#!/usr/bin/env python
"""Query the persisted retrieval index for top-K items.

A serve-style CLI the reference lists only as future work (its README's
"inference service"). Loads the flat MIPS index artifact written at the end
of training and answers top-K queries for user rows of a saved user
embedding matrix or for arbitrary embedding vectors.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description="Top-K retrieval queries.")
    parser.add_argument("--index", type=Path, required=True, help="TTFLAT index path")
    parser.add_argument(
        "--queries", type=Path, required=True, help=".npy query embedding matrix"
    )
    parser.add_argument("--k", type=int, default=10)
    parser.add_argument(
        "--backend", choices=["auto", "device", "native", "numpy"], default="auto"
    )
    parser.add_argument(
        "--score-dtype", choices=["float32", "bfloat16"], default=None,
        help="override the device-backend scoring precision persisted in "
        "the index header (the training pipeline's recall gate sets it); "
        "bfloat16 is the ~1.5x approximate fast path (ranking exact "
        "w.r.t. bf16 scores)",
    )
    args = parser.parse_args()

    if args.backend in ("auto", "device"):
        # Reuse compiled programs across restarts.
        from ttamm.utils import enable_persistent_cache

        enable_persistent_cache()

    from ttamm.serve import FlatIndex

    index = FlatIndex.load(args.index)
    if args.score_dtype is not None:
        index.score_dtype = args.score_dtype
    queries = np.load(args.queries)
    backend = args.backend
    scores, indices = index.search(queries, args.k, backend=backend)
    for row in range(indices.shape[0]):
        pairs = ", ".join(
            f"{int(i)}:{s:.4f}" for i, s in zip(indices[row], scores[row])
        )
        print(f"query {row}: {pairs}")


if __name__ == "__main__":
    main()
