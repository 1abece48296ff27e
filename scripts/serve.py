#!/usr/bin/env python
"""Serve top-K recommendations from the exported serving bundle.

Batch mode (one userId per line on stdin or via --user-id) over the
artifacts directory the training pipeline wrote (default
``artifacts/faiss``), or a long-running HTTP service with ``--http PORT``
(GET /healthz, GET/POST /v1/recommend — see ttamm/serve/http_server.py).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description="Recommendation serving CLI.")
    parser.add_argument("--artifacts", type=Path, default=Path("artifacts/faiss"))
    parser.add_argument("--user-id", action="append", default=None)
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
    parser.add_argument(
        "--http", type=int, default=None, metavar="PORT",
        help="run as an HTTP service on this port instead of batch mode",
    )
    parser.add_argument("--host", default="127.0.0.1")
    args = parser.parse_args()

    if args.backend in ("auto", "device"):
        # Reuse compiled programs across restarts.
        from ttamm.utils import enable_persistent_cache

        enable_persistent_cache()

    from ttamm.serve.service import RetrievalService

    service = RetrievalService.from_artifacts(args.artifacts)
    if args.score_dtype is not None:
        service.index.score_dtype = args.score_dtype
    if args.http is not None:
        from ttamm.serve.http_server import serve_forever

        print(f"serving on http://{args.host}:{args.http} (backend={args.backend})")
        serve_forever(service, args.host, args.http, backend=args.backend)
        return
    user_ids = args.user_id or [line.strip() for line in sys.stdin if line.strip()]
    for uid in user_ids:
        try:
            recs = service.recommend_for_user(uid, k=args.k, backend=args.backend)
        except KeyError as exc:
            print(f"{uid}\tERROR\t{exc}")
            continue
        formatted = ", ".join(f"{asin}:{score:.4f}" for asin, score in recs)
        print(f"{uid}\t{formatted}")


if __name__ == "__main__":
    main()
