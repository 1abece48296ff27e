#!/usr/bin/env python
"""Generate the canonical full-scale synthetic Amazon-books corpus.

The reference repo does not distribute the real books.csv / users.csv
(only 10-row trimmed samples), so full-scale runs here use the synthetic
generator (``ttamm/data/synthetic.py``: per-user category preference +
zipf popularity, schema-identical to the reference loaders'
``src/data/loaders.py:40,60`` expectations).

This script pins the generation parameters so every full run in RESULTS.md
is reproducible bit-for-bit:

    python scripts/make_corpus.py                  # data/books.csv users.csv
    python scripts/make_corpus.py --seed 13 --out /tmp/corpus13

Scale matches the reference's benchmark config (2M-interaction cap,
configs/default.yaml): 200k users x 100k items x 2M interactions.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# num_authors=30 keeps the author one-hot informative (~3.3k items/author);
# saturating the author_top_k=300 cap instead (num_authors >= 300) adds
# 300 noisy feature columns and costs ~0.01 recall@10 (measured:
# 0.105 at authors=30 vs 0.088-0.096 across seeds at authors=2000).
CANONICAL = dict(
    num_users=200_000,
    num_items=100_000,
    num_interactions=2_000_000,
    num_authors=30,
    seed=0,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data")
    ap.add_argument("--seed", type=int, default=CANONICAL["seed"])
    ap.add_argument("--users", type=int, default=CANONICAL["num_users"])
    ap.add_argument("--items", type=int, default=CANONICAL["num_items"])
    ap.add_argument(
        "--interactions", type=int, default=CANONICAL["num_interactions"]
    )
    args = ap.parse_args()

    from ttamm.data.synthetic import write_synthetic_csvs

    t0 = time.time()
    write_synthetic_csvs(
        args.out,
        num_users=args.users,
        num_items=args.items,
        num_interactions=args.interactions,
        num_authors=CANONICAL["num_authors"],
        seed=args.seed,
    )
    print(
        f"wrote {args.out}/books.csv + users.csv "
        f"({args.users} users, {args.items} items, {args.interactions} "
        f"interactions, seed={args.seed}) in {time.time() - t0:.0f}s"
    )


if __name__ == "__main__":
    main()
