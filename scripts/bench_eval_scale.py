#!/usr/bin/env python
"""Per-epoch retrieval-eval wall-clock at corpus scale.

Times the production eval path — ``encode_corpus`` + the one-dispatch
EvalPlan hit-matrix eval (``evaluation/retrieval.py``) — for a 200k-user
sweep over an N-item corpus at flagship shapes (128-dim gated towers +
mimic augmentation, 105 features), at 0.5M/1M/2M items where the slab
traffic is ~20x that of 100k.

Usage: python scripts/bench_eval_scale.py [--items 2000000] [--users 200000]
Prints one JSON line per corpus size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--items", default="2000000")
    parser.add_argument("--users", type=int, default=200_000)
    parser.add_argument("--features", type=int, default=105)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--user-batch", type=int, default=2048)
    parser.add_argument("--score-dtype", default="float32")
    parser.add_argument("--platform", default=None)
    parser.add_argument(
        "--heavy-tail", type=int, default=0,
        help="number of heavy users whose blocked lists exceed the narrow "
        "mask width (the bucketed plan keeps the majority's masks narrow)",
    )
    parser.add_argument(
        "--heavy-width", type=int, default=192,
        help="max blocked-list length for the heavy tail",
    )
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    from ttamm.utils.compile_cache import enable_persistent_cache

    enable_persistent_cache()
    import jax.numpy as jnp
    import pandas as pd

    from __graft_entry__ import _model_cfg_dict
    from ttamm.evaluation import build_eval_plan, evaluate_retrieval_metrics
    from ttamm.models import parse_model_config
    from ttamm.train import create_train_state, encode_corpus
    from ttamm.train.state import BatchData

    rng = np.random.default_rng(0)
    users, feat, dim = args.users, args.features, args.dim

    for num_items in (int(x) for x in args.items.split(",")):
        cfg = parse_model_config(
            _model_cfg_dict(dim), user_feature_dim=feat, item_feature_dim=feat
        )
        full = create_train_state(
            jax.random.key(0), cfg, num_users=users, num_items=num_items
        )
        # Eval touches only tables+dense; drop the optimizer state so the
        # 2M-item run holds ~4 GB instead of ~10 GB on the chip.
        state = full._replace(opt_sparse={}, opt_dense=full.opt_dense._replace(
            m={"dense": {}, "tables": {}}, v={"dense": {}, "tables": {}}
        ))
        del full
        data = BatchData(
            user_features=jnp.asarray(
                rng.normal(0, 1, (users, feat)).astype(np.float32)
            ),
            item_features=jnp.asarray(
                rng.normal(0, 1, (num_items, feat)).astype(np.float32)
            ),
            positive_rows=jnp.asarray(
                rng.integers(0, num_items, (users, 8), dtype=np.int32)
            ),
            category_ids=None,
        )

        # One held-out item per user (the reference's split shape) + 8
        # blocked train positives per user.
        val = pd.DataFrame(
            {
                "user_idx": np.arange(users, dtype=np.int64),
                "item_idx": rng.integers(0, num_items, users, dtype=np.int64),
            }
        )
        blocked = {
            u: set(map(int, rng.integers(0, num_items, 8))) for u in range(users)
        }
        if args.heavy_tail > 0:
            heavy = rng.choice(users, size=args.heavy_tail, replace=False)
            for u in heavy:
                w = int(rng.integers(args.heavy_width // 2, args.heavy_width))
                blocked[int(u)] = set(map(int, rng.integers(0, num_items, w)))
        t0 = time.perf_counter()
        plan = build_eval_plan(
            val, blocked,
            num_users=users, num_items=num_items,
            k_values=[5, 10, 20], user_batch_size=args.user_batch,
        )
        plan_s = time.perf_counter() - t0

        def run_once():
            t0 = time.perf_counter()
            emb = encode_corpus(state, data, cfg, "item", num_rows=num_items)
            np.asarray(jax.device_get(emb[0, :1]))
            t_enc = time.perf_counter() - t0
            t1 = time.perf_counter()
            metrics = evaluate_retrieval_metrics(
                state, data, cfg, plan=plan, k_values=[5, 10, 20],
                item_embeddings=emb, score_dtype=args.score_dtype,
            )
            t_eval = time.perf_counter() - t1
            return t_enc, t_eval, metrics

        run_once()  # compile
        a = run_once()
        b = run_once()
        t_enc = min(a[0], b[0])
        t_eval = min(a[1], b[1])
        metrics = b[2]
        bucket_info = {}
        if args.heavy_tail > 0:
            wide = plan.wide
            bucket_info = {
                "heavy_tail_users": args.heavy_tail,
                "narrow_width": int(plan.blocked_rows.shape[1]),
                "wide_users": (
                    0 if wide is None
                    else sum(len(b) for b in wide.batches)
                ),
                "wide_width": (
                    None if wide is None else int(wide.blocked_rows.shape[1])
                ),
            }
        print(
            json.dumps(
                {
                    "num_items": num_items,
                    "num_users": users,
                    "score_dtype": args.score_dtype,
                    "plan_build_s": round(plan_s, 2),
                    "encode_corpus_s": round(t_enc, 2),
                    "eval_s": round(t_eval, 2),
                    "recall@10": round(metrics.recall[10], 6),
                    **bucket_info,
                }
            ),
            flush=True,
        )
        del state, data, plan


if __name__ == "__main__":
    main()
