#!/usr/bin/env python
"""Weak-scaling benchmark across mesh sizes.

Runs the sharded train step at increasing device counts on whatever
platform is attached, holding per-device batch constant (weak scaling), and
reports examples/s plus scaling efficiency vs the 1-device run. On a
single-chip or CPU host this exercises the code path (virtual CPU devices
give no real speedup); on a pod slice it produces the ≥80%-efficiency
number BASELINE.md targets.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/bench_scaling.py --platform cpu --max-devices 8
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default=None)
    parser.add_argument("--max-devices", type=int, default=None)
    parser.add_argument("--per-device-batch", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--users", type=int, default=100_000)
    parser.add_argument("--items", type=int, default=50_000)
    parser.add_argument("--features", type=int, default=608)
    parser.add_argument("--dim", type=int, default=128)
    args = parser.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _model_cfg_dict
    from ttamm.models import parse_model_config
    from ttamm.parallel import (
        MeshConfig,
        build_mesh,
        make_sharded_train_step,
        pad_batch_data,
        pad_state_rows,
        place_data,
        place_state,
    )
    from ttamm.train import TrainStepConfig, create_train_state
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData

    n_avail = len(jax.devices())
    max_devices = min(args.max_devices or n_avail, n_avail)
    device_counts = [d for d in (1, 2, 4, 8, 16, 32, 64) if d <= max_devices]

    cfg = parse_model_config(
        _model_cfg_dict(args.dim),
        user_feature_dim=args.features,
        item_feature_dim=args.features,
    )
    rng = np.random.default_rng(0)
    base_state = jax.tree.map(
        np.asarray,
        create_train_state(
            jax.random.key(0), cfg, num_users=args.users, num_items=args.items
        ),
    )  # host copy: each mesh size gets a fresh device placement
    base_data = BatchData(
        user_features=rng.normal(0, 1, (args.users, args.features)).astype(np.float32),
        item_features=rng.normal(0, 1, (args.items, args.features)).astype(np.float32),
        positive_rows=rng.integers(0, args.items, (args.users, 8), dtype=np.int32),
        category_ids=rng.integers(0, 64, args.items).astype(np.int32),
    )
    tscfg = TrainStepConfig(
        num_items=args.items,
        negatives_per_positive=5,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        lambda_category_alignment=0.01,
        cal_max_categories=64,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}
        ),
    )

    results = []
    base_eps = None
    for n in device_counts:
        model_parallel = 2 if n >= 2 else 1
        data_parallel = n // model_parallel
        mesh = build_mesh(MeshConfig(data_parallel, model_parallel))
        state = place_state(mesh, pad_state_rows(base_state, model_parallel))
        data = place_data(mesh, pad_batch_data(base_data, model_parallel))
        step = make_sharded_train_step(cfg, tscfg, mesh, state, data)

        batch = args.per_device_batch * data_parallel
        u = jnp.asarray(rng.integers(0, args.users, batch).astype(np.int32))
        p = jnp.asarray(rng.integers(0, args.items, batch).astype(np.int32))
        state, metrics = step(state, data, u, p, jax.random.key(0))
        np.asarray(jax.device_get(metrics["loss"]))  # compile barrier

        t0 = time.perf_counter()
        for i in range(args.steps):
            state, metrics = step(state, data, u, p, jax.random.key(i + 1))
        np.asarray(jax.device_get(metrics["loss"]))
        dt = time.perf_counter() - t0
        eps = args.steps * batch / dt
        if base_eps is None:
            base_eps = eps
        efficiency = eps / (base_eps * n)
        results.append(
            {
                "devices": n,
                "mesh": f"{data_parallel}x{model_parallel}",
                "examples_per_s": round(eps, 1),
                "weak_scaling_efficiency": round(efficiency, 3),
            }
        )
        print(json.dumps(results[-1]))

    print(json.dumps({"scaling": results, "platform": jax.default_backend()}))


if __name__ == "__main__":
    main()
