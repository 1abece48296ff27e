"""Collective-footprint comparison: GSPMD-auto vs explicit bucketed exchange.

Compiles the full hybrid sharded train step on a virtual 8-device mesh
(4 data x 2 model by default) at a table-dominant scale and prints each
path's collective op counts and bytes: a written comparison of
GSPMD-auto vs explicit exchange. Run hermetically:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/compare_exchange_hlo.py
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ttamm.data import pack_positives  # noqa: E402
from ttamm.models import parse_model_config  # noqa: E402
from ttamm.parallel import (  # noqa: E402
    MeshConfig,
    build_mesh,
    make_sharded_train_step,
    pad_batch_data,
    pad_state_rows,
    place_data,
    place_state,
)
from ttamm.parallel.hlo_inspect import (  # noqa: E402
    collect_collectives,
    collective_summary,
)
from ttamm.train import TrainStepConfig, create_train_state  # noqa: E402
from ttamm.train.optim import parse_dense_opt_config  # noqa: E402
from ttamm.train.state import BatchData  # noqa: E402


def compiled_hlo(rows, batch, dim, dp, mp, exchange):
    f = 16
    mc = {
        side: {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": dim, "sparse": True}},
            "feature_encoder": {
                "type": "mlp", "hidden_dims": [32], "output_dim": dim
            },
            "fusion": "gated",
        }
        for side in ("user_encoder", "item_encoder")
    } | {"similarity": "cosine", "adaptive_mimic": {"enabled": True}}
    cfg = parse_model_config(mc, user_feature_dim=f, item_feature_dim=f)
    state = create_train_state(
        jax.random.key(0), cfg, num_users=rows, num_items=rows
    )
    rng = np.random.default_rng(0)
    pp = pack_positives(
        {u: {int(x) for x in rng.integers(0, rows, 3)} for u in range(rows)},
        num_users=rows, num_items=rows,
    )
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (rows, f)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (rows, f)).astype(np.float32)),
        positive_rows=jnp.asarray(pp.rows),
        category_ids=jnp.asarray(rng.integers(0, 4, rows).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=rows, negatives_per_positive=3,
        lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=4,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}
        ),
        embedding_exchange=exchange,
    )
    mesh = build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
    pstate = place_state(mesh, pad_state_rows(state, mp))
    pdata = place_data(mesh, pad_batch_data(data, mp))
    step = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    u = jnp.asarray(rng.integers(0, rows, batch).astype(np.int32))
    p = jnp.asarray(rng.integers(0, rows, batch).astype(np.int32))
    return step.lower(pstate, pdata, u, p, jax.random.key(1)).compile().as_text()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=8192)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--dp", type=int, default=4)
    ap.add_argument("--mp", type=int, default=2)
    args = ap.parse_args()

    for exchange in ("gspmd", "alltoall"):
        hlo = compiled_hlo(
            args.rows, args.batch, args.dim, args.dp, args.mp, exchange
        )
        summary = collective_summary(hlo)
        total = sum(v["bytes"] for v in summary.values())
        count = sum(v["count"] for v in summary.values())
        print(f"\n== {exchange} ==  total {count} collectives, {total} bytes")
        print(json.dumps(summary, indent=1, sort_keys=True))
        top = sorted(collect_collectives(hlo), key=lambda c: -c.bytes)[:5]
        for c in top:
            print("  ", c)


if __name__ == "__main__":
    main()
