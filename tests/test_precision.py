"""bf16 compute-precision option: runs and tracks fp32 within tolerance."""

import jax
import jax.numpy as jnp
import numpy as np

from ttamm.models import init_tower, parse_tower_config, tower_forward


def _cfg(precision_dtype):
    return parse_tower_config(
        {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": 16}},
            "feature_encoder": {
                "type": "mlp",
                "hidden_dims": [32],
                "output_dim": 16,
                "dropout": 0.0,
            },
            "fusion": "gated",
        },
        feature_dim=8,
        compute_dtype=precision_dtype,
    )


def test_bf16_tower_close_to_fp32():
    cfg32 = _cfg("float32")
    cfg16 = _cfg("bfloat16")
    table, dense = init_tower(jax.random.key(0), cfg32, num_embeddings=20)
    idx = jnp.arange(6)
    feats = jnp.asarray(
        np.random.default_rng(0).normal(0, 1, (6, 8)).astype(np.float32)
    )
    rows = jnp.take(table, idx, axis=0)
    out32 = tower_forward(dense, cfg32, rows, feats)
    out16 = tower_forward(dense, cfg16, rows, feats)
    assert out16.dtype == jnp.float32  # fp32 accumulation
    assert np.allclose(np.asarray(out32), np.asarray(out16), atol=0.05)


def test_model_precision_parsing():
    from ttamm.models import parse_model_config
    import pytest

    cfg = parse_model_config(
        {
            "precision": "bf16",
            "user_encoder": {"type": "embedding", "params": {"embedding_dim": 8}},
            "item_encoder": {"type": "embedding", "params": {"embedding_dim": 8}},
            "adaptive_mimic": {"enabled": False},
        },
        user_feature_dim=0,
        item_feature_dim=0,
    )
    assert cfg.user_tower.compute_dtype == "bfloat16"

    with pytest.raises(ValueError):
        parse_model_config(
            {"precision": "fp8"}, user_feature_dim=0, item_feature_dim=0
        )


import pytest


def test_bf16_feature_matrices_train_and_eval():
    """data.features_dtype='bfloat16': towers upcast after the gather;
    one step stays close to the fp32-features step and the pipeline-level
    eval path runs."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ttamm.data import pack_positives
    from ttamm.models import parse_model_config
    from ttamm.train import TrainStepConfig, create_train_state, make_train_step
    from ttamm.train.state import BatchData

    U, I, F, B = 30, 24, 10, 8
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": 8},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "sum",
            },
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    rng = np.random.default_rng(0)
    uf = rng.normal(0, 1, (U, F)).astype(np.float32)
    itf = rng.normal(0, 1, (I, F)).astype(np.float32)
    packed = pack_positives(
        {u: {int(x) for x in rng.integers(0, I, 2)} for u in range(U)},
        num_users=U, num_items=I,
    )

    def mk(dt):
        return BatchData(
            user_features=jnp.asarray(uf, dtype=dt),
            item_features=jnp.asarray(itf, dtype=dt),
            positive_rows=jnp.asarray(packed.rows),
            category_ids=None,
        )

    tscfg = TrainStepConfig(num_items=I, negatives_per_positive=2)
    state = create_train_state(jax.random.key(0), cfg, num_users=U, num_items=I)
    step = make_train_step(cfg, tscfg)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    s32, m32 = step(jax.tree.map(jnp.copy, state), mk(jnp.float32), u, p, jax.random.key(1))
    s16, m16 = step(jax.tree.map(jnp.copy, state), mk(jnp.bfloat16), u, p, jax.random.key(1))
    assert float(m16["loss"]) == pytest.approx(float(m32["loss"]), rel=2e-2)
    a = np.asarray(s32.tables["user_id"])
    b = np.asarray(s16.tables["user_id"])
    assert np.allclose(a, b, atol=3e-3)  # ~2x lr bound (Adam sign steps)

    # Eval path: encode + plan-based retrieval metrics run on bf16 features.
    import pandas as pd

    from ttamm.evaluation import build_eval_plan, evaluate_retrieval_metrics

    val = pd.DataFrame({"user_idx": [0, 1, 2], "item_idx": [3, 4, 5]})
    plan = build_eval_plan(
        val, {u_: set() for u_ in range(U)},
        num_users=U, num_items=I, k_values=[5],
    )
    metrics = evaluate_retrieval_metrics(
        s16, mk(jnp.bfloat16), cfg, plan=plan, k_values=[5]
    )
    assert 0.0 <= metrics.recall[5] <= 1.0
