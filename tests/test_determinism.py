"""Determinism: same seed -> identical training trajectory (SURVEY §7
"hard parts": reproducible sweeps via threaded jax.random keys)."""

import jax
import jax.numpy as jnp
import numpy as np

from ttamm.data import pack_positives
from ttamm.models import parse_model_config
from ttamm.train import TrainStepConfig, create_train_state, make_train_step
from ttamm.train.optim import parse_dense_opt_config
from ttamm.train.state import BatchData


def _run(seed: int, steps: int = 5):
    U, I, F, B = 30, 25, 6, 8
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": 8, "dropout": 0.2},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "mlp", "hidden_dims": [16], "output_dim": 8, "dropout": 0.2},
                "fusion": "gated",
            },
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    state = create_train_state(jax.random.key(seed), cfg, num_users=U, num_items=I)
    rng = np.random.default_rng(seed)
    positives = {u: {int(x) for x in rng.integers(0, I, 3)} for u in range(U)}
    packed = pack_positives(positives, num_users=U, num_items=I)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(packed.rows),
        category_ids=jnp.asarray(rng.integers(0, 3, I).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=I,
        negatives_per_positive=2,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        cal_max_categories=3,
        lambda_category_alignment=0.01,
        opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 1e-3}),
    )
    step = make_train_step(cfg, tscfg)
    losses = []
    for i in range(steps):
        u = jnp.asarray(rng.integers(0, U, 8).astype(np.int32))
        p = jnp.asarray(rng.integers(0, I, 8).astype(np.int32))
        state, metrics = step(state, data, u, p, jax.random.key(seed * 1000 + i))
        losses.append(float(metrics["loss"]))
    return losses, np.asarray(state.tables["user_id"])


def test_same_seed_identical_trajectory():
    l1, t1 = _run(7)
    l2, t2 = _run(7)
    assert l1 == l2
    assert np.array_equal(t1, t2)


def test_different_seed_differs():
    l1, _ = _run(7)
    l2, _ = _run(8)
    assert l1 != l2
