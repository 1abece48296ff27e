"""Multi-batch scanned step == sequence of single steps (same RNG)."""

import jax
import jax.numpy as jnp
import numpy as np

from ttamm.data import pack_positives
from ttamm.models import parse_model_config
from ttamm.train import (
    TrainStepConfig,
    create_train_state,
    make_train_step,
)
from ttamm.train.step import make_multi_train_step
from ttamm.train.optim import parse_dense_opt_config
from ttamm.train.state import BatchData


def test_multi_step_equivalent_to_single_steps():
    U, I, F, B, K = 24, 20, 5, 6, 4
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    rng = np.random.default_rng(0)
    positives = {u: {int(x) for x in rng.integers(0, I, 2)} for u in range(U)}
    packed = pack_positives(positives, num_users=U, num_items=I)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(packed.rows),
        category_ids=None,
    )
    tscfg = TrainStepConfig(
        num_items=I,
        negatives_per_positive=2,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 1e-3}),
    )
    state0 = create_train_state(jax.random.key(0), cfg, num_users=U, num_items=I)

    u_all = rng.integers(0, U, (K, B)).astype(np.int32)
    p_all = rng.integers(0, I, (K, B)).astype(np.int32)
    key = jax.random.key(99)

    single = make_train_step(cfg, tscfg)
    state_seq = state0
    losses_seq = []
    for i in range(K):
        state_seq, metrics = single(
            state_seq, data, jnp.asarray(u_all[i]), jnp.asarray(p_all[i]),
            jax.random.fold_in(key, i),
        )
        losses_seq.append(float(metrics["loss"]))

    multi = make_multi_train_step(cfg, tscfg)
    state_multi, losses_multi = multi(
        state0, data, jnp.asarray(u_all), jnp.asarray(p_all), key
    )

    assert np.allclose(np.asarray(losses_multi), losses_seq, atol=1e-6)
    for a, b in zip(jax.tree.leaves(state_seq), jax.tree.leaves(state_multi)):
        assert np.allclose(np.asarray(a), np.asarray(b), atol=1e-6)
