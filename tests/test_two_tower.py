"""TwoTowerModel forward-surface parity (ref ``two_tower.py:40-95``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.models import (
    init_model,
    model_forward,
    parse_model_config,
    similarity_scores,
)


def _cfg(similarity="cosine", mimic=True):
    return parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "similarity": similarity,
            "adaptive_mimic": {"enabled": mimic},
        },
        user_feature_dim=4,
        item_feature_dim=4,
    )


def test_forward_outputs_score_and_mimic_losses():
    cfg = _cfg()
    tables, dense = init_model(jax.random.key(0), cfg, num_users=6, num_items=7)
    out = model_forward(
        tables, dense, cfg,
        {"indices": jnp.array([0, 1]), "features": jnp.ones((2, 4))},
        {"indices": jnp.array([2, 3]), "features": jnp.ones((2, 4))},
        return_embeddings=True,
    )
    assert out["score"].shape == (2,)
    assert out["user_embedding"].shape == (2, 8)
    assert out["item_embedding"].shape == (2, 8)
    assert float(out["mimic_user_loss"]) >= 0.0
    assert float(out["mimic_item_loss"]) >= 0.0


def test_forward_without_mimic_has_no_loss_keys():
    cfg = _cfg(mimic=False)
    tables, dense = init_model(jax.random.key(0), cfg, num_users=6, num_items=7)
    out = model_forward(
        tables, dense, cfg,
        {"indices": jnp.array([0])},
        {"indices": jnp.array([1])},
    )
    assert "mimic_user_loss" not in out
    assert set(out) == {"score"}


def test_cosine_scores_bounded():
    cfg = _cfg("cosine")
    u = jnp.asarray(np.random.default_rng(0).normal(0, 5, (10, 8)))
    v = jnp.asarray(np.random.default_rng(1).normal(0, 5, (10, 8)))
    s = np.asarray(similarity_scores(cfg, u, v))
    assert np.all(s <= 1.0 + 1e-5) and np.all(s >= -1.0 - 1e-5)


def test_dot_scores_match_manual():
    cfg = _cfg("dot")
    u = jnp.ones((3, 8))
    v = jnp.full((3, 8), 2.0)
    s = np.asarray(similarity_scores(cfg, u, v))
    assert np.allclose(s, 16.0)


def test_mimic_dim_mismatch_rejected():
    with pytest.raises(ValueError):
        parse_model_config(
            {
                "user_encoder": {
                    "type": "embedding",
                    "params": {"embedding_dim": 8},
                },
                "item_encoder": {
                    "type": "embedding",
                    "params": {"embedding_dim": 16},
                },
                "adaptive_mimic": {"enabled": True},
            },
            user_feature_dim=0,
            item_feature_dim=0,
        )
