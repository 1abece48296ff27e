import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.models import init_tower, parse_tower_config, tower_forward


def _gated_cfg(feature_dim: int):
    return parse_tower_config(
        {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
            "feature_encoder": {
                "type": "mlp",
                "hidden_dims": [16],
                "activation": "relu",
                "output_dim": 8,
                "dropout": 0.0,
            },
            "fusion": "gated",
        },
        feature_dim=feature_dim,
    )


def test_gated_tower_output_shape():
    cfg = _gated_cfg(feature_dim=5)
    table, dense = init_tower(jax.random.key(0), cfg, num_embeddings=10)
    idx = jnp.array([0, 3, 7])
    feats = jnp.ones((3, 5))
    out = tower_forward(dense, cfg, jnp.take(table, idx, axis=0), feats)
    assert out.shape == (3, 8)


def test_sparse_flag_and_extra_rows():
    cfg = _gated_cfg(feature_dim=4)
    assert cfg.embedding.sparse is True
    table, _ = init_tower(
        jax.random.key(0), cfg, num_embeddings=10, table_extra_rows=1
    )
    assert table.shape == (11, 8)
    assert np.allclose(np.asarray(table)[-1], 0.0)  # scratch row zeroed


def test_feature_fallback_to_id_only():
    cfg = _gated_cfg(feature_dim=5)
    table, dense = init_tower(jax.random.key(0), cfg, num_embeddings=10)
    rows = jnp.take(table, jnp.array([1, 2]), axis=0)
    out = tower_forward(dense, cfg, rows, None)  # features unavailable
    assert np.allclose(np.asarray(out), np.asarray(rows))


def test_embedding_only_tower():
    cfg = parse_tower_config(
        {"type": "embedding", "params": {"embedding_dim": 6}}, feature_dim=0
    )
    assert cfg.fusion == "identity"
    table, dense = init_tower(jax.random.key(0), cfg, num_embeddings=4)
    assert table.shape == (4, 6)


def test_sum_fusion_requires_matching_dims():
    with pytest.raises(ValueError):
        parse_tower_config(
            {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8}},
                "feature_encoder": {"type": "linear", "output_dim": 4},
                "fusion": "sum",
            },
            feature_dim=5,
        )


def test_adaptive_mimic_fusion_alias_warns():
    with pytest.warns(DeprecationWarning):
        cfg = parse_tower_config(
            {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "adaptive_mimic",
            },
            feature_dim=5,
        )
    assert cfg.fusion == "gated"


def test_sparse_max_norm_rejected():
    with pytest.raises(ValueError):
        parse_tower_config(
            {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True, "max_norm": 1.0}},
            },
            feature_dim=0,
        )


def test_concat_fusion_projection():
    cfg = parse_tower_config(
        {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": 8}},
            "feature_encoder": {"type": "linear", "output_dim": 6},
            "fusion": "concat",
            "output_dim": 12,
        },
        feature_dim=5,
    )
    assert cfg.output_dim == 12
    table, dense = init_tower(jax.random.key(0), cfg, num_embeddings=10)
    out = tower_forward(
        dense, cfg, jnp.take(table, jnp.array([0, 1]), axis=0), jnp.ones((2, 5))
    )
    assert out.shape == (2, 12)


def test_tower_gate_values_range_and_consistency():
    from ttamm.evaluation import summarize_gate_values
    from ttamm.models.encoders import tower_gate_values

    cfg = _gated_cfg(feature_dim=5)
    table, dense = init_tower(jax.random.key(0), cfg, num_embeddings=10)
    idx = jnp.array([0, 3, 7])
    rows = jnp.take(table, idx, axis=0)
    feats = jnp.ones((3, 5))

    gate = tower_gate_values(dense, cfg, rows, feats)
    assert gate.shape == (3, 8)
    g = np.asarray(gate)
    assert np.all(g > 0.0) and np.all(g < 1.0)

    # the blend the gate reports must equal tower_forward's output
    from ttamm.models.encoders import apply_feature_encoder

    feat_repr = apply_feature_encoder(dense, cfg, feats, train=False, dropout_rng=None)
    blended = gate * rows + (1.0 - gate) * feat_repr
    out = tower_forward(dense, cfg, rows, feats)
    np.testing.assert_allclose(np.asarray(blended), np.asarray(out), rtol=1e-6)

    stats = summarize_gate_values(g)
    assert stats["rows"] == 3
    assert 0.0 <= stats["id_dominant_fraction"] <= 1.0
    assert stats["min"] <= stats["mean"] <= stats["max"]

    # non-gated towers / missing features report no gate
    assert tower_gate_values(dense, cfg, rows, None) is None
    assert summarize_gate_values(None) == {}
