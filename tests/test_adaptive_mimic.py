import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.models import augment, init_mimic_tables, mimic_forward


def test_shapes_preserved_and_losses_nonnegative():
    tables = init_mimic_tables(
        jax.random.key(0), num_users=5, num_items=6, embedding_dim=4
    )
    u_idx = jnp.array([0, 2])
    i_idx = jnp.array([1, 3])
    user_emb = jnp.zeros((2, 4))
    item_emb = jnp.ones((2, 4))
    aug_u, aug_i, lu, li = mimic_forward(
        jnp.take(tables["user_aug"], u_idx, axis=0),
        jnp.take(tables["item_aug"], i_idx, axis=0),
        user_emb,
        item_emb,
    )
    assert aug_u.shape == (2, 4)
    assert aug_i.shape == (2, 4)
    assert float(lu) >= 0.0
    assert float(li) >= 0.0


def test_mimic_losses_target_opposite_tower():
    # If user_aug exactly equals the item embedding, mimic_user_loss == 0.
    user_emb = jnp.zeros((2, 4))
    item_emb = jnp.full((2, 4), 3.0)
    _, _, lu, li = mimic_forward(item_emb, user_emb, user_emb, item_emb)
    assert float(lu) == pytest.approx(0.0)
    assert float(li) == pytest.approx(0.0)


def test_mimic_gradients_stop_at_targets():
    # d(mimic_user_loss)/d(item_emb) must be zero (stop-gradient target).
    def loss(item_emb):
        _, _, lu, _ = mimic_forward(
            jnp.ones((2, 4)), jnp.zeros((2, 4)), jnp.zeros((2, 4)), item_emb
        )
        return lu

    grad = jax.grad(loss)(jnp.ones((2, 4)))
    assert np.allclose(np.asarray(grad), 0.0)


def test_augment_adds_rows():
    base = jnp.ones((3, 4))
    rows = jnp.full((3, 4), 0.5)
    out = augment(rows, base)
    assert np.allclose(np.asarray(out), 1.5)
    assert np.allclose(np.asarray(augment(None, base)), 1.0)


def test_invalid_sizes_raise():
    with pytest.raises(ValueError):
        init_mimic_tables(jax.random.key(0), num_users=0, num_items=3, embedding_dim=4)


# ---------------------------------------------------------------- sparse mode


def _tiny_cfg(mimic_sparse: bool):
    from ttamm.models import parse_model_config

    raw = {
        "user_encoder": {
            "type": "tower",
            "id_embedding": {
                "params": {"embedding_dim": 16, "sparse": True},
                "init": {"type": "normal", "std": 0.02},
            },
            "feature_encoder": {
                "type": "mlp", "hidden_dims": [32], "activation": "relu",
                "output_dim": 16, "dropout": 0.0,
            },
            "fusion": "gated",
            "output_dim": 16,
        },
        "item_encoder": {
            "type": "tower",
            "id_embedding": {
                "params": {"embedding_dim": 16, "sparse": True},
                "init": {"type": "normal", "std": 0.02},
            },
            "feature_encoder": {
                "type": "mlp", "hidden_dims": [32], "activation": "relu",
                "output_dim": 16, "dropout": 0.0,
            },
            "fusion": "gated",
            "output_dim": 16,
        },
        "similarity": "cosine",
        "adaptive_mimic": {"enabled": True, "sparse": mimic_sparse},
    }
    return parse_model_config(raw, user_feature_dim=8, item_feature_dim=8)


def _tiny_setup(mimic_sparse: bool, weight_decay: float, clip: float | None = None):
    from ttamm.train import TrainStepConfig, create_train_state, make_train_step
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData

    cfg = _tiny_cfg(mimic_sparse)
    num_users, num_items = 40, 30
    state = create_train_state(
        jax.random.key(0), cfg, num_users=num_users, num_items=num_items
    )
    rng = np.random.default_rng(0)
    data = BatchData(
        user_features=jnp.asarray(
            rng.normal(0, 1, (num_users, 8)).astype(np.float32)
        ),
        item_features=jnp.asarray(
            rng.normal(0, 1, (num_items, 8)).astype(np.float32)
        ),
        positive_rows=jnp.asarray(
            rng.integers(0, num_items, (num_users, 4)).astype(np.int32)
        ),
        category_ids=jnp.asarray(rng.integers(0, 4, num_items).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=num_items,
        negatives_per_positive=2,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        gradient_clip_norm=clip,
        opt=parse_dense_opt_config(
            {
                "optimizer": "adamw",
                "learning_rate": 1e-3,
                "weight_decay": weight_decay,
            }
        ),
    )
    return cfg, state, data, tscfg, make_train_step(cfg, tscfg)


def test_mimic_sparse_routes_tables_and_updates_lazily():
    # adaptive_mimic.sparse=True: aug tables join the sparse-row optimizer
    # (scratch row appended) and only batch rows are touched per step —
    # the scaling mode for multi-million-row corpora.
    from ttamm.train.state import dense_table_names, sparse_table_names

    cfg, state, data, tscfg, step = _tiny_setup(True, weight_decay=0.01)
    assert sparse_table_names(cfg) == (
        "user_id", "item_id", "user_aug", "item_aug",
    )
    assert dense_table_names(cfg) == ()
    assert state.tables["user_aug"].shape[0] == 41  # scratch row
    assert set(state.opt_sparse) == {"user_id", "item_id", "user_aug", "item_aug"}

    u = jnp.asarray([1, 2, 3, 1], jnp.int32)
    p = jnp.asarray([5, 6, 7, 8], jnp.int32)
    new_state, metrics = step(state, data, u, p, jax.random.key(1))
    assert np.isfinite(float(metrics["loss"]))
    before = np.asarray(state.tables["user_aug"])
    after = np.asarray(new_state.tables["user_aug"])
    changed = set(np.where(np.any(before != after, axis=1))[0].tolist())
    assert changed == {1, 2, 3}  # touched users only; scratch row untouched


def test_mimic_sparse_first_step_matches_dense_without_decay():
    # At weight_decay=0 the first AdamW step equals the SparseAdam step on
    # every touched row (same moments, same bias correction), and dense
    # AdamW's zero-grad rows get a zero delta — so step 1 must produce
    # bit-identical aug tables across the two modes (same seeds).
    _, state_d, data, _, step_d = _tiny_setup(False, weight_decay=0.0)
    _, state_s, _, _, step_s = _tiny_setup(True, weight_decay=0.0)

    u = jnp.asarray([1, 2, 3, 1], jnp.int32)
    p = jnp.asarray([5, 6, 7, 8], jnp.int32)
    new_d, _ = step_d(state_d, data, u, p, jax.random.key(1))
    new_s, _ = step_s(state_s, data, u, p, jax.random.key(1))
    for name in ("user_aug", "item_aug"):
        dense_tbl = np.asarray(new_d.tables[name])
        sparse_tbl = np.asarray(new_s.tables[name])[: dense_tbl.shape[0]]
        np.testing.assert_array_equal(dense_tbl, sparse_tbl)


def test_mimic_sparse_matches_dense_under_clip_with_duplicates():
    # The global clip norm coalesces sparse row grads (duplicate batch
    # indices contribute ||g1+g2||^2, exactly what the dense scatter-add
    # path feeds the norm), so step 1 matches across modes even with
    # clipping on — the batch below repeats user 1 on purpose. Tolerance:
    # the norm's accumulation ORDER differs (segment-sum vs table reduce),
    # so the clip scale can differ by an ulp. (The reference cannot run
    # this at all: torch's clip_grad_norm_ raises NotImplementedError on
    # sparse gradients.)
    _, state_d, data, _, step_d = _tiny_setup(False, weight_decay=0.0, clip=0.05)
    _, state_s, _, _, step_s = _tiny_setup(True, weight_decay=0.0, clip=0.05)

    u = jnp.asarray([1, 2, 3, 1], jnp.int32)
    p = jnp.asarray([5, 6, 7, 8], jnp.int32)
    new_d, _ = step_d(state_d, data, u, p, jax.random.key(1))
    new_s, _ = step_s(state_s, data, u, p, jax.random.key(1))
    for name in ("user_aug", "item_aug"):
        dense_tbl = np.asarray(new_d.tables[name])
        sparse_tbl = np.asarray(new_s.tables[name])[: dense_tbl.shape[0]]
        np.testing.assert_allclose(dense_tbl, sparse_tbl, rtol=1e-6, atol=1e-8)
