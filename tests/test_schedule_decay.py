"""Round-5 regularization levers: on-device lr schedules, sparse-table
weight decay, mixed negatives (RESULTS.md round-5 loss-ceiling study).

All three extend the reference (no scheduler, torch SparseAdam has no
weight decay, no mixed negative sampling — ref ``training.py:1311-1350``)
and default OFF for parity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.data import pack_positives
from ttamm.models import parse_model_config
from ttamm.ops.sparse_adam import (
    SparseAdamState,
    init_sparse_adam,
    sparse_adam_update,
    sparse_adam_update_packed,
    sparse_adam_update_sorted,
)
from ttamm.train import TrainStepConfig, create_train_state, make_train_step
from ttamm.train.optim import (
    DenseOptConfig,
    DenseOptState,
    dense_opt_update,
    init_dense_opt,
    lr_scale,
    parse_dense_opt_config,
)
from ttamm.train.state import BatchData


def test_lr_scale_endpoints():
    cos = DenseOptConfig(
        lr_schedule="cosine", lr_total_steps=11, lr_final_factor=0.1
    )
    assert float(lr_scale(cos, jnp.asarray(1))) == pytest.approx(1.0)
    assert float(lr_scale(cos, jnp.asarray(11))) == pytest.approx(0.1)
    # midpoint of the cosine = average of the endpoints
    assert float(lr_scale(cos, jnp.asarray(6))) == pytest.approx(0.55, abs=1e-6)
    # clamped past the horizon
    assert float(lr_scale(cos, jnp.asarray(99))) == pytest.approx(0.1)

    lin = DenseOptConfig(
        lr_schedule="linear", lr_total_steps=5, lr_final_factor=0.0
    )
    assert float(lr_scale(lin, jnp.asarray(1))) == pytest.approx(1.0)
    assert float(lr_scale(lin, jnp.asarray(3))) == pytest.approx(0.5)
    assert float(lr_scale(lin, jnp.asarray(5))) == pytest.approx(0.0)

    const = DenseOptConfig()
    assert lr_scale(const, jnp.asarray(3)) == 1.0  # static float


def test_parse_lr_schedule_config():
    cfg = parse_dense_opt_config(
        {"lr_schedule": {"type": "cosine", "final_factor": 0.25}},
        total_steps=700,
    )
    assert cfg.lr_schedule == "cosine"
    assert cfg.lr_total_steps == 700
    assert cfg.lr_final_factor == 0.25
    # string form + explicit horizon override
    cfg = parse_dense_opt_config(
        {"lr_schedule": {"type": "linear", "total_steps": 42}}
    )
    assert cfg.lr_schedule == "linear" and cfg.lr_total_steps == 42
    with pytest.raises(ValueError):
        parse_dense_opt_config({"lr_schedule": "polynomial"})


def test_dense_adamw_linear_schedule_matches_manual():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    cfg = DenseOptConfig(
        name="adamw", lr=0.1, weight_decay=0.01,
        lr_schedule="linear", lr_total_steps=3, lr_final_factor=0.0,
    )
    params = {"w": jnp.asarray(w)}
    state = init_dense_opt(params)
    grads = {"w": jnp.asarray(rng.normal(size=(3, 4)).astype(np.float32))}

    w_ref = w.astype(np.float64)
    m = np.zeros_like(w_ref)
    v = np.zeros_like(w_ref)
    g = np.asarray(grads["w"], np.float64)
    for t, scale in ((1, 1.0), (2, 0.5)):
        lr = 0.1 * scale
        w_ref = w_ref - lr * 0.01 * w_ref
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        m_hat = m / (1 - 0.9**t)
        v_hat = v / (1 - 0.999**t)
        w_ref = w_ref - lr * m_hat / (np.sqrt(v_hat) + 1e-8)
        params, state = dense_opt_update(params, grads, state, cfg)
    assert np.allclose(np.asarray(params["w"]), w_ref, atol=1e-5)


def _manual_sparse_adamw(table, m, v, idx_list, grads, lr, wd, t=1):
    table = table.astype(np.float64).copy()
    m, v = m.astype(np.float64).copy(), v.astype(np.float64).copy()
    coalesced: dict[int, np.ndarray] = {}
    for i, row in zip(idx_list, grads):
        coalesced[i] = coalesced.get(i, 0.0) + row.astype(np.float64)
    for i, g in coalesced.items():
        m[i] = 0.9 * m[i] + 0.1 * g
        v[i] = 0.999 * v[i] + 0.001 * g * g
        m_hat = m[i] / (1 - 0.9**t)
        v_hat = v[i] / (1 - 0.999**t)
        table[i] = table[i] - lr * wd * table[i] - lr * m_hat / (
            np.sqrt(v_hat) + 1e-8
        )
    return table


@pytest.mark.parametrize("variant", ["sorted", "packed", "dispatch_packed"])
def test_sparse_weight_decay_touched_rows_only(variant):
    rng = np.random.default_rng(1)
    rows, dim = 10, 8
    table = rng.normal(size=(rows, dim)).astype(np.float32)
    idx = np.array([2, 5, 2, 7, 5, 5, 2, 7], np.int32)
    grads = rng.normal(size=(8, dim)).astype(np.float32)
    want = _manual_sparse_adamw(
        table, np.zeros_like(table), np.zeros_like(table),
        idx.tolist(), grads, lr=0.05, wd=0.1,
    )
    t = jnp.asarray(table)
    if variant == "packed":
        state = init_sparse_adam(t, packed=True)
        new_table, _ = sparse_adam_update_packed(
            t, state, jnp.asarray(idx), jnp.asarray(grads),
            lr=0.05, weight_decay=0.1,
        )
    elif variant == "dispatch_packed":
        # The public entry picks the packed path from the state's layout.
        state = init_sparse_adam(t, packed=True)
        new_table, _ = sparse_adam_update(
            t, state, jnp.asarray(idx), jnp.asarray(grads),
            lr=0.05, weight_decay=0.1,
        )
    else:
        state = init_sparse_adam(t)
        new_table, _ = sparse_adam_update_sorted(
            t, state, jnp.asarray(idx), jnp.asarray(grads),
            lr=0.05, weight_decay=0.1,
        )
    got = np.asarray(new_table)
    assert np.allclose(got, want, atol=1e-5)
    untouched = [r for r in range(rows) if r not in {2, 5, 7}]
    assert np.array_equal(got[untouched], table[untouched])  # no decay


def test_sparse_weight_decay_zero_is_bit_identical_to_default():
    rng = np.random.default_rng(2)
    table = jnp.asarray(rng.normal(size=(6, 4)).astype(np.float32))
    idx = jnp.asarray(np.array([1, 3, 1, 4], np.int32))
    grads = jnp.asarray(rng.normal(size=(4, 4)).astype(np.float32))
    a, _ = sparse_adam_update_sorted(
        table, init_sparse_adam(table), idx, grads, lr=0.01
    )
    b, _ = sparse_adam_update_sorted(
        table, init_sparse_adam(table), idx, grads, lr=0.01, weight_decay=0.0
    )
    assert np.array_equal(np.asarray(a), np.asarray(b))


def _tiny_setup(loss_type="in_batch_softmax", **tscfg_kwargs):
    U, I, F, B = 20, 16, 5, 8
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "sum",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "sum",
            },
            "adaptive_mimic": {"enabled": False},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    rng = np.random.default_rng(5)
    packed = pack_positives(
        {u: {int(x) for x in rng.integers(0, I, 2)} for u in range(U)},
        num_users=U, num_items=I,
    )
    counts = rng.integers(1, 30, I).astype(np.float64)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(packed.rows),
        category_ids=None,
        item_log_q=jnp.asarray(np.log(counts / counts.sum()), jnp.float32),
    )
    tscfg = TrainStepConfig(num_items=I, loss_type=loss_type, **tscfg_kwargs)
    state = create_train_state(jax.random.key(0), cfg, num_users=U, num_items=I)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    return cfg, tscfg, state, data, u, p


def test_train_step_zero_final_lr_freezes_every_parameter():
    """With a linear schedule reaching 0 at step 2, the second step must
    change NO parameter (the schedule demonstrably reaches the sparse
    tables and the dense AdamW decay, not just the dense Adam delta)."""
    cfg, tscfg, state, data, u, p = _tiny_setup(
        opt=DenseOptConfig(
            name="adamw", lr=0.01, weight_decay=0.01,
            lr_schedule="linear", lr_total_steps=2, lr_final_factor=0.0,
        ),
        sparse_weight_decay=0.05,
    )
    step = make_train_step(cfg, tscfg)
    s1, _ = step(state, data, u, p, jax.random.key(1))
    s2, _ = step(s1, data, u, p, jax.random.key(2))
    for name in s1.tables:
        assert np.array_equal(
            np.asarray(s1.tables[name]), np.asarray(s2.tables[name])
        ), name
    for a, b in zip(jax.tree.leaves(s1.dense), jax.tree.leaves(s2.dense)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # ...while step 1 (scale 1.0) did train
    assert not np.array_equal(
        np.asarray(state.tables["user_id"]), np.asarray(s1.tables["user_id"])
    )


def test_train_step_sparse_weight_decay_decays_touched_rows():
    cfg, tscfg, state, data, u, p = _tiny_setup(
        opt=DenseOptConfig(name="adamw", lr=0.01),
        sparse_weight_decay=0.5,
    )
    base_cfg = tscfg._replace(sparse_weight_decay=0.0)
    s_wd, _ = make_train_step(cfg, tscfg)(state, data, u, p, jax.random.key(1))
    s_no, _ = make_train_step(cfg, base_cfg)(
        state, data, u, p, jax.random.key(1)
    )
    touched = np.unique(np.asarray(u))
    w0 = np.asarray(state.tables["user_id"])
    ww = np.asarray(s_wd.tables["user_id"])
    wn = np.asarray(s_no.tables["user_id"])
    # decayed rows differ from the no-decay run by exactly lr*wd*w0
    assert np.allclose(
        wn[touched] - ww[touched], 0.01 * 0.5 * w0[touched], atol=1e-6
    )
    untouched = [r for r in range(w0.shape[0]) if r not in set(touched)]
    assert np.array_equal(ww[untouched], w0[untouched])
