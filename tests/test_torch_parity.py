"""Numerical parity against torch, the reference's substrate.

These tests pin our optimizer and loss semantics directly to
``torch.optim`` / ``torch.nn`` behavior (the reference uses them verbatim),
with identical weights and gradients on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttamm.ops import bce_with_logits, init_sparse_adam, sparse_adam_update
from ttamm.train.optim import (
    DenseOptConfig,
    dense_opt_update,
    init_dense_opt,
)


def _run_dense(name, wd, momentum=0.0, steps=5):
    rng = np.random.default_rng(0)
    w0 = rng.normal(0, 1, (4, 6)).astype(np.float32)
    grads = [rng.normal(0, 1, (4, 6)).astype(np.float32) for _ in range(steps)]

    # torch side
    wt = torch.nn.Parameter(torch.tensor(w0.copy()))
    if name == "adam":
        opt = torch.optim.Adam([wt], lr=1e-2, weight_decay=wd)
    elif name == "adamw":
        opt = torch.optim.AdamW([wt], lr=1e-2, weight_decay=wd)
    else:
        opt = torch.optim.SGD([wt], lr=1e-2, weight_decay=wd, momentum=momentum)
    for g in grads:
        opt.zero_grad()
        wt.grad = torch.tensor(g.copy())
        opt.step()

    # ours
    params = {"w": jnp.asarray(w0)}
    cfg = DenseOptConfig(name=name, lr=1e-2, weight_decay=wd, momentum=momentum)
    state = init_dense_opt(params)
    for g in grads:
        params, state = dense_opt_update(params, {"w": jnp.asarray(g)}, state, cfg)

    assert np.allclose(
        np.asarray(params["w"]), wt.detach().numpy(), atol=1e-5
    ), name


def test_adam_matches_torch():
    _run_dense("adam", wd=0.0)


def test_adam_l2_matches_torch():
    _run_dense("adam", wd=0.01)


def test_adamw_matches_torch():
    _run_dense("adamw", wd=0.01)


def test_sgd_momentum_matches_torch():
    _run_dense("sgd", wd=0.01, momentum=0.9)


def test_sparse_adam_matches_torch():
    rng = np.random.default_rng(1)
    rows, dim = 10, 4
    w0 = rng.normal(0, 1, (rows, dim)).astype(np.float32)

    # torch SparseAdam with duplicate-index sparse grads over 3 steps
    wt = torch.nn.Parameter(torch.tensor(w0.copy()))
    opt = torch.optim.SparseAdam([wt], lr=1e-2)
    steps = [
        (np.array([1, 3, 1]), rng.normal(0, 1, (3, dim)).astype(np.float32)),
        (np.array([0, 3]), rng.normal(0, 1, (2, dim)).astype(np.float32)),
        (np.array([9, 9, 9]), rng.normal(0, 1, (3, dim)).astype(np.float32)),
    ]
    for idx, g in steps:
        opt.zero_grad()
        wt.grad = torch.sparse_coo_tensor(
            torch.tensor(idx[None, :]), torch.tensor(g.copy()), (rows, dim)
        )
        opt.step()

    # ours (scratch row appended)
    table = jnp.concatenate(
        [jnp.asarray(w0), jnp.zeros((1, dim), jnp.float32)], axis=0
    )
    state = init_sparse_adam(table)
    for idx, g in steps:
        table, state = sparse_adam_update(
            table, state, jnp.asarray(idx, jnp.int32), jnp.asarray(g), lr=1e-2
        )

    assert np.allclose(
        np.asarray(table)[:rows], wt.detach().numpy(), atol=1e-5
    )


def test_bce_matches_torch():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, 100).astype(np.float32)
    labels = (rng.random(100) > 0.4).astype(np.float32)
    expected = torch.nn.BCEWithLogitsLoss()(
        torch.tensor(logits), torch.tensor(labels)
    ).item()
    got = float(bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)))
    assert got == pytest.approx(expected, rel=1e-5)


def test_gate_matches_torch_reference_math():
    """σ-gate blend with identical weights == torch Sequential equivalent."""
    rng = np.random.default_rng(3)
    dim, hidden, batch = 6, 5, 7
    w1 = rng.normal(0, 1, (2 * dim, hidden)).astype(np.float32)
    b1 = rng.normal(0, 1, hidden).astype(np.float32)
    w2 = rng.normal(0, 1, (hidden, dim)).astype(np.float32)
    b2 = rng.normal(0, 1, dim).astype(np.float32)
    id_repr = rng.normal(0, 1, (batch, dim)).astype(np.float32)
    feat = rng.normal(0, 1, (batch, dim)).astype(np.float32)

    lin1 = torch.nn.Linear(2 * dim, hidden)
    lin2 = torch.nn.Linear(hidden, dim)
    with torch.no_grad():
        lin1.weight.copy_(torch.tensor(w1.T))
        lin1.bias.copy_(torch.tensor(b1))
        lin2.weight.copy_(torch.tensor(w2.T))
        lin2.bias.copy_(torch.tensor(b2))
    net = torch.nn.Sequential(lin1, torch.nn.ReLU(), lin2, torch.nn.Sigmoid())
    with torch.no_grad():
        gate_t = net(torch.tensor(np.concatenate([id_repr, feat], axis=1)))
        expected = gate_t * torch.tensor(id_repr) + (1 - gate_t) * torch.tensor(feat)

    from ttamm.models.encoders import apply_gate

    dense = {
        "gate": {
            "fc1": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
            "fc2": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)},
        }
    }
    got = apply_gate(dense, jnp.asarray(id_repr), jnp.asarray(feat))
    assert np.allclose(np.asarray(got), expected.numpy(), atol=1e-5)


def test_mimic_losses_match_torch_mse():
    rng = np.random.default_rng(4)
    user_aug = rng.normal(0, 1, (5, 8)).astype(np.float32)
    item_aug = rng.normal(0, 1, (5, 8)).astype(np.float32)
    user_emb = rng.normal(0, 1, (5, 8)).astype(np.float32)
    item_emb = rng.normal(0, 1, (5, 8)).astype(np.float32)

    expected_u = torch.nn.functional.mse_loss(
        torch.tensor(user_aug), torch.tensor(item_emb)
    ).item()
    expected_i = torch.nn.functional.mse_loss(
        torch.tensor(item_aug), torch.tensor(user_emb)
    ).item()

    from ttamm.models import mimic_forward

    _, _, lu, li = mimic_forward(
        jnp.asarray(user_aug),
        jnp.asarray(item_aug),
        jnp.asarray(user_emb),
        jnp.asarray(item_emb),
    )
    assert float(lu) == pytest.approx(expected_u, rel=1e-5)
    assert float(li) == pytest.approx(expected_i, rel=1e-5)
