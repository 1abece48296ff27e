"""Bucketed all-to-all embedding exchange tests (8-device CPU mesh).

The ``dense`` collective layout runs everywhere, so it carries the
numeric tests; the ``ragged`` layout shares every line of routing math
(``route_by_owner``), which is unit-tested directly. Adversarial id
distributions (all ids on one shard, duplicates) exercise the static
worst-case capacity.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.parallel import MeshConfig, build_mesh
from ttamm.parallel.exchange import (
    make_exchange_lookup,
    padded_exchange_lookup,
    route_by_owner,
)

ROWS, D = 64, 8


def _mesh(dp, mp):
    return build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))


def _table(seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, 1, (ROWS, D)).astype(np.float32))


def test_route_by_owner_plan():
    ids = jnp.asarray([13, 2, 13, 63, 0, 7], dtype=jnp.int32)
    plan = route_by_owner(ids, rows_per_shard=8, num_shards=8, capacity=6)
    owners = np.asarray(ids) // 8
    # sorted ids grouped by owner, counts/starts consistent
    assert np.array_equal(np.sort(owners), owners[np.asarray(plan.order)])
    assert np.asarray(plan.counts).sum() == 6
    assert np.array_equal(
        np.asarray(plan.starts),
        np.concatenate([[0], np.cumsum(np.asarray(plan.counts))[:-1]]),
    )
    # inverse permutation really inverts
    assert np.array_equal(
        np.asarray(plan.sorted_ids)[np.asarray(plan.inv_order)],
        np.asarray(ids),
    )
    # each slot is inside its owner's capacity range
    slots = np.asarray(plan.slots)
    so = np.sort(owners)
    assert np.all(slots // 6 == so)
    assert np.all(slots % 6 < 6)


@pytest.mark.parametrize("dp,mp", [(1, 8), (2, 4), (4, 2)])
def test_exchange_matches_take(dp, mp):
    mesh = _mesh(dp, mp)
    table = _table()
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(0, ROWS, 32).astype(np.int32))
    lookup = make_exchange_lookup(mesh, ROWS, variant="dense")
    out = lookup(table, ids)
    assert np.allclose(np.asarray(out), np.asarray(table)[np.asarray(ids)])


def test_exchange_all_ids_one_shard():
    """Worst-case routing: every id lives on the last shard (capacity n)."""
    mesh = _mesh(2, 4)
    table = _table(2)
    ids = jnp.asarray(np.full(16, ROWS - 3, np.int32))  # all -> shard 3
    lookup = make_exchange_lookup(mesh, ROWS, variant="dense")
    out = lookup(table, ids)
    assert np.allclose(np.asarray(out), np.asarray(table)[np.asarray(ids)])


def test_exchange_gradient_matches_take():
    """VJP must scatter-add duplicate-id grads exactly like jnp.take's."""
    mesh = _mesh(2, 4)
    table = _table(3)
    rng = np.random.default_rng(4)
    ids = jnp.asarray(rng.integers(0, ROWS, 16).astype(np.int32))
    ids = ids.at[3].set(int(ids[11]))  # force duplicates
    cot = jnp.asarray(rng.normal(0, 1, (16, D)).astype(np.float32))

    lookup = make_exchange_lookup(mesh, ROWS, variant="dense")
    g_ex = jax.grad(lambda t: jnp.vdot(lookup(t, ids), cot))(table)
    g_ref = jax.grad(lambda t: jnp.vdot(jnp.take(t, ids, axis=0), cot))(table)
    assert np.allclose(np.asarray(g_ex), np.asarray(g_ref), atol=1e-6)


def _emulated_ragged_all_to_all(
    operand, output, input_offsets, send_sizes, output_offsets, recv_sizes,
    *, axis_name,
):
    """Reference implementation of ``lax.ragged_all_to_all`` semantics
    using only all_gather + masked scatters (runs on XLA:CPU, which lacks
    the ragged thunk). Per the op's contract, for every (source s, dest d):
    s's operand[input_offsets[d] : +send_sizes[d]] lands at offset
    output_offsets[d] of d's output buffer."""
    ops = jax.lax.all_gather(operand, axis_name)            # [S, n, ...]
    in_off = jax.lax.all_gather(input_offsets, axis_name)   # [S, S]
    sizes = jax.lax.all_gather(send_sizes, axis_name)       # [S, S]
    out_off = jax.lax.all_gather(output_offsets, axis_name) # [S, S]
    me = jax.lax.axis_index(axis_name)
    n = operand.shape[0]
    ar = jnp.arange(n, dtype=jnp.int32)
    out = output
    for s in range(ops.shape[0]):
        chunk = jnp.take(
            ops[s], jnp.clip(in_off[s, me] + ar, 0, n - 1), axis=0
        )
        valid = ar < sizes[s, me]
        dst = jnp.where(valid, out_off[s, me] + ar, output.shape[0])
        out = out.at[dst].set(chunk, mode="drop")
    return out


@pytest.mark.parametrize(
    "ids_fn",
    [
        lambda rng: rng.integers(0, ROWS, 32).astype(np.int32),
        lambda rng: np.full(32, ROWS - 3, np.int32),  # all on one shard
        lambda rng: np.repeat(
            rng.integers(0, ROWS, 8).astype(np.int32), 4
        ),  # heavy duplicates
    ],
)
def test_ragged_exchange_routing_matches_take(monkeypatch, ids_fn):
    """Execute the REAL ``_ragged_exchange_rows`` code — every line of its
    offset bookkeeping (counts/starts matrices, recv offsets, return-trip
    landing slots) — with only the collective swapped for a semantics-
    faithful emulation (XLA:CPU has no ragged-all-to-all thunk). The
    GPU lowering itself is exercised by ``scripts/check_ragged_exchange.py``
    and ``chip_smoke.py --multi``."""
    monkeypatch.setattr(
        jax.lax, "ragged_all_to_all", _emulated_ragged_all_to_all
    )
    mesh = _mesh(2, 4)
    table = _table(7)
    rng = np.random.default_rng(8)
    ids = jnp.asarray(ids_fn(rng))
    lookup = make_exchange_lookup(mesh, ROWS, variant="ragged")
    out = lookup(table, ids)
    assert np.allclose(np.asarray(out), np.asarray(table)[np.asarray(ids)])


def test_padded_exchange_lookup():
    mesh = _mesh(2, 4)
    table = _table(5)
    rng = np.random.default_rng(6)
    ids = jnp.asarray(rng.integers(0, ROWS, 13).astype(np.int32))  # 13 % 8 != 0
    out = padded_exchange_lookup(mesh, table, ids, variant="dense")
    assert out.shape == (13, D)
    assert np.allclose(np.asarray(out), np.asarray(table)[np.asarray(ids)])
