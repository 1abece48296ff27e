"""Bucketed all-to-all embedding exchange (the DLRM embedding-sharding pattern).

Explicit alternative to letting the partitioner lower ``jnp.take`` on a
row-sharded table (``parallel/step.py``). Each device owns a contiguous
row range of the table (``model`` axis) and a sub-chunk of the batch
(``data`` × ``model``). The lookup routes each id to its owning shard,
gathers locally, and routes the rows back:

1. sort the local ids by owning shard (one cheap [n] argsort);
2. exchange per-destination counts (an [S] all-gather of ints);
3. all-to-all the bucketed ids to their owners;
4. every owner gathers its local rows for the ids it received;
5. all-to-all the rows back; undo the sort.

Two collective layouts share that routing plan:

- ``dense``: fixed worst-case capacity ``n`` per (src, dst) pair via
  ``lax.all_to_all`` — exact for any id distribution, runs on every
  backend (tests use the 8-device CPU mesh). Wire bytes are the static
  buffer: (S-1)·n·D floats per device — half the replicated-psum
  pattern's 2·(S-1)/S·S·n·D and, unlike it, the output stays sharded.
- ``ragged``: ``lax.ragged_all_to_all`` moves only the real bucket
  sizes — ≈(S-1)/S·n·D on the wire for a balanced batch, the speed-of-
  light exchange. Accelerator backends only (XLA:CPU has no
  ragged-all-to-all thunk); an explicit choice, never ``"auto"``.

The transpose (gradient) path all-gathers the batch-shaped row grads
over ``data`` (so every replica applies identical updates — Adam is
nonlinear, the reduction must happen on grads, not tables), routes them
to the owning shards with the same bucket plan, and scatter-adds
locally; the table-shaped gradient never crosses a link
(``tests/test_hlo_collectives.py`` pins this for the whole step).

Reference being replaced: the monolithic ``nn.Embedding`` gather,
the reference's ``src/models/encoders.py:54-60``; pattern spec
SURVEY.md §2.3.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import DATA_AXIS, MODEL_AXIS


class RoutePlan(NamedTuple):
    """Static-shape routing of local ids to their owning shards."""

    order: jax.Array  # [n] permutation sorting ids by owner
    inv_order: jax.Array  # [n] inverse permutation
    sorted_ids: jax.Array  # [n] ids grouped by destination bucket
    counts: jax.Array  # [S] ids bound for each shard
    starts: jax.Array  # [S] exclusive cumsum of counts (bucket starts)
    slots: jax.Array  # [n] flat position of each sorted id in an
    #     [S, capacity] send buffer (bucket-major)


def route_by_owner(ids: jax.Array, rows_per_shard: int, num_shards: int,
                   capacity: int) -> RoutePlan:
    """Pure routing math (unit-testable without a mesh)."""
    n = ids.shape[0]
    owner = jnp.clip(ids // rows_per_shard, 0, num_shards - 1)
    order = jnp.argsort(owner)
    sorted_owner = owner[order]
    counts = jnp.bincount(owner, length=num_shards)
    starts = jnp.cumsum(counts) - counts
    within = jnp.arange(n, dtype=jnp.int32) - starts[sorted_owner]
    slots = sorted_owner * capacity + within
    return RoutePlan(
        order=order,
        inv_order=jnp.argsort(order),
        sorted_ids=ids[order],
        counts=counts,
        starts=starts,
        slots=slots,
    )


def _dense_exchange_rows(table_shard, ids, *, rows_per_shard, num_shards):
    """Steps 1-5 with fixed capacity-``n`` buffers (``lax.all_to_all``)."""
    n = ids.shape[0]
    me = jax.lax.axis_index(MODEL_AXIS)
    plan = route_by_owner(ids, rows_per_shard, num_shards, capacity=n)

    send_ids = (
        jnp.zeros((num_shards * n,), jnp.int32)
        .at[plan.slots]
        .set(plan.sorted_ids)
        .reshape(num_shards, n)
    )
    got_ids = jax.lax.all_to_all(
        send_ids, MODEL_AXIS, split_axis=0, concat_axis=0, tiled=True
    )
    local = jnp.clip(got_ids - me * rows_per_shard, 0, rows_per_shard - 1)
    rows = jnp.take(table_shard, local.reshape(-1), axis=0)
    # Slots beyond recv_sizes hold garbage rows; they ride back but the
    # readout below never touches them — masking would only cost a pass.
    rows = rows.reshape(num_shards, n, -1)
    back = jax.lax.all_to_all(
        rows, MODEL_AXIS, split_axis=0, concat_axis=0, tiled=True
    )
    out_sorted = back.reshape(num_shards * n, -1)[plan.slots]
    return out_sorted[plan.inv_order]


def _ragged_exchange_rows(table_shard, ids, *, rows_per_shard, num_shards):
    """Steps 1-5 moving only real bucket bytes (``ragged_all_to_all``)."""
    n = ids.shape[0]
    dim = table_shard.shape[-1]
    me = jax.lax.axis_index(MODEL_AXIS)
    plan = route_by_owner(ids, rows_per_shard, num_shards, capacity=n)

    counts_mat = jax.lax.all_gather(plan.counts, MODEL_AXIS)  # [S, S]
    starts_mat = jax.lax.all_gather(plan.starts, MODEL_AXIS)  # [S, S]
    recv_sizes = counts_mat[:, me]
    recv_starts = jnp.cumsum(recv_sizes) - recv_sizes
    # Where my chunk lands in each owner's buffer: after every lower-
    # ranked sender's chunk for that owner.
    out_offsets = (jnp.cumsum(counts_mat, axis=0) - counts_mat)[me]

    id_buf = jnp.zeros((num_shards * n,), jnp.int32)
    got_ids = jax.lax.ragged_all_to_all(
        plan.sorted_ids, id_buf,
        plan.starts, plan.counts, out_offsets, recv_sizes,
        axis_name=MODEL_AXIS,
    )
    local = jnp.clip(got_ids - me * rows_per_shard, 0, rows_per_shard - 1)
    rows = jnp.take(table_shard, local, axis=0)

    row_buf = jnp.zeros((n, dim), table_shard.dtype)
    # Return trip: my rows for requester r land at r's bucket-me start.
    back = jax.lax.ragged_all_to_all(
        rows, row_buf,
        recv_starts, recv_sizes, starts_mat[:, me], plan.counts,
        axis_name=MODEL_AXIS,
    )
    return back[plan.inv_order]


def _grad_scatter_local(grad_rows, ids, *, rows_per_shard, num_shards):
    """Transpose path: route row grads to owners, scatter-add shard-local.

    Runs per device under shard_map over BOTH axes. The ``data``-axis
    all-gather makes every replica of a table shard see the full batch's
    grads, so the scattered shard gradient is identical across ``data``
    without any table-shaped reduction.
    """
    me = jax.lax.axis_index(MODEL_AXIS)
    g = jax.lax.all_gather(grad_rows, DATA_AXIS, axis=0, tiled=True)
    i = jax.lax.all_gather(ids, DATA_AXIS, axis=0, tiled=True)
    n = i.shape[0]
    dim = g.shape[-1]
    plan = route_by_owner(i, rows_per_shard, num_shards, capacity=n)

    send_ids = (
        jnp.full((num_shards * n,), num_shards * rows_per_shard, jnp.int32)
        .at[plan.slots]
        .set(plan.sorted_ids)
        .reshape(num_shards, n)
    )
    send_g = (
        jnp.zeros((num_shards * n, dim), g.dtype)
        .at[plan.slots]
        .set(g[plan.order])
        .reshape(num_shards, n, dim)
    )
    got_ids = jax.lax.all_to_all(
        send_ids, MODEL_AXIS, split_axis=0, concat_axis=0, tiled=True
    ).reshape(-1)
    got_g = jax.lax.all_to_all(
        send_g, MODEL_AXIS, split_axis=0, concat_axis=0, tiled=True
    ).reshape(-1, dim)
    # Pad slots carry the sentinel id (out of range) and a zero grad:
    # 'drop' mode makes them no-ops.
    local = got_ids - me * rows_per_shard
    return (
        jnp.zeros((rows_per_shard, dim), g.dtype)
        .at[local]
        .add(got_g, mode="drop")
    )


def make_exchange_lookup(
    mesh: Mesh, num_rows: int, *, variant: str = "auto"
):
    """Differentiable ``lookup(table, ids) -> rows`` over ``mesh``.

    ``table``: [num_rows, D] sharded ``P(model, None)`` (num_rows must
    divide the model axis — ``pad_state_rows`` guarantees it).
    ``ids``: [B] int32; B must divide the mesh device count (the step
    wrapper pads). Output rows are sharded ``P((data, model), None)``.

    variant: 'dense' | 'ragged' | 'auto' (= 'dense' on every backend; the
    ragged all-to-all stays an explicit choice).
    """
    from jax import shard_map

    num_shards = mesh.shape[MODEL_AXIS]
    if num_rows % num_shards != 0:
        raise ValueError(
            f"num_rows={num_rows} must divide the model axis ({num_shards})."
        )
    rows_per_shard = num_rows // num_shards
    if variant == "auto":
        variant = "dense"
    if variant not in {"dense", "ragged"}:
        raise ValueError(f"Unknown exchange variant: {variant}")
    exchange = (
        _ragged_exchange_rows if variant == "ragged" else _dense_exchange_rows
    )

    fwd_mapped = shard_map(
        partial(
            exchange, rows_per_shard=rows_per_shard, num_shards=num_shards
        ),
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), P((DATA_AXIS, MODEL_AXIS))),
        out_specs=P((DATA_AXIS, MODEL_AXIS), None),
        check_vma=False,
    )
    bwd_mapped = shard_map(
        partial(
            _grad_scatter_local,
            rows_per_shard=rows_per_shard,
            num_shards=num_shards,
        ),
        mesh=mesh,
        in_specs=(P((DATA_AXIS, MODEL_AXIS), None), P((DATA_AXIS, MODEL_AXIS))),
        out_specs=P(MODEL_AXIS, None),
        check_vma=False,
    )

    @jax.custom_vjp
    def lookup(table, ids):
        return fwd_mapped(table, ids)

    def lookup_fwd(table, ids):
        return fwd_mapped(table, ids), ids

    def lookup_bwd(ids, grad_rows):
        return bwd_mapped(grad_rows, ids), None

    lookup.defvjp(lookup_fwd, lookup_bwd)
    return lookup


def padded_exchange_lookup(mesh: Mesh, table: jax.Array, ids: jax.Array,
                           *, variant: str = "auto") -> jax.Array:
    """Lookup with automatic id padding to the mesh device count."""
    devices = mesh.shape[DATA_AXIS] * mesh.shape[MODEL_AXIS]
    b = ids.shape[0]
    padded = -(-b // devices) * devices
    if padded != b:
        ids = jnp.concatenate(
            [ids, jnp.zeros((padded - b,), ids.dtype)]
        )
    lookup = make_exchange_lookup(mesh, table.shape[0], variant=variant)
    return lookup(table, ids)[:b]
