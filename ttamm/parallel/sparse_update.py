"""Mesh-composable sparse-row Adam: the row update runs shard-locally
inside ``shard_map``.

GSPMD partitions the default single-device update (``ops/sparse_adam.py``)
against a row-sharded table, and under a mesh the train step's replicate
constraints make it all-gather the global batch's row grads. This module
instead applies the update by manual partitioning, so the cross-chip
exchange can be cut to what each shard owns.

Two wire routings for the cross-chip row-grad exchange:

``routing='allgather'``:
1. all-gather the batch's ``(indices, row_grads)`` over the ``data`` axis
   (batch-sized traffic — [n, D] rows, never a [rows, D] table);
2. coalesce duplicate indices exactly like the single-device path (stable
   sort + segment-sum, identical summation order → identical numerics);
3. each ``model`` shard remaps global row ids to its local range and
   sends the lanes it does not own — and every non-head duplicate lane —
   to an out-of-range sentinel row;
4. ``jnp.take(mode="fill")`` / ``.at[].set(mode="drop")`` gather and
   scatter only the owned head lanes — no write ever crosses a shard
   boundary and every written row is written once.

``routing='owner'`` (the shard-owner cut): the all-gather above makes
every chip receive the FULL global batch's row grads (``n x D``) even
though each model shard applies only the ``~n/mp`` lanes it owns. Because
the batch is replicated over the ``model`` axis, each chip ALREADY HOLDS
every lane its shard owns from its own data shard — no all-to-all is
needed at all. Owner routing therefore:

1. coalesces the LOCAL ``n/dp`` lanes (stable sort + segment-sum);
2. compacts the coalesced lanes OWNED by this chip's model shard into a
   static ``C``-lane buffer (``C = ceil(capacity_factor * n/(dp*mp))``);
3. all-gathers only the compacted ``(idx [C], grads [C, D])`` over
   ``data`` — per-chip receive drops from ``n x D`` to ``dp*C x D``,
   i.e. ~``capacity_factor/mp`` of the allgather routing's wire;
4. re-coalesces the gathered ``dp*C`` lanes (the same row touched by two
   data shards arrives twice) and applies the shard-local row update —
   sentinel ``idx = -1`` capacity padding is dropped like a foreign lane.

Overflow is GUARANTEED handled, never dropped: if any chip's owned-lane
count exceeds ``C`` (data-dependent — id popularity can skew shard
loads), a one-int ``pmax`` over both mesh axes raises a replicated flag
and ``lax.cond`` routes THAT step through the full allgather path (both
branches are compiled once; the predicate is mesh-uniform by
construction, so every device takes the same branch and the collectives
inside the branches stay coherent). Numerics: owner routing sums each
row's duplicates in two phases (within data shard, then across shards)
instead of one global sorted pass — deterministic, but not bit-identical
to the allgather routing (tests pin ``allclose`` at 1e-5 and loss
equality at 1e-4, like the mesh-vs-single-device suite).

Every data-replica of a table shard applies the same update (the
all-gather makes the exchanged lanes identical everywhere), so replicas
stay bit-identical without any cross-replica reduction.

Reference capability being scaled: ``torch.optim.SparseAdam`` on huge
``sparse=True`` embedding tables (reference ``src/pipelines/
training.py:1341-1346``), row-sharded per SURVEY §2.3; owner routing
makes the exchange scale with ``batch/mp`` instead of ``batch``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.sparse_adam import SparseAdamState
from .mesh import DATA_AXIS, MODEL_AXIS


def _coalesce_sorted(idx: jax.Array, grads: jax.Array, *, head_init: int):
    """Stable-sort lanes by row id and segment-sum duplicate runs.

    Returns ``(sorted_idx, grads_coal, is_head, seg)`` where EVERY lane of
    a duplicate run carries the run's coalesced total.
    ``head_init`` must sort strictly below every possible id (-1 for
    non-negative ids, -2 when sentinel -1 lanes are present).
    """
    n = idx.shape[0]
    order = jnp.argsort(idx)
    sorted_idx = idx[order]
    sorted_grads = grads[order]
    prev = jnp.concatenate(
        [jnp.array([head_init], sorted_idx.dtype), sorted_idx[:-1]]
    )
    is_head = sorted_idx != prev
    seg = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    summed = jax.ops.segment_sum(sorted_grads, seg, num_segments=n)
    return sorted_idx, summed[seg], is_head, seg


def owner_capacity(n: int, dp: int, mp: int, capacity_factor: float) -> int:
    """Static per-chip compaction capacity for owner routing.

    ``capacity_factor`` x the balanced per-shard share of this chip's
    ``n/dp`` local lanes, capped at the local lane count (where owner
    routing degenerates to the allgather wire volume but can never
    overflow).
    """
    n_local = n // dp
    return min(max(1, -(-int(capacity_factor * n_local) // mp)), n_local)


def sharded_sparse_adam_update(
    mesh: Mesh,
    table: jax.Array,
    state: SparseAdamState,
    indices: jax.Array,
    row_grads: jax.Array,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    routing: str = "allgather",
    capacity_factor: float = 2.0,
) -> tuple[jax.Array, SparseAdamState]:
    """SparseAdam step over a row-sharded table, applied shard-locally.
    Call inside a jit compiled for ``mesh``; semantics match
    :func:`ttamm.ops.sparse_adam.sparse_adam_update` to ``allclose``
    tolerance (same coalesce order and per-row math under
    ``routing='allgather'``; two-phase duplicate summation under
    ``routing='owner'`` — see module docstring). The lane count must
    divide the ``data`` axis.
    """
    from jax import shard_map

    if routing not in ("allgather", "owner", "owner_unchecked"):
        raise ValueError(f"Unknown update routing: {routing}")
    unchecked = routing == "owner_unchecked"
    n = indices.shape[0]
    num_shards = mesh.shape[MODEL_AXIS]
    dp = mesh.shape[DATA_AXIS]
    if n % dp != 0:
        raise ValueError(
            f"sharded_sparse_adam_update: {n} lanes do not divide "
            f"data={dp}"
        )
    rows_per_shard = table.shape[0] // num_shards
    assert table.shape[0] % num_shards == 0, (
        f"table rows {table.shape[0]} not divisible by model={num_shards} "
        "(pad_state_rows)"
    )
    cap = owner_capacity(n, dp, num_shards, capacity_factor)

    def _widen(grads):
        if grads.dtype != table.dtype:
            # The barrier pins the widen AFTER the collective — XLA
            # otherwise rewrites convert(all_gather_bf16(x)) into
            # all_gather_f32(convert(x)), putting f32 back on the wire
            # (observed in compiled HLO).
            grads = jax.lax.optimization_barrier(grads).astype(table.dtype)
        return grads

    def _apply(table, m, v, step, lane_idx, grads_coal, lr):
        """Adam tail shared by both routings: gather the owned lanes'
        rows, step them, scatter back. ``lane_idx`` is shard-LOCAL with
        -1 = skip (foreign, duplicate or capacity-padding lane): it maps
        to an out-of-range row that the gather fills and the scatter
        drops.
        """
        lane_idx = jnp.where(lane_idx >= 0, lane_idx, rows_per_shard)

        def take(x):
            return jnp.take(x, lane_idx, axis=0, mode="fill", fill_value=0)

        def put(x, rows):
            return x.at[lane_idx].set(rows, mode="drop")

        m_rows, v_rows, w_rows = take(m), take(v), take(table)

        new_step = step + 1
        m_new = b1 * m_rows + (1.0 - b1) * grads_coal
        v_new = b2 * v_rows + (1.0 - b2) * jnp.square(grads_coal)
        t = new_step.astype(jnp.float32)
        m_hat = m_new / (1.0 - jnp.power(b1, t))
        v_hat = v_new / (1.0 - jnp.power(b2, t))
        delta = lr * m_hat / (jnp.sqrt(v_hat) + eps)
        if weight_decay:
            # Decoupled decay on touched rows (duplicate lanes compute
            # the same value; masked-lane w_rows are never written back).
            delta = delta + (lr * weight_decay) * w_rows

        new_table = put(table, w_rows - delta)
        new_m = put(m, m_new)
        new_v = put(v, v_new)
        return new_table, new_m, new_v, new_step

    def _allgather_update(table, m, v, step, idx, grads, lr):
        # [n/dp] -> [n]: identical global batch on every device; the
        # all-gather moves batch-row-sized data over the data axis only.
        # A bf16 comm_dtype halves this and widens right after; all
        # update math stays in the table dtype.
        idx = jax.lax.all_gather(idx, DATA_AXIS, axis=0, tiled=True)
        grads = _widen(
            jax.lax.all_gather(grads, DATA_AXIS, axis=0, tiled=True)
        )

        # Coalesce duplicates in the SAME order as the single-device
        # sorted path: stable sort by row id, segment-sum runs. Foreign
        # lanes (rows another shard owns) and non-head duplicates skip.
        sorted_idx, grads_coal, is_head, _ = _coalesce_sorted(
            idx, grads, head_init=-1
        )
        shard = jax.lax.axis_index(MODEL_AXIS)
        local = sorted_idx - shard * rows_per_shard
        owned = is_head & (local >= 0) & (local < rows_per_shard)
        lane_idx = jnp.where(owned, local, -1)
        return _apply(table, m, v, step, lane_idx, grads_coal, lr)

    def _owner_update(table, m, v, step, idx, grads_wire, lr):
        """Compact-owned-lanes + capacity all-gather (module docstring)."""
        # Local coalesce in the TABLE dtype (a bf16 comm_dtype rounds at
        # the wire below, not in the sums).
        grads = grads_wire.astype(table.dtype)
        sorted_idx, grads_coal, is_head, _ = _coalesce_sorted(
            idx, grads, head_init=-1
        )
        shard = jax.lax.axis_index(MODEL_AXIS)
        local = sorted_idx - shard * rows_per_shard
        owned = is_head & (local >= 0) & (local < rows_per_shard)
        pos = jnp.cumsum(owned.astype(jnp.int32)) - 1
        count = jnp.sum(owned.astype(jnp.int32))

        def owner_branch():
            # Compact the owned head lanes into the [cap] buffer; the
            # +1 slot absorbs every discarded write (non-owned lanes and
            # would-be overflow — the cond guarantees there is none).
            tgt = jnp.where(owned & (pos < cap), pos, cap)
            idx_c = (
                jnp.full((cap + 1,), -1, jnp.int32)
                .at[tgt].set(jnp.where(owned, sorted_idx, -1))[:cap]
            )
            g_c = (
                jnp.zeros((cap + 1, grads.shape[1]), table.dtype)
                .at[tgt].set(jnp.where(owned[:, None], grads_coal, 0.0))[:cap]
            )
            if grads_wire.dtype != table.dtype:
                # comm_dtype wire cast: barrier-pinned on both sides so
                # the collective itself is emitted in bf16.
                g_c = jax.lax.optimization_barrier(
                    g_c.astype(grads_wire.dtype)
                )
            # The owner exchange: [cap] per chip instead of [n/dp] —
            # every gathered lane is owned by THIS model shard, so the
            # per-chip receive is ~1/mp of the allgather routing's.
            idx_all = jax.lax.all_gather(idx_c, DATA_AXIS, axis=0, tiled=True)
            g_all = _widen(
                jax.lax.all_gather(g_c, DATA_AXIS, axis=0, tiled=True)
            )
            if dp == 1:
                # One data shard (1xN model-only meshes, 1x1 checks):
                # the compacted lanes are already sorted-unique coalesced
                # totals — the cross-shard coalesce is a no-op.
                s2, g2_coal, head2 = idx_all, g_all, True
            else:
                # Cross-data-shard coalesce: the same row touched by two
                # data shards arrives once per shard. Sentinel -1
                # capacity padding sorts to the front as one skipped run
                # (head_init=-2 keeps lane 0 a head even when it is a
                # sentinel).
                s2, g2_coal, head2, _ = _coalesce_sorted(
                    idx_all, g_all, head_init=-2
                )
            lane_idx = jnp.where(
                head2 & (s2 >= 0), s2 - shard * rows_per_shard, -1
            )
            return _apply(table, m, v, step, lane_idx, g2_coal, lr)

        def fallback_branch():
            # Guaranteed overflow handling: re-run this step through the
            # full allgather routing (correct at any skew, just wider;
            # re-exchanges the UNSUMMED wire-dtype grads so the branch
            # matches the allgather routing exactly).
            return _allgather_update(table, m, v, step, idx, grads_wire, lr)

        if unchecked:
            # 'owner_unchecked': no overflow cond — for compiled-HLO wire
            # analysis (a cond would double-count the fallback branch's
            # collectives) and for deployments whose capacity has been
            # audited against the id distribution. Overflowing lanes ARE
            # SILENTLY DROPPED here; use 'owner' unless you know the
            # capacity holds.
            return owner_branch()
        # Replicated overflow flag: pmax over BOTH axes makes every
        # device agree, so the cond (and the collectives inside each
        # branch) are mesh-uniform.
        overflow = jax.lax.pmax(
            (count > cap).astype(jnp.int32), (DATA_AXIS, MODEL_AXIS)
        )
        return jax.lax.cond(
            overflow > 0, fallback_branch, owner_branch
        )

    def body(table, m, v, step, idx, grads, lr):
        idx = idx.astype(jnp.int32)
        if routing != "allgather":
            return _owner_update(table, m, v, step, idx, grads, lr)
        return _allgather_update(table, m, v, step, idx, grads, lr)

    row = P(MODEL_AXIS, None)
    fn = shard_map(
        body,
        mesh=mesh,
        # lr rides as a replicated operand (not a closure constant) so a
        # traced scheduled lr (train.optim.lr_scale) works under the mesh.
        in_specs=(row, row, row, P(), P(DATA_AXIS), P(DATA_AXIS, None), P()),
        out_specs=(row, row, row, P()),
        check_vma=False,
    )
    new_table, new_m, new_v, new_step = fn(
        table, state.m, state.v, state.step, indices, row_grads,
        jnp.asarray(lr, jnp.float32),
    )
    return new_table, SparseAdamState(m=new_m, v=new_v, step=new_step)
