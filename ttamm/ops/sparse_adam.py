"""Sparse-row Adam: SparseAdam-semantics updates for embedding tables.

Re-creation of ``torch.optim.SparseAdam`` as used by the
reference for ``sparse=True`` embedding tables (``training.py:1341-1346``):

- only rows that received gradients this step are updated;
- duplicate indices are coalesced (gradients summed) before the update;
- first/second moments are per-row and persist in table-shaped buffers;
- bias correction uses a single global step count;
- no weight decay.

The dense-grad trap is avoided by construction: the training step gathers
rows *outside* the differentiated function, so gradients arrive as
``(indices [N], row_grads [N, D])`` pairs — never table-shaped zeros.

XLA-friendly duplicate coalescing with static shapes: sort the indices,
segment-sum the sorted grads, and scatter-ADD the update at every lane with
zero deltas on the lanes that are not a segment head — so duplicates never
race and the scatter sees sorted indices.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SparseAdamState(NamedTuple):
    m: jax.Array  # [rows, dim] first moment (same row count as the table)
    v: jax.Array  # [rows, dim] second moment
    step: jax.Array  # scalar int32 global step


class SparseAdamStatePacked(NamedTuple):
    """Moments packed lane-concatenated: ``mv[:, :D] = m``, ``mv[:, D:] = v``.

    One ``[n, 2D]`` row gather/scatter per step instead of two
    (``training.packed_moments``). Bit-identical to the separate layout
    (same op order per element).
    """

    mv: jax.Array  # [rows, 2*dim]
    step: jax.Array  # scalar int32 global step

    @property
    def m(self) -> jax.Array:
        return self.mv[:, : self.mv.shape[1] // 2]

    @property
    def v(self) -> jax.Array:
        return self.mv[:, self.mv.shape[1] // 2 :]


def init_sparse_adam(
    table: jax.Array, *, packed: bool = False
) -> SparseAdamState | SparseAdamStatePacked:
    if packed:
        rows, dim = table.shape
        return SparseAdamStatePacked(
            mv=jnp.zeros((rows, 2 * dim), table.dtype),
            step=jnp.zeros((), jnp.int32),
        )
    return SparseAdamState(
        m=jnp.zeros_like(table),
        v=jnp.zeros_like(table),
        step=jnp.zeros((), jnp.int32),
    )


def sparse_adam_update(
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
) -> tuple[jax.Array, SparseAdamState]:
    """Apply one SparseAdam step for the touched rows.

    ``weight_decay`` applies DECOUPLED (AdamW-style) decay to the touched
    rows only: ``w -= lr*wd*w`` once per step per coalesced row. This
    extends the reference — ``torch.optim.SparseAdam`` supports no weight
    decay at all (ref ``training.py:1341-1346``) — as a regularization
    lever for the in-batch softmax loss. Sparse semantics are preserved:
    untouched rows never decay.

    A packed state (``training.packed_moments``) takes the packed-moment
    path; both layouts give bit-identical tables.
    """
    update = (
        sparse_adam_update_packed
        if isinstance(state, SparseAdamStatePacked)
        else sparse_adam_update_sorted
    )
    return update(
        table, state, indices, row_grads, lr=lr, b1=b1, b2=b2, eps=eps,
        weight_decay=weight_decay,
    )


def sparse_adam_update_sorted(
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
) -> tuple[jax.Array, SparseAdamState]:
    """SparseAdam step via sorted scatter-ADD (same semantics as
    :func:`sparse_adam_update`).

    All lanes keep their *sorted* index; duplicate (non-head) lanes
    contribute zero deltas, so the scatter is an add with
    sorted indices. No scratch-row routing needed.
    """
    step = state.step + 1
    n = indices.shape[0]
    # bf16 comm_dtype arrives rounded; all math is fp32 from here.
    row_grads = row_grads.astype(table.dtype)

    order = jnp.argsort(indices.astype(jnp.int32))
    sorted_idx = indices.astype(jnp.int32)[order]
    sorted_grads = row_grads[order]

    prev = jnp.concatenate([jnp.array([-1], sorted_idx.dtype), sorted_idx[:-1]])
    is_head = sorted_idx != prev
    segment_ids = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    summed = jax.ops.segment_sum(sorted_grads, segment_ids, num_segments=n)
    grads = summed[segment_ids]  # coalesced total, valid at head lanes

    m_rows = state.m[sorted_idx]
    v_rows = state.v[sorted_idx]

    m_new = b1 * m_rows + (1.0 - b1) * grads
    v_new = b2 * v_rows + (1.0 - b2) * jnp.square(grads)
    t = step.astype(jnp.float32)
    m_hat = m_new / (1.0 - jnp.power(b1, t))
    v_hat = v_new / (1.0 - jnp.power(b2, t))
    # The weight delta is -lr*m_hat/(sqrt(v_hat)+eps): it never reads the
    # old weights, so skip the table[sorted_idx] gather entirely
    # (bit-identical output). Decoupled weight decay is the one feature
    # that re-enables the gather — only when requested.
    delta = lr * m_hat / (jnp.sqrt(v_hat) + eps)
    if weight_decay:
        delta = delta + (lr * weight_decay) * table[sorted_idx]

    head = is_head[:, None]
    new_table = table.at[sorted_idx].add(
        jnp.where(head, -delta, 0.0), indices_are_sorted=True
    )
    new_m = state.m.at[sorted_idx].add(
        jnp.where(head, m_new - m_rows, 0.0), indices_are_sorted=True
    )
    new_v = state.v.at[sorted_idx].add(
        jnp.where(head, v_new - v_rows, 0.0), indices_are_sorted=True
    )
    return new_table, SparseAdamState(m=new_m, v=new_v, step=step)


def sparse_adam_update_packed(
    table: jax.Array,
    state: SparseAdamStatePacked,
    indices: jax.Array,
    row_grads: jax.Array,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[jax.Array, SparseAdamStatePacked]:
    """Sorted scatter-ADD SparseAdam step over the packed ``[rows, 2D]``
    moment layout — bit-identical to :func:`sparse_adam_update_sorted`,
    with one moment gather + one moment scatter instead of two of each.
    """
    step = state.step + 1
    n = indices.shape[0]
    dim = table.shape[1]
    row_grads = row_grads.astype(table.dtype)

    order = jnp.argsort(indices.astype(jnp.int32))
    sorted_idx = indices.astype(jnp.int32)[order]
    sorted_grads = row_grads[order]

    prev = jnp.concatenate([jnp.array([-1], sorted_idx.dtype), sorted_idx[:-1]])
    is_head = sorted_idx != prev
    segment_ids = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    summed = jax.ops.segment_sum(sorted_grads, segment_ids, num_segments=n)
    grads = summed[segment_ids]

    mv_rows = state.mv[sorted_idx]  # ONE [n, 2D] gather
    m_rows = mv_rows[:, :dim]
    v_rows = mv_rows[:, dim:]

    m_new = b1 * m_rows + (1.0 - b1) * grads
    v_new = b2 * v_rows + (1.0 - b2) * jnp.square(grads)
    t = step.astype(jnp.float32)
    m_hat = m_new / (1.0 - jnp.power(b1, t))
    v_hat = v_new / (1.0 - jnp.power(b2, t))
    delta = lr * m_hat / (jnp.sqrt(v_hat) + eps)
    if weight_decay:
        delta = delta + (lr * weight_decay) * table[sorted_idx]

    head = is_head[:, None]
    new_table = table.at[sorted_idx].add(
        jnp.where(head, -delta, 0.0), indices_are_sorted=True
    )
    mv_upd = jnp.concatenate([m_new - m_rows, v_new - v_rows], axis=1)
    new_mv = state.mv.at[sorted_idx].add(
        jnp.where(head, mv_upd, 0.0), indices_are_sorted=True
    )
    return new_table, SparseAdamStatePacked(mv=new_mv, step=step)
