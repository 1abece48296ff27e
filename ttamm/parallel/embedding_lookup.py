"""Explicit sharded embedding lookup: the all-to-all ID exchange pattern.

The training step normally lets GSPMD lower ``jnp.take`` on a row-sharded
table into the exchange collectives automatically (``parallel/step.py``).
This module spells the same pattern out with ``shard_map`` — each shard
owns a contiguous row range; batch indices are broadcast, masked to the
owning shard, gathered locally, and the partial rows are psum-combined —
both as a reference implementation for tests/debugging and as the hook
point for a future hand-scheduled exchange kernel.

Backward: the transpose of the forward — row gradients are scattered-added
into the owning shard's range — implemented via ``jax.custom_vjp`` so the
lookup is differentiable end to end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from .mesh import MODEL_AXIS


def _lookup_local(table_shard: jax.Array, idx: jax.Array, rows_per_shard: int):
    shard_id = jax.lax.axis_index(MODEL_AXIS)
    base = shard_id * rows_per_shard
    local = idx - base
    mine = (local >= 0) & (local < rows_per_shard)
    safe = jnp.where(mine, local, 0)
    rows = jnp.take(table_shard, safe, axis=0)
    rows = jnp.where(mine[:, None], rows, 0.0)
    return jax.lax.psum(rows, MODEL_AXIS)


def _scatter_local(
    grad_rows: jax.Array, idx: jax.Array, rows_per_shard: int, dim: int
):
    shard_id = jax.lax.axis_index(MODEL_AXIS)
    base = shard_id * rows_per_shard
    local = idx - base
    mine = (local >= 0) & (local < rows_per_shard)
    safe = jnp.where(mine, local, 0)
    contrib = jnp.where(mine[:, None], grad_rows, 0.0)
    return jnp.zeros((rows_per_shard, dim), grad_rows.dtype).at[safe].add(contrib)


def make_sharded_lookup(mesh: Mesh, num_rows: int, dim: int):
    """Build a differentiable ``lookup(table, idx) -> rows`` over ``mesh``.

    ``table`` must be row-sharded over the ``model`` axis with ``num_rows``
    divisible by the axis size; ``idx`` is replicated. The VJP scatters row
    gradients back to the owning shards (sum over duplicate indices).
    """
    from jax import shard_map

    num_shards = mesh.shape[MODEL_AXIS]
    if num_rows % num_shards != 0:
        raise ValueError(
            f"num_rows={num_rows} must divide the model axis ({num_shards})."
        )
    rows_per_shard = num_rows // num_shards

    fwd_mapped = shard_map(
        partial(_lookup_local, rows_per_shard=rows_per_shard),
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), P()),
        out_specs=P(),
        check_vma=False,
    )
    bwd_mapped = shard_map(
        partial(_scatter_local, rows_per_shard=rows_per_shard, dim=dim),
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(MODEL_AXIS, None),
        check_vma=False,
    )

    @jax.custom_vjp
    def lookup(table, idx):
        return fwd_mapped(table, idx)

    def lookup_fwd(table, idx):
        return fwd_mapped(table, idx), idx

    def lookup_bwd(idx, grad_rows):
        return bwd_mapped(grad_rows, idx), None

    lookup.defvjp(lookup_fwd, lookup_bwd)
    return lookup
