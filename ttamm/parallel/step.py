"""Mesh-sharded training step and distributed corpus encode / MIPS top-K.

``make_sharded_train_step`` compiles the SAME step function as the
single-chip path (``ttamm.train.step``) under explicit in/out
shardings: dp batch sharding over ``data``, row-sharded tables over
``model``. XLA GSPMD lowers the table gathers/scatters into the all-gather
+ masked-gather + psum exchange pattern and psum-reduces dense grads —
no separate multi-chip code path to maintain.

``sharded_mips_topk`` uses ``shard_map`` for the eval sweep: each model
shard scores its local item rows and produces a local top-k; a cross-shard
all-gather + merge yields the global top-k (the distributed form of the
reference's chunked merge, ref ``training.py:372-382``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.two_tower import ModelConfig
from ..ops.topk import mips_topk
from ..train.state import BatchData, TrainState
from ..train.step import TrainStepConfig, make_train_step
from .mesh import DATA_AXIS, MODEL_AXIS
from .sharding import batch_sharding, data_shardings, state_shardings


def make_sharded_train_step(
    cfg: ModelConfig,
    tscfg: TrainStepConfig,
    mesh: Mesh,
    state_template: TrainState,
    data_template: BatchData,
    *,
    tensor_parallel: bool = False,
):
    """Jit the train step with explicit mesh shardings (donated state).

    ``tensor_parallel`` must match how the state was placed
    (``place_state``): True additionally shards dense tower params and
    their moments over the ``model`` axis.
    """
    base_step = make_train_step(
        cfg, tscfg, mesh=mesh, tensor_parallel=tensor_parallel
    )
    # Re-jit the underlying function with shardings: reach for the wrapped
    # fn to avoid double-jit overhead.
    inner = base_step.__wrapped__ if hasattr(base_step, "__wrapped__") else base_step

    st_shard = state_shardings(
        mesh, state_template, tensor_parallel=tensor_parallel
    )
    dt_shard = data_shardings(mesh, data_template)
    b_shard = batch_sharding(mesh)
    rep = NamedSharding(mesh, P())

    metric_shardings = {
        "loss": rep,
        "retrieval_loss": rep,
        "mimic_user_loss": rep,
        "mimic_item_loss": rep,
        "category_alignment_loss": rep,
    }
    return jax.jit(
        inner,
        in_shardings=(st_shard, dt_shard, b_shard, b_shard, rep),
        out_shardings=(st_shard, metric_shardings),
        donate_argnums=(0,),
    )


def make_sharded_multi_train_step(
    cfg: ModelConfig,
    tscfg: TrainStepConfig,
    mesh: Mesh,
    state_template: TrainState,
    data_template: BatchData,
    *,
    tensor_parallel: bool = False,
):
    """Explicit-shardings jit of the K-batch scanned step (donated state).

    The mesh analog of ``train.step.make_multi_train_step`` — one compile
    path for bench, tests, dryrun AND the production pipeline: in/out
    shardings pinned (state as placed, ``[K, B]`` batch index chunks
    sharded over ``data`` on their batch axis), state donated.
    """
    from ..train.step import make_train_step

    base = make_train_step(
        cfg, tscfg, mesh=mesh, tensor_parallel=tensor_parallel
    )
    raw_step = base.__wrapped__

    def multi(state: TrainState, data: BatchData, u_all, p_all, rng):
        steps = u_all.shape[0]

        def body(st, xs):
            u, p, i = xs
            st, metrics = raw_step(st, data, u, p, jax.random.fold_in(rng, i))
            return st, metrics["loss"]

        return jax.lax.scan(
            body, state, (u_all, p_all, jnp.arange(steps, dtype=jnp.int32))
        )

    st_shard = state_shardings(
        mesh, state_template, tensor_parallel=tensor_parallel
    )
    dt_shard = data_shardings(mesh, data_template)
    chunk_shard = NamedSharding(mesh, P(None, DATA_AXIS))
    rep = NamedSharding(mesh, P())
    return jax.jit(
        multi,
        in_shardings=(st_shard, dt_shard, chunk_shard, chunk_shard, rep),
        out_shardings=(st_shard, rep),
        donate_argnums=(0,),
    )


def make_sharded_topk(
    mesh: Mesh,
    *,
    k: int,
    padded_rows: int,
    num_valid_rows: int,
    chunk_size: int = 8192,
    normalize_queries: bool = False,
    score_dtype: str = "float32",
    with_mask: bool = False,
):
    """Build the shard-mapped distributed top-k callable.

    ``(queries [B, D], item_shards [padded_rows, D])`` (+ optional
    ``mask_rows [B, M]`` of GLOBAL item ids when ``with_mask``) ->
    ``(scores [B, k], global idx [B, k])``. Items are row-sharded
    ``P(model, None)``; each shard searches its local rows and an
    all-gather of the [B, k]-sized local winners merges globally — the
    full corpus never crosses a link. Callable inside an outer jit (the
    EvalPlan scan uses it per user batch). ``padded_rows`` must be a
    multiple of the shard count with the padding confined to the last
    shard (pad by less than one shard's rows).
    """
    from jax import shard_map

    num_shards = mesh.shape[MODEL_AXIS]
    rows_per_shard = padded_rows // num_shards
    num_pad = padded_rows - num_valid_rows

    def _localize_mask(mask_rows, shard_id):
        # Global ids -> shard-local; anything outside my row range
        # (including sentinel num_items padding) goes to the
        # out-of-range sentinel. The explicit where matters: a raw
        # negative local id would WRAP in the mask scatter and
        # silently block the wrong row.
        local = mask_rows.astype(jnp.int32) - shard_id * rows_per_shard
        return jnp.where(
            (local >= 0) & (local < rows_per_shard), local, rows_per_shard
        )

    def _local_slab(q, items, mask_rows, shard_id):
        mask = None
        if num_pad > 0:
            # Pad rows must rank below every real item: a zero pad row
            # scores 0.0, which BEATS real items whenever scores go
            # negative (dot/cosine frequently do). Mask them to -inf
            # BEFORE shard-local selection — masking after the local
            # top-k is not enough, since pads can crowd real rows out of
            # the last shard's candidate set. Mirrors the single-device
            # iota masking in ``ops/topk.py`` (scan path / group tail).
            # Callers pad to a multiple of the shard count only, so the
            # pad rows all sit on the LAST shard (mask stays narrow).
            assert num_pad <= rows_per_shard, (
                "slab sharding expects pad rows confined to the last "
                f"shard; got {num_pad} pads at {rows_per_shard} rows/shard"
            )
            pad_local = rows_per_shard - num_pad + jnp.arange(
                num_pad, dtype=jnp.int32
            )
            mask = jnp.broadcast_to(
                jnp.where(shard_id == num_shards - 1, pad_local,
                          rows_per_shard)[None, :],  # id >= N drops the mask
                (q.shape[0], num_pad),
            )
        if mask_rows is not None:
            local = _localize_mask(mask_rows, shard_id)
            mask = local if mask is None else jnp.concatenate(
                [mask, local], axis=1
            )
        return mips_topk(
            q,
            items,
            k=min(k, rows_per_shard),
            chunk_size=chunk_size,
            mask_rows=mask,
            normalize_queries=normalize_queries,
            score_dtype=score_dtype,
        )

    def local_topk(q, items, mask_rows=None):
        # items: local shard rows [rows_per_shard, D]; q replicated [B, D].
        shard_id = jax.lax.axis_index(MODEL_AXIS)
        scores, idx = _local_slab(q, items, mask_rows, shard_id)
        idx = idx + shard_id * rows_per_shard
        # all-gather local top-k across the model axis, merge to global k.
        all_scores = jax.lax.all_gather(scores, MODEL_AXIS, axis=1, tiled=True)
        all_idx = jax.lax.all_gather(idx, MODEL_AXIS, axis=1, tiled=True)
        top_scores, pos = jax.lax.top_k(all_scores, k)
        top_idx = jnp.take_along_axis(all_idx, pos, axis=-1)
        return top_scores, top_idx

    in_specs = (P(), P(MODEL_AXIS, None)) + ((P(),) if with_mask else ())
    return shard_map(
        local_topk,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "mesh", "normalize_queries", "chunk_size", "score_dtype",
        "num_valid_rows",
    ),
)
def _sharded_topk_impl(
    queries: jax.Array,
    item_shards: jax.Array,
    *,
    k: int,
    mesh: Mesh,
    normalize_queries: bool,
    chunk_size: int,
    score_dtype: str = "float32",
    num_valid_rows: int | None = None,
):
    fn = make_sharded_topk(
        mesh,
        k=k,
        padded_rows=item_shards.shape[0],
        num_valid_rows=(
            item_shards.shape[0] if num_valid_rows is None else num_valid_rows
        ),
        chunk_size=chunk_size,
        normalize_queries=normalize_queries,
        score_dtype=score_dtype,
    )
    return fn(queries, item_shards)


def sharded_mips_topk(
    queries: jax.Array,
    item_embeddings: jax.Array,
    *,
    k: int,
    mesh: Mesh,
    normalize_queries: bool = False,
    chunk_size: int = 8192,
    score_dtype: str = "float32",
):
    """Distributed exact top-k: shard-local top-k + all-gather merge.

    ``item_embeddings`` is zero-row-padded to a multiple of the shard
    count; pad rows are masked to -inf inside the shard-local search so
    they can never be returned (a zero row scores 0.0, which would
    outrank real items with negative scores).
    Returns (scores [B, k], global indices [B, k]).
    """
    num_valid_rows = item_embeddings.shape[0]
    multiple = mesh.shape[MODEL_AXIS]
    if num_valid_rows % multiple != 0:
        pad = multiple - num_valid_rows % multiple
        item_embeddings = jnp.concatenate(
            [
                item_embeddings,
                jnp.zeros(
                    (pad, item_embeddings.shape[1]), item_embeddings.dtype
                ),
            ],
            axis=0,
        )
    item_embeddings = jax.device_put(
        item_embeddings, NamedSharding(mesh, P(MODEL_AXIS, None))
    )
    queries = jax.device_put(queries, NamedSharding(mesh, P()))
    return _sharded_topk_impl(
        queries,
        item_embeddings,
        k=k,
        mesh=mesh,
        normalize_queries=normalize_queries,
        chunk_size=chunk_size,
        score_dtype=score_dtype,
        num_valid_rows=num_valid_rows,
    )
