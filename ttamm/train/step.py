"""Compiled training and evaluation steps.

The reference's hot loop (``_train_one_epoch``, ref ``training.py:700-833``)
becomes ONE jit-compiled function per batch shape: on-device negative
sampling -> embedding gathers -> tower forwards (single fused pass over
positives+negatives) -> mimic -> BCE + mimic + category-alignment losses ->
grad -> hybrid dense/sparse-row optimizer updates. No host round-trips
inside the epoch except batch index slicing.

Loss math parity notes:

- training logits are always dot products regardless of ``model.similarity``
  (ref ``training.py:770-787`` — cosine only affects eval paths);
- mimic targets are the *base* (pre-augmentation) opposite-tower embeddings
  (ref ``training.py:749-763``);
- negatives get mimic augmentation but no mimic loss (ref ``:777-780``);
- the category-alignment loss sees the augmented pos+neg item embeddings
  (ref ``:805-820``);
- eval loss (``_compute_loss``, ref ``:836-914``) is the same stack without
  dropout, mimic-loss terms, or the alignment term.
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..models.encoders import TPContext, tower_forward
from ..models.two_tower import ModelConfig
from ..ops.losses import bce_with_logits, category_alignment_loss
from ..ops.sampling import sample_negative_items
from ..ops.sparse_adam import SparseAdamStatePacked, sparse_adam_update
from .optim import DenseOptConfig, dense_opt_update, lr_scale
from .state import BatchData, TrainState, dense_table_names, sparse_table_names

Params = dict[str, Any]


class TrainStepConfig(NamedTuple):
    num_items: int
    negatives_per_positive: int = 5
    loss_type: str = "bce"  # 'bce' (sampled negatives) | 'in_batch_softmax'
    lambda_mimic_user: float = 0.0
    lambda_mimic_item: float = 0.0
    lambda_category_alignment: float = 0.0
    gradient_clip_norm: float | None = None
    cal_max_categories: int = 64
    sampling_rounds: int = 8
    # Table-row lookup strategy under a mesh: 'gspmd' lets the
    # partitioner lower jnp.take on the row-sharded tables; 'alltoall'
    # routes ids/rows explicitly through the bucketed exchange
    # (parallel/exchange.py). Ignored single-chip (mesh=None).
    embedding_exchange: str = "gspmd"
    # In-batch softmax only: softmax temperature (divides the dot-product
    # logits) and the Yi-et-al-2019 logQ popularity correction. The
    # correction additionally needs ``BatchData.item_log_q`` (built by the
    # pipeline from train-split item frequencies); without it the loss
    # falls back to uncorrected. See _in_batch_softmax_loss.
    softmax_temperature: float = 1.0
    logq_correction: bool = True
    # In-batch softmax only: number of UNIFORM negatives appended to the
    # in-batch candidate pool (mixed negative sampling, Yang et al. 2020)
    # — one shared pool per step, encoded once, logits [B, B+M]. The logQ
    # correction becomes the mixture log((B*q_pop + M/N)/(B+M)), which
    # reduces exactly to the plain logQ at M=0. Restores gradient signal
    # on rare/cold items that in-batch negatives alone almost never
    # sample. 0 = off (round-4 behavior).
    mixed_negatives: int = 0
    # Decoupled weight decay on the sparse ID tables (touched rows only;
    # torch SparseAdam has none — see ops/sparse_adam.py). 0 = parity.
    sparse_weight_decay: float = 0.0
    # Wire dtype for batch-row gradient exchange: 'bfloat16' rounds every
    # table-row gradient once before it is replicated/all-gathered across
    # the mesh, halving the global-batch row-grad all-gathers. All
    # optimizer math stays fp32 after the widen; the rounding applies on
    # 1 chip too, so quality can be measured single-chip. 'float32'
    # (default) = exact parity.
    comm_dtype: str = "float32"
    # Cross-chip routing for the sparse-table row-grad exchange (mesh
    # only). 'allgather' (default): GSPMD partitions the sparse-Adam
    # scatters and every chip receives the full global batch's row grads.
    # 'owner': the update runs shard-locally inside shard_map
    # (parallel/sparse_update.py); each chip compacts the coalesced lanes
    # its model shard owns into a static capacity buffer and only THAT is
    # all-gathered over data — ~capacity_factor/mp of the allgather wire.
    # Overflowing the capacity (id-popularity skew) falls back to the
    # allgather routing FOR THAT STEP via a mesh-uniform lax.cond — never
    # dropped. 'owner_unchecked' skips the overflow check.
    update_routing: str = "allgather"
    update_capacity_factor: float = 2.0
    opt: DenseOptConfig = DenseOptConfig()


def _gather_opt(features: jax.Array | None, idx: jax.Array) -> jax.Array | None:
    if features is None or features.size == 0:
        return None
    return jnp.take(features, idx, axis=0)


def _forward_embeddings(
    cfg: ModelConfig,
    tscfg: TrainStepConfig,
    dense: Params,
    data: BatchData,
    u_idx: jax.Array,
    pos_idx: jax.Array,
    neg_idx_flat: jax.Array,
    user_rows: jax.Array,
    item_rows_all: jax.Array,
    user_aug_rows: jax.Array | None,
    item_aug_rows_all: jax.Array | None,
    *,
    train: bool,
    dropout_rng: jax.Array | None,
    tp: TPContext | None = None,
):
    """Shared forward producing (user_emb, pos_emb, neg_emb, mimic losses).

    All table rows arrive pre-gathered: ``user_rows``/``item_rows_all``
    are the ID rows, ``user_aug_rows``/``item_aug_rows_all`` the mimic
    augmentation rows (items ordered [positives; negatives]). Gathering
    OUTSIDE the differentiated function keeps every table gradient
    batch-row-shaped — under mesh sharding the data-axis reduction then
    moves ``[B, D]`` rows instead of a ``[rows, D]`` table-shaped grad.
    """
    batch = pos_idx.shape[0]
    num_neg = tscfg.negatives_per_positive
    rng_u = rng_i = None
    if dropout_rng is not None:
        rng_u, rng_i = jax.random.split(dropout_rng)

    item_idx_all = jnp.concatenate([pos_idx, neg_idx_flat])
    user_feats = _gather_opt(data.user_features, u_idx)
    item_feats_all = _gather_opt(data.item_features, item_idx_all)

    user_base = tower_forward(
        dense["user_tower"], cfg.user_tower, user_rows, user_feats,
        train=train, dropout_rng=rng_u, tp=tp,
    )
    item_base_all = tower_forward(
        dense["item_tower"], cfg.item_tower, item_rows_all, item_feats_all,
        train=train, dropout_rng=rng_i, tp=tp,
    )
    pos_base = item_base_all[:batch]
    neg_base = item_base_all[batch:]

    mimic_user_loss = mimic_item_loss = jnp.zeros(())
    if cfg.mimic_enabled:
        user_aug = user_aug_rows
        item_aug_all = item_aug_rows_all
        pos_aug = item_aug_all[:batch]
        neg_aug = item_aug_all[batch:]
        user_emb = user_base + user_aug
        pos_emb = pos_base + pos_aug
        neg_emb = neg_base + neg_aug
        mimic_user_loss = jnp.mean(
            jnp.square(user_aug - jax.lax.stop_gradient(pos_base))
        )
        mimic_item_loss = jnp.mean(
            jnp.square(pos_aug - jax.lax.stop_gradient(user_base))
        )
    else:
        user_emb, pos_emb, neg_emb = user_base, pos_base, neg_base

    dim = pos_emb.shape[-1]
    if tscfg.loss_type == "in_batch_softmax":
        # Mixed-negative pool stays FLAT [M, D]: one shared candidate set
        # for the whole batch (M = tscfg.mixed_negatives, possibly 0).
        pass
    else:
        neg_emb = neg_emb.reshape(batch, num_neg, dim)
    return user_emb, pos_emb, neg_emb, mimic_user_loss, mimic_item_loss


def _retrieval_logits(user_emb, pos_emb, neg_emb):
    pos_logits = jnp.sum(user_emb * pos_emb, axis=-1)
    neg_logits = jnp.einsum("bd,bnd->bn", user_emb, neg_emb)
    return pos_logits, neg_logits


def _bce_stack(pos_logits, neg_logits):
    logits = jnp.concatenate([pos_logits, neg_logits.reshape(-1)])
    labels = jnp.concatenate(
        [jnp.ones_like(pos_logits), jnp.zeros_like(neg_logits.reshape(-1))]
    )
    return bce_with_logits(logits, labels)


def _in_batch_softmax_loss(
    user_emb, pos_emb, pos_idx, *, neg_emb=None, neg_idx=None,
    num_items=0, log_q=None, temperature=1.0,
):
    """Sampled-softmax with in-batch negatives: every other row's positive
    item is a negative; rows whose item equals this row's item are masked
    (accidental hits) rather than treated as negatives.

    ``log_q``: optional [num_items] log empirical sampling probabilities.
    In-batch negatives are drawn ∝ item popularity, so the uncorrected
    softmax systematically pushes popular items DOWN (measured: recall@10
    DEGRADES from epoch 1 on the canonical corpus, RESULTS.md round-4).
    The standard logQ correction (Yi et al. 2019, "Sampling-bias-corrected
    neural modeling") subtracts each candidate's log sampling probability
    from its logit — popular candidates get their over-representation in
    the negative pool discounted exactly.

    ``neg_emb``/``neg_idx``: optional shared pool of M uniformly sampled
    extra negatives (mixed negative sampling, Yang et al. 2020 "Mixed
    Negative Sampling for Learning Two-tower Neural Networks") appended
    as candidate columns — logits become [B, B+M]. With ``log_q`` the
    correction uses the MIXTURE sampling probability
    ``log((B*q_pop(i) + M/N) / (B+M))`` for every candidate, which
    reduces to the plain logQ (up to a softmax-invariant constant shift)
    at M=0; accidental hits (a pool item equal to a row's positive) are
    masked per row like in-batch duplicates.

    ``temperature``: divides the logits before the softmax (logits here
    are raw dot products per reference parity, so the learnable embedding
    scale already absorbs most of this; ships for completeness).
    """
    batch = pos_idx.shape[0]
    cand_idx = pos_idx
    logits = jnp.dot(user_emb, pos_emb.T, preferred_element_type=jnp.float32)
    mixed = neg_emb is not None and neg_emb.shape[0] > 0
    if mixed:
        extra = jnp.dot(
            user_emb, neg_emb.T, preferred_element_type=jnp.float32
        )  # [B, M]
        logits = jnp.concatenate([logits, extra], axis=1)
        cand_idx = jnp.concatenate([pos_idx, neg_idx])
    if temperature != 1.0:
        logits = logits / jnp.asarray(temperature, logits.dtype)
    if log_q is not None:
        cand_log_q = jnp.take(log_q, cand_idx)
        if mixed:
            m = neg_emb.shape[0]
            q_mix = (batch * jnp.exp(cand_log_q) + m / num_items) / (
                batch + m
            )
            cand_log_q = jnp.log(q_mix)
        logits = logits - cand_log_q[None, :]
    same_item = cand_idx[None, :] == pos_idx[:, None]  # [B, B+M]
    diag = (
        jax.lax.broadcasted_iota(jnp.int32, logits.shape, 0)
        == jax.lax.broadcasted_iota(jnp.int32, logits.shape, 1)
    )
    mask = same_item & ~diag  # this row's item anywhere else in the pool
    logits = jnp.where(mask, jnp.finfo(logits.dtype).min, logits)
    log_probs = jax.nn.log_softmax(logits, axis=-1)
    return -jnp.mean(jnp.diagonal(log_probs))


def make_train_step(
    cfg: ModelConfig,
    tscfg: TrainStepConfig,
    *,
    mesh=None,
    tensor_parallel: bool = False,
):
    """Build the jitted train step ``(state, data, u_idx, pos_idx, rng) ->
    (state, metrics)``.

    ``mesh``: when compiling for a device mesh, pass it so batch-shaped
    intermediates that feed table-shaped scatters can be pinned replicated
    — the partitioner then all-gathers ``[B, D]`` row grads over ``data``
    (batch-sized) instead of all-reducing the scattered ``[rows, D]``
    table-shaped gradient (table-sized; measured on the 8-device mesh).

    ``tensor_parallel`` must match how the dense params were placed
    (``place_state(tensor_parallel=True)``): it pins forward activations
    to the layout the Megatron col/row weight shardings imply, so the
    transpose never hits the partitioner's replicate-and-repartition
    fallback on activation grads.
    """
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        _rep = NamedSharding(mesh, PartitionSpec())

        def replicate(x):
            return jax.lax.with_sharding_constraint(x, _rep)
    else:
        def replicate(x):
            return x

    tp_ctx = None
    if mesh is not None and tensor_parallel:
        from jax.sharding import NamedSharding, PartitionSpec

        from ..parallel.mesh import DATA_AXIS, MODEL_AXIS

        _hidden_s = NamedSharding(mesh, PartitionSpec(DATA_AXIS, MODEL_AXIS))
        _batch_s = NamedSharding(mesh, PartitionSpec(DATA_AXIS, None))

        def _tp_constrain(x, kind):
            return jax.lax.with_sharding_constraint(
                x, _hidden_s if kind == "hidden" else _batch_s
            )

        tp_ctx = TPContext(
            size=mesh.shape[MODEL_AXIS], constrain=_tp_constrain
        )

    if tscfg.embedding_exchange not in {"gspmd", "alltoall"}:
        raise ValueError(
            f"Unknown embedding_exchange: {tscfg.embedding_exchange}"
        )
    if mesh is not None and tscfg.embedding_exchange == "alltoall":
        from ..parallel.exchange import padded_exchange_lookup

        def table_lookup(table, idx):
            return padded_exchange_lookup(mesh, table, idx)
    else:
        def table_lookup(table, idx):
            return jnp.take(table, idx, axis=0)

    if tscfg.comm_dtype not in {"float32", "bfloat16"}:
        raise ValueError(f"Unknown comm_dtype: {tscfg.comm_dtype}")
    comm_bf16 = tscfg.comm_dtype == "bfloat16"

    def comm_cast(g):
        # The bf16 value (not a cast-roundtrip, which XLA would fold) is
        # what gets sharding-constrained / all-gathered — bf16 on the
        # wire, widened to fp32 right after. The barrier pins the convert
        # BEFORE the collective: XLA otherwise rewrites
        # all_gather(convert_bf16(y)) into convert(all_gather_f32(y)),
        # silently putting f32 back on the wire (observed in HLO).
        if not comm_bf16:
            return g
        return jax.lax.optimization_barrier(g.astype(jnp.bfloat16))

    sparse_names = sparse_table_names(cfg)
    dense_tbl_names = dense_table_names(cfg)
    sparse_lr = tscfg.opt.lr
    b1, b2 = tscfg.opt.b1, tscfg.opt.b2
    if tscfg.update_routing not in {"allgather", "owner", "owner_unchecked"}:
        raise ValueError(f"Unknown update_routing: {tscfg.update_routing}")
    shard_local_update = mesh is not None and tscfg.update_routing != "allgather"
    if shard_local_update:
        from ..parallel.mesh import DATA_AXIS

    def loss_fn(diff, data, u_idx, pos_idx, neg_idx_flat, dropout_rng):
        dense = diff["dense"]
        rows = {**diff["table_rows"], **diff["sparse_rows"]}

        user_emb, pos_emb, neg_emb, mu_loss, mi_loss = _forward_embeddings(
            cfg, tscfg, dense, data,
            u_idx, pos_idx, neg_idx_flat, rows["user_id"], rows["item_id"],
            rows.get("user_aug"), rows.get("item_aug"),
            train=True, dropout_rng=dropout_rng, tp=tp_ctx,
        )
        if tscfg.loss_type == "in_batch_softmax":
            retrieval_loss = _in_batch_softmax_loss(
                user_emb, pos_emb, pos_idx,
                neg_emb=neg_emb, neg_idx=neg_idx_flat,
                num_items=tscfg.num_items,
                log_q=data.item_log_q if tscfg.logq_correction else None,
                temperature=tscfg.softmax_temperature,
            )
        else:
            pos_logits, neg_logits = _retrieval_logits(user_emb, pos_emb, neg_emb)
            retrieval_loss = _bce_stack(pos_logits, neg_logits)

        total = retrieval_loss
        if cfg.mimic_enabled and tscfg.lambda_mimic_user > 0:
            total = total + tscfg.lambda_mimic_user * mu_loss
        if cfg.mimic_enabled and tscfg.lambda_mimic_item > 0:
            total = total + tscfg.lambda_mimic_item * mi_loss

        cal_loss = jnp.zeros(())
        if tscfg.lambda_category_alignment > 0 and data.category_ids is not None:
            item_idx_all = jnp.concatenate([pos_idx, neg_idx_flat])
            cats = jnp.take(data.category_ids, item_idx_all)
            embs = jnp.concatenate(
                [pos_emb, neg_emb.reshape(-1, pos_emb.shape[-1])], axis=0
            )
            with jax.named_scope("category_alignment"):
                cal_loss = category_alignment_loss(
                    cats,
                    embs,
                    max_categories=tscfg.cal_max_categories,
                )
            total = total + tscfg.lambda_category_alignment * cal_loss

        aux = {
            "retrieval_loss": retrieval_loss,
            "mimic_user_loss": mu_loss,
            "mimic_item_loss": mi_loss,
            "category_alignment_loss": cal_loss,
        }
        return total, aux

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    @jax.jit
    def train_step(state: TrainState, data: BatchData, u_idx, pos_idx, rng):
        rng_neg, rng_drop = jax.random.split(rng)
        if tscfg.loss_type == "in_batch_softmax":
            # Mixed-negative pool: M uniform draws SHARED by the whole
            # batch (encoded once; the mixture logQ correction absorbs
            # the sampling bias, accidental hits are masked in the loss —
            # no per-user rejection needed).
            neg_flat = (
                jax.random.randint(
                    rng_neg, (tscfg.mixed_negatives,), 0, tscfg.num_items,
                    dtype=jnp.int32,
                )
                if tscfg.mixed_negatives > 0
                else jnp.zeros((0,), jnp.int32)
            )
        else:
            user_pos = jnp.take(data.positive_rows, u_idx, axis=0)
            neg = sample_negative_items(
                rng_neg,
                user_pos,
                num_items=tscfg.num_items,
                num_negatives=tscfg.negatives_per_positive,
                num_rounds=tscfg.sampling_rounds,
            )
            neg_flat = neg.reshape(-1)
        item_idx_all = jnp.concatenate([pos_idx, neg_flat])
        row_idx = {
            "user_id": u_idx, "user_aug": u_idx,
            "item_id": item_idx_all, "item_aug": item_idx_all,
        }

        # EVERY table (sparse or dense-updated) is gathered here, outside
        # the differentiated function: gradients arrive batch-row-shaped
        # ([B, D] / [B*(1+NEG), D]). Dense-updated tables (mimic aug, any
        # sparse=False ID table) get their table-shaped AdamW gradient
        # rebuilt by a LOCAL scatter-add below — under mesh sharding the
        # data-axis psum therefore moves row grads, never a [rows, D]
        # table-shaped grad (measured: the table-shaped path all-reduced a
        # full table shard per step on an 8-device mesh).
        diff = {
            "dense": state.dense,
            "table_rows": {
                n: table_lookup(state.tables[n], row_idx[n])
                for n in dense_tbl_names
            },
            "sparse_rows": {
                n: table_lookup(state.tables[n], row_idx[n])
                for n in sparse_names
            },
        }

        (total_loss, aux), grads = grad_fn(
            diff, data, u_idx, pos_idx, neg_flat, rng_drop
        )

        # Rebuild table-shaped dense grads (scatter-add coalesces duplicate
        # indices) BEFORE the clip so the global norm matches the previous
        # differentiate-the-table formulation bit for bit.
        grads["tables"] = {
            n: jnp.zeros_like(state.tables[n])
            .at[replicate(row_idx[n])]
            .add(
                replicate(comm_cast(grads["table_rows"].pop(n))).astype(
                    state.tables[n].dtype
                )
            )
            for n in dense_tbl_names
        }
        del grads["table_rows"]

        if tscfg.gradient_clip_norm is not None and tscfg.gradient_clip_norm > 0:
            # Global-norm clip over ALL grads (dense + sparse rows), as in
            # clip_grad_norm_(model.parameters()) (ref training.py:824-825).
            # Sparse row grads are COALESCED before the norm so duplicate
            # batch indices contribute ||g1+g2||^2 (the true gradient's
            # norm), matching what the dense scatter-add path feeds the
            # norm. This exceeds the reference: torch's clip_grad_norm_
            # raises NotImplementedError on sparse grads (verified against
            # torch 2.x aten::linalg_vector_norm/SparseCPU), so the
            # reference can't clip sparse-embedding runs at all. The
            # post-clip scale distributes over the coalesce.
            def coalesced_sq_norm(idx, rows):
                order = jnp.argsort(idx.astype(jnp.int32))
                sorted_idx = idx.astype(jnp.int32)[order]
                prev = jnp.concatenate(
                    [jnp.array([-1], sorted_idx.dtype), sorted_idx[:-1]]
                )
                seg = jnp.cumsum((sorted_idx != prev).astype(jnp.int32)) - 1
                summed = jax.ops.segment_sum(
                    rows[order], seg, num_segments=rows.shape[0]
                )
                return jnp.sum(jnp.square(summed))

            sq = sum(
                jnp.sum(jnp.square(g))
                for g in jax.tree.leaves(
                    {"dense": grads["dense"], "tables": grads["tables"]}
                )
            )
            sq += sum(
                coalesced_sq_norm(row_idx[n], grads["sparse_rows"][n])
                for n in sparse_names
            )
            gnorm = jnp.sqrt(sq)
            scale = jnp.minimum(1.0, tscfg.gradient_clip_norm / (gnorm + 1e-6))
            grads = jax.tree.map(lambda g: g * scale, grads)

        dense_target = {"dense": state.dense,
                        "tables": {n: state.tables[n] for n in dense_tbl_names}}
        dense_grads = {"dense": grads["dense"], "tables": grads["tables"]}
        new_dense_target, new_opt_dense = dense_opt_update(
            dense_target, dense_grads, state.opt_dense, tscfg.opt
        )

        new_tables = dict(state.tables)
        for name in dense_tbl_names:
            new_tables[name] = new_dense_target["tables"][name]

        # Scheduled sparse lr: the same on-device schedule the dense
        # optimizer applies (1-indexed step = state.step + 1). Constant
        # schedule keeps the static Python float — unchanged program.
        lr_t = sparse_lr * lr_scale(tscfg.opt, state.step + 1)
        new_opt_sparse = dict(state.opt_sparse)
        for name in sparse_names:
            packed = isinstance(state.opt_sparse[name], SparseAdamStatePacked)
            if (
                shard_local_update
                and not packed
                and row_idx[name].shape[0] % mesh.shape[DATA_AXIS] == 0
            ):
                # Owner routing: the update runs shard-locally inside
                # shard_map (parallel/sparse_update.py).
                from ..parallel.sparse_update import (
                    sharded_sparse_adam_update,
                )

                new_tables[name], new_opt_sparse[name] = (
                    sharded_sparse_adam_update(
                        mesh,
                        state.tables[name],
                        state.opt_sparse[name],
                        row_idx[name],
                        comm_cast(grads["sparse_rows"][name]),
                        lr=lr_t, b1=b1, b2=b2,
                        weight_decay=tscfg.sparse_weight_decay,
                        routing=tscfg.update_routing,
                        capacity_factor=tscfg.update_capacity_factor,
                    )
                )
                continue
            new_tables[name], new_opt_sparse[name] = sparse_adam_update(
                state.tables[name],
                state.opt_sparse[name],
                row_idx[name],
                comm_cast(grads["sparse_rows"][name]),
                lr=lr_t, b1=b1, b2=b2,
                weight_decay=tscfg.sparse_weight_decay,
            )

        new_state = TrainState(
            tables=new_tables,
            dense=new_dense_target["dense"],
            opt_dense=new_opt_dense,
            opt_sparse=new_opt_sparse,
            step=state.step + 1,
        )
        metrics = {"loss": total_loss, **aux}
        return new_state, metrics

    return train_step


def make_multi_train_step(
    cfg: ModelConfig,
    tscfg: TrainStepConfig,
    *,
    mesh=None,
    tensor_parallel: bool = False,
):
    """Jitted multi-batch step: ``lax.scan`` the train step over K stacked
    batches in one device call.

    ``(state, data, u_all [K, B], p_all [K, B], rng) -> (state, losses [K])``

    Amortises host dispatch across K steps — the epoch loop uses this for
    whole chunks of the epoch and falls back to the single step for the
    remainder batch. Donates the input state.
    """
    single = make_train_step(
        cfg, tscfg, mesh=mesh, tensor_parallel=tensor_parallel
    )
    raw_step = single.__wrapped__

    def multi(state: TrainState, data: BatchData, u_all, p_all, rng):
        steps = u_all.shape[0]

        def body(st, xs):
            u, p, i = xs
            st, metrics = raw_step(st, data, u, p, jax.random.fold_in(rng, i))
            return st, metrics["loss"]

        return jax.lax.scan(
            body, state, (u_all, p_all, jnp.arange(steps, dtype=jnp.int32))
        )

    return jax.jit(multi, donate_argnums=(0,))


def make_multi_eval_loss_step(cfg: ModelConfig, tscfg: TrainStepConfig):
    """Scanned eval loss over K stacked batches: ``(state, data,
    u_all [K, B], p_all [K, B], rng) -> losses [K]``."""
    single = make_eval_loss_step(cfg, tscfg)
    raw = single.__wrapped__

    def multi(state: TrainState, data: BatchData, u_all, p_all, rng):
        steps = u_all.shape[0]

        def body(_, xs):
            u, p, i = xs
            return None, raw(state, data, u, p, jax.random.fold_in(rng, i))

        _, losses = jax.lax.scan(
            body, None, (u_all, p_all, jnp.arange(steps, dtype=jnp.int32))
        )
        return losses

    return jax.jit(multi)


def make_eval_loss_step(cfg: ModelConfig, tscfg: TrainStepConfig):
    """Build the jitted eval-loss step: plain BCE on the [pos; sampled-neg]
    stack, no dropout, no auxiliary loss terms (ref ``training.py:836-914``).
    """

    @jax.jit
    def eval_loss_step(state: TrainState, data: BatchData, u_idx, pos_idx, rng):
        if tscfg.loss_type == "in_batch_softmax":
            neg_flat = (
                jax.random.randint(
                    rng, (tscfg.mixed_negatives,), 0, tscfg.num_items,
                    dtype=jnp.int32,
                )
                if tscfg.mixed_negatives > 0
                else jnp.zeros((0,), jnp.int32)
            )
        else:
            user_pos = jnp.take(data.positive_rows, u_idx, axis=0)
            neg = sample_negative_items(
                rng,
                user_pos,
                num_items=tscfg.num_items,
                num_negatives=tscfg.negatives_per_positive,
                num_rounds=tscfg.sampling_rounds,
            )
            neg_flat = neg.reshape(-1)
        item_idx_all = jnp.concatenate([pos_idx, neg_flat])

        user_rows = jnp.take(state.tables["user_id"], u_idx, axis=0)
        item_rows_all = jnp.take(state.tables["item_id"], item_idx_all, axis=0)
        user_aug_rows = item_aug_rows = None
        if cfg.mimic_enabled:
            user_aug_rows = jnp.take(state.tables["user_aug"], u_idx, axis=0)
            item_aug_rows = jnp.take(
                state.tables["item_aug"], item_idx_all, axis=0
            )
        user_emb, pos_emb, neg_emb, _, _ = _forward_embeddings(
            cfg, tscfg, state.dense, data,
            u_idx, pos_idx, neg_flat, user_rows, item_rows_all,
            user_aug_rows, item_aug_rows,
            train=False, dropout_rng=None,
        )
        if tscfg.loss_type == "in_batch_softmax":
            return _in_batch_softmax_loss(
                user_emb, pos_emb, pos_idx,
                neg_emb=neg_emb, neg_idx=neg_flat,
                num_items=tscfg.num_items,
                log_q=data.item_log_q if tscfg.logq_correction else None,
                temperature=tscfg.softmax_temperature,
            )
        pos_logits, neg_logits = _retrieval_logits(user_emb, pos_emb, neg_emb)
        return _bce_stack(pos_logits, neg_logits)

    return eval_loss_step


@partial(jax.jit, static_argnames=("cfg", "side", "num_rows", "chunk_size", "augment"))
def encode_corpus(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    side: str,
    *,
    num_rows: int,
    chunk_size: int = 65536,
    augment: bool = True,
) -> jax.Array:
    """Encode every user or item through its tower (+ mimic augmentation).

    Replaces ``_encode_item_embeddings`` (ref ``training.py:613-643``) with a
    device-resident ``lax.scan`` over fixed-size index chunks; the padded
    tail is computed and sliced off (static shapes, no host loop).
    """
    table = state.tables[f"{side}_id"]
    features = data.user_features if side == "user" else data.item_features
    tower_cfg = cfg.user_tower if side == "user" else cfg.item_tower
    dense = state.dense[f"{side}_tower"]
    aug_table = (
        state.tables.get(f"{side}_aug") if (augment and cfg.mimic_enabled) else None
    )

    chunk = min(chunk_size, max(num_rows, 1))
    num_chunks = -(-num_rows // chunk)

    def body(_, chunk_start):
        idx = chunk_start + jnp.arange(chunk, dtype=jnp.int32)
        idx = jnp.minimum(idx, num_rows - 1)  # clamp padded tail
        rows = jnp.take(table, idx, axis=0)
        feats = _gather_opt(features, idx)
        emb = tower_forward(dense, tower_cfg, rows, feats, train=False)
        if aug_table is not None:
            emb = emb + jnp.take(aug_table, idx, axis=0)
        return None, emb

    starts = jnp.arange(num_chunks, dtype=jnp.int32) * chunk
    _, chunks = jax.lax.scan(body, None, starts)
    return chunks.reshape(num_chunks * chunk, -1)[:num_rows]
