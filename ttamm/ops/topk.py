"""On-device brute-force MIPS top-K over the item corpus.

Replacement for FAISS ``IndexFlatIP`` (ref ``training.py:646-697,944-972``)
and for the chunked Python merge in ``_score_all_items_for_user`` (ref
``training.py:330-384``): the query batch is matmul'ed against the
item-embedding matrix, per-128-item group maxima prune the corpus to the k
groups that can hold a top-k item, and only those groups' scores are
selected and ranked (``group_exact``). Corpora too large for a score slab
scan item chunks and merge a running top-k (``chunked``).

``mips_topk`` is the single-device entry; the mesh-sharded variant (local
top-k per item shard + cross-shard merge) lives in
``ttamm.parallel.step`` (``sharded_mips_topk``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

NEG_INF = jnp.finfo(jnp.float32).min


def _merge_topk(
    scores_a: jax.Array,
    idx_a: jax.Array,
    scores_b: jax.Array,
    idx_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two per-row top-k candidate sets into one top-k."""
    scores = jnp.concatenate([scores_a, scores_b], axis=-1)
    idx = jnp.concatenate([idx_a, idx_b], axis=-1)
    top_scores, pos = jax.lax.top_k(scores, k)
    top_idx = jnp.take_along_axis(idx, pos, axis=-1)
    return top_scores, top_idx


# Score-slab budget: group_exact blocks its queries so no [qb, N] score
# slab exceeds this, and ``auto`` keeps group_exact until even a 64-query
# fp32 slab would (~8M items). A block sweep on an H100 (PERF.md) found
# q/s rising with the block up to 512 queries and power-of-two blocks
# beating the odd sizes a tighter budget produced.
_SCORES_BYTES_BUDGET = 2 * 1024 * 1024 * 1024
_GROUP = 128  # items per group (group_exact only)


def _precision(dtype) -> jax.lax.Precision:
    """fp32 scores run at HIGHEST precision: a default-precision fp32 matmul
    may run in TF32 on the GPU (~3 decimal digits), which would reorder
    near-tied items and break FAISS ``IndexFlatIP`` exactness. bf16 mode is
    an explicit approximation and keeps the default single pass."""
    if dtype == jnp.bfloat16:
        return jax.lax.Precision.DEFAULT
    return jax.lax.Precision.HIGHEST


def _fit_rows(items: jax.Array, rows: int) -> jax.Array:
    """Slice or zero-pad ``items`` to exactly ``rows`` leading rows.

    A leading-row slice of a pre-padded corpus fuses into the consuming
    matmul (no copy); the pad branch is the one that copies — callers
    that search repeatedly should pre-pad once and pass
    ``num_valid_rows`` (see FlatIndex).
    """
    if items.shape[0] == rows:
        return items
    if items.shape[0] > rows:
        return items[:rows]
    return jnp.concatenate(
        [items, jnp.zeros((rows - items.shape[0], items.shape[1]), items.dtype)]
    )


@partial(
    jax.jit,
    static_argnames=(
        "k", "chunk_size", "normalize_queries", "algorithm", "score_dtype",
        "num_valid_rows",
    ),
)
def mips_topk(
    queries: jax.Array,
    item_embeddings: jax.Array,
    *,
    k: int,
    num_valid_rows: int | None = None,
    chunk_size: int = 8192,
    mask_rows: jax.Array | None = None,
    normalize_queries: bool = False,
    algorithm: str = "auto",
    score_dtype: str = "float32",
) -> tuple[jax.Array, jax.Array]:
    """Exact top-k inner-product search.

    Parameters
    ----------
    queries: float [B, D] query embeddings.
    item_embeddings: float [N, D] item matrix (pre-normalised for cosine).
    k: number of results per query (static).
    chunk_size: items scored per scan step (static; rounded into the corpus;
        scanning algorithm only).
    mask_rows: optional int32 [B, M] per-query item ids to exclude
        (padded with an id >= N). Matching scores are set to -inf, which
        reproduces the reference's "filter blocked then take top"
        (``training.py:958-968``) since its search depth always covers the
        blocked count.
    normalize_queries: L2-normalise queries first (cosine mode).
    algorithm: 'auto' | 'group_exact' | 'chunked'.
        ``group_exact`` (the ``auto`` choice) is the group-max-pruned
        algorithm, blocked over query sub-batches so each score slab fits
        the budget (see :func:`_group_exact_topk`). ``chunked`` is the
        item-chunk scan+merge with O(B*chunk) score memory, for corpora
        where even a 64-query score slab would blow the budget. (A
        full-row ``lax.top_k`` over [B, N] with no grouping sorts whole
        rows once the *indices* are consumed; values-only microbenchmarks
        hide that because the index chain gets dead-code-eliminated.)
    score_dtype: 'float32' (default; exact, FAISS ``IndexFlatIP`` parity —
        the score matmuls run at HIGHEST precision so TF32 never applies)
        or 'bfloat16' — an opt-in approximate fast path: queries and items
        are cast to bf16 and the score slab is kept in bf16, halving slab
        bandwidth. Ranking is exact *with respect to the bf16 scores*
        (selection gathers are still exact); vs the fp32 ranking only
        near-boundary ties flip. Use for serving throughput; keep fp32 for
        eval-metric parity.

    num_valid_rows: treat only the first N rows of ``item_embeddings`` as
        real items (the rest is padding, never returned). Lets callers
        pre-pad the corpus ONCE to the algorithms' tile multiples so the
        per-call pad-concat (a full corpus copy) disappears — a leading
        slice of a pre-padded buffer fuses into the score matmul.

    Returns
    -------
    (scores [B, k], indices [B, k]) sorted descending per row; scores are
    float32 in both modes (bf16 scores are widened on return).
    """
    num_items = (
        item_embeddings.shape[0] if num_valid_rows is None else num_valid_rows
    )
    dim = item_embeddings.shape[1]
    batch = queries.shape[0]
    if normalize_queries:
        queries = queries / jnp.maximum(
            jnp.linalg.norm(queries, axis=-1, keepdims=True), 1e-12
        )
    if score_dtype not in {"float32", "bfloat16"}:
        raise ValueError(f"Unknown mips_topk score_dtype: {score_dtype}")
    if score_dtype == "bfloat16":
        # Cast AFTER normalization so the cosine norms stay fp32-accurate.
        queries = queries.astype(jnp.bfloat16)
        item_embeddings = item_embeddings.astype(jnp.bfloat16)

    k_eff = min(k, num_items)
    if algorithm not in {"auto", "group_exact", "chunked"}:
        raise ValueError(f"Unknown mips_topk algorithm: {algorithm}")
    if algorithm == "auto":
        fits = 64 * num_items * 4 <= _SCORES_BYTES_BUDGET
        algorithm = "group_exact" if fits else "chunked"
    if algorithm == "group_exact":
        return _group_exact_topk(
            queries, item_embeddings, k_eff, mask_rows, num_items
        )
    chunk = min(chunk_size, max(num_items, 1))
    num_chunks = -(-num_items // chunk)
    padded = num_chunks * chunk

    # Fit the corpus to a whole number of chunks (slice a pre-padded
    # buffer or zero-pad); rows beyond num_items score -inf.
    item_embeddings = _fit_rows(item_embeddings, padded)

    items_t = item_embeddings.T.reshape(dim, num_chunks, chunk).transpose(1, 0, 2)

    # bf16 mode keeps the chunk scores bf16-rounded (then widened for the
    # merge) so ranking semantics match the group_exact path — "exact
    # w.r.t. the bf16 scores". The barrier is load-bearing: XLA otherwise
    # folds convert_f32(dot->bf16) into an fp32-accumulating dot, silently
    # skipping the rounding.
    bf16_chunks = queries.dtype == jnp.bfloat16

    def scan_body(carry, inputs):
        run_scores, run_idx = carry
        chunk_block, chunk_start = inputs
        if bf16_chunks:
            scores = jnp.dot(
                queries, chunk_block, preferred_element_type=jnp.bfloat16
            )
            scores = jax.lax.optimization_barrier(scores).astype(jnp.float32)
        else:
            scores = jnp.dot(
                queries, chunk_block, preferred_element_type=jnp.float32,
                precision=_precision(queries.dtype),
            )  # [B, chunk]
        ids = chunk_start + jax.lax.broadcasted_iota(jnp.int32, (batch, chunk), 1)
        valid = ids < num_items
        if mask_rows is not None:
            blocked = jnp.any(ids[:, :, None] == mask_rows[:, None, :], axis=-1)
            valid = valid & ~blocked
        scores = jnp.where(valid, scores, NEG_INF)
        local_scores, local_pos = jax.lax.top_k(scores, min(k_eff, chunk))
        local_idx = jnp.take_along_axis(ids, local_pos, axis=-1)
        new_scores, new_idx = _merge_topk(
            run_scores, run_idx, local_scores, local_idx, k_eff
        )
        return (new_scores, new_idx), None

    init = (
        jnp.full((batch, k_eff), NEG_INF, jnp.float32),
        jnp.zeros((batch, k_eff), jnp.int32),
    )
    chunk_starts = jnp.arange(num_chunks, dtype=jnp.int32) * chunk
    (scores, indices), _ = jax.lax.scan(scan_body, init, (items_t, chunk_starts))
    return scores, indices


def _mask_scatter(scores: jax.Array, mask_rows: jax.Array) -> jax.Array:
    """Set the blocked columns of ``scores`` to -inf (B*M scatter; padding
    ids >= N are dropped)."""
    row_ids = jnp.broadcast_to(
        jnp.arange(scores.shape[0], dtype=jnp.int32)[:, None], mask_rows.shape
    )
    # FINITE min of the slab dtype, never -inf: float32.min rounds to -inf
    # in bf16, and a -inf slab entry NaN-poisons the one-hot selection
    # einsum (0 * -inf = NaN for every unselected group sharing the
    # column), silently corrupting bf16-mode results. finfo(f32).min IS
    # NEG_INF, so the fp32 path is unchanged.
    return scores.at[row_ids, mask_rows.astype(jnp.int32)].set(
        jnp.asarray(jnp.finfo(scores.dtype).min, scores.dtype),
        mode="drop",
        unique_indices=False,
    )


def default_query_block(slab_columns: int, itemsize: int) -> int:
    """Largest power of two of queries whose [qb, slab_columns] score slab
    fits ``_SCORES_BYTES_BUDGET`` (at least 1)."""
    fit = max(1, _SCORES_BYTES_BUDGET // (slab_columns * itemsize))
    return 1 << (fit.bit_length() - 1)


def _group_exact_topk(
    queries: jax.Array,
    item_embeddings: jax.Array,
    k_eff: int,
    mask_rows: jax.Array | None,
    num_items: int,
    query_block: int | None = None,
    _select: str = "auto",
) -> tuple[jax.Array, jax.Array]:
    """Group-max-pruned exact top-k, blocked over queries.

    Per query block (``query_block`` queries; by default the largest
    power of two that keeps the [qb, NG*G] score slab inside
    ``_SCORES_BYTES_BUDGET`` — blocking over queries needs no cross-block
    merging, every query sees its complete score row):

    1. one [qb, D] x [D, NG*G] matmul against the *row-padded* item matrix
       (zero rows appended up to a whole number of G=128-item groups, so
       the matmul writes the group-shaped layout directly — no [B, N]
       concat/pad copy afterwards; the zero-score pad columns are never
       written to -inf in the slab, which would copy the whole slab —
       instead the tail group's max is taken over real columns only, and
       pad candidates are masked post-selection);
    2. reduce scores to per-group maxima; take the top-k *groups* by
       maximum. Every true top-k item's group has max >= s_k (the k-th
       best score), and at most k groups can have max >= s_k (each
       contains an item scoring >= s_k, of which there are exactly k) —
       so the true top-k items all live in these groups;
    3. select the k groups' score rows and take the final top-k. Selection
       is a per-query row-gather (``take_along_axis``) or a one-hot matmul
       in HIGHEST precision (multiply-by-1.0 moves fp32 values exactly);
       ``_select`` forces one for measurement.

    Replaces the per-chunk ``lax.top_k`` over [B, chunk] (the bottleneck
    of the item-chunked algorithm) with one max-reduce + two narrow
    top-ks. Exact with respect to the computed scores, including ties.
    """
    batch, dim = queries.shape
    g = _GROUP
    ng = -(-num_items // g)
    padded_n = ng * g
    item_embeddings = _fit_rows(item_embeddings, padded_n)
    items_t = item_embeddings.T  # loop-invariant; hoisted out of any scan
    k_groups = min(k_eff, ng)

    # bf16 mode: keep the slab itself in bf16 — halves slab write/read
    # bandwidth and makes the one-hot selection einsum a single pass. Each
    # dot product still accumulates in fp32 before rounding the slab entry.
    slab_dtype = queries.dtype if queries.dtype == jnp.bfloat16 else jnp.float32
    # Finite min, NOT -inf: bf16(-inf) in the slab turns the one-hot
    # selection einsum into NaNs (0 * -inf). See _mask_scatter.
    neg = jnp.asarray(jnp.finfo(slab_dtype).min, slab_dtype)

    def block(q, m):
        qb = q.shape[0]
        s = jnp.dot(
            q, items_t, preferred_element_type=slab_dtype,
            precision=_precision(slab_dtype),
        )
        if m is not None:
            # Scatter -inf at the blocked columns (qb*M elements) instead
            # of a [qb, N, M] broadcast compare (4e9 elements at qb=1024,
            # N=100k, M=40).
            s = _mask_scatter(s, m)
        sg = s.reshape(qb, ng, g)
        if padded_n != num_items:
            # The zero pad columns must not inflate the tail group's max
            # (all-negative tails). Mask them INSIDE the reduce with an
            # iota-based [NG, G] validity map: a single elementwise+reduce
            # pass that can fuse with the matmul's consumer (a tail-column
            # slice+concat would split the reduction into extra passes).
            col = (
                jax.lax.broadcasted_iota(jnp.int32, (ng, g), 0) * g
                + jax.lax.broadcasted_iota(jnp.int32, (ng, g), 1)
            )
            valid_cols = (col < num_items)[None]
            gmax = jnp.max(jnp.where(valid_cols, sg, neg), axis=-1)
        else:
            gmax = jnp.max(sg, axis=-1)  # [qb, NG]
        _, gi = jax.lax.top_k(gmax.astype(jnp.float32), k_groups)  # [qb, kg]
        select = _select
        if select == "auto":
            # bf16 slab: the one-pass einsum; fp32: the row-gather for
            # small k, the one-hot einsum (flat in k) beyond.
            if slab_dtype == jnp.bfloat16:
                select = "einsum"
            else:
                select = "gather" if k_eff <= 24 else "einsum"
        if select == "einsum":
            sel = jax.nn.one_hot(gi, ng, dtype=s.dtype)  # [qb, kg, NG]
            # Selection is exact in both modes: each output element has
            # exactly one nonzero term (x1.0). An fp32 slab needs HIGHEST
            # precision to move the values bit-exactly; a bf16 slab moves
            # exactly in one default-precision pass.
            cand = jnp.einsum(
                "bkg,bgj->bkj", sel, sg,
                preferred_element_type=jnp.float32,
                precision=_precision(slab_dtype),
            )
        else:
            cand = jnp.take_along_axis(sg, gi[:, :, None], axis=1).astype(
                jnp.float32
            )
        if padded_n != num_items:
            # Pad items (global id >= num_items, score 0.0) may sit inside
            # a selected tail group; mask them at the [qb, kg, G] level.
            ids = gi[:, :, None] * g + jnp.arange(g, dtype=jnp.int32)[None, None, :]
            cand = jnp.where(ids < num_items, cand, NEG_INF)
        cv, ci = jax.lax.top_k(cand.reshape(qb, k_groups * g), k_eff)
        group_of = jnp.take_along_axis(gi, ci // g, axis=1)
        return cv, group_of * g + ci % g

    if query_block is None:
        query_block = default_query_block(padded_n, jnp.dtype(slab_dtype).itemsize)
    qb = max(1, min(batch, query_block))
    if qb >= batch:
        return block(queries, mask_rows)

    num_blocks = -(-batch // qb)
    padded_b = num_blocks * qb
    if padded_b != batch:
        queries = jnp.concatenate(
            [queries, jnp.zeros((padded_b - batch, dim), queries.dtype)]
        )
        if mask_rows is not None:
            mask_pad = jnp.full(
                (padded_b - batch, mask_rows.shape[1]), num_items,
                mask_rows.dtype,
            )
            mask_rows = jnp.concatenate([mask_rows, mask_pad])

    q_blocks = queries.reshape(num_blocks, qb, dim)
    m_blocks = (
        mask_rows.reshape(num_blocks, qb, -1) if mask_rows is not None else None
    )

    def body(_, xs):
        if m_blocks is None:
            return None, block(xs, None)
        return None, block(xs[0], xs[1])

    xs = q_blocks if m_blocks is None else (q_blocks, m_blocks)
    _, (scores, idx) = jax.lax.scan(body, None, xs)
    return (
        scores.reshape(padded_b, k_eff)[:batch],
        idx.reshape(padded_b, k_eff)[:batch],
    )


def topk_with_mask(
    queries: jax.Array,
    item_embeddings: jax.Array,
    *,
    k: int,
    mask_rows: jax.Array,
    normalize_queries: bool = False,
    chunk_size: int = 8192,
) -> tuple[jax.Array, jax.Array]:
    """Convenience wrapper used by retrieval eval (blocked-row masking)."""
    return mips_topk(
        queries,
        item_embeddings,
        k=k,
        chunk_size=chunk_size,
        mask_rows=mask_rows,
        normalize_queries=normalize_queries,
    )
