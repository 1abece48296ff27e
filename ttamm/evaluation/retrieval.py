"""Batched retrieval evaluation: on-device MIPS path + sampled fallback.

Replaces the reference's per-user FAISS/sampled evaluation loop
(``_evaluate_model``, ref ``training.py:917-1043``) with batched, compiled
device work:

- **MIPS path** (default): encode the full item corpus on device, batch the
  validation users, run the chunked top-K kernel with per-user blocked-item
  masking, then apply the reference's exact post-processing per user on
  host: de-duplicated non-blocked candidates, truncate to
  ``max_k + |GT|`` (its ``search_limit``), force-append any missed
  ground-truth items, truncate to ``max_k`` (ref ``:944-972`` — the
  "GT-append quirk" required for metric parity on tiny corpora).
- **Sampled path**: candidates = GT ∪ ``candidate_samples`` random items
  outside the user's train positives, scored in one batched gather+matmul
  (ref ``:974-1009``).

Blocked-filtering equivalence note: the reference searches
``k >= search_limit + |blocked|`` deep and then skips blocked items; we mask
blocked scores to -inf before top-k, which yields the same candidate
sequence with a static search depth of ``max_k + gt_cap``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable, Mapping

import jax
import jax.numpy as jnp
import numpy as np

from ..models.two_tower import ModelConfig
from ..ops.topk import NEG_INF, mips_topk
from ..train.state import BatchData, TrainState
from ..train.step import encode_corpus
from ..utils.logging import get_logger

if TYPE_CHECKING:
    import pandas as pd

logger = get_logger("evaluation")

_VALID_THRESHOLD = NEG_INF / 2

# Eval plans bucket users at this blocked-mask width: the power-law
# majority searches with a narrow mask, and only the heavy tail pays for a
# full-width one. A no-slab search stays exact for a narrow mask by
# selecting M extra groups, so the width is also its eligibility gate.
NARROW_MASK_WIDTH = 32


def _pad_rows(values: list[list[int]], width: int, fill: int) -> np.ndarray:
    out = np.full((len(values), width), fill, dtype=np.int32)
    for i, row in enumerate(values):
        row = row[:width]
        out[i, : len(row)] = row
    return out


from functools import partial


@partial(jax.jit, static_argnames=("cfg",))
def encode_user_batch(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    user_idx: jax.Array,
) -> jax.Array:
    """Encode + mimic-augment a batch of users (one compiled kernel)."""
    from ..models.two_tower import encode_tower

    feats = (
        None
        if data.user_features is None
        else jnp.take(data.user_features, user_idx, axis=0)
    )
    return encode_tower(
        state.tables, state.dense, cfg, "user", user_idx, feats,
        train=False, augment_with_mimic=True,
    )


@partial(jax.jit, static_argnames=("cfg", "deep_k", "chunk", "cosine"))
def _encode_and_search(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    user_idx: jax.Array,
    item_embeddings: jax.Array,
    mask_rows: jax.Array,
    *,
    deep_k: int,
    chunk: int,
    cosine: bool,
) -> tuple[jax.Array, jax.Array]:
    """User encode + masked MIPS top-k in ONE dispatch (one device round
    trip per user batch instead of two)."""
    queries = encode_user_batch(state, data, cfg, user_idx)
    return mips_topk(
        queries,
        item_embeddings,
        k=deep_k,
        chunk_size=chunk,
        mask_rows=mask_rows,
        normalize_queries=cosine,
    )


@partial(jax.jit, static_argnames=("cfg", "cosine"))
def _score_candidates(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    user_idx: jax.Array,
    item_embeddings: jax.Array,
    candidates: jax.Array,
    *,
    cosine: bool,
) -> jax.Array:
    """Sampled-path scorer: encode users + gather candidates + row dots."""
    queries = encode_user_batch(state, data, cfg, user_idx)
    if cosine:
        queries = queries / jnp.maximum(
            jnp.linalg.norm(queries, axis=-1, keepdims=True), 1e-12
        )
    cand_emb = jnp.take(item_embeddings, candidates, axis=0)
    return jnp.einsum("bd,bcd->bc", queries, cand_emb)


def _bucket_width(width: int) -> int:
    """Round a mask width up to a power of two (bounds jit recompiles
    while keeping per-batch host->device mask uploads small)."""
    return 1 << max(width, 1).bit_length()


@dataclass(frozen=True)
class EvalPlan:
    """Precomputed, device-resident inputs for the scan-based MIPS eval.

    Built ONCE per experiment (``build_eval_plan``) and reused every epoch:
    the users and the blocked-item matrix live on device and the whole
    eval runs as ONE ``lax.scan`` dispatch, so no per-batch host<->device
    round trip sits between searches.

    When the packed blocked matrix is wider than ``NARROW_MASK_WIDTH``,
    the plan is BUCKETED by per-user blocked width: this plan holds the
    users whose train-positive count fits the width (their mask rows
    sliced to it), and ``wide`` holds a sub-plan for the heavy tail at
    full width. Without the split one heavy user's width would set the
    mask width of the WHOLE eval.
    """

    batches: tuple[tuple[int, ...], ...]  # eval users, chunked by scan step
    gt_per_user: dict[int, set[int]]
    user_mat: jax.Array  # int32 [nb, bs], short batches padded with repeats
    blocked_rows: jax.Array  # int32 [num_users, W] train positives, fill>=N
    deep_k: int
    num_items: int
    gt_mat: jax.Array  # int32 [nb, bs, gt_cap] ground truth, -1 padded
    gt_sizes: np.ndarray  # int32 [nb, bs] |GT| per (padded) user row
    wide: "EvalPlan | None" = None  # heavy-tail bucket (full mask width)


def _plan_buckets(plan: EvalPlan) -> list[EvalPlan]:
    return [plan] + ([plan.wide] if plan.wide is not None else [])


def _plan_for_users(
    users: list[int],
    gt_per_user: dict[int, set[int]],
    blocked_rows: jax.Array,
    *,
    num_items: int,
    k_values: Iterable[int],
    user_batch_size: int,
    wide: EvalPlan | None = None,
) -> EvalPlan:
    max_k = max(k_values)
    gt_cap = max(len(gt_per_user[u]) for u in users)
    n = len(users)
    bs = min(user_batch_size, n)
    nb = -(-n // bs)
    user_arr = np.asarray(users, np.int32)
    padded = np.concatenate([user_arr, np.full(nb * bs - n, user_arr[-1], np.int32)])
    padded_users = [int(u) for u in padded]
    gt_rows = _pad_rows([sorted(gt_per_user[u]) for u in padded_users], gt_cap, -1)
    gt_sizes = np.asarray(
        [len(gt_per_user[u]) for u in padded_users], np.int32
    ).reshape(nb, bs)
    return EvalPlan(
        batches=tuple(
            tuple(users[start : start + bs]) for start in range(0, n, bs)
        ),
        gt_per_user=gt_per_user,
        user_mat=jnp.asarray(padded.reshape(nb, bs)),
        blocked_rows=blocked_rows,
        deep_k=min(max_k + gt_cap, num_items),
        num_items=num_items,
        gt_mat=jnp.asarray(gt_rows.reshape(nb, bs, gt_cap)),
        gt_sizes=gt_sizes,
        wide=wide,
    )


def build_eval_plan(
    val_interactions: pd.DataFrame,
    train_positive_map: Mapping[int, set[int]],
    *,
    num_users: int,
    num_items: int,
    k_values: Iterable[int],
    user_batch_size: int = 1024,
    blocked_rows: jax.Array | None = None,
) -> EvalPlan | None:
    """Precompute the per-epoch-invariant eval inputs (see EvalPlan).

    ``blocked_rows`` lets callers share one packed+uploaded train-positives
    matrix across several plans (the pipeline builds val and test plans
    from the same blocked map). It must cover every eval user's FULL
    train-positive list: a matrix packed with a ``positives_cap`` that
    truncated an eval user is rebuilt uncapped here (with a warning) —
    a truncated blocked row would let the eval recommend that user's own
    train positives and inflate recall.

    When the blocked width exceeds ``NARROW_MASK_WIDTH``, users are
    bucketed by their own blocked count (see :class:`EvalPlan`).
    """
    from ..data.arrays import pack_positives, positives_from_frame

    if val_interactions.empty:
        return None
    gt_per_user = positives_from_frame(val_interactions)
    users = [u for u, gt in gt_per_user.items() if gt]
    if not users:
        return None
    counts = {u: len(train_positive_map.get(u, ())) for u in users}
    max_blocked = max(counts.values(), default=0)
    if blocked_rows is not None and blocked_rows.shape[1] < max_blocked:
        logger.warning(
            "eval blocked matrix width %d < max eval-user positive count %d "
            "(built with a positives_cap?); rebuilding uncapped — truncated "
            "blocked rows would leak train positives into eval predictions.",
            blocked_rows.shape[1],
            max_blocked,
        )
        blocked_rows = None
    if blocked_rows is None:
        packed = pack_positives(
            train_positive_map, num_users=num_users, num_items=num_items
        )
        blocked_rows = jnp.asarray(packed.rows)
    kwargs = dict(
        num_items=num_items, k_values=k_values, user_batch_size=user_batch_size
    )
    if blocked_rows.shape[1] > NARROW_MASK_WIDTH:
        narrow = [u for u in users if counts[u] <= NARROW_MASK_WIDTH]
        wide = [u for u in users if counts[u] > NARROW_MASK_WIDTH]
        if narrow:
            logger.info(
                "eval plan: blocked width %d exceeds the narrow mask width "
                "(%d); bucketing %d narrow / %d wide users.",
                blocked_rows.shape[1], NARROW_MASK_WIDTH,
                len(narrow), len(wide),
            )
            narrow_blocked = blocked_rows[:, :NARROW_MASK_WIDTH]
            wide_plan = (
                _plan_for_users(wide, gt_per_user, blocked_rows, **kwargs)
                if wide
                else None
            )
            return _plan_for_users(
                narrow, gt_per_user, narrow_blocked, wide=wide_plan, **kwargs
            )
    return _plan_for_users(users, gt_per_user, blocked_rows, **kwargs)


@partial(jax.jit, static_argnames=("cfg", "deep_k", "chunk", "cosine"))
def _scan_encode_search(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    user_mat: jax.Array,
    item_embeddings: jax.Array,
    blocked_rows: jax.Array,
    *,
    deep_k: int,
    chunk: int,
    cosine: bool,
) -> tuple[jax.Array, jax.Array]:
    """Whole-corpus eval for every user batch in ONE dispatch.

    Returns (indices int32 [nb, bs, deep_k], valid bool [nb, bs, deep_k]);
    scores themselves are never needed on host, so only a validity bit is
    shipped back (masked/blocked entries are invalid).
    """

    def step(_, u_idx):
        queries = encode_user_batch(state, data, cfg, u_idx)
        mask_rows = jnp.take(blocked_rows, u_idx, axis=0)
        scores, idx = mips_topk(
            queries,
            item_embeddings,
            k=deep_k,
            chunk_size=chunk,
            mask_rows=mask_rows,
            normalize_queries=cosine,
        )
        return None, (idx.astype(jnp.int32), scores > _VALID_THRESHOLD)

    _, (idx_all, valid_all) = jax.lax.scan(step, None, user_mat)
    return idx_all, valid_all


@partial(
    jax.jit,
    static_argnames=(
        "cfg", "deep_k", "chunk", "cosine", "max_k", "score_dtype",
        "mesh", "num_valid_rows",
    ),
)
def _scan_encode_search_hits(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    user_mat: jax.Array,
    gt_mat: jax.Array,
    item_embeddings: jax.Array,
    blocked_rows: jax.Array,
    *,
    deep_k: int,
    chunk: int,
    cosine: bool,
    max_k: int,
    score_dtype: str = "float32",
    mesh=None,
    num_valid_rows: int | None = None,
) -> jax.Array:
    """Whole-corpus eval returning the per-user HIT MATRIX on device.

    Fuses the reference's host-side post-processing (filter -> cap ->
    GT-append -> truncate, ref ``training.py:944-972``) into the eval scan
    as position arithmetic, so only a [users, max_k] bit matrix crosses to
    the host instead of per-user index lists:

    - masked/invalid entries score -inf, so top-k already orders the
      ``nvalid`` real candidates first — the "filter" is a prefix;
    - the cap keeps the first ``limit = min(max_k + |GT|, nvalid)`` entries;
    - appended missing-GT items are all hits by construction, so they
      occupy positions ``limit .. limit+missing-1`` regardless of which GT
      item lands where (set iteration order cannot change the matrix).

    Returns hits bool [nb, bs, max_k]; feed to
    ``metrics_from_hit_matrix`` with the plan's ``gt_sizes``.

    ``mesh``: with a model axis > 1, the per-batch search runs through the
    shard-mapped distributed top-k (``parallel.step.make_sharded_topk``) —
    shard-local ``mips_topk`` over the row-sharded corpus + a [B, k]-sized
    all-gather merge, so the full item-embedding slab is never replicated
    per device (``item_embeddings`` must arrive ``P(model, None)``-placed
    and row-padded; ``num_valid_rows`` is the real item count).
    """
    sharded_search = None
    if mesh is not None:
        from ..parallel.step import make_sharded_topk

        sharded_search = make_sharded_topk(
            mesh,
            k=deep_k,
            padded_rows=item_embeddings.shape[0],
            num_valid_rows=(
                item_embeddings.shape[0]
                if num_valid_rows is None
                else num_valid_rows
            ),
            chunk_size=chunk,
            normalize_queries=cosine,
            score_dtype=score_dtype,
            with_mask=True,
        )

    def step(_, xs):
        u_idx, gt_b = xs
        queries = encode_user_batch(state, data, cfg, u_idx)
        mask_rows = jnp.take(blocked_rows, u_idx, axis=0)
        if sharded_search is not None:
            scores, idx = sharded_search(queries, item_embeddings, mask_rows)
        else:
            scores, idx = mips_topk(
                queries,
                item_embeddings,
                k=deep_k,
                chunk_size=chunk,
                mask_rows=mask_rows,
                normalize_queries=cosine,
                score_dtype=score_dtype,
                num_valid_rows=num_valid_rows,
            )
        valid = scores > _VALID_THRESHOLD  # [bs, deep_k]
        nvalid = jnp.sum(valid.astype(jnp.int32), axis=-1)  # [bs]
        gt_size = jnp.sum((gt_b >= 0).astype(jnp.int32), axis=-1)  # [bs]
        limit = jnp.minimum(max_k + gt_size, nvalid)  # [bs]
        jpos = jnp.arange(deep_k, dtype=jnp.int32)
        pre = (idx[:, :, None] == gt_b[:, None, :]) & (
            jpos[None, :, None] < limit[:, None, None]
        )  # [bs, deep_k, gt_cap]
        found = jnp.sum(jnp.any(pre, axis=1).astype(jnp.int32), axis=-1)
        missing = gt_size - found
        w = min(deep_k, max_k)
        direct = jnp.any(pre, axis=-1)[:, :w]  # [bs, w]
        if w < max_k:
            direct = jnp.pad(direct, ((0, 0), (0, max_k - w)))
        kpos = jnp.arange(max_k, dtype=jnp.int32)[None, :]
        appended = (kpos >= limit[:, None]) & (
            kpos < (limit + missing)[:, None]
        )
        return None, direct | appended

    _, hits = jax.lax.scan(
        step, None, (user_mat, gt_mat)
    )
    return hits


def evaluate_retrieval_metrics(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    *,
    plan: EvalPlan,
    k_values: Iterable[int],
    item_embeddings: jax.Array | None = None,
    topk_chunk_size: int = 8192,
    score_dtype: str = "float32",
    mesh=None,
):
    """One-dispatch retrieval eval straight to :class:`RankingMetrics`.

    ``score_dtype="bfloat16"`` scores the MIPS sweep in bf16 (the serving
    fast path) — used by the pipeline's serving-precision recall gate;
    metric-parity evals keep the float32 default.

    Metric-identical to ``compute_ranking_metrics(*evaluate_retrieval(...))``
    (pinned by ``tests/test_retrieval_eval.py``) but skips the per-user
    Python post-processing and dict building on both sides — at 200k users
    that is ~4 s of host loops per eval replaced by vectorized numpy over
    the device-computed hit matrix.
    """
    from .metrics import metrics_from_hit_matrix

    k_list = list(k_values)
    max_k = max(k_list)
    cosine = cfg.similarity == "cosine"
    if item_embeddings is None:
        item_embeddings = encode_corpus(
            state, data, cfg, "item", num_rows=plan.num_items
        )
    if cosine:
        item_embeddings = item_embeddings / jnp.maximum(
            jnp.linalg.norm(item_embeddings, axis=-1, keepdims=True), 1e-12
        )
    num_valid_rows = item_embeddings.shape[0]
    buckets = _plan_buckets(plan)
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        # Row-shard the corpus over the model axis for the distributed
        # search (zero-pad rows are -inf-masked inside the shard-local
        # top-k; see make_sharded_topk).
        from jax.sharding import NamedSharding, PartitionSpec as P

        # One padded+placed corpus serves every bucket.
        pad = (-item_embeddings.shape[0]) % mesh.shape["model"]
        if pad:
            item_embeddings = jnp.concatenate(
                [
                    item_embeddings,
                    jnp.zeros(
                        (pad, item_embeddings.shape[1]), item_embeddings.dtype
                    ),
                ]
            )
        item_embeddings = jax.device_put(
            item_embeddings, NamedSharding(mesh, P("model", None))
        )
    else:
        mesh = None  # data-parallel-only meshes use the plain local search
    rows: list[np.ndarray] = []
    sizes: list[np.ndarray] = []
    for bucket in buckets:
        hits = _scan_encode_search_hits(
            state, data, cfg, bucket.user_mat, bucket.gt_mat, item_embeddings,
            bucket.blocked_rows,
            deep_k=bucket.deep_k, chunk=topk_chunk_size, cosine=cosine,
            max_k=max_k, score_dtype=score_dtype,
            mesh=mesh, num_valid_rows=num_valid_rows,
        )
        hits_np = np.asarray(jax.device_get(hits))  # [nb, bs, max_k]
        # Drop the pad rows (short final batch repeats its last user;
        # counting the repeats would skew the macro average).
        rows.extend(
            hits_np[b, : len(chunk_users)]
            for b, chunk_users in enumerate(bucket.batches)
        )
        sizes.extend(
            bucket.gt_sizes[b, : len(chunk_users)]
            for b, chunk_users in enumerate(bucket.batches)
        )
    return metrics_from_hit_matrix(
        np.concatenate(rows, axis=0),
        np.concatenate(sizes, axis=0),
        k_list,
    )


def _postprocess_mips_rows(
    predictions: dict[int, list[int]],
    chunk_users: Iterable[int],
    idx_np: np.ndarray,
    valid_np: np.ndarray,
    gt_per_user: Mapping[int, set[int]],
    max_k: int,
) -> None:
    """Reference post-processing: filter -> cap -> GT-append -> truncate
    (ref ``training.py:944-972``)."""
    for row, user in enumerate(chunk_users):
        gt = gt_per_user[user]
        filtered = [int(i) for i in idx_np[row][valid_np[row]]]
        search_limit = max(max_k + len(gt), 1)
        filtered = filtered[:search_limit]
        seen = set(filtered)
        for item in gt:  # GT-append quirk (ref :969-972)
            if item not in seen:
                filtered.append(item)
        predictions[user] = filtered[:max_k]


def evaluate_retrieval(
    state: TrainState,
    data: BatchData,
    cfg: ModelConfig,
    *,
    val_interactions: pd.DataFrame,
    train_positive_map: Mapping[int, set[int]],
    num_items: int,
    k_values: Iterable[int],
    use_mips: bool = True,
    candidate_samples: int = 50,
    rng: np.random.Generator | None = None,
    user_batch_size: int = 1024,
    item_embeddings: jax.Array | None = None,
    topk_chunk_size: int = 8192,
    plan: EvalPlan | None = None,
) -> tuple[dict[int, list[int]], dict[int, set[int]]]:
    """Per-user top-K predictions + ground truth for the metric computer.

    With ``plan`` (see :func:`build_eval_plan`) the MIPS path runs as one
    ``lax.scan`` dispatch over device-resident inputs — the fast path the
    training pipeline uses every epoch.
    """
    k_list = list(k_values)
    max_k = max(k_list) if k_list else 0
    cosine = cfg.similarity == "cosine"

    if plan is not None and use_mips:
        if item_embeddings is None:
            item_embeddings = encode_corpus(
                state, data, cfg, "item", num_rows=plan.num_items
            )
        if cosine:
            item_embeddings = item_embeddings / jnp.maximum(
                jnp.linalg.norm(item_embeddings, axis=-1, keepdims=True), 1e-12
            )
        predictions: dict[int, list[int]] = {}
        plan_users: list[int] = []
        for bucket in _plan_buckets(plan):
            idx_all, valid_all = _scan_encode_search(
                state, data, cfg, bucket.user_mat, item_embeddings,
                bucket.blocked_rows,
                deep_k=bucket.deep_k, chunk=topk_chunk_size, cosine=cosine,
            )
            idx_np = np.asarray(jax.device_get(idx_all))
            valid_np = np.asarray(jax.device_get(valid_all))
            for b, chunk_users in enumerate(bucket.batches):
                _postprocess_mips_rows(
                    predictions, chunk_users, idx_np[b], valid_np[b],
                    plan.gt_per_user, max_k,
                )
            plan_users.extend(u for batch in bucket.batches for u in batch)
        return predictions, {u: plan.gt_per_user[u] for u in plan_users}

    if val_interactions.empty:
        return {}, {}
    from ..data.arrays import positives_from_frame

    # Group ground truth per user (insertion order = groupby order, matching
    # the reference's per-user iteration).
    gt_per_user = positives_from_frame(val_interactions)
    users = [u for u, gt in gt_per_user.items() if gt]
    if not users:
        return {}, {}
    gt_cap = max(len(gt_per_user[u]) for u in users)
    blocked_lists = [sorted(train_positive_map.get(u, ())) for u in users]
    blocked_cap = max((len(b) for b in blocked_lists), default=1)

    if item_embeddings is None:
        item_embeddings = encode_corpus(
            state, data, cfg, "item", num_rows=num_items
        )
    if cosine:
        item_embeddings = item_embeddings / jnp.maximum(
            jnp.linalg.norm(item_embeddings, axis=-1, keepdims=True), 1e-12
        )

    predictions: dict[int, list[int]] = {}

    if use_mips:
        deep_k = min(max_k + gt_cap, num_items)
        n = len(users)
        bs = min(user_batch_size, n)
        user_arr = np.asarray(users, np.int32)
        # Phase 1: dispatch every batch without synchronizing — JAX queues
        # the encode+search programs while earlier ones still run, so host
        # dispatch overlaps device compute.
        launched: list[tuple[list[int], jax.Array, jax.Array]] = []
        for start in range(0, n, bs):
            chunk_users = users[start : start + bs]
            cnt = len(chunk_users)
            pad = bs - cnt
            rows_sel = np.concatenate(
                [np.arange(start, start + cnt)] + [[start + cnt - 1]] * pad
            )
            u_idx = jnp.asarray(user_arr[rows_sel])
            batch_blocked = [blocked_lists[r] for r in rows_sel]
            width = _bucket_width(max((len(b) for b in batch_blocked), default=1))
            mask_rows = jnp.asarray(_pad_rows(batch_blocked, width, num_items))
            scores, idx = _encode_and_search(
                state, data, cfg, u_idx, item_embeddings, mask_rows,
                deep_k=deep_k, chunk=topk_chunk_size, cosine=cosine,
            )
            launched.append((chunk_users, scores, idx))
        # Phase 2: pull results and apply the reference's host-side
        # post-processing (filter -> cap -> GT-append -> truncate).
        for chunk_users, scores, idx in launched:
            scores_np = np.asarray(scores)
            idx_np = np.asarray(idx)
            _postprocess_mips_rows(
                predictions, chunk_users, idx_np,
                scores_np > _VALID_THRESHOLD, gt_per_user, max_k,
            )
    else:
        rng = rng or np.random.default_rng(0)
        cand_rows: list[list[int]] = []
        for user in users:
            gt = gt_per_user[user]
            blocked = set(train_positive_map.get(user, ()))
            candidates = set(gt)
            available = list(set(range(num_items)) - blocked)
            if available:
                budget = max(0, min(candidate_samples, len(available)))
                if budget > 0:
                    sampled = rng.choice(available, size=budget, replace=False)
                    candidates.update(int(s) for s in sampled)
            cand_rows.append(list(candidates))
        cand_cap = max(len(c) for c in cand_rows)
        cand_mat = _pad_rows(cand_rows, cand_cap, 0)
        pad_mask = np.zeros(cand_mat.shape, dtype=bool)
        for i, c in enumerate(cand_rows):
            pad_mask[i, len(c):] = True

        n = len(users)
        bs = min(user_batch_size, n)
        sampled_launched: list[tuple[list[int], int, jax.Array]] = []
        for start in range(0, n, bs):
            chunk_users = users[start : start + bs]
            cnt = len(chunk_users)
            pad = bs - cnt
            padded_users = chunk_users + [chunk_users[-1]] * pad
            u_idx = jnp.asarray(np.asarray(padded_users, np.int32))
            cands = np.concatenate(
                [cand_mat[start : start + cnt]]
                + [cand_mat[start + cnt - 1 : start + cnt]] * pad,
                axis=0,
            )
            scores = _score_candidates(
                state, data, cfg, u_idx, item_embeddings, jnp.asarray(cands),
                cosine=cosine,
            )
            sampled_launched.append((chunk_users, start, scores))
        for chunk_users, start, scores in sampled_launched:
            cnt = len(chunk_users)
            pad = bs - cnt
            scores_np = np.array(scores)  # writable copy
            scores_np[
                np.concatenate(
                    [pad_mask[start : start + cnt]]
                    + [pad_mask[start + cnt - 1 : start + cnt]] * pad,
                    axis=0,
                )
            ] = -np.inf
            order = np.argsort(-scores_np, axis=1)
            for row, user in enumerate(chunk_users):
                n_cand = len(cand_rows[start + row])
                top = order[row][: min(max_k, n_cand)]
                predictions[user] = [int(cand_mat[start + row, t]) for t in top]

    return predictions, {u: gt_per_user[u] for u in users}
