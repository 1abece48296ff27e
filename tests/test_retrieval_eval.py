"""Retrieval-eval parity vs a literal re-implementation of the reference's
FAISS-path post-processing (filter blocked -> cap at search_limit -> append
missed GT -> truncate to max_k, ref ``training.py:944-972``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from ttamm.data import pack_positives
from ttamm.evaluation import compute_ranking_metrics, evaluate_retrieval
from ttamm.models import parse_model_config
from ttamm.train import create_train_state
from ttamm.train.state import BatchData


def _setup(num_users=20, num_items=15, seed=0):
    cfg = parse_model_config(
        {
            "user_encoder": {"type": "embedding", "params": {"embedding_dim": 8}},
            "item_encoder": {"type": "embedding", "params": {"embedding_dim": 8}},
            "similarity": "dot",
            "adaptive_mimic": {"enabled": False},
        },
        user_feature_dim=0,
        item_feature_dim=0,
    )
    state = create_train_state(
        jax.random.key(seed), cfg, num_users=num_users, num_items=num_items
    )
    rng = np.random.default_rng(seed)
    positives = {
        u: {int(x) for x in rng.integers(0, num_items, 3)} for u in range(num_users)
    }
    packed = pack_positives(positives, num_users=num_users, num_items=num_items)
    data = BatchData(
        user_features=None,
        item_features=None,
        positive_rows=jnp.asarray(packed.rows),
        category_ids=None,
    )
    return cfg, state, data, positives, rng


def _reference_predictions(user_emb, item_emb, blocked, gt, max_k):
    """Literal reference post-processing on exact scores."""
    scores = item_emb @ user_emb
    order = np.argsort(-scores, kind="stable")
    search_limit = max(max_k + len(gt), 1)
    filtered, seen = [], set()
    for item in order:
        item = int(item)
        if item in blocked or item in seen:
            continue
        filtered.append(item)
        seen.add(item)
        if len(filtered) >= search_limit:
            break
    for item in gt:
        if item not in seen:
            filtered.append(item)
    return filtered[:max_k]


def test_mips_eval_matches_reference_postprocessing():
    cfg, state, data, positives, rng = _setup()
    num_users, num_items = 20, 15
    val = pd.DataFrame(
        {
            "user_idx": list(range(num_users)),
            "item_idx": [int(rng.integers(0, num_items)) for _ in range(num_users)],
        }
    )
    train_blocked = {u: set(list(positives[u])[:2]) for u in range(num_users)}

    preds, gts = evaluate_retrieval(
        state, data, cfg,
        val_interactions=val,
        train_positive_map=train_blocked,
        num_items=num_items,
        k_values=[5, 10],
        use_mips=True,
        user_batch_size=7,  # force batching + padding
        topk_chunk_size=4,
    )

    user_table = np.asarray(state.tables["user_id"])
    item_table = np.asarray(state.tables["item_id"])
    for user in preds:
        gt = gts[user]
        expected = _reference_predictions(
            user_table[user], item_table, train_blocked[user], gt, max_k=10
        )
        assert preds[user] == expected, user


def test_gt_append_quirk_on_tiny_corpus():
    """When almost everything is blocked, missed GT must be force-appended."""
    cfg, state, data, positives, rng = _setup(num_users=3, num_items=6)
    # Block all but one item for user 0; GT is a blocked... use GT outside
    blocked = {0: {0, 1, 2, 3}, 1: set(), 2: set()}
    val = pd.DataFrame({"user_idx": [0], "item_idx": [4]})
    preds, gts = evaluate_retrieval(
        state, data, cfg,
        val_interactions=val,
        train_positive_map=blocked,
        num_items=6,
        k_values=[5],
        use_mips=True,
    )
    # only items 4,5 are unblocked; predictions has <=2 entries, GT among them
    assert set(preds[0]) <= {4, 5}
    assert 4 in preds[0]


def test_sampled_eval_contains_ground_truth():
    cfg, state, data, positives, rng = _setup()
    val = pd.DataFrame({"user_idx": [0, 1, 2], "item_idx": [3, 4, 5]})
    preds, gts = evaluate_retrieval(
        state, data, cfg,
        val_interactions=val,
        train_positive_map={u: set() for u in range(20)},
        num_items=15,
        k_values=[15],
        use_mips=False,
        candidate_samples=4,
        rng=np.random.default_rng(0),
    )
    # with max_k >= candidate count, every GT item must appear
    for u, gt in gts.items():
        assert gt <= set(preds[u])


def test_metrics_pipeline_end():
    cfg, state, data, positives, rng = _setup()
    val = pd.DataFrame({"user_idx": [0, 1], "item_idx": [3, 4]})
    preds, gts = evaluate_retrieval(
        state, data, cfg,
        val_interactions=val,
        train_positive_map={u: set() for u in range(20)},
        num_items=15,
        k_values=[5],
        use_mips=True,
    )
    metrics = compute_ranking_metrics(preds, gts, [5])
    assert 0.0 <= metrics.recall[5] <= 1.0


@pytest.mark.parametrize("seed,block_heavy", [(0, False), (1, True), (2, False)])
def test_hit_matrix_metrics_match_dict_path(seed, block_heavy):
    """evaluate_retrieval_metrics (device-side hit matrix) must equal
    compute_ranking_metrics over the dict path exactly — including the
    GT-append quirk and the search_limit cap."""
    from ttamm.evaluation import (
        build_eval_plan,
        compute_ranking_metrics,
        evaluate_retrieval_metrics,
    )

    cfg, state, data, positives, rng = _setup(seed=seed)
    num_users, num_items = 20, 15
    # Multi-GT users (1-3 held-out items each) exercise append positions.
    rows = []
    for u in range(num_users):
        for it in {int(x) for x in rng.integers(0, num_items, int(rng.integers(1, 4)))}:
            rows.append((u, it))
    val = pd.DataFrame(
        {"user_idx": [r[0] for r in rows], "item_idx": [r[1] for r in rows]}
    )
    if block_heavy:
        # Block most of the corpus: nvalid < search_limit for everyone.
        train_blocked = {
            u: {int(x) for x in rng.integers(0, num_items, 12)}
            for u in range(num_users)
        }
    else:
        train_blocked = {u: set(list(positives[u])[:2]) for u in range(num_users)}

    k_values = [5, 10]
    plan = build_eval_plan(
        val, train_blocked,
        num_users=num_users, num_items=num_items,
        k_values=k_values, user_batch_size=7,
    )
    preds, gts = evaluate_retrieval(
        state, data, cfg,
        val_interactions=val,
        train_positive_map=train_blocked,
        num_items=num_items,
        k_values=k_values,
        use_mips=True,
        user_batch_size=7,
        topk_chunk_size=4,
        plan=plan,
    )
    want = compute_ranking_metrics(preds, gts, k_values, include_per_user=False)
    got = evaluate_retrieval_metrics(
        state, data, cfg, plan=plan, k_values=k_values, topk_chunk_size=4
    )
    for k in k_values:
        assert got.recall[k] == pytest.approx(want.recall[k], abs=1e-12)
        assert got.precision[k] == pytest.approx(want.precision[k], abs=1e-12)
        assert got.ndcg[k] == pytest.approx(want.ndcg[k], abs=1e-12)
        assert got.hit_rate[k] == pytest.approx(want.hit_rate[k], abs=1e-12)
        assert got.map[k] == pytest.approx(want.map[k], abs=1e-12)
    assert got.mrr == pytest.approx(want.mrr, abs=1e-12)


def test_eval_plan_matches_batched_path():
    """The one-dispatch scan path (EvalPlan) must reproduce the per-batch
    path (and therefore the reference post-processing) exactly."""
    from ttamm.evaluation import build_eval_plan

    cfg, state, data, positives, rng = _setup()
    num_users, num_items = 20, 15
    val = pd.DataFrame(
        {
            "user_idx": list(range(num_users)),
            "item_idx": [int(rng.integers(0, num_items)) for _ in range(num_users)],
        }
    )
    train_blocked = {u: set(list(positives[u])[:2]) for u in range(num_users)}
    kwargs = dict(
        val_interactions=val,
        train_positive_map=train_blocked,
        num_items=num_items,
        k_values=[5, 10],
        use_mips=True,
        user_batch_size=7,
        topk_chunk_size=4,
    )
    preds_ref, gts_ref = evaluate_retrieval(state, data, cfg, **kwargs)
    plan = build_eval_plan(
        val, train_blocked,
        num_users=num_users, num_items=num_items,
        k_values=[5, 10], user_batch_size=7,
    )
    preds_plan, gts_plan = evaluate_retrieval(state, data, cfg, plan=plan, **kwargs)
    assert preds_plan == preds_ref
    assert gts_plan == gts_ref


@pytest.mark.parametrize("seed,block_heavy", [(0, False), (3, True)])
def test_sharded_mesh_eval_matches_local(seed, block_heavy):
    """evaluate_retrieval_metrics(mesh=...) — the distributed shard-local
    top-k + merge over the row-sharded corpus — must reproduce the local
    path's metrics exactly (the distributed search is exact: when deep_k
    >= rows_per_shard each shard returns every row it owns, otherwise its
    top-k suffices; blocked ids and zero-pad rows are masked inside the
    shard-local search)."""
    from ttamm.evaluation import (
        build_eval_plan,
        evaluate_retrieval_metrics,
    )
    from ttamm.parallel import MeshConfig, build_mesh

    cfg, state, data, positives, rng = _setup(seed=seed)
    num_users, num_items = 20, 15
    rows = []
    for u in range(num_users):
        for it in {
            int(x) for x in rng.integers(0, num_items, int(rng.integers(1, 4)))
        }:
            rows.append((u, it))
    val = pd.DataFrame(
        {"user_idx": [r[0] for r in rows], "item_idx": [r[1] for r in rows]}
    )
    if block_heavy:
        train_blocked = {
            u: {int(x) for x in rng.integers(0, num_items, 12)}
            for u in range(num_users)
        }
    else:
        train_blocked = {u: set(list(positives[u])[:2]) for u in range(num_users)}

    k_values = [5, 10]
    plan = build_eval_plan(
        val, train_blocked,
        num_users=num_users, num_items=num_items,
        k_values=k_values, user_batch_size=7,
    )
    local = evaluate_retrieval_metrics(
        state, data, cfg, plan=plan, k_values=k_values, topk_chunk_size=4
    )
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    sharded = evaluate_retrieval_metrics(
        state, data, cfg, plan=plan, k_values=k_values, topk_chunk_size=4,
        mesh=mesh,
    )
    for k in k_values:
        assert sharded.recall[k] == pytest.approx(local.recall[k], abs=1e-12)
        assert sharded.ndcg[k] == pytest.approx(local.ndcg[k], abs=1e-12)
        assert sharded.precision[k] == pytest.approx(local.precision[k], abs=1e-12)
        assert sharded.hit_rate[k] == pytest.approx(local.hit_rate[k], abs=1e-12)
        assert sharded.map[k] == pytest.approx(local.map[k], abs=1e-12)
    assert sharded.mrr == pytest.approx(local.mrr, abs=1e-12)


def test_bucketed_plan_heavy_user_matches_dict_path():
    """One heavy user must not drag the whole eval onto full-width masks:
    build_eval_plan buckets users at the narrow mask width (32), and the
    bucketed scan must reproduce the dict path's metrics exactly."""
    from ttamm.evaluation import (
        build_eval_plan,
        evaluate_retrieval_metrics,
    )
    from ttamm.evaluation.retrieval import NARROW_MASK_WIDTH

    num_users, num_items = 12, 120
    cfg, state, data, _, rng = _setup(
        num_users=num_users, num_items=num_items, seed=4
    )
    train_blocked = {
        u: {int(x) for x in rng.integers(0, num_items, 4)}
        for u in range(num_users)
    }
    train_blocked[3] = set(range(80))  # heavy-tail user: width 80 > 32
    rows = []
    for u in range(num_users):
        for it in {int(x) for x in rng.integers(0, num_items, 3)}:
            rows.append((u, it))
    val = pd.DataFrame(
        {"user_idx": [r[0] for r in rows], "item_idx": [r[1] for r in rows]}
    )
    k_values = [5, 10]
    plan = build_eval_plan(
        val, train_blocked,
        num_users=num_users, num_items=num_items,
        k_values=k_values, user_batch_size=5,
    )
    assert plan.wide is not None
    assert plan.blocked_rows.shape[1] == NARROW_MASK_WIDTH
    assert plan.wide.blocked_rows.shape[1] >= 80
    assert {u for b in plan.wide.batches for u in b} == {3}

    kwargs = dict(
        val_interactions=val,
        train_positive_map=train_blocked,
        num_items=num_items,
        k_values=k_values,
        use_mips=True,
        user_batch_size=5,
        topk_chunk_size=16,
    )
    preds_ref, gts_ref = evaluate_retrieval(state, data, cfg, **kwargs)
    preds_plan, gts_plan = evaluate_retrieval(
        state, data, cfg, plan=plan, **kwargs
    )
    assert preds_plan == preds_ref
    assert gts_plan == gts_ref

    want = compute_ranking_metrics(
        preds_ref, gts_ref, k_values, include_per_user=False
    )
    got = evaluate_retrieval_metrics(
        state, data, cfg, plan=plan, k_values=k_values, topk_chunk_size=16
    )
    for k in k_values:
        assert got.recall[k] == pytest.approx(want.recall[k], abs=1e-12)
        assert got.ndcg[k] == pytest.approx(want.ndcg[k], abs=1e-12)
        assert got.map[k] == pytest.approx(want.map[k], abs=1e-12)
    assert got.mrr == pytest.approx(want.mrr, abs=1e-12)


def test_bucketed_plan_sharded_mesh_matches_local():
    """The bucketed (narrow+wide) eval under a model-sharded mesh must
    match the local bucketed metrics exactly."""
    from ttamm.evaluation import (
        build_eval_plan,
        evaluate_retrieval_metrics,
    )
    from ttamm.parallel import MeshConfig, build_mesh

    num_users, num_items = 10, 96
    cfg, state, data, _, rng = _setup(
        num_users=num_users, num_items=num_items, seed=6
    )
    train_blocked = {
        u: {int(x) for x in rng.integers(0, num_items, 5)}
        for u in range(num_users)
    }
    train_blocked[2] = set(range(60))  # wide bucket member
    rows = []
    for u in range(num_users):
        for it in {int(x) for x in rng.integers(0, num_items, 2)}:
            rows.append((u, it))
    val = pd.DataFrame(
        {"user_idx": [r[0] for r in rows], "item_idx": [r[1] for r in rows]}
    )
    k_values = [5]
    plan = build_eval_plan(
        val, train_blocked,
        num_users=num_users, num_items=num_items,
        k_values=k_values, user_batch_size=4,
    )
    assert plan.wide is not None
    local = evaluate_retrieval_metrics(
        state, data, cfg, plan=plan, k_values=k_values, topk_chunk_size=16
    )
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    sharded = evaluate_retrieval_metrics(
        state, data, cfg, plan=plan, k_values=k_values, topk_chunk_size=16,
        mesh=mesh,
    )
    for k in k_values:
        assert sharded.recall[k] == pytest.approx(local.recall[k], abs=1e-12)
        assert sharded.ndcg[k] == pytest.approx(local.ndcg[k], abs=1e-12)
    assert sharded.mrr == pytest.approx(local.mrr, abs=1e-12)


def test_capped_blocked_rows_cannot_leak_train_positives():
    """A blocked matrix packed with a positives_cap must be rebuilt by
    build_eval_plan: truncated blocked rows would let the eval recommend
    the user's own train positives."""
    from ttamm.evaluation import build_eval_plan

    num_users, num_items = 6, 60
    cfg, state, data, _, rng = _setup(
        num_users=num_users, num_items=num_items, seed=5
    )
    train_blocked = {
        u: set(range(u, u + 40)) for u in range(num_users)
    }
    val = pd.DataFrame({"user_idx": [0, 1], "item_idx": [55, 56]})
    capped = jnp.asarray(
        pack_positives(
            train_blocked, num_users=num_users, num_items=num_items, cap=8
        ).rows
    )
    assert capped.shape[1] == 8  # the cap really truncated
    plan = build_eval_plan(
        val, train_blocked,
        num_users=num_users, num_items=num_items,
        k_values=[10], blocked_rows=capped,
    )
    widths = [b.blocked_rows.shape[1] for b in ([plan] + ([plan.wide] if plan.wide else []))]
    assert max(widths) >= 40  # rebuilt uncapped
    preds, gts = evaluate_retrieval(
        state, data, cfg,
        val_interactions=val,
        train_positive_map=train_blocked,
        num_items=num_items,
        k_values=[10],
        use_mips=True,
        plan=plan,
    )
    for u, items in preds.items():
        leaked = set(items) & (train_blocked[u] - gts[u])
        assert not leaked, (u, leaked)
