"""Kernel-vs-reference numerics tests (SURVEY §4 test plan item c)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.ops import (
    bce_with_logits,
    category_alignment_loss,
    init_sparse_adam,
    mips_topk,
    sparse_adam_update,
)


def test_bce_matches_reference_formula():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2, 50).astype(np.float32)
    labels = (rng.random(50) > 0.5).astype(np.float32)
    got = float(bce_with_logits(jnp.asarray(logits), jnp.asarray(labels)))
    p = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
    expected = -np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p))
    assert got == pytest.approx(expected, rel=1e-5)


def test_mips_topk_exact_vs_argsort():
    rng = np.random.default_rng(1)
    items = rng.normal(0, 1, (257, 16)).astype(np.float32)  # non-multiple of chunk
    queries = rng.normal(0, 1, (9, 16)).astype(np.float32)
    scores, idx = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=7, chunk_size=64
    )
    full = queries @ items.T
    expected_idx = np.argsort(-full, axis=1)[:, :7]
    assert np.array_equal(np.asarray(idx), expected_idx)
    expected_scores = np.take_along_axis(full, expected_idx, axis=1)
    assert np.allclose(np.asarray(scores), expected_scores, atol=1e-5)


def test_mips_topk_mask_rows_excluded():
    rng = np.random.default_rng(2)
    items = rng.normal(0, 1, (40, 8)).astype(np.float32)
    queries = rng.normal(0, 1, (3, 8)).astype(np.float32)
    mask = np.array([[0, 1, 40, 40], [5, 40, 40, 40], [40, 40, 40, 40]], np.int32)
    _, idx = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=10, chunk_size=16,
        mask_rows=jnp.asarray(mask),
    )
    idx = np.asarray(idx)
    assert 0 not in idx[0] and 1 not in idx[0]
    assert 5 not in idx[1]


def test_coalesce_row_grads_sums_duplicates():
    from ttamm.parallel.sparse_update import _coalesce_sorted

    idx = jnp.array([3, 1, 3, 3, 2], jnp.int32)
    grads = jnp.arange(10, dtype=jnp.float32).reshape(5, 2)
    targets, summed, is_head, _ = _coalesce_sorted(idx, grads, head_init=-1)
    assert np.asarray(is_head).sum() == 3
    by_row = {}
    for t, g in zip(np.asarray(targets), np.asarray(summed)):
        by_row.setdefault(int(t), g)
        assert np.allclose(by_row[int(t)], g)  # every duplicate lane agrees
    assert np.allclose(by_row[1], [2, 3])
    assert np.allclose(by_row[2], [8, 9])
    assert np.allclose(by_row[3], np.array([0, 1]) + [4, 5] + np.array([6, 7]))


def test_sparse_adam_matches_dense_adam_on_touched_rows():
    """SparseAdam == Adam restricted to touched rows (coalesced grads)."""
    rng = np.random.default_rng(3)
    table = rng.normal(0, 1, (6, 4)).astype(np.float32)
    table_p = np.concatenate([table, np.zeros((1, 4), np.float32)])  # scratch
    state = init_sparse_adam(jnp.asarray(table_p))

    idx = np.array([0, 2, 0], np.int32)
    grads = rng.normal(0, 1, (3, 4)).astype(np.float32)
    lr, b1, b2, eps = 0.01, 0.9, 0.999, 1e-8

    new_table, new_state = sparse_adam_update(
        jnp.asarray(table_p), state, jnp.asarray(idx), jnp.asarray(grads),
        lr=lr, b1=b1, b2=b2, eps=eps,
    )
    new_table = np.asarray(new_table)

    # Reference dense-math computation for rows 0 (coalesced) and 2.
    for row, g in [(0, grads[0] + grads[2]), (2, grads[1])]:
        m = (1 - b1) * g
        v = (1 - b2) * g * g
        m_hat = m / (1 - b1)
        v_hat = v / (1 - b2)
        expected = table[row] - lr * m_hat / (np.sqrt(v_hat) + eps)
        assert np.allclose(new_table[row], expected, atol=1e-6), row

    # Untouched rows unchanged.
    for row in [1, 3, 4, 5]:
        assert np.allclose(new_table[row], table[row])
    assert int(new_state.step) == 1


def test_sparse_adam_second_step_uses_moments():
    table = jnp.zeros((3, 2))
    state = init_sparse_adam(table)
    idx = jnp.array([0], jnp.int32)
    g = jnp.ones((1, 2))
    t1, s1 = sparse_adam_update(table, state, idx, g, lr=0.1)
    t2, s2 = sparse_adam_update(t1, s1, idx, g, lr=0.1)
    # constant gradient: both steps move by ~lr
    assert float(t2[0, 0]) == pytest.approx(-0.2, abs=1e-3)
    assert int(s2.step) == 2


def test_sparse_adam_packed_matches_separate_bit_exact():
    """The [rows, 2D] packed-moment layout is bit-identical to the
    separate-m/v sorted path over multiple steps with duplicate indices."""
    rng = np.random.default_rng(7)
    rows, dim, n = 64, 8, 24
    table0 = jnp.asarray(rng.normal(0, 0.1, (rows, dim)).astype(np.float32))
    sep = init_sparse_adam(table0)
    packed = init_sparse_adam(table0, packed=True)
    assert packed.mv.shape == (rows, 2 * dim)

    t_sep, t_pack = table0, table0
    for step in range(4):
        idx = jnp.asarray(
            rng.integers(0, rows - 1, n).astype(np.int32)
        )  # duplicates guaranteed at n=24 over 63 rows across steps
        g = jnp.asarray(rng.normal(0, 1, (n, dim)).astype(np.float32))
        t_sep, sep = sparse_adam_update(t_sep, sep, idx, g, lr=0.05)
        t_pack, packed = sparse_adam_update(t_pack, packed, idx, g, lr=0.05)

    np.testing.assert_array_equal(np.asarray(t_sep), np.asarray(t_pack))
    np.testing.assert_array_equal(np.asarray(sep.m), np.asarray(packed.m))
    np.testing.assert_array_equal(np.asarray(sep.v), np.asarray(packed.v))
    assert int(sep.step) == int(packed.step) == 4


def test_packed_moments_state_roundtrip_and_views():
    """create_train_state(packed_moments=True) produces packed sparse
    states whose m/v views match a fresh separate-layout state, and the
    jitted train step runs on it."""
    from ttamm.models import parse_model_config
    from ttamm.train import TrainStepConfig, create_train_state, make_train_step
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData
    from ttamm.ops import SparseAdamStatePacked

    cfg = parse_model_config(
        {
            "embedding_dim": 8,
            "user_tower": {"embedding": {"sparse": True}},
            "item_tower": {"embedding": {"sparse": True}},
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=0,
        item_feature_dim=0,
    )
    key = jax.random.key(0)
    st_sep = create_train_state(key, cfg, num_users=16, num_items=12)
    st_pack = create_train_state(
        key, cfg, num_users=16, num_items=12, packed_moments=True
    )
    for name, s in st_pack.opt_sparse.items():
        assert isinstance(s, SparseAdamStatePacked)
        np.testing.assert_array_equal(
            np.asarray(s.m), np.asarray(st_sep.opt_sparse[name].m)
        )

    tscfg = TrainStepConfig(
        num_items=12,
        negatives_per_positive=2,
        opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 1e-3}),
    )
    data = BatchData(
        user_features=None,
        item_features=None,
        positive_rows=jnp.zeros((16, 2), jnp.int32),
        category_ids=None,
    )
    step = make_train_step(cfg, tscfg)
    u = jnp.arange(8, dtype=jnp.int32)
    p = jnp.arange(8, dtype=jnp.int32) % 12
    s1, m1 = step(st_sep, data, u, p, jax.random.key(1))
    s2, m2 = step(st_pack, data, u, p, jax.random.key(1))
    np.testing.assert_array_equal(
        np.asarray(s1.tables["user_id"]), np.asarray(s2.tables["user_id"])
    )
    np.testing.assert_array_equal(
        np.asarray(m1["loss"]), np.asarray(m2["loss"])
    )


def test_category_alignment_zero_when_single_category():
    embs = jnp.asarray(np.random.default_rng(0).normal(0, 1, (10, 4)), jnp.float32)
    cats = jnp.zeros((10,), jnp.int32)
    loss = category_alignment_loss(cats, embs, max_categories=4)
    assert float(loss) == 0.0


def test_category_alignment_matches_numpy_reference():
    rng = np.random.default_rng(4)
    embs = rng.normal(0, 1, (30, 6)).astype(np.float32)
    cats = rng.integers(0, 3, 30).astype(np.int32)

    def np_cov(x):
        if x.shape[0] <= 1:
            return np.zeros((x.shape[1], x.shape[1]))
        c = x - x.mean(0, keepdims=True)
        return c.T @ c / (x.shape[0] - 1)

    major = np_cov(embs[cats == 0])
    total, compared = 0.0, 0
    for c in [1, 2]:
        members = embs[cats == c]
        if members.shape[0] < 2:
            continue
        d = np_cov(members) - major
        total += float((d * d).sum())
        compared += 1
    expected = total / compared
    got = float(category_alignment_loss(jnp.asarray(cats), jnp.asarray(embs), max_categories=3))
    assert got == pytest.approx(expected, rel=1e-4)


def test_mips_topk_group_exact_matches_chunked():
    rng = np.random.default_rng(7)
    items = rng.normal(0, 1, (1000, 16)).astype(np.float32)  # pads to 8 groups
    queries = rng.normal(0, 1, (17, 16)).astype(np.float32)
    for k in (1, 5, 130):  # 130 > number of groups (8) exercises k > NG
        sg, ig = mips_topk(
            jnp.asarray(queries), jnp.asarray(items), k=k, algorithm="group_exact"
        )
        sc, ic = mips_topk(
            jnp.asarray(queries), jnp.asarray(items), k=k,
            chunk_size=256, algorithm="chunked",
        )
        assert np.allclose(np.asarray(sg), np.asarray(sc), atol=1e-5)
        assert np.array_equal(np.sort(np.asarray(ig)), np.sort(np.asarray(ic)))


def test_mips_topk_group_exact_with_ties_and_mask():
    rng = np.random.default_rng(8)
    items = np.repeat(rng.normal(0, 1, (50, 8)), 3, axis=0).astype(np.float32)
    queries = rng.normal(0, 1, (4, 8)).astype(np.float32)
    mask = np.full((4, 6), 150, np.int32)
    mask[0, :3] = [0, 1, 2]  # block one full tied triple for query 0
    sg, ig = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=9,
        mask_rows=jnp.asarray(mask), algorithm="group_exact",
    )
    sc, _ = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=9,
        mask_rows=jnp.asarray(mask), chunk_size=32, algorithm="chunked",
    )
    # tied scores make index sets ambiguous; the score multisets must match
    assert np.allclose(np.sort(np.asarray(sg)), np.sort(np.asarray(sc)), atol=1e-5)
    assert not np.isin(np.asarray(ig[0]), [0, 1, 2]).any()


def test_mips_topk_group_blocked_matches_argsort():
    # Tiny budget forces the query-blocking scan (with a padded remainder
    # block) plus per-block mask slicing.
    from ttamm.ops.topk import _group_exact_topk

    rng = np.random.default_rng(11)
    items = rng.normal(0, 1, (57, 8)).astype(np.float32)
    queries = rng.normal(0, 1, (9, 8)).astype(np.float32)
    mask = np.full((9, 3), 57, np.int32)
    mask[0] = [0, 1, 2]
    mask[4, 0] = 13
    scores, idx = _group_exact_topk(
        jnp.asarray(queries), jnp.asarray(items), 5, jnp.asarray(mask), 57,
        query_block=2,
    )
    full = queries @ items.T
    full[0, [0, 1, 2]] = -np.inf
    full[4, 13] = -np.inf
    expected_idx = np.argsort(-full, axis=1)[:, :5]
    assert np.array_equal(np.asarray(idx), expected_idx)
    assert np.allclose(
        np.asarray(scores), np.take_along_axis(full, expected_idx, axis=1),
        atol=1e-5,
    )


def test_mips_topk_group_select_variants_match():
    # The one-hot-matmul candidate selection must be bit-identical to the
    # row-gather selection (multiply-by-1.0 in HIGHEST precision is exact).
    from ttamm.ops.topk import _group_exact_topk

    rng = np.random.default_rng(12)
    items = rng.normal(0, 1, (300, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (17, 16)).astype(np.float32)
    for k in (1, 10, 300):
        se, ie = _group_exact_topk(
            jnp.asarray(queries), jnp.asarray(items), k, None, 300,
            _select="einsum",
        )
        sg, ig = _group_exact_topk(
            jnp.asarray(queries), jnp.asarray(items), k, None, 300,
            _select="gather",
        )
        assert np.array_equal(np.asarray(se), np.asarray(sg))
        assert np.array_equal(np.asarray(ie), np.asarray(ig))
        sc, ic = mips_topk(
            jnp.asarray(queries), jnp.asarray(items), k=k,
            chunk_size=128, algorithm="chunked",
        )
        assert np.allclose(np.asarray(se), np.asarray(sc), atol=1e-5)
        assert np.array_equal(np.sort(np.asarray(ie)), np.sort(np.asarray(ic)))


def test_mips_topk_group_exact_all_negative_tail():
    # Items chosen so every real score is negative: the zero-score pad
    # columns of the row-padded item matrix would win both the tail
    # group's max and the final top-k if they weren't excluded (the slab
    # itself no longer -infs them; see _group_exact_topk step 1).
    rng = np.random.default_rng(13)
    n = 200  # pads to 2 groups of 128 -> 56 pad rows in the tail group
    d = 8
    queries = rng.normal(0, 1, (5, d)).astype(np.float32)
    queries[:, 0] = 0.5 + np.abs(queries[:, 0])  # positive first coordinate
    # items live on -e0: score(q_b, i) = -(1 + u_i) * q_b[0] < 0 everywhere
    u = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    items = np.zeros((n, d), np.float32)
    items[:, :1] = -(1.0 + u)
    sg, ig = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=7, algorithm="group_exact"
    )
    full = queries @ items.T
    expected_idx = np.argsort(-full, axis=1)[:, :7]
    assert (np.asarray(ig) < n).all()
    assert np.allclose(
        np.asarray(sg), np.take_along_axis(full, expected_idx, axis=1), atol=1e-5
    )
    assert (np.asarray(sg) < 0).all()


def test_mips_topk_bfloat16_mode():
    # Opt-in bf16 scoring: ranking must be exact w.r.t. the bf16 score
    # slab (selection gathers are exact); bf16 rounding creates ties, so
    # compare score multisets plus per-index score consistency.
    rng = np.random.default_rng(21)
    items = rng.normal(0, 1, (300, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (9, 16)).astype(np.float32)
    sb, ib = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=7,
        score_dtype="bfloat16",
    )
    assert sb.dtype == jnp.float32
    slab = np.asarray(
        jnp.dot(
            jnp.asarray(queries).astype(jnp.bfloat16),
            jnp.asarray(items).astype(jnp.bfloat16).T,
            preferred_element_type=jnp.bfloat16,
        ).astype(jnp.float32)
    )
    sb, ib = np.asarray(sb), np.asarray(ib)
    expected_scores = -np.sort(-slab, axis=1)[:, :7]
    assert np.array_equal(sb, expected_scores)  # exact: bf16 values widened
    # every returned index really has the returned score
    assert np.array_equal(np.take_along_axis(slab, ib, axis=1), sb)
    # each row's indices are unique
    assert all(len(set(row.tolist())) == 7 for row in ib)


def test_mips_topk_bfloat16_mask_and_tail():
    # mask_rows exclusion + row-padded tail handling under the bf16 slab
    # (masked entries use the FINITE bf16 min; pad columns masked
    # post-selection).
    rng = np.random.default_rng(22)
    items = rng.normal(0, 1, (200, 8)).astype(np.float32)  # 56 pad rows
    queries = rng.normal(0, 1, (4, 8)).astype(np.float32)
    mask = np.full((4, 3), 200, np.int32)
    mask[0] = [0, 1, 2]
    sb, ib = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=150,
        mask_rows=jnp.asarray(mask), score_dtype="bfloat16",
        algorithm="group_exact",
    )
    ib = np.asarray(ib)
    assert (ib < 200).all()
    assert not np.isin(ib[0], [0, 1, 2]).any()
    assert np.isfinite(np.asarray(sb)).all()


def test_mips_topk_bfloat16_mask_matches_dense_reference():
    # Regression: masking the bf16 slab with a value that rounds to -inf
    # NaN-poisons the one-hot selection einsum (0 * -inf = NaN) — every
    # candidate column sharing a slab column with a blocked entry went NaN
    # and the eval's validity bits collapsed (nvalid=0 -> all-GT-appended
    # -> recall "1.0" in the round-2 serving gate). Pin the full result
    # against a dense bf16 scoring + numpy sort reference at a small k
    # where the true top scores cannot hide the corruption.
    rng = np.random.default_rng(31)
    items = rng.normal(0, 1, (400, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (8, 16)).astype(np.float32)
    mask = rng.integers(0, 400, (8, 6)).astype(np.int32)
    sb, ib = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=5,
        mask_rows=jnp.asarray(mask), score_dtype="bfloat16",
    )
    sb, ib = np.asarray(sb), np.asarray(ib)
    assert np.isfinite(sb).all()
    dense = np.array(
        jnp.dot(
            jnp.asarray(queries).astype(jnp.bfloat16),
            jnp.asarray(items).astype(jnp.bfloat16).T,
            preferred_element_type=jnp.bfloat16,
        ).astype(jnp.float32)
    )
    for b in range(8):
        dense[b, mask[b]] = -np.inf
    expected = -np.sort(-dense, axis=1)[:, :5]
    assert np.array_equal(sb, expected)
    assert np.array_equal(np.take_along_axis(dense, ib, axis=1), sb)
    for b in range(8):
        assert not set(ib[b].tolist()) & set(mask[b].tolist())


def test_mips_topk_bfloat16_chunked_matches_group_exact():
    # The chunked algorithm (auto choice beyond the score-slab budget)
    # must honor the bf16 contract too: chunk scores are bf16-rounded
    # before the merge, so both algorithms rank by the same values.
    rng = np.random.default_rng(33)
    items = rng.normal(0, 1, (300, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (6, 16)).astype(np.float32)
    mask = rng.integers(0, 300, (6, 4)).astype(np.int32)
    sg, ig = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=7,
        mask_rows=jnp.asarray(mask), score_dtype="bfloat16",
        algorithm="group_exact",
    )
    sc, ic = mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=7,
        mask_rows=jnp.asarray(mask), score_dtype="bfloat16",
        algorithm="chunked", chunk_size=64,
    )
    np.testing.assert_array_equal(np.asarray(sg), np.asarray(sc))
    # indices may differ only among equal scores; verify score-consistency
    slab = np.array(
        jnp.dot(
            jnp.asarray(queries).astype(jnp.bfloat16),
            jnp.asarray(items).astype(jnp.bfloat16).T,
            preferred_element_type=jnp.bfloat16,
        ).astype(jnp.float32)
    )
    np.testing.assert_array_equal(
        np.take_along_axis(slab, np.asarray(ic), axis=1), np.asarray(sc)
    )


def test_mips_topk_num_valid_rows_matches_unpadded():
    """A corpus pre-padded to tile multiples with num_valid_rows set must
    return exactly the unpadded search's results (pad rows never appear,
    even when real scores are all negative and the zero pad rows would
    otherwise win)."""
    from ttamm.ops.topk import mips_topk

    rng = np.random.default_rng(17)
    n, d = 300, 16
    items = rng.normal(-2, 0.5, (n, d)).astype(np.float32)  # negative-ish
    queries = rng.normal(0, 1, (7, d)).astype(np.float32)
    padded = np.concatenate(
        [items, np.zeros((2048 - n, d), np.float32)]
    )
    for algorithm in ("group_exact", "chunked"):
        s0, i0 = mips_topk(
            jnp.asarray(queries), jnp.asarray(items), k=9,
            algorithm=algorithm, chunk_size=64,
        )
        s1, i1 = mips_topk(
            jnp.asarray(queries), jnp.asarray(padded), k=9,
            num_valid_rows=n, algorithm=algorithm, chunk_size=64,
        )
        np.testing.assert_array_equal(np.asarray(i0), np.asarray(i1))
        np.testing.assert_allclose(
            np.asarray(s0), np.asarray(s1), atol=1e-6
        )
        assert np.asarray(i1).max() < n
