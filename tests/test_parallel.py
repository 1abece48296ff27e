"""Multi-device sharding tests on a virtual 8-device CPU mesh
(SURVEY §4 test plan items a/b)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.data import pack_positives
from ttamm.models import parse_model_config
from ttamm.parallel import (
    MeshConfig,
    build_mesh,
    make_sharded_train_step,
    pad_batch_data,
    pad_state_rows,
    place_data,
    place_state,
    sharded_mips_topk,
)
from ttamm.train import TrainStepConfig, create_train_state, make_train_step
from ttamm.train.optim import parse_dense_opt_config
from ttamm.train.state import BatchData

U, I, F, B, NEG = 48, 40, 12, 16, 3


def _setup(seed=0):
    mc = {
        "user_encoder": {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": 16},
            "fusion": "gated",
        },
        "item_encoder": {
            "type": "tower",
            "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
            "feature_encoder": {"type": "mlp", "hidden_dims": [32], "output_dim": 16},
            "fusion": "gated",
        },
        "similarity": "cosine",
        "adaptive_mimic": {"enabled": True},
    }
    cfg = parse_model_config(mc, user_feature_dim=F, item_feature_dim=F)
    state = create_train_state(jax.random.key(seed), cfg, num_users=U, num_items=I)
    rng = np.random.default_rng(seed)
    positives = {u: {int(x) for x in rng.integers(0, I, 3)} for u in range(U)}
    pp = pack_positives(positives, num_users=U, num_items=I)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(pp.rows),
        category_ids=jnp.asarray(rng.integers(0, 4, I).astype(np.int32)),
    )
    tscfg = TrainStepConfig(
        num_items=I,
        negatives_per_positive=NEG,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        lambda_category_alignment=0.01,
        cal_max_categories=4,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}
        ),
    )
    return cfg, state, data, tscfg


def test_mesh_construction():
    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    assert mesh.shape == {"data": 4, "model": 2}
    with pytest.raises(ValueError):
        build_mesh(MeshConfig(data_parallel=16, model_parallel=1))


def test_sharded_step_matches_single_device():
    """The sharded step must be numerically equivalent to the local step."""
    cfg, state, data, tscfg = _setup()
    step = make_train_step(cfg, tscfg)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(42)

    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = pad_state_rows(state, 2)
    pdata = pad_batch_data(data, 2)
    pstate = place_state(mesh, pstate)
    pdata = place_data(mesh, pdata)
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    # Table rows (excluding padding) identical after one update.
    rows = np.asarray(ref_state.tables["user_id"])
    srows = np.asarray(new_state.tables["user_id"])[: rows.shape[0]]
    assert np.allclose(rows, srows, atol=1e-5)
    dense_a = np.asarray(jax.tree.leaves(ref_state.dense)[0])
    dense_b = np.asarray(jax.tree.leaves(new_state.dense)[0])
    assert np.allclose(dense_a, dense_b, atol=1e-5)


def test_sharded_step_packed_moments_matches_single_device():
    """Packed [rows, 2D] sparse-Adam moments shard/pad/run identically."""
    cfg, _, data, tscfg = _setup()
    state = create_train_state(
        jax.random.key(0), cfg, num_users=U, num_items=I, packed_moments=True
    )
    step = make_train_step(cfg, tscfg)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(42)
    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = place_state(mesh, pad_state_rows(state, 2))
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    mv = np.asarray(ref_state.opt_sparse["user_id"].mv)
    smv = np.asarray(new_state.opt_sparse["user_id"].mv)[: mv.shape[0]]
    assert np.allclose(mv, smv, atol=1e-6)


def test_sharded_step_alltoall_exchange_matches_single_device():
    """embedding_exchange='alltoall' (the explicit bucketed exchange) must
    produce the same numbers as the local step."""
    cfg, state, data, tscfg = _setup()
    step = make_train_step(cfg, tscfg)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(42)
    ref_state, ref_metrics = step(state, data, u, p, key)

    tscfg = tscfg._replace(embedding_exchange="alltoall")
    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = place_state(mesh, pad_state_rows(state, 2))
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    rows = np.asarray(ref_state.tables["user_id"])
    srows = np.asarray(new_state.tables["user_id"])[: rows.shape[0]]
    assert np.allclose(rows, srows, atol=1e-5)
    aug = np.asarray(ref_state.tables["item_aug"])
    saug = np.asarray(new_state.tables["item_aug"])[: aug.shape[0]]
    assert np.allclose(aug, saug, atol=1e-5)


def test_sharded_step_tensor_parallel_matches_single_device():
    """tensor_parallel=True shards the dense MLP/gate weights and their
    AdamW moments over the model axis; numerics must be unchanged."""
    cfg, state, data, tscfg = _setup()
    step = make_train_step(cfg, tscfg)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(42)
    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    pstate = place_state(mesh, pad_state_rows(state, 4), tensor_parallel=True)
    pdata = place_data(mesh, pad_batch_data(data, 4))
    # The MLP hidden dim (32) and output (16) divide the model axis (4):
    # the weights must actually be sharded, not silently replicated.
    w0 = pstate.dense["user_tower"]["feature_encoder"]["layers"][0]["w"]
    assert w0.sharding.spec == (None, "model"), w0.sharding
    sharded = make_sharded_train_step(
        cfg, tscfg, mesh, pstate, pdata, tensor_parallel=True
    )
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    for ref_leaf, got_leaf in zip(
        jax.tree.leaves(ref_state.dense), jax.tree.leaves(new_state.dense)
    ):
        assert np.allclose(
            np.asarray(ref_leaf), np.asarray(got_leaf), atol=1e-5
        )


def test_sharded_step_runs_multiple_steps():
    cfg, state, data, tscfg = _setup(seed=3)
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    pstate = place_state(mesh, pad_state_rows(state, 4))
    pdata = place_data(mesh, pad_batch_data(data, 4))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    rng = np.random.default_rng(2)
    losses = []
    for i in range(20):
        u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
        p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
        pstate, metrics = sharded(pstate, pdata, u, p, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_sharded_mips_topk_matches_exact():
    rng = np.random.default_rng(5)
    items = rng.normal(0, 1, (100, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (7, 16)).astype(np.float32)
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    scores, idx = sharded_mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=9, mesh=mesh, chunk_size=16
    )
    full = queries @ items.T
    expected = np.argsort(-full, axis=1)[:, :9]
    assert np.array_equal(np.asarray(idx), expected)


def test_sharded_mips_topk_pad_rows_never_returned():
    """Regression: zero pad rows score 0.0, which outranks real items when
    all scores are negative — they must be masked to -inf BEFORE the
    shard-local top-k."""
    rng = np.random.default_rng(7)
    # All dot products strictly negative: every pad row would win unmasked.
    items = np.abs(rng.normal(0, 1, (100, 16))).astype(np.float32)
    queries = -np.abs(rng.normal(0, 1, (7, 16))).astype(np.float32)
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    # 100 rows over 8 shards -> padded to 104, 4 pad rows on the last
    # shard; k == rows_per_shard stresses local crowd-out too.
    k = 13
    scores, idx = sharded_mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=k, mesh=mesh, chunk_size=16
    )
    idx, scores = np.asarray(idx), np.asarray(scores)
    assert idx.max() < 100, "pad index leaked into the top-k"
    full = queries @ items.T
    expected = np.argsort(-full, axis=1)[:, :k]
    assert np.array_equal(idx, expected)
    assert np.allclose(scores, np.take_along_axis(full, idx, axis=1), atol=1e-5)


def test_sharded_mips_topk_bfloat16_mode():
    # score_dtype threads through shard_map: each shard ranks by its local
    # bf16 slab; the cross-shard merge sees fp32-widened bf16 scores.
    rng = np.random.default_rng(6)
    items = rng.normal(0, 1, (96, 16)).astype(np.float32)
    queries = rng.normal(0, 1, (5, 16)).astype(np.float32)
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    scores, idx = sharded_mips_topk(
        jnp.asarray(queries), jnp.asarray(items), k=7, mesh=mesh,
        chunk_size=16, score_dtype="bfloat16",
    )
    slab = np.asarray(
        jnp.dot(
            jnp.asarray(queries).astype(jnp.bfloat16),
            jnp.asarray(items).astype(jnp.bfloat16).T,
            preferred_element_type=jnp.bfloat16,
        ).astype(jnp.float32)
    )
    scores, idx = np.asarray(scores), np.asarray(idx)
    # returned scores must be the top-7 bf16 score multiset per row, and
    # each index must carry its own bf16 score (tie-robust assertions)
    assert np.array_equal(scores, -np.sort(-slab, axis=1)[:, :7])
    assert np.array_equal(np.take_along_axis(slab, idx, axis=1), scores)


def test_sharded_step_in_batch_softmax_logq_matches_single_device():
    """The corrected in-batch softmax (BatchData.item_log_q threaded
    through the mesh shardings) is numerically equivalent sharded."""
    cfg, state, data, tscfg = _setup()
    rng = np.random.default_rng(7)
    counts = rng.integers(1, 40, I).astype(np.float64)
    data = data._replace(
        item_log_q=jnp.asarray(np.log(counts / counts.sum()), jnp.float32)
    )
    tscfg = tscfg._replace(loss_type="in_batch_softmax")
    step = make_train_step(cfg, tscfg)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(21)

    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = place_state(mesh, pad_state_rows(state, 2))
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    rows = np.asarray(ref_state.tables["item_id"])
    srows = np.asarray(new_state.tables["item_id"])[: rows.shape[0]]
    assert np.allclose(rows, srows, atol=1e-5)


def test_sharded_step_mixed_negatives_matches_single_device():
    """In-batch softmax with a mixed-negative pool (round-5 lever) is
    numerically equivalent under the 8-device mesh."""
    cfg, state, data, tscfg = _setup()
    rng = np.random.default_rng(11)
    counts = rng.integers(1, 40, I).astype(np.float64)
    data = data._replace(
        item_log_q=jnp.asarray(np.log(counts / counts.sum()), jnp.float32)
    )
    tscfg = tscfg._replace(loss_type="in_batch_softmax", mixed_negatives=16)
    step = make_train_step(cfg, tscfg)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(23)

    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = place_state(mesh, pad_state_rows(state, 2))
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    rows = np.asarray(ref_state.tables["item_id"])
    srows = np.asarray(new_state.tables["item_id"])[: rows.shape[0]]
    assert np.allclose(rows, srows, atol=1e-5)


def test_sharded_step_lr_schedule_matches_single_device():
    """The on-device cosine lr schedule (traced lr through the shard-
    mapped sparse update) is numerically equivalent under the mesh."""
    from ttamm.train.optim import DenseOptConfig

    cfg, state, data, tscfg = _setup()
    tscfg = tscfg._replace(
        opt=DenseOptConfig(
            name="adamw", lr=0.01,
            lr_schedule="cosine", lr_total_steps=10, lr_final_factor=0.1,
        ),
        sparse_weight_decay=0.01,
    )
    rng = np.random.default_rng(13)
    step = make_train_step(cfg, tscfg)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(29)

    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    # Placements from COPIES: donation would otherwise delete the
    # original state's leaves (place_state aliases leaves that need no
    # repadding/resharding).
    pstate = place_state(
        mesh, pad_state_rows(jax.tree.map(jnp.copy, state), 2)
    )
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    # The shard-local (owner-routed) update too: the traced scheduled lr
    # + weight decay must thread through shard_map's sparse update.
    pstate2 = place_state(
        mesh, pad_state_rows(jax.tree.map(jnp.copy, state), 2)
    )
    sharded_pl = make_sharded_train_step(
        cfg, tscfg._replace(update_routing="owner"), mesh, pstate2, pdata
    )
    pl_state, pl_metrics = sharded_pl(pstate2, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    assert float(pl_metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    for name in ("item_id", "user_id"):
        rows = np.asarray(ref_state.tables[name])
        srows = np.asarray(new_state.tables[name])[: rows.shape[0]]
        plrows = np.asarray(pl_state.tables[name])[: rows.shape[0]]
        assert np.allclose(rows, srows, atol=1e-5), name
        assert np.allclose(rows, plrows, atol=1e-5), name


def test_sharded_step_comm_bf16_matches_single_device():
    """comm_dtype='bfloat16' rounds row grads once at the wire; the
    sharded step must match the single-device step WITH THE SAME FLAG
    (both paths round identically, math fp32 after the widen)."""
    cfg, state, data, tscfg = _setup()
    tscfg = tscfg._replace(comm_dtype="bfloat16")
    rng = np.random.default_rng(17)
    step = make_train_step(cfg, tscfg)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(31)

    ref_state, ref_metrics = step(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = place_state(
        mesh, pad_state_rows(jax.tree.map(jnp.copy, state), 2)
    )
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    for name in ref_state.tables:
        rows = np.asarray(ref_state.tables[name])
        srows = np.asarray(new_state.tables[name])[: rows.shape[0]]
        assert np.allclose(rows, srows, atol=1e-5), name

    # ...and stays CLOSE to the exact fp32 path. Adam's step-1 delta is
    # ~lr*sign(g), so a bf16-rounded near-zero grad can move an element
    # by up to ~2*lr — bound the diff by that, not by the 0.4% relative
    # rounding.
    exact_state, _ = make_train_step(cfg, tscfg._replace(comm_dtype="float32"))(
        jax.tree.map(jnp.copy, state), data, u, p, key
    )
    w = np.asarray(exact_state.tables["item_id"])
    wb = np.asarray(ref_state.tables["item_id"])
    assert np.allclose(w, wb, atol=2.5e-3)  # 2.5x lr
    assert not np.array_equal(w, wb)  # the rounding really happened


def test_sharded_step_owner_routing_matches_single_device():
    """Round-5 owner-routed sparse update: compact-owned-lanes + capacity
    all-gather (~1/mp the allgather routing's wire) must be numerically
    equivalent to the single-device step. Two-phase duplicate summation
    (within data shard, then across shards) is deterministic but not the
    single sorted pass, hence allclose rather than bit-equality."""
    cfg, state, data, tscfg = _setup()
    tscfg = tscfg._replace(update_routing="owner")
    rng = np.random.default_rng(19)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(37)

    ref_state, ref_metrics = make_train_step(cfg, tscfg._replace(
        update_routing="allgather"
    ))(state, data, u, p, key)

    # The (2,4) case additionally turns on tensor parallelism: owner
    # routing (sparse tables) and TP (dense params) must compose.
    for dp, mp, tp in ((4, 2, False), (2, 4, True)):
        mesh = build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
        pstate = place_state(
            mesh, pad_state_rows(jax.tree.map(jnp.copy, state), mp),
            tensor_parallel=tp,
        )
        pdata = place_data(mesh, pad_batch_data(data, mp))
        sharded = make_sharded_train_step(
            cfg, tscfg, mesh, pstate, pdata, tensor_parallel=tp
        )
        new_state, metrics = sharded(pstate, pdata, u, p, key)

        assert float(metrics["loss"]) == pytest.approx(
            float(ref_metrics["loss"]), rel=1e-4
        )
        for name in ref_state.tables:
            rows = np.asarray(ref_state.tables[name])
            srows = np.asarray(new_state.tables[name])[: rows.shape[0]]
            assert np.allclose(rows, srows, atol=1e-5), (dp, mp, name)
        for name, st in ref_state.opt_sparse.items():
            sm = np.asarray(new_state.opt_sparse[name].m)[: st.m.shape[0]]
            assert np.allclose(np.asarray(st.m), sm, atol=1e-6), (dp, mp, name)


def test_sharded_step_owner_routing_overflow_fallback():
    """A capacity too small for the batch's per-shard unique-row counts
    must take the guaranteed lax.cond fallback (full allgather routing for
    that step) and still match the single-device step exactly — overflow
    is never dropped."""
    from ttamm.parallel.sparse_update import owner_capacity

    cfg, state, data, tscfg = _setup()
    tscfg = tscfg._replace(
        update_routing="owner", update_capacity_factor=0.01
    )
    # The tiny factor must actually produce a capacity below the unique
    # owned counts (otherwise this test silently stops testing overflow).
    assert owner_capacity(B * (1 + NEG), 4, 2, 0.01) < B * (1 + NEG) // 4
    rng = np.random.default_rng(23)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    key = jax.random.key(41)

    ref_state, ref_metrics = make_train_step(cfg, tscfg)(state, data, u, p, key)

    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    pstate = place_state(
        mesh, pad_state_rows(jax.tree.map(jnp.copy, state), 2)
    )
    pdata = place_data(mesh, pad_batch_data(data, 2))
    sharded = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
    new_state, metrics = sharded(pstate, pdata, u, p, key)

    assert float(metrics["loss"]) == pytest.approx(
        float(ref_metrics["loss"]), rel=1e-4
    )
    for name in ref_state.tables:
        rows = np.asarray(ref_state.tables[name])
        srows = np.asarray(new_state.tables[name])[: rows.shape[0]]
        assert np.allclose(rows, srows, atol=1e-5), name


def test_owner_routing_unit_variants():
    """Unit-level sharded_sparse_adam_update: 'owner', 'owner_unchecked'
    (no cond; same result when capacity holds) and bf16 wire grads all
    match the single-device reference."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ttamm.ops.sparse_adam import SparseAdamState, sparse_adam_update
    from ttamm.parallel.sparse_update import sharded_sparse_adam_update

    ROWS, D, N = 64, 8, 32
    rng = np.random.default_rng(7)
    table = jnp.asarray(rng.normal(size=(ROWS, D)).astype(np.float32))
    zeros = jnp.zeros((ROWS, D), jnp.float32)
    idx = jnp.asarray(rng.integers(0, ROWS, N).astype(np.int32))
    grads = jnp.asarray(rng.normal(size=(N, D)).astype(np.float32))
    # 1x8 covers the dp==1 static branch (second coalesce skipped:
    # compacted lanes are already sorted-unique, sentinels at the tail).
    mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    mesh_dp1 = build_mesh(MeshConfig(data_parallel=1, model_parallel=8))
    tdev = jax.device_put(table, NamedSharding(mesh, P("model", None)))

    def run(routing, g):
        st = SparseAdamState(
            m=zeros, v=zeros, step=jnp.asarray(0, jnp.int32)
        )
        fn = jax.jit(
            lambda t, s, i, gg: sharded_sparse_adam_update(
                mesh, t, s, i, gg, lr=1e-2, routing=routing
            )
        )
        return fn(tdev, st, idx, g)

    st0 = SparseAdamState(m=zeros, v=zeros, step=jnp.asarray(0, jnp.int32))
    ref_tbl, _ = sparse_adam_update(
        table, st0, idx, grads, lr=1e-2
    )
    own_tbl, _ = run("owner", grads)
    unc_tbl, _ = run("owner_unchecked", grads)
    assert np.allclose(np.asarray(own_tbl), np.asarray(ref_tbl), atol=1e-5)
    # Capacity holds at these shapes, so unchecked == checked exactly.
    assert np.array_equal(np.asarray(unc_tbl), np.asarray(own_tbl))

    # bf16 wire: double rounding (per-lane cast + wire re-cast of the
    # coalesced sums) stays within the Adam step-1 envelope (~2x lr).
    bf_tbl, _ = run("owner", grads.astype(jnp.bfloat16))
    assert np.allclose(np.asarray(bf_tbl), np.asarray(ref_tbl), atol=2.5e-2)

    # dp == 1 (model-only 1x8 mesh): the skipped second coalesce must not
    # change the result.
    st1 = SparseAdamState(m=zeros, v=zeros, step=jnp.asarray(0, jnp.int32))
    t1dev = jax.device_put(table, NamedSharding(mesh_dp1, P("model", None)))
    dp1_tbl, _ = jax.jit(
        lambda t, s, i, g: sharded_sparse_adam_update(
            mesh_dp1, t, s, i, g, lr=1e-2, routing="owner"
        )
    )(t1dev, st1, idx, grads)
    assert np.allclose(np.asarray(dp1_tbl), np.asarray(ref_tbl), atol=1e-5)
