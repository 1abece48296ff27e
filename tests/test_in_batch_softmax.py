"""In-batch sampled-softmax training option (BASELINE config #2)."""

import jax
import jax.numpy as jnp
import numpy as np

from ttamm.data import pack_positives
from ttamm.models import parse_model_config
from ttamm.train import TrainStepConfig, create_train_state, make_train_step
from ttamm.train.step import _in_batch_softmax_loss, make_eval_loss_step
from ttamm.train.optim import parse_dense_opt_config
from ttamm.train.state import BatchData


def test_in_batch_softmax_loss_matches_manual():
    rng = np.random.default_rng(0)
    u = rng.normal(0, 1, (4, 8)).astype(np.float32)
    v = rng.normal(0, 1, (4, 8)).astype(np.float32)
    idx = np.array([0, 1, 2, 3], np.int32)
    got = float(_in_batch_softmax_loss(jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx)))
    logits = u @ v.T
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    expected = -np.mean(np.diagonal(logp))
    assert np.isclose(got, expected, atol=1e-5)


def test_duplicate_items_masked_not_penalised():
    # Two rows share the same positive item: each other's column is masked.
    u = np.eye(2, 4, dtype=np.float32) * 10
    v = np.tile(np.eye(1, 4, dtype=np.float32) * 10, (2, 1))
    idx = np.array([5, 5], np.int32)
    loss = float(
        _in_batch_softmax_loss(jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx))
    )
    # with the duplicate masked, each row's softmax has one live column
    assert np.isclose(loss, 0.0, atol=1e-5)


def test_training_converges_with_in_batch_loss():
    U, I, F, B = 30, 25, 5, 10
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    rng = np.random.default_rng(1)
    positives = {u: {int(x) for x in rng.integers(0, I, 2)} for u in range(U)}
    packed = pack_positives(positives, num_users=U, num_items=I)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(packed.rows),
        category_ids=None,
    )
    tscfg = TrainStepConfig(
        num_items=I,
        loss_type="in_batch_softmax",
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 0.01}),
    )
    state = create_train_state(jax.random.key(0), cfg, num_users=U, num_items=I)
    step = make_train_step(cfg, tscfg)
    losses = []
    u_fixed = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p_fixed = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    for i in range(25):
        state, metrics = step(state, data, u_fixed, p_fixed, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0]

    eval_step = make_eval_loss_step(cfg, tscfg)
    val = float(eval_step(state, data, u_fixed, p_fixed, jax.random.key(99)))
    assert np.isfinite(val)


def test_logq_correction_matches_manual():
    rng = np.random.default_rng(2)
    u = rng.normal(0, 1, (5, 8)).astype(np.float32)
    v = rng.normal(0, 1, (5, 8)).astype(np.float32)
    idx = np.array([3, 1, 4, 0, 2], np.int32)
    num_items = 6
    counts = np.array([10, 40, 5, 25, 15, 1], np.float64)
    log_q = np.log(counts / counts.sum()).astype(np.float32)
    got = float(
        _in_batch_softmax_loss(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx),
            log_q=jnp.asarray(log_q),
        )
    )
    logits = (u @ v.T) - log_q[idx][None, :]
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    expected = -np.mean(np.diagonal(logp))
    assert np.isclose(got, expected, atol=1e-5)
    # and the correction actually changes the loss vs the plain variant
    plain = float(
        _in_batch_softmax_loss(jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx))
    )
    assert not np.isclose(got, plain, atol=1e-6)


def test_temperature_matches_manual():
    rng = np.random.default_rng(3)
    u = rng.normal(0, 1, (4, 8)).astype(np.float32)
    v = rng.normal(0, 1, (4, 8)).astype(np.float32)
    idx = np.array([0, 1, 2, 3], np.int32)
    tau = 0.25
    got = float(
        _in_batch_softmax_loss(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(idx), temperature=tau
        )
    )
    logits = (u @ v.T) / tau
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    expected = -np.mean(np.diagonal(logp))
    assert np.isclose(got, expected, atol=1e-5)


def test_train_step_threads_logq_through_batch_data():
    """The jitted step consumes BatchData.item_log_q when
    tscfg.logq_correction is on, and ignores it when off."""
    U, I, F, B = 12, 9, 4, 6
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "sum",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "sum",
            },
            "adaptive_mimic": {"enabled": False},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    rng = np.random.default_rng(4)
    positives = {u: {int(x) for x in rng.integers(0, I, 2)} for u in range(U)}
    packed = pack_positives(positives, num_users=U, num_items=I)
    counts = rng.integers(1, 50, I).astype(np.float64)
    log_q = jnp.asarray(np.log(counts / counts.sum()), jnp.float32)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(packed.rows),
        category_ids=None,
        item_log_q=log_q,
    )
    state = create_train_state(jax.random.key(0), cfg, num_users=U, num_items=I)
    u_idx = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p_idx = jnp.asarray(rng.integers(0, I, B).astype(np.int32))

    def first_loss(logq_on):
        tscfg = TrainStepConfig(
            num_items=I,
            loss_type="in_batch_softmax",
            logq_correction=logq_on,
            opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 0.01}),
        )
        step = make_train_step(cfg, tscfg)
        _, metrics = step(state, data, u_idx, p_idx, jax.random.key(0))
        return float(metrics["loss"])

    corrected, plain = first_loss(True), first_loss(False)
    assert np.isfinite(corrected) and np.isfinite(plain)
    assert not np.isclose(corrected, plain, atol=1e-6)

    # the eval-loss step applies the same correction
    tscfg = TrainStepConfig(
        num_items=I,
        loss_type="in_batch_softmax",
        opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 0.01}),
    )
    val = float(make_eval_loss_step(cfg, tscfg)(state, data, u_idx, p_idx, jax.random.key(1)))
    assert np.isfinite(val)


def test_batch_data_logq_sharding_and_padding():
    from ttamm.parallel.sharding import data_shardings, pad_batch_data
    from ttamm.parallel.mesh import MeshConfig, build_mesh

    data = BatchData(
        user_features=jnp.zeros((5, 3)),
        item_features=jnp.zeros((7, 3)),
        positive_rows=jnp.zeros((5, 2), jnp.int32),
        category_ids=jnp.zeros((7,), jnp.int32),
        item_log_q=jnp.zeros((7,), jnp.float32),
    )
    padded = pad_batch_data(data, 4)
    assert padded.item_log_q.shape[0] % 4 == 0
    assert padded.item_log_q.shape[0] == padded.category_ids.shape[0]
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=1))
    s = data_shardings(mesh, data)
    assert s.item_log_q is not None


def test_mixed_negatives_loss_matches_manual():
    """Mixed negative sampling: logits [B, B+M], mixture logQ correction
    log((B*q_pop + M/N)/(B+M)), accidental-hit masking across the whole
    candidate pool."""
    rng = np.random.default_rng(3)
    B, M, D, N = 5, 3, 8, 50
    u = rng.normal(size=(B, D)).astype(np.float32)
    v = rng.normal(size=(B, D)).astype(np.float32)
    negs = rng.normal(size=(M, D)).astype(np.float32)
    pos_idx = np.array([4, 7, 4, 9, 11], np.int32)  # rows 0/2 share item 4
    neg_idx = np.array([7, 30, 31], np.int32)  # pool item 7 = row 1's positive
    counts = rng.integers(1, 20, N).astype(np.float64)
    log_q = np.log(counts / counts.sum()).astype(np.float32)

    got = float(
        _in_batch_softmax_loss(
            jnp.asarray(u), jnp.asarray(v), jnp.asarray(pos_idx),
            neg_emb=jnp.asarray(negs), neg_idx=jnp.asarray(neg_idx),
            num_items=N, log_q=jnp.asarray(log_q),
        )
    )

    cand = np.concatenate([v, negs]).astype(np.float64)
    cand_idx = np.concatenate([pos_idx, neg_idx])
    logits = u.astype(np.float64) @ cand.T
    q_mix = (B * np.exp(log_q[cand_idx].astype(np.float64)) + M / N) / (B + M)
    logits = logits - np.log(q_mix)[None, :]
    mask = cand_idx[None, :] == pos_idx[:, None]
    for i in range(B):
        mask[i, i] = False
    logits = np.where(mask, np.finfo(np.float32).min, logits)
    logp = logits - np.log(np.exp(logits).sum(axis=1, keepdims=True))
    expected = -np.mean(np.diagonal(logp))
    assert np.isclose(got, expected, atol=1e-5)


def test_mixed_negatives_empty_pool_is_identical_to_plain():
    rng = np.random.default_rng(4)
    u = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(4, 8)).astype(np.float32))
    idx = jnp.asarray(np.array([0, 1, 2, 3], np.int32))
    counts = rng.integers(1, 9, 10).astype(np.float64)
    log_q = jnp.asarray(np.log(counts / counts.sum()).astype(np.float32))
    plain = float(_in_batch_softmax_loss(u, v, idx, log_q=log_q))
    empty = float(
        _in_batch_softmax_loss(
            u, v, idx,
            neg_emb=jnp.zeros((0, 8), jnp.float32),
            neg_idx=jnp.zeros((0,), jnp.int32),
            num_items=10, log_q=log_q,
        )
    )
    assert plain == empty


def test_train_step_mixed_negatives_converges():
    """The full train step with a mixed-negative pool runs and trains."""
    U, I, F, B = 30, 25, 5, 10
    cfg = parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=F,
        item_feature_dim=F,
    )
    rng = np.random.default_rng(6)
    packed = pack_positives(
        {u: {int(x) for x in rng.integers(0, I, 2)} for u in range(U)},
        num_users=U, num_items=I,
    )
    counts = rng.integers(1, 30, I).astype(np.float64)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (U, F)).astype(np.float32)),
        item_features=jnp.asarray(rng.normal(0, 1, (I, F)).astype(np.float32)),
        positive_rows=jnp.asarray(packed.rows),
        category_ids=None,
        item_log_q=jnp.asarray(np.log(counts / counts.sum()), jnp.float32),
    )
    tscfg = TrainStepConfig(
        num_items=I,
        loss_type="in_batch_softmax",
        mixed_negatives=8,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        opt=parse_dense_opt_config({"optimizer": "adamw", "learning_rate": 0.01}),
    )
    state = create_train_state(jax.random.key(0), cfg, num_users=U, num_items=I)
    step = make_train_step(cfg, tscfg)
    u_fixed = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p_fixed = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    losses = []
    for i in range(30):
        state, metrics = step(state, data, u_fixed, p_fixed, jax.random.key(i))
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.8

    # Eval-loss step accepts the same config.
    eval_step = make_eval_loss_step(cfg, tscfg)
    assert np.isfinite(
        float(eval_step(state, data, u_fixed, p_fixed, jax.random.key(99)))
    )
