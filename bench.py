#!/usr/bin/env python
"""Throughput benchmark: training examples/s/chip + top-K queries/s.

Runs the flagship configuration (128-dim gated feature towers + adaptive
mimic + category alignment, AdamW + sparse-row Adam, batch 2048, 5
negatives) on a synthetic Amazon-books-scale workload and prints ONE JSON
line.

Baseline for ``vs_baseline``: the reference publishes no throughput — only
996 s wall-clock for 7 epochs at a 2,000,000-interaction cap on CPU
(BASELINE.md). 7 * 2e6 / 996 = 14,056 examples/s is an *upper bound* on the
reference's CPU throughput (pruning only shrinks its epochs), so
``vs_baseline = ours / 14056`` is conservative in the reference's favor.

Env overrides: BENCH_USERS, BENCH_ITEMS, BENCH_FEATURES, BENCH_BATCH,
BENCH_STEPS, BENCH_DIM, BENCH_QUERY_BATCHES.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

REFERENCE_EXAMPLES_PER_S = 7 * 2_000_000 / 996.0

# Published peaks per device kind, the denominators of every *_util field.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM part, dense rates
# without sparsity; 700 W power limit). A device kind not listed here is an
# error: a utilization against a guessed peak would be no measurement.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "bf16_flops_per_s": 989e12,
        "tf32_flops_per_s": 495e12,
        "fp32_flops_per_s": 67e12,
    },
}


def device_peaks(device_kind: str) -> dict[str, float]:
    """Published peaks of ``device_kind``; raises on a kind not in PEAKS."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet numbers to bench.PEAKS"
        ) from None


def main() -> None:
    import jax

    from ttamm.utils import enable_persistent_cache

    enable_persistent_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        raise SystemExit(
            f"bench.py measures the GPU; JAX's default device is {device}"
        )
    peaks = device_peaks(device.device_kind)

    import jax.numpy as jnp

    from __graft_entry__ import _model_cfg_dict
    from ttamm.models import parse_model_config
    from ttamm.ops.topk import mips_topk
    from ttamm.parallel import (
        MeshConfig,
        build_mesh,
        make_sharded_train_step,
        place_data,
        place_state,
    )
    from ttamm.train import TrainStepConfig, create_train_state, encode_corpus
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData

    num_users = int(os.environ.get("BENCH_USERS", 200_000))
    num_items = int(os.environ.get("BENCH_ITEMS", 100_000))
    feat = int(os.environ.get("BENCH_FEATURES", 608))
    batch = int(os.environ.get("BENCH_BATCH", 2048))
    steps = int(os.environ.get("BENCH_STEPS", 400))
    dim = int(os.environ.get("BENCH_DIM", 128))
    # Many query batches per timed call, so per-dispatch host latency stays
    # a small share of the timed window.
    query_batches = int(os.environ.get("BENCH_QUERY_BATCHES", 200))
    neg = 5

    n_devices = len(jax.devices())
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=1))

    # BENCH_MIMIC_SPARSE=1 routes the mimic tables through sparse-row Adam
    # (`adaptive_mimic.sparse`) instead of the reference-parity dense AdamW.
    mimic_sparse = os.environ.get("BENCH_MIMIC_SPARSE", "0") == "1"
    cfg_dict = _model_cfg_dict(dim)
    if mimic_sparse:
        cfg_dict["adaptive_mimic"]["sparse"] = True
    cfg = parse_model_config(
        cfg_dict, user_feature_dim=feat, item_feature_dim=feat
    )
    state = create_train_state(
        jax.random.key(0), cfg, num_users=num_users, num_items=num_items
    )

    rng = np.random.default_rng(0)
    pos_width = 8
    positive_rows = rng.integers(
        0, num_items, (num_users, pos_width), dtype=np.int32
    )
    data = BatchData(
        user_features=jnp.asarray(
            rng.normal(0, 1, (num_users, feat)).astype(np.float32)
        ),
        item_features=jnp.asarray(
            rng.normal(0, 1, (num_items, feat)).astype(np.float32)
        ),
        positive_rows=jnp.asarray(positive_rows),
        category_ids=jnp.asarray(
            rng.integers(0, 64, num_items).astype(np.int32)
        ),
    )
    tscfg = TrainStepConfig(
        num_items=num_items,
        negatives_per_positive=neg,
        lambda_mimic_user=0.15,
        lambda_mimic_item=0.15,
        lambda_category_alignment=0.01,
        cal_max_categories=64,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}
        ),
    )

    # ---- utilization denominators -----------------------------------------
    # Achieved fraction of the device's published HBM bandwidth (PEAKS);
    # the traffic models below are re-derived at the current shapes.
    HBM_BW = peaks["hbm_bytes_per_s"]

    from ttamm.train.state import dense_table_names, sparse_table_names

    def _train_hbm_model_bytes() -> float:
        """Modeled dominant HBM bytes of one BCE train step.

        - dense AdamW: ~7 passes over the dense target (w/m/v read+write
          + grad) — params AND dense-updated aug tables;
        - sparse-row traffic: per touched lane, 2 moment gathers + 3
          scatters + 2 forward gathers (id+aug rows), dim*4 B each;
        - feature gathers: user + (1+neg) item feature rows.
        Sort costs are NOT bytes and are excluded, so the utilization
        reads as a fraction of the pure-bandwidth floor.
        """
        dense_param_bytes = sum(
            np.prod(np.shape(x)) * 4 for x in jax.tree.leaves(state.dense)
        )
        dense_tbl_bytes = sum(
            np.prod(np.shape(state.tables[n])) * 4
            for n in dense_table_names(cfg)
        )
        lanes = batch + batch * (1 + neg)  # user + item touched lanes
        n_sparse = max(len(sparse_table_names(cfg)) // 2, 1)
        rows_bytes = lanes * dim * 4 * (2 + 3 + 2) * n_sparse
        feat_bytes = (batch + batch * (1 + neg)) * feat * 4
        return 7.0 * (dense_param_bytes + dense_tbl_bytes) + rows_bytes + feat_bytes

    state = place_state(mesh, state)
    data = place_data(mesh, data)
    from ttamm.train import make_train_step

    step_jit = make_train_step(cfg, tscfg)
    raw_step = step_jit.__wrapped__  # un-jitted step for device-side scan

    u_all = jnp.asarray(rng.integers(0, num_users, (steps, batch)).astype(np.int32))
    p_all = jnp.asarray(rng.integers(0, num_items, (steps, batch)).astype(np.int32))

    @jax.jit
    def run_steps(state, data, u_all, p_all, key):
        """Device-side training loop: host dispatch cost excluded.

        Returns (state, losses, probe); the probe is one tiny array that
        depends on the final state, so waiting on it waits for the loop.
        """

        def body(st, xs):
            u, p, i = xs
            st, m = raw_step(st, data, u, p, jax.random.fold_in(key, i))
            return st, m["loss"]

        st, losses = jax.lax.scan(
            body, state, (u_all, p_all, jnp.arange(steps, dtype=jnp.int32))
        )
        probe = (
            losses[-1]
            + st.tables["user_id"][0, 0]
            + st.tables["user_aug"][0, 0]
            + st.opt_dense.step.astype(jnp.float32)
            + st.step.astype(jnp.float32)
        )
        return st, losses, probe

    def _sync(*arrays):
        return jax.block_until_ready(arrays)

    # Warmup / compile, then best-of-3.
    state2, losses, probe = run_steps(state, data, u_all, p_all, jax.random.key(0))
    _sync(probe)
    train_seconds = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        state2, losses, probe = run_steps(
            state, data, u_all, p_all, jax.random.key(rep + 1)
        )
        _sync(probe)
        train_seconds = min(train_seconds, time.perf_counter() - t0)
    state = state2
    examples_per_s = steps * batch / train_seconds
    step_model_bytes = _train_hbm_model_bytes()
    train_hbm_gbps = step_model_bytes * steps / train_seconds / 1e9
    train_hbm_util = train_hbm_gbps * 1e9 / HBM_BW

    # In-batch softmax training: the `training.loss: in_batch_softmax`
    # option with its default logQ correction, which skips negative
    # sampling and the 5x negative item-tower rows. Timed on the same
    # shapes; the log-frequency table content is irrelevant to throughput.
    tscfg_ib = tscfg._replace(loss_type="in_batch_softmax")
    data_ib = data._replace(
        item_log_q=jnp.full((num_items,), -np.log(num_items), jnp.float32)
    )
    raw_ib = make_train_step(cfg, tscfg_ib).__wrapped__

    @jax.jit
    def run_steps_ib(state, data, u_all, p_all, key):
        def body(st, xs):
            u, p, i = xs
            st, m = raw_ib(st, data, u, p, jax.random.fold_in(key, i))
            return st, m["loss"]

        st, losses = jax.lax.scan(
            body, state, (u_all, p_all, jnp.arange(steps, dtype=jnp.int32))
        )
        probe = (
            losses[-1]
            + st.tables["user_id"][0, 0]
            + st.step.astype(jnp.float32)
        )
        return st, losses, probe

    _, _, probe_ib = run_steps_ib(state, data_ib, u_all, p_all, jax.random.key(0))
    _sync(probe_ib)
    ib_seconds = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        _, _, probe_ib = run_steps_ib(
            state, data_ib, u_all, p_all, jax.random.key(rep + 1)
        )
        _sync(probe_ib)
        ib_seconds = min(ib_seconds, time.perf_counter() - t0)
    in_batch_examples_per_s = steps * batch / ib_seconds

    # The RECOMMENDED config (configs/in_batch_softmax.yaml): in-batch
    # loss + sparse-row Adam on the mimic tables, which removes the
    # O(rows) dense mimic AdamW.
    cfg_dict_s = _model_cfg_dict(dim)
    cfg_dict_s["adaptive_mimic"]["sparse"] = True
    cfg_s = parse_model_config(
        cfg_dict_s, user_feature_dim=feat, item_feature_dim=feat
    )
    state_sm = create_train_state(
        jax.random.key(0), cfg_s, num_users=num_users, num_items=num_items
    )
    raw_ibs = make_train_step(cfg_s, tscfg_ib).__wrapped__

    @jax.jit
    def run_steps_ibs(state, data, u_all, p_all, key):
        def body(st, xs):
            u, p, i = xs
            st, m = raw_ibs(st, data, u, p, jax.random.fold_in(key, i))
            return st, m["loss"]

        st, losses = jax.lax.scan(
            body, state, (u_all, p_all, jnp.arange(steps, dtype=jnp.int32))
        )
        probe = (
            losses[-1]
            + st.tables["user_id"][0, 0]
            + st.step.astype(jnp.float32)
        )
        return st, losses, probe

    _, _, probe_ibs = run_steps_ibs(
        state_sm, data_ib, u_all, p_all, jax.random.key(0)
    )
    _sync(probe_ibs)
    ibs_seconds = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        _, _, probe_ibs = run_steps_ibs(
            state_sm, data_ib, u_all, p_all, jax.random.key(rep + 1)
        )
        _sync(probe_ibs)
        ibs_seconds = min(ibs_seconds, time.perf_counter() - t0)
    del state_sm
    recommended_examples_per_s = steps * batch / ibs_seconds

    # Top-K queries/s: encode corpus once, then timed top-20 sweeps.
    item_emb = encode_corpus(state, data, cfg, "item", num_rows=num_items)
    item_emb = item_emb / jnp.maximum(
        jnp.linalg.norm(item_emb, axis=-1, keepdims=True), 1e-12
    )
    qbatch = 1024
    queries_all = jnp.asarray(
        rng.normal(0, 1, (query_batches, qbatch, dim)).astype(np.float32)
    )

    def make_run_queries(score_dtype):
        @jax.jit
        def run_queries(queries_all, item_emb):
            """Device-side query loop; iterations chained to prevent overlap."""

            def body(carry, q):
                q = q + 0.0 * carry  # serialize on previous result
                s, idx = mips_topk(
                    q, item_emb, k=20, normalize_queries=True,
                    score_dtype=score_dtype,
                )
                return s[:, :1], idx

            return jax.lax.scan(
                body, jnp.zeros((qbatch, 1), jnp.float32), queries_all
            )

        return run_queries

    def time_queries(run_queries):
        _, idx = run_queries(queries_all, item_emb)
        _sync(idx[:, :1, :1])
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _, idx = run_queries(queries_all, item_emb)
            _sync(idx[:, :1, :1])
            best = min(best, time.perf_counter() - t0)
        return query_batches * qbatch / best

    queries_per_s = time_queries(make_run_queries("float32"))
    queries_per_s_bf16 = time_queries(make_run_queries("bfloat16"))

    def _slab_util(qps: float, itemsize: int) -> float:
        # Slab-algorithm bound: the [q, N] score slab is written by the
        # matmul and re-read by the group-max reduce — 2 x N x itemsize
        # bytes per query at HBM bandwidth.
        return qps * 2 * num_items * itemsize / HBM_BW

    # Corpus-scale extra: the train step at the reference's full 2M-item
    # table scale, sparse-mimic mode (the at-scale optimizer choice —
    # dense mimic AdamW is inherently O(rows)). BENCH_SCALE_ITEMS=0
    # disables.
    scale_items = int(os.environ.get("BENCH_SCALE_ITEMS", 2_000_000))
    scale_extra = {}
    if scale_items > num_items:
        del state, state2, data, data_ib, item_emb, queries_all, losses, probe
        del probe_ib
        scale_feat = 105  # flagship corpus feature width (make_corpus.py)
        scale_steps = int(os.environ.get("BENCH_SCALE_STEPS", 100))
        cfg_dict2 = _model_cfg_dict(dim)
        cfg_dict2["adaptive_mimic"]["sparse"] = True
        cfg2 = parse_model_config(
            cfg_dict2, user_feature_dim=scale_feat, item_feature_dim=scale_feat
        )
        tscfg2 = tscfg._replace(num_items=scale_items)
        state_s = create_train_state(
            jax.random.key(0), cfg2, num_users=num_users, num_items=scale_items
        )
        data_s = BatchData(
            user_features=jnp.asarray(
                rng.normal(0, 1, (num_users, scale_feat)).astype(np.float32)
            ),
            item_features=jnp.asarray(
                rng.normal(0, 1, (scale_items, scale_feat)).astype(np.float32)
            ),
            positive_rows=jnp.asarray(
                rng.integers(0, scale_items, (num_users, 8), dtype=np.int32)
            ),
            category_ids=jnp.asarray(
                rng.integers(0, 64, scale_items).astype(np.int32)
            ),
        )
        raw2 = make_train_step(cfg2, tscfg2).__wrapped__
        u2 = jnp.asarray(
            rng.integers(0, num_users, (scale_steps, batch)).astype(np.int32)
        )
        p2 = jnp.asarray(
            rng.integers(0, scale_items, (scale_steps, batch)).astype(np.int32)
        )

        from functools import partial

        # Donate: input+output copies of the 2M-item live state would
        # double its footprint.
        @partial(jax.jit, donate_argnums=(0,))
        def run_scale(state, data, u_all, p_all, key):
            def body(st, xs):
                u, p, i = xs
                st, m = raw2(st, data, u, p, jax.random.fold_in(key, i))
                return st, m["loss"]

            st, losses = jax.lax.scan(
                body, state,
                (u_all, p_all, jnp.arange(scale_steps, dtype=jnp.int32)),
            )
            return st, losses[-1] + st.step.astype(jnp.float32)

        state_s, probe2 = run_scale(state_s, data_s, u2, p2, jax.random.key(0))
        _sync(probe2)
        best = float("inf")
        for rep in range(3):
            t0 = time.perf_counter()
            state_s, probe2 = run_scale(
                state_s, data_s, u2, p2, jax.random.key(rep + 1)
            )
            _sync(probe2)
            best = min(best, time.perf_counter() - t0)
        scale_extra = {
            "scale_items": scale_items,
            "scale_examples_per_s": round(scale_steps * batch / best, 1),
            "scale_mimic_optimizer": "sparse_row_adam",
        }

        # Serving top-K at corpus scale.
        item_emb2 = encode_corpus(
            state_s, data_s, cfg2, "item", num_rows=scale_items
        )
        item_emb2 = item_emb2 / jnp.maximum(
            jnp.linalg.norm(item_emb2, axis=-1, keepdims=True), 1e-12
        )
        del state_s, data_s
        scale_q = jnp.asarray(
            rng.normal(0, 1, (20, qbatch, dim)).astype(np.float32)
        )

        def time_scale_queries(score_dtype):
            @jax.jit
            def run_queries(qs, emb):
                def body(carry, q):
                    q = q + 0.0 * carry
                    s, idx = mips_topk(
                        q, emb, k=20, normalize_queries=True,
                        score_dtype=score_dtype,
                    )
                    return s[:, :1], idx

                return jax.lax.scan(
                    body, jnp.zeros((qbatch, 1), jnp.float32), qs
                )

            _, idx = run_queries(scale_q, item_emb2)
            _sync(idx[:, :1, :1])
            best_q = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                _, idx = run_queries(scale_q, item_emb2)
                _sync(idx[:, :1, :1])
                best_q = min(best_q, time.perf_counter() - t0)
            return round(20 * qbatch / best_q, 1)

        scale_extra["scale_topk_queries_per_s"] = time_scale_queries("float32")
        scale_extra["scale_topk_bf16_queries_per_s"] = time_scale_queries(
            "bfloat16"
        )
        scale_extra["scale_topk_slab_util"] = round(
            scale_extra["scale_topk_queries_per_s"] * 2 * scale_items * 4
            / HBM_BW,
            3,
        )

    result = {
        "metric": "training examples/s/chip",
        "value": round(examples_per_s / max(n_devices, 1), 1),
        "unit": "examples/s/chip",
        "vs_baseline": round(examples_per_s / REFERENCE_EXAMPLES_PER_S, 2),
        "extra": {
            "topk_queries_per_s": round(queries_per_s, 1),
            "topk_bf16_queries_per_s": round(queries_per_s_bf16, 1),
            # Achieved fraction of the device's published HBM bandwidth.
            "train_hbm_util": round(train_hbm_util, 3),
            "train_hbm_model_gb_per_step": round(step_model_bytes / 1e9, 3),
            "topk_slab_util": round(_slab_util(queries_per_s, 4), 3),
            "topk_bf16_slab_util": round(_slab_util(queries_per_s_bf16, 2), 3),
            "num_users": num_users,
            "num_items": num_items,
            "batch": batch,
            "steps": steps,
            "dim": dim,
            "platform": device.platform,
            "device_kind": device.device_kind,
            "devices": n_devices,
            "mimic_optimizer": "sparse_row_adam" if mimic_sparse else "adamw",
            "in_batch_softmax_examples_per_s": round(in_batch_examples_per_s, 1),
            "recommended_config_examples_per_s": round(
                recommended_examples_per_s, 1
            ),
            **scale_extra,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
