#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU, in one process.

    python chip_smoke.py            # one card: trainer, references, serving
    python chip_smoke.py --multi    # four cards: the sharded train step only

One card, at the flagship model's full width (``configs/default.yaml``:
128-dim gated towers, MLP 256, adaptive mimic, batch 2048, 5 negatives,
category alignment over 64 categories):

- trainer: ``pipelines.run_training`` on a 200k-user x 100k-item synthetic
  corpus for one epoch, once with the BCE default and once as the
  recommended in-batch softmax + sparse mimic (``configs/in_batch_softmax
  .yaml``); finite falling loss, a full-corpus recall@10, a checkpoint and
  a serving bundle;
- references: each device kernel against ``ttamm.numpy_reference``
  (float64) at real widths, and one train step against the same step on
  the CPU backend of this process;
- serving: the HTTP service answering from the device backend, checked
  against a numpy search.

``--multi`` runs the row-sharded train step on 2x2 and 1x4 meshes (GSPMD
and owner routing) against the single-device step, the sharded top-k
against ``mips_topk``, the ragged embedding exchange against the dense
one, and a sharded checkpoint saved on 2x2 and restored on 1x4.

Every check prints its precision and tolerance. Any failure exits
non-zero. The last line of standard output is one JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 0
NUM_USERS, NUM_ITEMS = 200_000, 100_000
NUM_INTERACTIONS = 1_000_000
FEATURES = 608  # flagship host-feature width (category/author one-hots)
BATCH, NEGATIVES, DIM = 2048, 5, 128
MIPS_SIZES = ((100_000, 256), (2_000_000, 32))  # (items, queries)
ADAM_ROWS = (100_000, 2_000_000)

# configs/default.yaml as a dict; the model and training blocks are kept
# unchanged apart from num_epochs (tests/test_xla_paths.py pins this).
_TOWER = {
    "type": "tower",
    "id_embedding": {
        "params": {"embedding_dim": 128, "sparse": True},
        "init": {"type": "normal", "std": 0.02},
    },
    "feature_encoder": {
        "type": "mlp",
        "hidden_dims": [256],
        "activation": "relu",
        "output_dim": 128,
        "dropout": 0.15,
    },
    "fusion": "gated",
    "output_dim": 128,
}
MODEL = {
    "user_encoder": _TOWER,
    "item_encoder": _TOWER,
    "similarity": "cosine",
    "adaptive_mimic": {"enabled": True, "init_std": 0.02, "sparse": False},
}
TRAINING = {
    "batch_size": 2048,
    "num_epochs": 1,
    "learning_rate": 0.001,
    "weight_decay": 0.01,
    "optimizer": "adamw",
    "negatives_per_positive": 5,
    "gradient_clip_norm": None,
    "loss": "bce",
    "logq_correction": True,
    "softmax_temperature": 1.0,
    "steps_per_call": "auto",
    "packed_moments": False,
    "loss_weights": {
        "mimic_user": 0.15,
        "mimic_item": 0.15,
        "category_alignment": 0.01,
    },
    "category_alignment_max_categories": 64,
    "resume_from": None,
    "early_stopping": {
        "enabled": True,
        "metric": "recall@10",
        "mode": "max",
        "patience": 2,
        "min_delta": 0.0005,
    },
    "checkpointing": {
        "enabled": True,
        "dir": "artifacts/checkpoints",
        "save_best_only": True,
        "keep_last": True,
        "async_save": True,
        "sharded": "auto",
        "filename_template": "{experiment}_{metric}_{value:.4f}_epoch{epoch}.pt",
    },
}


def _config(work: Path, name: str, *, in_batch: bool) -> dict:
    import copy

    model = copy.deepcopy(MODEL)
    training = copy.deepcopy(TRAINING)
    if in_batch:  # configs/in_batch_softmax.yaml
        model["adaptive_mimic"]["sparse"] = True
        training["loss"] = "in_batch_softmax"
    training["checkpointing"]["dir"] = str(work / name / "checkpoints")
    out = work / name
    return {
        "experiment": {"name": name, "seed": 1234, "grid": {},
                       "benchmark_report": str(out / "benchmark.md")},
        "data": {
            "root": str(work / "corpus"),
            "books_file": "books.csv",
            "users_file": "users.csv",
            "cache_dir": str(work / "cache"),
            "use_cache": True,
            "train_fraction": 0.85,
            "test_fraction": 0.15,
            "books_limit": None,
            "interactions_limit": 2_000_000,
            "min_user_interactions": 3,
            "min_item_interactions": 6,
            "positives_cap": None,
            "feature_params": {
                "numeric_columns": ["average_rating", "price", "rating_number"],
                "category_top_k": 300,
                "author_top_k": 300,
                "user_aggregation": "mean",
            },
        },
        "model": model,
        "training": training,
        "mesh": {"data_parallel": 1, "model_parallel": 1},
        "evaluation": {
            "metrics_k": [5, 10, 20],
            "candidate_samples": 50,
            "holdout": "latest_per_user",
            "user_batch_size": 4096,
            "faiss": {
                "enabled": True,
                "search_k_multiplier": 4,
                "batch_size": 8192,
                "index_path": str(out / "serve" / "items.index"),
                "embedding_path": str(out / "serve" / "item_embeddings.npy"),
            },
        },
        "serving": {"score_dtype": "auto", "bf16_recall_gate": 0.002},
        "recommendations": {"sample_users": 2, "top_k": 5},
        "diagnostics": {
            "item_sample_size": 10,
            "user_sample_size": 100,
            "neighbor_k": 5,
            "report_path": str(out / "report.md"),
            "loss_plot_path": str(out / "loss.png"),
            "embedding_summary_path": str(out / "diag.json"),
            "feature_corr_top_k": 15,
        },
        "logging": {"level": "WARNING"},
    }


class Checks:
    """Collects pass/fail lines; any failure fails the run."""

    def __init__(self) -> None:
        self.failed: list[str] = []

    def check(self, name: str, ok: bool, detail: str) -> None:
        print(f"[{'PASS' if ok else 'FAIL'}] {name}: {detail}", flush=True)
        if not ok:
            self.failed.append(name)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def _count_compiles() -> dict:
    """Counts XLA compilations and persistent-cache hits from JAX's
    monitoring events for the rest of the process."""
    import jax

    counts = {"backend_compiles": 0, "compile_s": 0.0, "cache_hits": 0,
              "cache_misses": 0}

    def on_event(event, **kwargs):
        if event == "/jax/compilation_cache/cache_hits":
            counts["cache_hits"] += 1
        elif event == "/jax/compilation_cache/cache_misses":
            counts["cache_misses"] += 1

    def on_duration(event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            counts["backend_compiles"] += 1
            counts["compile_s"] += duration

    jax.monitoring.register_event_listener(on_event)
    jax.monitoring.register_event_duration_secs_listener(on_duration)
    return counts


def _peak_gb(device) -> str:
    stats = device.memory_stats() or {}
    return f"{stats.get('peak_bytes_in_use', 0) / 1e9:.2f} GB"


# --------------------------------------------------------------- trainer
def phase_trainer(checks: Checks, work: Path) -> Path:
    from ttamm.data.synthetic import write_synthetic_csvs
    from ttamm.pipelines import run_training

    t0 = time.perf_counter()
    write_synthetic_csvs(
        work / "corpus", num_users=NUM_USERS, num_items=NUM_ITEMS,
        num_interactions=NUM_INTERACTIONS, seed=SEED,
    )
    print(f"corpus: {NUM_USERS} users x {NUM_ITEMS} items, "
          f"{NUM_INTERACTIONS} interactions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    serve_dir = None
    for name, in_batch in (("bce", False), ("in_batch", True)):
        t0 = time.perf_counter()
        result = run_training(_config(work, name, in_batch=in_batch))
        seconds = time.perf_counter() - t0
        steps = np.asarray(result.history.step_loss)
        n = len(steps)
        head = float(steps[: max(n // 10, 1)].mean()) if n else float("nan")
        tail = float(steps[-max(n // 10, 1):].mean()) if n else float("nan")
        recall = None
        if result.val_metrics is not None:
            recall = result.val_metrics.recall.get(10)
        ckpts = list((work / name / "checkpoints").glob("*"))
        bundle = work / name / "serve"
        print(f"trainer[{name}]: {n} steps in {seconds:.1f} s "
              f"({result.examples_per_second or 0:.0f} examples/s incl. "
              f"compile), loss first 10% {head:.4f} -> last 10% {tail:.4f}, "
              f"val recall@10={recall}", flush=True)
        checks.check(
            f"trainer[{name}] loss", n >= 100 and bool(np.all(np.isfinite(steps)))
            and tail < head,
            f"{n} steps, all finite, mean of last 10% < mean of first 10%",
        )
        checks.check(
            f"trainer[{name}] recall@10", recall is not None and 0.0 < recall <= 1.0,
            f"full-corpus eval recall@10={recall}",
        )
        checks.check(
            f"trainer[{name}] artifacts",
            bool(ckpts) and all(
                (bundle / f).exists()
                for f in ("items.index", "user_embeddings.npy", "vocab.json")
            ),
            f"checkpoint {[c.name for c in ckpts]}, bundle in {bundle.name}/",
        )
        serve_dir = bundle
    return serve_dir


# ------------------------------------------------------------- references
def phase_mips(checks: Checks, rng: np.random.Generator) -> None:
    import jax
    import jax.numpy as jnp

    from ttamm.numpy_reference import mips_scores, topk_mismatches
    from ttamm.ops.topk import mips_topk

    k, tol = 20, 1e-5
    for n_items, n_queries in MIPS_SIZES:
        items = rng.normal(0, 1, (n_items, DIM)).astype(np.float32)
        items /= np.linalg.norm(items, axis=1, keepdims=True)
        queries = rng.normal(0, 1, (n_queries, DIM)).astype(np.float32)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
        mask = rng.integers(0, n_items, (n_queries, 40)).astype(np.int32)
        mask[:, 30:] = n_items  # padding ids
        items_d, queries_d, mask_d = map(jnp.asarray, (items, queries, mask))
        for masked in (False, True):
            ref = mips_scores(queries, items, mask if masked else None)
            for algorithm in ("group_exact", "chunked"):
                fn = jax.jit(lambda q, x, m, a=algorithm: mips_topk(
                    q, x, k=k, algorithm=a, mask_rows=m))
                t0 = time.perf_counter()
                _, idx = jax.block_until_ready(
                    fn(queries_d, items_d, mask_d if masked else None))
                first = time.perf_counter() - t0
                bad = topk_mismatches(np.asarray(idx), ref, k, tol)
                checks.check(
                    f"mips_topk fp32 {algorithm} N={n_items} "
                    f"{'masked' if masked else 'unmasked'}",
                    bad == 0,
                    f"{bad}/{n_queries} queries differ from the float64 "
                    f"brute force beyond score ties of {tol} (fp32 HIGHEST; "
                    f"first call {first:.2f} s)",
                )
        if n_items == MIPS_SIZES[0][0]:
            _, i32 = mips_topk(queries_d, items_d, k=k)
            _, i16 = mips_topk(queries_d, items_d, k=k, score_dtype="bfloat16")
            overlap = np.mean([
                len(set(a) & set(b)) / k
                for a, b in zip(np.asarray(i32), np.asarray(i16))
            ])
            checks.check(
                f"mips_topk bf16 overlap N={n_items}", overlap >= 0.9,
                f"mean top-{k} overlap with fp32 {overlap:.4f} >= 0.9 (bf16 "
                "scores keep ~3 significant digits; only near-ties swap)",
            )


def phase_category_alignment(checks: Checks, rng: np.random.Generator) -> None:
    import jax
    import jax.numpy as jnp

    from ttamm.numpy_reference import category_alignment_reference
    from ttamm.ops.losses import category_alignment_loss

    n, c = BATCH * (1 + NEGATIVES), 64
    cats = np.minimum(rng.zipf(1.5, n) - 1, 80).astype(np.int32)
    x = rng.normal(0, 0.3, (n, DIM)).astype(np.float32)
    ref_loss, ref_grad = category_alignment_reference(cats, x, c)
    fn = jax.jit(jax.value_and_grad(
        lambda e: category_alignment_loss(jnp.asarray(cats), e, max_categories=c)))
    for precision in ("default", "highest"):
        with jax.default_matmul_precision(precision):
            loss, grad = jax.block_until_ready(fn(jnp.asarray(x)))
        rel = abs(float(loss) - ref_loss) / abs(ref_loss)
        gerr = float(np.max(np.abs(np.asarray(grad) - ref_grad))
                     / np.max(np.abs(ref_grad)))
        tol = 1e-2 if precision == "default" else 1e-4
        checks.check(
            f"category_alignment_loss {precision} precision",
            rel <= tol and gerr <= tol,
            f"[{n}, {DIM}] C={c}: loss rel err {rel:.2e}, grad max err / "
            f"max |grad| {gerr:.2e}, tol {tol:g} (default = TF32 matmuls "
            "on the GPU, ~1e-3 relative per product)",
        )


def phase_sparse_adam(checks: Checks, rng: np.random.Generator) -> None:
    import jax
    import jax.numpy as jnp

    from ttamm.numpy_reference import sparse_adam_reference
    from ttamm.ops.sparse_adam import SparseAdamState, sparse_adam_update

    lanes, lr, step = BATCH * (1 + NEGATIVES), 1e-3, 4
    for rows in ADAM_ROWS:
        table = rng.normal(0, 0.02, (rows, DIM)).astype(np.float32)
        m = rng.normal(0, 1e-3, (rows, DIM)).astype(np.float32)
        v = rng.uniform(0, 1e-6, (rows, DIM)).astype(np.float32)
        pool = rng.choice(rows, min(1500, rows // 4), replace=False)
        idx = pool[rng.zipf(1.3, lanes) % pool.size].astype(np.int32)
        grads = rng.normal(0, 1e-2, (lanes, DIM)).astype(np.float32)
        state = SparseAdamState(jnp.asarray(m), jnp.asarray(v),
                                jnp.asarray(step, jnp.int32))
        fn = jax.jit(lambda t, s, i, g: sparse_adam_update(t, s, i, g, lr=lr))
        new_t, new_s = jax.block_until_ready(
            fn(jnp.asarray(table), state, jnp.asarray(idx), jnp.asarray(grads)))
        touched, w_ref, m_ref, v_ref = sparse_adam_reference(
            table, m, v, step, idx, grads, lr=lr)
        got_t, got_m, got_v = map(np.asarray, (new_t, new_s.m, new_s.v))
        untouched = np.ones(rows, bool)
        untouched[touched] = False
        # A Zipf-hot id collects thousands of the 12,288 lanes. Their fp32
        # sum g differs from the float64 one by ~1e-5 relative, which m =
        # 0.1 g and v = 1e-3 g^2 inherit (v's error is ~2e-3 |g| x 1e-5 <=
        # 5e-9 on the hottest row). Each figure below is the worst |err| /
        # (atol + rtol |ref|); two H100 runs read at most 0.30 / 0.33 / 0.31.
        worst = {
            name: float(np.max(np.abs(got - ref) / (atol + rtol * np.abs(ref))))
            for name, got, ref, atol, rtol in (
                ("weights", got_t[touched], w_ref, 3e-4 * lr, 0.0),
                ("m", got_m[touched], m_ref, 1e-6, 0.0),
                ("v", got_v[touched], v_ref, 1e-8, 1e-5),
            )
        }
        ok = (
            max(worst.values()) <= 1.0
            and np.array_equal(got_t[untouched], table[untouched])
            and np.array_equal(got_m[untouched], m[untouched])
            and np.array_equal(got_v[untouched], v[untouched])
            and int(new_s.step) == step + 1
        )
        checks.check(
            f"sparse_adam_update rows={rows}", ok,
            f"{lanes} lanes over {touched.size} distinct rows vs float64: "
            f"|err| / bound: weights {worst['weights']:.2f} (bound 3e-4 lr), "
            f"m {worst['m']:.2f} (1e-6), v {worst['v']:.2f} (1e-8 + 1e-5 "
            "|v|), all <= 1 (fp32 duplicate sums); untouched rows "
            "bit-identical",
        )


def _leaves(tree) -> dict[str, np.ndarray]:
    import jax

    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): np.asarray(x, np.float64) for p, x in flat}


def _weights_and_moments(state):
    """The weight leaves, each weight's Adam first moment under the same
    key, and every optimizer moment leaf."""
    weights = {"dense": state.dense, "tables": state.tables}
    first = {"dense": state.opt_dense.m["dense"], "tables": {
        n: state.opt_sparse[n].m if n in state.opt_sparse
        else state.opt_dense.m["tables"][n]
        for n in state.tables}}
    moments = {"dense_m": state.opt_dense.m, "dense_v": state.opt_dense.v,
               "sparse_m": {n: s.m for n, s in state.opt_sparse.items()},
               "sparse_v": {n: s.v for n, s in state.opt_sparse.items()}}
    return _leaves(weights), _leaves(first), _leaves(moments)


# Tolerances of one flagship train step on the GPU against the same step on
# the CPU. Training matmuls run at default precision, i.e. TF32 on the GPU.
# Each is set from three H100 runs with ~3x headroom or more (PERF.md):
# loss at most 6.0e-6, worst moment leaf 3.0e-2 (first-layer weight
# gradients), worst weight element 0.55 of the bound below with a
# weight_atol of 1e-4.
STEP_LOSS_RTOL = 1e-4
STEP_MOMENT_RTOL = 1e-1  # per leaf: max |diff| / max |cpu moment|
STEP_WEIGHT_ATOL_LR = 2e-4  # per element, in units of lr (see below)
ADAM_EPS = 1e-8


def compare_train_steps(old, gpu, cpu, lr: float, *,
                        moment_rtol: float = STEP_MOMENT_RTOL,
                        weight_atol: float = STEP_WEIGHT_ATOL_LR) -> dict:
    """Compare one first Adam step taken from ``old`` on two backends.

    Moments: every leaf of the dense and sparse optimizer state within
    ``moment_rtol`` of its largest CPU value.

    Weights: Adam's first step moves an element by u(g) = lr g / (|g| +
    eps) plus the shared decay, with g = 10 m (m starts at 0). With e the
    leaf's largest gradient error, an element whose CPU gradient lies
    within 2e of zero (and is not zero on both) may change sign: its
    updates may differ by up to 2 lr. Every other element's update must
    agree within lr (weight_atol + eps e / (|g| - e + eps)^2), the
    sensitivity of u to an error e in g: near |g| ~ eps a small relative
    gradient error moves the update visibly. Elements with no gradient on
    either backend get weight_atol alone. Returns the worst leaf of each
    rule and whether all leaves pass.
    """
    w_old, _, _ = _weights_and_moments(old)
    w_gpu, m1_gpu, mom_gpu = _weights_and_moments(gpu)
    w_cpu, m1_cpu, mom_cpu = _weights_and_moments(cpu)
    out = {"moment_ratio": (0.0, ""), "weight_ratio": (0.0, ""),
           "flip_err": (0.0, ""), "flips": 0, "elements": 0, "ok": True}
    for key, c in mom_cpu.items():
        err = float(np.max(np.abs(mom_gpu[key] - c), initial=0.0))
        scale = float(np.max(np.abs(c), initial=0.0))
        ratio = err / scale if scale else (0.0 if err == 0 else np.inf)
        out["ok"] &= ratio <= moment_rtol
        out["moment_ratio"] = max(out["moment_ratio"], (ratio, key))
    for key, old_w in w_old.items():
        d = np.abs((w_gpu[key] - old_w) - (w_cpu[key] - old_w)) / lr
        g_gpu, g_cpu = 10.0 * m1_gpu[key], 10.0 * m1_cpu[key]
        e = float(np.max(np.abs(g_gpu - g_cpu), initial=0.0))
        g = np.abs(g_cpu)
        zero = (g_cpu == 0) & (g_gpu == 0)  # untouched rows, dead units
        flip = (g <= 2.0 * e) & ~zero
        sensitivity = ADAM_EPS * e / (np.maximum(g - e, 0.0) + ADAM_EPS) ** 2
        bound = weight_atol + np.where(zero, 0.0, sensitivity)
        ratio = float(np.max((d / bound)[~flip], initial=0.0))
        flipped = float(np.max(d[flip], initial=0.0))
        out["ok"] &= ratio <= 1.0 and flipped <= 2.0 + weight_atol
        out["weight_ratio"] = max(out["weight_ratio"], (ratio, key))
        out["flip_err"] = max(out["flip_err"], (flipped, key))
        out["flips"] += int(np.count_nonzero(d[flip] > weight_atol))
        out["elements"] += d.size
    return out


def step_inputs(rng: np.random.Generator, *, users: int, items: int,
                batch: int, features: int):
    """Config, fresh state and one batch of the flagship BCE step."""
    import jax
    import jax.numpy as jnp

    from ttamm.models import parse_model_config
    from ttamm.train import TrainStepConfig, create_train_state
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData

    cfg = parse_model_config(MODEL, user_feature_dim=features,
                             item_feature_dim=features)
    tscfg = TrainStepConfig(
        num_items=items, negatives_per_positive=NEGATIVES,
        lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=64,
        opt=parse_dense_opt_config({
            "optimizer": "adamw", "learning_rate": TRAINING["learning_rate"],
            "weight_decay": TRAINING["weight_decay"]}),
    )
    state = create_train_state(jax.random.key(SEED), cfg, num_users=users,
                               num_items=items)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (users, features)),
                                  jnp.float32),
        item_features=jnp.asarray(rng.normal(0, 1, (items, features)),
                                  jnp.float32),
        positive_rows=jnp.asarray(rng.integers(0, items, (users, 8)), jnp.int32),
        category_ids=jnp.asarray(rng.integers(0, 64, items), jnp.int32),
    )
    u = jnp.asarray(rng.integers(0, users, batch), jnp.int32)
    p = jnp.asarray(rng.integers(0, items, batch), jnp.int32)
    return cfg, tscfg, (state, data, u, p, jax.random.key(1))


def phase_step_vs_cpu(checks: Checks, rng: np.random.Generator) -> None:
    import jax

    from ttamm.train import make_train_step

    cpu, gpu = jax.devices("cpu")[0], jax.devices()[0]
    lr = TRAINING["learning_rate"]
    with jax.default_device(cpu):
        cfg, tscfg, args = step_inputs(rng, users=NUM_USERS, items=NUM_ITEMS,
                                       batch=BATCH, features=FEATURES)
    step = make_train_step(cfg, tscfg)
    results = []
    for dev in (gpu, cpu):
        t0 = time.perf_counter()
        new_state, metrics = jax.block_until_ready(
            step(*jax.device_put(args, dev)))
        results.append((jax.device_get(new_state), float(metrics["loss"])))
        print(f"train step on {dev.platform}: first call "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    (g_state, g_loss), (c_state, c_loss) = results
    rel = abs(g_loss - c_loss) / abs(c_loss)
    checks.check(
        "train step gpu vs cpu: loss", rel <= STEP_LOSS_RTOL,
        f"{g_loss:.6f} vs {c_loss:.6f}, rel {rel:.2e} <= {STEP_LOSS_RTOL:g} "
        "(training matmuls run in TF32 on the GPU)",
    )
    r = compare_train_steps(jax.device_get(args[0]), g_state, c_state, lr)
    checks.check(
        "train step gpu vs cpu: state", r["ok"],
        f"{r['elements']} weights and every optimizer moment after one AdamW "
        f"+ sparse Adam step. Moments: worst leaf {r['moment_ratio'][1]} "
        f"max |diff| / max |cpu| {r['moment_ratio'][0]:.2e} <= "
        f"{STEP_MOMENT_RTOL:g} (TF32 gradients). Weight updates: worst "
        f"|diff| / bound {r['weight_ratio'][0]:.2f} <= 1 in "
        f"{r['weight_ratio'][1]} (bound: lr ({STEP_WEIGHT_ATOL_LR:g} + Adam's "
        "sensitivity eps e / (|g| - e + eps)^2 to the leaf's gradient error "
        f"e)); {r['flips']} elements whose cpu gradient is within 2e of 0 "
        f"differ by up to {r['flip_err'][0]:.2f} lr <= 2 lr (Adam's first "
        "step is ~lr*sign(g))",
    )


# ---------------------------------------------------------------- serving
def phase_serving(checks: Checks, serve_dir: Path) -> None:
    import dataclasses
    import urllib.request

    from ttamm.numpy_reference import mips_scores, topk_mismatches
    from ttamm.serve import FlatIndex, RetrievalService, start_in_thread

    bundle = RetrievalService.from_artifacts(serve_dir)
    # Serve the exact fp32 index (the export may have chosen bf16 scoring).
    service = dataclasses.replace(bundle, index=FlatIndex(
        bundle.index.embeddings, normalized=bundle.index.normalized))
    server, thread = start_in_thread(service, port=0, backend="auto")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    k = 10
    users = service.user_ids[:: max(len(service.user_ids) // 8, 1)][:8]
    try:
        got, t0 = [], time.perf_counter()
        for i, uid in enumerate(users):
            if i % 2:
                req = urllib.request.Request(
                    f"{base}/v1/recommend",
                    data=json.dumps({"user_id": uid, "k": k}).encode(),
                    headers={"Content-Type": "application/json"},
                )
            else:
                req = f"{base}/v1/recommend?user_id={uid}&k={k}"
            with urllib.request.urlopen(req, timeout=120) as resp:
                got.append(json.loads(resp.read())["items"])
        seconds = time.perf_counter() - t0
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    asin_to_idx = {a: i for i, a in enumerate(service.item_ids)}
    got_idx = np.asarray([[asin_to_idx[r["asin"]] for r in items] for items in got])
    queries = service.user_embeddings[[service.user_to_idx[u] for u in users]]
    if service.index.normalized:
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    ref = mips_scores(queries, service.index.embeddings)
    bad = topk_mismatches(got_idx, ref, k, 1e-5)
    on_device = getattr(service.index, "_device_emb", None) is not None
    checks.check(
        "serving over HTTP", on_device and bad == 0 and not thread.is_alive(),
        f"{len(users)} GET/POST /v1/recommend answered by the device backend "
        f"in {seconds:.2f} s; {bad} differ from the numpy float64 search "
        "beyond score ties of 1e-5",
    )


# ------------------------------------------------------------- four cards
def phase_multi(checks: Checks, rng: np.random.Generator) -> None:
    import jax
    import jax.numpy as jnp

    from ttamm.models import parse_model_config
    from ttamm.ops.topk import mips_topk
    from ttamm.parallel import (
        MeshConfig, build_mesh, make_sharded_train_step, pad_batch_data,
        pad_state_rows, place_data, place_state, sharded_mips_topk,
    )
    from ttamm.parallel.exchange import padded_exchange_lookup
    from ttamm.train import (
        TrainStepConfig, create_train_state, load_sharded_checkpoint,
        make_train_step, save_sharded_checkpoint,
    )
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData

    devices = jax.devices()
    checks.check("four cards", len(devices) == 4, f"{len(devices)} devices")
    if len(devices) != 4:
        return
    cfg = parse_model_config(MODEL, user_feature_dim=FEATURES,
                             item_feature_dim=FEATURES)
    lr = TRAINING["learning_rate"]
    tscfg = TrainStepConfig(
        num_items=NUM_ITEMS, negatives_per_positive=NEGATIVES,
        lambda_mimic_user=0.15, lambda_mimic_item=0.15,
        lambda_category_alignment=0.01, cal_max_categories=64,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": lr, "weight_decay": 0.01}),
    )
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (NUM_USERS, FEATURES)), jnp.float32),
        item_features=jnp.asarray(rng.normal(0, 1, (NUM_ITEMS, FEATURES)), jnp.float32),
        positive_rows=jnp.asarray(rng.integers(0, NUM_ITEMS, (NUM_USERS, 8)), jnp.int32),
        category_ids=jnp.asarray(rng.integers(0, 64, NUM_ITEMS), jnp.int32),
    )
    batches = [
        (jnp.asarray(rng.integers(0, NUM_USERS, BATCH), jnp.int32),
         jnp.asarray(rng.integers(0, NUM_ITEMS, BATCH), jnp.int32),
         jax.random.key(10 + i))
        for i in range(2)
    ]

    def fresh():
        return create_train_state(jax.random.key(SEED), cfg,
                                  num_users=NUM_USERS, num_items=NUM_ITEMS)

    # Every comparison here runs its matmuls at HIGHEST precision, so the
    # sharded and single-device steps differ only by summation order.
    with jax.default_matmul_precision("highest"):
        ref_state, ref_losses = fresh(), []
        single = make_train_step(cfg, tscfg)
        for u, p, key in batches:
            ref_state, m = single(ref_state, data, u, p, key)
            ref_losses.append(float(m["loss"]))
        ref_tables = {n: np.asarray(t) for n, t in ref_state.tables.items()}
        del ref_state

        meshes = {"2x2": (2, 2), "1x4": (1, 4)}
        for mesh_name, (dp, mp) in meshes.items():
            mesh = build_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
            pdata = place_data(mesh, pad_batch_data(data, mp))
            for routing in ("allgather", "owner"):
                st = place_state(mesh, pad_state_rows(fresh(), mp))
                step = make_sharded_train_step(
                    cfg, tscfg._replace(update_routing=routing), mesh, st, pdata)
                losses = []
                t0 = time.perf_counter()
                for u, p, key in batches:
                    st, m = step(st, pdata, u, p, key)
                    losses.append(float(m["loss"]))
                seconds = time.perf_counter() - t0
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
                diffs = np.concatenate([
                    np.abs(np.asarray(st.tables[n])[: t.shape[0]] - t).ravel()
                    for n, t in ref_tables.items()
                ])
                worst, off = float(diffs.max()), float(np.mean(diffs > 1e-5))
                label = "GSPMD" if routing == "allgather" else "owner routing"
                checks.check(
                    f"sharded step {mesh_name} {label}",
                    rel <= 1e-4 and (worst <= 1e-5 or (
                        worst <= 2.5 * lr and off <= 1e-6)),
                    f"2 steps ({seconds:.1f} s incl. compile): loss rel diff "
                    f"{rel:.2e} <= 1e-4; tables max |diff| {worst:.2e}, "
                    f"share > 1e-5: {off:.1e} (<= 1e-5 everywhere, or <= "
                    "2.5*lr on <= 1e-6 of elements: Adam moves an element "
                    "by ~lr*sign(g), so a gradient within summation-order "
                    "noise of 0 may flip) vs the single-device step (fp32 "
                    "HIGHEST)",
                )
                del st

        mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=2))
        items = rng.normal(0, 1, (NUM_ITEMS, DIM)).astype(np.float32)
        queries = rng.normal(0, 1, (256, DIM)).astype(np.float32)
        _, idx_single = mips_topk(jnp.asarray(queries), jnp.asarray(items), k=20)
        _, idx_sharded = sharded_mips_topk(
            jnp.asarray(queries), jnp.asarray(items), k=20, mesh=mesh)
        checks.check(
            "sharded_mips_topk 2x2", np.array_equal(
                np.asarray(idx_single), np.asarray(idx_sharded)),
            f"256 queries x {NUM_ITEMS} items, k=20: identical indices to "
            "mips_topk (fp32 HIGHEST)",
        )

        # Sharded checkpoint: save on 2x2, restore on 1x4, one equal step.
        mesh_a = mesh
        mesh_b = build_mesh(MeshConfig(data_parallel=1, model_parallel=4))
        # Rows padded to a multiple of 4 on both meshes: one saved layout
        # divides both model axes.
        data_a = place_data(mesh_a, pad_batch_data(data, 4))
        data_b = place_data(mesh_b, pad_batch_data(data, 4))
        st_a = place_state(mesh_a, pad_state_rows(fresh(), 4))
        step_a = make_sharded_train_step(cfg, tscfg, mesh_a, st_a, data_a)
        u, p, key = batches[0]
        st_a, _ = step_a(st_a, data_a, u, p, key)
        with tempfile.TemporaryDirectory() as td:
            path = save_sharded_checkpoint(
                td, st_a, experiment_name="smoke", epoch=1,
                metric_name="loss", metric_value=0.0)
            template = place_state(mesh_b, pad_state_rows(fresh(), 4))
            st_b, _ = load_sharded_checkpoint(path, template)
        step_b = make_sharded_train_step(cfg, tscfg, mesh_b, st_b, data_b)
        u, p, key = batches[1]
        _, m_a = step_a(st_a, data_a, u, p, key)
        _, m_b = step_b(st_b, data_b, u, p, key)
        la, lb = float(m_a["loss"]), float(m_b["loss"])
        checks.check(
            "sharded checkpoint 2x2 -> 1x4", abs(la - lb) <= 1e-4 * abs(la),
            f"next-step loss {la:.6f} (2x2) vs {lb:.6f} (restored on 1x4), "
            "rel tol 1e-4",
        )

        table = jax.device_put(
            jnp.asarray(rng.normal(0, 1, (NUM_ITEMS, DIM)), jnp.float32),
            jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("model", None)))
        ids = jnp.asarray(rng.integers(0, NUM_ITEMS, BATCH), jnp.int32)
        dense = jax.jit(lambda t, i: padded_exchange_lookup(
            mesh, t, i, variant="dense"))(table, ids)
        ragged = jax.jit(lambda t, i: padded_exchange_lookup(
            mesh, t, i, variant="ragged"))(table, ids)
        checks.check(
            "ragged exchange 2x2", np.array_equal(np.asarray(dense), np.asarray(ragged))
            and np.array_equal(np.asarray(dense), np.asarray(table)[np.asarray(ids)]),
            f"{BATCH} row lookups: ragged all-to-all == dense exchange == take",
        )


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the four-card sharded phase")
    args = parser.parse_args()

    sys.path.insert(0, str(REPO))
    try:
        import ttamm
    except ImportError:
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    if Path(ttamm.__file__).resolve().parent.parent != REPO:
        print(f"ttamm imported from {ttamm.__file__}, not this "
              "checkout", file=sys.stderr)
        return 2

    import jax

    from ttamm.utils import enable_persistent_cache

    print(f"compile cache: {enable_persistent_cache()}", flush=True)
    compiles = _count_compiles()
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's default device is {device}",
              file=sys.stderr)
        return 1
    print(f"devices: {jax.devices()}", flush=True)
    print(f"device_kind: {device.device_kind}", flush=True)
    card = _card()
    print(f"card: {card}", flush=True)

    checks = Checks()
    rng = np.random.default_rng(SEED)
    timings = {}

    def run(name, fn, *fargs):
        t0 = time.perf_counter()
        out = fn(*fargs)
        timings[name] = time.perf_counter() - t0
        print(f"phase {name}: {timings[name]:.1f} s, peak device memory "
              f"{_peak_gb(device)} ({card})", flush=True)
        return out

    if args.multi:
        run("multi", phase_multi, checks, rng)
    else:
        with tempfile.TemporaryDirectory() as td:
            work = Path(td)
            serve_dir = run("trainer", phase_trainer, checks, work)
            run("mips", phase_mips, checks, rng)
            run("category_alignment", phase_category_alignment, checks, rng)
            run("sparse_adam", phase_sparse_adam, checks, rng)
            run("step_vs_cpu", phase_step_vs_cpu, checks, rng)
            run("serving", phase_serving, checks, serve_dir)
    print(f"compilation: {compiles['backend_compiles']} backend compiles "
          f"({compiles['compile_s']:.1f} s), persistent cache "
          f"{compiles['cache_hits']} hits / {compiles['cache_misses']} "
          f"misses; phases {json.dumps({k: round(v, 1) for k, v in timings.items()})} s "
          f"({card})", flush=True)
    if checks.failed:
        print(f"FAILED: {checks.failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device.platform,
        "kind": device.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
