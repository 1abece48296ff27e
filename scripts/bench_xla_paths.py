#!/usr/bin/env python
"""Time the XLA paths that replaced the hand-written kernels, on the GPU.

    python scripts/bench_xla_paths.py [--out artifacts/bench/xla_paths.json]
    python scripts/bench_xla_paths.py --split --out artifacts/bench/bce_split.json

Measures, at the flagship shapes (dim 128, batch 2048, 5 negatives):

- sparse-row Adam: one update of 12,288 lanes (duplicate-heavy ids) into
  100k- and 2M-row tables, with separate and with packed ``[rows, 2D]``
  moments (``training.packed_moments``);
- exact top-20 MIPS over 1024 normalised queries at 100k and 2M items, fp32
  and bf16, for query blocks {64, 128, 256, 512} and the budget default;
- the BCE train step at 200k users x 100k items, with the
  category-alignment loss on and off.

``--split`` runs only a profiler trace of the BCE step, with XLA's command
buffers off so each kernel is its own event, and reports device time per
HLO op and the share inside the ``category_alignment`` scope.

Each timing is the best of 3 device-side ``lax.scan`` loops whose body
depends on its carry (so XLA cannot hoist it), ending in
``block_until_ready``. Prints one JSON object; every number is labelled
with the card and its power limit.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def best_of(fn, *args, reps: int = 3) -> float:
    """Seconds of the fastest of ``reps`` calls (after a compile call)."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def sparse_adam_ms(rows: int, packed: bool = False, steps: int = 50) -> float:
    import jax
    import jax.numpy as jnp

    from ttamm.ops.sparse_adam import init_sparse_adam, sparse_adam_update

    rng = np.random.default_rng(0)
    lanes, dim = 2048 * 6, 128
    table = jnp.asarray(rng.normal(0, 0.02, (rows, dim)), jnp.float32)
    pool = rng.choice(rows, 4000, replace=False)
    idx = jnp.asarray(pool[rng.zipf(1.3, (steps, lanes)) % pool.size], jnp.int32)
    grads = jnp.asarray(rng.normal(0, 1e-2, (lanes, dim)), jnp.float32)

    @jax.jit
    def loop(table, state, idx):
        def body(carry, i):
            t, s = carry
            t, s = sparse_adam_update(t, s, i, grads, lr=1e-3)
            return (t, s), None

        return jax.lax.scan(body, (table, state), idx)[0]

    state = init_sparse_adam(table, packed=packed)
    return best_of(loop, table, state, idx) / steps * 1e3


def topk_qps(n_items: int, score_dtype: str, query_block: int | None,
             batches: int = 10) -> float:
    import jax
    import jax.numpy as jnp

    from ttamm.ops.topk import _group_exact_topk

    rng = np.random.default_rng(1)
    items = rng.normal(0, 1, (n_items, 128)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    items = jnp.asarray(items, jnp.dtype(score_dtype))
    queries = jnp.asarray(rng.normal(0, 1, (batches, 1024, 128)), jnp.float32)

    @jax.jit
    def loop(queries, items):
        def body(carry, q):
            q = (q + 0.0 * carry).astype(items.dtype)
            s, idx = _group_exact_topk(
                q, items, 20, None, n_items, query_block=query_block
            )
            return s[:, :1], idx

        return jax.lax.scan(body, jnp.zeros((1024, 1), jnp.float32), queries)

    return batches * 1024 / best_of(loop, queries, items)


def _scope_ops(hlo_text: str, scope: str) -> set[str]:
    """HLO instruction names whose metadata op_name lies inside ``scope``."""
    ops = set()
    inside = re.compile(rf"(^|[/(]){re.escape(scope)}([)/]|$)")
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*op_name=\"([^\"]*)\"", line)
        if m and inside.search(m.group(2)):
            ops.add(m.group(1))
    return ops


def _bce_loop(lambda_cal: float):
    """A jitted 50-step scan of the flagship BCE step, and its arguments."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _model_cfg_dict
    from ttamm.models import parse_model_config
    from ttamm.train import TrainStepConfig, create_train_state, make_train_step
    from ttamm.train.optim import parse_dense_opt_config
    from ttamm.train.state import BatchData

    users, items, feat, batch, steps = 200_000, 100_000, 608, 2048, 50
    rng = np.random.default_rng(2)
    cfg = parse_model_config(_model_cfg_dict(128), user_feature_dim=feat,
                             item_feature_dim=feat)
    state = create_train_state(jax.random.key(0), cfg, num_users=users,
                               num_items=items)
    data = BatchData(
        user_features=jnp.asarray(rng.normal(0, 1, (users, feat)), jnp.float32),
        item_features=jnp.asarray(rng.normal(0, 1, (items, feat)), jnp.float32),
        positive_rows=jnp.asarray(rng.integers(0, items, (users, 8)), jnp.int32),
        category_ids=jnp.asarray(rng.integers(0, 64, items), jnp.int32),
    )
    tscfg = TrainStepConfig(
        num_items=items, negatives_per_positive=5, lambda_mimic_user=0.15,
        lambda_mimic_item=0.15, lambda_category_alignment=lambda_cal,
        cal_max_categories=64,
        opt=parse_dense_opt_config(
            {"optimizer": "adamw", "learning_rate": 1e-3, "weight_decay": 0.01}),
    )
    raw = make_train_step(cfg, tscfg).__wrapped__
    u = jnp.asarray(rng.integers(0, users, (steps, batch)), jnp.int32)
    p = jnp.asarray(rng.integers(0, items, (steps, batch)), jnp.int32)

    @jax.jit
    def loop(state, u, p):
        def body(st, xs):
            st, m = raw(st, data, xs[0], xs[1], jax.random.fold_in(
                jax.random.key(0), st.step))
            return st, m["loss"]

        return jax.lax.scan(body, state, (u, p))

    return loop, (state, u, p), steps, batch


def bce_step() -> dict:
    """BCE step time with the category-alignment loss on and off."""
    out = {}
    for name, lambda_cal in (("bce", 0.01), ("bce_without_cal", 0.0)):
        loop, args, steps, batch = _bce_loop(lambda_cal)
        ms = best_of(loop, *args) / steps * 1e3
        out[f"{name}_step_ms"] = ms
        out[f"{name}_examples_per_s"] = batch / ms * 1e3
    return out


def bce_split(out_dir: Path) -> dict:
    """Device time per HLO op of the BCE step from a profiler trace, and
    the share of it inside the ``category_alignment`` scope. Run with
    command buffers off (``--split`` sets the flag): a command buffer
    replays the whole step as one graph launch, hiding its kernels."""
    import jax
    from jax.profiler import ProfileData

    loop, args, steps, _ = _bce_loop(0.01)
    step_ms = best_of(loop, *args) / steps * 1e3
    cal_ops = _scope_ops(loop.lower(*args).compile().as_text(),
                         "category_alignment")
    trace_dir = out_dir / "trace_bce"
    with jax.profiler.trace(str(trace_dir)):
        jax.block_until_ready(loop(*args))
    path = sorted(glob.glob(str(trace_dir / "plugins/profile/*/*.xplane.pb")))[-1]
    # Kernel events on the device's stream lines; each carries its HLO op
    # in the "hlo_op" stat.
    total = cal = 0.0
    per_op: dict[str, float] = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                op = dict(ev.stats).get("hlo_op", ev.name)
                total += ev.duration_ns
                per_op[op] = per_op.get(op, 0.0) + ev.duration_ns
                if op in cal_ops:
                    cal += ev.duration_ns
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:20]
    device_ms = total / steps / 1e6
    return {
        "split_bce_step_ms": step_ms,
        "split_device_ms_per_step": device_ms,
        "split_device_busy_share": device_ms / step_ms,
        "category_alignment_ms_per_step": cal / steps / 1e6,
        "category_alignment_share": cal / total if total else None,
        "category_alignment_hlo_ops": len(cal_ops),
        "top_ops_ms_per_step": {k: v / steps / 1e6 for k, v in top},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="artifacts/bench/xla_paths.json")
    parser.add_argument("--split", action="store_true",
                        help="only trace the BCE step, with command buffers "
                        "off, for its per-op device time")
    args = parser.parse_args()
    if args.split:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
        )

    import jax

    from ttamm.utils import enable_persistent_cache

    enable_persistent_cache()
    device = jax.devices()[0]
    if device.platform != "gpu":
        print(f"needs a GPU; JAX's default device is {device}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    result: dict = {"card": card, "device_kind": device.device_kind}
    if args.split:
        with tempfile.TemporaryDirectory() as td:
            result.update(bce_split(Path(td)))
        return _write(result, args.out)
    for rows in (100_000, 2_000_000):
        for packed in (False, True):
            key = f"sparse_adam_ms_rows{rows}_{'packed' if packed else 'separate'}"
            result[key] = sparse_adam_ms(rows, packed)
            print(key, result[key], flush=True)
    for n_items in (100_000, 2_000_000):
        for dtype in ("float32", "bfloat16"):
            for qb in (64, 128, 256, 512, None):
                key = f"topk_qps_{n_items}_{dtype}_qb{qb or 'default'}"
                result[key] = topk_qps(n_items, dtype, qb)
                print(key, result[key], flush=True)
    result.update(bce_step())
    return _write(result, args.out)


def _write(result: dict, path: str) -> int:
    print(json.dumps(result, indent=1), flush=True)
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
