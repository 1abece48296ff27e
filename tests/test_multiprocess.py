"""2-process x 4-device jax.distributed validation.

The single-process virtual mesh cannot exercise ``jax.distributed``
initialization, cross-process array placement, or the multi-process
compile path. This test spawns two real OS processes that form a
2-process CPU cluster (8 global devices), run one sharded hybrid train
step each on a 4x2 global mesh, and must agree on the loss — which must
also match the single-process step on the same inputs.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_parallel import _setup, U, I, B
from ttamm.train import make_train_step

WORKER = Path(__file__).resolve().parent / "multiprocess_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_step_agrees_with_single_process(tmp_path):
    # Hang safety comes from the communicate(timeout=280) below, not a
    # pytest-timeout plugin (not installed here).
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(port), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env={
                k: v
                for k, v in os.environ.items()
                if k not in ("XLA_FLAGS", "JAX_PLATFORMS")
            },
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=280)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-3000:]}"

    losses, losses2 = [], []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("LOSS ")]
        assert lines, f"no LOSS line in worker output:\n{out[-2000:]}"
        losses.append(float(lines[-1].split()[1]))
        lines2 = [l for l in out.splitlines() if l.startswith("LOSS2 ")]
        assert lines2, f"no LOSS2 line in worker output:\n{out[-2000:]}"
        losses2.append(float(lines2[-1].split()[1]))
    assert losses[0] == losses[1], losses
    # Sharded save -> restore -> continue: both processes agree.
    assert losses2[0] == losses2[1], losses2
    # And the checkpoint wrote per-process shard files + manifest.
    ckpts = list(tmp_path.glob("*/manifest.json"))
    assert len(ckpts) == 1
    shard_files = sorted(ckpts[0].parent.glob("shards_p*.npz"))
    assert [f.name for f in shard_files] == [
        "shards_p00000.npz",
        "shards_p00001.npz",
    ]

    # Reference: the plain single-process steps on identical inputs.
    cfg, state, data, tscfg = _setup()
    step = make_train_step(cfg, tscfg)
    rng = np.random.default_rng(1)
    u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    state1, metrics = step(state, data, u, p, jax.random.key(42))
    assert losses[0] == pytest.approx(float(metrics["loss"]), rel=1e-4)
    u2 = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
    p2 = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
    _, metrics2 = step(state1, data, u2, p2, jax.random.key(43))
    # The multi-process continuation from the restored checkpoint matches
    # uninterrupted single-process training.
    assert losses2[0] == pytest.approx(float(metrics2["loss"]), rel=1e-4)
