#!/usr/bin/env python
"""Execute the ragged all-to-all exchange on one accelerator.

The ``ragged`` exchange layout (``parallel/exchange.py
_ragged_exchange_rows``) needs an accelerator backend — XLA:CPU has no
ragged-all-to-all thunk — so the multi-shard CPU tests run it with an
emulated collective (tests/test_exchange.py). This script runs a
degenerate 1x1-mesh lookup on one device that lowers and executes the REAL
``lax.ragged_all_to_all`` end to end (S=1: every offset/size array is
live, the thunk runs, the data round-trips through it), plus the full
hybrid train step compiled with ``embedding_exchange='alltoall'``.
``chip_smoke.py --multi`` runs it across four cards against the dense
layout.

Usage: python scripts/check_ragged_exchange.py  (prints one JSON line)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> None:
    import jax
    import jax.numpy as jnp

    from ttamm.parallel import MeshConfig, build_mesh
    from ttamm.parallel.exchange import make_exchange_lookup

    backend = jax.default_backend()
    mesh = build_mesh(MeshConfig(data_parallel=1, model_parallel=1))

    rows, dim, n = 64, 8, 32
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(0, 1, (rows, dim)).astype(np.float32))
    ids = jnp.asarray(rng.integers(0, rows, n).astype(np.int32))

    lookup = make_exchange_lookup(mesh, rows, variant="ragged")
    hlo = jax.jit(lookup).lower(table, ids).compile().as_text()
    n_ragged = hlo.count("ragged-all-to-all")
    out = np.asarray(jax.device_get(jax.jit(lookup)(table, ids)))
    fwd_ok = bool(np.allclose(out, np.asarray(table)[np.asarray(ids)]))

    # Gradient path through the custom VJP on the same mesh.
    cot = jnp.asarray(rng.normal(0, 1, (n, dim)).astype(np.float32))
    g = jax.jit(
        jax.grad(lambda t: jnp.vdot(lookup(t, ids), cot))
    )(table)
    g_ref = jax.grad(
        lambda t: jnp.vdot(jnp.take(t, ids, axis=0), cot)
    )(table)
    bwd_ok = bool(
        np.allclose(np.asarray(jax.device_get(g)), np.asarray(g_ref), atol=1e-6)
    )

    # Full hybrid step with the alltoall exchange on the 1x1 mesh.
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import os

    step_loss = None
    try:
        from test_parallel import _setup, U, I, B
        from ttamm.parallel import (
            make_sharded_train_step, pad_batch_data, pad_state_rows,
            place_data, place_state,
        )

        cfg, state, data, tscfg = _setup()
        tscfg = tscfg._replace(embedding_exchange="alltoall")
        pstate = place_state(mesh, pad_state_rows(state, 1))
        pdata = place_data(mesh, pad_batch_data(data, 1))
        step = make_sharded_train_step(cfg, tscfg, mesh, pstate, pdata)
        u = jnp.asarray(rng.integers(0, U, B).astype(np.int32))
        p = jnp.asarray(rng.integers(0, I, B).astype(np.int32))
        _, metrics = step(pstate, pdata, u, p, jax.random.key(1))
        step_loss = float(np.asarray(jax.device_get(metrics["loss"])))
    except Exception as exc:  # keep the core result even if this leg dies
        step_loss = f"failed: {type(exc).__name__}: {exc}"

    print(
        json.dumps(
            {
                "backend": backend,
                "ragged_ops_in_hlo": n_ragged,
                "forward_matches_take": fwd_ok,
                "grad_matches_take": bwd_ok,
                "alltoall_step_loss": step_loss,
            }
        )
    )


if __name__ == "__main__":
    main()
