"""Multi-process initialization for runs that span several hosts.

Every process runs the same program; JAX needs
``jax.distributed.initialize`` before first device use so every process
sees the global device set. This wrapper makes that a config switch:

    mesh:
      data_parallel: 16
      model_parallel: 2
      multi_host: true          # call initialize() from the JAX_* env vars

Single-host runs (and the CPU test mesh) skip it. Elastic recovery /
preemption handling is out of scope for now (the reference has no failure
handling at all, SURVEY §5); checkpoint+resume is the recovery story.
"""

from __future__ import annotations

import os

from ..utils.logging import get_logger

logger = get_logger("parallel")

_initialized = False


def maybe_initialize_distributed(multi_host: bool = False) -> bool:
    """Initialize JAX's multi-process runtime when requested.

    Returns True when running in a multi-process setup. The coordinator
    comes from ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``; without them ``jax.distributed.initialize`` asks
    the cluster environment it detects. A failed initialization raises:
    a run configured for several hosts never continues as one process.
    """
    global _initialized
    if not multi_host or _initialized:
        return _initialized

    import jax

    kwargs = {}
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        kwargs = {
            "coordinator_address": os.environ["JAX_COORDINATOR_ADDRESS"],
            "num_processes": int(os.environ["JAX_NUM_PROCESSES"]),
            "process_id": int(os.environ["JAX_PROCESS_ID"]),
        }
    try:
        jax.distributed.initialize(**kwargs)
    except Exception as exc:
        raise RuntimeError(
            "mesh.multi_host is set but jax.distributed.initialize failed; "
            "set JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and "
            "JAX_PROCESS_ID"
        ) from exc
    _initialized = True
    logger.info(
        "Distributed runtime up: process %d/%d, %d global devices",
        jax.process_index(),
        jax.process_count(),
        len(jax.devices()),
    )
    return _initialized


def is_primary_host() -> bool:
    """True on the process that should write artifacts/reports."""
    import jax

    return jax.process_index() == 0
