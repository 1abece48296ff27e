"""Persistent XLA compilation cache.

Pointing JAX's persistent compilation cache at a fixed directory makes
every run after the first skip compilation: XLA keys entries on the
serialized HLO + compile options + device, so identical programs
deserialize in milliseconds instead of recompiling.

No reference analog — the reference's torch/FAISS path has no AOT
compilation step (ref src/pipelines/training.py:330-384 searches eagerly).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parent.parent.parent / ".jax_cache"


def enable_persistent_cache() -> str:
    """Enable JAX's persistent compilation cache (idempotent).

    Call BEFORE the first jit dispatch. The directory is
    ``$JAX_COMPILATION_CACHE_DIR`` when that is set — used as given — and
    the fixed ``<repo>/.jax_cache`` otherwise. Returns the directory in use.

    The min-compile-time / min-entry-size floors are zeroed so the small
    programs around a headline kernel are cached too.
    """
    import jax

    path = Path(os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR)
    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return str(path)
