"""ctypes bridge to the native C++ runtime (``native/libttamm_native.so``).

The reference consumed native capability through FAISS's C++ core; this
framework ships its own native library (built by ``native/Makefile``) for
host-side serving on installs without an accelerator. Gracefully degrades to
numpy when the library has not been built.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB = None
_SEARCHED = False


def _library_path() -> Path:
    override = os.environ.get("TTAMM_NATIVE_LIB")
    if override:
        return Path(override)
    return Path(__file__).resolve().parents[2] / "native" / "libttamm_native.so"


def load_native_library() -> ctypes.CDLL | None:
    """Load (and cache) the native library; None when unavailable."""
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    path = _library_path()
    if not path.exists():
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.ttamm_flat_topk.restype = ctypes.c_int
        lib.ttamm_flat_topk.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # items [n, d]
            ctypes.c_int64,  # n
            ctypes.c_int32,  # d
            ctypes.POINTER(ctypes.c_float),  # queries [b, d]
            ctypes.c_int64,  # b
            ctypes.c_int32,  # k
            ctypes.POINTER(ctypes.c_float),  # out scores [b, k]
            ctypes.POINTER(ctypes.c_int64),  # out indices [b, k]
            ctypes.c_int32,  # num threads (0 = auto)
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def native_available() -> bool:
    return load_native_library() is not None


def native_flat_search(
    embeddings: np.ndarray, queries: np.ndarray, k: int, *, threads: int = 0
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact top-k via the native library; None when it is not built."""
    lib = load_native_library()
    if lib is None:
        return None
    emb = np.ascontiguousarray(embeddings, dtype=np.float32)
    q = np.ascontiguousarray(queries, dtype=np.float32)
    b = q.shape[0]
    scores = np.empty((b, k), dtype=np.float32)
    indices = np.empty((b, k), dtype=np.int64)
    rc = lib.ttamm_flat_topk(
        emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(emb.shape[0]),
        ctypes.c_int32(emb.shape[1]),
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(b),
        ctypes.c_int32(k),
        scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(threads),
    )
    if rc != 0:
        raise RuntimeError(f"native flat_topk failed with code {rc}")
    return scores, indices
