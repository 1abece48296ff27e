"""Flat MIPS index artifact: the FAISS ``IndexFlatIP`` replacement.

The reference persists a FAISS flat inner-product index plus a raw
embedding matrix (``_save_faiss_artifacts``, ref ``training.py:682-697``;
paths from ``configs/default.yaml:94-99``). Here the artifact is an open
binary format (magic ``TTFLAT1``) holding the float32 embedding matrix and
a normalize flag:

    [8s magic][u32 version][u32 dim][u64 count][u8 normalized]
    [u8 score_dtype: 0=float32 1=bfloat16][pad 2][data]

(The score byte reuses a v1 pad byte: v1 files read as 0 = float32, and
v1 readers ignore it — both directions stay compatible.)

Search backends:

1. on-device exact MIPS (``ttamm.ops.topk``) whenever an accelerator
   is attached — used by eval, serving and the query CLI;
2. on installs without one, the native C++ searcher
   (``native/flat_index.cpp``) via ctypes — exact multithreaded blocked
   top-k on the host;
3. a pure-numpy searcher where the native library is not built.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

MAGIC = b"TTFLAT1\x00"
VERSION = 1
_HEADER = struct.Struct("<8sII Q BB2x")
_SCORE_FLAGS = {"float32": 0, "bfloat16": 1}
_FLAG_SCORES = {v: k for k, v in _SCORE_FLAGS.items()}
# The device copy of the corpus is padded to this many rows: a multiple of
# both the 128-item group and the default 8192-item scan chunk of
# ``mips_topk``, so searches slice the padded buffer instead of copying it.
_DEVICE_ROW_MULTIPLE = 8192


def accelerator_attached() -> bool:
    """True when JAX's default device is an accelerator (not the CPU)."""
    import jax

    return jax.devices()[0].platform != "cpu"


@dataclass
class FlatIndex:
    """An exact inner-product index over a row matrix."""

    embeddings: np.ndarray  # float32 [count, dim]
    normalized: bool = False
    # Device-backend scoring precision: 'float32' (exact, FAISS-parity) or
    # 'bfloat16' (serving fast path: half the score-slab bytes, ranking
    # exact w.r.t. bf16-rounded scores; see ops/topk.py mips_topk). The training
    # pipeline exports bf16 only after an explicit recall-delta gate on
    # the final e2e eval (config ``serving:``); persisted in the artifact
    # header. Host backends (native/numpy) always score in float32.
    score_dtype: str = "float32"

    @property
    def dim(self) -> int:
        return int(self.embeddings.shape[1])

    def __len__(self) -> int:
        return int(self.embeddings.shape[0])

    def search(
        self, queries: np.ndarray, k: int, *, backend: str = "auto"
    ) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by inner product. Returns (scores [B,k], indices [B,k]).

        backend: 'auto' | 'device' | 'native' | 'numpy'. 'device' runs the
        exact group-pruned MIPS search (``ttamm.ops.topk``) on the
        attached accelerator with the index cached in device memory;
        'native' is the multithreaded C++ searcher; 'numpy' the blocked
        host search. 'auto' is 'device' whenever an accelerator is
        attached — a device error then propagates, it never silently
        degrades to a host search — and native -> numpy otherwise.
        """
        if backend not in {"auto", "device", "native", "numpy"}:
            raise ValueError(f"Unknown search backend: {backend}")
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        if queries.ndim == 1:
            queries = queries[None, :]
        if self.normalized:
            norms = np.linalg.norm(queries, axis=1, keepdims=True)
            queries = queries / np.maximum(norms, 1e-12)
        k = min(k, len(self))

        if backend == "device" or (
            backend == "auto" and accelerator_attached()
        ):
            return self._device_search(queries, k)
        if backend in ("auto", "native"):
            from .native_bridge import native_flat_search

            result = native_flat_search(self.embeddings, queries, k)
            if result is not None:
                return result
            if backend == "native":
                raise RuntimeError("native searcher library is not built")
        return _numpy_search(self.embeddings, queries, k)

    def _device_search(
        self, queries: np.ndarray, k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k on the attached accelerator.

        The embedding matrix is transferred once and cached in device
        memory across calls (the index is immutable).
        """
        import jax
        import jax.numpy as jnp

        from ..ops.topk import mips_topk

        if not accelerator_attached():
            raise RuntimeError(
                "backend='device' requires an attached accelerator; JAX's "
                f"default device is {jax.devices()[0]}."
            )
        emb = getattr(self, "_device_emb", None)
        # Cache the corpus PRE-PADDED so the search slices instead of
        # pad-concatenating (a full-corpus copy per call). The cache key
        # includes the source matrix identity and valid-row count, not
        # just the padded bucket: swapping .embeddings for a different
        # corpus that lands in the same bucket must refresh the device copy.
        cache_key = (id(self.embeddings), len(self))
        padded_rows = -(-len(self) // _DEVICE_ROW_MULTIPLE) * _DEVICE_ROW_MULTIPLE
        if emb is None or getattr(self, "_device_emb_key", None) != cache_key:
            host = np.zeros((padded_rows, self.dim), np.float32)
            host[: len(self)] = self.embeddings
            emb = jax.device_put(host)
            self._device_emb = emb
            self._device_emb_key = cache_key
        scores, idx = mips_topk(
            jnp.asarray(queries), emb, k=k, score_dtype=self.score_dtype,
            num_valid_rows=len(self),
        )
        return np.asarray(scores), np.asarray(idx).astype(np.int64)

    def save(self, path: Path | str) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        emb = np.ascontiguousarray(self.embeddings, dtype=np.float32)
        with open(path, "wb") as handle:
            handle.write(
                _HEADER.pack(
                    MAGIC, VERSION, emb.shape[1], emb.shape[0],
                    int(self.normalized), _SCORE_FLAGS[self.score_dtype],
                )
            )
            handle.write(emb.tobytes())

    @classmethod
    def load(cls, path: Path | str) -> "FlatIndex":
        path = Path(path)
        with open(path, "rb") as handle:
            header = handle.read(_HEADER.size)
            magic, version, dim, count, normalized, score_flag = (
                _HEADER.unpack(header)
            )
            if magic != MAGIC:
                raise ValueError(f"{path} is not a TTFLAT index (bad magic).")
            if version != VERSION:
                raise ValueError(f"Unsupported TTFLAT version {version}.")
            data = np.frombuffer(handle.read(count * dim * 4), dtype=np.float32)
        if score_flag not in _FLAG_SCORES:
            raise ValueError(
                f"{path}: unknown score_dtype flag {score_flag} "
                "(index written by a newer version?)"
            )
        return cls(
            embeddings=data.reshape(count, dim).copy(),
            normalized=bool(normalized),
            score_dtype=_FLAG_SCORES[score_flag],
        )


def _numpy_search(
    embeddings: np.ndarray, queries: np.ndarray, k: int, block: int = 65536
) -> tuple[np.ndarray, np.ndarray]:
    n = embeddings.shape[0]
    b = queries.shape[0]
    best_scores = np.full((b, k), -np.inf, dtype=np.float32)
    best_idx = np.zeros((b, k), dtype=np.int64)
    for start in range(0, n, block):
        chunk = embeddings[start : start + block]
        scores = queries @ chunk.T  # [b, block]
        local_k = min(k, scores.shape[1])
        part = np.argpartition(-scores, local_k - 1, axis=1)[:, :local_k]
        part_scores = np.take_along_axis(scores, part, axis=1)
        merged_scores = np.concatenate([best_scores, part_scores], axis=1)
        merged_idx = np.concatenate([best_idx, part + start], axis=1)
        sel = np.argpartition(-merged_scores, k - 1, axis=1)[:, :k]
        best_scores = np.take_along_axis(merged_scores, sel, axis=1)
        best_idx = np.take_along_axis(merged_idx, sel, axis=1)
    order = np.argsort(-best_scores, axis=1)
    return (
        np.take_along_axis(best_scores, order, axis=1),
        np.take_along_axis(best_idx, order, axis=1),
    )


def build_flat_index(
    embeddings: np.ndarray,
    *,
    normalize: bool = False,
    score_dtype: str = "float32",
) -> FlatIndex:
    """Build an index, L2-normalising rows when ``normalize`` (cosine mode,
    matching FAISS ``normalize_L2`` + ``IndexFlatIP``)."""
    if score_dtype not in _SCORE_FLAGS:
        raise ValueError(f"Unknown score_dtype: {score_dtype}")
    emb = np.ascontiguousarray(embeddings, dtype=np.float32)
    if normalize:
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        emb = emb / np.maximum(norms, 1e-12)
    return FlatIndex(
        embeddings=emb, normalized=normalize, score_dtype=score_dtype
    )
