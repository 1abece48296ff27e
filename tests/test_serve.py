"""Flat-index artifact + native/numpy search backends."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ttamm.serve import FlatIndex, build_flat_index, native_available
from ttamm.serve.flat_index import _numpy_search

REPO_ROOT = Path(__file__).resolve().parents[1]


def test_flat_index_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    emb = rng.normal(0, 1, (100, 16)).astype(np.float32)
    index = build_flat_index(emb, normalize=True)
    path = tmp_path / "items.index"
    index.save(path)
    loaded = FlatIndex.load(path)
    assert loaded.normalized is True
    assert loaded.dim == 16 and len(loaded) == 100
    norms = np.linalg.norm(loaded.embeddings, axis=1)
    assert np.allclose(norms, 1.0, atol=1e-5)


def test_flat_index_score_dtype_roundtrip(tmp_path):
    rng = np.random.default_rng(9)
    emb = rng.normal(0, 1, (10, 4)).astype(np.float32)
    path = tmp_path / "items.index"
    build_flat_index(emb, score_dtype="bfloat16").save(path)
    assert FlatIndex.load(path).score_dtype == "bfloat16"
    build_flat_index(emb).save(path)
    assert FlatIndex.load(path).score_dtype == "float32"
    with pytest.raises(ValueError):
        build_flat_index(emb, score_dtype="float16")


def test_flat_index_bad_magic(tmp_path):
    path = tmp_path / "bogus.index"
    path.write_bytes(b"NOTANIDX" + b"\x00" * 64)
    with pytest.raises(ValueError):
        FlatIndex.load(path)


def test_numpy_search_exact():
    rng = np.random.default_rng(1)
    emb = rng.normal(0, 1, (500, 8)).astype(np.float32)
    queries = rng.normal(0, 1, (7, 8)).astype(np.float32)
    scores, idx = _numpy_search(emb, queries, 5)
    full = queries @ emb.T
    expected = np.argsort(-full, axis=1)[:, :5]
    assert np.array_equal(idx, expected)


@pytest.mark.skipif(not native_available(), reason="native library not built")
def test_native_matches_numpy():
    rng = np.random.default_rng(2)
    emb = rng.normal(0, 1, (2000, 32)).astype(np.float32)
    queries = rng.normal(0, 1, (16, 32)).astype(np.float32)
    from ttamm.serve import native_flat_search

    s_n, i_n = native_flat_search(emb, queries, 9)
    s_p, i_p = _numpy_search(emb, queries, 9)
    assert np.array_equal(i_n, i_p)
    assert np.allclose(s_n, s_p, atol=1e-4)


def test_query_cli(tmp_path):
    rng = np.random.default_rng(3)
    emb = rng.normal(0, 1, (50, 8)).astype(np.float32)
    build_flat_index(emb).save(tmp_path / "items.index")
    np.save(tmp_path / "q.npy", emb[:2])
    out = subprocess.run(
        [
            sys.executable,
            str(REPO_ROOT / "scripts" / "query.py"),
            "--index",
            str(tmp_path / "items.index"),
            "--queries",
            str(tmp_path / "q.npy"),
            "--k",
            "3",
        ],
        capture_output=True,
        text=True,
        check=True,
    )
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    # each query's own row is its top hit for un-normalised self-queries
    assert lines[0].startswith("query 0: 0:")


def test_retrieval_service_roundtrip(tmp_path):
    import json

    rng = np.random.default_rng(7)
    item_emb = rng.normal(0, 1, (30, 8)).astype(np.float32)
    user_emb = rng.normal(0, 1, (10, 8)).astype(np.float32)
    build_flat_index(item_emb, normalize=True).save(tmp_path / "items.index")
    np.save(tmp_path / "user_embeddings.npy", user_emb)
    (tmp_path / "vocab.json").write_text(
        json.dumps(
            {
                "user_ids": [f"U{i}" for i in range(10)],
                "item_ids": [f"A{i}" for i in range(30)],
                "similarity": "cosine",
            }
        )
    )
    from ttamm.serve import RetrievalService

    service = RetrievalService.from_artifacts(tmp_path)
    recs = service.recommend_for_user("U3", k=5)
    assert len(recs) == 5
    assert all(asin.startswith("A") for asin, _ in recs)
    # exclusion drops items
    top_idx = int(recs[0][0][1:])
    recs2 = service.recommend_for_user("U3", k=5, exclude={top_idx})
    assert recs[0][0] not in [a for a, _ in recs2]
    with pytest.raises(KeyError):
        service.recommend_for_user("nobody")


def test_device_backend_raises_without_accelerator():
    import pytest

    from ttamm.serve.flat_index import build_flat_index

    rng = np.random.default_rng(5)
    idx = build_flat_index(rng.normal(0, 1, (64, 8)).astype(np.float32))
    q = rng.normal(0, 1, (4, 8)).astype(np.float32)
    # Tests force the CPU platform, so the strict device backend must raise.
    with pytest.raises(RuntimeError):
        idx.search(q, 5, backend="device")
    # ... while auto on an install without an accelerator searches the host.
    qbig = rng.normal(0, 1, (64, 8)).astype(np.float32)
    scores, indices = idx.search(qbig, 5, backend="auto")
    assert scores.shape == (64, 5)


def test_device_backend_wiring_matches_numpy(monkeypatch):
    import ttamm.serve.flat_index as fi

    rng = np.random.default_rng(6)
    idx = fi.build_flat_index(rng.normal(0, 1, (300, 16)).astype(np.float32))
    q = rng.normal(0, 1, (7, 16)).astype(np.float32)

    def fake_device_search(self, queries, k):
        import jax.numpy as jnp

        from ttamm.ops.topk import mips_topk

        s, i = mips_topk(jnp.asarray(queries), jnp.asarray(self.embeddings), k=k)
        return np.asarray(s), np.asarray(i).astype(np.int64)

    monkeypatch.setattr(fi.FlatIndex, "_device_search", fake_device_search)
    s_d, i_d = idx.search(q, 5, backend="device")
    s_n, i_n = idx.search(q, 5, backend="numpy")
    assert np.allclose(s_d, s_n, atol=1e-5)
    assert np.array_equal(np.sort(i_d), np.sort(i_n))
