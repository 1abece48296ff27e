"""Device kernels on the GPU against the numpy float64 references.

Marked ``gpu``: they skip on a machine without one. Run them on the card
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ttamm.numpy_reference import (
    category_alignment_reference,
    mips_scores,
    sparse_adam_reference,
    topk_mismatches,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {device}")
    return device


@pytest.mark.parametrize("algorithm", ["group_exact", "chunked"])
def test_mips_topk_fp32_exact_on_gpu(gpu, algorithm):
    from ttamm.ops.topk import mips_topk

    rng = np.random.default_rng(0)
    items = rng.normal(0, 1, (100_000, 128)).astype(np.float32)
    queries = rng.normal(0, 1, (64, 128)).astype(np.float32)
    mask = rng.integers(0, 100_000, (64, 16)).astype(np.int32)
    _, idx = mips_topk(jnp.asarray(queries), jnp.asarray(items), k=20,
                       algorithm=algorithm, mask_rows=jnp.asarray(mask))
    scores = mips_scores(queries, items, mask)
    assert topk_mismatches(np.asarray(idx), scores, 20, 1e-4) == 0


def test_sparse_adam_on_gpu(gpu):
    from ttamm.ops.sparse_adam import init_sparse_adam, sparse_adam_update

    rng = np.random.default_rng(1)
    rows, lanes, lr = 100_000, 12_288, 1e-3
    table = rng.normal(0, 0.02, (rows, 128)).astype(np.float32)
    idx = rng.integers(0, 2000, lanes).astype(np.int32)
    grads = rng.normal(0, 1e-2, (lanes, 128)).astype(np.float32)
    t = jnp.asarray(table)
    new_t, _ = sparse_adam_update(t, init_sparse_adam(t), jnp.asarray(idx),
                                  jnp.asarray(grads), lr=lr)
    zeros = np.zeros_like(table)
    touched, w_ref, _, _ = sparse_adam_reference(table, zeros, zeros, 0, idx,
                                                 grads, lr=lr)
    assert np.allclose(np.asarray(new_t)[touched], w_ref, rtol=0, atol=1e-3 * lr)


def test_category_alignment_highest_precision_on_gpu(gpu):
    from ttamm.ops.losses import category_alignment_loss

    rng = np.random.default_rng(2)
    cats = np.minimum(rng.zipf(1.5, 12_288) - 1, 80).astype(np.int32)
    x = rng.normal(0, 0.3, (12_288, 128)).astype(np.float32)
    ref_loss, ref_grad = category_alignment_reference(cats, x, 64)
    with jax.default_matmul_precision("highest"):
        loss, grad = jax.value_and_grad(lambda e: category_alignment_loss(
            jnp.asarray(cats), e, max_categories=64))(jnp.asarray(x))
    assert float(loss) == pytest.approx(ref_loss, rel=1e-4)
    assert np.allclose(np.asarray(grad), ref_grad, atol=1e-4 * np.abs(ref_grad).max())


def test_flat_index_auto_searches_on_device(gpu):
    from ttamm.serve import build_flat_index

    rng = np.random.default_rng(3)
    index = build_flat_index(rng.normal(0, 1, (20_000, 64)).astype(np.float32))
    queries = rng.normal(0, 1, (4, 64)).astype(np.float32)
    _, idx = index.search(queries, 10)
    assert getattr(index, "_device_emb", None) is not None
    assert topk_mismatches(idx, mips_scores(queries, index.embeddings), 10, 1e-4) == 0
