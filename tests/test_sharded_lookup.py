"""Explicit all-to-all embedding lookup vs jnp.take (known permutations)."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ttamm.parallel import MODEL_AXIS, MeshConfig, build_mesh
from ttamm.parallel.embedding_lookup import make_sharded_lookup


def _mesh():
    return build_mesh(MeshConfig(data_parallel=1, model_parallel=8))


def test_lookup_matches_take():
    mesh = _mesh()
    rng = np.random.default_rng(0)
    table = rng.normal(0, 1, (64, 16)).astype(np.float32)
    idx = rng.integers(0, 64, 37).astype(np.int32)

    table_sharded = jax.device_put(
        jnp.asarray(table), NamedSharding(mesh, P(MODEL_AXIS, None))
    )
    lookup = make_sharded_lookup(mesh, num_rows=64, dim=16)
    rows = lookup(table_sharded, jnp.asarray(idx))
    assert np.allclose(np.asarray(rows), table[idx], atol=1e-6)


def test_lookup_known_permutation():
    mesh = _mesh()
    # table row r filled with value r: a permutation lookup must return the
    # permuted values exactly (pins the owner-shard routing).
    table = jnp.broadcast_to(
        jnp.arange(32, dtype=jnp.float32)[:, None], (32, 8)
    )
    table_sharded = jax.device_put(
        table, NamedSharding(mesh, P(MODEL_AXIS, None))
    )
    perm = np.random.default_rng(1).permutation(32).astype(np.int32)
    lookup = make_sharded_lookup(mesh, num_rows=32, dim=8)
    rows = lookup(table_sharded, jnp.asarray(perm))
    assert np.allclose(np.asarray(rows)[:, 0], perm.astype(np.float32))


def test_lookup_gradient_scatters_to_owners():
    mesh = _mesh()
    rng = np.random.default_rng(2)
    table = rng.normal(0, 1, (40, 8)).astype(np.float32)
    idx = np.array([0, 5, 5, 39, 12], np.int32)  # duplicate index 5
    cotangent = rng.normal(0, 1, (5, 8)).astype(np.float32)

    table_sharded = jax.device_put(
        jnp.asarray(table), NamedSharding(mesh, P(MODEL_AXIS, None))
    )
    lookup = make_sharded_lookup(mesh, num_rows=40, dim=8)

    def loss(t):
        return jnp.sum(lookup(t, jnp.asarray(idx)) * jnp.asarray(cotangent))

    grad = np.asarray(jax.grad(loss)(table_sharded))
    expected = np.zeros_like(table)
    for row, ct in zip(idx, cotangent):
        expected[row] += ct
    assert np.allclose(grad, expected, atol=1e-6)


def test_indivisible_rows_rejected():
    mesh = _mesh()
    import pytest

    with pytest.raises(ValueError):
        make_sharded_lookup(mesh, num_rows=65, dim=4)
