"""Sharded (multi-host-format) checkpoint tests on the virtual 8-device mesh.

The real multi-process path is covered by tests/test_multiprocess.py; these
pin the format itself: per-shard piece save, assembly under the same and
different layouts, moment-layout conversion, and the load_checkpoint
directory dispatch.
"""

import jax
import numpy as np
import pytest

from test_parallel import _setup
from ttamm.parallel import (
    MeshConfig,
    build_mesh,
    pad_state_rows,
    place_state,
)
from ttamm.train import (
    create_train_state,
    load_checkpoint,
    load_sharded_checkpoint,
    save_sharded_checkpoint,
)


def _placed_state(seed=0, model_parallel=2):
    cfg, state, _, _ = _setup(seed=seed)
    mesh = build_mesh(
        MeshConfig(
            data_parallel=8 // model_parallel, model_parallel=model_parallel
        )
    )
    return cfg, mesh, place_state(mesh, pad_state_rows(state, model_parallel))


def _assert_states_equal(a, b):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_sharded_roundtrip_same_mesh(tmp_path):
    _, mesh, state = _placed_state(seed=0)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=4,
        metric_name="recall@10", metric_value=0.3,
    )
    assert path.is_dir()
    assert (path / "manifest.json").exists()
    assert (path / "shards_p00000.npz").exists()

    _, _, template = _placed_state(seed=1)
    restored, meta = load_sharded_checkpoint(path, template)
    assert meta["epoch"] == 4
    _assert_states_equal(state, restored)
    # Placement is the template's, not host numpy.
    for leaf in jax.tree.leaves(restored):
        assert isinstance(leaf, jax.Array)
    assert (
        restored.tables["item_id"].sharding.spec
        == template.tables["item_id"].sharding.spec
    )


def test_sharded_restore_into_unplaced_template(tmp_path):
    """A checkpoint saved row-sharded restores into a plain single-device
    state (different layout than saved) by assembling pieces."""
    cfg, _, state = _placed_state(seed=0)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    template = pad_state_rows(
        create_train_state(jax.random.key(7), cfg, num_users=48, num_items=40),
        2,
    )  # numpy/unplaced leaves
    restored, _ = load_sharded_checkpoint(path, template)
    _assert_states_equal(state, restored)


def test_sharded_restore_under_different_mesh_layout(tmp_path):
    """Saved with model=2 row shards, restored with model=4 shards: each
    target shard is assembled from the overlapping saved pieces. (Same
    padded row counts — the model=4 padding divides by 2 as well.)"""
    cfg, raw, _, _ = _setup(seed=0)
    padded = pad_state_rows(raw, 4)
    mesh2 = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    mesh4 = build_mesh(MeshConfig(data_parallel=2, model_parallel=4))
    state = place_state(mesh2, padded)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    template = place_state(mesh4, pad_state_rows(_setup(seed=9)[1], 4))
    restored, _ = load_sharded_checkpoint(path, template)
    _assert_states_equal(state, restored)
    assert (
        restored.tables["item_id"].sharding.spec
        == template.tables["item_id"].sharding.spec
    )


@pytest.mark.parametrize("save_packed", [False, True])
def test_sharded_moment_layout_conversion(tmp_path, save_packed):
    cfg, _, _ = _placed_state()
    mesh = build_mesh(MeshConfig(data_parallel=4, model_parallel=2))
    state = place_state(
        mesh,
        pad_state_rows(
            create_train_state(
                jax.random.key(0), cfg, num_users=48, num_items=40,
                packed_moments=save_packed,
            ),
            2,
        ),
    )
    # Non-trivial moments so the lane relayout is actually exercised.
    state = state._replace(
        opt_sparse=jax.tree.map(
            lambda a: a + 1.5 if getattr(a, "ndim", 0) == 2 else a,
            state.opt_sparse,
        )
    )
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    template = place_state(
        mesh,
        pad_state_rows(
            create_train_state(
                jax.random.key(3), cfg, num_users=48, num_items=40,
                packed_moments=not save_packed,
            ),
            2,
        ),
    )
    restored, _ = load_sharded_checkpoint(path, template)
    for name, st in restored.opt_sparse.items():
        src = state.opt_sparse[name]
        np.testing.assert_array_equal(np.asarray(st.m), np.asarray(src.m))
        np.testing.assert_array_equal(np.asarray(st.v), np.asarray(src.v))


def test_load_checkpoint_dispatches_to_sharded_dir(tmp_path):
    _, _, state = _placed_state(seed=0)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=2,
        metric_name="loss", metric_value=0.1,
    )
    _, _, template = _placed_state(seed=5)
    restored, meta = load_checkpoint(path, template)
    assert meta["epoch"] == 2
    _assert_states_equal(state, restored)


def test_async_checkpointer_sharded(tmp_path):
    from ttamm.train.checkpoint import AsyncCheckpointer

    _, _, state = _placed_state(seed=0)
    ckpt = AsyncCheckpointer(sharded=True)
    (path,) = ckpt.submit(
        state,
        [
            dict(
                directory=tmp_path,
                experiment_name="exp",
                epoch=3,
                metric_name="last",
                metric_value=3.0,
                template="{experiment}_last.pt",
            )
        ],
    )
    ckpt.wait()
    assert path.name == "exp_last.pt" and path.is_dir()
    _, _, template = _placed_state(seed=2)
    restored, meta = load_checkpoint(path, template)
    assert meta["epoch"] == 3
    _assert_states_equal(state, restored)


def test_missing_leaf_raises(tmp_path):
    _, _, state = _placed_state(seed=0)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    # Drop a leaf's pieces by renaming them away in the shard file.
    import numpy as _np

    shard_path = path / "shards_p00000.npz"
    blob = dict(_np.load(shard_path, allow_pickle=False))
    pruned = {k: v for k, v in blob.items() if "item_id" not in k or "::" not in k}
    with open(shard_path, "wb") as handle:
        _np.savez(handle, **{k: v for k, v in pruned.items() if "tables/item_id" not in k})
    _, _, template = _placed_state(seed=1)
    with pytest.raises(ValueError, match="no pieces"):
        load_sharded_checkpoint(path, template)


def test_stale_shard_files_pruned_and_ignored(tmp_path):
    """Re-saving into a directory that holds shard files from a run with
    MORE processes must neither fail coverage validation nor restore the
    stale rows (the 'best'/'last' checkpoint must stay loadable after the
    process count shrinks)."""
    _, _, state = _placed_state(seed=0)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
        template="{experiment}_best.pt",
    )
    # Forge a stale higher-index shard file (as a previous 2-process save
    # would leave behind) whose pieces OVERLAP this save's.
    first = np.load(path / "shards_p00000.npz", allow_pickle=False)
    stale = {k: np.full_like(v, 123.0) for k, v in dict(first).items()}
    first.close()
    with open(path / "shards_p00001.npz", "wb") as handle:
        np.savez(handle, **stale)

    # Restore must ignore it (manifest says num_processes == 1).
    _, _, template = _placed_state(seed=1)
    restored, _ = load_sharded_checkpoint(path, template)
    _assert_states_equal(state, restored)

    # A fresh save into the same directory prunes the stale file.
    path2 = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=2,
        metric_name="loss", metric_value=0.4,
        template="{experiment}_best.pt",
    )
    assert path2 == path
    assert not (path / "shards_p00001.npz").exists()
    restored2, meta2 = load_sharded_checkpoint(path, template)
    assert meta2["epoch"] == 2
    _assert_states_equal(state, restored2)


def test_piece_index_closes_npz_handles(tmp_path):
    """_PieceIndex.close() must release every NpzFile (fd-leak guard);
    load_sharded_checkpoint calls it after assembly."""
    from ttamm.train.sharded_checkpoint import _PieceIndex

    _, _, state = _placed_state(seed=0)
    path = save_sharded_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    index = _PieceIndex(path, num_processes=1)
    blobs = list(index._files)
    assert blobs
    index.close()
    assert index._files == [] and index.by_leaf == {}
    for blob in blobs:
        with pytest.raises(Exception):
            blob["anything"]  # closed NpzFile refuses reads
