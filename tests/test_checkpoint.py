import jax
import numpy as np
import pytest

from ttamm.models import parse_model_config
from ttamm.train import create_train_state, load_checkpoint, save_checkpoint
from ttamm.train.checkpoint import checkpoint_filename


def _cfg():
    return parse_model_config(
        {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 8, "sparse": True}},
                "feature_encoder": {"type": "linear", "output_dim": 8},
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "embedding",
                "params": {"embedding_dim": 8},
            },
            "similarity": "dot",
            "adaptive_mimic": {"enabled": True},
        },
        user_feature_dim=3,
        item_feature_dim=0,
    )


def test_checkpoint_roundtrip(tmp_path):
    cfg = _cfg()
    state = create_train_state(jax.random.key(0), cfg, num_users=5, num_items=6)
    path = save_checkpoint(
        tmp_path,
        state,
        experiment_name="exp",
        epoch=3,
        metric_name="recall@10",
        metric_value=0.25,
        template="{experiment}_{metric}_{value:.4f}_epoch{epoch}.pt",
    )
    assert path.name == "exp_recallat10_0.2500_epoch3.pt"

    template = create_train_state(jax.random.key(1), cfg, num_users=5, num_items=6)
    restored, meta = load_checkpoint(path, template)
    assert meta["epoch"] == 3
    assert meta["metric_value"] == 0.25
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert np.allclose(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch_detected(tmp_path):
    cfg = _cfg()
    state = create_train_state(jax.random.key(0), cfg, num_users=5, num_items=6)
    path = save_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    other = create_train_state(jax.random.key(0), cfg, num_users=9, num_items=6)
    with pytest.raises(ValueError):
        load_checkpoint(path, other)


def test_async_checkpointer_matches_sync(tmp_path):
    from ttamm.train.checkpoint import AsyncCheckpointer

    cfg = _cfg()
    state = create_train_state(jax.random.key(0), cfg, num_users=5, num_items=6)
    sync_path = save_checkpoint(
        tmp_path / "sync", state, experiment_name="exp", epoch=2,
        metric_name="recall@10", metric_value=0.5,
    )

    ckpt = AsyncCheckpointer()
    paths = ckpt.submit(
        state,
        [
            dict(
                directory=tmp_path / "async",
                experiment_name="exp",
                epoch=2,
                metric_name="recall@10",
                metric_value=0.5,
                template=None,
            ),
            dict(
                directory=tmp_path / "async",
                experiment_name="exp",
                epoch=2,
                metric_name="last",
                metric_value=2.0,
                template="{experiment}_last.pt",
            ),
        ],
    )
    ckpt.wait()
    assert paths[0].name == sync_path.name
    assert paths[1].name == "exp_last.pt"
    template = create_train_state(jax.random.key(1), cfg, num_users=5, num_items=6)
    for path in paths:
        restored, meta = load_checkpoint(path, template)
        assert meta["epoch"] == 2
        for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
            assert np.allclose(np.asarray(a), np.asarray(b))


def test_async_checkpointer_orders_same_file_writes(tmp_path):
    from ttamm.train.checkpoint import AsyncCheckpointer

    cfg = _cfg()
    ckpt = AsyncCheckpointer()
    states = []
    for epoch in (1, 2, 3):
        state = create_train_state(
            jax.random.key(epoch), cfg, num_users=5, num_items=6
        )
        states.append(state)
        (path,) = ckpt.submit(
            state,
            [
                dict(
                    directory=tmp_path,
                    experiment_name="exp",
                    epoch=epoch,
                    metric_name="last",
                    metric_value=float(epoch),
                    template="{experiment}_last.pt",
                )
            ],
        )
    ckpt.wait()
    template = create_train_state(jax.random.key(9), cfg, num_users=5, num_items=6)
    restored, meta = load_checkpoint(path, template)
    assert meta["epoch"] == 3  # the final submit wins
    for a, b in zip(jax.tree.leaves(states[-1]), jax.tree.leaves(restored)):
        assert np.allclose(np.asarray(a), np.asarray(b))


def test_async_checkpointer_surfaces_errors(tmp_path):
    from ttamm.train.checkpoint import AsyncCheckpointer

    cfg = _cfg()
    state = create_train_state(jax.random.key(0), cfg, num_users=5, num_items=6)
    bad = tmp_path / "not_a_dir"
    bad.write_text("file blocks mkdir")
    ckpt = AsyncCheckpointer()
    ckpt.submit(
        state,
        [
            dict(
                directory=bad / "sub",
                experiment_name="exp",
                epoch=1,
                metric_name="loss",
                metric_value=0.1,
                template=None,
            )
        ],
    )
    with pytest.raises(RuntimeError, match="Async checkpoint save failed"):
        ckpt.wait()


@pytest.mark.parametrize("save_packed", [False, True])
def test_checkpoint_portable_across_moment_layouts(tmp_path, save_packed):
    """training.packed_moments may be toggled between save and resume: the
    packed [rows, 2D] layout is a pure lane relayout of separate m/v, and
    load_checkpoint converts bit-exactly in either direction."""
    cfg = _cfg()
    state = create_train_state(
        jax.random.key(0), cfg, num_users=5, num_items=6,
        packed_moments=save_packed,
    )
    # Make the moments non-trivial so the conversion is actually checked.
    state = state._replace(
        opt_sparse={
            name: jax.tree.map(
                lambda a: a + np.float32(1.5) if a.ndim == 2 else a, st
            )
            for name, st in state.opt_sparse.items()
        }
    )
    path = save_checkpoint(
        tmp_path, state, experiment_name="exp", epoch=1,
        metric_name="loss", metric_value=0.5,
    )
    template = create_train_state(
        jax.random.key(1), cfg, num_users=5, num_items=6,
        packed_moments=not save_packed,
    )
    restored, _ = load_checkpoint(path, template)
    for name, st in restored.opt_sparse.items():
        src = state.opt_sparse[name]
        np.testing.assert_array_equal(np.asarray(st.m), np.asarray(src.m))
        np.testing.assert_array_equal(np.asarray(st.v), np.asarray(src.v))
        np.testing.assert_array_equal(np.asarray(st.step), np.asarray(src.step))


def test_filename_template_sanitises_metric():
    name = checkpoint_filename(
        None, experiment_name="e", metric_name="ndcg@5/x", metric_value=None, epoch=2
    )
    assert name == "e_ndcgat5_x_epoch2.pt"
