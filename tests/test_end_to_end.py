"""End-to-end smoke: full pipeline on a small synthetic dataset (CPU).

The reference has no end-to-end test (SURVEY §4 gap); this pins the whole
data -> train -> eval -> report flow, determinism, and artifact outputs.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from ttamm.data.synthetic import write_synthetic_csvs
from ttamm.pipelines import run_training
from ttamm.utils import clone_config


def _config(data_dir: Path, artifact_dir: Path) -> dict:
    return {
        "experiment": {
            "name": "e2e",
            "seed": 3,
            "benchmark_report": str(artifact_dir / "benchmark_summary.md"),
        },
        "data": {
            "root": str(data_dir),
            "books_file": "books.csv",
            "users_file": "users.csv",
            "test_fraction": 0.2,
            "min_user_interactions": 2,
            "min_item_interactions": 2,
            "feature_params": {"category_top_k": 20, "author_top_k": 20},
        },
        "model": {
            "user_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
                "feature_encoder": {
                    "type": "mlp",
                    "hidden_dims": [32],
                    "output_dim": 16,
                    "dropout": 0.1,
                },
                "fusion": "gated",
            },
            "item_encoder": {
                "type": "tower",
                "id_embedding": {"params": {"embedding_dim": 16, "sparse": True}},
                "feature_encoder": {
                    "type": "mlp",
                    "hidden_dims": [32],
                    "output_dim": 16,
                    "dropout": 0.1,
                },
                "fusion": "gated",
            },
            "similarity": "cosine",
            "adaptive_mimic": {"enabled": True},
        },
        "training": {
            "batch_size": 64,
            "num_epochs": 2,
            "learning_rate": 0.005,
            "weight_decay": 0.01,
            "optimizer": "adamw",
            "negatives_per_positive": 3,
            "loss_weights": {
                "mimic_user": 0.15,
                "mimic_item": 0.15,
                "category_alignment": 0.01,
            },
            "early_stopping": {
                "enabled": True,
                "metric": "recall@5",
                "mode": "max",
                "patience": 3,
            },
            "checkpointing": {
                "enabled": True,
                "dir": str(artifact_dir / "checkpoints"),
                "save_best_only": True,
                "keep_last": True,
            },
        },
        "evaluation": {
            "metrics_k": [5],
            "candidate_samples": 10,
            "user_batch_size": 32,
            "faiss": {
                "enabled": True,
                "index_path": str(artifact_dir / "items.index"),
                "embedding_path": str(artifact_dir / "item_embeddings.npy"),
            },
        },
        "recommendations": {"sample_users": 2, "top_k": 3},
        "diagnostics": {
            "item_sample_size": 10,
            "user_sample_size": 10,
            "neighbor_k": 3,
            "report_path": str(artifact_dir / "report.md"),
            "loss_plot_path": str(artifact_dir / "loss.png"),
            "embedding_summary_path": str(artifact_dir / "diag.json"),
        },
        "logging": {"level": "WARNING"},
    }


@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("synth")
    write_synthetic_csvs(
        data_dir, num_users=60, num_items=40, num_interactions=600, seed=5
    )
    return data_dir


def test_end_to_end_run_and_artifacts(synth_dir, tmp_path):
    artifact_dir = tmp_path / "artifacts"
    config = _config(synth_dir, artifact_dir)
    result = run_training(config)

    assert result.best_metric is not None
    assert len(result.history.train_loss) >= 1
    # losses are finite and training made progress
    assert np.isfinite(result.history.train_loss).all()
    assert (artifact_dir / "report.md").exists()
    assert (artifact_dir / "loss.png").exists()
    assert (artifact_dir / "items.index").exists()
    assert (artifact_dir / "item_embeddings.npy").exists()
    payload = json.loads((artifact_dir / "diag.json").read_text())
    assert payload["monitor_metric"] == "recall@5"
    gate_stats = payload["embedding_stats"]["fusion_gate"]
    for side in ("user", "item"):  # both towers are gated in this config
        assert gate_stats[side]["rows"] > 0
        assert 0.0 < gate_stats[side]["mean"] < 1.0
    assert "fusion gate" in (artifact_dir / "report.md").read_text()
    assert list((artifact_dir / "checkpoints").glob("*last.pt"))
    assert result.examples_per_second is not None and result.examples_per_second > 0

    # saved index is loadable and searchable
    from ttamm.serve import FlatIndex

    index = FlatIndex.load(artifact_dir / "items.index")
    emb = np.load(artifact_dir / "item_embeddings.npy")
    assert len(index) == emb.shape[0]
    scores, idx = index.search(emb[:2], k=3)
    assert idx.shape == (2, 3)
    # cosine mode: nearest neighbor of a row is itself
    assert idx[0, 0] == 0 and idx[1, 0] == 1


def test_serving_score_dtype_forced_and_auto(synth_dir, tmp_path):
    """The serving: config block controls the exported index precision:
    forced values skip the gate; `auto` runs the bf16 recall gate against
    the final validation eval and persists its decision in the header."""
    from ttamm.serve import FlatIndex

    artifact_dir = tmp_path / "forced"
    config = _config(synth_dir, artifact_dir)
    config["training"]["num_epochs"] = 1
    config["serving"] = {"score_dtype": "bfloat16"}
    run_training(config)
    assert FlatIndex.load(artifact_dir / "items.index").score_dtype == "bfloat16"

    artifact_dir = tmp_path / "auto"
    config = _config(synth_dir, artifact_dir)
    config["training"]["num_epochs"] = 1
    config["serving"] = {"score_dtype": "auto", "bf16_recall_gate": 0.002}
    run_training(config)
    # The gate's decision must be a valid persisted precision either way
    # (tiny noisy corpora legitimately fall on either side of the gate).
    assert FlatIndex.load(artifact_dir / "items.index").score_dtype in (
        "float32",
        "bfloat16",
    )


def test_sweep_grid_writes_ledger(synth_dir, tmp_path):
    artifact_dir = tmp_path / "artifacts"
    config = _config(synth_dir, artifact_dir)
    config["training"]["num_epochs"] = 1
    config["experiment"]["grid"] = {"training.learning_rate": [0.001, 0.01]}
    results = run_training(config)
    assert isinstance(results, list) and len(results) == 2
    ledger = (artifact_dir / "benchmark_summary.md").read_text()
    assert "training.learning_rate=0.001" in ledger
    assert "training.learning_rate=0.01" in ledger


def test_resume_from_checkpoint(synth_dir, tmp_path):
    artifact_dir = tmp_path / "artifacts"
    config = _config(synth_dir, artifact_dir)
    config["training"]["num_epochs"] = 1
    result = run_training(config)
    last = list((artifact_dir / "checkpoints").glob("*last.pt"))[0]

    config2 = clone_config(config)
    config2["training"]["num_epochs"] = 2
    config2["training"]["resume_from"] = str(last)
    result2 = run_training(config2)
    # resumed run trains only epoch 2
    assert len(result2.history.train_loss) == 1


def test_end_to_end_with_mesh(synth_dir, tmp_path):
    """Full pipeline with a 4x2 mesh over the virtual 8-device CPU set."""
    artifact_dir = tmp_path / "artifacts"
    config = _config(synth_dir, artifact_dir)
    config["training"]["num_epochs"] = 1
    config["mesh"] = {"data_parallel": 4, "model_parallel": 2}
    result = run_training(config)
    assert result.best_metric is not None
    assert np.isfinite(result.history.train_loss).all()
    assert (artifact_dir / "report.md").exists()


def test_dataset_cache_reused(synth_dir, tmp_path):
    artifact_dir = tmp_path / "artifacts"
    config = _config(synth_dir, artifact_dir)
    config["training"]["num_epochs"] = 1
    config["data"]["use_cache"] = True
    config["data"]["cache_dir"] = str(tmp_path / "cache")
    r1 = run_training(config)
    caches = list((tmp_path / "cache").glob("dataset_*.pkl"))
    assert len(caches) == 1
    # second run hits the cache and reproduces identical metrics
    r2 = run_training(config)
    assert r2.best_metric == r1.best_metric
    assert len(list((tmp_path / "cache").glob("dataset_*.pkl"))) == 1


def test_end_to_end_in_batch_softmax_logq(synth_dir, tmp_path):
    """Pipeline-level coverage of the corrected in-batch loss: the
    item_log_q table is built from the train split and the run trains
    to completion with finite losses and artifacts."""
    artifact_dir = tmp_path / "artifacts_ib"
    config = _config(synth_dir, artifact_dir)
    config["training"]["loss"] = "in_batch_softmax"
    result = run_training(config)
    assert result.best_metric is not None
    assert np.isfinite(result.history.train_loss).all()
    assert (artifact_dir / "report.md").exists()


@pytest.mark.slow_variant
def test_end_to_end_in_batch_softmax_plain_variant(synth_dir, tmp_path):
    """The plain (uncorrected) in-batch variant still runs when opted
    out. Split from the logq test (advisor r4: two full pipelines in one
    test doubled its wall time); deselect with -m "not slow_variant"."""
    artifact_dir2 = tmp_path / "artifacts_ib_plain"
    config2 = _config(synth_dir, artifact_dir2)
    config2["training"]["loss"] = "in_batch_softmax"
    config2["training"]["logq_correction"] = False
    config2["training"]["num_epochs"] = 1
    result2 = run_training(config2)
    assert np.isfinite(result2.history.train_loss).all()
