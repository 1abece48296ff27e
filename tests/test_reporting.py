import json
from pathlib import Path

from ttamm.evaluation import compute_ranking_metrics
from ttamm.pipelines import TrainingHistory, TrainingResult
from ttamm.reporting import (
    save_loss_curves,
    write_benchmark_report,
    write_embedding_summary,
    write_recommendation_report,
)


def _stats():
    base = {"mean": 1.0, "std": 0.1, "min": 0.5, "max": 1.5, "median": 1.0}
    return {
        "user_norms": dict(base, label="user", count=3),
        "item_norms": dict(base, label="item", count=3),
        "item_neighbor_overlap": {
            "sampled_items": 3,
            "category_overlap_mean": 0.4,
            "category_overlap_std": 0.1,
            "k": 5,
        },
        "user_alignment": {"aligned_users": 3, "cosine_mean": 0.8, "cosine_std": 0.05},
    }


def test_save_loss_curves_writes_png(tmp_path: Path):
    path = save_loss_curves(
        {"Train": [1.0, 0.5], "Validation": [1.1, 0.6]},
        output_path=tmp_path / "curves.png",
    )
    assert path.exists()
    assert path.stat().st_size > 0


def test_save_loss_curves_empty_raises(tmp_path: Path):
    import pytest

    with pytest.raises(ValueError):
        save_loss_curves({"Train": []}, output_path=tmp_path / "x.png")


def test_recommendation_report_content(tmp_path: Path):
    metrics = compute_ranking_metrics({0: [1, 2]}, {0: {1}}, [1, 2])
    history = TrainingHistory(
        train_loss=[0.9, 0.5], val_loss=[1.0, 0.6], test_loss=[1.1, 0.7]
    )
    recs = [
        {
            "user_id": "U1",
            "user_idx": 0,
            "category_match": 0.5,
            "author_match": 0.0,
            "history_categories": {"History"},
            "history_authors": set(),
            "recommendations": [
                {
                    "asin": "A1",
                    "title": "Sample Book",
                    "author": "Auth",
                    "categories": ["History"],
                }
            ],
        }
    ]
    corr = [{"feature": "numeric:price", "pearson_r": 0.5, "p_value": 0.01}]
    report = tmp_path / "report.md"
    plot = tmp_path / "loss.png"
    plot.write_bytes(b"png")
    write_recommendation_report(
        report,
        metrics_summary=metrics,
        embedding_stats=_stats(),
        recommendations=recs,
        loss_plot_path=plot,
        history=history,
        monitor_metric="recall@2",
        best_epoch=2,
        feature_correlations=corr,
    )
    text = report.read_text(encoding="utf-8")
    assert "![Loss curves]" in text
    assert "numeric:price" in text
    assert "Sample Book" in text
    assert "Best recall@2 achieved at epoch 2" in text
    assert "Recall" in text and "@1=" in text


def test_embedding_summary_structure(tmp_path: Path):
    path = tmp_path / "diag.json"
    write_embedding_summary(
        path,
        embedding_stats=_stats(),
        mimic_stats={"user": {"mean_norm": 0.5}, "item": {"mean_norm": 0.6}},
        feature_correlations=[],
        monitor_metric="recall@10",
        best_epoch=3,
    )
    payload = json.loads(path.read_text(encoding="utf-8"))
    assert set(payload) == {
        "embedding_stats",
        "adaptive_mimic",
        "feature_correlations",
        "monitor_metric",
        "best_epoch",
    }
    assert payload["best_epoch"] == 3
    assert payload["adaptive_mimic"]["user"]["mean_norm"] == 0.5


def test_benchmark_report(tmp_path: Path):
    result = TrainingResult(
        config={"training": {"optimizer": "adamw"}},
        history=TrainingHistory(),
        runtime_seconds=12.5,
        best_metric=0.1,
        best_epoch=2,
        best_checkpoint_path=None,
        val_metrics=None,
        test_metrics=None,
        overrides={"training.learning_rate": 0.01},
        examples_per_second=1234.0,
    )
    path = tmp_path / "bench.md"
    write_benchmark_report(path, [result])
    text = path.read_text(encoding="utf-8")
    assert "training.learning_rate=0.01" in text
    assert "adamw" in text
    assert "1234" in text
