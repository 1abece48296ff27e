import numpy as np
import pandas as pd

from ttamm.data import split_train_validation, split_train_validation_test
from ttamm.pipelines import EarlyStoppingController, extract_metric_value
from ttamm.evaluation import compute_ranking_metrics


def _frame():
    return pd.DataFrame(
        {
            "user_idx": [0, 0, 0, 1, 1, 2],
            "item_idx": [10, 11, 12, 20, 21, 30],
            "timestamp": [1, 2, 3, 5, 4, 9],
        }
    )


def test_latest_per_user_holdout():
    train, val = split_train_validation(_frame())
    # user 0 holds out ts=3 (item 12); user 1 holds out ts=5 (item 20);
    # user 2 has a single row -> no holdout.
    assert set(val["item_idx"]) == {12, 20}
    assert len(train) == 4
    assert 30 in set(train["item_idx"])


def test_split_with_seeded_test_fraction():
    train, val, test = split_train_validation_test(
        _frame(), train_fraction=None, test_fraction=0.4, seed=42
    )
    assert len(val) == 2
    assert len(test) == max(1, int(round(4 * 0.4)))
    assert len(train) + len(test) == 4
    # determinism
    train2, _, test2 = split_train_validation_test(
        _frame(), train_fraction=None, test_fraction=0.4, seed=42
    )
    assert list(test["item_idx"]) == list(test2["item_idx"])


def test_no_timestamp_column_keeps_all_train():
    df = _frame().drop(columns=["timestamp"])
    train, val, test = split_train_validation_test(
        df, train_fraction=None, test_fraction=0.0, seed=0
    )
    assert len(train) == len(df)
    assert val.empty and test.empty


def test_extract_metric_value_parses_at_k():
    summary = compute_ranking_metrics({0: [1, 2]}, {0: {1}}, [2])
    assert extract_metric_value(summary, "recall@2") == 1.0
    assert extract_metric_value(summary, "recall@7") is None
    assert extract_metric_value(summary, "mrr") == 1.0
    assert extract_metric_value(summary, "bogus@x") is None
    assert extract_metric_value(None, "recall@2") is None


def test_early_stopping_patience():
    ctrl = EarlyStoppingController(metric="recall@10", mode="max", patience=2)
    assert ctrl.update(0.5, 1) is False
    assert ctrl.update(0.4, 2) is False  # 1 epoch without improvement
    assert ctrl.update(0.4, 3) is True  # patience reached
    assert ctrl.best_epoch == 1


def test_early_stopping_min_mode_and_min_delta():
    ctrl = EarlyStoppingController(
        metric="val_loss", mode="min", patience=1, min_delta=0.1
    )
    assert ctrl.update(1.0, 1) is False
    assert ctrl.update(0.95, 2) is True  # improvement < min_delta
    ctrl2 = EarlyStoppingController(metric="m", mode="min", patience=1, min_delta=0.1)
    ctrl2.update(1.0, 1)
    assert ctrl2.update(0.8, 2) is False
    assert ctrl2.best_value == 0.8


def test_pick_steps_per_call_minimizes_dispatches():
    from ttamm.pipelines.training import _pick_steps_per_call

    assert _pick_steps_per_call(0) == 1
    assert _pick_steps_per_call(1) == 1
    # under the cap the whole epoch is one scanned dispatch
    assert _pick_steps_per_call(747) == 747
    # 747 = 9 * 83: with a tighter cap a perfect divisor wins (9 calls)
    assert _pick_steps_per_call(747, cap=128) == 83
    # exhaustive check of optimality for a range of sizes and caps
    for cap in (128, 8192):
        for n in (2, 5, 16, 100, 128, 129, 747, 1000, 9000):
            k = _pick_steps_per_call(n, cap=cap)
            cost = n // k + n % k
            best = min(n // c + n % c for c in range(1, min(cap, n) + 1))
            assert cost == best, (n, cap, k)
