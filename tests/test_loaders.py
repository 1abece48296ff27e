"""Loader tests (a coverage gap in the reference — SURVEY §4): trimmed-CSV
fallback, dtype coercion, row limits, unknown-ASIN filtering, and an
end-to-end preprocessing smoke on the reference's bundled 10-row samples."""

from pathlib import Path

import pandas as pd
import pytest

from ttamm.data.loaders import load_books, load_dataset, load_interactions
from ttamm.data.preprocessing import build_training_dataset

DATA_DIR = Path(__file__).resolve().parent.parent / "data"


def test_missing_default_falls_back_to_trimmed(tmp_path):
    for name in ("books_trimmed.csv", "users_trimmed.csv"):
        (tmp_path / name).write_bytes((DATA_DIR / name).read_bytes())
    books = load_books(tmp_path)  # no books.csv -> trimmed sample
    interactions = load_interactions(tmp_path)
    assert len(books) == 10
    assert len(interactions) == 10


def test_explicit_missing_filename_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_books(tmp_path, filename="does_not_exist.csv")


def test_interaction_dtypes_and_limit():
    interactions = load_interactions(
        DATA_DIR, filename="users_trimmed.csv", limit=4
    )
    assert len(interactions) == 4
    assert str(interactions["parent_asin"].dtype) == "string"
    assert str(interactions["userId"].dtype) == "string"
    assert str(interactions["timestamp"].dtype) == "Int64"


def test_unknown_asins_dropped(tmp_path):
    pd.DataFrame(
        {
            "title": ["A"],
            "author": ["X"],
            "average_rating": [4.0],
            "rating_number": [3],
            "price": [9.99],
            "categories": ['["Books", "History"]'],
            "parent_asin": ["KEEP"],
        }
    ).to_csv(tmp_path / "books.csv", index=False)
    pd.DataFrame(
        {
            "parent_asin": ["KEEP", "DROP"],
            "userId": ["u1", "u1"],
            "timestamp": [1, 2],
        }
    ).to_csv(tmp_path / "users.csv", index=False)
    artifacts = load_dataset(tmp_path)
    assert list(artifacts.interactions["parent_asin"]) == ["KEEP"]


def test_trimmed_samples_preprocess_end_to_end():
    """The reference's bundled 10-row samples are disjoint heads (no ASIN
    overlap), so every interaction is dropped by the books-subset filter —
    preprocessing must survive that gracefully (the reference's empty-data
    early-return philosophy, SURVEY §5)."""
    artifacts = load_dataset(
        DATA_DIR,
        books_file="books_trimmed.csv",
        interactions_file="users_trimmed.csv",
    )
    assert len(artifacts.books) == 10
    assert artifacts.interactions.empty  # disjoint samples -> all filtered
    ds = build_training_dataset(artifacts)
    n_items = len(ds.item_mapping.id_to_index)
    assert n_items == 10
    assert len(ds.user_mapping.id_to_index) == 0
    assert ds.item_feature_matrix.shape[0] == n_items
