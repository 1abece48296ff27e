import pandas as pd

from ttamm.data import DatasetArtifacts, build_training_dataset


def _artifacts() -> DatasetArtifacts:
    books = pd.DataFrame(
        {
            "title": ["T1", "T2", "T3"],
            "author": ["A", "B", "C"],
            "average_rating": [4.0, 3.0, 5.0],
            "rating_number": [10, 20, 30],
            "price": [1.0, 2.0, 3.0],
            "categories": ["[\"Books\", \"X\"]"] * 3,
            "parent_asin": ["A1", "A2", "A3"],
        }
    )
    interactions = pd.DataFrame(
        {
            "parent_asin": ["A1", "A2", "A1", "A3"],
            "userId": ["U1", "U1", "U2", "U2"],
            "timestamp": [1, 2, 3, 4],
        }
    )
    return DatasetArtifacts(books=books, interactions=interactions)


def test_basic_structure_and_mappings():
    ds = build_training_dataset(_artifacts())
    assert len(ds.user_mapping) == 2
    assert len(ds.item_mapping) == 3
    assert {"user_idx", "item_idx"} <= set(ds.interactions.columns)
    assert ds.user_positive_items[0] == {0, 1}
    assert ds.user_positive_items[1] == {0, 2}
    assert ds.item_feature_matrix.shape[0] == 3
    assert ds.user_feature_matrix.shape == (2, ds.item_feature_matrix.shape[1])


def test_fixpoint_low_frequency_filtering():
    """Alternating item>=N / user>=M pruning converges to a fixpoint.

    With min_item=2, min_user=2: A2/A3 drop (1 interaction each), then U1/U2
    each retain only A1 interactions -> both keep >=1... iterate until only
    the stable (U1, A1), (U2, A1) core or empty remains, matching the
    reference fixpoint semantics (ref preprocessing.py:86-114).
    """
    books = pd.DataFrame(
        {
            "title": ["T1", "T2"],
            "author": ["A", "B"],
            "average_rating": [4.0, 3.0],
            "rating_number": [1, 2],
            "price": [1.0, 2.0],
            "categories": ["[\"Books\"]"] * 2,
            "parent_asin": ["A1", "A2"],
        }
    )
    interactions = pd.DataFrame(
        {
            "parent_asin": ["A1", "A1", "A2"],
            "userId": ["U1", "U2", "U2"],
            "timestamp": [1, 2, 3],
        }
    )
    ds = build_training_dataset(
        DatasetArtifacts(books=books, interactions=interactions),
        min_user_interactions=1,
        min_item_interactions=2,
    )
    # A2 has 1 interaction -> dropped; both users keep their A1 rows.
    assert set(ds.interactions["parent_asin"]) == {"A1"}
    assert len(ds.item_mapping) == 1
    assert len(ds.user_mapping) == 2


def test_unknown_items_dropped():
    arts = _artifacts()
    interactions = pd.concat(
        [
            arts.interactions,
            pd.DataFrame(
                {"parent_asin": ["ZZ"], "userId": ["U3"], "timestamp": [9]}
            ),
        ],
        ignore_index=True,
    )
    ds = build_training_dataset(
        DatasetArtifacts(books=arts.books, interactions=interactions)
    )
    assert "ZZ" not in set(ds.interactions["parent_asin"])
    assert len(ds.user_mapping) == 2
