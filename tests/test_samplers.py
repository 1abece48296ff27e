import jax
import numpy as np
import pytest

from ttamm.data import pack_positives
from ttamm.ops import sample_negative_items


def test_negatives_exclude_positives_and_shape():
    num_items = 20
    positives = {0: {1, 2, 3}, 1: {4, 5}}
    packed = pack_positives(positives, num_users=2, num_items=num_items)
    rows = np.asarray(packed.rows)

    batch_rows = rows[np.array([0, 1, 0, 1])]
    negs = np.asarray(
        sample_negative_items(
            jax.random.key(0),
            batch_rows,
            num_items=num_items,
            num_negatives=6,
        )
    )
    assert negs.shape == (4, 6)
    assert negs.min() >= 0 and negs.max() < num_items
    for row, user in enumerate([0, 1, 0, 1]):
        assert not (set(negs[row].tolist()) & positives[user])


def test_dense_positive_sets_still_avoid_collisions():
    # User has interacted with all but 3 of 10 items: rejection must still
    # land only on the free items (the reference re-draws up to 10 times).
    num_items = 10
    positives = {0: set(range(7))}
    packed = pack_positives(positives, num_users=1, num_items=num_items)
    rows = np.asarray(packed.rows)
    negs = np.asarray(
        sample_negative_items(
            jax.random.key(1),
            np.repeat(rows, 64, axis=0),
            num_items=num_items,
            num_negatives=4,
            num_rounds=32,
        )
    )
    assert set(np.unique(negs).tolist()) <= {7, 8, 9}


def test_invalid_args_raise():
    rows = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError):
        sample_negative_items(jax.random.key(0), rows, num_items=5, num_negatives=0)
    with pytest.raises(ValueError):
        sample_negative_items(jax.random.key(0), rows, num_items=1, num_negatives=2)
