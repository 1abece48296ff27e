import pytest

from ttamm.data import build_index_mapping


def test_order_preservation_and_roundtrip():
    mapping = build_index_mapping(["b", "a", "b", "c", "a"])
    assert mapping.index_to_id == ["b", "a", "c"]
    assert mapping.to_index("c") == 2
    assert mapping.to_id(0) == "b"
    assert len(mapping) == 3


def test_unknown_id_raises():
    mapping = build_index_mapping(["x"])
    with pytest.raises(KeyError):
        mapping.to_index("missing")
    with pytest.raises(IndexError):
        mapping.to_id(5)
