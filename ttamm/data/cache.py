"""Preprocessed-dataset cache: skip minutes of pandas work on reruns.

The reference re-runs the full CSV -> prune -> index -> feature pipeline on
every experiment (its preprocess CLI even warns serialization is
unimplemented, ref ``scripts/preprocess.py:61-64``). Here
``data.use_cache: true`` keys a pickle of the built
:class:`~ttamm.data.preprocessing.TrainingDataset` on the input files'
(size, mtime) and every config knob that affects preprocessing; sweeps over
model/training params then reuse one cache entry.
"""

from __future__ import annotations

import hashlib
import json
import pickle
from pathlib import Path
from typing import Any, Mapping

from .preprocessing import TrainingDataset
from ..utils.logging import get_logger

logger = get_logger("data")

_CACHE_VERSION = 1


def dataset_cache_key(
    data_dir: Path,
    *,
    books_file: str | None,
    users_file: str | None,
    books_limit: int | None,
    interactions_limit: int | None,
    min_user_interactions: int,
    min_item_interactions: int,
    feature_config: Mapping[str, Any] | None,
) -> str | None:
    """Stable key over input files + preprocessing knobs; None when the
    input files cannot be found (fallback paths in play)."""
    parts: dict[str, Any] = {
        "version": _CACHE_VERSION,
        "books_limit": books_limit,
        "interactions_limit": interactions_limit,
        "min_user": min_user_interactions,
        "min_item": min_item_interactions,
        "features": dict(feature_config or {}),
    }
    for label, name in (("books", books_file or "books.csv"),
                        ("users", users_file or "users.csv")):
        path = Path(data_dir) / name
        if not path.exists():
            return None
        stat = path.stat()
        parts[label] = [name, stat.st_size, int(stat.st_mtime)]
    blob = json.dumps(parts, sort_keys=True, default=str).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:24]


def cache_path(cache_dir: Path | str, key: str) -> Path:
    return Path(cache_dir) / f"dataset_{key}.pkl"


def save_training_dataset(dataset: TrainingDataset, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as handle:
        pickle.dump(dataset, handle, protocol=pickle.HIGHEST_PROTOCOL)
    tmp.replace(path)
    logger.info("Cached preprocessed dataset -> %s", path)


def load_training_dataset(path: Path) -> TrainingDataset | None:
    try:
        with open(path, "rb") as handle:
            dataset = pickle.load(handle)
        if isinstance(dataset, TrainingDataset):
            logger.info("Loaded preprocessed dataset from cache %s", path)
            return dataset
    except Exception as exc:  # corrupt/stale cache: rebuild
        logger.warning("Ignoring unreadable dataset cache %s (%s)", path, exc)
    return None
