#!/usr/bin/env python
"""Preprocess raw CSVs and cache the packed training arrays.

Extends the reference's preprocess CLI (which printed counts but never
serialised, ref ``scripts/preprocess.py:61-64``): this one actually writes
the model-ready arrays (features, index maps, packed positives) to
``data.cache_dir`` as ``.npz`` + JSON vocabularies.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import asdict
from pathlib import Path

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))


def main() -> None:
    parser = argparse.ArgumentParser(description="Preprocess the dataset.")
    parser.add_argument(
        "--config", type=Path, default=REPO_ROOT / "configs" / "default.yaml"
    )
    args = parser.parse_args()

    from ttamm.data import (
        build_item_categories,
        build_training_dataset,
        load_dataset,
        pack_positives,
    )
    from ttamm.utils import load_config

    config = load_config(args.config)
    data_cfg = dict(config.get("data", {}))
    dataset = load_dataset(
        Path(data_cfg.get("root", "data")),
        books_file=data_cfg.get("books_file"),
        interactions_file=data_cfg.get("users_file"),
        books_limit=data_cfg.get("books_limit"),
        interactions_limit=data_cfg.get("interactions_limit"),
    )
    training = build_training_dataset(
        dataset,
        feature_config=data_cfg.get("feature_params", {}),
        min_user_interactions=int(data_cfg.get("min_user_interactions", 0)),
        min_item_interactions=int(data_cfg.get("min_item_interactions", 0)),
    )
    num_users = len(training.user_mapping)
    num_items = len(training.item_mapping)
    print(f"users={num_users} items={num_items} interactions={len(training.interactions)}")
    print(
        f"item_feature_dim={training.item_feature_matrix.shape[1]} "
        f"user_feature_dim={training.user_feature_matrix.shape[1]}"
    )

    cache_dir = Path(data_cfg.get("cache_dir", "artifacts/cache"))
    cache_dir.mkdir(parents=True, exist_ok=True)
    packed = pack_positives(
        training.user_positive_items, num_users=num_users, num_items=num_items
    )
    categories = build_item_categories(training.items, num_items=num_items)
    np.savez_compressed(
        cache_dir / "training_arrays.npz",
        item_features=training.item_feature_matrix,
        user_features=training.user_feature_matrix,
        positive_rows=packed.rows,
        positive_counts=packed.counts,
        user_idx=training.interactions["user_idx"].to_numpy(np.int32),
        item_idx=training.interactions["item_idx"].to_numpy(np.int32),
        category_ids=(
            categories.category_ids if categories is not None else np.empty(0)
        ),
    )
    (cache_dir / "vocab.json").write_text(
        json.dumps(
            {
                "user_ids": training.user_mapping.index_to_id,
                "item_ids": training.item_mapping.index_to_id,
                "feature_metadata": asdict(training.feature_metadata),
                "category_names": (
                    categories.category_names if categories is not None else []
                ),
            }
        ),
        encoding="utf-8",
    )
    print(f"cached arrays -> {cache_dir}")


if __name__ == "__main__":
    main()
