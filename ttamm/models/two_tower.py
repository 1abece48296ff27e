"""Two-tower model: orchestration of towers, similarity, and adaptive mimic.

Parity with ``src/models/two_tower.py:19-95`` re-designed functionally: the
model is a static :class:`ModelConfig` plus a params pytree split into

- ``tables``: embedding-like row tables (user/item ID tables + mimic
  augmentation tables) — the sharding/sparse-update candidates, and
- ``dense``: everything else (feature MLPs, gates, projections) — the
  data-parallel replicated part.

``model_forward`` reproduces the reference ``TwoTowerModel.forward`` output
dict (score + optional embeddings + optional mimic losses); the training
pipeline, like the reference's, drives towers/mimic directly (SURVEY §3.5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping

import jax
import jax.numpy as jnp

from .adaptive_mimic import init_mimic_tables, mimic_forward
from .encoders import TowerConfig, init_tower, parse_tower_config, tower_forward

Params = dict[str, Any]


@dataclass(frozen=True)
class ModelConfig:
    user_tower: TowerConfig
    item_tower: TowerConfig
    similarity: str = "cosine"  # 'cosine' | 'dot'
    mimic_enabled: bool = True
    mimic_init_std: float = 0.02
    # Route the mimic augmentation tables through sparse-row Adam (exactly
    # like `sparse: true` ID embeddings) instead of the reference's dense
    # AdamW. A scaling option: dense AdamW touches the FULL [rows, D]
    # table + both moments every step (~9x table bytes of HBM traffic),
    # which dominates the step beyond ~1M rows; sparse-row Adam keeps the
    # per-step cost batch-sized. Semantics follow torch's sparse-embedding
    # split (SparseAdam: lazy moments, no weight decay on untouched rows),
    # so it is OFF by default for reference parity.
    mimic_sparse: bool = False

    @property
    def embedding_dim(self) -> int:
        return self.user_tower.output_dim


def parse_model_config(
    model_cfg: Mapping[str, Any] | None,
    *,
    user_feature_dim: int,
    item_feature_dim: int,
) -> ModelConfig:
    """Resolve the YAML ``model:`` section (ref ``training.py:1243-1296``)."""
    cfg = dict(model_cfg or {})
    compute_dtype = str(cfg.get("precision", "float32")).lower()
    if compute_dtype in {"bf16", "bfloat16"}:
        compute_dtype = "bfloat16"
    elif compute_dtype in {"fp32", "float32"}:
        compute_dtype = "float32"
    else:
        raise ValueError(f"Unsupported model.precision: {compute_dtype}")
    user_tower = parse_tower_config(
        cfg.get("user_encoder", {}),
        feature_dim=user_feature_dim,
        compute_dtype=compute_dtype,
    )
    item_tower = parse_tower_config(
        cfg.get("item_encoder", {}),
        feature_dim=item_feature_dim,
        compute_dtype=compute_dtype,
    )
    similarity = str(cfg.get("similarity", "cosine")).lower()
    if similarity not in {"cosine", "dot"}:
        raise ValueError(f"Unsupported similarity function: {similarity}")

    mimic_cfg = dict(cfg.get("adaptive_mimic", {}) or {})
    mimic_enabled = bool(mimic_cfg.get("enabled", True))
    if mimic_enabled and user_tower.output_dim != item_tower.output_dim:
        raise ValueError(
            "Adaptive mimic requires user and item embedding dimensions to match."
        )
    return ModelConfig(
        user_tower=user_tower,
        item_tower=item_tower,
        similarity=similarity,
        mimic_enabled=mimic_enabled,
        mimic_init_std=float(mimic_cfg.get("init_std", 0.02)),
        mimic_sparse=bool(mimic_cfg.get("sparse", False)),
    )


def init_model(
    key: jax.Array,
    cfg: ModelConfig,
    *,
    num_users: int,
    num_items: int,
    table_extra_rows: int = 1,
    dtype=jnp.float32,
) -> tuple[Params, Params]:
    """Initialise ``(tables, dense)`` parameter pytrees.

    ``table_extra_rows`` appends scratch rows to every table on the
    sparse-row optimizer (scatter-padding targets) — the sparse ID tables,
    plus the mimic tables when ``mimic_sparse``; dense-updated tables stay
    exactly sized.
    """
    ukey, ikey, mkey = jax.random.split(key, 3)
    user_extra = table_extra_rows if cfg.user_tower.embedding.sparse else 0
    item_extra = table_extra_rows if cfg.item_tower.embedding.sparse else 0
    user_table, user_dense = init_tower(
        ukey,
        cfg.user_tower,
        num_embeddings=num_users,
        table_extra_rows=user_extra,
        dtype=dtype,
    )
    item_table, item_dense = init_tower(
        ikey,
        cfg.item_tower,
        num_embeddings=num_items,
        table_extra_rows=item_extra,
        dtype=dtype,
    )
    tables: Params = {"user_id": user_table, "item_id": item_table}
    dense: Params = {"user_tower": user_dense, "item_tower": item_dense}
    if cfg.mimic_enabled:
        tables.update(
            init_mimic_tables(
                mkey,
                num_users=num_users,
                num_items=num_items,
                embedding_dim=cfg.embedding_dim,
                init_std=cfg.mimic_init_std,
                extra_rows=table_extra_rows if cfg.mimic_sparse else 0,
                dtype=dtype,
            )
        )
    return tables, dense


def similarity_scores(
    cfg: ModelConfig, user_embedding: jax.Array, item_embedding: jax.Array
) -> jax.Array:
    """Row-wise similarity (cosine or dot) between matching rows."""
    if cfg.similarity == "cosine":
        u = user_embedding / jnp.maximum(
            jnp.linalg.norm(user_embedding, axis=-1, keepdims=True), 1e-8
        )
        v = item_embedding / jnp.maximum(
            jnp.linalg.norm(item_embedding, axis=-1, keepdims=True), 1e-8
        )
        return jnp.sum(u * v, axis=-1)
    return jnp.sum(user_embedding * item_embedding, axis=-1)


def encode_tower(
    tables: Params,
    dense: Params,
    cfg: ModelConfig,
    side: str,
    indices: jax.Array,
    features: jax.Array | None = None,
    *,
    train: bool = False,
    dropout_rng: jax.Array | None = None,
    augment_with_mimic: bool = False,
) -> jax.Array:
    """Gather + tower forward (+ optional mimic augmentation) for one side."""
    assert side in {"user", "item"}
    tower_cfg = cfg.user_tower if side == "user" else cfg.item_tower
    table = tables[f"{side}_id"]
    id_rows = jnp.take(table, indices, axis=0)
    emb = tower_forward(
        dense[f"{side}_tower"],
        tower_cfg,
        id_rows,
        features,
        train=train,
        dropout_rng=dropout_rng,
    )
    if augment_with_mimic and cfg.mimic_enabled:
        aug = jnp.take(tables[f"{side}_aug"], indices, axis=0)
        emb = emb + aug
    return emb


def model_forward(
    tables: Params,
    dense: Params,
    cfg: ModelConfig,
    user_inputs: Mapping[str, jax.Array],
    item_inputs: Mapping[str, jax.Array],
    *,
    return_embeddings: bool = False,
    train: bool = False,
    dropout_rng: jax.Array | None = None,
) -> dict[str, jax.Array]:
    """Full forward on positive pairs, mirroring ``TwoTowerModel.forward``.

    Inputs are mappings with ``indices`` and optional ``features``. Output
    keys: ``score``, plus ``user_embedding``/``item_embedding`` when
    requested and ``mimic_user_loss``/``mimic_item_loss`` when mimic is on.
    """
    u_idx = user_inputs["indices"]
    i_idx = item_inputs["indices"]
    rng_u = rng_i = None
    if dropout_rng is not None:
        rng_u, rng_i = jax.random.split(dropout_rng)

    user_embedding = encode_tower(
        tables, dense, cfg, "user", u_idx, user_inputs.get("features"),
        train=train, dropout_rng=rng_u,
    )
    item_embedding = encode_tower(
        tables, dense, cfg, "item", i_idx, item_inputs.get("features"),
        train=train, dropout_rng=rng_i,
    )

    outputs: dict[str, jax.Array] = {}
    if cfg.mimic_enabled:
        user_aug = jnp.take(tables["user_aug"], u_idx, axis=0)
        item_aug = jnp.take(tables["item_aug"], i_idx, axis=0)
        user_embedding, item_embedding, mu_loss, mi_loss = mimic_forward(
            user_aug, item_aug, user_embedding, item_embedding
        )
        outputs["mimic_user_loss"] = mu_loss
        outputs["mimic_item_loss"] = mi_loss

    if return_embeddings:
        outputs["user_embedding"] = user_embedding
        outputs["item_embedding"] = item_embedding

    outputs["score"] = similarity_scores(cfg, user_embedding, item_embedding)
    return outputs
