"""Experiment orchestration: data -> compiled train loop -> eval -> reports.

JAX re-design of the reference pipeline
(``src/pipelines/training.py:1168-1897``). The experiment flow, config
surface, split semantics, early-stopping/checkpoint behaviour, and the four
artifact types (Markdown report, JSON diagnostics, loss-curve PNG,
benchmark ledger) match the reference; the execution model does not:

- the entire hot path (negative sampling, towers, mimic, losses, hybrid
  optimizer) is ONE jit-compiled step (``ttamm.train.step``);
- retrieval evaluation runs batched on device via the chunked MIPS top-K
  kernel instead of per-user FAISS queries;
- item-corpus encoding is a device-resident scan, re-run per epoch exactly
  like the reference's per-epoch FAISS rebuild (ref ``:1500``);
- checkpoints are restorable (resume is supported via
  ``training.resume_from``; the reference only ever saved).

RNG note: the reference seeds Python/numpy/torch globally; exact RNG stream
parity across frameworks is impossible, so parity targets are statistical
(recall@10/NDCG@10 within run-to-run variance — BASELINE.md).
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd

from ..data import (
    build_item_categories,
    build_training_dataset,
    interaction_arrays,
    load_dataset,
    pack_positives,
    parse_category_tokens,
    positives_from_frame,
    split_train_validation_test,
)
from ..evaluation import (
    analyze_item_neighbors,
    compute_feature_correlations,
    compute_mimic_statistics,
    summarize_gate_values,
    compute_ranking_metrics,
    build_eval_plan,
    evaluate_retrieval,
    evaluate_retrieval_metrics,
    summarize_embedding_norms,
    summarize_user_alignment,
)
from ..evaluation.retrieval import encode_user_batch
from ..models import ModelConfig, parse_model_config
from ..ops.topk import mips_topk
from ..reporting import (
    save_loss_curves,
    write_benchmark_report,
    write_embedding_summary,
    write_recommendation_report,
)
from ..serve.flat_index import build_flat_index
from ..train.checkpoint import (
    AsyncCheckpointer,
    load_checkpoint,
    save_checkpoint,
    state_to_host,
)
from ..train.optim import parse_dense_opt_config
from ..train.state import BatchData, TrainState, create_train_state
from ..train.step import (
    TrainStepConfig,
    encode_corpus,
    make_eval_loss_step,
    make_multi_eval_loss_step,
    make_multi_train_step,
    make_train_step,
)
from ..utils import configure_logging, expand_grid, get_logger

logger = get_logger("pipeline")


@dataclass
class TrainingHistory:
    train_loss: list[float] = field(default_factory=list)
    step_loss: list[float] = field(default_factory=list)  # per optimizer step
    val_loss: list[float] = field(default_factory=list)
    test_loss: list[float] = field(default_factory=list)
    monitored_metric: list[float] = field(default_factory=list)


@dataclass
class TrainingResult:
    config: Mapping[str, Any]
    history: TrainingHistory
    runtime_seconds: float
    best_metric: float | None
    best_epoch: int | None
    best_checkpoint_path: Path | None
    val_metrics: Any | None
    test_metrics: Any | None
    overrides: Mapping[str, Any] | None = None
    loss_plot_path: Path | None = None
    embedding_summary_path: Path | None = None
    examples_per_second: float | None = None


@dataclass
class EarlyStoppingController:
    """max/min monitored-metric controller (ref ``training.py:85-116``)."""

    metric: str
    mode: str = "max"
    patience: int = 3
    min_delta: float = 0.0
    best_value: float | None = None
    best_epoch: int | None = None
    epochs_without_improvement: int = 0

    def update(self, value: float | None, epoch: int) -> bool:
        if value is None:
            return False
        if self.best_value is None:
            improved = True
        elif self.mode == "max":
            improved = value > (self.best_value + self.min_delta)
        else:
            improved = value < (self.best_value - self.min_delta)
        if improved:
            self.best_value = value
            self.best_epoch = epoch
            self.epochs_without_improvement = 0
            return False
        self.epochs_without_improvement += 1
        return self.epochs_without_improvement >= max(self.patience, 1)


def extract_metric_value(metrics_summary: Any, metric: str) -> float | None:
    """Parse ``recall@10``-style monitor names (ref ``training.py:119-138``)."""
    if metrics_summary is None:
        return None
    metric = metric.lower()
    if "@" in metric:
        prefix, k_str = metric.split("@", 1)
        try:
            k = int(k_str)
        except ValueError:
            return None
        table = getattr(metrics_summary, prefix, None)
        if table is None:
            return None
        return table.get(k)
    value = getattr(metrics_summary, metric, None)
    if isinstance(value, (int, float)):
        return float(value)
    return None


def _seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def _clone_state_device(state: TrainState) -> TrainState:
    """Device-side deep copy of the best state (the reference clones to CPU,
    ref ``training.py:141-147``; a device copy avoids a full host
    transfer per improvement — device memory holds two states)."""
    return jax.tree.map(jnp.copy, state)


def _state_to_device(state: TrainState) -> TrainState:
    return jax.tree.map(jnp.asarray, state)


def _build_user_profile(
    items_lookup: pd.DataFrame, interactions: pd.DataFrame, user_idx: int
) -> dict[str, set[str]]:
    """Category/author history profile for one user (ref ``:312-327``,
    restricted to the sampled users instead of all users)."""
    categories: set[str] = set()
    authors: set[str] = set()
    group = interactions[interactions["user_idx"] == user_idx]
    for item_idx in group["item_idx"]:
        if item_idx not in items_lookup.index:
            continue
        row = items_lookup.loc[item_idx]
        categories.update(parse_category_tokens(row.get("categories")))
        author = row.get("author")
        if isinstance(author, str) and author:
            authors.add(author.strip())
    return {"categories": categories, "authors": authors}


def _log_recommendations(
    state: TrainState,
    data: BatchData,
    model_cfg: ModelConfig,
    training_dataset,
    item_embeddings,
    *,
    sample_users: int,
    top_k: int,
) -> list[dict[str, Any]]:
    """Qualitative sample recommendations (ref ``training.py:1046-1137``):
    full-corpus MIPS per sampled user, history filtered, metadata joined."""
    results: list[dict[str, Any]] = []
    if sample_users <= 0:
        return results
    num_users = len(training_dataset.user_mapping)
    num_items = len(training_dataset.item_mapping)
    if num_users == 0 or num_items == 0:
        return results

    chosen_users = random.sample(
        list(range(num_users)), k=min(sample_users, num_users)
    )
    items_df = training_dataset.items.set_index("item_idx")
    users_df = training_dataset.users.set_index("user_idx")
    cosine = model_cfg.similarity == "cosine"
    if cosine:
        item_embeddings = item_embeddings / jnp.maximum(
            jnp.linalg.norm(item_embeddings, axis=-1, keepdims=True), 1e-12
        )

    u_idx = jnp.asarray(np.asarray(chosen_users, np.int32))
    queries = encode_user_batch(state, data, model_cfg, u_idx)
    max_hist = max(
        (len(training_dataset.user_positive_items.get(u, ())) for u in chosen_users),
        default=0,
    )
    deep_k = min(top_k + max_hist, num_items)
    _, idx = mips_topk(
        queries, item_embeddings, k=deep_k, normalize_queries=cosine
    )
    idx_np = np.asarray(idx)

    for row, user_idx in enumerate(chosen_users):
        positives = training_dataset.user_positive_items.get(int(user_idx), set())
        recommended = [
            int(i) for i in idx_np[row] if int(i) not in positives
        ][:top_k]

        display_user = users_df.loc[user_idx]["userId"]
        profile = _build_user_profile(
            items_df, training_dataset.interactions, int(user_idx)
        )

        recommendations = []
        category_matches = 0
        author_matches = 0
        for item_idx in recommended:
            if item_idx not in items_df.index:
                continue
            item_row = items_df.loc[item_idx]
            categories = set(parse_category_tokens(item_row.get("categories")))
            author = (
                item_row.get("author")
                if isinstance(item_row.get("author"), str)
                else ""
            )
            if categories & profile["categories"]:
                category_matches += 1
            if author and author in profile["authors"]:
                author_matches += 1
            recommendations.append(
                {
                    "asin": item_row.get("parent_asin", ""),
                    "title": item_row.get("title", "<unknown>"),
                    "author": author,
                    "categories": sorted(categories)[:5],
                }
            )

        total = max(len(recommendations), 1)
        logger.info(
            "User %s | Top %d recommendations", display_user, len(recommendations)
        )
        results.append(
            {
                "user_id": display_user,
                "user_idx": int(user_idx),
                "recommendations": recommendations,
                "category_match": category_matches / total,
                "author_match": author_matches / total,
                "history_categories": profile["categories"],
                "history_authors": profile["authors"],
            }
        )
    return results


def _pick_steps_per_call(num_full_batches: int, cap: int = 8192) -> int:
    """Scan length K minimizing device dispatches per epoch.

    An epoch issues ``num_full//K`` scanned calls plus ``num_full % K``
    single-step calls for the tail chunk; each dispatch costs host time,
    so pick the K <= cap that minimizes their sum. Whenever the epoch fits under the cap that is
    K == num_full: the entire epoch's train loop becomes ONE ``lax.scan``
    dispatch (scan length does not affect compile time, and the epoch's
    batch indices are uploaded as one array either way).
    """
    if num_full_batches <= 1:
        return max(num_full_batches, 1)
    best_k, best_cost = 1, num_full_batches
    for k in range(2, min(cap, num_full_batches) + 1):
        cost = num_full_batches // k + num_full_batches % k
        if cost < best_cost:
            best_k, best_cost = k, cost
    return best_k


def _dataset_loss(
    eval_step, multi_eval_step, state, data, users, items, batch_size, key
) -> float:
    """Sample-weighted mean eval loss over a split (ref ``:836-914``).

    Full batches go through the scanned multi-batch step (one device call);
    the remainder uses the single step."""
    if len(users) == 0:
        return 0.0
    total = 0.0
    count = 0
    num_full = len(users) // batch_size
    full = num_full * batch_size
    if num_full > 0:
        losses = multi_eval_step(
            state,
            data,
            jnp.asarray(users[:full].reshape(num_full, batch_size)),
            jnp.asarray(items[:full].reshape(num_full, batch_size)),
            key,
        )
        total += float(np.sum(np.asarray(losses))) * batch_size
        count += full
    if full < len(users):
        loss = eval_step(
            state,
            data,
            jnp.asarray(users[full:]),
            jnp.asarray(items[full:]),
            jax.random.fold_in(key, 999_999),
        )
        total += float(loss) * (len(users) - full)
        count += len(users) - full
    return total / max(count, 1)


def run_single_experiment(
    config: Mapping[str, Any],
    overrides: Mapping[str, Any] | None = None,
) -> TrainingResult:
    config = dict(config)
    removed = sorted(
        {"use_pallas", "cal_use_pallas"} & set(config.get("training") or {})
    )
    if removed:
        raise ValueError(
            f"training.{removed[0]} is no longer a setting: the Pallas "
            "kernels it selected were removed and every path runs through "
            "XLA. Delete the key from the config."
        )
    configure_logging(str((config.get("logging") or {}).get("level", "INFO")))

    experiment_cfg = dict(config.get("experiment", {}))
    seed = int(experiment_cfg.get("seed", 0))
    if "seed" in experiment_cfg:
        _seed_everything(seed)
    root_key = jax.random.key(seed)

    start_time = time.time()
    experiment_name = str(experiment_cfg.get("name", "experiment"))

    # ------------------------------------------------------------------ data
    data_config = dict(config.get("data", {}))
    data_dir = Path(data_config.get("root", "data"))

    from ..data.cache import (
        cache_path,
        dataset_cache_key,
        load_training_dataset,
        save_training_dataset,
    )

    use_cache = bool(data_config.get("use_cache", False))
    cache_dir = Path(data_config.get("cache_dir", "artifacts/cache"))
    cache_key = (
        dataset_cache_key(
            data_dir,
            books_file=data_config.get("books_file"),
            users_file=data_config.get("users_file"),
            books_limit=data_config.get("books_limit"),
            interactions_limit=data_config.get("interactions_limit"),
            min_user_interactions=int(data_config.get("min_user_interactions", 0)),
            min_item_interactions=int(data_config.get("min_item_interactions", 0)),
            feature_config=data_config.get("feature_params", {}),
        )
        if use_cache
        else None
    )
    training_dataset = None
    if cache_key is not None:
        training_dataset = load_training_dataset(cache_path(cache_dir, cache_key))

    if training_dataset is None:
        logger.info("Loading raw datasets from %s", data_dir)
        dataset = load_dataset(
            data_dir,
            books_file=data_config.get("books_file"),
            interactions_file=data_config.get("users_file"),
            books_limit=data_config.get("books_limit"),
            interactions_limit=data_config.get("interactions_limit"),
        )
        training_dataset = build_training_dataset(
            dataset,
            stage="train",
            feature_config=data_config.get("feature_params", {}),
            min_user_interactions=int(data_config.get("min_user_interactions", 0)),
            min_item_interactions=int(data_config.get("min_item_interactions", 0)),
        )
        if cache_key is not None:
            save_training_dataset(
                training_dataset, cache_path(cache_dir, cache_key)
            )
    num_users = len(training_dataset.user_mapping)
    num_items = len(training_dataset.item_mapping)
    logger.info(
        "Dataset | users=%d items=%d interactions=%d feature_dim(item=%d user=%d)",
        num_users,
        num_items,
        len(training_dataset.interactions),
        training_dataset.item_feature_matrix.shape[1],
        training_dataset.user_feature_matrix.shape[1],
    )

    train_df, val_df, test_df = split_train_validation_test(
        training_dataset.interactions,
        train_fraction=data_config.get("train_fraction"),
        test_fraction=data_config.get("test_fraction"),
        seed=seed,
    )
    logger.info(
        "Split | train=%d validation=%d test=%d", len(train_df), len(val_df), len(test_df)
    )

    # -------------------------------------------------------------- training cfg
    training_config = dict(config.get("training", {}))
    batch_size = int(training_config.get("batch_size", 512))
    num_epochs = int(training_config.get("num_epochs", 10))
    negatives_per_positive = int(training_config.get("negatives_per_positive", 5))
    gradient_clip_norm = training_config.get("gradient_clip_norm")
    loss_weights = dict(training_config.get("loss_weights", {}))

    model_config_raw = dict(config.get("model", {}))
    model_cfg = parse_model_config(
        model_config_raw,
        user_feature_dim=training_dataset.user_feature_matrix.shape[1],
        item_feature_dim=training_dataset.item_feature_matrix.shape[1],
    )

    history = TrainingHistory()
    empty_result = lambda: TrainingResult(  # noqa: E731
        config=config,
        history=history,
        runtime_seconds=time.time() - start_time,
        best_metric=None,
        best_epoch=None,
        best_checkpoint_path=None,
        val_metrics=None,
        test_metrics=None,
        overrides=overrides,
    )
    if train_df.empty or num_users == 0 or num_items == 0:
        logger.warning("No training interactions available; exiting early.")
        return empty_result()

    # -------------------------------------------------------------- device data
    categories = build_item_categories(training_dataset.items, num_items=num_items)
    positives_cap = data_config.get("positives_cap")
    packed_positives = pack_positives(
        training_dataset.user_positive_items,
        num_users=num_users,
        num_items=num_items,
        cap=int(positives_cap) if positives_cap else None,
    )
    # logQ correction table for the in-batch softmax: log empirical
    # train-split item frequency (floored at one occurrence — unseen items
    # can still appear as eval-loss candidates). Only materialised when
    # the loss actually consumes it.
    item_log_q = None
    if (
        str(training_config.get("loss", "bce")).lower() == "in_batch_softmax"
        and bool(training_config.get("logq_correction", True))
    ):
        counts = np.bincount(
            train_df["item_idx"].to_numpy(), minlength=num_items
        ).astype(np.float64)
        item_log_q = jnp.asarray(
            np.log(np.maximum(counts, 1.0) / max(counts.sum(), 1.0)),
            dtype=jnp.float32,
        )
    # bf16-stored feature matrices (`data.features_dtype: bfloat16`):
    # halves feature HBM footprint + per-step feature-row gather traffic
    # (the largest per-row payload: F=105-608 floats vs D=128 embeddings)
    # and the multi-chip feature exchange. Towers upcast after the gather
    # (models/encoders.py); inputs are normalized O(1) floats, so the one
    # bf16 rounding is measured quality-neutral (RESULTS.md round-5).
    features_dtype = str(data_config.get("features_dtype", "float32")).lower()
    if features_dtype not in {"float32", "bfloat16"}:
        raise ValueError(f"Unsupported data.features_dtype: {features_dtype}")
    feat_dt = jnp.bfloat16 if features_dtype == "bfloat16" else jnp.float32
    data = BatchData(
        user_features=(
            jnp.asarray(training_dataset.user_feature_matrix, dtype=feat_dt)
            if training_dataset.user_feature_matrix.size
            else None
        ),
        item_features=(
            jnp.asarray(training_dataset.item_feature_matrix, dtype=feat_dt)
            if training_dataset.item_feature_matrix.size
            else None
        ),
        positive_rows=jnp.asarray(packed_positives.rows),
        category_ids=(
            jnp.asarray(categories.category_ids) if categories is not None else None
        ),
        item_log_q=item_log_q,
    )

    # -------------------------------------------------------------- model/opt
    state = create_train_state(
        root_key, model_cfg, num_users=num_users, num_items=num_items,
        packed_moments=bool(training_config.get("packed_moments", False)),
    )

    # Mesh placement (config `mesh:`; 1x1 = single device, no-op). With the
    # state/data placed on a (data, model) mesh the SAME jitted steps below
    # run sharded — XLA infers layouts from the input shardings and inserts
    # the collectives (see parallel/ and docs/architecture.md).
    from ..parallel import (
        MeshConfig,
        build_mesh,
        pad_batch_data,
        pad_state_rows,
        place_data,
        place_state,
    )

    from ..parallel import maybe_initialize_distributed

    mesh_cfg_raw = dict(config.get("mesh", {}) or {})
    maybe_initialize_distributed(bool(mesh_cfg_raw.get("multi_host", False)))
    mesh_cfg = MeshConfig(
        data_parallel=int(mesh_cfg_raw.get("data_parallel", 1)),
        model_parallel=int(mesh_cfg_raw.get("model_parallel", 1)),
    )
    mesh = None
    tensor_parallel = bool(mesh_cfg_raw.get("tensor_parallel", False))
    if mesh_cfg.num_devices > 1:
        mesh = build_mesh(mesh_cfg)
        state = place_state(
            mesh,
            pad_state_rows(state, mesh_cfg.model_parallel),
            tensor_parallel=tensor_parallel,
        )
        data = place_data(mesh, pad_batch_data(data, mesh_cfg.model_parallel))
        logger.info(
            "Mesh | data_parallel=%d model_parallel=%d devices=%d tp=%s",
            mesh_cfg.data_parallel,
            mesh_cfg.model_parallel,
            mesh_cfg.num_devices,
            tensor_parallel,
        )

    loss_type = str(training_config.get("loss", "bce")).lower()
    if loss_type not in {"bce", "in_batch_softmax"}:
        raise ValueError(f"Unsupported training.loss: {loss_type}")
    if float(training_config.get("softmax_temperature", 1.0)) <= 0.0:
        raise ValueError("training.softmax_temperature must be > 0")
    mixed_negatives = int(training_config.get("mixed_negatives", 0))
    if mixed_negatives and loss_type != "in_batch_softmax":
        logger.warning(
            "training.mixed_negatives=%d ignored: only the in_batch_softmax "
            "loss consumes a mixed-negative pool.", mixed_negatives,
        )
        mixed_negatives = 0
    # Schedule horizon for training.lr_schedule: the exact optimizer step
    # count (full batches + remainder per epoch, drop_last=False).
    total_opt_steps = max(1, -(-len(train_df) // batch_size)) * num_epochs
    tscfg = TrainStepConfig(
        num_items=num_items,
        negatives_per_positive=negatives_per_positive,
        loss_type=loss_type,
        lambda_mimic_user=float(loss_weights.get("mimic_user", 0.0)),
        lambda_mimic_item=float(loss_weights.get("mimic_item", 0.0)),
        lambda_category_alignment=float(loss_weights.get("category_alignment", 0.0)),
        gradient_clip_norm=(
            float(gradient_clip_norm) if gradient_clip_norm is not None else None
        ),
        # Default rounds up to a multiple of 8; the padding category ids
        # never occur, contribute zero counts, and are mathematically inert
        # (the loss averages only categories with >=2 batch members).
        cal_max_categories=int(
            training_config.get(
                "category_alignment_max_categories",
                min(64, -(-len(categories.category_names) // 8) * 8)
                if categories
                else 0,
            )
        ),
        embedding_exchange=str(
            mesh_cfg_raw.get("embedding_exchange", "gspmd")
        ),
        softmax_temperature=float(
            training_config.get("softmax_temperature", 1.0)
        ),
        logq_correction=bool(training_config.get("logq_correction", True)),
        comm_dtype=str(training_config.get("comm_dtype", "float32")).lower(),
        # Shard-owner routing for the sparse-table row-grad exchange:
        # ~1/mp the wire of the default allgather routing on a model-
        # sharded mesh, with a guaranteed per-step allgather fallback on
        # capacity overflow (parallel/sparse_update.py docstring).
        update_routing=str(
            training_config.get("update_routing", "allgather")
        ).lower(),
        update_capacity_factor=float(
            training_config.get("update_capacity_factor", 2.0)
        ),
        mixed_negatives=mixed_negatives,
        sparse_weight_decay=float(
            training_config.get("sparse_weight_decay", 0.0)
        ),
        opt=parse_dense_opt_config(training_config, total_steps=total_opt_steps),
    )
    if tscfg.update_routing != "allgather" and (
        mesh is None or bool(training_config.get("packed_moments", False))
    ):
        logger.warning(
            "training.update_routing=%s has no effect: it applies to the "
            "shard-local sparse update of a mesh run with separate moment "
            "arrays (packed_moments: false).", tscfg.update_routing,
        )
    train_step = make_train_step(
        model_cfg, tscfg, mesh=mesh, tensor_parallel=tensor_parallel
    )
    if mesh is not None and batch_size % mesh_cfg.data_parallel == 0:
        # ONE compile path with the bench/tests/dryrun: explicit in/out
        # shardings + state donation for the dominant scanned step (the
        # remainder batch, whose size need not divide the data axis, goes
        # through the mesh-hinted single step above).
        from ..parallel.step import make_sharded_multi_train_step

        multi_step = make_sharded_multi_train_step(
            model_cfg, tscfg, mesh, state, data,
            tensor_parallel=tensor_parallel,
        )
    else:
        multi_step = make_multi_train_step(
            model_cfg, tscfg, mesh=mesh, tensor_parallel=tensor_parallel
        )
    steps_per_call_cfg = training_config.get("steps_per_call", "auto")
    eval_step = make_eval_loss_step(model_cfg, tscfg)
    multi_eval_step = make_multi_eval_loss_step(model_cfg, tscfg)
    logger.info(
        "Tower configuration | dim=%d | similarity=%s | mimic=%s | sparse tables=%s",
        model_cfg.embedding_dim,
        model_cfg.similarity,
        model_cfg.mimic_enabled,
        (model_cfg.user_tower.embedding.sparse, model_cfg.item_tower.embedding.sparse),
    )

    # -------------------------------------------------------------- eval cfg
    eval_cfg = dict(config.get("evaluation", {}))
    metrics_k = eval_cfg.get("metrics_k", [10])
    if isinstance(metrics_k, int):
        metrics_k = [metrics_k]
    candidate_samples = int(eval_cfg.get("candidate_samples", 500))
    mips_cfg = dict(eval_cfg.get("mips", eval_cfg.get("faiss", {})) or {})
    mips_enabled = bool(mips_cfg.get("enabled", True))
    index_path = Path(mips_cfg.get("index_path", "artifacts/faiss/items.index"))
    embedding_path = Path(
        mips_cfg.get("embedding_path", "artifacts/faiss/item_embeddings.npy")
    )
    eval_user_batch = int(eval_cfg.get("user_batch_size", 1024))
    topk_chunk = int(mips_cfg.get("batch_size", 8192))

    diag_cfg = dict(config.get("diagnostics", {}))
    item_sample_size = int(diag_cfg.get("item_sample_size", 500))
    user_sample_size = int(diag_cfg.get("user_sample_size", 5000))
    neighbor_k = int(diag_cfg.get("neighbor_k", 10))
    report_path = Path(
        diag_cfg.get("report_path", "artifacts/reports/recommendation_report.md")
    )
    loss_plot_target = Path(
        diag_cfg.get("loss_plot_path", "artifacts/reports/loss_curve.png")
    )
    embedding_summary_path = Path(
        diag_cfg.get(
            "embedding_summary_path", "artifacts/reports/embedding_diagnostics.json"
        )
    )
    feature_corr_top_k = int(diag_cfg.get("feature_corr_top_k", 15))
    profile_dir = diag_cfg.get("profile_dir")  # jax.profiler trace target

    monitor_cfg = dict(training_config.get("early_stopping", {}))
    monitor_metric = (
        monitor_cfg.get("metric") if monitor_cfg.get("enabled", False) else None
    )
    monitor_mode = str(monitor_cfg.get("mode", "max")).lower()
    patience = int(monitor_cfg.get("patience", 3))
    min_delta = float(monitor_cfg.get("min_delta", 0.0))
    early_controller = None
    if monitor_metric:
        if monitor_mode not in {"max", "min"}:
            raise ValueError("early_stopping.mode must be either 'max' or 'min'")
        early_controller = EarlyStoppingController(
            metric=str(monitor_metric),
            mode=monitor_mode,
            patience=patience,
            min_delta=min_delta,
        )

    checkpoint_cfg = dict(training_config.get("checkpointing", {}))
    checkpoint_enabled = bool(checkpoint_cfg.get("enabled", False))
    checkpoint_dir = Path(checkpoint_cfg.get("dir", "artifacts/checkpoints"))
    checkpoint_template = str(
        checkpoint_cfg.get(
            "filename_template", "{experiment}_{metric}_{value:.4f}_epoch{epoch}.pt"
        )
    )
    save_best_only = bool(checkpoint_cfg.get("save_best_only", True))
    keep_last = bool(checkpoint_cfg.get("keep_last", True))
    # Async saves overlap the ~1 GB state pull + disk write with the next
    # epoch's device compute (set ``checkpointing.async_save: false`` for
    # strictly synchronous, reference-style saves).
    async_save = bool(checkpoint_cfg.get("async_save", True))
    # 'auto' switches to the per-process sharded directory format exactly
    # when the flat .npz pull would break: a multi-process mesh, where no
    # single host can address the full row-sharded state.
    sharded_raw = checkpoint_cfg.get("sharded", "auto")
    sharded_ckpt = (
        jax.process_count() > 1 if sharded_raw == "auto" else bool(sharded_raw)
    )
    checkpointer = (
        AsyncCheckpointer(sharded=sharded_ckpt)
        if checkpoint_enabled and async_save
        else None
    )
    best_checkpoint_path: Path | None = None
    last_checkpoint_path: Path | None = None

    train_positive_map = positives_from_frame(train_df)
    # Precompute the per-epoch-invariant eval inputs once (device-resident
    # users + blocked matrix) so every epoch's retrieval eval is a single
    # scan dispatch (see evaluation/retrieval.py EvalPlan).
    val_eval_plan = test_eval_plan = None
    if mips_enabled and (not val_df.empty or not test_df.empty):
        eval_blocked = jnp.asarray(
            pack_positives(
                train_positive_map, num_users=num_users, num_items=num_items
            ).rows
        )
        val_eval_plan = build_eval_plan(
            val_df, train_positive_map,
            num_users=num_users, num_items=num_items,
            k_values=metrics_k, user_batch_size=eval_user_batch,
            blocked_rows=eval_blocked,
        )
        test_eval_plan = build_eval_plan(
            test_df, train_positive_map,
            num_users=num_users, num_items=num_items,
            k_values=metrics_k, user_batch_size=eval_user_batch,
            blocked_rows=eval_blocked,
        )
    train_users, train_items = interaction_arrays(train_df)
    if steps_per_call_cfg in (None, "auto"):
        steps_per_call = _pick_steps_per_call(len(train_users) // batch_size)
        logger.info("steps_per_call=auto -> %d", steps_per_call)
    else:
        steps_per_call = max(1, int(steps_per_call_cfg))
    val_users, val_items = interaction_arrays(val_df) if not val_df.empty else (
        np.empty(0, np.int32),
        np.empty(0, np.int32),
    )
    test_users, test_items = interaction_arrays(test_df) if not test_df.empty else (
        np.empty(0, np.int32),
        np.empty(0, np.int32),
    )

    # Resume (new capability vs reference; see module docstring).
    start_epoch = 1
    resume_from = training_config.get("resume_from")
    if resume_from:
        state, meta = load_checkpoint(Path(resume_from), state)
        state = _state_to_device(state)
        start_epoch = int(meta.get("epoch", 0)) + 1
        logger.info("Resumed from %s at epoch %d", resume_from, start_epoch)

    rng_seed = seed or 0
    best_metric_value: float | None = None
    best_epoch: int | None = None
    best_val_metrics = None
    best_test_metrics = None
    best_state: TrainState | None = None
    last_val_metrics = None
    last_test_metrics = None
    total_examples = 0
    total_train_seconds = 0.0

    # ---------------------------------------------------------------- epochs
    for epoch in range(start_epoch, num_epochs + 1):
        epoch_start = time.time()
        epoch_rng = np.random.default_rng(rng_seed * 1000003 + epoch)
        running_loss = 0.0
        seen = 0
        step_key = jax.random.fold_in(root_key, epoch)
        pending: list[tuple[Any, int]] = []

        # Full-size batches run through the multi-batch scanned step
        # (steps_per_call batches per device call); the remainder batch
        # goes through the single step. Matches the reference's
        # drop_last=False semantics with at most two compiled shapes.
        perm = epoch_rng.permutation(len(train_users))
        num_full = len(perm) // batch_size
        full_count = num_full * batch_size
        # ONE host->device upload for the whole epoch's batch indices;
        # chunks below are device-side slices (no per-chunk transfer).
        u_full = jnp.asarray(
            train_users[perm[:full_count]].reshape(num_full, batch_size)
        )
        p_full = jnp.asarray(
            train_items[perm[:full_count]].reshape(num_full, batch_size)
        )
        profiling = bool(profile_dir) and epoch == start_epoch
        if profiling:
            jax.profiler.start_trace(str(profile_dir))
        chunk_idx = 0
        for start in range(0, num_full, steps_per_call):
            u_chunk = u_full[start : start + steps_per_call]
            p_chunk = p_full[start : start + steps_per_call]
            if u_chunk.shape[0] == steps_per_call and steps_per_call > 1:
                state, losses = multi_step(
                    state,
                    data,
                    u_chunk,
                    p_chunk,
                    jax.random.fold_in(step_key, 100_000 + chunk_idx),
                )
                pending.append((losses, batch_size * steps_per_call))
            else:
                for row in range(u_chunk.shape[0]):
                    state, metrics = train_step(
                        state,
                        data,
                        u_chunk[row],
                        p_chunk[row],
                        jax.random.fold_in(step_key, start + row),
                    )
                    pending.append((metrics["loss"], batch_size))
            chunk_idx += 1
        if full_count < len(perm):
            u_rem = train_users[perm[full_count:]]
            p_rem = train_items[perm[full_count:]]
            state, metrics = train_step(
                state,
                data,
                jnp.asarray(u_rem),
                jnp.asarray(p_rem),
                jax.random.fold_in(step_key, 999_983),
            )
            pending.append((metrics["loss"], len(u_rem)))

        if profiling:
            jax.block_until_ready(pending[-1][0])
            jax.profiler.stop_trace()
            logger.info("Wrote profiler trace for epoch %d to %s", epoch, profile_dir)

        if pending:
            # One concatenated pull for every chunk's losses — each
            # np.asarray would otherwise be its own device->host sync.
            flat = jnp.concatenate(
                [jnp.ravel(jnp.asarray(l)) for l, _ in pending]
            )
            vals = np.asarray(jax.device_get(flat))
            history.step_loss.extend(vals.tolist())
            pos = 0
            for loss_dev, n in pending:
                cnt = int(np.prod(jnp.shape(loss_dev))) if jnp.shape(loss_dev) else 1
                running_loss += float(vals[pos : pos + cnt].mean()) * n
                pos += cnt
                seen += n
        avg_loss = running_loss / max(seen, 1)
        epoch_seconds = time.time() - epoch_start
        total_examples += seen
        total_train_seconds += epoch_seconds
        history.train_loss.append(float(avg_loss))
        logger.info(
            "Epoch %03d/%03d | train_loss=%.4f | %.1f examples/s",
            epoch,
            num_epochs,
            avg_loss,
            seen / max(epoch_seconds, 1e-9),
        )

        phase_t: dict[str, float] = {"train": epoch_seconds}
        _tick = time.time()

        def _lap(name: str) -> None:
            nonlocal _tick
            now = time.time()
            phase_t[name] = now - _tick
            _tick = now

        # Per-epoch full item-corpus re-encode (the FAISS rebuild analog).
        item_embeddings = None
        if len(val_users) or len(test_users):
            item_embeddings = encode_corpus(
                state, data, model_cfg, "item", num_rows=num_items
            )

        val_loss_value = float("nan")
        val_metrics = None
        monitor_value: float | None = None

        if len(val_users):
            val_loss_value = _dataset_loss(
                eval_step, multi_eval_step, state, data, val_users, val_items,
                batch_size, jax.random.fold_in(step_key, 7_000_003),
            )
            _lap("val_loss")
            if val_eval_plan is not None and mips_enabled:
                # Hit-matrix fast path: the reference post-processing runs
                # on device inside the eval scan; metric-identical to the
                # dict path (tests/test_retrieval_eval.py).
                val_metrics = evaluate_retrieval_metrics(
                    state, data, model_cfg,
                    plan=val_eval_plan,
                    k_values=metrics_k,
                    item_embeddings=item_embeddings,
                    topk_chunk_size=topk_chunk,
                    mesh=mesh,
                )
            else:
                rng = np.random.default_rng(rng_seed * 997 + epoch)
                val_predictions, val_ground_truth = evaluate_retrieval(
                    state, data, model_cfg,
                    val_interactions=val_df,
                    train_positive_map=train_positive_map,
                    num_items=num_items,
                    k_values=metrics_k,
                    use_mips=mips_enabled,
                    candidate_samples=candidate_samples,
                    rng=rng,
                    user_batch_size=eval_user_batch,
                    item_embeddings=item_embeddings,
                    topk_chunk_size=topk_chunk,
                )
                val_metrics = compute_ranking_metrics(
                    val_predictions, val_ground_truth, metrics_k,
                    include_per_user=False,  # unused at 200k users; 4x faster
                )
            _lap("val_eval")
            last_val_metrics = val_metrics
            for k in metrics_k:
                logger.info(
                    "Validation @%d | recall=%.4f precision=%.4f ndcg=%.4f "
                    "hit_rate=%.4f map=%.4f",
                    k,
                    val_metrics.recall[k],
                    val_metrics.precision[k],
                    val_metrics.ndcg[k],
                    val_metrics.hit_rate[k],
                    val_metrics.map[k],
                )
            if monitor_metric:
                monitor_value = extract_metric_value(val_metrics, str(monitor_metric))

        if len(test_users):
            test_loss_value = _dataset_loss(
                eval_step, multi_eval_step, state, data, test_users, test_items,
                batch_size, jax.random.fold_in(step_key, 9_000_001),
            )
            _lap("test_loss")
            history.test_loss.append(float(test_loss_value))
            if test_eval_plan is not None and mips_enabled:
                last_test_metrics = evaluate_retrieval_metrics(
                    state, data, model_cfg,
                    plan=test_eval_plan,
                    k_values=metrics_k,
                    item_embeddings=item_embeddings,
                    topk_chunk_size=topk_chunk,
                    mesh=mesh,
                )
            else:
                rng = np.random.default_rng(rng_seed * 199 + epoch)
                test_predictions, test_ground_truth = evaluate_retrieval(
                    state, data, model_cfg,
                    val_interactions=test_df,
                    train_positive_map=train_positive_map,
                    num_items=num_items,
                    k_values=metrics_k,
                    use_mips=mips_enabled,
                    candidate_samples=candidate_samples,
                    rng=rng,
                    user_batch_size=eval_user_batch,
                    item_embeddings=item_embeddings,
                    topk_chunk_size=topk_chunk,
                )
                last_test_metrics = compute_ranking_metrics(
                    test_predictions, test_ground_truth, metrics_k,
                    include_per_user=False,
                )
            _lap("test_eval")
        else:
            history.test_loss.append(float("nan"))

        history.val_loss.append(float(val_loss_value))

        # Improvement bookkeeping (ref ``training.py:1589-1620``).
        if monitor_metric and monitor_value is not None and early_controller is not None:
            should_stop = early_controller.update(monitor_value, epoch)
            improved = early_controller.best_epoch == epoch
            if improved:
                best_metric_value = early_controller.best_value
                best_epoch = epoch
        else:
            candidate_value = (
                val_loss_value if not np.isnan(val_loss_value) else avg_loss
            )
            should_stop = False
            improved = best_metric_value is None or candidate_value < (
                best_metric_value - min_delta
            )
            if improved:
                best_metric_value = float(candidate_value)
                best_epoch = epoch

        tracked_value = monitor_value
        if tracked_value is None:
            if best_metric_value is not None:
                tracked_value = best_metric_value
            elif not np.isnan(val_loss_value):
                tracked_value = val_loss_value
            else:
                tracked_value = avg_loss
        history.monitored_metric.append(
            float(tracked_value) if tracked_value is not None else float("nan")
        )

        if improved:
            best_state = _clone_state_device(state)
            best_val_metrics = val_metrics or last_val_metrics
            best_test_metrics = last_test_metrics

        # One device->host pull per epoch shared by every checkpoint file
        # (best + per-epoch + last would otherwise each transfer ~1 GB);
        # with async_save the pull + disk write overlap the next epoch.
        checkpoint_jobs: list[dict[str, Any]] = []
        if checkpoint_enabled and improved:
            metric_for_checkpoint = (
                monitor_value
                if monitor_metric and monitor_value is not None
                else (
                    best_metric_value
                    if best_metric_value is not None
                    else avg_loss
                )
            )
            checkpoint_jobs.append(
                dict(
                    directory=checkpoint_dir,
                    experiment_name=experiment_name,
                    epoch=epoch,
                    metric_name=str(monitor_metric) if monitor_metric else "loss",
                    metric_value=metric_for_checkpoint,
                    template=checkpoint_template,
                    _role="best",
                )
            )
        if checkpoint_enabled and not save_best_only:
            checkpoint_jobs.append(
                dict(
                    directory=checkpoint_dir,
                    experiment_name=experiment_name,
                    epoch=epoch,
                    metric_name="epoch",
                    metric_value=float(epoch),
                    template=checkpoint_template,
                    _role="epoch",
                )
            )
        if checkpoint_enabled and keep_last:
            checkpoint_jobs.append(
                dict(
                    directory=checkpoint_dir,
                    experiment_name=experiment_name,
                    epoch=epoch,
                    metric_name="last",
                    metric_value=float(epoch),
                    template="{experiment}_last.pt",
                    _role="last",
                )
            )
        if checkpoint_jobs:
            roles = [job.pop("_role") for job in checkpoint_jobs]
            if checkpointer is not None:
                # Reuse the best-state clone when we just made one; the
                # worker only reads it, later train steps donate `state`.
                snapshot = best_state if improved else _clone_state_device(state)
                paths = checkpointer.submit(snapshot, checkpoint_jobs)
            elif sharded_ckpt:
                from ..train.sharded_checkpoint import (
                    save_sharded_checkpoint,
                    state_to_host_shards,
                )

                pieces = state_to_host_shards(state)
                paths = [
                    save_sharded_checkpoint(state=None, host_pieces=pieces, **job)
                    for job in checkpoint_jobs
                ]
            else:
                host = state_to_host(state)
                paths = [
                    save_checkpoint(state=None, host_arrays=host, **job)
                    for job in checkpoint_jobs
                ]
            for role, path in zip(roles, paths):
                if role == "best":
                    best_checkpoint_path = path
                elif role == "last":
                    last_checkpoint_path = path
        _lap("ckpt")
        logger.info(
            "Epoch timing | %s",
            " ".join(f"{k}={v:.1f}s" for k, v in phase_t.items()),
        )

        if should_stop:
            logger.info(
                "Early stopping triggered after %d epochs without improvement.",
                patience,
            )
            break

    # -------------------------------------------------------------- finalize
    if checkpointer is not None:
        checkpointer.wait()  # checkpoints on disk before anyone can load them
    if best_state is not None:
        state = best_state
    elif last_checkpoint_path is not None and best_checkpoint_path is None:
        best_checkpoint_path = last_checkpoint_path

    if best_val_metrics is None:
        best_val_metrics = last_val_metrics
    if best_val_metrics is None:
        best_val_metrics = compute_ranking_metrics({}, {}, metrics_k)
    if best_test_metrics is None:
        best_test_metrics = last_test_metrics
    if best_test_metrics is None:
        best_test_metrics = compute_ranking_metrics({}, {}, metrics_k)
    if best_metric_value is None and history.train_loss:
        best_metric_value = history.train_loss[-1]
        best_epoch = best_epoch or len(history.train_loss)

    # -------------------------------------------------------- diagnostics
    items_df = training_dataset.items.set_index("item_idx")
    item_sample = (
        np.asarray(
            random.sample(range(num_items), k=min(item_sample_size, num_items)),
            np.int32,
        )
        if num_items > 0 and item_sample_size > 0
        else np.empty(0, np.int32)
    )
    user_sample = (
        np.asarray(
            random.sample(range(num_users), k=min(user_sample_size, num_users)),
            np.int32,
        )
        if num_users > 0 and user_sample_size > 0
        else np.empty(0, np.int32)
    )

    from ..models.two_tower import encode_tower

    if item_sample.size:
        item_sample_embeddings = np.asarray(
            encode_tower(
                state.tables, state.dense, model_cfg, "item",
                jnp.asarray(item_sample),
                (
                    jnp.take(data.item_features, jnp.asarray(item_sample), axis=0)
                    if data.item_features is not None
                    else None
                ),
                train=False, augment_with_mimic=True,
            )
        )
        item_sample_frame = items_df.loc[item_sample].reset_index(drop=True)
        item_feature_subset = training_dataset.item_feature_matrix[item_sample]
    else:
        item_sample_embeddings = np.zeros((0, model_cfg.embedding_dim), np.float32)
        item_sample_frame = items_df.iloc[0:0]
        item_feature_subset = np.zeros(
            (0, training_dataset.item_feature_matrix.shape[1])
        )

    if user_sample.size:
        user_sample_embeddings = np.asarray(
            encode_user_batch(state, data, model_cfg, jnp.asarray(user_sample))
        )
        user_feature_subset = (
            training_dataset.user_feature_matrix[user_sample]
            if training_dataset.user_feature_matrix.size
            else np.zeros((len(user_sample), 0), np.float32)
        )
    else:
        user_sample_embeddings = np.zeros((0, model_cfg.embedding_dim), np.float32)
        user_feature_subset = np.zeros((0, 0), np.float32)

    embedding_stats = {
        "user_norms": summarize_embedding_norms(user_sample_embeddings, label="user"),
        "item_norms": summarize_embedding_norms(item_sample_embeddings, label="item"),
        "item_neighbor_overlap": analyze_item_neighbors(
            item_sample_embeddings,
            item_sample_frame,
            k=neighbor_k,
            sample_size=item_sample_frame.shape[0],
        ),
        "user_alignment": summarize_user_alignment(
            user_sample_embeddings, user_feature_subset
        ),
    }

    # Fusion-gate statistics (BASELINE config #4: "adaptive mimic gate
    # enabled with mimic loss + gate-statistics diagnostics"): how strongly
    # each tower's σ-gate leans ID vs metadata features on the sample rows.
    from ..models.encoders import tower_gate_values

    gate_stats: dict[str, dict[str, float]] = {}
    for side, idx, feats_arr in (
        ("user", user_sample, data.user_features),
        ("item", item_sample, data.item_features),
    ):
        tower_cfg = model_cfg.user_tower if side == "user" else model_cfg.item_tower
        gate = None
        if idx.size and feats_arr is not None and tower_cfg.fusion == "gated":
            id_rows = jnp.take(state.tables[f"{side}_id"], jnp.asarray(idx), axis=0)
            feats = jnp.take(feats_arr, jnp.asarray(idx), axis=0)
            g = tower_gate_values(state.dense[f"{side}_tower"], tower_cfg, id_rows, feats)
            gate = np.asarray(g) if g is not None else None
        gate_stats[side] = summarize_gate_values(gate)
    embedding_stats["fusion_gate"] = gate_stats

    mimic_stats = compute_mimic_statistics(
        state.tables if model_cfg.mimic_enabled else None,
        user_indices=user_sample,
        item_indices=item_sample,
    )

    feature_correlations: list[dict[str, float]] = []
    if item_feature_subset.size > 0:
        feature_names = training_dataset.feature_metadata.feature_names()
        scores = np.linalg.norm(item_sample_embeddings, axis=1)
        feature_correlations = compute_feature_correlations(
            item_feature_subset,
            scores,
            feature_names[: item_feature_subset.shape[1]],
            top_k=feature_corr_top_k,
        )

    # ---------------------------------------------------- recommendations
    final_item_embeddings = encode_corpus(
        state, data, model_cfg, "item", num_rows=num_items
    )
    rec_cfg = dict(config.get("recommendations", {}))
    recommendation_samples = _log_recommendations(
        state,
        data,
        model_cfg,
        training_dataset,
        final_item_embeddings,
        sample_users=int(rec_cfg.get("sample_users", 3)),
        top_k=int(rec_cfg.get("top_k", 5)),
    )

    # ------------------------------------------------- retrieval artifacts
    if mips_enabled:
        # Serving scoring precision (config `serving:`): bf16 scoring
        # halves the score-slab bytes, but it only ships as the serving default when a recall-delta gate on the
        # final e2e validation eval passes — the same corpus, state, and
        # eval plan as the reported metrics, re-scored in bf16.
        # `score_dtype: float32|bfloat16` forces either without
        # gating; eval metrics themselves are always float32.
        serving_cfg = dict(config.get("serving", {}) or {})
        requested_dtype = str(serving_cfg.get("score_dtype", "auto")).lower()
        if requested_dtype in {"fp32", "float32"}:
            requested_dtype = "float32"
        elif requested_dtype in {"bf16", "bfloat16"}:
            requested_dtype = "bfloat16"
        elif requested_dtype != "auto":
            raise ValueError(
                f"Unsupported serving.score_dtype: {requested_dtype!r} "
                "(expected auto, float32, or bfloat16)"
            )
        gate_eps = float(serving_cfg.get("bf16_recall_gate", 0.002))
        serving_score_dtype = "float32"
        if requested_dtype in ("float32", "bfloat16"):
            serving_score_dtype = requested_dtype
        elif val_eval_plan is None:
            logger.info(
                "Serving precision gate skipped (no validation eval plan);"
                " exporting float32."
            )
        else:
            bf16_metrics = evaluate_retrieval_metrics(
                state,
                data,
                model_cfg,
                plan=val_eval_plan,
                k_values=metrics_k,
                item_embeddings=final_item_embeddings,
                topk_chunk_size=topk_chunk,
                score_dtype="bfloat16",
                mesh=mesh,
            )
            deltas = {
                k: best_val_metrics.recall.get(k, 0.0)
                - bf16_metrics.recall.get(k, 0.0)
                for k in metrics_k
            }
            worst = max(deltas.values()) if deltas else 0.0
            if worst <= gate_eps:
                serving_score_dtype = "bfloat16"
            logger.info(
                "Serving precision gate | bf16 recall deltas %s | worst %.5f"
                " vs gate %.5f -> %s",
                {k: round(v, 5) for k, v in deltas.items()},
                worst,
                gate_eps,
                serving_score_dtype,
            )
        emb_np = np.asarray(final_item_embeddings)
        index = build_flat_index(
            emb_np,
            normalize=model_cfg.similarity == "cosine",
            score_dtype=serving_score_dtype,
        )
        index.save(index_path)
        embedding_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(embedding_path, index.embeddings)
        logger.info("Saved retrieval artifacts to %s / %s", index_path, embedding_path)

        # Serving bundle (beyond the reference, which never exported the
        # user side): user embeddings + raw-ID vocabularies so the
        # serve CLI / RetrievalService can answer userId -> top-K ASINs.
        serve_dir = index_path.parent
        user_embeddings = np.asarray(
            encode_corpus(state, data, model_cfg, "user", num_rows=num_users)
        )
        np.save(serve_dir / "user_embeddings.npy", user_embeddings)
        import json as _json

        (serve_dir / "vocab.json").write_text(
            _json.dumps(
                {
                    "user_ids": training_dataset.user_mapping.index_to_id,
                    "item_ids": training_dataset.item_mapping.index_to_id,
                    "similarity": model_cfg.similarity,
                }
            ),
            encoding="utf-8",
        )
        logger.info("Saved serving bundle to %s", serve_dir)

    # ------------------------------------------------------------- reports
    loss_plot_path: Path | None = None
    loss_series = {
        "Train": history.train_loss,
        "Validation": history.val_loss,
        "Test": history.test_loss,
    }
    if any(len(v) for v in loss_series.values()):
        try:
            loss_plot_path = save_loss_curves(
                loss_series, output_path=loss_plot_target
            )
        except ValueError:
            loss_plot_path = None
        except ModuleNotFoundError as exc:
            logger.warning("Loss curve not drawn: %s", exc)
            loss_plot_path = None

    write_recommendation_report(
        report_path,
        metrics_summary=best_val_metrics,
        embedding_stats=embedding_stats,
        recommendations=recommendation_samples,
        loss_plot_path=loss_plot_path,
        history=history,
        monitor_metric=str(monitor_metric) if monitor_metric else "val_loss",
        best_epoch=best_epoch,
        feature_correlations=feature_correlations,
    )
    write_embedding_summary(
        embedding_summary_path,
        embedding_stats=embedding_stats,
        mimic_stats=mimic_stats,
        feature_correlations=feature_correlations,
        monitor_metric=str(monitor_metric) if monitor_metric else "val_loss",
        best_epoch=best_epoch,
    )

    runtime = time.time() - start_time
    return TrainingResult(
        config=config,
        history=history,
        runtime_seconds=runtime,
        best_metric=best_metric_value,
        best_epoch=best_epoch,
        best_checkpoint_path=best_checkpoint_path,
        val_metrics=best_val_metrics,
        test_metrics=best_test_metrics,
        overrides=overrides,
        loss_plot_path=loss_plot_path,
        embedding_summary_path=embedding_summary_path,
        examples_per_second=(
            total_examples / total_train_seconds if total_train_seconds > 0 else None
        ),
    )


def run_experiment_grid(
    config: Mapping[str, Any], grid: Mapping[str, Sequence[Any]]
) -> list[TrainingResult]:
    if not grid:
        return [run_single_experiment(config)]
    results: list[TrainingResult] = []
    for run_config, overrides in expand_grid(config, grid):
        results.append(run_single_experiment(run_config, overrides=overrides))
    return results


def run_training(config: Mapping[str, Any]) -> list[TrainingResult] | TrainingResult:
    """Entry point: single run or Cartesian sweep + benchmark ledger
    (ref ``training.py:1882-1897``)."""
    experiment_cfg = dict(config.get("experiment", {}))
    grid = experiment_cfg.get("grid") or {}

    results = (
        run_experiment_grid(config, grid) if grid else [run_single_experiment(config)]
    )

    benchmark_path = experiment_cfg.get("benchmark_report")
    if benchmark_path:
        write_benchmark_report(Path(benchmark_path), results)

    if len(results) == 1:
        return results[0]
    return results
