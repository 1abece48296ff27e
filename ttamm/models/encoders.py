"""Tower encoders: ID embedding + feature MLP + fusion, as pure functions.

Capability parity with the reference encoder stack
(``src/models/encoders.py:19-331``) re-designed for XLA:

- parameters are plain pytrees (nested dicts of ``jnp`` arrays), no module
  objects, so ``jax.jit`` / ``pjit`` can shard and donate them freely;
- the tower forward takes *gathered* embedding rows (``id_rows``) instead of
  indices — the caller owns the gather, which lets the training step
  differentiate w.r.t. only the touched rows (sparse-row optimizer), and
  lets the gather itself be ``jnp.take``, a hand-written kernel, or a sharded
  all-to-all lookup without touching the model code;
- supported fusions: identity / sum / concat(+projection) / gated
  (σ-gate blend, ``encoders.py:149-168``); ``adaptive_mimic`` is accepted
  as a deprecated alias for gated (``encoders.py:195-201``);
- bare ``type: embedding`` towers (``encoders.py:271-287``) are towers with
  no feature encoder;
- feature encoders: identity / linear / MLP(hidden_dims, activation,
  dropout) with xavier-uniform weight init (``encoders.py:102-146``).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

Params = dict[str, Any]


class TPContext(NamedTuple):
    """Tensor-parallel execution context threaded into the tower forward.

    ``size`` is the model-axis extent; ``constrain(x, kind)`` applies a
    sharding constraint to an activation, with ``kind`` one of
    ``"hidden"`` (batch over data, features over model — the output of a
    column-parallel layer) or ``"replicated"`` (batch over data only — the
    output of a row-parallel or replicated layer). Keeping forward
    activations pinned to the layout the weight shardings imply stops the
    SPMD partitioner from re-laying-out activation *gradients* in the
    transpose (the "involuntary full rematerialization" it otherwise hits:
    grads arrive batch-sharded over every mesh axis and must be rebuilt
    feature-sharded over ``model``).
    """

    size: int
    constrain: Callable[[jax.Array, str], jax.Array]


def tp_layer_roles(
    shapes: list[tuple[int, int]], size: int
) -> list[str]:
    """Megatron-style role per linear layer: ``col`` / ``row`` / ``rep``.

    Alternates column-parallel (weight ``[in, out/s]``, bias sharded,
    output feature-sharded) with row-parallel (weight ``[in/s, out]``,
    bias replicated, contraction over the sharded feature dim — GSPMD
    inserts one batch-sized psum). A row layer always follows a col layer
    (its contraction dim is the col layer's sharded output, divisible by
    construction); a layer whose output dim does not divide ``size`` at a
    col position is replicated and the alternation restarts. The single
    source of truth for both the weight shardings
    (``parallel/sharding.py``) and the forward's activation constraints.
    """
    roles: list[str] = []
    after_col = False
    for i, (_, dout) in enumerate(shapes):
        if after_col:
            roles.append("row")
            after_col = False
        elif dout % size == 0 and i < len(shapes) - 1:
            # Never end a stack column-parallel: the tower output must be
            # feature-replicated for the fusion/logit math, and with no
            # row layer to contract back, a trailing col would force an
            # activation all-gather for no matmul saving.
            roles.append("col")
            after_col = True
        else:
            roles.append("rep")
    return roles

_ACTIVATIONS = {
    "relu": jax.nn.relu,
    "gelu": jax.nn.gelu,
    "tanh": jnp.tanh,
    "selu": jax.nn.selu,
}


# ---------------------------------------------------------------------------
# Configs (static, hashable -> safe to close over in jit)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EmbeddingConfig:
    dim: int = 64
    sparse: bool = False
    padding_idx: int | None = None
    max_norm: float | None = None
    init_type: str = "normal"
    init_std: float = 0.02
    init_bound: float = 0.1

    def __post_init__(self) -> None:
        if self.sparse and self.max_norm is not None:
            raise ValueError("max_norm is not supported when using sparse embeddings.")


@dataclass(frozen=True)
class FeatureEncoderConfig:
    type: str = "linear"
    output_dim: int | None = None
    hidden_dims: tuple[int, ...] = ()
    activation: str = "relu"
    dropout: float = 0.0


@dataclass(frozen=True)
class TowerConfig:
    embedding: EmbeddingConfig = field(default_factory=EmbeddingConfig)
    feature_encoder: FeatureEncoderConfig | None = None
    fusion: str = "identity"
    output_dim: int = 0  # resolved final output dim
    feature_dim: int = 0  # input feature width (0 => id-only tower)
    gate_hidden_dim: int | None = None
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16' matmul inputs


def _parse_embedding_config(cfg: Mapping[str, Any] | None) -> EmbeddingConfig:
    cfg = cfg or {}
    params = cfg.get("params", {}) or {}
    init = cfg.get("init", {}) or {}
    return EmbeddingConfig(
        dim=int(params.get("embedding_dim", 64)),
        sparse=bool(params.get("sparse", False)),
        padding_idx=params.get("padding_idx"),
        max_norm=params.get("max_norm"),
        init_type=str(init.get("type", "normal")).lower(),
        init_std=float(init.get("std", 0.02)),
        init_bound=float(init.get("bound", 0.1)),
    )


def parse_tower_config(
    config: Mapping[str, Any] | None,
    *,
    feature_dim: int,
    compute_dtype: str = "float32",
) -> TowerConfig:
    """Resolve a YAML tower section into a static TowerConfig.

    Mirrors ``build_tower_encoder``'s resolution rules
    (``src/models/encoders.py:258-331``): fusion defaults to gated when
    features exist, feature towers with no features degrade to identity,
    sum/gated require matching dims, concat gets a projection.
    """
    cfg = dict(config or {})
    encoder_type = str(cfg.get("type", "tower")).lower()
    if encoder_type not in {"tower", "embedding"}:
        raise ValueError(f"Unsupported encoder type: {encoder_type}")

    if encoder_type == "embedding":
        emb = _parse_embedding_config({"params": cfg.get("params", {}), "init": cfg.get("init")})
        return TowerConfig(
            embedding=emb,
            feature_encoder=None,
            fusion="identity",
            output_dim=emb.dim,
            feature_dim=0,
            compute_dtype=compute_dtype,
        )

    emb = _parse_embedding_config(cfg.get("id_embedding", {}))
    fusion = str(cfg.get("fusion", "gated" if feature_dim > 0 else "identity")).lower()
    if fusion == "adaptive_mimic":
        warnings.warn(
            "fusion='adaptive_mimic' is deprecated; use fusion='gated' instead.",
            DeprecationWarning,
            stacklevel=2,
        )
        fusion = "gated"
    if fusion not in {"identity", "sum", "concat", "gated"}:
        raise ValueError(f"Unsupported fusion strategy: {fusion}")

    fe_cfg_raw = cfg.get("feature_encoder")
    feature_encoder: FeatureEncoderConfig | None = None
    if feature_dim > 0:
        fe = dict(fe_cfg_raw or {})
        feature_encoder = FeatureEncoderConfig(
            type=str(fe.get("type", "linear")).lower(),
            output_dim=(
                int(fe["output_dim"]) if fe.get("output_dim") is not None else None
            ),
            hidden_dims=tuple(int(h) for h in (fe.get("hidden_dims") or ())),
            activation=str(fe.get("activation", "relu")).lower(),
            dropout=float(fe.get("dropout", 0.0)),
        )
        fe_out = feature_encoder.output_dim or emb.dim
        if feature_encoder.type == "identity" and feature_dim != fe_out:
            raise ValueError(
                "Identity feature encoder requires input_dim == output_dim."
            )
        if fusion in {"sum", "gated"} and fe_out != emb.dim:
            raise ValueError(
                "Feature encoder output dimension must equal embedding dimension "
                "for 'sum' or 'gated' fusion."
            )

    if feature_encoder is None:
        fusion = "identity"

    if fusion == "concat" and feature_encoder is not None:
        fe_out = feature_encoder.output_dim or emb.dim
        output_dim = int(cfg.get("output_dim") or (emb.dim + fe_out))
    else:
        output_dim = emb.dim

    gate_hidden = None
    if fusion == "gated":
        mimic_cfg = cfg.get("adaptive_mimic", {}) or {}
        gate_hidden = mimic_cfg.get("hidden_dim")
        gate_hidden = int(gate_hidden) if gate_hidden is not None else None

    return TowerConfig(
        embedding=emb,
        feature_encoder=feature_encoder,
        fusion=fusion,
        output_dim=output_dim,
        feature_dim=int(feature_dim),
        gate_hidden_dim=gate_hidden,
        compute_dtype=compute_dtype,
    )


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------


def init_embedding_table(
    key: jax.Array,
    cfg: EmbeddingConfig,
    *,
    num_embeddings: int,
    extra_rows: int = 0,
    dtype=jnp.float32,
) -> jax.Array:
    """Initialise an embedding table.

    ``extra_rows`` appends scratch rows (used as scatter-padding targets by
    the sparse-row optimizer); they are initialised to zero and never read.
    Init types mirror ``_init_embedding`` (``encoders.py:19-36``).
    """
    shape = (num_embeddings, cfg.dim)
    if cfg.init_type == "normal":
        table = jax.random.normal(key, shape, dtype) * cfg.init_std
    elif cfg.init_type == "uniform":
        table = jax.random.uniform(
            key, shape, dtype, minval=-cfg.init_bound, maxval=cfg.init_bound
        )
    elif cfg.init_type in {"xavier_normal", "xavier_uniform"}:
        fan_in, fan_out = shape[0], shape[1]
        scale = float(np.sqrt(2.0 / (fan_in + fan_out)))
        if cfg.init_type == "xavier_normal":
            table = jax.random.normal(key, shape, dtype) * scale
        else:
            bound = float(np.sqrt(3.0)) * scale
            table = jax.random.uniform(key, shape, dtype, minval=-bound, maxval=bound)
    else:
        raise ValueError(f"Unsupported embedding init type: {cfg.init_type}")

    if cfg.padding_idx is not None:
        table = table.at[int(cfg.padding_idx)].set(0.0)
    if extra_rows:
        table = jnp.concatenate(
            [table, jnp.zeros((extra_rows, cfg.dim), dtype)], axis=0
        )
    return table


def _init_linear(
    key: jax.Array, in_dim: int, out_dim: int, dtype=jnp.float32
) -> Params:
    """Xavier-uniform weights + torch-style uniform bias (±1/sqrt(fan_in))."""
    wkey, bkey = jax.random.split(key)
    bound_w = float(np.sqrt(6.0 / (in_dim + out_dim)))
    w = jax.random.uniform(wkey, (in_dim, out_dim), dtype, -bound_w, bound_w)
    bound_b = 1.0 / float(np.sqrt(in_dim)) if in_dim > 0 else 0.0
    b = jax.random.uniform(bkey, (out_dim,), dtype, -bound_b, bound_b)
    return {"w": w, "b": b}


def init_tower(
    key: jax.Array,
    cfg: TowerConfig,
    *,
    num_embeddings: int,
    table_extra_rows: int = 0,
    dtype=jnp.float32,
) -> tuple[jax.Array, Params]:
    """Initialise (embedding_table, dense_params) for a tower.

    The table is returned separately from the dense params so callers can
    place it in the sparse/sharded part of the train state.
    """
    keys = jax.random.split(key, 8)
    table = init_embedding_table(
        keys[0],
        cfg.embedding,
        num_embeddings=num_embeddings,
        extra_rows=table_extra_rows,
        dtype=dtype,
    )

    dense: Params = {}
    fe = cfg.feature_encoder
    if fe is not None and cfg.feature_dim > 0:
        out_dim = fe.output_dim or cfg.embedding.dim
        if fe.type == "identity":
            dense["feature_encoder"] = {"layers": []}
        elif fe.type == "linear":
            dense["feature_encoder"] = {
                "layers": [_init_linear(keys[1], cfg.feature_dim, out_dim, dtype)]
            }
        elif fe.type == "mlp":
            layers = []
            prev = cfg.feature_dim
            lkeys = jax.random.split(keys[1], len(fe.hidden_dims) + 1)
            for i, hidden in enumerate(fe.hidden_dims):
                layers.append(_init_linear(lkeys[i], prev, hidden, dtype))
                prev = hidden
            layers.append(_init_linear(lkeys[-1], prev, out_dim, dtype))
            dense["feature_encoder"] = {"layers": layers}
        else:
            raise ValueError(f"Unsupported feature encoder type: {fe.type}")

    if cfg.fusion == "gated":
        dim = cfg.embedding.dim
        hidden = cfg.gate_hidden_dim or dim
        dense["gate"] = {
            "fc1": _init_linear(keys[2], dim * 2, hidden, dtype),
            "fc2": _init_linear(keys[3], hidden, dim, dtype),
        }
    if cfg.fusion == "concat" and fe is not None:
        fe_out = fe.output_dim or cfg.embedding.dim
        dense["projection"] = _init_linear(
            keys[4], cfg.embedding.dim + fe_out, cfg.output_dim, dtype
        )
    return table, dense


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _dot(x: jax.Array, w: jax.Array, compute_dtype: str) -> jax.Array:
    """Matmul with optional bf16 inputs and fp32 accumulation (MXU path)."""
    if compute_dtype == "bfloat16":
        return jnp.dot(
            x.astype(jnp.bfloat16),
            w.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )
    return x @ w


def _apply_mlp(
    layers: list[Params],
    x: jax.Array,
    *,
    activation: str,
    dropout: float,
    train: bool,
    dropout_rng: jax.Array | None,
    compute_dtype: str = "float32",
    tp: TPContext | None = None,
) -> jax.Array:
    """Linear stack with activation+dropout after each hidden layer."""
    act = _ACTIVATIONS[activation]
    n = len(layers)
    roles = (
        tp_layer_roles([tuple(l["w"].shape) for l in layers], tp.size)
        if tp is not None
        else None
    )
    for i, layer in enumerate(layers):
        x = _dot(x, layer["w"], compute_dtype) + layer["b"]
        if tp is not None:
            x = tp.constrain(x, "hidden" if roles[i] == "col" else "replicated")
        if i < n - 1:
            x = act(x)
            if train and dropout > 0.0 and dropout_rng is not None:
                dropout_rng = jax.random.fold_in(dropout_rng, i)
                keep = jax.random.bernoulli(dropout_rng, 1.0 - dropout, x.shape)
                x = jnp.where(keep, x / (1.0 - dropout), 0.0)
    return x


def apply_feature_encoder(
    dense: Params,
    cfg: TowerConfig,
    features: jax.Array,
    *,
    train: bool = False,
    dropout_rng: jax.Array | None = None,
    tp: TPContext | None = None,
) -> jax.Array:
    fe = cfg.feature_encoder
    assert fe is not None
    layers = dense["feature_encoder"]["layers"]
    if fe.type == "identity" or not layers:
        return features
    return _apply_mlp(
        layers,
        features,
        activation=fe.activation,
        dropout=fe.dropout,
        train=train,
        dropout_rng=dropout_rng,
        compute_dtype=cfg.compute_dtype,
        tp=tp,
    )


def gate_values(
    dense: Params,
    id_repr: jax.Array,
    feat_repr: jax.Array,
    compute_dtype: str = "float32",
    tp: TPContext | None = None,
) -> jax.Array:
    """The σ(MLP([id;feat])) gate itself — 1.0 means the blend is all-ID,
    0.0 all-feature (``encoders.py:164-167``). Exposed for the
    gate-statistics diagnostic."""
    gate_params = dense["gate"]
    h = jnp.concatenate([id_repr, feat_repr], axis=-1)
    h = _dot(h, gate_params["fc1"]["w"], compute_dtype) + gate_params["fc1"]["b"]
    if tp is not None:
        roles = tp_layer_roles(
            [gate_params["fc1"]["w"].shape, gate_params["fc2"]["w"].shape],
            tp.size,
        )
        h = tp.constrain(h, "hidden" if roles[0] == "col" else "replicated")
    h = jax.nn.relu(h)
    out = _dot(h, gate_params["fc2"]["w"], compute_dtype) + gate_params["fc2"]["b"]
    if tp is not None:
        out = tp.constrain(out, "replicated")
    return jax.nn.sigmoid(out)


def apply_gate(
    dense: Params,
    id_repr: jax.Array,
    feat_repr: jax.Array,
    compute_dtype: str = "float32",
    tp: TPContext | None = None,
) -> jax.Array:
    """σ-gate blend: ``g*id + (1-g)*feat`` with g = σ(MLP([id;feat]))
    (``encoders.py:164-168``)."""
    gate = gate_values(dense, id_repr, feat_repr, compute_dtype, tp=tp)
    return gate * id_repr + (1.0 - gate) * feat_repr


def tower_gate_values(
    dense: Params,
    cfg: TowerConfig,
    id_rows: jax.Array,
    features: jax.Array | None,
) -> jax.Array | None:
    """Gate values for already-gathered rows, or None when the tower does
    not blend via a gate (fusion != 'gated' or no features at runtime)."""
    if cfg.fusion != "gated" or cfg.feature_encoder is None or features is None:
        return None
    if cfg.embedding.max_norm is not None:
        norms = jnp.linalg.norm(id_rows, axis=-1, keepdims=True)
        scale = jnp.minimum(1.0, cfg.embedding.max_norm / jnp.maximum(norms, 1e-12))
        id_rows = id_rows * scale
    feat_repr = apply_feature_encoder(dense, cfg, features, train=False, dropout_rng=None)
    return gate_values(dense, id_rows, feat_repr, cfg.compute_dtype)


def tower_forward(
    dense: Params,
    cfg: TowerConfig,
    id_rows: jax.Array,
    features: jax.Array | None = None,
    *,
    train: bool = False,
    dropout_rng: jax.Array | None = None,
    tp: TPContext | None = None,
) -> jax.Array:
    """Tower forward from already-gathered embedding rows.

    Mirrors ``TowerEncoder.forward`` (``encoders.py:221-255``) including the
    fallback to id-only behaviour when features are unavailable at runtime.
    ``tp`` activates tensor-parallel activation constraints (see
    :class:`TPContext`); numerics are unchanged.
    """
    if cfg.embedding.max_norm is not None:
        # Functional analog of torch's max_norm renorm-on-lookup: clamp row
        # norms of the *gathered* rows (the table itself is not mutated).
        norms = jnp.linalg.norm(id_rows, axis=-1, keepdims=True)
        scale = jnp.minimum(1.0, cfg.embedding.max_norm / jnp.maximum(norms, 1e-12))
        id_rows = id_rows * scale

    if cfg.fusion == "identity" or cfg.feature_encoder is None or features is None:
        return id_rows

    if features.dtype != id_rows.dtype:
        # bf16-stored feature matrices (`data.features_dtype`): the rows
        # travel HBM/ICI at half width; all tower math stays in the
        # param dtype from here.
        features = features.astype(id_rows.dtype)
    feat_repr = apply_feature_encoder(
        dense, cfg, features, train=train, dropout_rng=dropout_rng, tp=tp
    )

    if cfg.fusion == "sum":
        return id_rows + feat_repr
    if cfg.fusion == "concat":
        proj = dense["projection"]
        combined = jnp.concatenate([id_rows, feat_repr], axis=-1)
        return _dot(combined, proj["w"], cfg.compute_dtype) + proj["b"]
    if cfg.fusion == "gated":
        return apply_gate(dense, id_rows, feat_repr, cfg.compute_dtype, tp=tp)
    return id_rows
