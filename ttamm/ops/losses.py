"""Training losses: sampled BCE retrieval loss and category-alignment.

Parity targets:

- ``bce_with_logits`` == ``nn.BCEWithLogitsLoss`` (mean reduction) used for
  the [positives; negatives] logit stack (ref ``training.py:789-798``).
  Implemented in the log-sum-exp-stable form
  ``max(x,0) - x*y + log(1+exp(-|x|))``.
- ``category_alignment_loss`` == ``_category_alignment_loss`` (ref
  ``training.py:541-579``): mean over non-major categories (with >=2 batch
  members) of the squared Frobenius distance between that category's batch
  covariance and the majority category's. The reference loops over the
  categories *present in the batch* (data-dependent); here we scan over a
  *static* set of the ``max_categories`` globally most frequent category ids
  (ids are frequency-ordered by ``build_item_categories``, so id 0 is the
  major category and ids [1, C) are the most frequent challengers). Rare
  categories beyond the cap contribute >=2 batch members so seldom that the
  regulariser (weight 0.01) is statistically unchanged.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def bce_with_logits(logits: jax.Array, labels: jax.Array) -> jax.Array:
    """Numerically stable mean binary cross-entropy on logits."""
    x, y = logits, labels
    return jnp.mean(
        jnp.maximum(x, 0.0) - x * y + jnp.log1p(jnp.exp(-jnp.abs(x)))
    )


def _masked_covariance(
    embeddings: jax.Array, mask: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Unbiased covariance of the masked rows; returns (cov [D,D], count)."""
    w = mask.astype(embeddings.dtype)
    n = jnp.sum(w)
    safe_n = jnp.maximum(n, 1.0)
    mean = (w @ embeddings) / safe_n
    centered = (embeddings - mean) * w[:, None]
    cov = (centered.T @ centered) / jnp.maximum(n - 1.0, 1.0)
    # Reference returns a zero matrix for <=1 members (training.py:530-538).
    cov = jnp.where(n > 1.0, cov, jnp.zeros_like(cov))
    return cov, n


@partial(jax.jit, static_argnames=("max_categories",))
def category_alignment_loss(
    item_category_ids: jax.Array,
    item_embeddings: jax.Array,
    *,
    max_categories: int = 64,
) -> jax.Array:
    """Covariance-alignment regulariser over the batch's item embeddings.

    Computed from per-category sufficient statistics in matmuls (a [C, N]
    selector against X and against the row-wise outer products) instead of
    a per-category scan — mathematically identical to the masked-covariance
    loop (up to float association).

    Parameters
    ----------
    item_category_ids: int32 [N] per-item primary-category ids for the batch
        (id 0 == majority category by construction).
    item_embeddings: float [N, D] item embeddings of the batch.
    max_categories: static cap on distinct category ids considered.
    """
    n_rows, dim = item_embeddings.shape
    c = max_categories
    x = item_embeddings
    # Selector S[c, n] = 1 when row n belongs to category c.
    cat_range = jnp.arange(c, dtype=item_category_ids.dtype)
    sel = (item_category_ids[None, :] == cat_range[:, None]).astype(x.dtype)

    counts = jnp.sum(sel, axis=1)  # [C]
    sums = jnp.dot(sel, x, preferred_element_type=jnp.float32)  # [C, D]
    # Second moments M2[c] = sum_{n in c} x_n x_n^T: one matmul of the
    # [C, N] selector against the row-wise outer products, chunked over N
    # to bound the [chunk, D*D] intermediate.
    chunk = min(2048, n_rows)
    num_chunks = -(-n_rows // chunk)
    pad = num_chunks * chunk - n_rows
    if pad:
        x_p = jnp.concatenate([x, jnp.zeros((pad, dim), x.dtype)])
        sel_p = jnp.concatenate([sel, jnp.zeros((c, pad), x.dtype)], axis=1)
    else:
        x_p, sel_p = x, sel

    def chunk_body(acc, inputs):
        xc, sc = inputs  # [chunk, D], [C, chunk]
        outer = (xc[:, :, None] * xc[:, None, :]).reshape(chunk, dim * dim)
        return acc + jnp.dot(sc, outer, preferred_element_type=jnp.float32), None

    x_chunks = x_p.reshape(num_chunks, chunk, dim)
    sel_chunks = sel_p.reshape(c, num_chunks, chunk).transpose(1, 0, 2)
    m2_flat, _ = jax.lax.scan(
        chunk_body,
        jnp.zeros((c, dim * dim), jnp.float32),
        (x_chunks, sel_chunks),
    )
    m2 = m2_flat.reshape(c, dim, dim)

    safe_n = jnp.maximum(counts, 1.0)
    means = sums / safe_n[:, None]
    # cov_c = (M2_c - n mu mu^T) / (n - 1), zero when n <= 1 (ref :530-538).
    mu_outer = means[:, :, None] * means[:, None, :]
    covs = (m2 - counts[:, None, None] * mu_outer) / jnp.maximum(
        counts - 1.0, 1.0
    )[:, None, None]
    covs = jnp.where((counts > 1.0)[:, None, None], covs, 0.0)

    diffs = covs - covs[0][None]
    contribs = jnp.sum(diffs * diffs, axis=(1, 2))  # [C]
    use = (counts >= 2.0) & (cat_range != 0)
    loss_sum = jnp.sum(jnp.where(use, contribs, 0.0))
    compared = jnp.sum(use.astype(jnp.int32))

    # Zero when the major category has <2 members or nothing to compare
    # (ref training.py:555-579).
    valid = (counts[0] >= 2.0) & (compared > 0)
    return jnp.where(valid, loss_sum / jnp.maximum(compared, 1), 0.0)
