"""Plain numpy float64 references for the device kernels.

Each function restates one operation's semantics without JAX, so the
device path can be checked against it on any backend: exact MIPS top-k
(FAISS ``IndexFlatIP``), the SparseAdam row update
(``torch.optim.SparseAdam`` + decoupled decay), and the category-alignment
loss with its gradient (ref ``training.py:541-579``).
"""

from __future__ import annotations

import numpy as np


def mips_scores(
    queries: np.ndarray, items: np.ndarray, mask_rows: np.ndarray | None = None
) -> np.ndarray:
    """float64 [B, N] inner products; blocked ids (mask_rows, padded with
    ids >= N) score -inf."""
    scores = np.asarray(queries, np.float64) @ np.asarray(items, np.float64).T
    if mask_rows is not None:
        n = scores.shape[1]
        for row, blocked in enumerate(np.asarray(mask_rows)):
            blocked = blocked[(blocked >= 0) & (blocked < n)]
            scores[row, blocked] = -np.inf
    return scores


def topk_mismatches(
    got_idx: np.ndarray, scores: np.ndarray, k: int, tol: float
) -> int:
    """Rows whose returned ids are not an exact top-k of ``scores``.

    A row passes when its k ids are distinct, unblocked, ordered by
    descending score, every id scores within ``tol`` of the true k-th best
    score, and every item scoring more than ``tol`` above that threshold is
    among them — so ids may differ only where scores are tied to ``tol``.
    """
    bad = 0
    for row, got in enumerate(np.asarray(got_idx)):
        s = scores[row]
        if len(set(got.tolist())) != k or got.min() < 0 or got.max() >= s.size:
            bad += 1
            continue
        g = s[got]
        kth = np.partition(s, s.size - k)[s.size - k]
        must = np.nonzero(s > kth + tol)[0]
        if (
            not np.all(np.isfinite(g))
            or g.min() < kth - tol
            or np.any(np.diff(g) > tol)
            or not set(must.tolist()) <= set(got.tolist())
        ):
            bad += 1
    return bad


def sparse_adam_reference(
    table: np.ndarray,
    m: np.ndarray,
    v: np.ndarray,
    step: int,
    indices: np.ndarray,
    row_grads: np.ndarray,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One SparseAdam step in float64 for the touched rows.

    Duplicate ids are coalesced (gradients summed); ``step`` is the global
    step count BEFORE this update. Returns ``(rows, table_rows, m_rows,
    v_rows)``: the sorted unique touched row ids and their new values.
    Every other row is unchanged by definition.
    """
    rows, inverse = np.unique(np.asarray(indices), return_inverse=True)
    grads = np.zeros((rows.size, row_grads.shape[1]), np.float64)
    np.add.at(grads, inverse, np.asarray(row_grads, np.float64))
    t = step + 1
    m_new = b1 * m[rows].astype(np.float64) + (1.0 - b1) * grads
    v_new = b2 * v[rows].astype(np.float64) + (1.0 - b2) * grads * grads
    m_hat = m_new / (1.0 - b1**t)
    v_hat = v_new / (1.0 - b2**t)
    w = table[rows].astype(np.float64)
    w_new = w - lr * m_hat / (np.sqrt(v_hat) + eps) - lr * weight_decay * w
    return rows, w_new, m_new, v_new


def category_alignment_reference(
    category_ids: np.ndarray, embeddings: np.ndarray, max_categories: int
) -> tuple[float, np.ndarray]:
    """Category-alignment loss and its gradient w.r.t. ``embeddings``.

    loss = mean over categories c in [1, C) with >= 2 members of
    ||cov_c - cov_0||_F^2 (unbiased covariances; 0 when category 0 has < 2
    members or no category is compared). For a member x_n of category c,
    d||cov_c - cov_0||^2 / dx_n = 4 (cov_c - cov_0)(x_n - mu_c) / (n_c - 1).
    """
    x = np.asarray(embeddings, np.float64)
    cats = np.asarray(category_ids)
    grad = np.zeros_like(x)
    covs, means, members = {}, {}, {}
    for c in range(max_categories):
        rows = np.nonzero(cats == c)[0]
        members[c] = rows
        if rows.size >= 2:
            means[c] = x[rows].mean(axis=0)
            centered = x[rows] - means[c]
            covs[c] = centered.T @ centered / (rows.size - 1)
    used = [c for c in range(1, max_categories) if members[c].size >= 2]
    if members[0].size < 2 or not used:
        return 0.0, grad
    loss = 0.0
    grad_cov0 = np.zeros_like(covs[0])
    for c in used:
        diff = covs[c] - covs[0]
        loss += float(np.sum(diff * diff))
        g_cov = 2.0 * diff / len(used)
        grad[members[c]] += (
            2.0 * (x[members[c]] - means[c]) @ g_cov / (members[c].size - 1)
        )
        grad_cov0 -= g_cov
    grad[members[0]] += (
        2.0 * (x[members[0]] - means[0]) @ grad_cov0 / (members[0].size - 1)
    )
    return loss / len(used), grad
