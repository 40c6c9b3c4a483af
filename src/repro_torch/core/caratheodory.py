"""Corollary 17 — exact 4-point moment representations, vectorized.

For each block B the coreset stores <= 4 weighted labels from B whose
weighted (1, y, y^2) moments *exactly* match B's.  The paper obtains them via
iterative Caratheodory elimination in R^3 (O(|B| d^3) per block).  Because
the points (y, y^2, 1) all lie on a parabola, a closed form exists:

Let a = min label, c = max label, q_b = largest label < mu, q_a = smallest
label >= mu, V = sum (y - mu)^2.  Any distribution with mean mu supported on
B's labels avoids the open interval (q_b, q_a), so

    V_min = w_b (q_b-mu)^2 + w_a (q_a-mu)^2   (inner two-point, least variance)
    V_max = M0 (mu-a)(c-mu)                   (outer two-point; Bhatia-Davis)

bracket V, and the mixture  lam * outer + (1-lam) * inner  with
lam = (V - V_min)/(V_max - V_min)  matches (M0, M1, M2) exactly with 4
non-negative weights.  This is O(1) per block after segment reductions,
always feasible, and fully vectorized across all blocks — a beyond-paper
constructive simplification (the guarantee only needs *some* exact <=4-point
representation; see Algorithm 3 line 5).

``caratheodory_reduce`` is the paper's generic iterative elimination, kept as
the test oracle.
"""
from __future__ import annotations

import numpy as np

__all__ = ["block_representatives", "caratheodory_reduce"]

_EPS = 1e-12


def block_representatives(y_flat: np.ndarray, block_id: np.ndarray, n_blocks: int,
                          w_flat: np.ndarray | None = None):
    """Exact 4-point representation of every block.

    Args:
      y_flat:   (N,) float64 labels.
      block_id: (N,) int32/int64 block index per cell (blocks tile the signal).
      n_blocks: number of blocks.
      w_flat:   optional (N,) per-point weights (weighted/merge-reduce inputs).

    Returns:
      labels  (n_blocks, 4) float64 — support labels (subset of each block's labels)
      weights (n_blocks, 4) float64 — non-negative, sum = block mass
      moments (n_blocks, 3) float64 — (M0, M1, M2), exact
    """
    y = np.asarray(y_flat, np.float64)
    bid = np.asarray(block_id)
    if w_flat is not None:
        w = np.asarray(w_flat, np.float64)
        keep = w > 0
        y, bid, w = y[keep], bid[keep], w[keep]
        M0 = np.bincount(bid, weights=w, minlength=n_blocks)
        M1 = np.bincount(bid, weights=w * y, minlength=n_blocks)
        M2 = np.bincount(bid, weights=w * y * y, minlength=n_blocks)
    else:
        M0 = np.bincount(bid, minlength=n_blocks).astype(np.float64)
        M1 = np.bincount(bid, weights=y, minlength=n_blocks)
        M2 = np.bincount(bid, weights=y * y, minlength=n_blocks)
    safe = np.maximum(M0, 1.0)
    mu = M1 / safe
    V = np.maximum(M2 - M1 * M1 / safe, 0.0)

    a = np.full(n_blocks, np.inf)
    c = np.full(n_blocks, -np.inf)
    np.minimum.at(a, bid, y)
    np.maximum.at(c, bid, y)

    mu_cell = mu[bid]
    q_a = np.full(n_blocks, np.inf)     # smallest label >= mu
    q_b = np.full(n_blocks, -np.inf)    # largest label  <  mu
    ge = y >= mu_cell
    np.minimum.at(q_a, bid[ge], y[ge])
    lt = ~ge
    np.maximum.at(q_b, bid[lt], y[lt])
    # constant / one-sided blocks: collapse the brackets onto the mean
    q_a = np.where(np.isfinite(q_a), q_a, mu)
    q_b = np.where(np.isfinite(q_b), q_b, np.where(np.isfinite(q_a), q_a, mu))
    a = np.where(np.isfinite(a), a, mu)
    c = np.where(np.isfinite(c), c, mu)

    # ---- inner two-point {q_b, q_a}: mean mu, least variance --------------
    span_i = q_a - q_b
    wi_b = np.where(span_i > _EPS, M0 * (q_a - mu) / np.maximum(span_i, _EPS), M0)
    wi_a = M0 - wi_b
    V_min = wi_b * (q_b - mu) ** 2 + wi_a * (q_a - mu) ** 2

    # ---- outer two-point {a, c}: mean mu, max variance (Bhatia-Davis) -----
    span_o = c - a
    wo_a = np.where(span_o > _EPS, M0 * (c - mu) / np.maximum(span_o, _EPS), M0)
    wo_c = M0 - wo_a
    V_max = wo_a * (a - mu) ** 2 + wo_c * (c - mu) ** 2

    denom = V_max - V_min
    lam = np.where(denom > _EPS, (V - V_min) / np.maximum(denom, _EPS), 0.0)
    lam = np.clip(lam, 0.0, 1.0)

    labels = np.stack([a, q_b, q_a, c], axis=1)
    weights = np.stack([lam * wo_a, (1 - lam) * wi_b,
                        (1 - lam) * wi_a, lam * wo_c], axis=1)
    weights = np.maximum(weights, 0.0)
    # Exactness is preserved up to fp rounding; renormalize the count so
    # downstream mass bookkeeping (Algorithm 5) sees sum(u) == |B| exactly.
    scale = M0 / np.maximum(weights.sum(axis=1), _EPS)
    weights = weights * np.where(M0 > 0, scale, 0.0)[:, None]
    moments = np.stack([M0, M1, M2], axis=1)
    return labels, weights, moments


# --------------------------------------------------------------------------
def caratheodory_reduce(points: np.ndarray, weights: np.ndarray):
    """Classic iterative Caratheodory (Theorem 16): reduce a weighted set in
    R^d to <= d+1 points with the same weighted sum and total weight.

    Reference implementation / test oracle. O(n d^3).
    """
    P = np.asarray(points, np.float64)
    w = np.asarray(weights, np.float64).copy()
    n, d = P.shape
    idx = np.arange(n)
    alive = w > 0
    while alive.sum() > d + 1:
        act = idx[alive][: d + 2]
        A = P[act]  # (d+2, d)
        # affine dependence: sum lam_i A_i = 0, sum lam_i = 0, lam != 0
        M = np.concatenate([A.T, np.ones((1, act.size))], axis=0)  # (d+1, d+2)
        _, _, vh = np.linalg.svd(M)
        lam = vh[-1]
        pos = lam > 1e-15
        if not pos.any():
            lam = -lam
            pos = lam > 1e-15
        ratios = w[act][pos] / lam[pos]
        j_local = int(np.argmin(ratios))
        alpha = float(ratios[j_local])
        w[act] = np.maximum(w[act] - alpha * lam, 0.0)
        w[act[np.flatnonzero(pos)[j_local]]] = 0.0  # exact elimination
        alive = w > 0
    keep = idx[alive]
    return keep, w[keep]
