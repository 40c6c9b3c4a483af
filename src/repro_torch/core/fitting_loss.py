"""Algorithm 5 (FITTING-LOSS) — evaluate any k-segmentation against the coreset.

Two-phase vectorized evaluation, mirroring the paper's case analysis:

  * non-intersected blocks (z = 1 distinct value): the covering leaf's label
    lam gives the *exact* loss  M2 - 2 lam M1 + lam^2 M0  (moment matching,
    Case (i) of Claim 14.1);
  * intersected blocks: the smoothed-assignment loss.  Leaves consume the
    block's point-weight mass in leaf order; with Z = cumsum of per-leaf
    overlap counts and U = cumsum of point weights, the mass of point i
    assigned to leaf l is the overlap of the intervals [Z_{l-1}, Z_l) and
    [U_{i-1}, U_i) — a closed form for the paper's while-loop (lines 9-25),
    vectorized over (blocks x leaves x 4).  Any consistent consumption order
    yields a valid "smoothed version" (Eqs. 9-11), so Lemma 14's guarantee
    applies unchanged.

Complexity O(|B2| * k) + O(|B|), matching the paper's O(k |C|) bound with the
balanced-partition promise |B2| << |B|.
"""
from __future__ import annotations

import numpy as np

__all__ = ["fitting_loss", "true_loss", "overlap_counts"]


def overlap_counts(block_rects: np.ndarray, seg_rects: np.ndarray) -> np.ndarray:
    """(B, K) cell-count overlaps between block and leaf rectangles."""
    br = block_rects[:, None, :]
    sr = seg_rects[None, :, :]
    dr = np.clip(np.minimum(br[..., 1], sr[..., 1]) - np.maximum(br[..., 0], sr[..., 0]), 0, None)
    dc = np.clip(np.minimum(br[..., 3], sr[..., 3]) - np.maximum(br[..., 2], sr[..., 2]), 0, None)
    return (dr * dc).astype(np.float64)


def fitting_loss(coreset, seg_rects: np.ndarray, seg_labels: np.ndarray,
                 chunk: int = 8192) -> float:
    """FITTING-LOSS((C, u), s): (1 +/- eps)-approximation of ell(D, s).

    ``seg_rects`` (K, 4) half-open leaf rectangles tiling [n] x [m];
    ``seg_labels`` (K,) their values.
    """
    seg_rects = np.asarray(seg_rects, np.int64).reshape(-1, 4)
    seg_labels = np.asarray(seg_labels, np.float64).ravel()
    B = coreset.num_blocks
    rects = coreset.rects
    M0, M1, M2 = coreset.moments[:, 0], coreset.moments[:, 1], coreset.moments[:, 2]

    # Phase 1: candidate covering leaf = the leaf containing each block's
    # top-left cell; a block is non-intersected iff that leaf covers it fully.
    r0, c0 = rects[:, 0], rects[:, 2]
    cover = np.full(B, -1, np.int64)
    for s in range(0, B, chunk):
        e = min(s + chunk, B)
        inside = ((seg_rects[None, :, 0] <= r0[s:e, None]) & (r0[s:e, None] < seg_rects[None, :, 1]) &
                  (seg_rects[None, :, 2] <= c0[s:e, None]) & (c0[s:e, None] < seg_rects[None, :, 3]))
        cover[s:e] = np.argmax(inside, axis=1)
        cover[s:e][~inside.any(axis=1)] = -1
    cov_rect = seg_rects[np.maximum(cover, 0)]
    full = ((cover >= 0) &
            (cov_rect[:, 0] <= rects[:, 0]) & (rects[:, 1] <= cov_rect[:, 1]) &
            (cov_rect[:, 2] <= rects[:, 2]) & (rects[:, 3] <= cov_rect[:, 3]))

    lam = seg_labels[np.maximum(cover, 0)]
    exact = np.where(full, M2 - 2.0 * lam * M1 + lam * lam * M0, 0.0)
    loss = float(np.maximum(exact, 0.0).sum())

    # Phase 2: smoothed assignment for the intersected blocks only.
    idx = np.flatnonzero(~full)
    if idx.size:
        U = np.cumsum(coreset.weights[idx], axis=1)            # (b, 4)
        Uprev = U - coreset.weights[idx]
        lbl = coreset.labels[idx]                               # (b, 4)
        for s in range(0, idx.size, chunk):
            sl = idx[s:s + chunk]
            z = overlap_counts(rects[sl], seg_rects)            # (b, K)
            Z = np.cumsum(z, axis=1)
            Zprev = Z - z
            lo = np.maximum(Zprev[:, :, None], Uprev[s:s + chunk, None, :])
            hi = np.minimum(Z[:, :, None], U[s:s + chunk, None, :])
            consumed = np.clip(hi - lo, 0.0, None)              # (b, K, 4)
            diff = seg_labels[None, :, None] - lbl[s:s + chunk, None, :]
            loss += float((consumed * diff * diff).sum())
    return loss


def true_loss(values: np.ndarray, seg_rects: np.ndarray, seg_labels: np.ndarray,
              ps=None) -> float:
    """Exact ell(D, s) on the full signal (for tests / baselines), O(K) via SAT."""
    from .stats import PrefixStats
    if ps is None:
        ps = PrefixStats.build(np.asarray(values, np.float64))
    seg_rects = np.asarray(seg_rects, np.int64).reshape(-1, 4)
    lam = np.asarray(seg_labels, np.float64).ravel()
    s0, s1, s2 = ps.sums(seg_rects[:, 0], seg_rects[:, 1], seg_rects[:, 2], seg_rects[:, 3])
    return float(np.maximum(s2 - 2.0 * lam * s1 + lam * lam * s0, 0.0).sum())
