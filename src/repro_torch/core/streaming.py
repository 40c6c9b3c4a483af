"""Coresets of weighted sparse signals, and their composition (paper §1.1).

Coresets of disjoint sub-signals *compose*: if (C_i, u_i) is a (k, eps)-
coreset of row-band D_i, the union is a (k, eps)-coreset of D = U D_i — a
k-segmentation restricted to a band is still a <=k-segmentation, and the
per-band multiplicative errors add up to eps * ell(D, s).  ``compose`` is
therefore exact concatenation (with row offsets).

``weighted_signal_coreset`` runs SIGNAL-CORESET over weighted points on the
grid; ``signal_coreset(mask=...)`` goes through it, so held-out cells carry
no mass (the §5 missing-value protocol).

This is the masked-build half of the reference's ``core/streaming.py``.
Re-compression (``recompress``, ``ops.streaming_compress``) and the
merge-reduce ``StreamingBuilder`` come with the write-path slice of the
port.
"""
from __future__ import annotations

import time

import numpy as np

from .balanced import balanced_partition
from .bicriteria import bicriteria
from .caratheodory import block_representatives
from .coreset import SignalCoreset, resolve_partition_params
from .segmentation import greedy_tree
from .stats import PrefixStats

__all__ = ["compose", "weighted_signal_coreset"]


def compose(coresets: list[SignalCoreset], row_offsets: list[int], n_total: int,
            ) -> SignalCoreset:
    """Union of per-band coresets -> coreset of the stacked signal."""
    if not coresets:
        raise ValueError("need at least one coreset")
    m = coresets[0].m
    rects = []
    for cs, off in zip(coresets, row_offsets):
        r = cs.rects.copy()
        r[:, 0] += off
        r[:, 1] += off
        rects.append(r)
    return SignalCoreset(
        n=n_total, m=m, k=coresets[0].k,
        eps=max(c.eps for c in coresets),
        rects=np.concatenate(rects, axis=0),
        labels=np.concatenate([c.labels for c in coresets], axis=0),
        weights=np.concatenate([c.weights for c in coresets], axis=0),
        moments=np.concatenate([c.moments for c in coresets], axis=0),
        sigma=min(c.sigma for c in coresets),
        tolerance=min(c.tolerance for c in coresets),
        max_slices=max(c.max_slices for c in coresets),
        bicriteria=coresets[0].bicriteria,
        build_seconds=sum(c.build_seconds for c in coresets),
        certified=all(c.certified for c in coresets),
    )


def _raster_moments(n: int, m: int, rows, cols, labels, weights):
    w0 = np.zeros((n, m), np.float64)
    w1 = np.zeros((n, m), np.float64)
    w2 = np.zeros((n, m), np.float64)
    np.add.at(w0, (rows, cols), weights)
    np.add.at(w1, (rows, cols), weights * labels)
    np.add.at(w2, (rows, cols), weights * labels * labels)
    return w0, w1, w2


def weighted_signal_coreset(n: int, m: int, rows: np.ndarray, cols: np.ndarray,
                            labels: np.ndarray, weights: np.ndarray, k: int,
                            eps: float, *, fidelity: str = "practical",
                            tolerance_override: float | None = None,
                            max_slices_override: int | None = None,
                            _sigma_hint=None) -> SignalCoreset:
    """SIGNAL-CORESET over a weighted sparse signal (points on the grid).

    All pipeline stages only consume (sum w, sum w y, sum w y^2) rasters, so
    the generalization is direct; the rasters are integrated on the host
    (``PrefixStats.build_moments``), as in the reference.
    """
    t0 = time.perf_counter()
    rows = np.asarray(rows, np.int64); cols = np.asarray(cols, np.int64)
    labels = np.asarray(labels, np.float64); weights = np.asarray(weights, np.float64)
    w0, w1, w2 = _raster_moments(n, m, rows, cols, labels, weights)

    ps = PrefixStats.build_moments(w0, w1, w2)
    if _sigma_hint is not None:       # size-bisection path: sigma known
        sigma, certified, bic = _sigma_hint
    else:
        bic = bicriteria(None, k, fidelity=fidelity, moments=(w0, w1, w2))
        sigma = bic.sigma
        certified = True
        if fidelity != "paper":
            # heuristic sigma floor (see signal_coreset): greedy k-tree loss/4
            g = greedy_tree(ps, k)
            s0, s1, s2 = ps.sums(g.rects[:, 0], g.rects[:, 1], g.rects[:, 2], g.rects[:, 3])
            heur = float(np.maximum(s2 - s1 * s1 / np.maximum(s0, 1e-300), 0.0).sum()) / 6.0
            if heur > sigma:
                sigma, certified = heur, False
    tol, max_slices = resolve_partition_params(sigma, k, eps, fidelity, bic.alpha_hat)
    if tolerance_override is not None:
        tol = float(tolerance_override)
    if max_slices_override is not None:
        max_slices = int(max_slices_override)

    part = balanced_partition(ps, tol, max_slices)
    raster = part.block_id_raster(n, m)
    bid_pts = raster[rows, cols]
    lab4, w4, mom = block_representatives(labels, bid_pts, part.num_blocks,
                                          w_flat=weights)
    keep = mom[:, 0] > 0  # drop mass-less blocks (all-empty regions)
    return SignalCoreset(
        n=n, m=m, k=k, eps=eps,
        rects=part.rects[keep], labels=lab4[keep], weights=w4[keep],
        moments=mom[keep], sigma=float(sigma), tolerance=tol,
        max_slices=max_slices, bicriteria=bic,
        build_seconds=time.perf_counter() - t0, certified=certified,
    )
