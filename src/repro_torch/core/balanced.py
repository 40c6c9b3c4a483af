"""Algorithm 2 (PARTITION) — the balanced partition of the signal.

The "simplicial partition for SSE" (Definition 6 / Lemma 7): a partition of
the signal into rectangles such that (i) the number of rectangles depends on
alpha/gamma^2 but not on N, (ii) every rectangle has opt1 <= gamma^2 * sigma,
and (iii) any k-segmentation intersects only O(k*alpha/gamma) of them.

Bands of rows are grown greedily while their SLICEPARTITION stays within
1/gamma slices; when adding a row would overflow, the previous band's
partition is committed (Fig. 2 of the paper, including the single-row
overflow case, which is committed as-is).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .slice_partition import Rect, slice_partition, slices_count_if
from .stats import PrefixStats

__all__ = ["balanced_partition", "BalancedPartition"]


@dataclasses.dataclass(frozen=True)
class BalancedPartition:
    """Result of Algorithm 2 plus bookkeeping used by the coreset proofs."""

    rects: np.ndarray          # (B, 4) int64 rows of (r0, r1, c0, c1)
    band_bounds: np.ndarray    # (H+1,) row indices of committed horizontal bands
    tolerance: float           # gamma^2 * sigma: upper bound on each opt1(B)

    @property
    def num_blocks(self) -> int:
        return int(self.rects.shape[0])

    def block_id_raster(self, n: int, m: int) -> np.ndarray:
        """(n, m) int32 map cell -> block index (blocks tile the signal)."""
        out = np.full((n, m), -1, dtype=np.int32)
        for i, (r0, r1, c0, c1) in enumerate(self.rects):
            out[r0:r1, c0:c1] = i
        if (out < 0).any():
            raise AssertionError("balanced partition does not tile the signal")
        return out


def balanced_partition(ps: PrefixStats, tolerance: float,
                       max_slices: int) -> BalancedPartition:
    """PARTITION(D, gamma, sigma); see Lemma 7.

    In the paper's parameterization ``tolerance = gamma^2 * sigma`` and
    ``max_slices = 1/gamma``; they are decoupled here so the practical mode
    can pick the per-block opt1 cap and the band-width cap independently
    (see ``signal_coreset`` for both settings).
    """
    if tolerance < 0:
        raise ValueError("tolerance must be >= 0")
    n, m = ps.shape
    tol = float(tolerance)
    max_slices = max(int(max_slices), 1)

    rects: list[Rect] = []
    band_bounds = [0]
    r0 = 0
    while r0 < n:
        # Find the maximal band [r0, r1) whose partition fits in max_slices,
        # by exponential growth + binary search over the (monotone) slice
        # count — O(log H) early-exit counts per band instead of the paper's
        # one-row-at-a-time O(H) repartitions.  (If the count is locally
        # non-monotone the committed band is merely narrower than maximal,
        # which affects no guarantee — every block still satisfies the
        # tolerance and the cap.)
        if slices_count_if(ps, r0, r0 + 1, tol, stop_above=max_slices) > max_slices:
            # single-row overflow: committed as-is (Fig. 2, yellow case)
            cur = slice_partition(ps, r0, r0 + 1, tol)
            r1 = r0 + 1
        else:
            step, r1 = 1, r0 + 1
            while r1 < n:
                cand = min(r1 + step, n)
                if slices_count_if(ps, r0, cand, tol, stop_above=max_slices) <= max_slices:
                    r1 = cand
                    step *= 2
                else:
                    break
            lo, hi = r1, min(r1 + step, n)  # invariant: [r0, lo) fits
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if slices_count_if(ps, r0, mid, tol, stop_above=max_slices) <= max_slices:
                    lo = mid
                else:
                    hi = mid - 1
            r1 = lo
            cur = slice_partition(ps, r0, r1, tol)
        rects.extend(cur)
        band_bounds.append(r1)
        r0 = r1

    return BalancedPartition(
        rects=np.asarray(rects, dtype=np.int64).reshape(-1, 4),
        band_bounds=np.asarray(band_bounds, dtype=np.int64),
        tolerance=float(tol),
    )
