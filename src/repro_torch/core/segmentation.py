"""k-segmentations and k-trees of signals: models, samplers, solvers, oracles.

A k-segmentation (Definition 1) is represented extensionally as K half-open
rectangles tiling [n] x [m] plus a label per rectangle.  k-trees (recursive
guillotine partitions — the decision-tree special case) are generated/solved
here:

  * ``random_tree_segmentation`` — uniform-ish random recursive splits
    (query sampler for guarantee tests);
  * ``greedy_tree`` — top-down best-split CART on the *signal domain* using
    O(1) SAT gain queries (the "train on full data" baseline of §5);
  * ``optimal_tree_dp`` — exact minimum-loss k-tree by exhaustive
    rectangle-split DP (tiny grids only; the test oracle);
  * ``segment_1d_dp`` — exact 1D k-segmentation DP (O(n^2 k)).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .stats import PrefixStats

__all__ = [
    "Segmentation", "random_tree_segmentation", "greedy_tree",
    "optimal_tree_dp", "segment_1d_dp", "optimal_labels",
]


@dataclasses.dataclass(frozen=True)
class Segmentation:
    rects: np.ndarray    # (K, 4) int64 half-open (r0, r1, c0, c1)
    labels: np.ndarray   # (K,) float64

    @property
    def k(self) -> int:
        return int(self.rects.shape[0])

    def assignment_raster(self, n: int, m: int) -> np.ndarray:
        out = np.full((n, m), np.nan)
        for (r0, r1, c0, c1), lam in zip(self.rects, self.labels):
            out[r0:r1, c0:c1] = lam
        return out


def optimal_labels(ps: PrefixStats, rects: np.ndarray) -> np.ndarray:
    """Per-rectangle mean labels (the loss-minimizing assignment)."""
    rects = np.asarray(rects, np.int64).reshape(-1, 4)
    s0, s1, _ = ps.sums(rects[:, 0], rects[:, 1], rects[:, 2], rects[:, 3])
    return np.where(s0 > 0, s1 / np.maximum(s0, 1e-300), 0.0)


# ------------------------------------------------------------------ samplers
def random_tree_segmentation(n: int, m: int, k: int, rng: np.random.Generator,
                             labels: str | np.ndarray = "random") -> Segmentation:
    """Random k-leaf guillotine tree over [n] x [m]."""
    rects = [(0, n, 0, m)]
    while len(rects) < k:
        # pick a splittable rect, biased by area
        areas = np.array([(r1 - r0) * (c1 - c0) for r0, r1, c0, c1 in rects], float)
        splittable = np.array([(r1 - r0 > 1) or (c1 - c0 > 1) for r0, r1, c0, c1 in rects])
        if not splittable.any():
            break
        p = areas * splittable
        i = rng.choice(len(rects), p=p / p.sum())
        r0, r1, c0, c1 = rects.pop(i)
        axes = [a for a, ok in ((0, r1 - r0 > 1), (1, c1 - c0 > 1)) if ok]
        ax = axes[rng.integers(len(axes))]
        if ax == 0:
            s = int(rng.integers(r0 + 1, r1))
            rects += [(r0, s, c0, c1), (s, r1, c0, c1)]
        else:
            s = int(rng.integers(c0 + 1, c1))
            rects += [(r0, r1, c0, s), (r0, r1, s, c1)]
    rect_arr = np.asarray(rects, np.int64)
    if isinstance(labels, str) and labels == "random":
        lab = rng.normal(size=len(rects))
    else:
        lab = np.asarray(labels, np.float64)
    return Segmentation(rect_arr, lab)


# ------------------------------------------------------------ greedy solver
def greedy_tree(ps: PrefixStats, k: int, min_cells: int = 1,
                rect: tuple[int, int, int, int] | None = None) -> Segmentation:
    """Top-down best-first k-tree: repeatedly split the leaf with the largest
    SSE reduction over all axis/positions (O(1) gain per candidate via SAT).
    Mean labels.  This is the full-data CART baseline on the signal domain.
    """
    import heapq
    n, m = ps.shape
    root = rect or (0, n, 0, m)

    def best_split(r0, r1, c0, c1):
        base = float(ps.opt1(r0, r1, c0, c1))
        best = (0.0, None)
        if r1 - r0 >= 2 * min_cells:
            ss = np.arange(r0 + min_cells, r1 - min_cells + 1)
            g = base - ps.opt1(r0, ss, c0, c1) - ps.opt1(ss, r1, c0, c1)
            j = int(np.argmax(g))
            if g[j] > best[0]:
                best = (float(g[j]), (0, int(ss[j])))
        if c1 - c0 >= 2 * min_cells:
            ss = np.arange(c0 + min_cells, c1 - min_cells + 1)
            g = base - ps.opt1(r0, r1, c0, ss) - ps.opt1(r0, r1, ss, c1)
            j = int(np.argmax(g))
            if g[j] > best[0]:
                best = (float(g[j]), (1, int(ss[j])))
        return best

    heap = []
    counter = 0

    def push(rc):
        nonlocal counter
        gain, split = best_split(*rc)
        if split is not None:
            heapq.heappush(heap, (-gain, counter, rc, split))
            counter += 1

    leaves = [root]
    push(root)
    while len(leaves) < k and heap:
        neg_gain, _, rc, (ax, s) = heapq.heappop(heap)
        if -neg_gain <= 0:
            break
        if rc not in leaves:
            continue
        leaves.remove(rc)
        r0, r1, c0, c1 = rc
        kids = ([(r0, s, c0, c1), (s, r1, c0, c1)] if ax == 0
                else [(r0, r1, c0, s), (r0, r1, s, c1)])
        leaves += kids
        for kid in kids:
            push(kid)
    rects = np.asarray(leaves, np.int64)
    return Segmentation(rects, optimal_labels(ps, rects))


# ------------------------------------------------------------------- oracles
def optimal_tree_dp(values: np.ndarray, k: int):
    """Exact optimal k-tree loss (and one optimal tree) by DP over
    (rectangle, leaves) — O(n^2 m^2 (n+m) k^2); tiny grids only."""
    y = np.asarray(values, np.float64)
    n, m = y.shape
    ps = PrefixStats.build(y)

    @functools.lru_cache(maxsize=None)
    def solve(r0, r1, c0, c1, kk):
        if kk == 1:
            return float(ps.opt1(r0, r1, c0, c1)), None
        best = solve(r0, r1, c0, c1, 1)
        for s in range(r0 + 1, r1):
            for k1 in range(1, kk):
                a, _ = solve(r0, s, c0, c1, k1)
                b, _ = solve(s, r1, c0, c1, kk - k1)
                if a + b < best[0]:
                    best = (a + b, (0, s, k1))
        for s in range(c0 + 1, c1):
            for k1 in range(1, kk):
                a, _ = solve(r0, r1, c0, s, k1)
                b, _ = solve(r0, r1, s, c1, kk - k1)
                if a + b < best[0]:
                    best = (a + b, (1, s, k1))
        return best

    loss, _ = solve(0, n, 0, m, k)

    def extract(r0, r1, c0, c1, kk):
        _, mv = solve(r0, r1, c0, c1, kk)
        if mv is None:
            return [(r0, r1, c0, c1)]
        ax, s, k1 = mv
        if ax == 0:
            return extract(r0, s, c0, c1, k1) + extract(s, r1, c0, c1, kk - k1)
        return extract(r0, r1, c0, s, k1) + extract(r0, r1, s, c1, kk - k1)

    rects = np.asarray(extract(0, n, 0, m, k), np.int64)
    return loss, Segmentation(rects, optimal_labels(ps, rects))


def segment_1d_dp(values: np.ndarray, k: int):
    """Exact optimal k-segmentation of a 1D signal: O(n^2 k) DP.
    Returns (loss, boundaries) with boundaries of length k+1."""
    y = np.asarray(values, np.float64).ravel()
    n = y.size
    p0 = np.arange(n + 1, dtype=np.float64)
    p1 = np.concatenate([[0.0], np.cumsum(y)])
    p2 = np.concatenate([[0.0], np.cumsum(y * y)])

    def cost(i, j):  # [i, j)
        s0 = p0[j] - p0[i]
        s1 = p1[j] - p1[i]
        s2 = p2[j] - p2[i]
        return max(s2 - s1 * s1 / max(s0, 1e-300), 0.0)

    INF = float("inf")
    dp = np.full((k + 1, n + 1), INF)
    arg = np.zeros((k + 1, n + 1), np.int64)
    dp[0, 0] = 0.0
    for kk in range(1, k + 1):
        for j in range(kk, n + 1):
            best, bi = INF, kk - 1
            for i in range(kk - 1, j):
                v = dp[kk - 1, i] + cost(i, j)
                if v < best:
                    best, bi = v, i
            dp[kk, j], arg[kk, j] = best, bi
    bounds = [n]
    j = n
    for kk in range(k, 0, -1):
        j = int(arg[kk, j])
        bounds.append(j)
    return float(dp[k, n]), np.asarray(bounds[::-1], np.int64)
