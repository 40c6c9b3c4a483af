"""Algorithm 4 (BICRITERIA) — the (alpha, beta)_k approximation (Lemma 5/10/11).

The coreset pipeline only consumes a scalar from this stage: a lower bound
``sigma <= opt_k(D)``.  We compute the *maximum of several certified lower
bounds* (each valid by the paper's own intersection-counting argument —
Observation 9 + "keep the blocks any k-segmentation cannot all intersect"):

(a) **Iterative removal** (the paper's Algorithm 4): per iteration, candidate
    disjoint sub-signals are formed (heavy-row 1-dim split / row-groups x
    column-intervals / heavy columns); discarding as many blocks as any
    k-segmentation could intersect and keeping the smallest-opt1 remainder
    gives  sum_{B in kept_i} opt1(B) <= opt_k(D)  (Lemma 10(i)).  The
    intersection budget z is computed *adaptively* from the candidate
    geometry:  z = 2k * (H + V), where H (resp. V) is the max number of
    blocks of height >= 2 (resp. width >= 2) that one horizontal (resp.
    vertical) boundary line can strictly cross — exactly the quantity the
    paper's proof bounds with worst-case constants.

(b) **Per-row / per-column 1-dim bounds**: the restriction of the optimal
    k-segmentation to any single row is a <= k-segmentation of that row, so
    sum_i opt_k(row_i) <= opt_k(D); each opt_k(row_i) is itself lower-bounded
    by the 1-dim interval scheme (t' = 4k equal intervals, keep the t'-2k
    smallest opt1 — Lemma 10, 1-dim case).  Columns likewise.  These are
    O(N) and much tighter than (a) on noisy signals when N >> k but
    N << 64 k^2 (the regime where (a)'s grouped scheme degenerates — which
    includes the paper's own experiments; see DESIGN.md §3).

``fidelity="paper"`` restores the paper's worst-case constants
(nu > 50, gamma_1d >= 8, r = 2(nu k)^2) for the theory-faithful path.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .stats import PrefixStats, opt1_from_sums

__all__ = ["bicriteria", "BicriteriaResult"]


@dataclasses.dataclass
class BicriteriaResult:
    sigma: float            # certified lower bound on opt_k(D): max of all bounds
    ell: float              # loss of the (alpha,beta)_k segmentation s (iterative scheme)
    alpha_hat: float        # ell / sigma (realized alpha)
    n_iterations: int
    n_blocks: int           # number of blocks of s (incl. final singletons)
    iter_losses: list[float]
    sigma_iter: float = 0.0     # bound (a)
    sigma_rows: float = 0.0     # bound (b), rows
    sigma_cols: float = 0.0     # bound (b), columns


def _keep_smallest(opt1s: np.ndarray, z: int) -> np.ndarray:
    """Indices of the |B'|-z blocks with smallest opt1 (at least 1 kept;
    keeping a subset of the smallest only shrinks the certified sum)."""
    keep = max(1, opt1s.size - z)
    return np.argpartition(opt1s, keep - 1)[:keep] if keep < opt1s.size else np.arange(opt1s.size)


# --------------------------------------------------------------- bound (b)
def _rowwise_interval_bound(w0: np.ndarray, w1: np.ndarray, w2: np.ndarray,
                            k: int) -> float:
    """sum_i [ sum of the (t'-2k) smallest opt1 over t'=4k equal column
    intervals of row i ]  <=  sum_i opt_k(row_i)  <=  opt_k(D)."""
    n, m = w0.shape
    t = max(4 * k, 4)
    if m < 2:
        return 0.0
    bounds = np.unique(np.linspace(0, m, min(t, m) + 1).astype(np.int64))
    p0 = np.concatenate([np.zeros((n, 1)), np.cumsum(w0, axis=1)], axis=1)
    p1 = np.concatenate([np.zeros((n, 1)), np.cumsum(w1, axis=1)], axis=1)
    p2 = np.concatenate([np.zeros((n, 1)), np.cumsum(w2, axis=1)], axis=1)
    lo, hi = bounds[:-1], bounds[1:]
    s0 = p0[:, hi] - p0[:, lo]
    s1 = p1[:, hi] - p1[:, lo]
    s2 = p2[:, hi] - p2[:, lo]
    o = opt1_from_sums(s0, s1, s2)                     # (n, t)
    keep = max(o.shape[1] - 2 * k, 0)
    if keep == 0:
        return 0.0
    o_sorted = np.sort(o, axis=1)[:, :keep]
    return float(o_sorted.sum())


# --------------------------------------------------------------------- main
def bicriteria(values: np.ndarray | None, k: int, *, nu: float = 8.0,
               gamma_1d: float = 4.0, fidelity: str = "practical",
               moments: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None,
               max_practical_iters: int = 8) -> BicriteriaResult:
    """Compute the (alpha, beta)_k bi-criteria approximation of Lemma 5.

    Either ``values`` (dense signal) or ``moments`` = (w0, w1, w2) per-cell
    moment rasters (weighted/sparse signal, used by merge-reduce).

    In practical mode the iterative scheme is capped at
    ``max_practical_iters`` iterations: the paper's own analysis needs
    Theta(k log N) iterations each removing a 1/O(k) fraction (that is the
    O(Nk) in Theorem 8), and at practical N its certified bound is dominated
    by the O(N) row/column bounds anyway — see the profile notes in
    EXPERIMENTS.md.  ``fidelity="paper"`` runs it to completion.
    """
    if fidelity == "paper":
        nu, gamma_1d = 51.0, 8.0
    if moments is None:
        y = np.asarray(values, dtype=np.float64)
        w0, w1, w2 = np.ones_like(y), y, y * y
    else:
        w0, w1, w2 = (np.asarray(a, np.float64) for a in moments)
    n, m = w0.shape
    N = n * m
    live = w0 > 0
    n_live = float(w0.sum())
    threshold = max(int(k * math.log2(N + 1)), 4)

    sigma_rows = _rowwise_interval_bound(w0, w1, w2, k)
    sigma_cols = _rowwise_interval_bound(w0.T, w1.T, w2.T, k)

    iter_losses: list[float] = []
    total_loss = 0.0
    n_blocks = 0
    max_iters = int(8 * nu * k * math.log2(N + 2)) + 16  # safety valve
    if fidelity != "paper":
        max_iters = min(max_iters, max_practical_iters)

    for _ in range(max_iters):
        if n_live <= threshold:
            break
        ps = PrefixStats.build_moments(w0, w1, w2, mask=live)
        row_sizes = ps.p0[1:, -1] - ps.p0[:-1, -1]   # live mass per row
        heavy_row_thresh = n_live / (nu * k)

        hr = int(np.argmax(row_sizes))
        if row_sizes[hr] >= heavy_row_thresh and row_sizes[hr] > 0:
            # ---- 1-dim case on the heavy row (Alg. 4 lines 4-6) ----------
            opt1s, rects = _heavy_row_candidates(ps, hr, float(row_sizes[hr]),
                                                 max(int(gamma_1d * k), 4))
            keep = _keep_smallest(opt1s, 2 * k)
        else:
            groups = _row_groups(row_sizes, heavy_row_thresh)
            # heavy-column decision threshold: a constant mass fraction in
            # practical mode (the paper's 1/(2(nu k)^2) declares near-every
            # column heavy at practical N, forcing the slow case (ii));
            # interval count inside light groups stays ~8k per the z-budget.
            col_frac = 2.0 * (nu * k) ** 2 if fidelity == "paper" else 8.0
            t_split = (2.0 * (nu * k) ** 2 if fidelity == "paper"
                       else float(max(8 * k, 4)))
            cand = _grouped_candidates(ps, groups, col_frac, t_split, k)
            if cand is None:
                break  # degenerate tiny remainder; finish with singletons
            opt1s, rects, z = cand
            keep = _keep_smallest(opt1s, z)

        kept_loss = float(opt1s[keep].sum())
        iter_losses.append(kept_loss)
        total_loss += kept_loss
        n_blocks += keep.size
        for idx in keep:
            r0, r1, c0, c1 = rects[idx]
            live[r0:r1, c0:c1] = False
        new_live = float(w0[live].sum())
        if n_live - new_live <= 0:
            break  # safety: guarantee progress
        n_live = new_live

    # Remaining cells become singleton blocks (opt1 = 0): contribute no loss.
    n_blocks += int(live.sum())
    sigma_iter = max(iter_losses) if iter_losses else 0.0
    sigma = max(sigma_iter, sigma_rows, sigma_cols)
    return BicriteriaResult(
        sigma=float(sigma),
        ell=float(total_loss),
        alpha_hat=float(total_loss / sigma) if sigma > 0 else 1.0,
        n_iterations=len(iter_losses),
        n_blocks=n_blocks,
        iter_losses=iter_losses,
        sigma_iter=float(sigma_iter),
        sigma_rows=float(sigma_rows),
        sigma_cols=float(sigma_cols),
    )


# --------------------------------------------------------------------------
def _heavy_row_candidates(ps: PrefixStats, row: int, row_mass: float, t_prime: int):
    """Split the heavy row's live mass into t' contiguous ~equal-mass column
    intervals; return their opt1s and rects."""
    n, m = ps.shape
    cum = ps.p0[row + 1, :] - ps.p0[row, :]          # (m+1,) cumulative live mass
    targets = np.arange(1, t_prime + 1) * (row_mass / t_prime)
    bounds = np.unique(np.clip(np.searchsorted(cum, targets - 1e-9, side="left"), 1, m))
    starts = np.concatenate([[0], bounds[:-1]])
    s0, s1, s2 = ps.sums(row, row + 1, starts, bounds)
    opt1s = opt1_from_sums(s0, s1, s2)
    rects = [(row, row + 1, int(a), int(b)) for a, b in zip(starts, bounds)]
    return opt1s, rects


def _row_groups(row_sizes: np.ndarray, target: float) -> list[tuple[int, int]]:
    """Greedy contiguous row groups with live mass in [target, 3*target)
    (tail merged into its predecessor)."""
    groups: list[tuple[int, int]] = []
    acc, start = 0.0, 0
    n = row_sizes.size
    for i in range(n):
        acc += row_sizes[i]
        if acc >= target:
            groups.append((start, i + 1))
            start, acc = i + 1, 0.0
    if start < n:
        if groups:
            g0, _ = groups.pop()
            groups.append((g0, n))
        else:
            groups.append((0, n))
    return groups


def _grouped_candidates(ps: PrefixStats, groups: list[tuple[int, int]],
                        col_frac: float, t_split: float, k: int):
    """Cases (i)/(ii) of Lemma 10: column-interval blocks of light groups, or
    the heavy column of each heavy group.  Returns (opt1s, rects, z)."""
    m = ps.shape[1]
    light, heavy = [], []   # (g0, g1, size) / (g0, g1, col)
    for g0, g1 in groups:
        col_counts = np.diff(ps.p0[g1, :] - ps.p0[g0, :])
        size = float(col_counts.sum())
        if size <= 0:
            continue
        thresh = size / col_frac
        hc = int(np.argmax(col_counts))
        if col_counts[hc] >= thresh and col_counts[hc] > 0:
            heavy.append((g0, g1, hc))
        else:
            light.append((g0, g1, size))

    if not light and not heavy:
        return None

    rects: list[tuple[int, int, int, int]] = []
    if len(light) >= len(heavy) and light:
        # Case (i): vertically partition every light group into ~equal-mass
        # column intervals (each column is lighter than the target, so the
        # greedy split is feasible).
        max_per_group = 1
        for g0, g1, size in light:
            cum = ps.p0[g1, :] - ps.p0[g0, :]
            t_g = max(int(t_split), 1)
            targets = np.arange(1, t_g + 1) * (size / t_g)
            bounds = np.unique(np.clip(np.searchsorted(cum, targets - 1e-9, "left"), 1, m))
            starts = np.concatenate([[0], bounds[:-1]])
            for a, b in zip(starts, bounds):
                rects.append((g0, g1, int(a), int(b)))
            max_per_group = max(max_per_group, len(bounds))
        # Adaptive budget: one horizontal boundary line lies inside exactly
        # one group -> crosses <= (intervals of that group) blocks; one
        # vertical line crosses <= 1 interval per group.
        z = 2 * k * (max_per_group + len(light))
    else:
        # Case (ii): the heaviest column of each heavy group.  Single-column
        # blocks cannot be split by vertical boundaries, and a horizontal
        # line lies inside exactly one group -> z = 2k (the 1-dim budget).
        for g0, g1, hc in heavy:
            rects.append((g0, g1, hc, hc + 1))
        z = 2 * k

    arr = np.asarray(rects, dtype=np.int64)
    s0, s1, s2 = ps.sums(arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3])
    opt1s = opt1_from_sums(s0, s1, s2)
    return opt1s, rects, z
