"""Synthetic signal generators (sklearn-free stand-ins for the paper's data).

The paper evaluates on (i) UCI Air Quality / Gesture Phase matrices
(instances x features, z-scored, treated as 2D signals) and (ii) the sklearn
blobs/moons/circles point sets rasterized as labeled signals (appendix A).
Neither UCI nor sklearn is reachable offline, so this module regenerates
statistically matched stand-ins:

  * ``sensor_matrix``     — UCI-like: correlated multivariate time series
                            (AR(1) rows, per-feature scales), z-scored;
  * ``piecewise_signal``  — ground-truth k-tree structure + noise;
  * ``smooth_field``      — separable low-frequency cosine field + noise;
  * ``blobs`` / ``moons`` / ``circles`` — re-implementations of the sklearn
    generators, plus ``rasterize`` to turn labeled points into a signal.
"""
from __future__ import annotations

import numpy as np

__all__ = ["sensor_matrix", "piecewise_signal", "smooth_field", "blobs",
           "moons", "circles", "rasterize", "zscore"]


def zscore(a: np.ndarray) -> np.ndarray:
    mu = a.mean(axis=0, keepdims=True)
    sd = a.std(axis=0, keepdims=True)
    return (a - mu) / np.maximum(sd, 1e-12)


def sensor_matrix(n: int = 9358, m: int = 15, rho: float = 0.995,
                  noise: float = 0.02, rank: int = 4, seed: int = 0) -> np.ndarray:
    """AR(1)-in-time, low-rank-across-features sensor matrix, z-scored per
    feature (the paper's Air Quality data: n=9358, m=15 — co-located gas
    sensors share slow drivers, so cross-feature structure is low rank and
    temporal drift is strong)."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(m, rank)) / np.sqrt(rank)
    x = np.empty((n, rank))
    state = rng.normal(size=rank)
    drive = rng.normal(size=(n, rank))
    for t in range(n):
        state = rho * state + np.sqrt(1 - rho * rho) * drive[t]
        x[t] = state
    x = x @ mix.T + noise * rng.normal(size=(n, m))
    return zscore(x)


def piecewise_signal(n: int, m: int, k: int, noise: float = 0.15,
                     scale: float = 2.0, seed: int = 0) -> np.ndarray:
    """Ground-truth k-tree structure + iid noise (the coreset-friendly regime)."""
    from repro_torch.core.segmentation import random_tree_segmentation
    rng = np.random.default_rng(seed)
    seg = random_tree_segmentation(n, m, k, rng)
    base = np.zeros((n, m))
    for (r0, r1, c0, c1), lam in zip(seg.rects, seg.labels):
        base[r0:r1, c0:c1] = lam * scale
    return base + noise * rng.normal(size=(n, m))


def smooth_field(n: int, m: int, freq: int = 3, noise: float = 0.1,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, n)[:, None]
    jj = np.linspace(0, 1, m)[None, :]
    out = np.zeros((n, m))
    for _ in range(freq):
        a, b = rng.uniform(0.5, 4, size=2)
        p, q = rng.uniform(0, 2 * np.pi, size=2)
        out += rng.normal() * np.cos(2 * np.pi * a * ii + p) * np.cos(2 * np.pi * b * jj + q)
    return out + noise * rng.normal(size=(n, m))


# ------------------------------------------------ sklearn-like point clouds
def blobs(n: int = 17000, centers=((0, 0), (4, 4), (-3, 5)),
          fractions=(0.5, 0.34, 0.16), std: float = 1.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    X, y = [], []
    for lab, (c, fr) in enumerate(zip(centers, fractions)):
        cnt = int(n * fr)
        X.append(rng.normal(size=(cnt, 2)) * std + np.asarray(c))
        y.append(np.full(cnt, lab, np.float64))
    return np.concatenate(X), np.concatenate(y)


def moons(n: int = 24000, noise: float = 0.08, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = n // 2
    t = np.pi * rng.uniform(size=h)
    X1 = np.stack([np.cos(t), np.sin(t)], axis=1)
    X2 = np.stack([1 - np.cos(t), 0.5 - np.sin(t)], axis=1)
    X = np.concatenate([X1, X2]) + noise * rng.normal(size=(2 * h, 2))
    y = np.concatenate([np.zeros(h), np.ones(h)])
    return X, y


def circles(n: int = 26000, factor: float = 0.5, noise: float = 0.05, seed: int = 0):
    rng = np.random.default_rng(seed)
    h = n // 2
    t1 = 2 * np.pi * rng.uniform(size=h)
    t2 = 2 * np.pi * rng.uniform(size=n - h)
    X = np.concatenate([np.stack([np.cos(t1), np.sin(t1)], 1),
                        factor * np.stack([np.cos(t2), np.sin(t2)], 1)])
    X += noise * rng.normal(size=X.shape)
    y = np.concatenate([np.zeros(h), np.ones(n - h)])
    return X, y


def rasterize(X: np.ndarray, y: np.ndarray, n: int = 256, m: int = 256,
              fill: str = "nearest") -> np.ndarray:
    """Labeled points -> n x m signal: cell label = mean of its points;
    empty cells take the nearest filled value along rows then columns."""
    lo = X.min(axis=0)
    hi = X.max(axis=0)
    ij = np.clip(((X - lo) / np.maximum(hi - lo, 1e-12)
                  * [n - 1, m - 1]).astype(np.int64), 0, [n - 1, m - 1])
    s = np.zeros((n, m))
    c = np.zeros((n, m))
    np.add.at(s, (ij[:, 0], ij[:, 1]), y)
    np.add.at(c, (ij[:, 0], ij[:, 1]), 1.0)
    out = np.where(c > 0, s / np.maximum(c, 1), np.nan)
    if fill == "nearest":
        for axis in (1, 0):
            a = out if axis == 1 else out.T
            for row in a:
                ok = ~np.isnan(row)
                if ok.any() and not ok.all():
                    idx = np.arange(len(row))
                    row[~ok] = np.interp(idx[~ok], idx[ok], row[ok])
            out = a if axis == 1 else a.T
        out = np.nan_to_num(out, nan=float(np.nanmean(out)))
    return out
