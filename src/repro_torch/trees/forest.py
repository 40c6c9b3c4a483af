"""Random forests and weighted bootstrap (the paper's §5 solver stand-in).

``RandomForestRegressor`` mirrors sklearn's: bootstrap resampling + feature
subsampling, average vote.  Weighted inputs (coreset points) are resampled
by multinomial draws proportional to the weights, which preserves the
weighted empirical distribution in expectation — each tree then trains on
integer multiplicity weights.
"""
from __future__ import annotations

import numpy as np

from .cart import DecisionTreeRegressor, apply_bins, quantile_bins

__all__ = ["RandomForestRegressor"]


class RandomForestRegressor:
    def __init__(self, n_estimators: int = 20, max_leaves: int = 31,
                 max_depth: int = 64, feature_fraction: float = 1.0,
                 bootstrap: bool = True, max_bins: int = 255,
                 random_state: int = 0, hist_backend: str = "auto"):
        self.n_estimators = int(n_estimators)
        self.max_leaves = int(max_leaves)
        self.max_depth = int(max_depth)
        self.feature_fraction = float(feature_fraction)
        self.bootstrap = bool(bootstrap)
        self.max_bins = int(max_bins)
        self.random_state = int(random_state)
        self.hist_backend = hist_backend
        self.trees: list[DecisionTreeRegressor] = []

    def fit(self, X: np.ndarray, y: np.ndarray, sample_weight: np.ndarray | None = None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        P, F = X.shape
        w = np.ones(P) if sample_weight is None else np.asarray(sample_weight, np.float64)
        rng = np.random.default_rng(self.random_state)
        edges = quantile_bins(X, self.max_bins)
        codes = apply_bins(X, edges)
        self.trees = []
        n_feat = max(1, int(round(self.feature_fraction * F)))
        for _ in range(self.n_estimators):
            if self.bootstrap:
                p = w / w.sum()
                counts = rng.multinomial(P, p)
                tw = counts.astype(np.float64)
            else:
                tw = w
            feats = np.sort(rng.choice(F, size=n_feat, replace=False)) if n_feat < F else None
            t = DecisionTreeRegressor(max_leaves=self.max_leaves,
                                      max_depth=self.max_depth,
                                      max_bins=self.max_bins,
                                      hist_backend=self.hist_backend,
                                      feature_indices=feats)
            keep = tw > 0
            t.fit(X[keep], y[keep], sample_weight=tw[keep],
                  bins=(edges, codes[keep]))
            self.trees.append(t)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        return np.mean([t.predict(X) for t in self.trees], axis=0)
