"""Histogram gradient-boosted trees (the LightGBM stand-in of §5).

Squared-loss GBDT: residual fitting with shrinkage, leaf-wise histogram
trees, first-class sample weights.
"""
from __future__ import annotations

import numpy as np

from .cart import DecisionTreeRegressor, apply_bins, quantile_bins

__all__ = ["GradientBoostingRegressor"]


class GradientBoostingRegressor:
    def __init__(self, n_estimators: int = 50, learning_rate: float = 0.1,
                 max_leaves: int = 31, max_depth: int = 64, max_bins: int = 255,
                 hist_backend: str = "auto"):
        self.n_estimators = int(n_estimators)
        self.learning_rate = float(learning_rate)
        self.max_leaves = int(max_leaves)
        self.max_depth = int(max_depth)
        self.max_bins = int(max_bins)
        self.hist_backend = hist_backend
        self.base_: float = 0.0
        self.trees: list[DecisionTreeRegressor] = []

    def fit(self, X: np.ndarray, y: np.ndarray, sample_weight: np.ndarray | None = None):
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        w = np.ones(len(y)) if sample_weight is None else np.asarray(sample_weight, np.float64)
        edges = quantile_bins(X, self.max_bins)
        codes = apply_bins(X, edges)
        self.base_ = float(np.average(y, weights=w))
        pred = np.full(len(y), self.base_)
        self.trees = []
        for _ in range(self.n_estimators):
            resid = y - pred
            t = DecisionTreeRegressor(max_leaves=self.max_leaves,
                                      max_depth=self.max_depth,
                                      max_bins=self.max_bins,
                                      hist_backend=self.hist_backend)
            t.fit(X, resid, sample_weight=w, bins=(edges, codes))
            pred = pred + self.learning_rate * t.predict(X)
            self.trees.append(t)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.full(len(X), self.base_)
        for t in self.trees:
            out += self.learning_rate * t.predict(X)
        return out
