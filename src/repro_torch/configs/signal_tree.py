"""signal-tree — the paper's own model family as a selectable config.

Not an LM: a (k, eps)-coreset + decision-tree/forest pipeline over n x m
signals (the paper's contribution).  The config pins the §5 experimental
setup; ``chip_smoke.py``'s tuning phase runs it on the card.
"""
from __future__ import annotations

import dataclasses

__all__ = ["SignalTreeConfig", "CONFIG"]


@dataclasses.dataclass(frozen=True)
class SignalTreeConfig:
    name: str = "signal-tree"
    family: str = "coreset"
    # construction (paper §5: k=2000 fixed, eps controls the trade-off;
    # practical builds use target_frac via signal_coreset_to_size)
    k: int = 64
    eps: float = 0.3
    target_frac: float | None = 0.02
    fidelity: str = "practical"
    # downstream solver (sklearn/LightGBM stand-ins in repro_torch.trees)
    solver: str = "forest"          # tree | forest | gbdt
    n_estimators: int = 20
    max_leaves: int = 256
    # §5 protocol
    test_fraction: float = 0.3
    patch: int = 5

    def build(self, values, mask=None):
        from repro_torch.core import signal_coreset, signal_coreset_to_size
        if self.target_frac is not None:
            return signal_coreset_to_size(values, self.k, self.target_frac,
                                          mask=mask)
        return signal_coreset(values, self.k, self.eps, mask=mask,
                              fidelity=self.fidelity)

    def make_solver(self, max_leaves=None):
        from repro_torch.trees import (DecisionTreeRegressor,
                                       GradientBoostingRegressor,
                                       RandomForestRegressor)
        k = max_leaves or self.max_leaves
        if self.solver == "tree":
            return DecisionTreeRegressor(max_leaves=k)
        if self.solver == "gbdt":
            return GradientBoostingRegressor(n_estimators=self.n_estimators,
                                             max_leaves=min(k, 64))
        return RandomForestRegressor(n_estimators=self.n_estimators,
                                     max_leaves=k)


CONFIG = SignalTreeConfig()
