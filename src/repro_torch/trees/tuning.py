"""AutoML / hyperparameter tuning on compressed data (paper §5, Fig 4).

The experiment protocol: hold out random 5x5 patches of the signal as
"missing values"; train a forest on the observed cells — either on the full
data, on the coreset, or on a uniform sample of equal size — for every
candidate k (max_leaves); pick the k with the lowest held-out SSE.  The
coreset is built ONCE and reused across the whole sweep (that is where the
x10 comes from).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np

from repro_torch.core.coreset import (SignalCoreset, signal_coreset,
                                      signal_coreset_to_size)
from .forest import RandomForestRegressor

__all__ = ["signal_to_points", "uniform_sample", "TuneResult", "tune_k",
           "score_segmentations", "best_segmentation"]


def score_segmentations(cs: SignalCoreset, seg_rects_batch, seg_labels_batch,
                        *, backend: str | None = None) -> np.ndarray:
    """(T,) Algorithm-5 losses of T candidate k-trees against one coreset.

    The tuning-sweep inner loop as ONE dispatched ``fitting_loss_batched``
    evaluation (numpy oracle / plain torch / batched CUDA kernel by the
    ``repro_torch.ops`` selection rules) instead of T sequential scores.
    """
    from repro_torch import ops
    sr = np.asarray(seg_rects_batch, np.float64)
    sl = np.asarray(seg_labels_batch, np.float64)
    return np.asarray(ops.fitting_loss_batched(cs, sr, sl, backend=backend),
                      np.float64)


def best_segmentation(cs: SignalCoreset, seg_rects_batch, seg_labels_batch,
                      *, backend: str | None = None) -> tuple[int, float]:
    """(argmin index, loss) over T candidates — coreset model selection."""
    losses = score_segmentations(cs, seg_rects_batch, seg_labels_batch,
                                 backend=backend)
    i = int(np.argmin(losses))
    return i, float(losses[i])


def signal_to_points(values: np.ndarray, mask: np.ndarray | None = None):
    """(i, j) -> y regression dataset from a signal; mask selects cells."""
    n, m = values.shape
    ii, jj = np.meshgrid(np.arange(n), np.arange(m), indexing="ij")
    sel = np.ones((n, m), bool) if mask is None else mask
    X = np.stack([ii[sel], jj[sel]], axis=1).astype(np.float64)
    return X, values[sel].astype(np.float64)


def uniform_sample(X: np.ndarray, y: np.ndarray, size: int, rng: np.random.Generator):
    """The RandomSample(D, tau) baseline: uniform rows, reweighted to total mass."""
    size = min(size, len(y))
    idx = rng.choice(len(y), size=size, replace=False)
    w = np.full(size, len(y) / size, np.float64)
    return X[idx], y[idx], w


@dataclasses.dataclass
class TuneResult:
    ks: list[int]
    losses: dict[str, list[float]]        # method -> per-k held-out SSE
    times: dict[str, float]               # method -> total seconds (incl. compression)
    best_k: dict[str, int]
    sizes: dict[str, int]                 # training-set sizes per method


def tune_k(values: np.ndarray, train_mask: np.ndarray, test_mask: np.ndarray,
           ks: list[int], *, eps: float = 0.2, coreset_k: int | None = None,
           target_frac: float | None = None,
           n_estimators: int = 10, methods: tuple[str, ...] = ("full", "coreset", "uniform"),
           rng: np.random.Generator | None = None,
           forest_factory: Callable | None = None,
           hist_backend: str = "auto") -> TuneResult:
    """Sweep max_leaves=k over the given training methods; §5 protocol.

    ``hist_backend`` selects the split-histogram op backend for the default
    forest factory ("auto" = dispatcher rules / REPRO_TORCH_OPS_BACKEND).
    """
    rng = rng or np.random.default_rng(0)
    forest_factory = forest_factory or (lambda k: RandomForestRegressor(
        n_estimators=n_estimators, max_leaves=k, random_state=0,
        hist_backend=hist_backend))

    X_tr, y_tr = signal_to_points(values, train_mask)
    X_te, y_te = signal_to_points(values, test_mask)

    datasets: dict[str, tuple] = {}
    times: dict[str, float] = {}
    sizes: dict[str, int] = {}

    if "full" in methods:
        datasets["full"] = (X_tr, y_tr, None)
        times["full"] = 0.0
        sizes["full"] = len(y_tr)
    cs: SignalCoreset | None = None
    if "coreset" in methods:
        t0 = time.perf_counter()
        # mask-aware construction: only observed cells carry mass (§5 trains
        # on the available data; held-out patches contribute nothing)
        if target_frac is not None:
            cs = signal_coreset_to_size(values, coreset_k or 64, target_frac,
                                        mask=train_mask)
        else:
            cs = signal_coreset(values, coreset_k or max(ks), eps,
                                mask=train_mask)
        Xc, yc, wc = cs.as_points()
        times["coreset"] = time.perf_counter() - t0
        datasets["coreset"] = (Xc, yc, wc)
        sizes["coreset"] = len(yc)
    if "uniform" in methods:
        t0 = time.perf_counter()
        tau = sizes.get("coreset", max(64, len(y_tr) // 100))
        Xu, yu, wu = uniform_sample(X_tr, y_tr, tau, rng)
        times["uniform"] = time.perf_counter() - t0
        datasets["uniform"] = (Xu, yu, wu)
        sizes["uniform"] = len(yu)

    losses = {name: [] for name in datasets}
    for name, (X, y, w) in datasets.items():
        t0 = time.perf_counter()
        for k in ks:
            f = forest_factory(k)
            f.fit(X, y, sample_weight=w)
            pred = f.predict(X_te)
            losses[name].append(float(((pred - y_te) ** 2).sum()))
        times[name] += time.perf_counter() - t0

    best_k = {name: ks[int(np.argmin(ls))] for name, ls in losses.items()}
    return TuneResult(ks=list(ks), losses=losses, times=times, best_k=best_k,
                      sizes=sizes)
