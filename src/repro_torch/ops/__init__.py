"""repro_torch.ops — the canonical op surface, three backends per op.

The same six op names and public signatures as ``repro.ops``:

  ``sat_moments(y)``                     (3, n, m) integral images of
                                         (1, y, y²) — PrefixStats' build
  ``delta_sat(carry, tail)``             the write-path row patch
  ``fitting_loss(cs, rects, labels)``    Algorithm-5 loss of one tree
  ``fitting_loss_batched(cs, R, L)``     (T,) losses, one fused evaluation
  ``hist_split(codes, w, wy, wy2, B)``   CART split histograms
  ``streaming_compress(coresets)``       merge-reduce recompress

Each dispatches through the backend registry (numpy oracle / plain torch
on the CPU / CUDA kernel) by the rules in ``registry.py``, at the problem
size the reference's wrappers give it (``size=``: what the autotune cache
is keyed by, and what the profile hooks and the dispatch span see); every
op has all three backends.  Each takes ``config=``, the tuning
configuration (``backends.py``), where ``None`` asks the autotune cache.
"""
from __future__ import annotations

import numpy as np

from . import autotune  # noqa: F401  (tuning cache + precision promotion)
from . import backends as _backends  # noqa: F401  (registers implementations)
from .registry import (BACKENDS, ENV_VAR, OPS, PINNED_OPS, BackendError,
                       available_backends, backend_override, bind, dispatch,
                       dispatch_counts, dispatch_seconds, register,
                       reset_dispatch_counts, resolve, select_backend,
                       snapshot)

__all__ = [
    "OPS", "BACKENDS", "ENV_VAR", "PINNED_OPS", "BackendError", "autotune",
    "available_backends", "backend_override", "bind", "dispatch",
    "dispatch_counts", "dispatch_seconds", "register",
    "reset_dispatch_counts", "resolve", "snapshot",
    "select_backend", "selected_backend", "sat_moments", "delta_sat",
    "fitting_loss",
    "fitting_loss_batched", "hist_split", "streaming_compress",
    "fitting_loss_size", "fitting_loss_batched_size",
    "streaming_compress_size",
]


def sat_moments(y, *, backend: str | None = None, **kw) -> np.ndarray:
    """(3, n, m) integral images of (1, y, y^2) for a 2-D signal; float64
    unless ``config={"dtype": "float32"}`` asks for the reference TPU
    kernel's type."""
    y = np.asarray(y)
    if y.ndim != 2:
        raise ValueError(f"signal must be 2D, got shape {y.shape}")
    return dispatch("sat_moments", y, backend=backend, size=3 * y.size, **kw)


def delta_sat(carry, tail, *, backend: str | None = None, **kw) -> np.ndarray:
    """(3, b, m) patched integral-image rows for a replaced/appended band.

    ``carry`` (3, m) is the integral-image row just above the first changed
    row (zeros when patching from row 0); ``tail`` (b, m) holds the raw
    signal rows from the first changed row to the (new) end of the signal.
    Float64 unless ``config={"dtype": "float32"}`` asks for the reference
    TPU kernel's type; in float64 every backend continues the ``sat_moments`` recurrence
    with numpy's additions, so chained patches are bitwise equal to a
    from-scratch build."""
    carry = np.asarray(carry)
    tail = np.asarray(tail)
    if tail.ndim != 2 or tail.shape[0] < 1:
        raise ValueError(f"tail must be a non-empty 2D band, got {tail.shape}")
    if carry.shape != (3, tail.shape[1]):
        raise ValueError(f"carry must have shape (3, {tail.shape[1]}), "
                         f"got {carry.shape}")
    return dispatch("delta_sat", carry, tail, backend=backend,
                    size=3 * tail.size, **kw)


def streaming_compress(coresets, k: int | None = None,
                       eps: float | None = None, *,
                       backend: str | None = None, **kw) -> list:
    """Merge-reduce "reduce": recompress a list of composed coresets.

    One dispatch recompresses every bucket in ``coresets`` (the dirty
    buckets of a merge-reduce level); the torch and cuda backends integrate
    all their moment rasters in one ``sat_stack`` call, in float64 bitwise
    as the numpy oracle does, or with ``config={"dtype": "float32"}`` in
    the reference TPU kernel's type and order."""
    coresets = list(coresets)
    if not coresets:
        return []
    return dispatch("streaming_compress", coresets, k, eps, backend=backend,
                    size=lambda: streaming_compress_size(coresets), **kw)


def streaming_compress_size(coresets) -> int:
    """Moment-raster cells a streaming_compress call integrates (three per
    cell of each bucket's signal)."""
    return 3 * sum(int(cs.n) * int(cs.m) for cs in coresets)


def fitting_loss_size(cs, seg_rects) -> int:
    """Problem size of a fitting_loss call (blocks x leaves)."""
    k = np.asarray(seg_rects).reshape(-1, 4).shape[0]
    return cs.num_blocks * max(k, 1)


def fitting_loss_batched_size(cs, seg_rects) -> int:
    """Problem size of a batched call (trees x blocks x leaves)."""
    sr = np.asarray(seg_rects)
    return cs.num_blocks * sr.shape[0] * max(sr.shape[1], 1)


def fitting_loss(cs, seg_rects, seg_labels, *,
                 backend: str | None = None, **kw) -> float:
    """Scalar Algorithm-5 loss of one k-segmentation against ``cs``."""
    sr = np.asarray(seg_rects).reshape(-1, 4)
    sl = np.asarray(seg_labels, np.float64).ravel()
    if sr.shape[0] != sl.shape[0]:
        raise ValueError("rects/labels length mismatch")
    return dispatch("fitting_loss", cs, sr, sl, backend=backend,
                    size=lambda: fitting_loss_size(cs, sr), **kw)


def fitting_loss_batched(cs, seg_rects, seg_labels, *,
                         backend: str | None = None, **kw) -> np.ndarray:
    """(T,) Algorithm-5 losses: seg_rects (T, K, 4), seg_labels (T, K)."""
    sr = np.asarray(seg_rects)
    sl = np.asarray(seg_labels, np.float64)
    if sr.ndim != 3 or sr.shape[-1] != 4:
        raise ValueError("batch rects must have shape (T, K, 4)")
    if sl.shape != sr.shape[:2]:
        raise ValueError("batch labels must have shape (T, K)")
    return dispatch("fitting_loss_batched", cs, sr, sl, backend=backend,
                    size=lambda: fitting_loss_batched_size(cs, sr), **kw)


def hist_split(codes, w, wy, wy2, n_bins: int, *,
               backend: str | None = None, **kw) -> np.ndarray:
    """(F, n_bins, 3) float64 per-(feature, bin) sums of (w, wy, wy2);
    codes (P, F) integer bin ids.  The torch and cuda backends take
    ``config={"variant": ..., "tile_p": ...}`` (``backends.py``)."""
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError(f"codes must be (P, F), got shape {codes.shape}")
    return dispatch("hist_split", codes, w, wy, wy2, int(n_bins),
                    backend=backend, size=codes.size, **kw)


def selected_backend(op: str, size: int | None = None,
                     backend: str | None = None) -> str:
    """The backend name a dispatch of ``op`` at ``size`` would use."""
    return backend or select_backend(op, size)
