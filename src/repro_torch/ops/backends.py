"""Registered backends of the ported ops.

Inputs are host values (SignalCoreset, numpy arrays) and outputs numpy
arrays or Python floats, as in the reference.  ``numpy`` is the reference's
host oracle, ``torch`` runs the plain PyTorch versions on the CPU, ``cuda``
uploads the inputs to the card and launches the hand-written kernels.
"""
from __future__ import annotations

import numpy as np

from .registry import register


def _check(device):
    # the cuda backends resolve only where a card is present
    if device == "cuda":
        from repro_torch.kernels.common import require_cuda
        require_cuda()

# ------------------------------------------------------------- sat_moments
# (3, n, m) inclusive integral images of (1, y, y^2) — PrefixStats' core.
# Every backend keeps numpy's order, so in float64 (the default, which the
# coreset build uses) all three agree bitwise; dtype=np.float32 gives the
# images in the reference TPU kernel's type.


@register("sat_moments", "numpy")
def _sat_moments_numpy():
    def sat_moments(y, dtype=np.float64):
        # canonical order: columns-within-row first, then down the rows
        # (np.cumsum is a sequential per-element reduction)
        y = np.asarray(y, dtype)
        stk = np.stack([np.ones_like(y), y, y * y], axis=0)
        return np.cumsum(np.cumsum(stk, axis=2), axis=1)
    return sat_moments


def _sat_moments_torch(device):
    def factory():
        import torch
        _check(device)
        from repro_torch.kernels.sat2d.ops import sat_moments as kernel_sat

        def sat_moments(y, dtype=np.float64):
            t = torch.as_tensor(np.asarray(y, dtype), device=device)
            return kernel_sat(t).cpu().numpy()
        return sat_moments
    return factory


register("sat_moments", "torch")(_sat_moments_torch("cpu"))
register("sat_moments", "cuda")(_sat_moments_torch("cuda"))

# --------------------------------------------------------------- delta_sat
# patched integral-image rows for a replaced/appended row band: carry (3, m)
# is the integral row just above the patch, tail (b, m) the raw rows from the
# first changed row to the (new) end.  Output (3, b, m).  Every backend keeps
# the numpy oracle's order, so in float64 (the default) chained patches stay
# bitwise equal to a full build on all three; dtype=np.float32 gives the
# reference TPU kernel's type.


@register("delta_sat", "numpy")
def _delta_sat_numpy():
    def delta_sat(carry, tail, dtype=np.float64):
        t = np.asarray(tail, dtype)
        stk = np.stack([np.ones_like(t), t, t * t], axis=0)
        inner = np.cumsum(stk, axis=2)
        # prepend the carry row and let the sequential cumsum continue it:
        # row i is row i-1 + inner[i], the float ops a full build performs
        full = np.concatenate([np.asarray(carry, dtype)[:, None, :], inner],
                              axis=1)
        return np.cumsum(full, axis=1)[:, 1:, :]
    return delta_sat


def _delta_sat_torch(device):
    def factory():
        import torch
        _check(device)
        from repro_torch.kernels.sat2d.ops import delta_sat_moments

        def delta_sat(carry, tail, dtype=np.float64):
            c = torch.as_tensor(np.asarray(carry, dtype), device=device)
            t = torch.as_tensor(np.asarray(tail, dtype), device=device)
            return delta_sat_moments(c, t).cpu().numpy()
        return delta_sat
    return factory


register("delta_sat", "torch")(_delta_sat_torch("cpu"))
register("delta_sat", "cuda")(_delta_sat_torch("cuda"))

# ------------------------------------------------------------ fitting_loss
# scalar Algorithm-5 loss of one segmentation against a SignalCoreset.


@register("fitting_loss", "numpy")
def _fitting_loss_numpy():
    from repro_torch.core.fitting_loss import fitting_loss

    def fl(cs, seg_rects, seg_labels):
        return float(fitting_loss(cs, seg_rects, seg_labels))
    return fl


def _fitting_loss_torch(device):
    def factory():
        from repro_torch.kernels.fitting_loss.ops import coreset_loss
        _check(device)

        def fl(cs, seg_rects, seg_labels):
            return coreset_loss(cs, seg_rects, seg_labels, device=device)
        return fl
    return factory


register("fitting_loss", "torch")(_fitting_loss_torch("cpu"))
register("fitting_loss", "cuda")(_fitting_loss_torch("cuda"))

# ---------------------------------------------------- fitting_loss_batched
# (T,) losses for T candidate segmentations against one coreset.


@register("fitting_loss_batched", "numpy")
def _fitting_loss_batched_numpy():
    from repro_torch.core.fitting_loss import fitting_loss

    def fb(cs, seg_rects, seg_labels):
        return np.array([fitting_loss(cs, r, l)
                         for r, l in zip(seg_rects, seg_labels)], np.float64)
    return fb


def _fitting_loss_batched_torch(device):
    def factory():
        from repro_torch.kernels.fitting_loss.ops import coreset_loss_batched
        _check(device)

        def fb(cs, seg_rects, seg_labels):
            return coreset_loss_batched(cs, seg_rects, seg_labels, device=device)
        return fb
    return factory


register("fitting_loss_batched", "torch")(_fitting_loss_batched_torch("cpu"))
register("fitting_loss_batched", "cuda")(_fitting_loss_batched_torch("cuda"))

# -------------------------------------------------------------- hist_split
# (F, n_bins, 3) per-(feature, bin) sums of (w, wy, wy2): the CART split
# search's hot spot.  numpy's bincount is the oracle; the torch and cuda
# backends' default variant "f64" equals it bitwise, so trees grown on any
# backend are the same trees.  variant= selects the float32 kernels
# ("fused", "legacy") or the compensated "partials", as the reference's
# config={"variant": ...} does.


@register("hist_split", "numpy")
def _hist_split_numpy():
    def hist(codes, w, wy, wy2, n_bins):
        codes = np.asarray(codes)
        out = np.empty((codes.shape[1], n_bins, 3), np.float64)
        for f in range(codes.shape[1]):
            c = codes[:, f]
            out[f, :, 0] = np.bincount(c, weights=w, minlength=n_bins)
            out[f, :, 1] = np.bincount(c, weights=wy, minlength=n_bins)
            out[f, :, 2] = np.bincount(c, weights=wy2, minlength=n_bins)
        return out
    return hist


def _hist_split_torch(device):
    def factory():
        from repro_torch.kernels.histsplit.ops import hist_split
        _check(device)

        def hist(codes, w, wy, wy2, n_bins, variant="f64", tile_p=2048):
            return hist_split(codes, w, wy, wy2, n_bins, variant=variant,
                              tile_p=tile_p, device=device)
        return hist
    return factory


register("hist_split", "torch")(_hist_split_torch("cpu"))
register("hist_split", "cuda")(_hist_split_torch("cuda"))

# ------------------------------------------------------- streaming_compress
# the merge-reduce "reduce" step as one dispatch: recompress a list of
# composed coresets (the dirty buckets of a level) into coresets of
# coresets.  The backends differ only in how the per-bucket moment rasters
# become integral images: numpy integrates each bucket with
# PrefixStats.build_moments (columns first); torch and cuda integrate all of
# them in one sat_stack call on a padded stack, in float64 in the same order
# (bitwise numpy's), or with dtype=np.float32 in the reference TPU kernel's
# type and order.  Rasterizing and the partition/Caratheodory finish are
# host code shared by all three (core.streaming).


def _stack_rasters(preps, dtype=np.float64):
    """Pad the per-bucket (3, n, m) moment rasters to one (L, 3, nmax, mmax)
    stack so that one call integrates every bucket."""
    nmax = max(p.rasters[0].shape[0] for p in preps)
    mmax = max(p.rasters[0].shape[1] for p in preps)
    stk = np.zeros((len(preps), 3, nmax, mmax), dtype)
    for i, p in enumerate(preps):
        n, m = p.rasters[0].shape
        for c in range(3):
            stk[i, c, :n, :m] = p.rasters[c]
    return stk


def _finish_from_sats(coresets, preps, sats, k, eps):
    from repro_torch.core.stats import PrefixStats
    from repro_torch.core.streaming import _recompress_finish
    out = []
    for cs, p, sat in zip(coresets, preps, sats):
        n, m = p.rasters[0].shape
        ps = PrefixStats.from_sat(np.asarray(sat[:, :n, :m], np.float64))
        out.append(_recompress_finish(cs, p, ps, k, eps))
    return out


@register("streaming_compress", "numpy")
def _streaming_compress_numpy():
    def sc(coresets, k=None, eps=None):
        from repro_torch.core.stats import PrefixStats
        from repro_torch.core.streaming import (_recompress_finish,
                                                _recompress_prep)
        out = []
        for cs in coresets:
            p = _recompress_prep(cs)
            ps = PrefixStats.build_moments(*p.rasters)
            out.append(_recompress_finish(cs, p, ps, k, eps))
        return out
    return sc


def _streaming_compress_torch(device):
    def factory():
        import torch
        _check(device)
        from repro_torch.kernels.sat2d.ops import sat_stack

        def sc(coresets, k=None, eps=None, dtype=np.float64):
            from repro_torch.core.streaming import _recompress_prep
            preps = [_recompress_prep(cs) for cs in coresets]
            stk = torch.as_tensor(_stack_rasters(preps, dtype), device=device)
            sats = sat_stack(stk).cpu().numpy()
            return _finish_from_sats(coresets, preps, sats, k, eps)
        return sc
    return factory


register("streaming_compress", "torch")(_streaming_compress_torch("cpu"))
register("streaming_compress", "cuda")(_streaming_compress_torch("cuda"))
