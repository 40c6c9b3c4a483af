"""Registered backends of the ported ops.

Inputs are host values (SignalCoreset, numpy arrays) and outputs numpy
arrays or Python floats, as in the reference.  ``numpy`` is the reference's
host oracle, ``torch`` runs the plain PyTorch versions on the CPU, ``cuda``
uploads the inputs to the card and launches the hand-written kernels.

Every implementation takes ``config=``, a tuning configuration dict, as the
reference's do.  ``None`` asks the autotune cache for this problem size
(``autotune.plan``); a cold cache gives ``{}``, and ``{}`` is each
backend's default, the float64 path that equals numpy bitwise.  The keys:

  numpy        ``dtype`` ("float64" | "float32") of the three scans' sums;
               anything else is ignored, and the oracle never asks the cache
  torch        ``compensated`` for sat_moments, delta_sat and
               streaming_compress: the two-float twins of the scans
               (``kernels/sat2d/ref.py``), recombined in float64 on the host;
               ``dtype`` as for cuda, the plain version of its kernel
  cuda         ``dtype`` for the three scans
  hist_split   ``variant``, ``tile_p`` and ``compensated`` on torch and cuda:
               "f64" (default), "fused", "legacy", "partials" (compensated);
               torch also runs the reference's XLA lowerings "vmap", "flat"
               and "chunked" (compensated)
  losses       no keys: the kernel's launch is the source's own
               (``fl_launch_shape``)

A key a backend does not know raises, so a configuration never silently
runs another path than it names.
"""
from __future__ import annotations

import numpy as np

from . import autotune
from .registry import register

_DTYPES = {"float64": np.float64, "float32": np.float32}
# hist_split variants that sum compensated (hi, lo) pairs
_COMPENSATED_VARIANTS = ("partials", "chunked")


def _check(device):
    # the cuda backends resolve only where a card is present
    if device == "cuda":
        from repro_torch.kernels.common import require_cuda
        require_cuda()


def _backend(device) -> str:
    return "torch" if device == "cpu" else "cuda"


def _plan(config, op: str, device, size: int, keys) -> dict:
    """``config``, or the tuned one for ``size`` when it is None, checked
    against the keys this backend reads."""
    cfg = autotune.plan(op, _backend(device), size) if config is None else config
    unknown = set(cfg) - set(keys)
    if unknown:
        raise ValueError(f"{op}/{_backend(device)} takes config keys "
                         f"{sorted(keys)}, not {sorted(unknown)}")
    return cfg


def _dtype(cfg: dict):
    name = cfg.get("dtype", "float64")
    if name not in _DTYPES:
        raise ValueError(f"config dtype {name!r}: 'float64' or 'float32'")
    return _DTYPES[name]


def _scan_keys(device):
    return ("dtype", "compensated") if device == "cpu" else ("dtype",)


def _pair_sum(hi, lo) -> np.ndarray:
    """A two-float result recombined in float64 on the host."""
    return hi.cpu().numpy().astype(np.float64) + lo.cpu().numpy().astype(np.float64)


def _split(x, device):
    import torch
    from repro_torch.kernels.sat2d.ref import split_hi_lo
    hi, lo = split_hi_lo(torch.as_tensor(np.asarray(x, np.float64)))
    return hi.to(device), lo.to(device)

# ------------------------------------------------------------- sat_moments
# (3, n, m) inclusive integral images of (1, y, y^2) — PrefixStats' core.
# Every backend keeps numpy's order, so in float64 (the default, which the
# coreset build uses) all three agree bitwise; dtype "float32" gives the
# images in the reference TPU kernel's type.


@register("sat_moments", "numpy")
def _sat_moments_numpy():
    def sat_moments(y, config=None):
        # canonical order: columns-within-row first, then down the rows
        # (np.cumsum is a sequential per-element reduction)
        y = np.asarray(y, _dtype(config or {}))
        stk = np.stack([np.ones_like(y), y, y * y], axis=0)
        return np.cumsum(np.cumsum(stk, axis=2), axis=1)
    return sat_moments


def _sat_moments_torch(device):
    def factory():
        import torch
        _check(device)
        from repro_torch.kernels.sat2d.ops import sat_moments as kernel_sat
        from repro_torch.kernels.sat2d.ref import sat_moments_comp_ref

        def sat_moments(y, config=None):
            y = np.asarray(y)
            cfg = _plan(config, "sat_moments", device, 3 * y.size,
                        _scan_keys(device))
            if cfg.get("compensated"):
                return _pair_sum(*sat_moments_comp_ref(*_split(y, device)))
            t = torch.as_tensor(np.asarray(y, _dtype(cfg)), device=device)
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
# bitwise equal to a full build on all three; dtype "float32" gives the
# reference TPU kernel's type.


@register("delta_sat", "numpy")
def _delta_sat_numpy():
    def delta_sat(carry, tail, config=None):
        dtype = _dtype(config or {})
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
        from repro_torch.kernels.sat2d.ref import delta_sat_comp_ref

        def delta_sat(carry, tail, config=None):
            tail = np.asarray(tail)
            cfg = _plan(config, "delta_sat", device, 3 * tail.size,
                        _scan_keys(device))
            if cfg.get("compensated"):
                # the stored carry enters as its own (hi, lo) pair, so
                # chained patches keep two-float precision across calls
                return _pair_sum(*delta_sat_comp_ref(*_split(carry, device),
                                                     *_split(tail, device)))
            dtype = _dtype(cfg)
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

    def fl(cs, seg_rects, seg_labels, config=None):
        return float(fitting_loss(cs, seg_rects, seg_labels))
    return fl


def _fitting_loss_torch(device):
    def factory():
        from repro_torch.kernels.fitting_loss.ops import coreset_loss
        _check(device)

        def fl(cs, seg_rects, seg_labels, config=None):
            _plan(config, "fitting_loss", device, cs.num_blocks
                  * max(np.asarray(seg_rects).reshape(-1, 4).shape[0], 1), ())
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

    def fb(cs, seg_rects, seg_labels, config=None):
        return np.array([fitting_loss(cs, r, l)
                         for r, l in zip(seg_rects, seg_labels)], np.float64)
    return fb


def _fitting_loss_batched_torch(device):
    def factory():
        from repro_torch.kernels.fitting_loss.ops import coreset_loss_batched
        _check(device)

        def fb(cs, seg_rects, seg_labels, config=None):
            sr = np.asarray(seg_rects)
            _plan(config, "fitting_loss_batched", device,
                  cs.num_blocks * sr.shape[0] * max(sr.shape[1], 1), ())
            return coreset_loss_batched(cs, seg_rects, seg_labels, device=device)
        return fb
    return factory


register("fitting_loss_batched", "torch")(_fitting_loss_batched_torch("cpu"))
register("fitting_loss_batched", "cuda")(_fitting_loss_batched_torch("cuda"))

# -------------------------------------------------------------- hist_split
# (F, n_bins, 3) per-(feature, bin) sums of (w, wy, wy2): the CART split
# search's hot spot.  numpy's bincount is the oracle; the torch and cuda
# backends' default variant "f64" equals it bitwise, so trees grown on any
# backend are the same trees.  Each backend's ``bind(codes, w, wy, wy2,
# n_bins)`` (through ``registry.bind``) returns the per-node form a tree
# calls with its node's rows: numpy indexes the host arrays; torch and cuda
# hold them on the device (``ResidentHist``), unless the tuned plan at the
# tree's size names another variant, which each node then runs on its rows.


@register("hist_split", "numpy")
def _hist_split_numpy():
    def hist(codes, w, wy, wy2, n_bins, config=None):
        codes = np.asarray(codes)
        out = np.empty((codes.shape[1], n_bins, 3), np.float64)
        for f in range(codes.shape[1]):
            c = codes[:, f]
            out[f, :, 0] = np.bincount(c, weights=w, minlength=n_bins)
            out[f, :, 1] = np.bincount(c, weights=wy, minlength=n_bins)
            out[f, :, 2] = np.bincount(c, weights=wy2, minlength=n_bins)
        return out

    def bind(codes, w, wy, wy2, n_bins):
        def node(rows):
            return hist(codes[rows], w[rows], wy[rows], wy2[rows], n_bins)
        return node
    hist.bind = bind
    return hist


def _hist_split_torch(device):
    def factory():
        from repro_torch.kernels.histsplit.ops import ResidentHist, hist_split
        _check(device)

        def hist(codes, w, wy, wy2, n_bins, config=None):
            codes = np.asarray(codes)
            cfg = _plan(config, "hist_split", device, codes.size,
                        ("variant", "tile_p", "compensated"))
            variant = cfg.get("variant", "f64")
            comp = variant in _COMPENSATED_VARIANTS
            if bool(cfg.get("compensated", comp)) != comp:
                raise ValueError(f"hist_split config {cfg}: variant {variant!r} "
                                 f"has compensated={comp}")
            return hist_split(codes, w, wy, wy2, n_bins, variant=variant,
                              tile_p=int(cfg.get("tile_p", 2048)), device=device)

        def bind(codes, w, wy, wy2, n_bins):
            cfg = autotune.plan("hist_split", _backend(device), np.asarray(codes).size)
            if cfg.get("variant", "f64") == "f64":
                return ResidentHist(codes, w, wy, wy2, n_bins, device=device)
            codes, w, wy, wy2 = (np.asarray(a) for a in (codes, w, wy, wy2))

            def node(rows):
                return hist(codes[rows], w[rows], wy[rows], wy2[rows], n_bins,
                            config=cfg)
            return node
        hist.bind = bind
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
# (bitwise numpy's), or with dtype "float32" in the reference TPU kernel's
# type and order, or (torch) compensated, rows first.  Rasterizing and the
# partition/Caratheodory finish are host code shared by all three
# (core.streaming).


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
    def sc(coresets, k=None, eps=None, config=None):
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
        from repro_torch.kernels.sat2d.ref import sat_stack_comp_ref

        def sc(coresets, k=None, eps=None, config=None):
            from repro_torch.core.streaming import _recompress_prep
            cfg = _plan(config, "streaming_compress", device,
                        3 * sum(int(cs.n) * int(cs.m) for cs in coresets),
                        _scan_keys(device))
            preps = [_recompress_prep(cs) for cs in coresets]
            if cfg.get("compensated"):
                sats = _pair_sum(*sat_stack_comp_ref(
                    *_split(_stack_rasters(preps), device)))
            else:
                stk = torch.as_tensor(_stack_rasters(preps, _dtype(cfg)),
                                      device=device)
                sats = sat_stack(stk).cpu().numpy()
            return _finish_from_sats(coresets, preps, sats, k, eps)
        return sc
    return factory


register("streaming_compress", "torch")(_streaming_compress_torch("cpu"))
register("streaming_compress", "cuda")(_streaming_compress_torch("cuda"))
