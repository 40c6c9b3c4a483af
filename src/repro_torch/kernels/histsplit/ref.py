"""Plain PyTorch versions of the histsplit kernels.

The same sums as ``csrc/histsplit.cu``: per (feature, bin), the sums of the
value channels of the points whose code is that bin.

``hist_rows_ref`` is the float64 kernel's plain version, written as the
kernel's four passes (count, scan, stable order by code, ordered sums per
segment).  On the CPU it equals numpy's ``np.bincount`` over the node's
rows bitwise, as the kernel does.  The float32 variants' plain versions are
one ``torch.bincount`` per (feature, channel): on the CPU a bincount adds
the points in order from +0.0; on a CUDA tensor it adds with atomics, in no
fixed order.

``hist_vmap_ref`` and ``hist_flat_ref`` are the plain versions of the
reference's two plain-float32 XLA lowerings (``src/repro/ops/backends.py``,
``variant="vmap"`` and ``"flat"``): one ``index_add_`` a feature, or one
over F * n_bins fused ids.  Its compensated ``"chunked"`` lowering sums
8192-point chunks of the six (hi, lo) channels, which is ``partials_ref``
at ``tile_p=8192`` (the reference pads the last chunk with zero weights in
bin 0, which adds nothing).
"""
from __future__ import annotations

import torch

from ..sat2d.ref import split_hi_lo

__all__ = ["hist_rows_ref", "histograms_ref", "partials_ref", "split_hi_lo",
           "hist_vmap_ref", "hist_flat_ref", "CHUNK"]

# the reference's compensated XLA lowering sums chunks of this many points
CHUNK = 8192


def hist_rows_ref(codes: torch.Tensor, vals: torch.Tensor,
                  rows: torch.Tensor | None, n_bins: int) -> torch.Tensor:
    """(F, n_bins, S) sums over the points ``rows`` (ascending; None: all)
    of codes (P, F) integer bin ids below ``n_bins`` and vals (P, S).

    Each (feature, bin, channel) sum is one chain of adds from +0.0 over
    its points in row order, numpy's ``bincount`` order:
      1. count the points of each (feature, bin) segment;
      2. an exclusive scan of the counts gives each segment's start;
      3. a stable sort by segment puts each segment's points in row order;
      4. each segment, behind a leading +0.0 and padded with +0.0 to the
         longest (an exact no-op: a chain from +0.0 never holds -0.0),
         is summed by a cumulative sum along it, which on the CPU adds in
         order.
    """
    c = (codes if rows is None else codes[rows]).long()
    v = vals if rows is None else vals[rows]
    n, F = c.shape
    S = v.shape[1]
    out = torch.zeros((F * n_bins, S), dtype=vals.dtype, device=vals.device)
    if n == 0:
        return out.view(F, n_bins, S)
    seg = (c + torch.arange(F, device=c.device) * n_bins).t().reshape(-1)
    counts = torch.bincount(seg, minlength=F * n_bins)             # 1
    starts = torch.cumsum(counts, 0) - counts                      # 2
    order = torch.sort(seg, stable=True).indices                   # 3
    sseg = seg[order]
    rank = torch.arange(F * n, device=c.device) - starts[sseg]
    full = counts > 0                                              # 4
    slot = torch.cumsum(full.long(), 0) - 1
    pad = torch.zeros((int(full.sum()), int(counts.max()) + 1, S),
                      dtype=vals.dtype, device=vals.device)
    pad[slot[sseg], rank + 1] = v[order % n]
    out[full] = torch.cumsum(pad, dim=1)[:, -1]
    return out.view(F, n_bins, S)


def histograms_ref(codes: torch.Tensor, vals: torch.Tensor,
                   n_bins: int) -> torch.Tensor:
    """(F, n_bins, S) sums in ``vals``' dtype: codes (P, F) integer bin ids
    below ``n_bins``, vals (P, S)."""
    F, S = codes.shape[1], vals.shape[1]
    out = torch.empty((F, n_bins, S), dtype=vals.dtype, device=vals.device)
    for f in range(F):
        for s in range(S):
            out[f, :, s] = torch.bincount(codes[:, f], weights=vals[:, s],
                                          minlength=n_bins)
    return out


def partials_ref(codes: torch.Tensor, vals: torch.Tensor, n_bins: int,
                 tile_p: int) -> torch.Tensor:
    """(ceil(P / tile_p), F, n_bins, S) sums of each tile of ``tile_p``
    consecutive points, in ``vals``' dtype."""
    P, F = codes.shape
    S = vals.shape[1]
    C = -(-P // tile_p)
    tile = torch.arange(P, device=codes.device) // tile_p * n_bins
    out = torch.empty((C, F, n_bins, S), dtype=vals.dtype, device=vals.device)
    for f in range(F):
        ids = tile + codes[:, f]
        for s in range(S):
            out[:, f, :, s] = torch.bincount(
                ids, weights=vals[:, s], minlength=C * n_bins).view(C, n_bins)
    return out


def hist_vmap_ref(codes: torch.Tensor, vals: torch.Tensor,
                  n_bins: int) -> torch.Tensor:
    """(F, n_bins, S) sums in ``vals``' dtype, one scatter a feature."""
    F, S = codes.shape[1], vals.shape[1]
    out = torch.zeros((F, n_bins, S), dtype=vals.dtype, device=vals.device)
    for f in range(F):
        out[f].index_add_(0, codes[:, f].long(), vals)
    return out


def hist_flat_ref(codes: torch.Tensor, vals: torch.Tensor,
                  n_bins: int) -> torch.Tensor:
    """(F, n_bins, S) sums in ``vals``' dtype, one scatter over the F *
    n_bins fused (feature, bin) ids."""
    P, F = codes.shape
    S = vals.shape[1]
    ids = codes.long() + torch.arange(F, device=codes.device) * n_bins
    out = torch.zeros((F * n_bins, S), dtype=vals.dtype, device=vals.device)
    out.index_add_(0, ids.reshape(-1),
                   vals[:, None, :].expand(P, F, S).reshape(P * F, S))
    return out.view(F, n_bins, S)
