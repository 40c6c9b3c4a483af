"""Plain PyTorch versions of the histsplit kernels.

The same sums as ``csrc/histsplit.cu``: per (feature, bin), the sums of the
value channels of the points whose code is that bin.  Each is one
``torch.bincount`` per (feature, channel).  On the CPU a bincount adds the
points in order from +0.0, so in float64 it equals numpy's ``np.bincount``
bitwise, as the ``f64`` kernel does; on a CUDA tensor it adds with atomics,
in no fixed order.
"""
from __future__ import annotations

import torch

__all__ = ["histograms_ref", "partials_ref", "split_hi_lo"]


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


def split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a float64 tensor into a float32 pair with ``hi + lo == x`` to
    float32-pair precision (~2^-48 relative)."""
    x = x.to(torch.float64)
    hi = x.to(torch.float32)
    return hi, (x - hi.to(torch.float64)).to(torch.float32)
