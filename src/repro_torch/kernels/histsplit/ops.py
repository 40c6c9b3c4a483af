"""Public wrappers of the histsplit kernels: the plain version for CPU
tensors, the CUDA kernel for CUDA tensors (which launches or raises), the
host adapter the ``repro_torch.ops`` ``hist_split`` backends register, and
``ResidentHist``, a tree's codes and values held on the device across its
nodes, the path the trees take.

Variants (``kernel.VARIANTS``): ``"f64"``, the default and the one the trees
use, sums in float64 in numpy's order; ``"fused"`` and ``"legacy"`` sum in
float32 as the TPU kernels do; ``"partials"`` is the compensated path: each
float64 channel is split into a float32 (hi, lo) pair, the six channels are
binned per P-tile, and the tiles and halves are summed in float64 on the
host, so neither the cast nor a long P axis leaves float32-level error.
"""
from __future__ import annotations

import numpy as np
import torch

from .kernel import (HIST_F64_NODE, VARIANTS, check_f64_shapes,
                     f64_scratch_bytes, histograms_cuda)
from .ref import hist_rows_ref, histograms_ref, partials_ref, split_hi_lo

__all__ = ["pack_values", "histograms_packed", "histograms", "hist_split",
           "ResidentHist"]


def pack_values(w, wy, wy2, variant: str = "f64") -> torch.Tensor:
    """(P, S) value channels of ``variant`` from three (P,) tensors, on
    their device."""
    x = torch.stack([w, wy, wy2], dim=1).to(torch.float64)
    if variant == "f64":
        return x
    if variant == "partials":
        return torch.cat(split_hi_lo(x), dim=1)
    return x.to(torch.float32)


def histograms_packed(codes: torch.Tensor, vals: torch.Tensor, n_bins: int, *,
                      variant: str = "f64", tile_p: int = 2048) -> torch.Tensor:
    """(F, n_bins, 3) sums of packed values (``pack_values``): float64 for
    ``"f64"``, float32 for ``"fused"`` and ``"legacy"``, and for
    ``"partials"`` float64 on the CPU, where the partials are combined."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown histsplit variant {variant!r}; "
                         f"valid: {sorted(VARIANTS)}")
    dtype, S = VARIANTS[variant]
    if vals.dtype != dtype or vals.dim() != 2 or vals.shape[1] != S:
        raise TypeError(f"variant {variant!r} takes (P, {S}) {dtype} values, "
                        f"got {tuple(vals.shape)} {vals.dtype}")
    if codes.device.type == "cpu":
        if variant == "f64":
            return hist_rows_ref(codes, vals, None, n_bins)
        if variant != "partials":
            return histograms_ref(codes, vals, n_bins)
        parts = partials_ref(codes, vals, n_bins, tile_p)
    else:
        parts = histograms_cuda(codes, vals, n_bins, variant=variant,
                                tile_p=tile_p)
        if variant != "partials":
            return parts
    p = parts.cpu().numpy().astype(np.float64)
    return torch.from_numpy(p[..., :3].sum(axis=0) + p[..., 3:].sum(axis=0))


def histograms(codes: torch.Tensor, w: torch.Tensor, wy: torch.Tensor,
               wy2: torch.Tensor, n_bins: int, *, variant: str = "f64",
               tile_p: int = 2048) -> torch.Tensor:
    """(F, n_bins, 3) sums of (w, wy, wy2) per (feature, bin): codes (P, F)
    integer bin ids below ``n_bins`` (uint8 on the card), w/wy/wy2 (P,)."""
    return histograms_packed(codes, pack_values(w, wy, wy2, variant), n_bins,
                             variant=variant, tile_p=tile_p)


def _uint8_codes(codes, n_bins: int) -> np.ndarray:
    codes = np.asarray(codes)
    if codes.ndim != 2:
        raise ValueError(f"codes must be (P, F), got shape {codes.shape}")
    if codes.dtype != np.uint8:
        if not np.issubdtype(codes.dtype, np.integer):
            raise TypeError(f"codes must be integers, got {codes.dtype}")
        if codes.size and (codes.min() < 0 or codes.max() > 255):
            raise ValueError("codes must lie in [0, 256)")
        codes = codes.astype(np.uint8)
    if n_bins < 256 and codes.size and codes.max() >= n_bins:
        raise ValueError(f"codes must lie below n_bins={n_bins}")
    return np.ascontiguousarray(codes)


def _upload(codes, w, wy, wy2, n_bins: int, variant: str, device):
    """(codes (P, F) uint8, packed values) on ``device``, both views of one
    buffer that travels in one upload."""
    codes = _uint8_codes(codes, n_bins)
    P, F = codes.shape
    vals = pack_values(*(torch.as_tensor(np.asarray(a, np.float64))
                         for a in (w, wy, wy2)), variant)
    if vals.shape[0] != P:
        raise ValueError(f"{vals.shape[0]} values for {P} codes")
    nv = vals.numel() * vals.element_size()
    buf = torch.empty(nv + P * F, dtype=torch.uint8)
    buf[:nv].view(vals.dtype).view(vals.shape).copy_(vals)
    buf[nv:].view(P, F).copy_(torch.from_numpy(codes))
    buf = buf.to(device)
    return buf[nv:].view(P, F), buf[:nv].view(vals.dtype).view(vals.shape)


def hist_split(codes, w, wy, wy2, n_bins: int, *, variant: str = "f64",
               tile_p: int = 2048, device="cuda") -> np.ndarray:
    """The ``hist_split`` op on ``device``, host arrays in and a float64
    (F, n_bins, 3) array out.  The codes and the packed values travel to the
    device in one upload."""
    codes, vals = _upload(codes, w, wy, wy2, n_bins, variant, device)
    out = histograms_packed(codes, vals, n_bins, variant=variant,
                            tile_p=tile_p)
    return out.cpu().numpy().astype(np.float64, copy=False)


class ResidentHist:
    """A tree's codes (P, F) and packed (w, wy, wy2) on ``device``, uploaded
    once; calling it with a node's rows returns that node's float64
    (F, n_bins, 3) sums as a host array, bitwise
    ``hist_split(codes[rows], w[rows], wy[rows], wy2[rows], n_bins)``.

    Rows are host integers, strictly ascending in [0, P).  On the card one
    C call a node (``HIST_F64_NODE``) copies them from a pinned buffer,
    launches, copies the sums into a pinned buffer and waits; the device
    scratch and both buffers are allocated here, once.  On the CPU the
    kernel's plain version runs on the same resident tensors.
    """

    def __init__(self, codes, w, wy, wy2, n_bins: int, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.codes, self.vals = _upload(codes, w, wy, wy2, n_bins, "f64",
                                        self.device)
        self.n_bins = int(n_bins)
        P, F = self.codes.shape
        if self.device.type == "cpu":
            return
        check_f64_shapes(P, F, self.n_bins)
        self._scratch = torch.empty(f64_scratch_bytes(P, F, self.n_bins),
                                    dtype=torch.uint8, device=self.device)
        self._rows = torch.empty(max(P, 1), dtype=torch.int32,
                                 device=self.device)
        self._out = torch.empty((F, self.n_bins, 3), dtype=torch.float64,
                                device=self.device)
        self._rows_host = torch.empty(max(P, 1), dtype=torch.int32,
                                      pin_memory=True)
        self._out_host = torch.empty((F, self.n_bins, 3), dtype=torch.float64,
                                     pin_memory=True)
        self._rows_np = self._rows_host.numpy()
        self._out_np = self._out_host.numpy()
        self._ptrs = (self.codes.data_ptr(), self.vals.data_ptr(),
                      self._rows_host.data_ptr(), self._rows.data_ptr())
        self._tail = (self._scratch.data_ptr(), self._out.data_ptr(),
                      self._out_host.data_ptr(), F, self.n_bins)

    def __call__(self, rows) -> np.ndarray:
        rows = np.asarray(rows)
        P, F = self.codes.shape
        if rows.ndim != 1 or not np.issubdtype(rows.dtype, np.integer):
            raise TypeError(f"rows must be (n,) integers, got {rows.shape} "
                            f"{rows.dtype}")
        n = rows.shape[0]
        if n and (rows[0] < 0 or rows[-1] >= P
                  or not (rows[1:] > rows[:-1]).all()):
            raise ValueError(f"rows must be strictly ascending in [0, {P})")
        if self.device.type == "cpu":
            return hist_rows_ref(self.codes, self.vals, torch.from_numpy(rows),
                                 self.n_bins).numpy()
        self._rows_np[:n] = rows
        stream = torch.cuda.current_stream(self.device).cuda_stream
        if torch.cuda.current_device() == self.device.index:
            HIST_F64_NODE(*self._ptrs, n, *self._tail, stream)
        else:
            with torch.cuda.device(self.device):
                HIST_F64_NODE(*self._ptrs, n, *self._tail, stream)
        return self._out_np.copy()
