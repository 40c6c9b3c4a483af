"""Launchers of ``csrc/histsplit.cu`` (see the source for the design and
bound).

Replaces ``src/repro/kernels/histsplit/kernel.py::histograms_kernel_call``:
``HIST_FUSED`` its ``variant="fused"``, ``HIST_PARTIALS`` ``"partials"`` and
``HIST_LEGACY`` ``"legacy"``, all float32 as on the TPU; ``HIST_F64`` is the
float64 variant the trees use, bitwise equal to numpy's ``bincount``.  Codes
are read as ``apply_bins`` makes them, (P, F) uint8 row-major; the reference
transposes them to (F, P) int32 only because its TPU kernel needs that.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, ceil_div, require_cuda

__all__ = ["HIST_F64", "HIST_FUSED", "HIST_PARTIALS", "HIST_LEGACY",
           "MAX_BINS", "VARIANTS", "histograms_cuda"]

_P = ctypes.c_void_p
_TILES = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, _P]
HIST_F64 = CudaKernel("histsplit", "hist_f64",
                      [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, _P])
HIST_FUSED = CudaKernel("histsplit", "hist_fused_f32", _TILES)
HIST_LEGACY = CudaKernel("histsplit", "hist_legacy_f32", _TILES)
HIST_PARTIALS = CudaKernel("histsplit", "hist_partials_f32",
                           [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P])
# one thread per bin: MAX_THREADS in csrc/histsplit.cu
MAX_BINS = 1024
# variant -> (value dtype, value channels)
VARIANTS = {"f64": (torch.float64, 3), "fused": (torch.float32, 3),
            "legacy": (torch.float32, 3), "partials": (torch.float32, 6)}


def histograms_cuda(codes: torch.Tensor, vals: torch.Tensor, n_bins: int, *,
                    variant: str = "f64", tile_p: int = 2048) -> torch.Tensor:
    """Split histograms of CUDA tensors: codes (P, F) uint8, each below
    ``n_bins``; vals (P, S) in the variant's dtype (``VARIANTS``).

    ``"f64"``, ``"fused"`` and ``"legacy"`` return the (F, n_bins, 3) sums;
    ``"partials"`` returns the (ceil(P / tile_p), F, n_bins, 6) per-tile sums.
    """
    require_cuda(codes, vals)
    if variant not in VARIANTS:
        raise ValueError(f"unknown histsplit variant {variant!r}; "
                         f"valid: {sorted(VARIANTS)}")
    dtype, S = VARIANTS[variant]
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be (P, F) uint8, got {tuple(codes.shape)} "
                        f"{codes.dtype}")
    P, F = codes.shape
    if vals.dtype != dtype or tuple(vals.shape) != (P, S):
        raise TypeError(f"variant {variant!r} takes ({P}, {S}) {dtype} values, "
                        f"got {tuple(vals.shape)} {vals.dtype}")
    if codes.device != vals.device:
        raise ValueError("codes and values lie on different devices")
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins}: one CTA holds 1..{MAX_BINS} bins")
    if not 1 <= tile_p < 2**31:
        raise ValueError(f"unsupported tile_p={tile_p}")
    C = ceil_div(P, tile_p)
    if C >= 2**31 or F >= 65536:
        raise ValueError(f"unsupported sizes P={P} F={F} tile_p={tile_p}")
    shape = (C, F, n_bins, 6) if variant == "partials" else (F, n_bins, 3)
    if P == 0 or F == 0:
        return torch.zeros(shape, dtype=dtype, device=vals.device)
    out = torch.empty(shape, dtype=dtype, device=vals.device)
    codes, vals = codes.contiguous(), vals.contiguous()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "f64":
            HIST_F64(codes.data_ptr(), vals.data_ptr(), out.data_ptr(), P, F,
                     n_bins, stream)
        elif variant == "partials":
            HIST_PARTIALS(codes.data_ptr(), vals.data_ptr(), out.data_ptr(),
                          P, F, n_bins, tile_p, stream)
        else:
            partial = torch.empty((C, F, n_bins, 3), dtype=dtype,
                                  device=vals.device)
            kern = HIST_FUSED if variant == "fused" else HIST_LEGACY
            kern(codes.data_ptr(), vals.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), P, F, n_bins, tile_p, stream)
    return out
