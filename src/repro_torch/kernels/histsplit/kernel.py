"""Launchers of ``csrc/histsplit.cu`` (see the source for the design and
bound).

Replaces ``src/repro/kernels/histsplit/kernel.py::histograms_kernel_call``:
``HIST_FUSED`` its ``variant="fused"``, ``HIST_PARTIALS`` ``"partials"`` and
``HIST_LEGACY`` ``"legacy"``, all float32 as on the TPU; ``HIST_F64`` is the
float64 variant, bitwise equal to numpy's ``bincount`` over all points or a
node's rows, and ``HIST_F64_NODE`` the same kernel in one tree node's round
trip, the launch the trees make (``ops.ResidentHist``).  :func:`launch_shape`
gives the launch that the source chooses for the fused, partials and
legacy kernels (its ``hist_f32_launch_shape``).  Codes
are read as ``apply_bins`` makes them, (P, F) uint8 row-major; the reference
transposes them to (F, P) int32 only because its TPU kernel needs that.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, ceil_div, device_sms, library, require_cuda

__all__ = ["HIST_F64", "HIST_F64_NODE", "HIST_FUSED", "HIST_PARTIALS",
           "HIST_LEGACY", "MAX_BINS", "VARIANTS", "f64_scratch_bytes",
           "launch_shape", "histograms_cuda", "hist_rows_cuda"]

_P = ctypes.c_void_p
_TILES = [_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
          ctypes.c_int, _P]
_LL, _I = ctypes.c_longlong, ctypes.c_int
HIST_F64 = CudaKernel("histsplit", "hist_f64",
                      [_P, _P, _P, _LL, _P, _P, _I, _I, _P])
HIST_F64_NODE = CudaKernel("histsplit", "hist_f64_node",
                           [_P, _P, _P, _P, _LL, _P, _P, _P, _I, _I, _P])
HIST_FUSED = CudaKernel("histsplit", "hist_fused_f32", _TILES)
HIST_LEGACY = CudaKernel("histsplit", "hist_legacy_f32", _TILES)
HIST_PARTIALS = CudaKernel("histsplit", "hist_partials_f32",
                           [_P, _P, _P, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int, _P])
# MAX_BINS in csrc/histsplit.cu: the bins one CTA holds
MAX_BINS = 1024
# hist_f64 indexes rows with int32
MAX_ROWS = 2**31 - 1
# variant -> (value dtype, value channels)
VARIANTS = {"f64": (torch.float64, 3), "fused": (torch.float32, 3),
            "legacy": (torch.float32, 3), "partials": (torch.float32, 6)}


def f64_scratch_bytes(n: int, F: int, n_bins: int) -> int:
    """Device scratch of ``hist_f64`` for any node of up to ``n`` rows."""
    fn = library("histsplit").hist_f64_scratch_bytes
    fn.argtypes, fn.restype = [_LL, _I, _I], _LL
    return int(fn(n, F, n_bins))


# hist_f32_launch_shape's numbers, in its order
_SHAPE_KEYS = ("tiles", "feature_groups", "features_per_cta", "ctas",
               "threads", "smem_bytes", "sub_chunk", "sub_chunks_per_tile")


def check_tile_shapes(P: int, F: int, n_bins: int, tile_p: int) -> None:
    """Raise unless the tiled kernels take these sizes (P, F >= 0)."""
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins}: one CTA holds 1..{MAX_BINS} bins")
    if not 1 <= tile_p < 2**31:
        raise ValueError(f"unsupported tile_p={tile_p}")
    if ceil_div(P, tile_p) >= 2**31 or F >= 65536:
        raise ValueError(f"unsupported sizes P={P} F={F} tile_p={tile_p}")


def launch_shape(variant: str, P: int, F: int, n_bins: int, tile_p: int,
                 sms: int | None = None) -> dict:
    """The launch of the ``"fused"``, ``"partials"`` or ``"legacy"`` kernel
    as ``csrc/histsplit.cu``'s ``hist_f32_launch_shape`` chooses it on a card
    of ``sms`` SMs (the current device's by default): P-tiles, feature groups
    (CTAs a tile), features a CTA, CTAs, threads and shared bytes a CTA,
    points a sub-chunk and sub-chunks of a full tile.  Legacy's grid is a
    CTA a (tile, feature) at every size."""
    if variant not in ("fused", "partials", "legacy"):
        raise ValueError(f"launch_shape covers the float32 kernels, not {variant!r}")
    if min(P, F) < 1:
        raise ValueError(f"launch_shape needs P, F >= 1, got P={P} F={F}")
    check_tile_shapes(P, F, n_bins, tile_p)
    if sms is None:
        sms = device_sms()
    shape = (ctypes.c_longlong * len(_SHAPE_KEYS))()
    fn = library("histsplit").hist_f32_launch_shape
    fn.argtypes = [ctypes.c_char_p, _LL, _I, _I, _I, _I,
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = _I
    if fn(variant.encode(), P, F, n_bins, tile_p, sms, shape) != 0:
        raise ValueError(f"hist_f32_launch_shape does not know {variant!r}")
    return dict(zip(_SHAPE_KEYS, shape))


def check_f64_shapes(P: int, F: int, n_bins: int) -> None:
    if not 1 <= n_bins <= MAX_BINS:
        raise ValueError(f"n_bins={n_bins}: one CTA holds 1..{MAX_BINS} bins")
    if P > MAX_ROWS or F >= 65536:
        raise ValueError(f"unsupported sizes P={P} F={F}")


def hist_rows_cuda(codes: torch.Tensor, vals: torch.Tensor,
                   rows: torch.Tensor | None, n_bins: int,
                   scratch: torch.Tensor | None = None) -> torch.Tensor:
    """(F, n_bins, 3) float64 sums over ``rows`` of CUDA tensors: codes
    (P, F) uint8 below ``n_bins``, vals (P, 3) float64, rows (n,) int32
    strictly ascending in [0, P) or None for all P (not checked here: the
    caller's).  ``scratch`` of at least ``f64_scratch_bytes(n, F, n_bins)``
    bytes, or None to allocate it."""
    require_cuda(codes, vals, *(() if rows is None else (rows,)))
    if codes.dtype != torch.uint8 or codes.dim() != 2:
        raise TypeError(f"codes must be (P, F) uint8, got {tuple(codes.shape)} "
                        f"{codes.dtype}")
    P, F = codes.shape
    if vals.dtype != torch.float64 or tuple(vals.shape) != (P, 3):
        raise TypeError(f"hist_f64 takes ({P}, 3) float64 values, got "
                        f"{tuple(vals.shape)} {vals.dtype}")
    if rows is not None and (rows.dtype != torch.int32 or rows.dim() != 1):
        raise TypeError(f"rows must be (n,) int32, got {tuple(rows.shape)} "
                        f"{rows.dtype}")
    check_f64_shapes(P, F, n_bins)
    n = P if rows is None else rows.shape[0]
    out = torch.empty((F, n_bins, 3), dtype=torch.float64, device=vals.device)
    if F == 0:
        return out
    codes, vals = codes.contiguous(), vals.contiguous()
    if rows is not None:
        rows = rows.contiguous()
    if scratch is None:
        scratch = torch.empty(f64_scratch_bytes(n, F, n_bins),
                              dtype=torch.uint8, device=vals.device)
    with torch.cuda.device(vals.device):
        HIST_F64(codes.data_ptr(), vals.data_ptr(),
                 None if rows is None else rows.data_ptr(), n,
                 scratch.data_ptr(), out.data_ptr(), F, n_bins,
                 torch.cuda.current_stream().cuda_stream)
    return out


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
    check_tile_shapes(P, F, n_bins, tile_p)
    if variant == "f64":
        return hist_rows_cuda(codes, vals, None, n_bins)
    C = ceil_div(P, tile_p)
    shape = (C, F, n_bins, 6) if variant == "partials" else (F, n_bins, 3)
    if P == 0 or F == 0:
        return torch.zeros(shape, dtype=dtype, device=vals.device)
    out = torch.empty(shape, dtype=dtype, device=vals.device)
    codes, vals = codes.contiguous(), vals.contiguous()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "partials":
            HIST_PARTIALS(codes.data_ptr(), vals.data_ptr(), out.data_ptr(),
                          P, F, n_bins, tile_p, stream)
        else:
            partial = torch.empty((C, F, n_bins, 3), dtype=dtype,
                                  device=vals.device)
            kern = HIST_FUSED if variant == "fused" else HIST_LEGACY
            kern(codes.data_ptr(), vals.data_ptr(), partial.data_ptr(),
                 out.data_ptr(), P, F, n_bins, tile_p, stream)
    return out
