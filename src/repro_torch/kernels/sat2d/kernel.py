"""Launchers of ``csrc/sat2d.cu`` (see the source for the design and bound).

Replaces ``src/repro/kernels/sat2d/kernel.py::scan_rows`` as the reference's
``sat2d/ops.py`` runs it:

- ``SAT_MOMENTS_F64`` / ``_F32``: ``sat_moments`` (``init=None``), the build
  and the stream's frames;
- ``SAT_DELTA_F64`` / ``_F32``: ``delta_sat_moments``, the unseeded row pass
  and the carry-seeded ``init=...`` scan, the write path's row patch;
- ``SAT_STACK_F64`` / ``_F32``: ``sat_stack``, one launch for the moment
  rasters of every bucket of a merge-reduce level.

All three are two launches of the same two kernels: ``row_scan`` (one warp
for a few rows, a lane for each row chain, fed by a cp.async ring of column
tiles, so a short tail still spreads over the card) and ``col_scan`` (one
lane for each column of each plane, seeded from the carry or from -0.0, fed
by a ring of row stages).  For sat_moments and sat_delta the row pass scans
each row's y and y^2 and the column pass adds channel 0's exact sums of
ones, never scanned; sat_stack scans each plane as it is.
:func:`launch_shape` gives each op's launch at a shape.

The float64 launchers keep numpy's summation order bitwise and are the ones
the coreset pipeline uses; the float32 ones are the TPU kernel's own type.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, library, require_cuda

__all__ = ["SAT_MOMENTS_F64", "SAT_MOMENTS_F32", "SAT_DELTA_F64",
           "SAT_DELTA_F32", "SAT_STACK_F64", "SAT_STACK_F32",
           "sat_moments_cuda", "delta_sat_cuda", "launch_shape",
           "sat_stack_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
SAT_MOMENTS_F64 = CudaKernel("sat2d", "sat_moments_f64", [_P, _P, _I, _I, _P])
SAT_MOMENTS_F32 = CudaKernel("sat2d", "sat_moments_f32", [_P, _P, _I, _I, _P])
SAT_DELTA_F64 = CudaKernel("sat2d", "sat_delta_f64", [_P, _P, _P, _I, _I, _P])
SAT_DELTA_F32 = CudaKernel("sat2d", "sat_delta_f32", [_P, _P, _P, _I, _I, _P])
_STACK_ARGS = [_P, _P, ctypes.c_longlong, _I, _I, _P]
SAT_STACK_F64 = CudaKernel("sat2d", "sat_stack_f64", _STACK_ARGS)
SAT_STACK_F32 = CudaKernel("sat2d", "sat_stack_f32", _STACK_ARGS)
_MOMENTS = {torch.float64: SAT_MOMENTS_F64, torch.float32: SAT_MOMENTS_F32}
_DELTA = {torch.float64: SAT_DELTA_F64, torch.float32: SAT_DELTA_F32}
_STACK = {torch.float64: SAT_STACK_F64, torch.float32: SAT_STACK_F32}
_SHAPE_KEYS = ("rows_ctas", "rows_per_cta", "rows_ring_tiles", "tile_cols",
               "cols_ctas", "cols_warps_per_cta", "cols_ring_stages",
               "stage_rows", "strip_cols")


def _kernel(table, what, t):
    kern = table.get(t.dtype)
    if kern is None:
        raise TypeError(f"{what} takes float64 or float32, got {t.dtype}")
    return kern


def _check_2d(what, t):
    if t.dim() != 2:
        raise ValueError(f"{what} must be 2D, got shape {tuple(t.shape)}")
    n, m = t.shape
    if not (1 <= n < 2**31 and 1 <= m < 2**31):
        raise ValueError(f"unsupported {what} shape {(n, m)}")
    return n, m


def launch_shape(op: str, n: int, m: int, planes: int = 3) -> dict:
    """The launch of ``op`` ("moments", "delta" or "stack") at ``planes``
    (n, m) planes (the stack's; sat_moments and sat_delta have three), as
    ``csrc/sat2d.cu`` sizes it, in either type: each pass's CTAs, rows or
    warps a CTA, ring depth and stage size."""
    if op not in ("moments", "delta", "stack"):
        raise ValueError(f"unknown sat2d op {op!r}")
    shape = (ctypes.c_longlong * len(_SHAPE_KEYS))()
    fn = library("sat2d").sat_launch_shape
    fn.argtypes = [_I, ctypes.c_longlong, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    fn(op == "stack", planes, n, m, shape)
    return dict(zip(_SHAPE_KEYS, shape))


def sat_moments_cuda(y: torch.Tensor) -> torch.Tensor:
    """(3, n, m) integral images of (1, y, y^2) for a CUDA (n, m) tensor of
    float64 or float32."""
    require_cuda(y)
    n, m = _check_2d("signal", y)
    kern = _kernel(_MOMENTS, "sat_moments", y)
    y = y.contiguous()
    out = torch.empty((3, n, m), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        kern(y.data_ptr(), out.data_ptr(), n, m,
             torch.cuda.current_stream().cuda_stream)
    return out


def delta_sat_cuda(carry: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """(3, b, m) patched integral-image rows for CUDA tensors: carry (3, m)
    and tail (b, m), both float64 or both float32."""
    require_cuda(carry, tail)
    b, m = _check_2d("tail", tail)
    kern = _kernel(_DELTA, "delta_sat", tail)
    if tuple(carry.shape) != (3, m) or carry.dtype != tail.dtype:
        raise ValueError(f"carry must be (3, {m}) {tail.dtype}, got "
                         f"{tuple(carry.shape)} {carry.dtype}")
    if carry.device != tail.device:
        raise ValueError("carry and tail lie on different devices")
    carry, tail = carry.contiguous(), tail.contiguous()
    out = torch.empty((3, b, m), dtype=tail.dtype, device=tail.device)
    with torch.cuda.device(tail.device):
        kern(carry.data_ptr(), tail.data_ptr(), out.data_ptr(), b, m,
             torch.cuda.current_stream().cuda_stream)
    return out


def sat_stack_cuda(stk: torch.Tensor) -> torch.Tensor:
    """Integral images of every (n, m) plane of a CUDA (B, n, m) stack:
    float64 columns first, float32 rows first (``ref.STACK_ORDER``)."""
    require_cuda(stk)
    if stk.dim() != 3:
        raise ValueError(f"stack must be (B, n, m), got shape {tuple(stk.shape)}")
    B, n, m = stk.shape
    kern = _kernel(_STACK, "sat_stack", stk)
    if not (1 <= B < 2**31 and 1 <= n < 2**31 and 1 <= m < 2**31):
        raise ValueError(f"unsupported stack shape {(B, n, m)}")
    launch = launch_shape("stack", n, m, planes=B)
    if max(launch["rows_ctas"], launch["cols_ctas"]) >= 2**31:
        raise ValueError(f"stack shape {(B, n, m)} needs more CTAs than a "
                         f"launch takes: {launch}")
    stk = stk.contiguous()
    out = torch.empty_like(stk)
    with torch.cuda.device(stk.device):
        kern(stk.data_ptr(), out.data_ptr(), B, n, m,
             torch.cuda.current_stream().cuda_stream)
    return out
