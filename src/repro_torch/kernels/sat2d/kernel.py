"""Launchers of ``csrc/sat2d.cu`` (see the source for the design and bound).

Replaces ``src/repro/kernels/sat2d/kernel.py::scan_rows`` as the reference's
``sat2d/ops.py`` runs it:

- ``SAT_MOMENTS_F64`` / ``_F32``: ``sat_moments`` (``init=None``), the build;
- ``SAT_DELTA_F64`` / ``_F32``: ``delta_sat_moments``, the unseeded row pass
  and the carry-seeded ``init=...`` scan, the write path's row patch: two
  launches, ``sat_delta_rows`` (one warp for 2 tail rows, a lane for each
  y or y^2 row chain, fed by a cp.async ring of column tiles, so a short
  tail still spreads over the card) and ``sat_delta_cols`` (one lane for
  each column of each channel, seeded from the carry, fed by a ring of row
  stages); channel 0's within-row sums are the exact sums of ones, never
  scanned (:func:`delta_launch_shape` gives the launch at a tail's shape);
- ``SAT_STACK_F64`` / ``_F32``: ``sat_stack``, one launch for the moment
  rasters of every bucket of a merge-reduce level.

The float64 launchers keep numpy's summation order bitwise and are the ones
the coreset pipeline uses; the float32 ones are the TPU kernel's own type.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, ceil_div, library, require_cuda

__all__ = ["SAT_MOMENTS_F64", "SAT_MOMENTS_F32", "SAT_DELTA_F64",
           "SAT_DELTA_F32", "SAT_STACK_F64", "SAT_STACK_F32",
           "sat_moments_cuda", "delta_sat_cuda", "delta_launch_shape",
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
# threads per column-pass block and rows per stack row-pass block:
# COL_THREADS and STACK_WARPS * ROWS in csrc/sat2d.cu
_COL_THREADS, _STACK_ROWS = 64, 128


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


def delta_launch_shape(b: int, m: int) -> dict:
    """The delta kernels' launch at a (b, m) tail, as ``csrc/sat2d.cu``
    sizes it: each pass's CTAs and ring depth."""
    shape = (ctypes.c_int * 6)()
    fn = library("sat2d").sat_delta_shape
    fn.argtypes = [_I, _I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = None
    fn(b, m, shape)
    return {"rows_ctas": shape[0], "rows_ring_tiles": shape[1],
            "tile_cols": shape[2], "cols_ctas": shape[3],
            "cols_ring_stages": shape[4], "stage_rows": shape[5]}


def sat_stack_cuda(stk: torch.Tensor) -> torch.Tensor:
    """Integral images of every (n, m) plane of a CUDA (B, n, m) stack:
    float64 columns first, float32 rows first (``ref.STACK_ORDER``)."""
    require_cuda(stk)
    if stk.dim() != 3:
        raise ValueError(f"stack must be (B, n, m), got shape {tuple(stk.shape)}")
    B, n, m = stk.shape
    kern = _kernel(_STACK, "sat_stack", stk)
    if not (B >= 1 and 1 <= n < 2**31 and 1 <= m < 2**31
            and ceil_div(B * n, _STACK_ROWS) < 2**31
            and ceil_div(B * m, _COL_THREADS) < 2**31):
        raise ValueError(f"unsupported stack shape {(B, n, m)}")
    stk = stk.contiguous()
    out = torch.empty_like(stk)
    with torch.cuda.device(stk.device):
        kern(stk.data_ptr(), out.data_ptr(), B, n, m,
             torch.cuda.current_stream().cuda_stream)
    return out
