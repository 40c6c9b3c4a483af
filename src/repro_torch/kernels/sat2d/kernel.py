"""Launchers of ``csrc/sat2d.cu`` (see the source for the design and bound).

Replaces ``src/repro/kernels/sat2d/kernel.py::scan_rows`` (``init=None``)
as ``sat2d/ops.py::sat_moments`` runs it.  ``SAT_MOMENTS_F64`` keeps numpy's
summation order bitwise and is the one the coreset build uses;
``SAT_MOMENTS_F32`` is the TPU kernel's own type.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, require_cuda

__all__ = ["SAT_MOMENTS_F64", "SAT_MOMENTS_F32", "sat_moments_cuda"]

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.c_void_p]
SAT_MOMENTS_F64 = CudaKernel("sat2d", "sat_moments_f64", _ARGS)
SAT_MOMENTS_F32 = CudaKernel("sat2d", "sat_moments_f32", _ARGS)
_KERNELS = {torch.float64: SAT_MOMENTS_F64, torch.float32: SAT_MOMENTS_F32}


def sat_moments_cuda(y: torch.Tensor) -> torch.Tensor:
    """(3, n, m) integral images of (1, y, y^2) for a CUDA (n, m) tensor of
    float64 or float32."""
    require_cuda(y)
    if y.dim() != 2:
        raise ValueError(f"signal must be 2D, got shape {tuple(y.shape)}")
    kern = _KERNELS.get(y.dtype)
    if kern is None:
        raise TypeError(f"sat_moments takes float64 or float32, got {y.dtype}")
    n, m = y.shape
    if not (1 <= n < 2**31 and 1 <= m < 2**31):
        raise ValueError(f"unsupported signal shape {(n, m)}")
    y = y.contiguous()
    out = torch.empty((3, n, m), dtype=y.dtype, device=y.device)
    with torch.cuda.device(y.device):
        kern(y.data_ptr(), out.data_ptr(), n, m,
             torch.cuda.current_stream().cuda_stream)
    return out
