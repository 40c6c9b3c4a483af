"""Launchers of ``csrc/flash_attention.cu`` (see the source for the design
and bound).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_call``:
``FLASH_ATTENTION_BF16`` for bfloat16 inputs and ``FLASH_ATTENTION_F32``
(3xTF32 on ``mma.sync``, float32 accuracy; four warps for 16 query rows,
each a quarter of every key tile) for float32 ones, each with its own
launch count.  The bfloat16 kernel is written for Hopper: a producer warp
feeds Q and a ring of K/V tiles into shared memory by TMA, and two consumer
warpgroups of 64 query rows each run ``wgmma`` on them (Q·Kᵀ from shared
memory, P·V with P from registers), the online softmax in between in
registers; the bf16 tensor-core peak bounds it at the model's shapes.  The
C launcher builds the three TMA tensor maps on each call.  Ragged Lq and
Lk are masked in the kernel, not padded.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, aligned, ceil_div, require_cuda
from .ref import TILE_K

__all__ = ["FLASH_ATTENTION_BF16", "FLASH_ATTENTION_F32", "HEAD_DIMS",
           "check_inputs", "empty_row_divisor", "flash_attention_cuda"]

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
         ctypes.c_void_p]
FLASH_ATTENTION_BF16 = CudaKernel("flash_attention", "flash_attention_bf16", _ARGS)
FLASH_ATTENTION_F32 = CudaKernel("flash_attention", "flash_attention_f32", _ARGS)
_KERNELS = {torch.bfloat16: FLASH_ATTENTION_BF16, torch.float32: FLASH_ATTENTION_F32}
# the head sizes the kernels are instantiated for
HEAD_DIMS = (32, 64, 128)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what the kernels do not take: ranks, head counts, dtypes, a
    head size outside ``HEAD_DIMS`` or a value head size unlike the key's.

    The bfloat16 kernel reads q, k and v by TMA, which needs each stride a
    multiple of 16 bytes: a row is ``2 * D`` bytes and a head ``2 * L * D``,
    so every D in ``HEAD_DIMS`` meets it once the launcher has made the
    tensors contiguous and 16-byte aligned (``common.aligned``)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, Hq, Lq, D) and k, v "
                         "(B, Hkv, Lk, D)")
    B, Hq, Lq, D = q.shape
    Bk, Hkv, Lk, Dk = k.shape
    if Bk != B or Dk != D or k.shape[:3] != v.shape[:3]:
        raise ValueError(f"mismatched shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head sizes {HEAD_DIMS}, "
                         f"got D = {D}")
    if v.shape[3] != D:
        raise ValueError(f"flash_attention kernel needs V's head size equal to "
                         f"D = {D} (one of {HEAD_DIMS}), got {v.shape[3]}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"query heads {Hq} are not a multiple of KV heads {Hkv}")
    if q.dtype not in _KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes bfloat16 or float32 q, k, "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if Lq == 0 or Lk == 0 or B * Hq > 65535 or max(B * Hq * Lq, B * Hkv * Lk) * D >= 2**62:
        raise ValueError(f"unsupported sizes B={B} Hq={Hq} Lq={Lq} Lk={Lk}")


def empty_row_divisor(Lk: int) -> float:
    """What a row that sees no key divides its sum of V by: the Pallas
    kernel's padded key count, whole tiles of ``min(256, Lk)`` keys."""
    tk = min(TILE_K, Lk)
    return float(ceil_div(Lk, tk) * tk)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """(B, Hq, Lq, D) attention output in q's dtype, by the kernel of q's
    dtype; raises without a card or for tensors off it."""
    check_inputs(q, k, v)
    require_cuda(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    B, Hq, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    q, k, v = aligned(q), aligned(k), aligned(v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _KERNELS[q.dtype](q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          B, Hq, Hkv, Lq, Lk, D, int(causal),
                          1.0 / float(D) ** 0.5, empty_row_divisor(Lk),
                          torch.cuda.current_stream().cuda_stream)
    return out
