"""Launchers of ``csrc/fitting_loss.cu`` (see the source for the design and
bound).

Replaces ``src/repro/kernels/fitting_loss/kernel.py::fitting_loss_batched_call``
(``FITTING_LOSS_BATCHED``) and ``::fitting_loss_call`` (``FITTING_LOSS``, the
same launch with T = 1, counted on its own).  Inputs are packed as in the
reference: blocks (B, 16) = rects | labels | weights | unused, trees
(T, K, 8) = rect | label | unused, float32.  Ragged B and T are masked in
the kernel, not padded.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import CudaKernel, ceil_div, require_cuda

__all__ = ["FITTING_LOSS", "FITTING_LOSS_BATCHED", "pack_blocks",
           "pack_trees", "fitting_loss_batched_cuda", "fitting_loss_cuda"]

_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
FITTING_LOSS_BATCHED = CudaKernel("fitting_loss", "fitting_loss_batched", _ARGS)
FITTING_LOSS = CudaKernel("fitting_loss", "fitting_loss_batched", _ARGS)
# coreset blocks per CTA: THREADS in csrc/fitting_loss.cu, which sizes the
# (T, ceil(B / CHUNK)) partials the launcher is given
CHUNK = 256


def pack_blocks(rects, labels4, weights4) -> torch.Tensor:
    """(B, 16) float32 block array on the inputs' device."""
    cols = [torch.as_tensor(a).to(torch.float32) for a in (rects, labels4, weights4)]
    return torch.cat(cols + [torch.zeros_like(cols[0])], dim=1).contiguous()


def pack_trees(seg_rects, seg_labels) -> torch.Tensor:
    """(T, K, 8) float32 tree array on the inputs' device."""
    r = torch.as_tensor(seg_rects).to(torch.float32)
    lab = torch.as_tensor(seg_labels).to(torch.float32)[..., None]
    pad = torch.zeros(r.shape[:-1] + (3,), dtype=torch.float32, device=r.device)
    return torch.cat([r, lab, pad], dim=-1).contiguous()


def _launch(kern: CudaKernel, blk: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    require_cuda(blk, seg)
    if blk.dtype != torch.float32 or seg.dtype != torch.float32:
        raise TypeError("fitting_loss kernels take float32 blocks and trees")
    if blk.dim() != 2 or blk.shape[1] != 16:
        raise ValueError(f"blocks must be (B, 16), got {tuple(blk.shape)}")
    if seg.dim() != 3 or seg.shape[2] != 8:
        raise ValueError(f"trees must be (T, K, 8), got {tuple(seg.shape)}")
    if blk.device != seg.device:
        raise ValueError("blocks and trees lie on different devices")
    B, (T, K) = blk.shape[0], seg.shape[:2]
    if B == 0 or T == 0 or K == 0:
        return torch.zeros(T, dtype=torch.float32, device=blk.device)
    nchunks = ceil_div(B, CHUNK)
    if T >= 2**31 or nchunks > 65535 or K >= 2**31:
        raise ValueError(f"unsupported sizes B={B} T={T} K={K}")
    partial = torch.empty((T, nchunks), dtype=torch.float32, device=blk.device)
    out = torch.empty(T, dtype=torch.float32, device=blk.device)
    blk, seg = blk.contiguous(), seg.contiguous()
    with torch.cuda.device(blk.device):
        kern(blk.data_ptr(), seg.data_ptr(), partial.data_ptr(), out.data_ptr(),
             B, T, K, torch.cuda.current_stream().cuda_stream)
    return out


def fitting_loss_batched_cuda(blk: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(T,) float32 losses of the (T, K, 8) trees against the (B, 16) blocks."""
    return _launch(FITTING_LOSS_BATCHED, blk, seg)


def fitting_loss_cuda(blk: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """0-d float32 loss of one (K, 8) tree against the (B, 16) blocks."""
    if seg.dim() != 2:
        raise ValueError(f"tree must be (K, 8), got {tuple(seg.shape)}")
    return _launch(FITTING_LOSS, blk, seg[None])[0]
