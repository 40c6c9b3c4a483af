"""Launchers of ``csrc/fitting_loss.cu`` (see the source for the design and
bound).

Replaces ``src/repro/kernels/fitting_loss/kernel.py::fitting_loss_batched_call``
(``FITTING_LOSS_BATCHED``) and ``::fitting_loss_call`` (``FITTING_LOSS``, the
same launch with T = 1, counted on its own).  Inputs are packed as in the
reference: blocks (B, 16) = rects | labels | weights | unused, trees
(T, K, 8) = rect | label | unused, float32.  Ragged B and T are masked in
the kernel, not padded.  :func:`launch_shape` gives the launch that the
source chooses from B, T and the card's SMs: CTAs a tree and warps a CTA.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import (CudaKernel, aligned, ceil_div, device_sms, library,
                      require_cuda)
from .ref import overlaps

__all__ = ["FITTING_LOSS", "FITTING_LOSS_BATCHED", "launch_shape", "work",
           "pack_blocks", "pack_trees", "fitting_loss_batched_cuda",
           "fitting_loss_cuda"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
FITTING_LOSS_BATCHED = CudaKernel("fitting_loss", "fitting_loss_batched", _ARGS)
FITTING_LOSS = CudaKernel("fitting_loss", "fitting_loss_batched", _ARGS)
# fl_launch_shape's numbers, in its order
_SHAPE_KEYS = ("chunk", "chunks", "splits", "chunks_per_cta", "warps", "rounds",
               "ctas", "max_warps")


def launch_shape(B: int, T: int, sms: int | None = None, lib=None) -> dict:
    """The launch of the loss kernel for T trees against B blocks on a card
    of ``sms`` SMs (the current device's by default), as
    ``csrc/fitting_loss.cu``'s ``fl_launch_shape`` chooses it: blocks a
    chunk (a warp), chunks (a tree's partials), CTAs a tree, chunks a CTA,
    warps a CTA and their rounds, CTAs, and warps a CTA at most.  ``lib``
    is the library to ask: this checkout's by default, or another build of
    the source (scripts/fitting_loss_turns.py)."""
    if B < 1 or T < 1 or max(B, T) >= 2**31:
        raise ValueError(f"launch_shape needs 1 <= B, T < 2^31, got B={B} T={T}")
    if sms is None:
        sms = device_sms()
    shape = (ctypes.c_longlong * len(_SHAPE_KEYS))()
    fn = (library("fitting_loss") if lib is None else lib).fl_launch_shape
    fn.argtypes = [_I, _I, _I, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = None
    fn(B, T, sms, shape)
    return dict(zip(_SHAPE_KEYS, shape))


def work(rects: torch.Tensor, seg_rects: torch.Tensor, chunk: int) -> dict:
    """What the kernel's design needs to do for each of T trees, by the
    plain version's overlaps z of the (B, 4) block rects within the
    (T, K, 4) leaf rects, with ``chunk`` consecutive blocks a warp: the
    (chunk, leaf) box tests (every one), the (chunk, leaf) pairs in which
    some block overlaps the leaf (each runs ``chunk`` overlaps) and the
    (block, leaf) pairs with z > 0 (each runs the loss body); (T,) int64
    each."""
    hit = overlaps(rects, seg_rects) > 0                   # (T, B, K)
    T, B, K = hit.shape
    chunks = ceil_div(B, chunk)
    pad = hit.new_zeros((T, chunks * chunk - B, K))
    chunk_hit = torch.cat([hit, pad], dim=1).view(T, chunks, chunk, K).any(dim=2)
    return {"box_tests": torch.full((T,), chunks * K, dtype=torch.int64),
            "chunk_hits": chunk_hit.sum(dim=(1, 2)).cpu(),
            "live_pairs": hit.sum(dim=(1, 2)).cpu()}


# Each stream's counts of a tree's finished CTAs: zeroed once, and each
# launch leaves them zero again, so a launch needs no fill of its own.
# Launches on one stream run in order; each stream has its own counts.
_DONE: dict = {}


def done_counts(device: torch.device, stream: int, trees: int) -> torch.Tensor:
    """The zeroed int32 counts of ``trees`` trees for launches on
    ``stream`` of ``device``."""
    key = (device, stream)
    done = _DONE.get(key)
    if done is None or done.numel() < trees:
        done = torch.zeros(max(trees, 1024), dtype=torch.int32, device=device)
        _DONE[key] = done
    return done


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
    if max(B, T, K) >= 2**31:
        raise ValueError(f"unsupported sizes B={B} T={T} K={K}")
    blk, seg = aligned(blk), aligned(seg)     # the kernel reads float4 rows
    with torch.cuda.device(blk.device):
        shape = launch_shape(B, T)
        partial = torch.empty((T, shape["chunks"]), dtype=torch.float32,
                              device=blk.device)
        out = torch.empty(T, dtype=torch.float32, device=blk.device)
        stream = torch.cuda.current_stream().cuda_stream
        done = done_counts(blk.device, stream, T)
        kern(blk.data_ptr(), seg.data_ptr(), partial.data_ptr(), done.data_ptr(),
             out.data_ptr(), B, T, K, shape["warps"], shape["splits"], stream)
    return out


def fitting_loss_batched_cuda(blk: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """(T,) float32 losses of the (T, K, 8) trees against the (B, 16) blocks."""
    return _launch(FITTING_LOSS_BATCHED, blk, seg)


def fitting_loss_cuda(blk: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
    """0-d float32 loss of one (K, 8) tree against the (B, 16) blocks."""
    if seg.dim() != 2:
        raise ValueError(f"tree must be (K, 8), got {tuple(seg.shape)}")
    return _launch(FITTING_LOSS, blk, seg[None])[0]
