"""Gradient compression for the cross-pod all-reduce.

int8 quantization with per-tensor scales and **error feedback** (the
quantization residual is carried to the next step, so compression bias
vanishes in expectation — Seide et al. / EF-SGD).  Intended use: the "pod"
axis of a multi-pod mesh is the slow dimension; compressing the gradient
sync there cuts its bytes 4x (bf16 -> int8 + scale).

The tensor API here (quantize / dequantize / compress_with_feedback) keeps
the reference's float32 arithmetic (``torch.round`` rounds half to even,
as ``jnp.round`` does).  ``compressed_pod_psum`` is the reference's
``psum`` over the "pod" axis as a ``torch.distributed`` all_reduce, run by
every rank of the group (SPMD).  Nothing in the training step calls it yet,
as in the reference.
"""
from __future__ import annotations

import torch

from ..tree import leaves, unflatten

__all__ = ["quantize_int8", "dequantize_int8", "ef_init", "compress_with_feedback",
           "compressed_pod_psum"]


def quantize_int8(x: torch.Tensor):
    """(q int8, scale): ``scale = max|x| / 127 + 1e-12`` in x's dtype."""
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_init(grads):
    return unflatten(grads, [torch.zeros_like(g, dtype=torch.float32)
                             for g in leaves(grads)])


def compress_with_feedback(grads, error_state):
    """Returns (quantized tree of (q, scale) pairs, new_error_state)."""
    quant, err = [], []
    for g, e in zip(leaves(grads), leaves(error_state)):
        target = g.to(torch.float32) + e
        q, s = quantize_int8(target)
        quant.append((q, s))
        err.append(target - dequantize_int8(q, s))
    return unflatten(grads, quant), unflatten(grads, err)


def _group(group, axis_name: str):
    """A process group: ``group`` itself, a ``DeviceMesh``'s ``axis_name``
    dimension, or the default group for None."""
    if group is not None and hasattr(group, "get_group"):
        return group.get_group(axis_name)
    return group


def compressed_pod_psum(grads, error_state, group=None, axis_name: str = "pod"):
    """int8+EF all-reduce of grads over ``group``: a process group, or a
    ``DeviceMesh`` (from ``repro_torch.launch.mesh``) whose ``axis_name``
    dimension is taken, or None for the default group.  Every rank of the
    group calls it with its own grads.  Returns (synced_grads_f32_mean,
    new_error_state)."""
    import torch.distributed as dist
    pg = _group(group, axis_name)
    n = dist.get_world_size(pg)
    synced, err = [], []
    for g, e in zip(leaves(grads), leaves(error_state)):
        target = g.to(torch.float32) + e
        q, s = quantize_int8(target)
        deq = dequantize_int8(q, s)
        err.append(target - deq)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=pg)
        synced.append(deq / n)
    return unflatten(grads, synced), unflatten(grads, err)
