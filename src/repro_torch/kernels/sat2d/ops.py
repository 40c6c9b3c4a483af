"""Public wrappers of the sat2d kernels: the plain version for a CPU tensor,
the CUDA kernel for a CUDA tensor (which launches or raises)."""
from __future__ import annotations

import torch

from .kernel import delta_sat_cuda, sat_moments_cuda, sat_stack_cuda
from .ref import STACK_ORDER, delta_sat_ref, sat_moments_ref, sat_stack_ref

__all__ = ["sat_moments", "delta_sat_moments", "sat_stack"]


def sat_moments(y: torch.Tensor) -> torch.Tensor:
    """(3, n, m) inclusive integral images of (1, y, y^2), in y's dtype."""
    if y.device.type == "cpu":
        return sat_moments_ref(y)
    return sat_moments_cuda(y)


def delta_sat_moments(carry: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """(3, b, m) patched integral-image rows (``ref.delta_sat_ref``) for a
    carry row (3, m) and the tail rows (b, m), in the tail's dtype."""
    if tail.device.type == "cpu" and carry.device.type == "cpu":
        return delta_sat_ref(carry, tail)
    return delta_sat_cuda(carry, tail)


def sat_stack(stk: torch.Tensor) -> torch.Tensor:
    """Inclusive integral images over the last two axes of a (..., n, m)
    stack, in the order of its dtype's kernel (``ref.STACK_ORDER``)."""
    if stk.dim() < 2:
        raise ValueError(f"stack must have at least 2 dims, got {tuple(stk.shape)}")
    if stk.device.type == "cpu":
        if stk.dtype not in STACK_ORDER:
            raise TypeError(f"sat_stack takes float64 or float32, got {stk.dtype}")
        return sat_stack_ref(stk, STACK_ORDER[stk.dtype])
    *lead, n, m = stk.shape
    return sat_stack_cuda(stk.reshape(-1, n, m)).reshape(*lead, n, m)
