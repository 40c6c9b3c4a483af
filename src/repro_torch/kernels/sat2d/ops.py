"""Public wrapper of the sat_moments kernel: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor (which launches or raises)."""
from __future__ import annotations

import torch

from .kernel import sat_moments_cuda
from .ref import sat_moments_ref

__all__ = ["sat_moments"]


def sat_moments(y: torch.Tensor) -> torch.Tensor:
    """(3, n, m) inclusive integral images of (1, y, y^2), in y's dtype."""
    if y.device.type == "cpu":
        return sat_moments_ref(y)
    return sat_moments_cuda(y)
