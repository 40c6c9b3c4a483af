"""Plain PyTorch version of the sat_moments kernel.

The same function as ``csrc/sat2d.cu``: a within-row scan, then a scan down
the rows, of the (1, y, y^2) stack.  On the CPU, ``torch.cumsum`` sums each
row and column in order, so in float64 the result equals numpy's
``np.cumsum(np.cumsum(stk, axis=2), axis=1)`` bitwise; on a CUDA tensor it
is a parallel scan that reorders the sums.
"""
from __future__ import annotations

import torch

__all__ = ["sat_moments_ref"]


def sat_moments_ref(y: torch.Tensor) -> torch.Tensor:
    """(3, n, m) inclusive integral images of (1, y, y^2), in y's dtype."""
    stk = torch.stack([torch.ones_like(y), y, y * y])
    return torch.cumsum(torch.cumsum(stk, dim=2), dim=1)
