"""Plain PyTorch versions of the sat2d kernels.

The same functions as ``csrc/sat2d.cu``:

- ``sat_moments_ref``: a within-row scan, then a scan down the rows, of the
  (1, y, y^2) stack;
- ``delta_sat_ref``: the rows of those images that change when the rows
  from some row on are replaced or appended, continued from the stored
  integral row above them (the write path's patch);
- ``sat_stack_ref``: integral images of every (n, m) plane of a stack, in
  either order (``STACK_ORDER`` gives the one each dtype's kernel keeps).

On the CPU, ``torch.cumsum`` sums each row and column in order, so in
float64 the results equal numpy's bitwise; on a CUDA tensor it is a
parallel scan that reorders the sums.  On the CPU signed zeros follow
numpy's too (``_cumsum``): a scan starts from its first element, as the
kernels' -0.0 seed makes it.
"""
from __future__ import annotations

import torch

__all__ = ["sat_moments_ref", "delta_sat_ref", "sat_stack_ref", "STACK_ORDER"]

# the order of each dtype's sat_stack kernel: float64 integrates the columns
# first, as PrefixStats.build_moments (the numpy streaming_compress oracle)
# does; float32 the rows first, as the reference's Pallas sat_stack does
STACK_ORDER = {torch.float64: "cols_first", torch.float32: "rows_first"}


def _cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum`` with numpy's signed zeros where the scan is numpy's:
    torch starts a scan from 0 + the first element, numpy from the element
    itself, so a prefix of -0.0s sums to -0.0 in numpy and to +0.0 in
    torch; past the first other element the two agree (-0.0 + x == +0.0 + x
    unless x is -0.0).  Only on the CPU, where torch sums in numpy's order:
    on a CUDA tensor the scan reorders the sums, so it is held to numpy by
    value there, and the fix would only slow the card's plain version."""
    s = torch.cumsum(x, dim)
    if x.device.type != "cpu":
        return s
    neg0 = (torch.signbit(x) & (x == 0)).to(torch.uint8)
    return s.masked_fill(torch.cumprod(neg0, dim).bool(), -0.0)


def sat_moments_ref(y: torch.Tensor) -> torch.Tensor:
    """(3, n, m) inclusive integral images of (1, y, y^2), in y's dtype."""
    stk = torch.stack([torch.ones_like(y), y, y * y])
    return _cumsum(_cumsum(stk, dim=2), dim=1)


def delta_sat_ref(carry: torch.Tensor, tail: torch.Tensor) -> torch.Tensor:
    """(3, b, m) patched integral-image rows: ``carry`` (3, m) is the integral
    row just above the patch (zeros at row 0), ``tail`` (b, m) the raw rows
    from the first changed row to the new end.

    The numpy oracle's order: a within-row scan of the (1, t, t^2) stack,
    then a scan down the rows with the carry row prepended, which is dropped
    again; so row i is row i-1 + inner[i], the adds a full build makes."""
    stk = torch.stack([torch.ones_like(tail), tail, tail * tail])
    inner = _cumsum(stk, dim=2)
    full = torch.cat([carry.to(tail.dtype)[:, None, :], inner], dim=1)
    return _cumsum(full, dim=1)[:, 1:, :]


def sat_stack_ref(stk: torch.Tensor, order: str) -> torch.Tensor:
    """Inclusive integral images over the last two axes of a (..., n, m)
    stack: ``"cols_first"`` scans down the columns, then along the rows (the
    order of ``PrefixStats.build_moments``); ``"rows_first"`` the other way
    round (the order of the reference's ``sat_stack``)."""
    if order == "cols_first":
        return _cumsum(_cumsum(stk, dim=-2), dim=-1)
    if order == "rows_first":
        return _cumsum(_cumsum(stk, dim=-1), dim=-2)
    raise ValueError(f"unknown order {order!r}; 'cols_first' or 'rows_first'")
