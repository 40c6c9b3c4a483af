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

The compensated (two-float) twins carry every partial sum as a float32 pair
``hi + lo``: prefix sums combine pairs with Knuth's error-free TwoSum, so
each addition's rounding error lands in ``lo``.  Inputs are split the same
way (``split_hi_lo``), which also keeps the float64 -> float32 cast error.
``hi + lo`` recombined in float64 on the host is within the autotuner's
1e-6 scaled certificate of the float64 oracle, in float32 arithmetic only.
"""
from __future__ import annotations

import torch

__all__ = ["sat_moments_ref", "delta_sat_ref", "sat_stack_ref", "STACK_ORDER",
           "split_hi_lo", "comp_cumsum", "sat_moments_comp_ref",
           "delta_sat_comp_ref", "sat_stack_comp_ref"]

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


# -------------------------------------------------- compensated (two-float)
def split_hi_lo(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a tensor, as float64, into a float32 pair with ``hi + lo == x``
    to float32-pair precision (~2^-48 relative)."""
    x = x.to(torch.float64)
    hi = x.to(torch.float32)
    return hi, (x - hi.to(torch.float64)).to(torch.float32)


def _two_sum(a_hi, a_lo, b_hi, b_lo):
    """Knuth's TwoSum on (hi, lo) pairs: the rounding error of ``a_hi +
    b_hi`` is recovered exactly and folded into ``lo``."""
    s = a_hi + b_hi
    z = s - a_hi
    err = (a_hi - (s - z)) + (b_hi - z)
    return s, a_lo + b_lo + err


def comp_cumsum(hi: torch.Tensor, lo: torch.Tensor,
                dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Compensated inclusive prefix sum along ``dim`` over (hi, lo) pairs.

    A log-step (Hillis-Steele) scan: at step ``d`` every element adds the
    pair ``d`` places before it, for d = 1, 2, 4, ...  That is ceil(log2 n)
    whole-tensor TwoSums, where a sequential scan would be n slice ops (2048
    along a delta band's rows); like the reference's associative scan, each
    prefix is a tree of log depth, though a different tree, so the pairs
    are not bitwise the reference's."""
    n = hi.shape[dim]
    d = 1
    while d < n:
        s, l = _two_sum(hi.narrow(dim, 0, n - d), lo.narrow(dim, 0, n - d),
                        hi.narrow(dim, d, n - d), lo.narrow(dim, d, n - d))
        hi = torch.cat([hi.narrow(dim, 0, d), s], dim)
        lo = torch.cat([lo.narrow(dim, 0, d), l], dim)
        d *= 2
    return hi, lo


def sat_moments_comp_ref(y_hi: torch.Tensor, y_lo: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) float32 pairs of the (3, n, m) moment integral images.

    The ones channel is analytic, ``(i+1)(j+1)`` in float32, which is exact
    while n * m <= 2^24 (a 4096 x 4096 signal is the last square one), so
    only the y and y^2 channels pay for the compensated scans, within each
    row first, then down the rows.  ``y^2`` enters as the pair ``(hi*hi,
    2*hi*lo)``: the dropped ``lo^2`` is ~2^-96 relative."""
    n, m = y_hi.shape
    stk_hi = torch.stack([y_hi, y_hi * y_hi])
    stk_lo = torch.stack([y_lo, 2.0 * y_hi * y_lo])
    h, l = comp_cumsum(stk_hi, stk_lo, dim=2)
    h, l = comp_cumsum(h, l, dim=1)
    counts = (torch.arange(1, n + 1, dtype=torch.float32, device=y_hi.device)[:, None]
              * torch.arange(1, m + 1, dtype=torch.float32, device=y_hi.device))[None]
    return torch.cat([counts, h]), torch.cat([torch.zeros_like(counts), l])


def delta_sat_comp_ref(carry_hi, carry_lo, tail_hi, tail_lo
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compensated twin of ``delta_sat_ref``: the (3, b, m) patched rows as
    (hi, lo) pairs, the stored carry row entering as its own pair so that
    chained patches keep two-float precision."""
    stk_hi = torch.stack([torch.ones_like(tail_hi), tail_hi, tail_hi * tail_hi])
    stk_lo = torch.stack([torch.zeros_like(tail_hi), tail_lo,
                          2.0 * tail_hi * tail_lo])
    h, l = comp_cumsum(stk_hi, stk_lo, dim=2)
    # continue the row recurrence from the carry pair: prepend, scan, drop
    h = torch.cat([carry_hi[:, None, :], h], dim=1)
    l = torch.cat([carry_lo[:, None, :], l], dim=1)
    h, l = comp_cumsum(h, l, dim=1)
    return h[:, 1:, :], l[:, 1:, :]


def sat_stack_comp_ref(stk_hi: torch.Tensor, stk_lo: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compensated twin of ``sat_stack_ref`` over (hi, lo) pairs, rows first
    (the order of the reference's ``sat_stack``)."""
    h, l = comp_cumsum(stk_hi, stk_lo, dim=-1)
    return comp_cumsum(h, l, dim=-2)
