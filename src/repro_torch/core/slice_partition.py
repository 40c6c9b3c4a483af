"""Algorithm 1 (SLICEPARTITION) — greedy maximal-variance slicing of a band.

Given a horizontal band of rows [r0:r1) of the signal and a tolerance
``sigma``, partition it into vertical slices, each the *maximal* contiguous
column window whose opt1 is <= sigma.  When even a single column exceeds the
tolerance, that column is recursively partitioned horizontally (the paper's
``SLICEPARTITION(B^T, sigma)`` call).

Identical output to the paper's linear greedy scan, but each boundary is
located with a binary search over the monotone opt1 (see
``PrefixStats.max_col_extent``), so a band costs O(#slices * log m) instead
of O((r1-r0) * m).
"""
from __future__ import annotations

from .stats import PrefixStats

__all__ = ["slice_partition", "Rect"]

# A rectangle is (r0, r1, c0, c1), half-open on both axes.
Rect = tuple[int, int, int, int]


def slice_partition(ps: PrefixStats, r0: int, r1: int, sigma: float,
                    c_lo: int = 0, c_hi: int | None = None) -> list[Rect]:
    """Partition the band [r0:r1, c_lo:c_hi) into maximal slices with
    opt1 <= sigma (Algorithm 1)."""
    m = ps.shape[1]
    c_hi = m if c_hi is None else c_hi
    out: list[Rect] = []
    c0 = c_lo
    while c0 < c_hi:
        c_end = ps.max_col_extent(r0, r1, c0, sigma)
        c_end = min(c_end, c_hi)
        if c_end == c0:
            # Single column already exceeds sigma: recurse on its transpose,
            # i.e. partition the column along rows (Algorithm 1 lines 4-6).
            out.extend(_column_partition(ps, c0, r0, r1, sigma))
            c0 += 1
        else:
            out.append((r0, r1, c0, c_end))
            c0 = c_end
    return out


def _column_partition(ps: PrefixStats, c: int, r_lo: int, r_hi: int,
                      sigma: float) -> list[Rect]:
    """Greedy maximal row-windows of a single column; single cells have
    opt1 = 0 <= sigma so this always terminates with unit cells at worst."""
    out: list[Rect] = []
    r0 = r_lo
    while r0 < r_hi:
        r_end = ps.max_row_extent(c, c + 1, r0, sigma)
        r_end = min(max(r_end, r0 + 1), r_hi)  # a unit cell always fits
        out.append((r0, r_end, c, c + 1))
        r0 = r_end
    return out


def slices_count_if(ps: PrefixStats, r0: int, r1: int, sigma: float,
                    stop_above: int) -> int:
    """Number of slices SLICEPARTITION would produce, early-exiting once the
    count exceeds ``stop_above`` (used by Algorithm 2's band-growing loop so
    rejected bands don't pay for a full partition)."""
    m = ps.shape[1]
    cnt = 0
    c0 = 0
    while c0 < m:
        c_end = ps.max_col_extent(r0, r1, c0, sigma)
        if c_end == c0:
            # count the column's row-partition
            rr = r0
            while rr < r1:
                r_end = min(max(ps.max_row_extent(c0, c0 + 1, rr, sigma), rr + 1), r1)
                cnt += 1
                if cnt > stop_above:
                    return cnt
                rr = r_end
            c0 += 1
        else:
            cnt += 1
            c0 = c_end
        if cnt > stop_above:
            return cnt
    return cnt
