"""Masked prefix statistics (summed-area tables) over an n x m signal.

Every algorithm in the paper reduces to O(1) queries of the form

    (S0, S1, S2)(R) = (sum 1, sum y, sum y^2) over a rectangle R,

optionally restricted to the *live* (not yet removed) cells.  We keep three
(n+1, m+1) float64 integral images and answer rectangle / row-interval /
column-interval queries, vectorized over arrays of rectangles.

``opt1`` (the optimal 1-segmentation SSE of a sub-signal, Definition 2 with
k=1) is ``S2 - S1^2 / S0`` — the variance identity used by Lemma 12(iv) /
Eq. (1) of the paper.

The unmasked/unweighted build routes through the ``repro_torch.ops.sat_moments``
dispatcher (the float64 CUDA kernel when a card is present, the numpy oracle
or the plain torch version when the caller pins one); this module remains the
owner of the float64 query API.  The row-patching methods of the reference
(``carry_row``, ``patch_rows``, ``append_rows``) belong to the write path and
are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["PrefixStats", "opt1_from_sums"]


def opt1_from_sums(s0, s1, s2):
    """SSE of the best constant fit given moments (vectorized, safe at s0=0).

    Uses max(.., 0) to clamp the tiny negative values float cancellation can
    produce for near-constant blocks.
    """
    s0 = np.asarray(s0, dtype=np.float64)
    s1 = np.asarray(s1, dtype=np.float64)
    s2 = np.asarray(s2, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        v = s2 - np.where(s0 > 0, (s1 * s1) / np.maximum(s0, 1e-300), 0.0)
    return np.maximum(v, 0.0)


@dataclasses.dataclass(frozen=True)
class PrefixStats:
    """Integral images of (count, y, y^2) for a (possibly masked, weighted) signal.

    ``p0/p1/p2`` have shape (n+1, m+1); entry [i, j] is the sum over the
    sub-matrix [0:i, 0:j].  Queries take half-open index ranges.
    """

    p0: np.ndarray
    p1: np.ndarray
    p2: np.ndarray

    # ------------------------------------------------------------------ build
    @staticmethod
    def build(values: np.ndarray, mask: np.ndarray | None = None,
              weights: np.ndarray | None = None) -> "PrefixStats":
        y = np.asarray(values, dtype=np.float64)
        if y.ndim != 2:
            raise ValueError(f"signal must be 2D, got shape {y.shape}")
        n, m = y.shape
        if mask is None and weights is None:
            # the common (unmasked, unweighted) path goes through the op
            # dispatcher; every backend of sat_moments keeps numpy's float64
            # summation order, so the images are bitwise the same on all
            from repro_torch import ops
            return PrefixStats.from_sat(
                np.asarray(ops.sat_moments(y), np.float64))
        w = np.ones_like(y) if weights is None else np.asarray(weights, np.float64)
        if mask is not None:
            w = w * np.asarray(mask, dtype=np.float64)

        def integral(a: np.ndarray) -> np.ndarray:
            out = np.zeros((n + 1, m + 1), dtype=np.float64)
            np.cumsum(a, axis=0, out=out[1:, 1:])
            np.cumsum(out[1:, 1:], axis=1, out=out[1:, 1:])
            return out

        return PrefixStats(integral(w), integral(w * y), integral(w * y * y))

    @staticmethod
    def from_sat(s: np.ndarray) -> "PrefixStats":
        """Wrap (3, n, m) inclusive integral images (one ``sat_moments``
        output) into the zero-padded (n+1, m+1) query layout."""
        n, m = s.shape[1], s.shape[2]
        ps = []
        for c in range(3):
            out = np.zeros((n + 1, m + 1), dtype=np.float64)
            out[1:, 1:] = s[c]
            ps.append(out)
        return PrefixStats(*ps)

    @staticmethod
    def build_moments(w0: np.ndarray, w1: np.ndarray, w2: np.ndarray,
                      mask: np.ndarray | None = None) -> "PrefixStats":
        """Build from per-cell moment rasters (weighted/sparse signals: cells
        carry (sum w, sum w*y, sum w*y^2) — the generalization used by the
        merge-reduce re-compression, where coreset points form the input)."""
        n, m = w0.shape
        mk = np.ones((n, m), np.float64) if mask is None else np.asarray(mask, np.float64)

        def integral(a: np.ndarray) -> np.ndarray:
            out = np.zeros((n + 1, m + 1), dtype=np.float64)
            np.cumsum(a * mk, axis=0, out=out[1:, 1:])
            np.cumsum(out[1:, 1:], axis=1, out=out[1:, 1:])
            return out

        return PrefixStats(integral(np.asarray(w0, np.float64)),
                           integral(np.asarray(w1, np.float64)),
                           integral(np.asarray(w2, np.float64)))

    @staticmethod
    def from_points(n: int, m: int, rows: np.ndarray, cols: np.ndarray,
                    labels: np.ndarray, weights: np.ndarray) -> "PrefixStats":
        """Raster weighted points into per-cell moments (used by merge-reduce
        re-compression, where coreset points act as a weighted sparse signal)."""
        w0 = np.zeros((n, m), np.float64)
        w1 = np.zeros((n, m), np.float64)
        w2 = np.zeros((n, m), np.float64)
        np.add.at(w0, (rows, cols), weights)
        np.add.at(w1, (rows, cols), weights * labels)
        np.add.at(w2, (rows, cols), weights * labels * labels)

        def integral(a):
            out = np.zeros((n + 1, m + 1), dtype=np.float64)
            np.cumsum(a, axis=0, out=out[1:, 1:])
            np.cumsum(out[1:, 1:], axis=1, out=out[1:, 1:])
            return out

        return PrefixStats(integral(w0), integral(w1), integral(w2))

    # ----------------------------------------------------------------- shapes
    @property
    def shape(self) -> tuple[int, int]:
        return self.p0.shape[0] - 1, self.p0.shape[1] - 1

    def transpose(self) -> "PrefixStats":
        """Stats of the transposed signal (O(nm) once; used by the
        SLICEPARTITION recursion on B^T)."""
        # Integral images do not transpose directly; rebuild from differences.
        def cell(a):
            return a[1:, 1:] - a[:-1, 1:] - a[1:, :-1] + a[:-1, :-1]

        def integral(a):
            n, m = a.shape
            out = np.zeros((n + 1, m + 1), dtype=np.float64)
            np.cumsum(a, axis=0, out=out[1:, 1:])
            np.cumsum(out[1:, 1:], axis=1, out=out[1:, 1:])
            return out

        return PrefixStats(integral(cell(self.p0).T), integral(cell(self.p1).T),
                           integral(cell(self.p2).T))

    # ---------------------------------------------------------------- queries
    def sums(self, r0, r1, c0, c1):
        """Moments over [r0:r1, c0:c1] (half-open). All args may be arrays."""
        r0 = np.asarray(r0, np.int64); r1 = np.asarray(r1, np.int64)
        c0 = np.asarray(c0, np.int64); c1 = np.asarray(c1, np.int64)

        def q(p):
            return p[r1, c1] - p[r0, c1] - p[r1, c0] + p[r0, c0]

        return q(self.p0), q(self.p1), q(self.p2)

    def count(self, r0, r1, c0, c1):
        return self.sums(r0, r1, c0, c1)[0]

    def mean(self, r0, r1, c0, c1):
        s0, s1, _ = self.sums(r0, r1, c0, c1)
        return np.where(s0 > 0, s1 / np.maximum(s0, 1e-300), 0.0)

    def opt1(self, r0, r1, c0, c1):
        """opt_1 of the sub-signal (Definition 2, k=1): min_c sum (y-c)^2."""
        return opt1_from_sums(*self.sums(r0, r1, c0, c1))

    def opt1_scalar(self, r0: int, r1: int, c0: int, c1: int) -> float:
        """Scalar fast path for the greedy searches (no ufunc machinery):
        identical math to :meth:`opt1` for single rectangles."""
        p0, p1, p2 = self.p0, self.p1, self.p2
        s0 = p0[r1, c1] - p0[r0, c1] - p0[r1, c0] + p0[r0, c0]
        if s0 <= 0.0:
            return 0.0
        s1 = p1[r1, c1] - p1[r0, c1] - p1[r1, c0] + p1[r0, c0]
        s2 = p2[r1, c1] - p2[r0, c1] - p2[r1, c0] + p2[r0, c0]
        v = s2 - (s1 * s1) / s0
        return v if v > 0.0 else 0.0

    def total_opt1(self) -> float:
        n, m = self.shape
        return float(self.opt1(0, n, 0, m))

    # ------------------------------------------------- monotone-window search
    def max_col_extent(self, r0: int, r1: int, c0: int, sigma: float) -> int:
        """Largest c_end in (c0, m] with opt1([r0:r1, c0:c_end]) <= sigma.

        opt1 is monotone non-decreasing in the window (adding cells cannot
        shrink the best-constant SSE: opt1(A) <= SSE_A(mu_{A u B}) <=
        opt1(A u B)), so a binary search over the prefix stats replaces the
        paper's linear scan (Algorithm 1, line 10) — identical output,
        O(log m) instead of O(m) per slice.

        Returns c0 if even the single first column exceeds sigma.
        """
        m = self.shape[1]
        if self.opt1_scalar(r0, r1, c0, c0 + 1) > sigma:
            return c0
        lo, hi = c0 + 1, m  # invariant: opt1(.., c0, lo) <= sigma
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.opt1_scalar(r0, r1, c0, mid) <= sigma:
                lo = mid
            else:
                hi = mid - 1
        return lo

    def max_row_extent(self, c0: int, c1: int, r0: int, sigma: float) -> int:
        """Row-direction twin of :meth:`max_col_extent` (for B^T recursion)."""
        n = self.shape[0]
        if self.opt1_scalar(r0, r0 + 1, c0, c1) > sigma:
            return r0
        lo, hi = r0 + 1, n
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self.opt1_scalar(r0, mid, c0, c1) <= sigma:
                lo = mid
            else:
                hi = mid - 1
        return lo
