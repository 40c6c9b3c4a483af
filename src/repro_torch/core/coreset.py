"""Algorithm 3 (SIGNAL-CORESET) — end-to-end (k, eps)-coreset construction.

Pipeline (Theorem 8):
  1. bi-criteria stage -> certified lower bound sigma <= opt_k(D);
  2. balanced partition with tolerance gamma^2 * sigma;
  3. per-block exact <=4-point Caratheodory representation, coordinates
     snapped to the block corners (Line 6 of Algorithm 3).

Two gamma regimes:
  * ``fidelity="practical"`` (default): gamma = eps — the regime the paper's
    own experiments run in (Section 5 uses eps to control the size/accuracy
    trade-off; the worst-case gamma = eps^2/(beta k) would force |C| >= N on
    real data, as the paper itself observes in "Coreset size").
  * ``fidelity="paper"``: gamma = eps^2 / (k * alpha_hat), the theory-faithful
    setting (with the adaptive alpha_hat = ell/sigma standing in for beta; see
    DESIGN.md §3) — used by the guarantee property tests.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time

import numpy as np

from .balanced import BalancedPartition, balanced_partition
from .bicriteria import BicriteriaResult, bicriteria
from .caratheodory import block_representatives
from .stats import PrefixStats

__all__ = ["SignalCoreset", "signal_coreset", "signal_coreset_to_size"]


@dataclasses.dataclass
class SignalCoreset:
    """The (C, u) data structure of Definition 3 (block-structured form).

    Each row i describes one block of the balanced partition:
      rects[i]   = (r0, r1, c0, c1)  half-open corner coordinates
      labels[i]  = 4 support labels (a subset of the block's labels)
      weights[i] = 4 non-negative weights, sum = block area
      moments[i] = exact (M0, M1, M2) of the block (redundant with
                   labels/weights — kept for O(1) non-intersected evaluation)
    """

    n: int
    m: int
    k: int
    eps: float
    rects: np.ndarray     # (B, 4) int64
    labels: np.ndarray    # (B, 4) float64
    weights: np.ndarray   # (B, 4) float64
    moments: np.ndarray   # (B, 3) float64
    sigma: float
    tolerance: float      # per-block opt1 cap used by the balanced partition
    max_slices: int       # band-width cap (1/gamma in the paper's terms)
    bicriteria: BicriteriaResult
    build_seconds: float
    certified: bool = True  # False when the heuristic sigma floor engaged

    # ------------------------------------------------------------------ views
    @property
    def num_blocks(self) -> int:
        return int(self.rects.shape[0])

    @property
    def size(self) -> int:
        """|C| — number of stored weighted points (4 per block)."""
        return 4 * self.num_blocks

    def compression_ratio(self) -> float:
        return self.size / float(self.n * self.m)

    def as_points(self, style: str = "mean"):
        """Flat weighted-point view for downstream solvers (paper §5):
        coordinates are the 4 corners of each block (Line 6).

        ``style="mean"`` (default for tree training): each corner carries the
        block's mean label with weight M0/4 — measured to beat both the raw
        Caratheodory labels and equal-size uniform sampling for forest
        training (regression trees consume block means; see EXPERIMENTS.md
        §Perf/quality).  First two moments are preserved exactly.
        ``style="caratheodory"``: the exact (M0, M1, M2) representation the
        Algorithm-5 query engine uses (paper-literal).

        Returns (X (P,2), y (P,), w (P,)) with zero-weight points dropped.
        """
        r0, r1, c0, c1 = (self.rects[:, i] for i in range(4))
        # corner order: (r0,c0), (r0,c1-1), (r1-1,c0), (r1-1,c1-1)
        rows = np.stack([r0, r0, r1 - 1, r1 - 1], axis=1)
        cols = np.stack([c0, c1 - 1, c0, c1 - 1], axis=1)
        X = np.stack([rows.ravel(), cols.ravel()], axis=1).astype(np.float64)
        if style == "mean":
            mu = self.moments[:, 1] / np.maximum(self.moments[:, 0], 1e-300)
            y = np.repeat(mu, 4)
            w = np.repeat(self.moments[:, 0] / 4.0, 4)
        else:
            y = self.labels.ravel()
            w = self.weights.ravel()
        keep = w > 0
        return X[keep], y[keep], w[keep]

    def total_mass(self) -> float:
        return float(self.weights.sum())

    @property
    def nbytes(self) -> int:
        """Payload bytes of the stored arrays (cache-accounting size)."""
        return int(self.rects.nbytes + self.labels.nbytes
                   + self.weights.nbytes + self.moments.nbytes)

    def fingerprint(self) -> str:
        """Stable content hash of the block geometry + exact moments.

        Two coresets with equal fingerprints answer every Algorithm-5 query
        identically (the loss only reads rects/labels/weights/moments), so
        this is a well-defined cache/ETag identity for the serving layer.
        """
        h = hashlib.blake2b(digest_size=16)
        h.update(np.int64([self.n, self.m, self.k, self.num_blocks]).tobytes())
        h.update(np.float64([self.eps]).tobytes())
        h.update(np.ascontiguousarray(self.rects, np.int64).tobytes())
        h.update(np.ascontiguousarray(self.moments, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.labels, np.float64).tobytes())
        h.update(np.ascontiguousarray(self.weights, np.float64).tobytes())
        return h.hexdigest()

    # ------------------------------------------------------------ carry-over
    _ARRAYS = ("rects", "labels", "weights", "moments")
    _SCALARS = ("n", "m", "k", "eps", "sigma", "tolerance", "max_slices",
                "build_seconds", "certified")

    def to_arrays(self) -> dict:
        """Plain numpy arrays and scalars of every field (the bicriteria
        result as a dict): the form in which a coreset crosses between this
        package and the reference one."""
        d = {f: getattr(self, f) for f in self._SCALARS}
        d.update({f: np.array(getattr(self, f)) for f in self._ARRAYS})
        d["bicriteria"] = dataclasses.asdict(self.bicriteria)
        return d

    @classmethod
    def from_arrays(cls, d: dict) -> "SignalCoreset":
        """Inverse of :meth:`to_arrays`; ``d`` may equally be built from a
        reference ``SignalCoreset``'s fields."""
        bic = d["bicriteria"]
        if not isinstance(bic, BicriteriaResult):
            bic = BicriteriaResult(**dict(bic))
        return cls(rects=np.asarray(d["rects"], np.int64),
                   labels=np.asarray(d["labels"], np.float64),
                   weights=np.asarray(d["weights"], np.float64),
                   moments=np.asarray(d["moments"], np.float64),
                   n=int(d["n"]), m=int(d["m"]), k=int(d["k"]),
                   eps=float(d["eps"]), sigma=float(d["sigma"]),
                   tolerance=float(d["tolerance"]),
                   max_slices=int(d["max_slices"]),
                   build_seconds=float(d["build_seconds"]),
                   certified=bool(d["certified"]), bicriteria=bic)

    def __repr__(self) -> str:
        return (f"SignalCoreset(n={self.n}, m={self.m}, k={self.k}, "
                f"eps={self.eps:g}, size={self.size}, "
                f"ratio={self.compression_ratio():.3g}, "
                f"certified={self.certified}, fp={self.fingerprint()[:10]})")


def resolve_partition_params(sigma: float, k: int, eps: float, fidelity: str,
                             alpha_hat: float) -> tuple[float, int]:
    """(tolerance, max_slices) per fidelity mode.

    paper:      gamma = eps^2/(k*alpha_hat); tolerance = gamma^2 sigma,
                max_slices = 1/gamma  (Lemma 7's parameterization).
    practical:  tolerance = eps^2 sigma / k and max_slices = 2 sqrt(k)/eps
                (gamma_eff = eps/sqrt(k)).  A k-leaf tree intersects
                I = O(k) blocks, so its Lemma-14 error budget is
                I * tolerance * (1 + 1/eps) ~ eps * sigma * (I/k) <~
                eps * opt_k — i.e. the relative error stays <= O(eps)
                uniformly in k.  Calibrated on the benchmark suite (see
                EXPERIMENTS.md §Guarantee).
    """
    if fidelity == "paper":
        gamma = eps * eps / (k * max(alpha_hat, 1.0))
        gamma = float(np.clip(gamma, 1e-6, 1.0))
        return gamma * gamma * sigma, max(int(1.0 / gamma), 1)
    tol = eps * eps * sigma / max(k, 1)
    max_slices = max(16, int(2.0 * np.sqrt(k) / eps))
    return float(tol), int(max_slices)


def signal_coreset(values: np.ndarray, k: int, eps: float, *,
                   fidelity: str = "practical", nu: float = 8.0,
                   gamma_1d: float = 4.0, sigma_mode: str = "auto",
                   mask: np.ndarray | None = None,
                   tolerance_override: float | None = None,
                   max_slices_override: int | None = None,
                   _sigma_hint=None,
                   _stats: PrefixStats | None = None) -> SignalCoreset:
    """SIGNAL-CORESET(D, k, eps); see Theorem 8.

    ``mask`` (optional) marks observed cells; unobserved cells carry no mass
    (the §5 missing-value protocol compresses only the available data).

    ``_stats`` (internal) supplies prebuilt integral images of ``values``, so
    repeated (k, eps) builds of one signal skip the O(N) prefix-sum rebuild.

    ``sigma_mode``:
      * "auto" (default): sigma = max(certified bi-criteria bound,
        greedy-tree-loss / 4).  The certified bounds vanish when
        k >~ min(n, m)/4 (the paper's own experimental regime: its worst-case
        machinery needs ~64 k^2 cells); the greedy k-tree loss is an upper
        bound on opt_k, so loss/4 is a heuristic lower bound — exactly the
        practical stance of the paper's §5 (empirical eps).  ``certified``
        on the result records whether the heuristic kicked in.
      * "certified": bi-criteria bounds only (used by the guarantee tests).
    """
    if not (0.0 < eps < 1.0):
        raise ValueError("eps must be in (0,1)")
    t0 = time.perf_counter()
    y = np.asarray(values, dtype=np.float64)
    n, m = y.shape
    if mask is not None:
        from .streaming import weighted_signal_coreset
        rows, cols = np.nonzero(mask)
        return weighted_signal_coreset(
            n, m, rows, cols, y[mask], np.ones(rows.size), k, eps,
            fidelity=fidelity, tolerance_override=tolerance_override,
            max_slices_override=max_slices_override, _sigma_hint=_sigma_hint)

    if _stats is not None and _stats.shape != y.shape:
        raise ValueError(f"_stats shape {_stats.shape} != signal {y.shape}")
    ps_full = PrefixStats.build(y) if _stats is None else _stats
    if _sigma_hint is not None:       # size-bisection path: sigma known
        sigma, certified, bic = _sigma_hint
    else:
        bic = bicriteria(y, k, nu=nu, gamma_1d=gamma_1d, fidelity=fidelity)
        sigma = bic.sigma
        certified = True
        if sigma_mode == "auto" and fidelity != "paper":
            from .segmentation import greedy_tree
            from .fitting_loss import true_loss
            g = greedy_tree(ps_full, k)
            # /6 calibrated on the worst family (smooth fields): max rel err
            # stays ~eps/2 at eps=0.1 (see EXPERIMENTS.md §Guarantee)
            heur = true_loss(y, g.rects, g.labels, ps=ps_full) / 6.0
            if heur > sigma:
                sigma, certified = heur, False

    tol, max_slices = resolve_partition_params(sigma, k, eps, fidelity, bic.alpha_hat)
    if tolerance_override is not None:
        tol = float(tolerance_override)
    if max_slices_override is not None:
        max_slices = int(max_slices_override)

    part: BalancedPartition = balanced_partition(ps_full, tol, max_slices)

    block_id = part.block_id_raster(n, m)
    labels, weights, moments = block_representatives(
        y.ravel(), block_id.ravel(), part.num_blocks)

    return SignalCoreset(
        n=n, m=m, k=k, eps=eps,
        rects=part.rects, labels=labels, weights=weights, moments=moments,
        sigma=float(sigma), tolerance=tol, max_slices=max_slices,
        bicriteria=bic, build_seconds=time.perf_counter() - t0,
        certified=certified,
    )


def signal_coreset_to_size(values: np.ndarray, k: int, target_frac: float,
                           *, mask: np.ndarray | None = None,
                           iters: int = 7, **kw) -> SignalCoreset:
    """Build a coreset of ~``target_frac`` of the input size by bisecting the
    block tolerance (the paper's Fig-4 experiments sweep compression size
    directly; eps is the dual knob).  Monotone: larger tolerance -> coarser
    partition -> fewer points.  The bi-criteria stage runs once; bisection
    re-runs only the balanced partition + block compression.
    """
    y = np.asarray(values, dtype=np.float64)
    base = signal_coreset(y, k, 0.5, mask=mask, **kw)
    if base.compression_ratio() <= target_frac:
        return base

    def rebuild(tol):
        return signal_coreset(y, k, 0.5, mask=mask, tolerance_override=tol,
                              max_slices_override=base.max_slices,
                              sigma_mode="skip",
                              _sigma_hint=(base.sigma, base.certified,
                                           base.bicriteria), **kw)

    lo = hi = base.tolerance + 1e-30
    cs = base
    while cs.compression_ratio() > target_frac and hi < 1e12 * lo:
        hi *= 8.0
        cs = rebuild(hi)
    best = cs
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        cs = rebuild(mid)
        if cs.compression_ratio() > target_frac:
            lo = mid
        else:
            hi = mid
            best = cs
            if cs.compression_ratio() > 0.75 * target_frac:
                break              # close enough from below
    return best
