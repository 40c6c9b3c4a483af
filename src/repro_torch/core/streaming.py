"""Streaming / merge-reduce coresets (paper §1.1 "merge and reduce").

Coresets of disjoint sub-signals *compose*: if (C_i, u_i) is a (k, eps)-
coreset of row-band D_i, the union is a (k, eps)-coreset of D = U D_i — a
k-segmentation restricted to a band is still a <=k-segmentation, and the
per-band multiplicative errors add up to eps * ell(D, s).  ``compose`` is
therefore exact concatenation (with row offsets).

``recompress`` runs the full pipeline again over the *weighted* union
(coreset points rastered to per-cell moments), giving the classic
merge-reduce tree: eps grows additively per level, size stays bounded.  It
is a dispatched op (``repro_torch.ops.streaming_compress``): the integral
images of the moment rasters — the compute-heavy stage — run on the numpy
f64 oracle, the plain torch version, or the sat2d CUDA kernel (all three
bitwise equal in float64), and MANY buckets recompress in one batched
dispatch.

``weighted_signal_coreset`` runs SIGNAL-CORESET over weighted points on the
grid; ``signal_coreset(mask=...)`` goes through it, so held-out cells carry
no mass (the §5 missing-value protocol).

``StreamingBuilder`` maintains the log-depth bucket structure for a stream
of row bands and supports *band replacement* (dynamic updates, challenge
(iv) of the paper's introduction): the per-band leaf coresets are retained,
a replaced band rebuilds only its leaf (O(band)) and marks the one bucket
containing it dirty; ``flush_dirty`` replays just those buckets' merge
cascades, recompressing all buckets of a tree level through a single
``streaming_compress`` dispatch.  Memory is O(#bands * coreset size) — the
tiny leaves are the price of O(band) updates instead of O(N) rebuilds.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from .balanced import balanced_partition
from .bicriteria import bicriteria
from .caratheodory import block_representatives
from .coreset import SignalCoreset, resolve_partition_params, signal_coreset
from .segmentation import greedy_tree
from .stats import PrefixStats

__all__ = ["compose", "recompress", "weighted_signal_coreset", "StreamingBuilder"]


def compose(coresets: list[SignalCoreset], row_offsets: list[int], n_total: int,
            ) -> SignalCoreset:
    """Union of per-band coresets -> coreset of the stacked signal."""
    if not coresets:
        raise ValueError("need at least one coreset")
    m = coresets[0].m
    rects = []
    for cs, off in zip(coresets, row_offsets):
        r = cs.rects.copy()
        r[:, 0] += off
        r[:, 1] += off
        rects.append(r)
    return SignalCoreset(
        n=n_total, m=m, k=coresets[0].k,
        eps=max(c.eps for c in coresets),
        rects=np.concatenate(rects, axis=0),
        labels=np.concatenate([c.labels for c in coresets], axis=0),
        weights=np.concatenate([c.weights for c in coresets], axis=0),
        moments=np.concatenate([c.moments for c in coresets], axis=0),
        sigma=min(c.sigma for c in coresets),
        tolerance=min(c.tolerance for c in coresets),
        max_slices=max(c.max_slices for c in coresets),
        bicriteria=coresets[0].bicriteria,
        build_seconds=sum(c.build_seconds for c in coresets),
        certified=all(c.certified for c in coresets),
    )


# ------------------------------------------------- weighted re-compression
@dataclasses.dataclass
class _Prep:
    """Rasterized point set of one coreset awaiting re-compression: the
    host-side half of ``streaming_compress`` shared by every backend (the
    backends only differ in how ``rasters`` become integral images)."""

    rows: np.ndarray
    cols: np.ndarray
    labels: np.ndarray
    weights: np.ndarray
    rasters: tuple  # (w0, w1, w2) per-cell (sum w, sum w*y, sum w*y^2)


def _raster_moments(n: int, m: int, rows, cols, labels, weights):
    w0 = np.zeros((n, m), np.float64)
    w1 = np.zeros((n, m), np.float64)
    w2 = np.zeros((n, m), np.float64)
    np.add.at(w0, (rows, cols), weights)
    np.add.at(w1, (rows, cols), weights * labels)
    np.add.at(w2, (rows, cols), weights * labels * labels)
    return w0, w1, w2


def _recompress_prep(cs: SignalCoreset) -> _Prep:
    # exact-moment (Caratheodory) labels: re-compression must preserve M2
    X, y, w = cs.as_points(style="caratheodory")
    rows = X[:, 0].astype(np.int64)
    cols = X[:, 1].astype(np.int64)
    return _Prep(rows, cols, y, w,
                 _raster_moments(cs.n, cs.m, rows, cols, y, w))


def _recompress_finish(cs: SignalCoreset, prep: _Prep, ps: PrefixStats,
                       k: int | None, eps: float | None) -> SignalCoreset:
    return weighted_signal_coreset(
        cs.n, cs.m, prep.rows, prep.cols, prep.labels, prep.weights,
        k or cs.k, eps or cs.eps, _moments=prep.rasters, _stats=ps)


def weighted_signal_coreset(n: int, m: int, rows: np.ndarray, cols: np.ndarray,
                            labels: np.ndarray, weights: np.ndarray, k: int,
                            eps: float, *, fidelity: str = "practical",
                            tolerance_override: float | None = None,
                            max_slices_override: int | None = None,
                            _sigma_hint=None, _moments=None,
                            _stats: PrefixStats | None = None) -> SignalCoreset:
    """SIGNAL-CORESET over a weighted sparse signal (points on the grid).

    Used by merge-reduce: the input points are themselves coreset points.
    All pipeline stages only consume (sum w, sum w y, sum w y^2) rasters, so
    the generalization is direct.  ``_moments``/``_stats`` (the rasters and
    their integral images) let the ``streaming_compress`` backends supply
    precomputed/batched stats instead of rebuilding them here.
    """
    t0 = time.perf_counter()
    rows = np.asarray(rows, np.int64); cols = np.asarray(cols, np.int64)
    labels = np.asarray(labels, np.float64); weights = np.asarray(weights, np.float64)
    if _moments is None:
        w0, w1, w2 = _raster_moments(n, m, rows, cols, labels, weights)
    else:
        w0, w1, w2 = _moments

    ps = PrefixStats.build_moments(w0, w1, w2) if _stats is None else _stats
    if _sigma_hint is not None:       # size-bisection path: sigma known
        sigma, certified, bic = _sigma_hint
    else:
        bic = bicriteria(None, k, fidelity=fidelity, moments=(w0, w1, w2))
        sigma = bic.sigma
        certified = True
        if fidelity != "paper":
            # heuristic sigma floor (see signal_coreset): greedy k-tree loss/4
            g = greedy_tree(ps, k)
            s0, s1, s2 = ps.sums(g.rects[:, 0], g.rects[:, 1], g.rects[:, 2], g.rects[:, 3])
            heur = float(np.maximum(s2 - s1 * s1 / np.maximum(s0, 1e-300), 0.0).sum()) / 6.0
            if heur > sigma:
                sigma, certified = heur, False
    tol, max_slices = resolve_partition_params(sigma, k, eps, fidelity, bic.alpha_hat)
    if tolerance_override is not None:
        tol = float(tolerance_override)
    if max_slices_override is not None:
        max_slices = int(max_slices_override)

    part = balanced_partition(ps, tol, max_slices)
    raster = part.block_id_raster(n, m)
    bid_pts = raster[rows, cols]
    lab4, w4, mom = block_representatives(labels, bid_pts, part.num_blocks,
                                          w_flat=weights)
    keep = mom[:, 0] > 0  # drop mass-less blocks (all-empty regions)
    return SignalCoreset(
        n=n, m=m, k=k, eps=eps,
        rects=part.rects[keep], labels=lab4[keep], weights=w4[keep],
        moments=mom[keep], sigma=float(sigma), tolerance=tol,
        max_slices=max_slices, bicriteria=bic,
        build_seconds=time.perf_counter() - t0, certified=certified,
    )


def recompress(cs: SignalCoreset, k: int | None = None, eps: float | None = None,
               *, backend: str | None = None) -> SignalCoreset:
    """Reduce step of merge-reduce: coreset-of-the-coreset (dispatched)."""
    from repro_torch import ops
    return ops.streaming_compress([cs], k, eps, backend=backend)[0]


# --------------------------------------------------------- streaming builder
@dataclasses.dataclass
class _Leaf:
    """One ingested band: its coreset plus absolute row placement."""

    cs: SignalCoreset
    row0: int
    rows: int

    @property
    def item(self) -> tuple:
        return (self.cs, self.row0, self.rows)


@dataclasses.dataclass
class _Bucket:
    """A binary-counter bucket: the merged coreset of ``count`` (= 2^level)
    contiguous bands starting at band index ``start``.  ``dirty`` marks a
    bucket whose constituent leaf changed and whose cascade must replay."""

    level: int
    start: int
    count: int
    item: tuple      # (coreset, absolute row0, rows)
    dirty: bool = False


@dataclasses.dataclass
class StreamingBuilder:
    """Merge-reduce over a stream of row bands with dynamic band updates.

    Buckets hold coresets of 2^level bands; inserting a band cascades merges
    (compose + recompress) like binary addition, so each band is touched
    O(log #bands) times.  The per-band *leaf* coresets are retained so that
    ``replace_band`` costs O(band): the replaced leaf rebuilds, the single
    bucket containing it is marked dirty, and ``flush_dirty`` (called by
    ``result``) replays only the dirty buckets' merge cascades — every
    recompression of a cascade level runs in ONE batched
    ``repro_torch.ops.streaming_compress`` dispatch.
    """

    m: int
    k: int
    eps: float
    recompress_levels: bool = True
    _leaves: list = dataclasses.field(default_factory=list)
    _buckets: dict[int, _Bucket] = dataclasses.field(default_factory=dict)
    _next_row: int = 0
    buckets_recompressed_total: int = 0   # lifetime flush_dirty recompressions

    def _merge(self, a: tuple, b: tuple, *, recompress_now: bool = True) -> tuple:
        lo = min(a[1], b[1])
        total = a[2] + b[2]
        merged = compose([a[0], b[0]], [a[1] - lo, b[1] - lo], n_total=total)
        if self.recompress_levels and recompress_now:
            merged = recompress(merged)
        return (merged, lo, total)

    def insert_band(self, band_values: np.ndarray, *, _leaf_cs=None) -> None:
        # settle pending replacements first: the cascade below merges bucket
        # items, and merging a dirty bucket's stale item would bake the old
        # leaf into a clean higher-level bucket no flush could ever repair
        self.flush_dirty()
        band_values = np.asarray(band_values, np.float64)
        # _leaf_cs (internal): prebuilt signal_coreset(band, k, eps) of this
        # band — the serving engine's delta fast path builds the leaf once
        # per (k, eps) spec and shares it between the cache splice and every
        # live builder, instead of rebuilding it here per consumer
        cs = (_leaf_cs if _leaf_cs is not None
              else signal_coreset(band_values, self.k, self.eps))
        leaf = _Leaf(cs, self._next_row, band_values.shape[0])
        self._leaves.append(leaf)
        self._next_row += leaf.rows
        item = leaf.item
        level, start, count = 0, len(self._leaves) - 1, 1
        while level in self._buckets:
            other = self._buckets.pop(level)
            item = self._merge(other.item, item)
            start, count = other.start, other.count + count
            level += 1
        self._buckets[level] = _Bucket(level, start, count, item)

    # ------------------------------------------------------- dynamic updates
    @property
    def num_bands(self) -> int:
        return len(self._leaves)

    def band_range(self, index: int) -> tuple[int, int]:
        """(row0, rows) of ingested band ``index``."""
        leaf = self._leaves[index]
        return leaf.row0, leaf.rows

    def _bucket_of(self, index: int) -> _Bucket:
        for bucket in self._buckets.values():
            if bucket.start <= index < bucket.start + bucket.count:
                return bucket
        raise ValueError(f"band index {index} not covered by any bucket")

    def replace_band(self, index: int, band_values: np.ndarray, *,
                     _leaf_cs=None) -> None:
        """Replace ingested band ``index`` with same-shape values: O(band)
        leaf rebuild now, a dirty mark on the one bucket containing it;
        recompression is deferred to ``flush_dirty`` so a burst of updates
        amortizes into one batched dispatch.

        ``_leaf_cs`` (internal) injects a prebuilt ``signal_coreset(band,
        k, eps)`` of the new content — the serving engine fans a delta
        burst's leaf builds out over its scheduler pool and hands each
        builder its finished leaf, so N replaced bands cost one batched
        submission instead of N sequential builds here.
        """
        band_values = np.asarray(band_values, np.float64)
        leaf = self._leaves[index]
        if band_values.shape != (leaf.rows, self.m):
            raise ValueError(
                f"replacement band must have shape ({leaf.rows}, {self.m}), "
                f"got {band_values.shape}")
        leaf.cs = (_leaf_cs if _leaf_cs is not None
                   else signal_coreset(band_values, self.k, self.eps))
        bucket = self._bucket_of(index)
        if bucket.count == 1:
            bucket.item = leaf.item    # a leaf bucket IS its band coreset
            bucket.dirty = False
        else:
            bucket.dirty = True

    @property
    def dirty_buckets(self) -> int:
        return sum(1 for b in self._buckets.values() if b.dirty)

    def flush_dirty(self) -> int:
        """Replay the merge cascade of every dirty bucket; returns the
        number of bucket recompressions performed.  The replay is level-
        synchronized across buckets: all compositions of one cascade level
        recompress in a single ``streaming_compress`` dispatch, and the
        pairwise left-to-right tree is exactly the shape the insert cascade
        built, so a flushed bucket is bitwise identical to a from-scratch
        rebuild of the same bands.
        """
        dirty = [b for b in self._buckets.values() if b.dirty]
        if not dirty:
            return 0
        pend = {id(b): [leaf.item
                        for leaf in self._leaves[b.start:b.start + b.count]]
                for b in dirty}
        done = 0
        while any(len(items) > 1 for items in pend.values()):
            staged = []   # (bucket id, position, composed item)
            for key, items in pend.items():
                if len(items) == 1:
                    continue
                merged_level = []
                for i in range(0, len(items), 2):   # counts are powers of 2
                    merged_level.append(
                        self._merge(items[i], items[i + 1],
                                    recompress_now=False))
                    staged.append((key, len(merged_level) - 1,
                                   merged_level[-1]))
                pend[key] = merged_level
            if self.recompress_levels and staged:
                from repro_torch import ops
                rcs = ops.streaming_compress([it[0] for _, _, it in staged])
                done += len(staged)
                for (key, pos, item), cs in zip(staged, rcs):
                    pend[key][pos] = (cs, item[1], item[2])
        for b in dirty:
            b.item = pend[id(b)][0]
            b.dirty = False
        self.buckets_recompressed_total += done
        return done

    # --------------------------------------------------------------- results
    @property
    def max_level(self) -> int:
        """Deepest occupied bucket = number of recompress layers any band may
        have passed through (eps composes as (1+eps)^(max_level+1) - 1)."""
        return max(self._buckets, default=0)

    @property
    def rows_seen(self) -> int:
        return self._next_row

    def result(self) -> SignalCoreset:
        self.flush_dirty()
        items = sorted((b.item for b in self._buckets.values()),
                       key=lambda t: t[1])
        if not items:
            raise ValueError("empty stream")
        return compose([it[0] for it in items], [it[1] for it in items],
                       n_total=self._next_row)
