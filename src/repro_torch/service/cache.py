"""Byte-budgeted LRU coreset cache with dominance reuse.

The paper's headline guarantee is *uniform over queries*: one (k, eps)-
coreset answers ell(D, s) for EVERY tree s of at most k leaves within
1 +/- eps.  Turned into a cache rule: a cached coreset built at (k', eps')
with  k' >= k  and  eps'_effective <= eps  is a valid answer source for a
(k, eps) request on the same signal version — no rebuild needed.  This is
what makes a coreset server amortize: the first tuning sweep pays O(Nk),
every later request (smaller trees, looser tolerances) is a cache hit.

``eps_eff`` is the entry's honest guarantee: equal to the requested eps for
one-shot and sharded-compose builds (composition is exact, streaming.py),
and the composed (1+eps)^(levels+1) - 1 bound for merge-reduce streaming
builds — dominance compares against eps_eff, never the nominal eps, so a
recompressed streamed coreset is not claimed tighter than it is.

Entries are keyed by (signal, version, k, eps); ``version`` is a content
hash maintained by the engine (a new ingested band bumps it), so stale
coresets can never serve a mutated signal.

Each entry also records ``row_spans`` — the merged half-open row intervals
its coreset's blocks cover (derived from ``coreset.rects`` at insert).
They are the provenance metadata of the delta-ingest **re-anchoring** fast
path: a delta whose row window is disjoint from every span cannot change
any block the entry stores, so the engine may re-key the entry to the
successor version (after splicing in the new rows' leaf blocks) instead of
rebuilding — an O(entries x spans) interval intersection, no coreset math.
``invalidate_signal(keep_version=...)`` returns the entries it dropped so
the engine can inspect exactly those re-anchor candidates, and
``stats()`` exposes ``reanchored`` / ``reanchor_candidates`` counters.

Eviction is cost-aware (GDSF — greedy-dual size-frequency) over a byte
budget: an entry's priority is

    priority = clock + (1 + hits) * max(build_seconds, floor) / nbytes

and overflow evicts the minimum-priority entry.  ``build_seconds / nbytes``
is the rebuild cost per cached byte (an expensive O(Nk) build that
compressed well is the most valuable thing in the cache), ``hits`` folds in
frequency, and the ``clock`` — advanced to each victim's priority — ages
out entries that stop being touched, so a once-hot expensive coreset still
drains away under pressure.  Priorities refresh on every hit and insert.
"""
from __future__ import annotations

import collections
import dataclasses
import threading

import numpy as np

from repro_torch.core.coreset import SignalCoreset

from .metrics import ServiceMetrics

__all__ = ["CacheEntry", "DominanceCache", "block_row_spans",
           "spans_intersect"]


def _eps_key(eps: float) -> float:
    return round(float(eps), 6)


def block_row_spans(rects: np.ndarray) -> np.ndarray:
    """Merged, sorted half-open row intervals covered by coreset blocks.

    ``rects[:, :2]`` are per-block ``[row0, row1)`` windows; adjacent or
    overlapping windows merge, so a composed coreset over bands
    ``[0,32) [32,64)`` collapses to one span ``[0,64)``.  The result is the
    provenance record a :class:`CacheEntry` carries: any delta window
    disjoint from every span provably cannot alter the entry's blocks.
    """
    r = np.asarray(rects).reshape(-1, 4)[:, :2].astype(np.int64)
    if r.shape[0] == 0:
        return np.empty((0, 2), np.int64)
    r = r[np.argsort(r[:, 0], kind="stable")]
    spans = [[int(r[0, 0]), int(r[0, 1])]]
    for row0, row1 in r[1:]:
        if int(row0) <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], int(row1))
        else:
            spans.append([int(row0), int(row1)])
    return np.asarray(spans, np.int64)


def spans_intersect(spans: np.ndarray | None, row0: int, row1: int) -> bool:
    """True when ``[row0, row1)`` overlaps any span.  ``None`` (unknown
    provenance — e.g. an entry inserted before span tracking) is treated as
    intersecting: re-anchoring must never be optimistic."""
    if spans is None:
        return True
    spans = np.asarray(spans).reshape(-1, 2)
    if spans.shape[0] == 0 or row1 <= row0:
        return False
    return bool(np.any((spans[:, 0] < row1) & (int(row0) < spans[:, 1])))


@dataclasses.dataclass
class CacheEntry:
    signal: str
    version: str
    k: int
    eps: float            # requested eps (exact-match key component)
    eps_eff: float        # honest guarantee after composition layers
    coreset: SignalCoreset
    nbytes: int
    fingerprint: str
    hits: int = 0
    build_seconds: float = 0.0   # construction cost, recorded at insert;
                                 # weighed against nbytes + recency by the
                                 # GDSF eviction policy
    priority: float = 0.0        # GDSF score, maintained by DominanceCache
    row_spans: np.ndarray | None = None   # merged [row0, row1) block
                                          # coverage; filled from
                                          # coreset.rects at put() if unset

    @property
    def key(self) -> tuple:
        return (self.signal, self.version, self.k, _eps_key(self.eps))


class DominanceCache:
    """Byte-budgeted cache; lookup tries exact key, then the dominance rule;
    overflow evicts by GDSF priority (cost-aware, not pure LRU)."""

    # floor for build_seconds in the priority: manually-constructed entries
    # (tests, replicated inserts) with cost 0 still order by size/recency
    MIN_COST = 1e-6

    def __init__(self, byte_budget: int = 256 << 20,
                 metrics: ServiceMetrics | None = None):
        self.byte_budget = int(byte_budget)
        self.metrics = metrics or ServiceMetrics()
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict[tuple, CacheEntry] = collections.OrderedDict()
        # signal -> version -> keys: dominance scans and invalidations touch
        # one signal's entries, not the whole cache (which may span millions
        # of signals)
        self._by_signal: dict[str, dict[str, set[tuple]]] = {}
        self._bytes = 0
        self._clock = 0.0   # GDSF aging clock; advances to victim priority
        self._reanchored = 0           # entries re-keyed to a new version
        self._reanchor_candidates = 0  # entries dropped by a keep_version
                                       # invalidation (the population the
                                       # re-anchor fast path competes for)

    def _boost(self, e: CacheEntry) -> None:
        """Refresh an entry's GDSF priority (call under the lock, on every
        insert and hit)."""
        cost = max(float(e.build_seconds), self.MIN_COST)
        e.priority = self._clock + (1.0 + e.hits) * cost / max(e.nbytes, 1)

    # ---------------------------------------------------------------- lookup
    def lookup(self, signal: str, version: str, k: int, eps: float, *,
               record: bool = True) -> tuple[CacheEntry | None, str | None]:
        """Returns (entry, kind) with kind in {"exact", "dominated", None}.

        ``record=False`` skips hit/miss counters (internal re-checks that
        would otherwise double-count the client-facing hit rate).
        """
        key = (signal, version, int(k), _eps_key(eps))
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
                e.hits += 1
                self._boost(e)
                if record:
                    self.metrics.inc("cache_hit_exact")
                return e, "exact"
            # dominance scan: any (k', eps'_eff) with k' >= k, eps'_eff <= eps.
            # Among dominating entries prefer the smallest coreset — queries
            # against it are cheapest and the guarantee is already satisfied.
            best = None
            for ek in self._by_signal.get(signal, {}).get(version, ()):
                e = self._entries[ek]
                if e.k >= k and e.eps_eff <= eps + 1e-12:
                    if best is None or e.nbytes < best.nbytes:
                        best = e
            if best is not None:
                self._entries.move_to_end(best.key)
                best.hits += 1
                self._boost(best)
                if record:
                    self.metrics.inc("cache_hit_dominated")
                return best, "dominated"
            if record:
                self.metrics.inc("cache_miss")
            return None, None

    # ------------------------------------------------------------------- put
    def _drop(self, key: tuple) -> CacheEntry | None:
        e = self._entries.pop(key, None)
        if e is not None:
            self._bytes -= e.nbytes
            versions = self._by_signal.get(e.signal)
            if versions is not None:
                keys = versions.get(e.version)
                if keys is not None:
                    keys.discard(key)
                    if not keys:
                        del versions[e.version]
                if not versions:
                    del self._by_signal[e.signal]
        return e

    def put(self, entry: CacheEntry) -> None:
        if entry.row_spans is None:
            entry.row_spans = block_row_spans(entry.coreset.rects)
        with self._lock:
            self._drop(entry.key)
            self._entries[entry.key] = entry
            self._by_signal.setdefault(entry.signal, {}).setdefault(
                entry.version, set()).add(entry.key)
            self._bytes += entry.nbytes
            self._boost(entry)
            self.metrics.inc("cache_insertions")
            while self._bytes > self.byte_budget and len(self._entries) > 1:
                # GDSF victim: minimum priority.  O(entries) scan, but only
                # on overflow — lookups stay O(1)+dominance.  The victim may
                # be the entry just inserted (a cheap build must not displace
                # expensive-to-rebuild ones); callers already hold the built
                # coreset, so serving is unaffected.
                victim = min(self._entries.values(), key=lambda e: e.priority)
                self._clock = max(self._clock, victim.priority)
                self._drop(victim.key)
                self.metrics.inc("cache_evictions")

    def specs_for(self, signal: str, version: str) -> list[tuple[int, float]]:
        """(k, eps) of every live entry for one signal version — the delta
        ingest path re-caches exactly these under the successor version."""
        with self._lock:
            keys = self._by_signal.get(signal, {}).get(version, ())
            return sorted({(self._entries[k].k, self._entries[k].eps)
                           for k in keys})

    def take(self, signal: str, version: str, k: int,
             eps: float) -> CacheEntry | None:
        """Pop an entry by exact key WITHOUT touching hit/miss counters —
        the re-anchor path removes the stale-version entry, splices the new
        rows in, and re-puts it under the successor version."""
        with self._lock:
            return self._drop((signal, version, int(k), _eps_key(eps)))

    def mark_reanchored(self, n: int = 1) -> None:
        """Record ``n`` entries re-keyed to a new version in metadata time
        (no rebuild).  Shows up as ``cache_reanchored`` in the metrics
        snapshot and ``stats()["reanchored"]``."""
        with self._lock:
            self._reanchored += n
        self.metrics.inc("cache_reanchored", n)

    def invalidate_signal(self, signal: str,
                          keep_version: str | None = None) -> list[CacheEntry]:
        """Drop entries of stale versions (the version key already prevents
        wrong serving; this just frees the bytes eagerly).

        Returns the dropped entries — with ``keep_version`` given these are
        exactly the re-anchor candidates the fast path did NOT claim (their
        blocks intersected the delta, or the delta shape was ineligible),
        so callers can see what fell back to invalidate+rebuild.  Also
        bumps ``reanchor_candidates`` in that case.
        """
        with self._lock:
            dead = [k for ver, keys in self._by_signal.get(signal, {}).items()
                    if ver != keep_version for k in keys]
            dropped = [e for e in (self._drop(k) for k in dead)
                       if e is not None]
            if dropped and keep_version is not None:
                self._reanchor_candidates += len(dropped)
        if dropped:
            self.metrics.inc("cache_invalidations", len(dropped))
            if keep_version is not None:
                self.metrics.inc("cache_reanchor_candidates", len(dropped))
        return dropped

    # ----------------------------------------------------------------- stats
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": self._bytes,
                "byte_budget": self.byte_budget,
                "eviction_policy": "gdsf",
                "clock": self._clock,
                "reanchored": self._reanchored,
                "reanchor_candidates": self._reanchor_candidates,
                "keys": [{"signal": e.signal, "k": e.k, "eps": e.eps,
                          "eps_eff": e.eps_eff, "blocks": e.coreset.num_blocks,
                          "nbytes": e.nbytes, "hits": e.hits,
                          "build_seconds": e.build_seconds,
                          "priority": e.priority}
                         for e in self._entries.values()],
            }
