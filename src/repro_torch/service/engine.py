"""CoresetEngine — coreset-as-a-service over named signals.

The serving model (the paper's §5 use-case):

  * clients **register** signals (dense matrices) or **ingest** row bands
    into an append-only stream;
  * (k, eps)-coresets are built **lazily** on first demand, through the
    batching ``BuildScheduler`` — dense signals fan row bands out via the
    ``core.sharded`` path, streamed signals route through the merge-reduce
    ``StreamingBuilder``;
  * **tree-loss / forest-fit / compression** queries are answered from the
    ``DominanceCache``: any cached (k', eps') coreset with k' >= k and
    eps'_eff <= eps serves the request without a rebuild (the paper's
    "every tree" guarantee as a cache-hit rule).

Every response carries the coreset fingerprint and its honest eps_eff so a
client can tell exactly which guarantee it was served under.

Every loss query dispatches through ``repro_torch.ops`` and reports the
backend that served it (``ops_backend_cuda``, ``ops_backend_torch`` or
``ops_backend_numpy``): on the card the hand-written kernels, on the CPU
only where the caller pinned ``numpy`` or ``torch``; with neither a card
nor a pin the dispatch raises and the query fails.

``mesh=`` (a ``DeviceMesh`` with a ``data`` dimension,
``repro_torch.launch.mesh``) shards batched scoring over the mesh
(``core.sharded.fitting_loss_batched``): each rank scores its slab of the
coreset's blocks, one all_reduce sums them.  A mesh engine is SPMD: one
engine a rank, and every rank's engine receives the same calls in the same
order (a collective waits for every rank of the mesh), so batches are not
coalesced across requests under a mesh.
"""
from __future__ import annotations

import collections
import hashlib
import threading
import time

import numpy as np

from repro_torch import obs, ops
from repro_torch.ops import autotune
from repro_torch.core.coreset import SignalCoreset, signal_coreset, signal_coreset_to_size
from repro_torch.core.sharded import (fitting_loss_batched, mesh_axis,
                                      mesh_backend, sharded_coreset)
from repro_torch.core.streaming import StreamingBuilder
from repro_torch.trees.forest import RandomForestRegressor

from .admission import AdmissionController
from .cache import CacheEntry, DominanceCache, _eps_key, spans_intersect
from .metrics import ServiceMetrics
from .query_scheduler import QueryScheduler
from .scheduler import BuildScheduler

__all__ = ["CoresetEngine", "SignalState", "UnknownSignalError"]


class UnknownSignalError(KeyError):
    """Lookup of a signal name nobody registered — the HTTP layer maps this
    (and only this) KeyError to 404, so stray KeyErrors from bugs still
    surface as 500s instead of masquerading as not_found."""


class _BuilderSlot:
    """A per-(k, eps) StreamingBuilder plus how many of the signal's bands it
    has consumed.  ``lock`` serializes feeding/result; band ranges are claimed
    under the signal lock while holding it, so insertion order always matches
    ingest order."""

    __slots__ = ("builder", "consumed", "lock")

    def __init__(self, builder: StreamingBuilder):
        self.builder = builder
        self.consumed = 0
        self.lock = threading.Lock()


class SignalState:
    """One named signal: dense matrix and/or band stream.

    ``version`` is a running content hash (chained per band), so the cache
    key is well-defined: the same bytes ingested in the same order always
    map to the same version, and any mutation bumps it; a band replacement
    recomputes the same fold over the new band sequence.

    Ingest only appends to ``bands`` (O(1) under the lock); the per-(k, eps)
    merge-reduce builders catch up lazily on the build path, outside this
    lock, so /healthz, /stats and concurrent ingests never stall behind a
    coreset build.

    ``stats`` holds the signal's three integral images — dense signals
    only: materialized once at the first delta write (pinning ~3x the
    signal's bytes is only worth it for signals that mutate), patched
    *incrementally* through the ``repro_torch.ops.delta_sat`` op on every later
    write — O(changed rows) instead of the O(N) from-scratch re-SAT, and
    bitwise identical to one on the f64 oracle — and reused by dense
    builds via :meth:`stats_snapshot`.  Streamed signals build through
    per-band merge-reduce and never read them, so going streamed drops
    them.
    """

    MAX_BUILDERS = 8   # LRU cap: (k, eps) come from client requests, so an
                       # unbounded dict would leak one merge-reduce state per
                       # distinct pair; evicted slots rebuild by band replay

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.RLock()
        self.bands: list[np.ndarray] = []
        self.m: int | None = None
        self.n: int = 0
        self.version = hashlib.blake2b(name.encode(), digest_size=12).hexdigest()
        self.builders: "collections.OrderedDict[tuple[int, float], _BuilderSlot]" = \
            collections.OrderedDict()
        self.streamed = False
        self.stats = None   # lazily-materialized PrefixStats (delta-patched)

    def append(self, band: np.ndarray, *, streamed: bool) -> None:
        band = np.ascontiguousarray(band, np.float64)
        if band.ndim != 2 or band.size == 0:
            raise ValueError("band must be a non-empty 2D array")
        with self.lock:
            if self.m is None:
                self.m = band.shape[1]
            elif band.shape[1] != self.m:
                raise ValueError(f"band has {band.shape[1]} columns, signal has {self.m}")
            old_n = self.n
            self.bands.append(band)
            self.n += band.shape[0]
            self.streamed = self.streamed or streamed or len(self.bands) > 1
            h = hashlib.blake2b(digest_size=12)
            h.update(self.version.encode())
            h.update(band.tobytes())
            self.version = h.hexdigest()
            if self.streamed:
                # only dense builds consume the images; streamed signals
                # build through per-band merge-reduce, so maintaining (and
                # pinning) full-signal stats would be pure waste
                self.stats = None
            elif self.stats is not None:
                # O(band) continuation of the integral images (delta_sat)
                self.stats = self.stats.patch_rows(old_n, band)

    def band_starts(self) -> list[int]:
        starts, r = [], 0
        for b in self.bands:
            starts.append(r)
            r += b.shape[0]
        return starts

    def replace_rows(self, row0: int, band: np.ndarray) -> int | None:
        """Replace rows [row0, row0 + rows) with ``band`` (the delta-ingest
        write path).  Streamed signals require the replacement to align with
        an ingested band (whole-band swap — the merge-reduce leaves map 1:1
        to ingested bands); single-band dense signals accept any in-range
        row window.  Returns the replaced band's index (None for the dense
        in-place case).  Raises ValueError on any misalignment — the HTTP
        layer turns that into the uniform 400 envelope.
        """
        band = np.ascontiguousarray(band, np.float64)
        if band.ndim != 2 or band.size == 0:
            raise ValueError("band must be a non-empty 2D array")
        rows = band.shape[0]
        with self.lock:
            if self.m is None:
                raise ValueError(f"signal {self.name!r} holds no data yet")
            if band.shape[1] != self.m:
                raise ValueError(f"band has {band.shape[1]} columns, "
                                 f"signal has {self.m}")
            if not (0 <= row0 and row0 + rows <= self.n):
                raise ValueError(f"rows [{row0}, {row0 + rows}) outside "
                                 f"signal of {self.n} rows")
            if self.streamed:
                starts = self.band_starts()
                try:
                    idx = starts.index(row0)
                except ValueError:
                    raise ValueError(
                        f"row offset {row0} does not start an ingested band "
                        f"(starts: {starts})") from None
                if self.bands[idx].shape[0] != rows:
                    raise ValueError(
                        f"band {idx} holds {self.bands[idx].shape[0]} rows, "
                        f"replacement has {rows}")
                self.bands[idx] = band
                band_index = idx
                self.stats = None   # streamed: nothing reads the images
            else:
                # single dense band: patch the row window on a FRESH array,
                # never in place — a concurrent build snapshots the previous
                # array under this lock and keeps reading it outside, so an
                # in-place write would tear its data (same reason the stats
                # patch below uses copy=True).  The copy + suffix re-SAT +
                # version refold are the documented dense-replace trade-off
                # (O(N) bandwidth, no O(N) recompute; streamed replaces
                # stay O(band)).
                base = np.array(self.bands[0], np.float64, copy=True)
                base[row0:row0 + rows] = band
                self.bands[0] = base
                band_index = None
            if band_index is None and self.stats is not None:
                # dense only — rows below the patch shift their prefixes
                # too: re-run the delta op over the suffix (copy=True: a
                # concurrent build may still be reading the previous images)
                tail = self.bands[0][row0:]
                self.stats = self.stats.patch_rows(row0, tail, copy=True)
            # version is the same fold appends maintain, over the new bands
            h = hashlib.blake2b(self.name.encode(), digest_size=12)
            version = h.hexdigest()
            for b in self.bands:
                h2 = hashlib.blake2b(digest_size=12)
                h2.update(version.encode())
                h2.update(b.tobytes())
                version = h2.hexdigest()
            self.version = version
        return band_index

    def dense_locked(self) -> np.ndarray:
        if len(self.bands) == 1:
            return self.bands[0]
        return np.concatenate(self.bands, axis=0)

    def dense(self) -> np.ndarray:
        with self.lock:
            return self.dense_locked()

    def stats_snapshot(self, version: str | None = None):
        """The materialized integral images, or None — never materializes.
        Dense builds reuse the images only for signals whose first delta
        write already paid for them: pinning ~3x the signal's bytes on
        every dense signal just in case would not amortize."""
        with self.lock:
            if self.stats is None or self.stats.shape != (self.n, self.m):
                return None
            if version is not None and self.version != version:
                return None
            return self.stats

    def ensure_stats(self, version: str | None = None):
        """Materialize the integral images by chaining ``delta_sat`` over
        the stored bands (bitwise equal to a from-scratch build on the f64
        oracle).  Returns None when ``version`` no longer matches — the
        caller's snapshot went stale and must not mix arrays and stats."""
        with self.lock:
            if version is not None and self.version != version:
                return None
            if self.stats is not None and self.stats.shape == (self.n, self.m):
                return self.stats
            bands = list(self.bands)
            v = self.version
        from repro_torch.core.stats import PrefixStats
        ps = None
        for band in bands:   # outside the lock: O(N) chain, O(band) steps
            ps = PrefixStats.build(band) if ps is None else ps.append_rows(band)
        with self.lock:
            if self.version == v:
                self.stats = ps
        return ps if version in (None, v) else None

    def info(self) -> dict:
        with self.lock:
            return {"name": self.name, "n": self.n, "m": self.m,
                    "bands": len(self.bands), "streamed": self.streamed,
                    "version": self.version,
                    "builders": sorted(self.builders)}


class CoresetEngine:
    MAX_FOREST_CACHE = 32   # fitted forests are MB-scale; keep a small LRU

    def __init__(self, *, cache_bytes: int = 256 << 20, workers: int = 4,
                 num_bands: int = 4, batch_window: float = 0.004,
                 query_window: float = 0.002, query_max_fuse: int = 16,
                 coalesce: bool = True,
                 metrics: ServiceMetrics | None = None, mesh=None,
                 admission: "AdmissionController | None" = None):
        if mesh is not None:
            mesh_axis(mesh, "data")
        self.metrics = metrics or ServiceMetrics()
        # optional front-door admission control (service/admission.py):
        # consulted by the HTTP layer and the cluster coordinator, never by
        # the engine's own compute paths — admitted work runs bit-identically
        # to an engine without it
        self.admission = admission
        if admission is not None and admission.metrics is None:
            admission.metrics = self.metrics
        self.cache = DominanceCache(cache_bytes, metrics=self.metrics)
        self.scheduler = BuildScheduler(max_workers=workers,
                                        batch_window=batch_window,
                                        metrics=self.metrics)
        # cross-request loss-query coalescing (the BuildScheduler pattern
        # applied to reads); ``coalesce=False`` turns the engine-wide
        # default off, and every query can opt out per-request
        self.queries = QueryScheduler(window=query_window,
                                      max_fuse=query_max_fuse,
                                      max_workers=workers,
                                      metrics=self.metrics)
        self.coalesce_queries = bool(coalesce)
        self.num_bands = int(num_bands)
        self.mesh = mesh   # optional DeviceMesh for sharded batch scoring
        self._signals: dict[str, SignalState] = {}
        self._lock = threading.Lock()
        # fit results are deterministic given (coreset fingerprint,
        # hyperparams, seed): identical re-fits are pure cache hits.
        # value: (fitted forest, train_size)
        self._forests: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()
        self._forests_lock = threading.Lock()
        # last autotune counter values already folded into self.metrics —
        # autotune's counters are process-global monotonic, ServiceMetrics
        # counters are per-engine, so each sync adds only the delta
        self._autotune_synced: dict[str, int] = {}

        # ops-dispatch profiling: the registry's hook seam feeds per-(op,
        # backend, shape-bucket) wall time into THIS engine's metrics, so
        # /metrics and /v1/stats show where dispatches actually go and what
        # they cost — including dispatches made from library code the engine
        # never sees directly (per-band builds, streaming recompression)
        def _on_dispatch(op: str, backend: str, size, seconds: float,
                         _m=self.metrics) -> None:
            bucket = obs.profile.shape_bucket(size)
            _m.inc("ops_dispatch_total", op=op, backend=backend,
                   bucket=bucket)
            sp = obs.current_span()
            _m.observe("ops_dispatch", seconds, op=op, backend=backend,
                       bucket=bucket,
                       exemplar=sp.trace_id if sp else None)

        self._profile_hook = _on_dispatch
        obs.profile.add_hook(self._profile_hook)

    # ---------------------------------------------------------------- ingest
    def register_signal(self, name: str, values: np.ndarray, *,
                        replace: bool = False) -> dict:
        """Register a dense signal under ``name`` (one-shot build path)."""
        # build + validate the full state BEFORE publishing: a malformed
        # payload must neither poison the name nor (with replace) destroy
        # the existing signal
        st = SignalState(name)
        st.append(np.asarray(values, np.float64), streamed=False)
        with self._lock:
            if name in self._signals and not replace:
                raise ValueError(f"signal {name!r} already registered")
            self._signals[name] = st
        # a replaced signal's old-version entries can never serve again
        self.cache.invalidate_signal(name, keep_version=st.version)
        self.metrics.inc("signals_registered")
        return st.info()

    def ingest_band(self, name: str, band: np.ndarray) -> dict:
        """Append a row band to ``name`` (created on first ingest).  O(1):
        the per-(k, eps) StreamingBuilders catch up on the new bands at the
        next build/query, off the ingest path."""
        band = np.asarray(band, np.float64)
        with self._lock:
            st = self._signals.get(name)
            created = st is None
            if created:
                st = SignalState(name)
        with self.metrics.timed("ingest"):
            st.append(band, streamed=True)   # validates; raises before publish
        with self._lock:
            winner = self._signals.setdefault(name, st) if created \
                else self._signals.get(name)
        if winner is not st:
            # lost a creation race, or register_signal(replace=True) swapped
            # the state mid-append: replay into the live signal so the
            # acknowledged write is never silently dropped
            return self.ingest_band(name, band)
        # stale-version entries can never serve again; free their bytes now
        self.cache.invalidate_signal(name, keep_version=st.version)
        self.metrics.inc("bands_ingested")
        return st.info()

    def ingest_delta(self, name: str, band, *, row0: int | None = None,
                     row0s: list | None = None,
                     rows: list | None = None) -> dict:
        """Delta write path: patch an existing signal with only the changed
        rows (``POST /v1/ingest:delta``).

        * ``row0 is None`` (or == current n): append — the stream's normal
          growth, O(band) state update.
        * otherwise: replace rows [row0, row0+rows).  The signal's integral
          images are patched through the dispatched ``delta_sat`` op, live
          merge-reduce builders swap just the affected leaf and mark its
          bucket dirty (``streaming_compress`` recompresses only those), and
          every cache entry the old version held is re-cached under the new
          version — synchronously for streamed specs (a cheap dirty-bucket
          flush), through the BuildScheduler for dense specs (a partition
          re-run does not belong on the write path) — instead of the legacy
          full re-ingest that re-SATs and re-compresses from scratch.

        **Burst form**: ``row0s``/``rows`` describe MANY deltas in one call
        — ``band`` is then the row-wise concatenation of ``len(row0s)``
        bands of ``rows[i]`` rows each, and ``row0s[i]`` places band i
        (None appends).  The per-band leaf ``signal_coreset`` rebuilds of
        every live merge-reduce builder fan out over the QueryScheduler's
        worker pool as ONE batched submission instead of N sequential
        builds, and the whole burst re-caches / recompresses once.

        Unknown signals 404 (a delta against nothing is a client bug, not an
        implicit create); malformed bands raise ValueError -> 400 envelope.
        """
        import contextlib

        band = np.ascontiguousarray(band, np.float64)
        if band.ndim != 2 or band.size == 0:
            raise ValueError("delta band must be a non-empty 2D array")
        if row0s is not None:
            if row0 is not None:
                raise ValueError("pass either row0 or row0s, not both")
            if rows is None or len(rows) != len(row0s) or not row0s:
                raise ValueError("burst needs matching non-empty row0s/rows")
            rows = [int(r) for r in rows]
            if any(r < 1 for r in rows):
                raise ValueError("every burst band needs >= 1 rows")
            if sum(rows) != band.shape[0]:
                raise ValueError(
                    f"rows {rows} sum to {sum(rows)}, band has "
                    f"{band.shape[0]} rows")
            pieces = np.split(band, np.cumsum(rows)[:-1], axis=0)
            deltas = [(None if r0 is None else int(r0), b)
                      for r0, b in zip(row0s, pieces)]
        elif rows is not None:
            raise ValueError("rows requires row0s (the burst form needs both)")
        else:
            deltas = [(None if row0 is None else int(row0), band)]
        st = self.signal(name)
        buckets0 = self._buckets_recompressed(st)
        recached = 0
        # only a true replace reads the integral images; an explicit
        # row0 == n is an append, whose streamed flip would discard them
        if any(r0 is not None and r0 != st.n
               for r0, _ in deltas) and not st.streamed:
            # first dense delta pays the one-off SAT materialization here
            # (outside the heavy lock section); every later replace patches
            # it in O(changed rows) and every later build skips its re-SAT
            st.ensure_stats()
        modes: list[str] = []
        applied: list[int] = []
        replaced: list[tuple[int, np.ndarray]] = []   # (band_index, band)
        dense_replaces = 0
        reanchored = 0
        with self.metrics.timed("ingest_delta"):
            # hold EVERY live builder lock across the mutation + leaf swap
            # (slot.lock before st.lock, the documented order): a concurrent
            # _build_streamed must not snapshot the bumped version while a
            # builder still carries the old leaf — it would cache stale
            # content under the new version.  Slots created concurrently are
            # safe either way: they replay the bands they read under st.lock.
            with st.lock:
                slots = list(st.builders.values())
            with contextlib.ExitStack() as stack:
                for slot in slots:
                    stack.enter_context(slot.lock)
                with st.lock:
                    # a malformed delta must reject the WHOLE burst before
                    # the first mutation: the loop below applies deltas in
                    # place, so a mid-burst validation failure would commit
                    # the earlier writes while skipping the leaf swaps and
                    # cache invalidation that follow (the single-delta path
                    # validates exactly where it applies, so it needs no
                    # pre-flight)
                    if len(deltas) > 1:
                        self._validate_burst_locked(st, deltas)
                    # entries live under the signal's PRE-burst version:
                    # capture their specs before the first mutation bumps it
                    prev_specs = self.cache.specs_for(name, st.version)
                    old_version, old_n = st.version, st.n
                    old_streamed, old_bands = st.streamed, len(st.bands)
                    for r0, b in deltas:
                        # mode decision and placement are atomic with the
                        # write: an explicit row0 == n is an append only if
                        # n still is n
                        if r0 is None or r0 == st.n:
                            modes.append("append")
                            applied.append(st.n)
                            st.append(b, streamed=True)
                            # per-(k, eps) builders consume the new band
                            # lazily at the next build, like /v1/ingest
                        else:
                            modes.append("replace")
                            applied.append(r0)
                            idx = st.replace_rows(r0, b)
                            if idx is not None:
                                replaced.append((idx, b))
                            else:
                                dense_replaces += 1
                    # version after OUR deltas, read under the same lock
                    # hold that applied them — re-anchored entries must be
                    # keyed to exactly this state, not whatever st.version
                    # says after a concurrent writer slips in
                    post_version = st.version
                if replaced:
                    # swap each replaced leaf in every builder that already
                    # consumed it — builders keep their merge-reduce state
                    # instead of a from-scratch replay.  The per-(builder,
                    # band) leaf signal_coreset builds are pure functions of
                    # (band bytes, k, eps): fan them out over the query
                    # scheduler's pool as ONE batched submission, then swap
                    # the finished leaves in under the held locks.
                    swaps = [(slot, idx, b)
                             for slot in slots
                             for idx, b in replaced
                             if slot.consumed > idx]
                    leaves = self.queries.map_fanout(
                        [lambda s=slot, bb=b: signal_coreset(
                            bb, s.builder.k, s.builder.eps)
                         for slot, _, b in swaps])
                    if swaps:
                        self.metrics.inc("ingest_delta_leaf_builds_batched",
                                         len(swaps))
                    for (slot, idx, b), leaf_cs in zip(swaps, leaves):
                        slot.builder.replace_band(idx, b, _leaf_cs=leaf_cs)
                        self.metrics.inc("ingest_delta_rebuilds_avoided")
                if dense_replaces and st.stats is not None:
                    # dense signal: the patched integral images spare the
                    # next build its O(N) re-SAT
                    self.metrics.inc("ingest_delta_rebuilds_avoided",
                                     dense_replaces)
                if (prev_specs and modes == ["append"] and old_streamed
                        and old_bands >= 2 and old_bands % 2 == 0):
                    # re-anchor fast path: a pure append touches rows the
                    # cached blocks provably do not cover, and with an even
                    # prior band count the merge-reduce cascade stays cold,
                    # so the fresh-build result is exactly "cached arrays +
                    # the new band's leaf blocks".  Splice in metadata time
                    # and re-key to the post-append version — no rebuild.
                    # (Builder locks are still held here: the eager feed
                    # below must not race a concurrent _build_streamed.)
                    reanchored = self._reanchor_append(
                        st, slots, old_version, post_version, old_n,
                        deltas[0][1], prev_specs, old_bands)
            if replaced:
                # close the slot-creation window: a slot born between the
                # snapshot above and the version bump may have consumed the
                # OLD band content (the consumed counter cannot see content
                # replacement).  One re-list suffices — slots created after
                # the bump replay the new bands.  Swapping a leaf that
                # already holds the new content is idempotent.
                seen = set(map(id, slots))
                with st.lock:
                    newcomers = [s for s in st.builders.values()
                                 if id(s) not in seen]
                for slot in newcomers:
                    with slot.lock:
                        for idx, b in replaced:
                            if slot.consumed > idx:
                                slot.builder.replace_band(idx, b)
            self.cache.invalidate_signal(name, keep_version=st.version)
            # re-cache what the old version served, under the new version:
            # streamed specs rebuild synchronously (a cheap dirty-bucket
            # recompress + compose); dense specs re-run the partition, so
            # they go through the BuildScheduler off the write path (and
            # coalesce with any concurrent query for the same coreset)
            version = st.version
            if "replace" in modes:
                for k, eps in prev_specs:
                    with st.lock:
                        live = (k, _eps_key(eps)) in st.builders
                    if live:
                        self._build_and_cache(st, version, k, eps)
                    else:
                        self.scheduler.submit(
                            (name, version, k, _eps_key(eps)),
                            lambda k=k, eps=eps: self._build_and_cache(
                                st, version, k, eps))
                    recached += 1
        buckets = self._buckets_recompressed(st) - buckets0
        self.metrics.inc("ingest_delta_bands", len(deltas))
        for mode in modes:
            self.metrics.inc(f"ingest_delta_{mode}s")
        if buckets:
            self.metrics.inc("ingest_delta_buckets_recompressed", buckets)
        if recached:
            self.metrics.inc("ingest_delta_recached", recached)
        info = st.info()
        return {"name": info["name"], "n": info["n"], "m": info["m"],
                "bands": info["bands"], "streamed": info["streamed"],
                "version": info["version"],
                "mode": modes[0] if len(modes) == 1 else "burst",
                "row0": applied[0], "rows": int(band.shape[0]),
                "deltas": len(deltas),
                "buckets_recompressed": int(buckets),
                "entries_recached": int(recached),
                "entries_reanchored": int(reanchored)}

    @staticmethod
    def _validate_burst_locked(st: SignalState, deltas: list) -> None:
        """Pre-flight every delta of a burst against a *simulated* walk of
        the signal's geometry (caller holds ``st.lock``), mirroring the
        checks ``append``/``replace_rows`` make — including appends growing
        ``n`` and flipping the signal streamed mid-burst — so nothing
        mutates unless the whole burst is applicable."""
        n = st.n
        starts = st.band_starts()
        band_rows = [b.shape[0] for b in st.bands]
        streamed = st.streamed
        for r0, b in deltas:
            rows = b.shape[0]
            if st.m is not None and b.shape[1] != st.m:
                raise ValueError(f"band has {b.shape[1]} columns, "
                                 f"signal has {st.m}")
            if r0 is None or r0 == n:
                starts.append(n)
                band_rows.append(rows)
                n += rows
                streamed = True   # delta appends always stream (see loop)
            else:
                if not (0 <= r0 and r0 + rows <= n):
                    raise ValueError(f"rows [{r0}, {r0 + rows}) outside "
                                     f"signal of {n} rows")
                if streamed or len(band_rows) > 1:
                    try:
                        idx = starts.index(r0)
                    except ValueError:
                        raise ValueError(
                            f"row offset {r0} does not start an ingested "
                            f"band (starts: {starts})") from None
                    if band_rows[idx] != rows:
                        raise ValueError(
                            f"band {idx} holds {band_rows[idx]} rows, "
                            f"replacement has {rows}")

    @staticmethod
    def _buckets_recompressed(st: SignalState) -> int:
        with st.lock:
            return sum(s.builder.buckets_recompressed_total
                       for s in st.builders.values())

    # ----------------------------------------------------- cache re-anchoring
    @staticmethod
    def _spliced_coreset(cs: SignalCoreset, leaf: SignalCoreset,
                         row0: int) -> SignalCoreset:
        """Append-splice: the cached composed coreset plus one new band's
        leaf coreset placed at ``row0``, folded EXACTLY as
        ``streaming.compose`` folds its items — so the result is bitwise
        identical to a fresh merge-reduce build of the grown signal.

        Why the fields fold this way: a fresh ``StreamingBuilder.result()``
        over the grown band set composes ``sorted(old bucket items) +
        [new leaf]``.  ``cs`` *is* ``compose(old items)``, and every compose
        fold is associative: eps/max_slices take max, sigma/tolerance take
        min, build_seconds sums, rects/labels/weights/moments concatenate in
        row order (``cs``'s rects are already absolute; the leaf's shift by
        ``row0``), and bicriteria comes from the first item in row order —
        unchanged, since the leaf sorts last.
        """
        rects = leaf.rects.copy()
        rects[:, 0] += row0
        rects[:, 1] += row0
        return SignalCoreset(
            n=int(row0 + leaf.n), m=cs.m, k=cs.k,
            eps=max(cs.eps, leaf.eps),
            rects=np.concatenate([cs.rects, rects], axis=0),
            labels=np.concatenate([cs.labels, leaf.labels], axis=0),
            weights=np.concatenate([cs.weights, leaf.weights], axis=0),
            moments=np.concatenate([cs.moments, leaf.moments], axis=0),
            sigma=min(cs.sigma, leaf.sigma),
            tolerance=min(cs.tolerance, leaf.tolerance),
            max_slices=max(cs.max_slices, leaf.max_slices),
            bicriteria=cs.bicriteria,
            build_seconds=cs.build_seconds + leaf.build_seconds,
            certified=bool(cs.certified and leaf.certified),
        )

    def _reanchor_append(self, st: SignalState, slots: list, old_version: str,
                         new_version: str, old_n: int, band: np.ndarray,
                         prev_specs: list, old_bands: int) -> int:
        """Re-key every old-version cache entry whose blocks are disjoint
        from the appended rows to ``new_version``, splicing in the new
        band's leaf blocks instead of rebuilding (O(entries x spans)
        metadata work + one leaf coreset per cached spec).

        Soundness gate (checked by the caller): the delta is a SINGLE
        append to a streamed signal with an EVEN prior band count.  In the
        merge-reduce binary counter an even count leaves level 0 empty, so
        inserting the new band cascades nothing — no bucket merges, no
        recompression, ``max_level`` (hence eps_eff) unchanged — and a
        fresh build is literally the old composition plus the new leaf.
        Odd counts (or replaces) change bucket contents and fall back to
        invalidate+rebuild.  Per-entry, ``row_spans`` disjointness is
        checked anyway: an entry with unknown provenance must not ride.

        Entries whose spec has a live builder that consumed exactly the
        pre-append bands also feed that builder the prebuilt leaf (caller
        holds the slot locks), so the next ``result()`` is a no-op replay.
        """
        rows = int(band.shape[0])
        taken: list[CacheEntry] = []
        for k, eps in prev_specs:
            entry = self.cache.take(st.name, old_version, k, eps)
            if entry is None:
                continue
            if spans_intersect(entry.row_spans, old_n, old_n + rows):
                # overlapping or unknown provenance: put it back for
                # invalidate_signal to drop (and count as a candidate
                # that fell back to the rebuild path)
                self.cache.put(entry)
                continue
            taken.append(entry)
        if not taken:
            return 0
        with self.metrics.timed("cache_reanchor"):
            # one leaf build per cached (k, eps) spec, batched over the
            # query pool — shared between the splice and the eager feed
            leaves = self.queries.map_fanout(
                [lambda e=e: signal_coreset(band, e.k, e.eps)
                 for e in taken])
            by_spec: dict[tuple, SignalCoreset] = {}
            for entry, leaf in zip(taken, leaves):
                spliced = self._spliced_coreset(entry.coreset, leaf, old_n)
                self.cache.put(CacheEntry(
                    signal=st.name, version=new_version, k=entry.k,
                    eps=entry.eps, eps_eff=entry.eps_eff, coreset=spliced,
                    nbytes=spliced.nbytes,
                    fingerprint=spliced.fingerprint(), hits=entry.hits,
                    build_seconds=float(spliced.build_seconds)))
                by_spec[(entry.k, _eps_key(entry.eps))] = leaf
            with st.lock:
                live = dict(st.builders)
            for slot in slots:
                key = (slot.builder.k, _eps_key(slot.builder.eps))
                leaf = by_spec.get(key)
                # feed only builders exactly at the pre-append state (a
                # lagging builder must replay bands in ingest order; a
                # slot no longer registered is already evicted)
                if (leaf is not None and live.get(key) is slot
                        and slot.consumed == old_bands):
                    slot.builder.insert_band(band, _leaf_cs=leaf)
                    slot.consumed += 1
        self.cache.mark_reanchored(len(taken))
        return len(taken)

    def signal(self, name: str) -> SignalState:
        with self._lock:
            st = self._signals.get(name)
        if st is None:
            raise UnknownSignalError(f"unknown signal {name!r}")
        return st

    def list_signals(self) -> list[dict]:
        with self._lock:
            states = list(self._signals.values())
        return [st.info() for st in states]

    # ----------------------------------------------------------------- build
    @staticmethod
    def _remaining(deadline: float | None,
                   timeout: float | None = None) -> float | None:
        """Seconds left until ``deadline`` (absolute perf_counter instant),
        folded with an optional plain timeout; None = wait forever."""
        if deadline is None:
            return timeout
        rem = max(deadline - time.perf_counter(), 0.0)
        return rem if timeout is None else min(timeout, rem)

    def get_coreset(self, name: str, k: int, eps: float, *,
                    timeout: float | None = None,
                    deadline: float | None = None,
                    ) -> tuple[SignalCoreset, float, str]:
        """Cached-or-built (k, eps)-coreset of the signal's current version.

        Returns (coreset, eps_eff, disposition) with disposition in
        {"exact", "dominated", "built", "coalesced"}.  ``deadline``
        propagates into the BuildScheduler: the build is skipped entirely
        when every waiter's deadline has already expired, and the wait here
        raises TimeoutError (HTTP 504) at the deadline.
        """
        k = int(k)
        eps = float(eps)
        if k < 1:
            raise ValueError("k must be >= 1")
        if not (0.0 < eps < 1.0):
            raise ValueError("eps must be in (0,1)")
        st = self.signal(name)
        version = st.version
        with obs.span("coreset.get", signal=name, k=k) as sp:
            # cache hits are the hot path: record the lookup as attrs on
            # coreset.get and only materialize a cache.lookup span on a
            # miss (the build path, already orders of magnitude slower)
            t0 = time.perf_counter()
            entry, kind = self.cache.lookup(name, version, k, eps)
            if entry is not None:
                sp.set_attr("disposition", kind)
                sp.set_attr("lookup_us",
                            round((time.perf_counter() - t0) * 1e6, 1))
                return entry.coreset, entry.eps_eff, kind
            lk = obs.child_span("cache.lookup",
                                attrs={"outcome": "miss"})
            if lk:
                lk.start_pc = t0
                lk.end()
            key = (name, version, k, _eps_key(eps))
            fut, created = self.scheduler.submit(
                key, lambda: self._build_and_cache(st, version, k, eps),
                deadline=deadline)
            entry = fut.result(timeout=self._remaining(deadline, timeout))
            sp.set_attr("disposition", "built" if created else "coalesced")
        return entry.coreset, entry.eps_eff, "built" if created else "coalesced"

    def _build_and_cache(self, st: SignalState, version: str, k: int,
                         eps: float) -> CacheEntry:
        # close the lookup->submit race: if an identical build finished and
        # was cached after the caller's miss but before this worker ran, the
        # snapshot-version entry is already here — serve it, don't rebuild
        entry, _ = self.cache.lookup(st.name, version, k, eps, record=False)
        if entry is not None:
            return entry
        # the O(Nk) work runs OUTSIDE st.lock (healthz/info/ingest must not
        # stall behind a build); each builder snapshots state under the lock
        # and returns the version its coreset actually corresponds to
        with st.lock:
            streamed = st.streamed
        with obs.span("engine.compress", signal=st.name, k=k,
                      streamed=streamed):
            if streamed:
                cs, eps_eff, version = self._build_streamed(st, k, eps)
            else:
                cs, eps_eff, version = self._build_dense(st, k, eps)
        entry = CacheEntry(
            signal=st.name, version=version, k=k, eps=eps, eps_eff=eps_eff,
            coreset=cs, nbytes=cs.nbytes, fingerprint=cs.fingerprint(),
            build_seconds=float(cs.build_seconds))
        self.cache.put(entry)
        # actual coreset constructions (scheduler's builds_completed counts
        # finished jobs, which include re-lookup short-circuits above)
        self.metrics.inc("coreset_builds")
        return entry

    def _build_dense(self, st: SignalState, k: int, eps: float,
                     ) -> tuple[SignalCoreset, float, str]:
        with st.lock:
            y = st.dense_locked()
            version = st.version
        bands = min(self.num_bands, max(1, y.shape[0] // 32))
        # reuse the delta-patched integral images when a delta write already
        # materialized them (None otherwise, or if the snapshot went stale
        # mid-ingest — then the build derives its own transient stats)
        ps = st.stats_snapshot(version)
        if bands > 1:
            cs = sharded_coreset(y, k, eps, num_bands=bands, _stats=ps)
        else:
            cs = signal_coreset(y, k, eps, _stats=ps)
        return cs, eps, version  # composition of disjoint bands is exact

    @staticmethod
    def _stream_eps_eff(b: StreamingBuilder, eps: float) -> float:
        # each merge level recompresses once: (1+eps)^(L+1) - 1 composed
        return float((1.0 + eps) ** (b.max_level + 1) - 1.0) \
            if b.recompress_levels else eps

    def _build_streamed(self, st: SignalState, k: int, eps: float,
                        ) -> tuple[SignalCoreset, float, str]:
        bk = (k, _eps_key(eps))
        with st.lock:
            slot = st.builders.get(bk)
            if slot is None:
                slot = st.builders[bk] = _BuilderSlot(
                    StreamingBuilder(m=st.m, k=k, eps=eps))
                while len(st.builders) > st.MAX_BUILDERS:
                    st.builders.popitem(last=False)   # LRU slot; replayable
            else:
                st.builders.move_to_end(bk)
        # slot.lock serializes feeders (so bands enter in ingest order) and
        # is taken BEFORE st.lock — never the reverse — so the heavy
        # insert_band cascades run with the signal lock free
        with slot.lock:
            with st.lock:
                missing = list(st.bands[slot.consumed:])
                slot.consumed = len(st.bands)
                version = st.version
            for band in missing:
                slot.builder.insert_band(band)
            cs = slot.builder.result()
            eps_eff = self._stream_eps_eff(slot.builder, eps)
        return cs, eps_eff, version

    # --------------------------------------------------------------- queries
    def tree_loss(self, name: str, seg_rects, seg_labels, *,
                  eps: float = 0.2, k: int | None = None,
                  timeout: float | None = None,
                  deadline: float | None = None,
                  coalesce: bool = True) -> dict:
        """Algorithm-5 loss of a k-segmentation, served from cache.

        ``k`` defaults to the query's leaf count — the smallest coreset
        parameter whose guarantee covers this tree.

        By default the evaluation routes through the :class:`QueryScheduler`
        so concurrent same-signal queries from different connections fuse
        into one ``fitting_loss_batched`` dispatch; ``coalesce=False`` (or
        an engine built with ``coalesce=False``) is the escape hatch that
        scores inline, exactly like the pre-coalescing path.
        """
        seg_rects = np.asarray(seg_rects, np.int64).reshape(-1, 4)
        seg_labels = np.asarray(seg_labels, np.float64).ravel()
        if seg_rects.shape[0] != seg_labels.shape[0]:
            raise ValueError("rects/labels length mismatch")
        k = int(k) if k is not None else int(seg_rects.shape[0])
        with obs.span("engine.tree_loss", signal=name, k=k,
                      coalesce=bool(coalesce and self.coalesce_queries)), \
                self.metrics.timed("query_loss"):
            cs, eps_eff, how = self.get_coreset(name, k, eps, timeout=timeout,
                                                deadline=deadline)
            fp = cs.fingerprint()   # hashes the coreset arrays: once per query
            if coalesce and self.coalesce_queries:
                # fusion key: only queries that score against the SAME
                # cached coreset on the SAME backend may share a dispatch
                # (mixed-k queries resolve different coresets — never fused).
                # The backend is selected at T=1, i.e. what THIS query would
                # run alone, deliberately: fusing must never size-promote a
                # query off the f64 numpy oracle onto an f32 path (the
                # coalesce gate's <=1e-9 parity vs the uncoalesced path
                # depends on it), and on the card — where the T axis pays —
                # selection takes cuda at any size anyway
                backend = ops.selected_backend(
                    "fitting_loss_batched",
                    ops.fitting_loss_batched_size(cs, seg_rects[None]))
                key = (fp, k, _eps_key(eps), backend)

                def execute(rects3, labels2, _cs=cs, _backend=backend):
                    self.metrics.inc("loss_scoring_calls")  # ONE per fusion
                    self.metrics.inc(f"ops_backend_{_backend}")
                    return ops.fitting_loss_batched(_cs, rects3, labels2,
                                                    backend=_backend)

                fut = self.queries.submit(key, seg_rects, seg_labels, execute,
                                          deadline=deadline)
                loss, fused = fut.result(
                    timeout=self._remaining(deadline, timeout))
            else:
                # resolve once, dispatch with the same choice: the reported
                # backend is by construction the one that served the query
                backend = ops.selected_backend(
                    "fitting_loss", ops.fitting_loss_size(cs, seg_rects))
                loss = ops.fitting_loss(cs, seg_rects, seg_labels,
                                        backend=backend)
                fused = 1
                self.metrics.inc("loss_scoring_calls")
                self.metrics.inc(f"ops_backend_{backend}")
        self.metrics.inc("queries_loss")
        return {"loss": float(loss), "k": k, "eps": eps, "eps_eff": eps_eff,
                "served_from": how, "fingerprint": fp,
                "coreset_size": cs.size, "backend": backend,
                "fused_batch_size": int(fused)}

    def tree_loss_batch(self, name: str, seg_rects, seg_labels, *,
                        eps: float = 0.2, k: int | None = None,
                        timeout: float | None = None,
                        deadline: float | None = None,
                        coalesce: bool = True) -> dict:
        """Fused Algorithm-5 loss for T same-signal segmentations.

        ``seg_rects`` (T, K, 4) / ``seg_labels`` (T, K) score against ONE
        cached coreset through the dispatched batched op
        (``core.sharded.fitting_loss_batched`` — the ``repro_torch.ops``
        backend rules when no mesh, blocks sharded over ``self.mesh`` when
        one is configured): a single engine scoring call replaces T
        sequential ``tree_loss`` evaluations — the tuning-sweep inner loop
        served as one request.

        With coalescing on (and no mesh), the batch enqueues into the SAME
        QueryScheduler fusion bucket single ``tree_loss`` queries use — a
        tuning sweep's batch and the interactive singles against the same
        hot coreset merge into one dispatch instead of two.
        """
        seg_rects = np.asarray(seg_rects, np.int64)
        seg_labels = np.asarray(seg_labels, np.float64)
        if seg_rects.ndim != 3 or seg_rects.shape[-1] != 4:
            raise ValueError("batch rects must have shape (T, K, 4)")
        if seg_labels.shape != seg_rects.shape[:2]:
            raise ValueError("batch labels must have shape (T, K)")
        if seg_rects.shape[0] < 1:
            raise ValueError("batch must contain at least one segmentation")
        T = int(seg_rects.shape[0])
        k = int(k) if k is not None else int(seg_rects.shape[1])
        with obs.span("engine.tree_loss_batch", signal=name, k=k,
                      batch=T,
                      coalesce=bool(coalesce and self.coalesce_queries
                                    and self.mesh is None)), \
                self.metrics.timed("query_loss_batch"):
            cs, eps_eff, how = self.get_coreset(name, k, eps, timeout=timeout,
                                                deadline=deadline)
            fp = cs.fingerprint()
            fused = T
            if self.mesh is not None:
                # each rank's slab through the batched kernel + one
                # all_reduce (core.sharded)
                backend = mesh_backend(self.mesh)
                losses = fitting_loss_batched(cs, seg_rects, seg_labels,
                                              mesh=self.mesh)
                self.metrics.inc("loss_scoring_calls")
                self.metrics.inc(f"ops_backend_{backend}")
            elif coalesce and self.coalesce_queries:
                # same fusion key as tree_loss: backend selected at T=1 so
                # a batch never lands in a different bucket than the singles
                # it should fuse with (and never size-promotes co-travelling
                # singles off the f64 oracle — the coalesce parity gate)
                backend = ops.selected_backend(
                    "fitting_loss_batched",
                    ops.fitting_loss_batched_size(cs, seg_rects[:1]))
                key = (fp, k, _eps_key(eps), backend)

                def execute(rects3, labels2, _cs=cs, _backend=backend):
                    self.metrics.inc("loss_scoring_calls")  # ONE per fusion
                    self.metrics.inc(f"ops_backend_{_backend}")
                    return ops.fitting_loss_batched(_cs, rects3, labels2,
                                                    backend=_backend)

                fut = self.queries.submit_batch(key, seg_rects, seg_labels,
                                                execute, deadline=deadline)
                losses, fused = fut.result(
                    timeout=self._remaining(deadline, timeout))
            else:
                # resolve once, dispatch with the same choice (see tree_loss)
                backend = ops.selected_backend(
                    "fitting_loss_batched",
                    ops.fitting_loss_batched_size(cs, seg_rects))
                losses = fitting_loss_batched(cs, seg_rects, seg_labels,
                                              backend=backend)
                self.metrics.inc("loss_scoring_calls")
                self.metrics.inc(f"ops_backend_{backend}")
        self.metrics.inc("queries_loss_batch")
        self.metrics.inc("queries_loss_batch_items", T)
        return {"losses": np.asarray(losses, np.float64),
                "k": k, "eps": eps, "eps_eff": eps_eff, "served_from": how,
                "fingerprint": fp, "coreset_size": cs.size,
                "scoring_calls": 1, "backend": backend,
                "fused_batch_size": int(fused)}

    def fit_forest(self, name: str, *, k: int, eps: float = 0.2,
                   n_estimators: int = 10, max_leaves: int | None = None,
                   predict: np.ndarray | None = None, seed: int = 0,
                   timeout: float | None = None,
                   deadline: float | None = None) -> dict:
        """Train a weighted random forest on the coreset points (§5 solver
        stand-in); optionally evaluate it at ``predict`` (P, 2) grid points."""
        with obs.span("engine.fit_forest", signal=name, k=int(k)), \
                self.metrics.timed("query_fit"):
            cs, eps_eff, how = self.get_coreset(name, k, eps, timeout=timeout,
                                                deadline=deadline)
            fkey = (cs.fingerprint(), int(n_estimators),
                    int(max_leaves or k), int(seed))
            with self._forests_lock:
                cached = self._forests.get(fkey)
                if cached is not None:
                    self._forests.move_to_end(fkey)
            model_cache = "hit"
            if cached is None:
                # materialize the point set only on a miss — a cache hit
                # must not pay the O(|C|) as_points() build
                model_cache = "fit"
                X, y, w = cs.as_points()
                forest = RandomForestRegressor(
                    n_estimators=n_estimators, max_leaves=max_leaves or k,
                    random_state=seed)
                forest.fit(X, y, sample_weight=w)
                cached = (forest, int(len(y)))
                with self._forests_lock:
                    # a racing fit of the same key produced an identical
                    # forest (deterministic given fkey); last writer wins
                    self._forests[fkey] = cached
                    while len(self._forests) > self.MAX_FOREST_CACHE:
                        self._forests.popitem(last=False)
            forest, train_size = cached
            self.metrics.inc(f"forest_cache_{model_cache}")
            out = {"k": k, "eps": eps, "eps_eff": eps_eff, "served_from": how,
                   "train_size": train_size, "n_estimators": n_estimators,
                   "fingerprint": cs.fingerprint(), "model_cache": model_cache}
            if predict is not None:
                pts = np.asarray(predict, np.float64).reshape(-1, 2)
                out["predictions"] = forest.predict(pts).tolist()
        self.metrics.inc("queries_fit")
        return out

    def compress(self, name: str, *, k: int, eps: float | None = None,
                 target_frac: float | None = None, style: str = "mean",
                 max_points: int = 4096, timeout: float | None = None,
                 deadline: float | None = None) -> dict:
        """Compression query: the weighted point set itself (paper Fig 4).

        ``target_frac`` bisects the block tolerance to a size target (dense
        signals only — it re-runs the partition, so it bypasses the cache);
        otherwise the cached (k, eps)-coreset is served.
        """
        with obs.span("engine.compress_query", signal=name, k=int(k)), \
                self.metrics.timed("query_compress"):
            if target_frac is not None:
                st = self.signal(name)
                with st.lock:
                    y = st.dense()
                cs = signal_coreset_to_size(y, k, float(target_frac))
                eps_eff, how = cs.eps, "built"
            else:
                cs, eps_eff, how = self.get_coreset(name, k, eps or 0.2,
                                                    timeout=timeout,
                                                    deadline=deadline)
            X, y, w = cs.as_points(style=style)
            out = {"k": k, "eps_eff": eps_eff, "served_from": how, "size": cs.size,
                   "blocks": cs.num_blocks, "nbytes": cs.nbytes,
                   "compression_ratio": cs.compression_ratio(),
                   "fingerprint": cs.fingerprint(), "truncated": len(y) > max_points}
            keep = slice(0, max_points)
            out["points"] = {"X": X[keep].tolist(), "y": y[keep].tolist(),
                             "w": w[keep].tolist()}
        self.metrics.inc("queries_compress")
        return out

    # ------------------------------------------------------------- lifecycle
    def sync_autotune_metrics(self) -> None:
        """Fold the autotune module's process-global counters into this
        engine's metrics as ``ops_autotune_*`` (delta since last sync), so
        the Prometheus render and /v1/stats expose cache hit/miss, tune
        runs, and promoted-to-compensated-f32 dispatch counts next to the
        ``ops_backend_*`` series."""
        for name, val in autotune.counters_snapshot().items():
            delta = int(val) - self._autotune_synced.get(name, 0)
            # a zero delta still registers the family, so the very first
            # scrape sees every ops_autotune_* series (at 0) rather than
            # the family popping into existence mid-run
            self.metrics.inc(f"ops_autotune_{name}", max(delta, 0))
            self._autotune_synced[name] = int(val)

    def stats(self) -> dict:
        self.sync_autotune_metrics()
        return {"signals": self.list_signals(), "cache": self.cache.stats(),
                "builds_in_flight": self.scheduler.in_flight(),
                "queries_in_flight": self.queries.in_flight(),
                "query_coalescing": {
                    "enabled": self.coalesce_queries,
                    "window_s": self.queries.window,
                    "max_fuse": self.queries.max_fuse},
                "ops_backends": ops.snapshot(),
                "ops_autotune": autotune.snapshot(),
                "tracing": obs.TRACER.stats(),
                "admission": ({**self.admission.snapshot(),
                               "scheduler_load": {
                                   "builds": self.scheduler.load(),
                                   "queries": self.queries.load()}}
                              if self.admission is not None
                              else {"enabled": False}),
                "metrics": self.metrics.snapshot()}

    def close(self) -> None:
        # drain queries first: a queued loss query may still need the cache
        # and ops dispatch, both of which outlive the schedulers
        self.queries.shutdown()
        self.scheduler.shutdown()
        obs.profile.remove_hook(self._profile_hook)
