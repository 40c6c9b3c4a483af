"""ClusterEngine — the coordinator of the distributed serving plane.

A :class:`~repro_torch.service.engine.CoresetEngine` whose **dense build path**
scatters row-band builds to :class:`~repro_torch.cluster.worker.ShardWorker`
peers instead of the in-process thread pool, and gathers only the tiny
band coresets back (the merge-reduce wire pattern of paper challenge iv —
data stays put, coresets travel).  Everything else — cache, dominance
rule, schedulers, streamed signals, queries — is inherited unchanged, so
a coordinator speaks the exact public v1 API.

Parity is the design invariant: the composed coreset must be **bitwise
fingerprint-equal** to the single-host ``sharded_coreset`` thread-pool
path.  Three shared pieces guarantee it:

  * ``shared_tolerance`` — the coordinator computes the global per-block
    cap from its own full-signal stats, identical float op order;
  * ``band_bounds``       — the same linspace band layout; worker i owns
    band i (round-robin when bands > peers);
  * workers build ``signal_coreset(slab, k, eps, tolerance_override=tol)``
    on the same bytes, and both wire codecs round-trip f64 exactly.

Failure model (degraded mode): an RPC answer of ``no_band`` /
``stale_band`` heals in-line — re-assign the slab (the coordinator always
holds the full signal) and retry once, which is also the entire worker
**rejoin** story.  A transport fault after the client's retries marks the
worker down and the coordinator builds that band **locally with the same
tolerance** — fingerprint-identical output, a 200 response, and only the
``cluster_degraded_builds`` counter knows.  Down workers are skipped for
``reprobe_s`` (no per-request timeout storms), then probed again by the
next build.
"""
from __future__ import annotations

import concurrent.futures as _fut
import threading
import time

import numpy as np

from repro_torch import obs
from repro_torch.core.coreset import SignalCoreset, signal_coreset
from repro_torch.core.sharded import band_bounds, shared_tolerance
from repro_torch.core.streaming import compose
from repro_torch.service.admission import current_ticket
from repro_torch.service.engine import CoresetEngine, SignalState

from .rpc import (WorkerClient, WorkerRPCError, WorkerTransportError,
                  band_hash, coreset_from_msg)

__all__ = ["ClusterEngine"]


class _Peer:
    """One worker endpoint + its health word."""

    __slots__ = ("url", "client", "up", "fails", "down_since", "lock")

    def __init__(self, url: str, client: WorkerClient):
        self.url = url
        self.client = client
        self.up = True          # optimistic: the first build probes for real
        self.fails = 0
        self.down_since = 0.0
        self.lock = threading.Lock()


class ClusterEngine(CoresetEngine):
    def __init__(self, peers: list[str], *, encoding: str = "binary",
                 rpc_timeout: float = 30.0, rpc_retries: int = 2,
                 rpc_backoff: float = 0.05, reprobe_s: float = 1.0, **kw):
        # one band per worker by default: band i lives on worker i, so the
        # layout IS the ownership map (callers may still override num_bands;
        # extra bands round-robin)
        kw.setdefault("num_bands", max(len(peers), 1))
        super().__init__(**kw)
        self._peers = [
            _Peer(url, WorkerClient(url, encoding=encoding,
                                    timeout=rpc_timeout,
                                    retries=rpc_retries,
                                    backoff=rpc_backoff))
            for url in peers]
        self.reprobe_s = float(reprobe_s)
        self.rpc_timeout = float(rpc_timeout)
        # a write and its fan-out to the workers are one step for a build:
        # the re-cache build a dense ingest_delta schedules must not gather
        # before the workers hold the patched rows (it would 409, drop the
        # slab and re-ship the whole band instead of the changed rows)
        self._write_lock = threading.RLock()
        # scatter pool: sized so one build can fan to every peer at once
        # with headroom for a concurrent delta forward
        self._rpc = _fut.ThreadPoolExecutor(
            max_workers=max(2 * max(len(self._peers), 1), 4),
            thread_name_prefix="cluster-rpc")
        for p in self._peers:
            self.metrics.set_gauge("cluster_worker_up", 1.0, worker=p.url)

    # ---------------------------------------------------------------- health
    def _usable(self, peer: _Peer) -> bool:
        """Down workers rest for ``reprobe_s`` — during the cooldown their
        bands degrade to local builds without paying a connect timeout; the
        first build after it probes the worker again (rejoin)."""
        with peer.lock:
            return peer.up or \
                (time.monotonic() - peer.down_since) >= self.reprobe_s

    def _mark_down(self, peer: _Peer) -> None:
        with peer.lock:
            was_up = peer.up
            peer.up = False
            peer.fails += 1
            peer.down_since = time.monotonic()
        self.metrics.set_gauge("cluster_worker_up", 0.0, worker=peer.url)
        if was_up:
            self.metrics.inc("cluster_worker_down_total", worker=peer.url)

    def _mark_up(self, peer: _Peer) -> None:
        with peer.lock:
            was_up = peer.up
            peer.up = True
            peer.fails = 0
        self.metrics.set_gauge("cluster_worker_up", 1.0, worker=peer.url)
        if not was_up:
            self.metrics.inc("cluster_worker_rejoins")

    def probe_workers(self, timeout: float = 2.0) -> dict:
        """Active health sweep (/v1/healthz per peer) — the launch CLI calls
        this once at startup; builds keep health fresh passively after."""
        out = {}
        for peer in self._peers:
            try:
                out[peer.url] = peer.client.healthz(timeout=timeout)
                self._mark_up(peer)
            except Exception as exc:
                out[peer.url] = {"status": "down",
                                 "error": f"{type(exc).__name__}: {exc}"}
                self._mark_down(peer)
        return out

    # ---------------------------------------------------------------- layout
    def _layout(self, n: int) -> list[tuple[int, int]]:
        # the engine's own band heuristic over the canonical linspace split:
        # identical on the single-host comparison engine by construction
        return band_bounds(n, min(self.num_bands, max(1, n // 32)))

    def _owner(self, band_index: int) -> _Peer:
        return self._peers[band_index % len(self._peers)]

    # ---------------------------------------------------------------- ingest
    def register_signal(self, name: str, values: np.ndarray, *,
                        replace: bool = False,
                        tenant: str | None = None) -> dict:
        # admit BEFORE scattering: a refused registration must cost zero
        # worker RPCs.  Requests arriving over HTTP already hold a ticket
        # (api.py admitted them and made it current), so only direct engine
        # callers trigger a fresh decision here — one request, one charge.
        ctl = self.admission
        if ctl is not None and current_ticket() is None:
            with ctl.admit("register", tenant, signal=name):
                return self._register_and_scatter(name, values, replace)
        return self._register_and_scatter(name, values, replace)

    def _register_and_scatter(self, name: str, values: np.ndarray,
                              replace: bool) -> dict:
        with self._write_lock:
            info = super().register_signal(name, values, replace=replace)
            self._scatter(name)
        return info

    def _scatter(self, name: str) -> int:
        """Push every band slab to its owner (best-effort: a failed assign
        only marks the worker down — the build path heals or degrades)."""
        st = self.signal(name)
        with st.lock:
            if st.streamed:
                return 0      # streamed signals build via merge-reduce, local
            y = st.dense_locked()
        layout = self._layout(y.shape[0])
        if len(layout) <= 1 or not self._peers:
            return 0

        def _one(i: int, b0: int, b1: int) -> bool:
            peer = self._owner(i)
            if not self._usable(peer):
                return False
            try:
                peer.client.assign(name, b0, y[b0:b1])
                self._mark_up(peer)
                return True
            except WorkerTransportError:
                self._mark_down(peer)
            except WorkerRPCError:
                pass          # an answer; the build path will heal
            return False

        futs = [self._rpc.submit(_one, i, b0, b1)
                for i, (b0, b1) in enumerate(layout)]
        sent = sum(bool(f.result()) for f in futs)
        if sent:
            self.metrics.inc("cluster_bands_scattered", sent)
        return sent

    def ingest_delta(self, name: str, band, *, row0: int | None = None,
                     row0s: list | None = None,
                     rows: list | None = None) -> dict:
        with self._write_lock:
            return self._ingest_and_forward(name, band, row0, row0s, rows)

    def _ingest_and_forward(self, name: str, band, row0, row0s,
                            rows) -> dict:
        out = super().ingest_delta(name, band, row0=row0, row0s=row0s,
                                   rows=rows)
        # forward only dense replaces: appends flip the signal streamed,
        # which routes builds through local merge-reduce — workers hold no
        # role there (their stale slabs die on the next dense build's heal)
        if out["streamed"] or not self._peers:
            return out
        st = self.signal(name)
        with st.lock:
            if st.streamed or st.version != out["version"]:
                return out    # racing writer; its own forward covers the rest
            y = st.dense_locked()
        if row0s is not None:
            splits = np.split(np.ascontiguousarray(band, np.float64),
                              np.cumsum([int(r) for r in rows])[:-1], axis=0)
            deltas = [(int(r0), p.shape[0]) for r0, p in zip(row0s, splits)]
        else:
            deltas = [(int(row0), int(out["rows"]))]
        self._forward_deltas(name, y, deltas)
        return out

    def _forward_deltas(self, name: str, y: np.ndarray,
                        deltas: list[tuple[int, int]]) -> None:
        """Send each owner only its intersection with the changed rows plus
        the expected post-patch slab hash (O(changed rows) on the wire; a
        re-assign ships the whole band).  Failures self-heal at build."""
        layout = self._layout(y.shape[0])
        if len(layout) <= 1:
            return
        jobs = []   # (band index, slab-absolute r0, r1)
        for i, (b0, b1) in enumerate(layout):
            touched: list[tuple[int, int]] = []
            for r0, nrows in deltas:
                lo, hi = max(r0, b0), min(r0 + nrows, b1)
                if lo < hi:
                    touched.append((lo, hi))
            if touched:
                # one merged window per band keeps it a single RPC
                lo = min(t[0] for t in touched)
                hi = max(t[1] for t in touched)
                jobs.append((i, lo, hi))

        def _one(i: int, lo: int, hi: int) -> bool:
            peer = self._owner(i)
            if not self._usable(peer):
                return False
            b0, b1 = layout[i]
            slab_hash = band_hash(y[b0:b1])
            try:
                try:
                    peer.client.delta(name, lo, y[lo:hi], slab_hash)
                except WorkerRPCError as exc:
                    if exc.code not in ("no_band", "stale_band"):
                        raise
                    # worker missed a prior write (or is freshly restarted):
                    # ship the whole current slab instead
                    peer.client.assign(name, b0, y[b0:b1])
                    self.metrics.inc("cluster_band_heals", code=exc.code)
                self._mark_up(peer)
                return True
            except WorkerTransportError:
                self._mark_down(peer)
            except WorkerRPCError:
                pass
            return False

        futs = [self._rpc.submit(_one, *job) for job in jobs]
        sent = sum(bool(f.result()) for f in futs)
        if sent:
            self.metrics.inc("cluster_deltas_forwarded", sent)

    # ----------------------------------------------------------------- build
    def _build_dense(self, st: SignalState, k: int, eps: float,
                     ) -> tuple[SignalCoreset, float, str]:
        with self._write_lock, st.lock:
            y = st.dense_locked()
            version = st.version
        n = y.shape[0]
        layout = self._layout(n)
        if len(layout) <= 1 or not self._peers:
            return super()._build_dense(st, k, eps)
        # the one full-signal computation the coordinator keeps: the global
        # sigma estimate -> shared per-block cap (reusing the delta-patched
        # integral images when a delta write already materialized them)
        ps = st.stats_snapshot(version)
        tol = shared_tolerance(y, k, eps, _stats=ps)
        t0 = time.perf_counter()
        with obs.span("cluster.gather", signal=st.name, k=int(k),
                      bands=len(layout)) as g:
            futs = [self._rpc.submit(self._band_part, g, st.name, y,
                                     i, b0, b1, k, eps, tol)
                    for i, (b0, b1) in enumerate(layout)]
            results = [f.result() for f in futs]
            for _, peer_ctx in results:
                if g and peer_ctx is not None:
                    # fan-in visibility: the gather span links every worker
                    # root, so GET /v1/trace/{id} resolves the remote hops
                    g.add_link(peer_ctx)
        self.metrics.observe("cluster_gather", time.perf_counter() - t0,
                             exemplar=g.trace_id if g else None)
        self.metrics.inc("cluster_gathers")
        cs = compose([part for part, _ in results],
                     [b0 for b0, _ in layout], n_total=n)
        return cs, eps, version   # composition of disjoint bands is exact

    def _band_part(self, gather_span, name: str, y: np.ndarray, i: int,
                   b0: int, b1: int, k: int, eps: float, tol: float):
        """One band's coreset: worker RPC with heal-retry, or the local
        degraded build.  Returns (coreset, worker SpanContext | None)."""
        peer = self._owner(i)
        slab = y[b0:b1]
        if not self._usable(peer):
            return self._local_part(slab, k, eps, tol), None
        slab_hash = band_hash(slab)
        deadline = time.perf_counter() + self.rpc_timeout
        # re-enter the request's trace on this pool thread so the rpc span
        # parents under the gather and the client stamps its traceparent
        with obs.attach(gather_span), \
                obs.span("cluster.rpc", worker=peer.url, row0=int(b0),
                         rows=int(b1 - b0)) as sp:
            t0 = time.perf_counter()
            try:
                msg = None
                for attempt in (0, 1):
                    try:
                        msg = peer.client.build(name, b0, b1 - b0, slab_hash,
                                                k, eps, tol,
                                                deadline=deadline)
                        break
                    except WorkerRPCError as exc:
                        if attempt == 0 and exc.code in ("no_band",
                                                         "stale_band"):
                            # the heal path doubles as rejoin: a restarted
                            # worker 404s, gets its slab, serves the retry
                            peer.client.assign(name, b0, slab,
                                               deadline=deadline)
                            self.metrics.inc("cluster_band_heals",
                                             code=exc.code)
                            continue
                        raise
                self._mark_up(peer)
                # last_peer_span is safe here: one in-flight RPC per client
                # (band i -> worker i % P; same-worker bands run serially
                # only when bands > pool, still one result read per call)
                peer_ctx = peer.client.last_peer_span
                dt = time.perf_counter() - t0
                self.metrics.observe("cluster_rpc", dt, worker=peer.url,
                                     exemplar=sp.trace_id if sp else None)
                self.metrics.inc("cluster_rpc_total", worker=peer.url,
                                 outcome="ok")
                if msg.cache == "hit":
                    self.metrics.inc("cluster_band_cache_hits")
                if sp:
                    sp.set_attr("cache", msg.cache)
                    sp.set_attr("worker_id", msg.worker_id)
                return coreset_from_msg(msg), peer_ctx
            except WorkerTransportError as exc:
                if sp:
                    sp.set_attr("error", str(exc))
                self._mark_down(peer)
                self.metrics.inc("cluster_rpc_total", worker=peer.url,
                                 outcome="transport_error")
                return self._local_part(slab, k, eps, tol), None
            except WorkerRPCError as exc:
                # an unexpected *answer* (not no_band/stale_band): the
                # worker is alive but cannot serve this band — degrade
                # without declaring it down
                if sp:
                    sp.set_attr("error", str(exc))
                self.metrics.inc("cluster_rpc_total", worker=peer.url,
                                 outcome=f"http_{exc.http}")
                return (self._local_part(slab, k, eps, tol),
                        peer.client.last_peer_span)

    def _local_part(self, slab: np.ndarray, k: int, eps: float,
                    tol: float) -> SignalCoreset:
        """Degraded-mode band build: same bytes, same shared tolerance ->
        bitwise the coreset the worker would have returned.  Clients see a
        normal 200; only the counter records the downgrade."""
        self.metrics.inc("cluster_degraded_builds")
        return signal_coreset(slab, int(k), float(eps),
                              tolerance_override=float(tol))

    # ------------------------------------------------------------- lifecycle
    def stats(self) -> dict:
        out = super().stats()
        m = self.metrics
        out["cluster"] = {
            "role": "coordinator",
            "num_bands": self.num_bands,
            "peers": [{"url": p.url, "up": bool(p.up),
                       "fails": int(p.fails)} for p in self._peers],
            "gathers": m.get("cluster_gathers"),
            "bands_scattered": m.get("cluster_bands_scattered"),
            "deltas_forwarded": m.get("cluster_deltas_forwarded"),
            "degraded_builds": m.get("cluster_degraded_builds"),
            "band_cache_hits": m.get("cluster_band_cache_hits"),
            "worker_rejoins": m.get("cluster_worker_rejoins"),
            # coordinator-cache re-anchors (appends to streamed signals ride
            # the inherited engine fast path); the per-band analogue lives
            # worker-side as worker_band_cache_purged — a delta drops ONLY
            # the owning worker's content-addressed entries
            "cache_reanchored": m.get("cache_reanchored"),
            "reanchor_candidates": m.get("cache_reanchor_candidates"),
        }
        return out

    def close(self) -> None:
        self._rpc.shutdown(wait=False, cancel_futures=True)
        super().close()
