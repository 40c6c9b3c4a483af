"""ShardWorker — owns one row-band slab of every registered signal.

The paper's construction is embarrassingly band-parallel: a band's coreset
is a pure function of (band bytes, k, eps, tolerance_override), and
coresets of disjoint bands compose exactly (streaming.py).  A worker is
therefore tiny state + one hot function:

  * per signal: the band slab (raw rows it owns), its blake2b content
    hash, and the band's three integral images (``PrefixStats``) —
    materialized once at assignment through the dispatched
    ``sat_moments`` op and **delta-patched** through the dispatched
    ``delta_sat`` op on every ``band:delta`` (O(changed rows), bitwise
    identical to a from-scratch SAT on the f64 oracle).  On the card these
    are the ``sat_moments_f64`` and ``sat_delta_f64`` kernels;
  * a small LRU of built band coresets keyed by (slab hash, k, eps,
    tolerance) — repeat gathers for a cached spec cost one dict hit.

Consistency is content-addressed (see rpc.py): every request names the
slab hash it expects.  A mismatch 409s ``stale_band`` AND drops the slab —
a worker that missed a write must force a re-assign rather than serve a
coreset of stale bytes; an unknown band 404s ``no_band`` into the same
coordinator heal path, which is also the whole rejoin story.

The HTTP server speaks the same wire conventions as ``service.api``:
protocol frames in both codecs, the uniform error envelope, W3C
``traceparent`` continuation (the coordinator's trace id spans the hop)
and ``X-Coreset-Trace-Id`` on every response **including errors**.
In-process servers (tests) take a private ``Tracer`` — two roots of one
trace id must not share a ring buffer — while a worker subprocess uses the
global ``obs.TRACER`` like any other process.
"""
from __future__ import annotations

import collections
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch import obs
from repro_torch.core.coreset import SignalCoreset, signal_coreset
from repro_torch.core.stats import PrefixStats
from repro_torch.service import protocol as P
from repro_torch.service.api import ApiError
from repro_torch.service.metrics import ServiceMetrics

from .rpc import (BandAck, BandAssignRequest, BandBuildRequest,
                  BandCoresetResponse, BandDeltaRequest, band_hash,
                  coreset_to_msg)

__all__ = ["ShardWorker", "make_worker_server"]

_MAX_BODY = 256 << 20


class _BandState:
    """One owned slab: bytes, content hash, delta-patched PrefixStats."""

    __slots__ = ("row0", "band", "hash", "stats", "lock")

    def __init__(self, row0: int, band: np.ndarray):
        self.row0 = int(row0)
        self.band = np.ascontiguousarray(band, np.float64)
        self.hash = band_hash(self.band)
        # the band's own integral images; every build reuses them (the
        # _stats seam of signal_coreset) and every delta patches them
        self.stats = PrefixStats.build(self.band)
        self.lock = threading.RLock()


class ShardWorker:
    MAX_CACHE = 32   # built band coresets are KB-scale; small LRU suffices

    def __init__(self, worker_id: str = "w0",
                 metrics: ServiceMetrics | None = None,
                 tracer: obs.Tracer | None = None):
        self.worker_id = worker_id
        self.metrics = metrics or ServiceMetrics()
        # spans must record into the SAME tracer the HTTP handler roots the
        # request trace in (make_worker_server aligns this) — in-process
        # test workers use a private tracer precisely so their spans never
        # land in the coordinator's ring buffer
        self.tracer = tracer or obs.TRACER
        self._bands: dict[str, _BandState] = {}
        self._lock = threading.Lock()
        # (signal, slab_hash, k, eps, tolerance) -> SignalCoreset
        self._cache: "collections.OrderedDict[tuple, SignalCoreset]" = \
            collections.OrderedDict()
        self._cache_lock = threading.Lock()

    # ----------------------------------------------------------------- state
    def _band(self, name: str) -> _BandState:
        with self._lock:
            st = self._bands.get(name)
        if st is None:
            raise ApiError(404, "no_band",
                           f"worker {self.worker_id} holds no band of "
                           f"signal {name!r}")
        return st

    def _drop(self, name: str) -> None:
        with self._lock:
            self._bands.pop(name, None)

    def _purge_stale(self, name: str, keep_hash: str) -> int:
        """Per-band cache invalidation: drop this signal's LRU entries
        built against any slab hash other than ``keep_hash``.  The cache
        key is content-addressed, so a delta to THIS worker's slab only
        ever strands this worker's entries — the coordinator's other band
        workers keep serving their (unchanged) band coresets from cache,
        the cluster analogue of the engine's row-span re-anchor rule."""
        with self._cache_lock:
            dead = [key for key in self._cache
                    if key[0] == name and key[1] != keep_hash]
            for key in dead:
                del self._cache[key]
        if dead:
            self.metrics.inc("worker_band_cache_purged", len(dead))
        return len(dead)

    def assign(self, msg: BandAssignRequest) -> BandAck:
        band = np.ascontiguousarray(msg.band, np.float64)
        if band.ndim != 2 or band.size == 0:
            raise ApiError(400, "bad_request",
                           "band must be a non-empty 2-D array")
        st = _BandState(msg.row0, band)
        if msg.band_hash and st.hash != msg.band_hash:
            raise ApiError(400, "bad_request",
                           f"assigned slab hashes {st.hash}, coordinator "
                           f"declared {msg.band_hash} (corrupt frame?)")
        with self._lock:
            self._bands[msg.signal.name] = st
        self._purge_stale(msg.signal.name, st.hash)
        self.metrics.inc("worker_bands_assigned")
        self.metrics.set_gauge("worker_bands_held", len(self._bands))
        return self._ack(msg.signal.name, st)

    def delta(self, msg: BandDeltaRequest) -> BandAck:
        st = self._band(msg.signal.name)
        rows = msg.band.shape[0]
        with st.lock:
            r0 = int(msg.row0) - st.row0      # signal-absolute -> slab-local
            if not (0 <= r0 and r0 + rows <= st.band.shape[0]):
                raise ApiError(
                    409, "stale_band",
                    f"delta rows [{msg.row0}, {msg.row0 + rows}) fall "
                    f"outside this worker's slab "
                    f"[{st.row0}, {st.row0 + st.band.shape[0]})")
            if msg.band.shape[1] != st.band.shape[1]:
                raise ApiError(400, "bad_request",
                               f"delta has {msg.band.shape[1]} columns, "
                               f"slab has {st.band.shape[1]}")
            # patch a FRESH slab (a concurrent build may still be reading
            # the old array outside the lock), then the integral images in
            # O(suffix) through the dispatched delta_sat op
            slab = np.array(st.band, np.float64, copy=True)
            slab[r0:r0 + rows] = msg.band
            new_hash = band_hash(slab)
            if new_hash != msg.band_hash:
                # pre-state was stale: this worker missed an earlier write.
                # Serving from it would be silently wrong — drop the slab
                # and force the coordinator's re-assign heal path.
                self._drop(msg.signal.name)
                self.metrics.inc("worker_stale_bands_dropped")
                raise ApiError(
                    409, "stale_band",
                    f"post-patch slab hashes {new_hash}, coordinator "
                    f"expects {msg.band_hash} — slab dropped, re-assign")
            st.band = slab
            st.stats = st.stats.patch_rows(r0, slab[r0:], copy=True)
            st.hash = new_hash
        self._purge_stale(msg.signal.name, new_hash)
        self.metrics.inc("worker_deltas_applied")
        return self._ack(msg.signal.name, st)

    def _ack(self, name: str, st: _BandState) -> BandAck:
        return BandAck(signal=name, row0=st.row0,
                       rows=int(st.band.shape[0]),
                       m=int(st.band.shape[1]), band_hash=st.hash,
                       worker_id=self.worker_id)

    # ----------------------------------------------------------------- build
    def build(self, msg: BandBuildRequest) -> BandCoresetResponse:
        st = self._band(msg.signal.name)
        with st.lock:
            if st.hash != msg.band_hash:
                self._drop(msg.signal.name)
                self.metrics.inc("worker_stale_bands_dropped")
                raise ApiError(
                    409, "stale_band",
                    f"slab hashes {st.hash}, coordinator expects "
                    f"{msg.band_hash} — slab dropped, re-assign")
            band, stats, slab_hash = st.band, st.stats, st.hash
        key = (msg.signal.name, slab_hash, int(msg.k), float(msg.eps),
               float(msg.tolerance_override))
        with self._cache_lock:
            cs = self._cache.get(key)
            if cs is not None:
                self._cache.move_to_end(key)
        if cs is not None:
            self.metrics.inc("worker_build_cache_hits")
            return coreset_to_msg(cs, cache="hit", worker_id=self.worker_id)
        # the hot function: bitwise the thread-pool path's per-band build
        # (same bytes, same k/eps, same shared tolerance; the delta-patched
        # stats are bitwise a from-scratch SAT, see core/stats.py)
        with self.tracer.span("worker.band_build", signal=msg.signal.name,
                              k=int(msg.k), rows=int(band.shape[0])), \
                self.metrics.timed("worker_band_build"):
            cs = signal_coreset(band, int(msg.k), float(msg.eps),
                                tolerance_override=float(
                                    msg.tolerance_override),
                                _stats=stats)
        with self._cache_lock:
            self._cache[key] = cs
            while len(self._cache) > self.MAX_CACHE:
                self._cache.popitem(last=False)
        self.metrics.inc("worker_band_builds")
        return coreset_to_msg(cs, cache="built", worker_id=self.worker_id)

    # ------------------------------------------------------------ telemetry
    def status(self) -> dict:
        with self._lock:
            bands = {name: {"row0": st.row0, "rows": int(st.band.shape[0]),
                            "m": int(st.band.shape[1]), "hash": st.hash}
                     for name, st in self._bands.items()}
        return {"status": "ok", "role": "worker",
                "worker_id": self.worker_id, "bands": bands,
                "uptime_s": self.metrics.uptime_s()}


# ----------------------------------------------------------------- transport
_WORKER_POST = {
    "/v1/worker/band:assign": (BandAssignRequest, ShardWorker.assign),
    "/v1/worker/band:delta": (BandDeltaRequest, ShardWorker.delta),
    "/v1/worker/band:build": (BandBuildRequest, ShardWorker.build),
}


class _WorkerHandler(BaseHTTPRequestHandler):
    worker: ShardWorker            # set by make_worker_server
    tracer: obs.Tracer             # global for subprocess, private in-process
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 - metrics carry the signal
        pass

    def _reply(self, code: int, body: bytes, content_type: str,
               span) -> None:
        if code >= 400:
            self.close_connection = True
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        if span:
            # every response — error envelopes included — names the trace
            # it ran under; the coordinator links this context into its
            # gather span, so fan-in is visible from /v1/trace/{id}
            self.send_header("traceparent",
                             obs.format_traceparent(span.trace_id,
                                                    span.span_id))
            self.send_header("X-Coreset-Trace-Id", span.trace_id)
        self.end_headers()
        self.wfile.write(body)

    def _reply_msg(self, code: int, msg: P._Wire, encoding: str, span):
        codec = None
        if encoding == "binary":
            codec = P._Wire.accept_codec(self.headers.get("Accept", ""))
            if codec == "zstd" and P.zstandard is None:
                codec = "zlib"
        ctype, body = msg.to_wire(encoding, binary_codec=codec)
        self._reply(code, body, ctype, span)

    def _error(self, http: int, code: str, message: str, span) -> None:
        env = P.ErrorResponse(error=P.ErrorInfo(code=code, message=message))
        self._reply_msg(http, env, "json", span)

    def do_GET(self):  # noqa: N802
        path = self.path.partition("?")[0].rstrip("/")
        root = self.tracer.start_trace(
            "GET /v1/healthz",
            traceparent=self.headers.get("traceparent"))
        try:
            if path == "/v1/healthz":
                body = json.dumps(self.worker.status()).encode()
                self._reply(200, body, "application/json", root)
            elif path == "/v1/metrics":
                self._reply(200, self.worker.metrics.render().encode(),
                            "text/plain; version=0.0.4", root)
            else:
                self._error(404, "not_found", f"no route GET {path}", root)
        finally:
            if root:
                root.end()

    def do_POST(self):  # noqa: N802
        w = self.worker
        path = self.path.partition("?")[0].rstrip("/")
        route = _WORKER_POST.get(path)
        metric_route = f"POST {path}" if route else "POST <unmatched>"
        t0 = time.perf_counter()
        # continue the coordinator's trace: the scatter/gather is ONE trace
        root = self.tracer.start_trace(
            metric_route, traceparent=self.headers.get("traceparent"))
        status = 500
        try:
            with self.tracer.attach(root):
                if route is None:
                    status = 404
                    self._error(404, "not_found",
                                f"no route POST {path}", root)
                    return
                length = int(self.headers.get("Content-Length", 0))
                if length > _MAX_BODY:
                    raise ApiError(413, "payload_too_large",
                                   f"body of {length} bytes exceeds "
                                   f"{_MAX_BODY}")
                raw = self.rfile.read(length) if length else b""
                msg_cls, method = route
                msg = P.decode(self.headers.get("Content-Type", ""), raw,
                               expect=msg_cls)
                out_enc = ("binary" if P.CONTENT_TYPE_BINARY in
                           self.headers.get("Accept", "") else "json")
                resp = method(w, msg)
                status = 200
                self._reply_msg(200, resp, out_enc, root)
        except ApiError as exc:
            status = exc.http
            self._error(exc.http, exc.code, str(exc), root)
        except P.UnsupportedCodec as exc:
            status = 415
            self._error(415, "unsupported_media", str(exc), root)
        except (P.ProtocolError, ValueError, TypeError) as exc:
            status = 400
            self._error(400, "bad_request",
                        f"{type(exc).__name__}: {exc}", root)
        except Exception as exc:  # pragma: no cover - defensive 500
            status = 500
            self._error(500, "internal", f"{type(exc).__name__}: {exc}",
                        root)
        finally:
            if root:
                root.set_attr("http.status", status)
                root.end()
            w.metrics.inc(f"worker_http_{status}")
            w.metrics.observe(f"http {metric_route}",
                              time.perf_counter() - t0,
                              exemplar=root.trace_id if root else None)


def make_worker_server(worker: ShardWorker, host: str = "127.0.0.1",
                       port: int = 0, *,
                       tracer: obs.Tracer | None = None,
                       ) -> ThreadingHTTPServer:
    """Bind the worker's RPC server; port 0 = ephemeral.

    ``tracer``: pass a private :class:`obs.Tracer` when the worker runs
    IN-PROCESS with its coordinator (tests) — continuing a trace id that is
    active in the same ring buffer would collide with the coordinator's
    root.  Worker subprocesses keep the default global tracer.
    """
    if tracer is not None:
        worker.tracer = tracer    # worker spans join the handler's traces
    handler = type("ShardWorkerHandler", (_WorkerHandler,), {
        "worker": worker, "tracer": tracer or worker.tracer})
    srv = _WorkerServer((host, port), handler)
    return srv


class _WorkerServer(ThreadingHTTPServer):
    daemon_threads = True
    # the coordinator's gather fans a band RPC per signal band at once (and
    # retries fast on failure); socketserver's default backlog of 5 turns
    # accept-loop lag into kernel RSTs, so give the listen queue real depth
    request_queue_size = 128
