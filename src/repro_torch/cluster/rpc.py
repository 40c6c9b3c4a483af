"""Cluster RPC vocabulary + worker client (coordinator -> ShardWorker).

The worker RPC rides the SAME v1 wire machinery as the public API: messages
are ``service.protocol`` dataclasses registered under their own kinds, so
they inherit the JSON / npz+zstd frame codecs, the ``Accept`` negotiation,
the decompression bomb ceiling, and the uniform error envelope for free.
Four messages cover the whole worker surface:

  ``band_assign``   the coordinator hands a worker its row-band slab of a
                    signal (full bytes — registration / re-scatter);
  ``band_delta``    only the changed rows of a slab cross the wire (the
                    ``ingest:delta`` fan-out) — the worker patches its slab
                    and delta-patches its band ``PrefixStats`` in O(rows);
  ``band_build``    "build YOUR band's coreset under this shared
                    tolerance" — the k/eps/tolerance_override triple is
                    coordinator-computed so every band build (remote or
                    thread-pool) caps blocks identically;
  ``band_coreset``  the tiny coreset back: a few KB of block arrays
                    instead of the band's MBs — the merge-reduce gather.

Consistency is content-addressed, not versioned: every band-touching
request carries ``band_hash`` — blake2b of the slab bytes the coordinator
*expects* the worker to hold (post-patch for deltas).  A worker whose slab
hashes differently answers 409 ``stale_band`` and drops the slab; the
coordinator heals by re-assigning the band (it always holds the full
signal) and retrying.  A restarted, empty worker 404s ``no_band`` into the
same heal path — rejoin needs no handshake beyond the next build.

:class:`WorkerClient` is the coordinator-side stub: binary frames by
default, retry with exponential backoff on transport faults only (API
errors are answers, not faults), a per-RPC deadline inherited from the
request's ``deadline_ms``, and W3C ``traceparent`` injection from the
*current span* so one trace spans the scatter/gather (the worker
continues the coordinator's trace id).

Every frame encodes byte for byte as the reference package's
``repro.cluster.rpc`` does.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import urllib.error
import urllib.request

import numpy as np

from repro_torch import obs
from repro_torch.core.bicriteria import BicriteriaResult
from repro_torch.core.coreset import SignalCoreset
from repro_torch.service import protocol as P

__all__ = [
    "BandAssignRequest", "BandDeltaRequest", "BandBuildRequest", "BandAck",
    "BandCoresetResponse", "WorkerRPCError", "WorkerTransportError",
    "WorkerClient", "band_hash", "coreset_to_msg", "coreset_from_msg",
]


def band_hash(band: np.ndarray) -> str:
    """Content address of a band slab (the cluster's consistency token) —
    the same blake2b family the engine's version fold uses."""
    return hashlib.blake2b(np.ascontiguousarray(band, np.float64).tobytes(),
                           digest_size=12).hexdigest()


# ------------------------------------------------------------------ messages
@P._message("band_assign")
class BandAssignRequest(P._Wire):
    """Full band slab hand-off: worker becomes the owner of rows
    [row0, row0 + band.shape[0]) of ``signal``."""
    signal: P.SignalRef
    row0: int
    band: np.ndarray                       # (rows, m) the slab bytes
    band_hash: str                         # blake2b of the slab (integrity)
    _NESTED = {"signal": P.SignalRef}
    _COERCE = {"band": P._arr(np.float64, ndim=2)}


@P._message("band_delta")
class BandDeltaRequest(P._Wire):
    """Changed rows only.  ``row0`` is SIGNAL-absolute; the worker maps it
    into its slab and delta-patches slab + PrefixStats.  ``band_hash`` is
    the expected hash of the WHOLE slab after the patch — a mismatch means
    the worker's pre-state was stale (it missed an earlier write), and the
    worker must drop the slab rather than serve silently wrong coresets."""
    signal: P.SignalRef
    row0: int
    band: np.ndarray                       # (rows, m) replacement rows
    band_hash: str                         # post-patch slab hash
    _NESTED = {"signal": P.SignalRef}
    _COERCE = {"band": P._arr(np.float64, ndim=2)}


@P._message("band_build")
class BandBuildRequest(P._Wire):
    """Build the band coreset under the coordinator's SHARED tolerance.

    ``tolerance_override`` is the global ``eps^2 * sigma / k`` cap from
    ``core.sharded.shared_tolerance`` — computed once at the coordinator
    (it owns the full-signal integral images), so remote band builds are
    bitwise the thread-pool path's ``signal_coreset(y[b0:b1], k, eps,
    tolerance_override=tol)``."""
    signal: P.SignalRef
    row0: int
    rows: int
    band_hash: str                         # expected slab hash (consistency)
    k: int
    eps: float
    tolerance_override: float
    deadline_ms: float | None = None
    _NESTED = {"signal": P.SignalRef}


@P._message("band_ack")
class BandAck(P._Wire):
    """Assignment / delta acknowledgement."""
    signal: str
    row0: int
    rows: int
    m: int
    band_hash: str
    worker_id: str


@P._message("band_coreset")
class BandCoresetResponse(P._Wire):
    """A serialized band ``SignalCoreset`` — the only thing the gather
    moves.  Arrays keep their exact dtypes through both codecs (npz stores
    raw IEEE bytes; JSON floats round-trip via shortest-repr), so the
    composed fingerprint is bitwise stable across the wire."""
    n: int
    m: int
    k: int
    eps: float
    rects: np.ndarray                      # (B, 4) int64
    labels: np.ndarray                     # (B, 4) float64
    weights: np.ndarray                    # (B, 4) float64
    moments: np.ndarray                    # (B, 3) float64
    sigma: float
    tolerance: float
    max_slices: int
    build_seconds: float
    certified: bool
    bicriteria: dict                       # BicriteriaResult fields (scalars)
    cache: str = "built"                   # built | hit (worker-side cache)
    worker_id: str = ""
    _COERCE = {"rects": P._arr(np.int64, ndim=2),
               "labels": P._arr(np.float64, ndim=2),
               "weights": P._arr(np.float64, ndim=2),
               "moments": P._arr(np.float64, ndim=2)}


def coreset_to_msg(cs: SignalCoreset, *, cache: str = "built",
                   worker_id: str = "") -> BandCoresetResponse:
    return BandCoresetResponse(
        n=int(cs.n), m=int(cs.m), k=int(cs.k), eps=float(cs.eps),
        rects=np.ascontiguousarray(cs.rects, np.int64),
        labels=np.ascontiguousarray(cs.labels, np.float64),
        weights=np.ascontiguousarray(cs.weights, np.float64),
        moments=np.ascontiguousarray(cs.moments, np.float64),
        sigma=float(cs.sigma), tolerance=float(cs.tolerance),
        max_slices=int(cs.max_slices),
        build_seconds=float(cs.build_seconds), certified=bool(cs.certified),
        bicriteria=dataclasses.asdict(cs.bicriteria),
        cache=cache, worker_id=worker_id)


def coreset_from_msg(msg: BandCoresetResponse) -> SignalCoreset:
    bic = BicriteriaResult(**{
        f.name: msg.bicriteria[f.name]
        for f in dataclasses.fields(BicriteriaResult)
        if f.name in msg.bicriteria})
    return SignalCoreset(
        n=int(msg.n), m=int(msg.m), k=int(msg.k), eps=float(msg.eps),
        rects=np.ascontiguousarray(msg.rects, np.int64),
        labels=np.ascontiguousarray(msg.labels, np.float64),
        weights=np.ascontiguousarray(msg.weights, np.float64),
        moments=np.ascontiguousarray(msg.moments, np.float64),
        sigma=float(msg.sigma), tolerance=float(msg.tolerance),
        max_slices=int(msg.max_slices), bicriteria=bic,
        build_seconds=float(msg.build_seconds), certified=bool(msg.certified))


# -------------------------------------------------------------------- client
class WorkerRPCError(Exception):
    """Structured error from a worker's v1 envelope (an *answer* — never
    retried).  ``code`` drives the coordinator's healing: ``no_band`` /
    ``stale_band`` mean re-assign and retry the build."""

    def __init__(self, http: int, code: str, message: str,
                 trace_id: str | None = None):
        tail = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(f"[{http} {code}] {message}{tail}")
        self.http = http
        self.code = code
        self.message = message
        self.trace_id = trace_id


class WorkerTransportError(Exception):
    """Worker unreachable after exhausting retries — the health tracker's
    down signal."""


class WorkerClient:
    """Stub for one ShardWorker.  Thread-safe (no mutable request state
    beyond the codec downgrade flag, which only ever goes binary->zlib)."""

    def __init__(self, base_url: str, *, encoding: str = "binary",
                 timeout: float = 30.0, retries: int = 2,
                 backoff: float = 0.05):
        self.base_url = base_url.rstrip("/")
        self.encoding = encoding
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        # last worker root-span context seen on a response: the gather span
        # links it so fan-in shows up in /v1/trace/{id}
        self.last_peer_span: obs.SpanContext | None = None

    # ---------------------------------------------------------- raw request
    def _headers(self, content_type: str) -> dict:
        if self.encoding == "binary":
            codec = "zstd" if P.zstandard is not None else "zlib"
            accept = f"{P.CONTENT_TYPE_BINARY};codec={codec}"
        else:
            accept = P.CONTENT_TYPE_JSON
        headers = {"Accept": accept, "Content-Type": content_type}
        # propagate the CURRENT span, not a fresh trace: the worker hop is
        # part of the request's trace (one trace id across the RPC)
        sp = obs.current_span()
        if sp:
            headers["traceparent"] = obs.format_traceparent(sp.trace_id,
                                                            sp.span_id)
        return headers

    def _note_peer(self, headers) -> None:
        ctx = obs.parse_traceparent(
            headers.get("traceparent") if headers is not None else None)
        self.last_peer_span = (obs.SpanContext(*ctx) if ctx is not None
                               else None)

    def call(self, path: str, msg: P._Wire, expect: type, *,
             deadline: float | None = None):
        """POST ``msg``, return the decoded ``expect`` response.

        ``deadline`` is an absolute ``time.perf_counter()`` instant (the
        engine's representation): each attempt's socket timeout is clipped
        to the time remaining, and an expired deadline fails fast with
        :class:`WorkerTransportError` instead of opening a doomed socket.
        """
        attempt = 0
        while True:
            budget = self.timeout
            if deadline is not None:
                budget = min(budget, deadline - time.perf_counter())
                if budget <= 0:
                    raise WorkerTransportError(
                        f"deadline expired before {path}")
            ctype, body = msg.to_wire(self.encoding)
            req = urllib.request.Request(self.base_url + path, data=body,
                                         headers=self._headers(ctype),
                                         method="POST")
            try:
                with urllib.request.urlopen(req, timeout=budget) as resp:
                    self._note_peer(resp.headers)
                    raw = resp.read()
                    return P.decode(resp.headers.get("Content-Type", ""),
                                    raw, expect=expect)
            except urllib.error.HTTPError as exc:
                raw = exc.read()
                self._note_peer(exc.headers)
                tid = exc.headers.get("X-Coreset-Trace-Id") \
                    if exc.headers is not None else None
                try:
                    env = P.decode(exc.headers.get("Content-Type", ""),
                                   raw, expect=P.ErrorResponse)
                    raise WorkerRPCError(exc.code, env.error.code,
                                         env.error.message, tid) from None
                except P.ProtocolError:
                    raise WorkerRPCError(
                        exc.code, "unknown",
                        raw[:256].decode("utf-8", "replace"), tid) from None
            except (urllib.error.URLError, TimeoutError, ConnectionError,
                    OSError) as exc:
                last = WorkerTransportError(f"{type(exc).__name__}: {exc}")
            if attempt >= self.retries:
                raise last
            time.sleep(self.backoff * (2 ** attempt))
            attempt += 1

    # ------------------------------------------------------------ rpc verbs
    def assign(self, name: str, row0: int, band: np.ndarray, *,
               deadline: float | None = None) -> BandAck:
        msg = BandAssignRequest(signal=P.SignalRef(name=name), row0=int(row0),
                                band=np.ascontiguousarray(band, np.float64),
                                band_hash=band_hash(band))
        return self.call("/v1/worker/band:assign", msg, BandAck,
                         deadline=deadline)

    def delta(self, name: str, row0: int, band: np.ndarray,
              slab_hash: str, *, deadline: float | None = None) -> BandAck:
        msg = BandDeltaRequest(signal=P.SignalRef(name=name), row0=int(row0),
                               band=np.ascontiguousarray(band, np.float64),
                               band_hash=slab_hash)
        return self.call("/v1/worker/band:delta", msg, BandAck,
                         deadline=deadline)

    def build(self, name: str, row0: int, rows: int, slab_hash: str,
              k: int, eps: float, tolerance_override: float, *,
              deadline: float | None = None) -> BandCoresetResponse:
        ms = None if deadline is None else \
            max((deadline - time.perf_counter()) * 1e3, 0.0)
        msg = BandBuildRequest(signal=P.SignalRef(name=name), row0=int(row0),
                               rows=int(rows), band_hash=slab_hash,
                               k=int(k), eps=float(eps),
                               tolerance_override=float(tolerance_override),
                               deadline_ms=ms)
        return self.call("/v1/worker/band:build", msg, BandCoresetResponse,
                         deadline=deadline)

    def healthz(self, *, timeout: float | None = None) -> dict:
        import json
        req = urllib.request.Request(self.base_url + "/v1/healthz",
                                     headers=self._headers("") or {})
        with urllib.request.urlopen(
                req, timeout=timeout or self.timeout) as resp:
            self._note_peer(resp.headers)
            return json.loads(resp.read())
