"""Versioned HTTP front for the CoresetEngine (v1 typed protocol).

``http.server.ThreadingHTTPServer`` — one OS thread per connection; the
numpy-heavy work releases the GIL and builds are bounded by the scheduler's
worker pool, so a plain threading server sustains the closed-loop loadgen
without an async stack (and without any non-baked-in dependency).

v1 routes (bodies are ``service.protocol`` messages, negotiated between
JSON and the binary npz frame via ``Content-Type`` / ``Accept``):

  POST /v1/signals            RegisterRequest    -> SignalInfo
  POST /v1/ingest             IngestRequest      -> SignalInfo
  POST /v1/ingest:delta       IngestDeltaRequest -> IngestDeltaResponse
  POST /v1/build              BuildRequest       -> BuildResponse
  POST /v1/query/loss         LossQuery         -> LossResponse
  POST /v1/query/loss:batch   BatchLossQuery    -> BatchLossResponse
  POST /v1/query/fit          FitRequest        -> FitResponse
  POST /v1/query/compress     CompressRequest   -> CompressResponse
  GET  /v1/healthz            liveness + basic gauges (JSON)
  GET  /v1/stats              full JSON snapshot (signals, cache, latency)
  GET  /v1/metrics            Prometheus text exposition
  GET  /v1/traces:recent      newest-first completed-trace summaries (?limit=)
  GET  /v1/trace/{id}         one trace + linked traces (?format=chrome for
                              Perfetto-loadable trace-event JSON)

Every request runs under a trace: the handler continues the caller's W3C
``traceparent`` when one arrives (the SDK injects it) or mints a fresh
trace, and every response carries ``traceparent`` + ``X-Coreset-Trace-Id``
headers so clients can fetch the server-side trace of any response —
including errors.  An optional JSON-lines access log (``make_server``'s
``access_log``/``slow_ms``, off by default) records one line per request
(or per slow request) with its trace id.

Every status >= 400 carries the uniform envelope
``{"type": "error", "error": {"code", "message"}}`` with code in
{bad_request, not_found, conflict, payload_too_large, unsupported_media,
deadline_exceeded, overloaded, internal}.  Requests carrying
``deadline_ms`` that miss their deadline (build queue wait, query batching
window) fail 504 ``deadline_exceeded`` without disturbing the batch they
were queued in.  When admission control is on (``make_server`` engines
constructed with ``admission=``), requests may instead be refused ON
ARRIVAL with 503 ``overloaded`` + a fractional-seconds ``Retry-After``
header and ``reason``/``tenant``/``retry_after`` fields in the envelope;
the tenant comes from ``X-Coreset-Tenant`` (default tenant otherwise).
A tenant refused for its rate (``tenant_rate``) gets its 503 only after
``min(n x Retry-After, RATE_REFUSAL_HOLD_S, the request's deadline left)``,
n its place among the tenant's refusals held at that moment, its handler
thread asleep meanwhile (``_RefusalHolds``); the reference answers at once,
and so does this server past RATE_REFUSAL_MAX_HELD_PER_TENANT refusals held
for the tenant or RATE_REFUSAL_MAX_HELD in all.

The pre-v1 unversioned routes (``/signals``, ``/ingest``, ``/build``,
``/query/*``, ``/healthz``, ``/stats``, ``/metrics``) remain as thin
deprecated shims: their flat-dict request schema is translated to the typed
messages, they delegate to the same handlers, and every response carries
``Deprecation: true`` plus a ``Link: </v1/...>; rel="successor-version"``
header.  New clients should use ``repro_torch.client.CoresetClient``.

``synthetic`` payloads ({"kind": "piecewise"|"smooth", n, m, k?, noise?,
seed?}) generate the signal server-side — the loadgen path, so benchmarks
can measure the serving engine rather than the wire codec.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

import numpy as np

from repro_torch import obs

from . import protocol as P
from .admission import DEFAULT_TENANT, AdmissionRejected
from .engine import CoresetEngine, UnknownSignalError
from .protocol import ProtocolError, UnsupportedCodec
from .query_scheduler import DeadlineExceeded

__all__ = ["make_server", "serve_forever_in_thread", "ApiError"]

_MAX_BODY = 256 << 20
_TRACE_WAIT_S = 0.25   # bounded wait for an in-flight trace to finalize
# The longest a rate refusal's 503 is held before it is written.  A client
# that re-sends as soon as it is refused then waits for its next token
# asleep in the handler thread, which holds no interpreter lock, instead of
# costing this process a refusal's CPU every few ms while the other
# tenants' requests wait for the interpreter.  A rate refusal's Retry-After
# is one token's refill time, so one second covers it for every tenant
# whose share is at least 1 rps.
RATE_REFUSAL_HOLD_S = 1.0
# The most rate refusals held at once for one tenant, and in all; a refusal
# past either is answered at once.  A client that sends without waiting for
# its answers (open loop) then holds at most this many handler threads and
# sockets, whatever its rate, and a closed-loop one holds one per loop.
RATE_REFUSAL_MAX_HELD_PER_TENANT = 8
RATE_REFUSAL_MAX_HELD = 32


class _RefusalHolds:
    """The rate refusals one server holds, counted by tenant.  The n-th
    refusal held for a tenant at once is held ``n x`` its Retry-After: a
    rate refusal's Retry-After is the time to the tenant's next token, and
    the n-1 held before it are waiting for the tokens ahead of its own.
    Held to one instant, they would come back together, one to take the
    token and the rest to be refused again."""

    def __init__(self):
        self._lock = threading.Lock()
        self._held: dict[str, int] = {}
        self._total = 0

    def hold(self, tenant: str, retry_after: float, budget_s: float | None) -> bool:
        """Sleeps through the refusal's hold; False, at once, where the
        tenant's or the server's holds are at their bounds."""
        with self._lock:
            n = self._held.get(tenant, 0) + 1
            if (n > RATE_REFUSAL_MAX_HELD_PER_TENANT
                    or self._total >= RATE_REFUSAL_MAX_HELD):
                return False
            self._held[tenant] = n
            self._total += 1
        try:
            wait = min(n * retry_after, RATE_REFUSAL_HOLD_S)
            if budget_s is not None:
                wait = min(wait, budget_s)
            if wait > 0:
                time.sleep(wait)
        finally:
            with self._lock:
                self._total -= 1
                self._held[tenant] -= 1
                if not self._held[tenant]:
                    del self._held[tenant]
        return True

# concurrent.futures.TimeoutError aliases builtins.TimeoutError on 3.11+,
# but is a distinct class before — catch whichever this runtime has
from concurrent.futures import TimeoutError as _FutTimeout  # noqa: E402


class ApiError(Exception):
    """Handler-raised error with a definite HTTP status + envelope code."""

    def __init__(self, http: int, code: str, message: str,
                 retry_after: float | None = None):
        super().__init__(message)
        self.http = http
        self.code = code
        self.retry_after = retry_after


def _synthetic(spec: dict) -> np.ndarray:
    from repro_torch.data.signals import piecewise_signal, smooth_field
    if not isinstance(spec, dict):
        raise ProtocolError("'synthetic' must be an object")
    kind = spec.get("kind", "piecewise")
    try:
        n, m = int(spec["n"]), int(spec["m"])
    except (KeyError, TypeError, ValueError):
        raise ProtocolError("synthetic spec needs integer 'n' and 'm'") from None
    seed = int(spec.get("seed", 0))
    if kind == "piecewise":
        return piecewise_signal(n, m, int(spec.get("k", 8)),
                                noise=float(spec.get("noise", 0.15)), seed=seed)
    if kind == "smooth":
        return smooth_field(n, m, noise=float(spec.get("noise", 0.1)), seed=seed)
    raise ProtocolError(f"unknown synthetic kind {kind!r}")


def _values_from(values: np.ndarray | None, synthetic: dict | None,
                 field: str) -> np.ndarray:
    """Resolve a dense payload: the typed array field (already dtype/ndim
    validated by the protocol coercers — ragged or non-numeric input fails
    decode with a 400 envelope, never a 500) or a server-side generator."""
    if values is not None:
        if values.ndim != 2 or values.size == 0:
            raise ProtocolError(f"{field!r} must be a non-empty 2-D array")
        if not np.isfinite(values).all():
            raise ProtocolError(f"{field!r} must be finite (NaN/inf found)")
        return np.asarray(values, np.float64)
    if synthetic is not None:
        return _synthetic(synthetic)
    raise ProtocolError(f"need {field!r} or 'synthetic'")


# ------------------------------------------------------------- v1 handlers
def _h_register(eng: CoresetEngine, msg: P.RegisterRequest) -> P.SignalInfo:
    values = _values_from(msg.values, msg.synthetic, "values")
    try:
        info = eng.register_signal(msg.signal.name, values, replace=msg.replace)
    except ValueError as exc:
        if "already registered" in str(exc):
            raise ApiError(409, "conflict", str(exc)) from None
        raise
    return _signal_info(info)


def _h_ingest(eng: CoresetEngine, msg: P.IngestRequest) -> P.SignalInfo:
    band = _values_from(msg.band, msg.synthetic, "band")
    return _signal_info(eng.ingest_band(msg.signal.name, band))


def _deadline_of(msg) -> float | None:
    """Absolute perf_counter deadline from a request's ``deadline_ms``
    budget (clocked from handler entry, i.e. request receipt)."""
    ms = getattr(msg, "deadline_ms", None)
    if ms is None:
        return None
    ms = float(ms)
    if ms <= 0:
        raise ProtocolError("deadline_ms must be > 0")
    return time.perf_counter() + ms / 1e3


def _h_ingest_delta(eng: CoresetEngine, msg: P.IngestDeltaRequest,
                    ) -> P.IngestDeltaResponse:
    band = _values_from(msg.band, None, "band")
    row0 = int(msg.row0) if msg.row0 is not None else None
    r = eng.ingest_delta(msg.signal.name, band, row0=row0,
                         row0s=msg.row0s, rows=msg.rows)
    return P.IngestDeltaResponse(**r)


def _signal_info(info: dict) -> P.SignalInfo:
    return P.SignalInfo(
        name=info["name"], n=int(info["n"]),
        m=int(info["m"]) if info["m"] is not None else None,
        bands=int(info["bands"]), streamed=bool(info["streamed"]),
        version=info["version"],
        builders=[list(b) for b in info["builders"]])


def _h_build(eng: CoresetEngine, msg: P.BuildRequest) -> P.BuildResponse:
    cs, eps_eff, how = eng.get_coreset(msg.signal.name, msg.spec.k,
                                       msg.spec.eps,
                                       deadline=_deadline_of(msg))
    return P.BuildResponse(
        fingerprint=cs.fingerprint(), eps_eff=float(eps_eff), served_from=how,
        size=int(cs.size), blocks=int(cs.num_blocks), nbytes=int(cs.nbytes),
        compression_ratio=float(cs.compression_ratio()),
        certified=bool(cs.certified), build_seconds=float(cs.build_seconds))


def _h_loss(eng: CoresetEngine, msg: P.LossQuery) -> P.LossResponse:
    eps = msg.spec.eps if msg.spec is not None else 0.2
    k = msg.spec.k if msg.spec is not None else None
    r = eng.tree_loss(msg.signal.name, msg.rects, msg.labels, eps=eps, k=k,
                      deadline=_deadline_of(msg),
                      coalesce=bool(msg.coalesce))
    return P.LossResponse(
        loss=r["loss"], k=r["k"], eps=r["eps"], eps_eff=r["eps_eff"],
        served_from=r["served_from"], fingerprint=r["fingerprint"],
        coreset_size=r["coreset_size"],
        fused_batch_size=r["fused_batch_size"], backend=r["backend"])


def _h_loss_batch(eng: CoresetEngine, msg: P.BatchLossQuery,
                  ) -> P.BatchLossResponse:
    eps = msg.spec.eps if msg.spec is not None else 0.2
    k = msg.spec.k if msg.spec is not None else None
    r = eng.tree_loss_batch(msg.signal.name, msg.rects, msg.labels,
                            eps=eps, k=k, deadline=_deadline_of(msg),
                            coalesce=bool(msg.coalesce))
    return P.BatchLossResponse(
        losses=r["losses"], k=r["k"], eps=r["eps"], eps_eff=r["eps_eff"],
        served_from=r["served_from"], fingerprint=r["fingerprint"],
        coreset_size=r["coreset_size"], scoring_calls=r["scoring_calls"],
        fused_batch_size=r["fused_batch_size"])


def _h_fit(eng: CoresetEngine, msg: P.FitRequest) -> P.FitResponse:
    r = eng.fit_forest(
        msg.signal.name, k=msg.spec.k, eps=msg.spec.eps,
        n_estimators=int(msg.n_estimators),
        max_leaves=int(msg.max_leaves) if msg.max_leaves is not None else None,
        predict=msg.predict, seed=int(msg.seed),
        deadline=_deadline_of(msg))
    return P.FitResponse(
        k=r["k"], eps=r["eps"], eps_eff=r["eps_eff"],
        served_from=r["served_from"], fingerprint=r["fingerprint"],
        train_size=r["train_size"], n_estimators=r["n_estimators"],
        model_cache=r["model_cache"],
        predictions=(np.asarray(r["predictions"], np.float64)
                     if "predictions" in r else None))


def _h_compress(eng: CoresetEngine, msg: P.CompressRequest,
                ) -> P.CompressResponse:
    r = eng.compress(
        msg.signal.name, k=msg.spec.k,
        eps=None if msg.target_frac is not None else msg.spec.eps,
        target_frac=(float(msg.target_frac)
                     if msg.target_frac is not None else None),
        style=msg.style, max_points=int(msg.max_points),
        deadline=_deadline_of(msg))
    pts = r["points"]
    return P.CompressResponse(
        k=r["k"], eps_eff=r["eps_eff"], served_from=r["served_from"],
        fingerprint=r["fingerprint"], size=r["size"], blocks=r["blocks"],
        nbytes=r["nbytes"], compression_ratio=r["compression_ratio"],
        truncated=r["truncated"],
        X=np.asarray(pts["X"], np.float64).reshape(-1, 2),
        y=np.asarray(pts["y"], np.float64),
        w=np.asarray(pts["w"], np.float64))


# (request message class, handler) per v1 POST route
_V1_POST = {
    "/v1/signals": (P.RegisterRequest, _h_register),
    "/v1/ingest": (P.IngestRequest, _h_ingest),
    "/v1/ingest:delta": (P.IngestDeltaRequest, _h_ingest_delta),
    "/v1/build": (P.BuildRequest, _h_build),
    "/v1/query/loss": (P.LossQuery, _h_loss),
    "/v1/query/loss:batch": (P.BatchLossQuery, _h_loss_batch),
    "/v1/query/fit": (P.FitRequest, _h_fit),
    "/v1/query/compress": (P.CompressRequest, _h_compress),
}
_V1_GET = frozenset({"/v1/healthz", "/v1/stats", "/v1/metrics"})

# deprecated unversioned path -> v1 successor (the ":"-suffixed fused/delta
# routes are v1-only: no pre-v1 client ever spoke them)
_V1_ONLY = frozenset({"/v1/query/loss:batch", "/v1/ingest:delta"})
_LEGACY = {p[len("/v1"):]: p for p in (*_V1_POST, *_V1_GET)
           if p not in _V1_ONLY}

_ROUTES = frozenset((*_V1_POST, *_V1_GET, *_LEGACY))


# --------------------------------------------- legacy flat-dict translation
def _req(body: dict, field: str):
    try:
        return body[field]
    except KeyError:
        raise ProtocolError(f"missing field {field!r}") from None


def _legacy_spec(body: dict, *, k_default: int | None = None) -> P.CoresetSpec:
    k = body.get("k", k_default)
    if k is None:
        raise ProtocolError("missing field 'k'")
    return P.CoresetSpec(k=int(k), eps=float(body.get("eps", 0.2)))


def _legacy_to_msg(path: str, body: dict) -> P._Wire:
    if not isinstance(body, dict):
        raise ProtocolError("body must be a JSON object")
    ref = P.SignalRef(name=str(_req(body, "name")))
    arr2 = P._arr(np.float64, ndim=2, allow_none=True)
    if path == "/signals":
        return P.RegisterRequest(
            signal=ref, values=arr2(body.get("values")),
            synthetic=body.get("synthetic"),
            replace=bool(body.get("replace", False)))
    if path == "/ingest":
        return P.IngestRequest(signal=ref, band=arr2(body.get("band")),
                               synthetic=body.get("synthetic"))
    if path == "/build":
        return P.BuildRequest(signal=ref, spec=_legacy_spec(body))
    if path == "/query/loss":
        rects = P._arr(np.int64, ndim=2)(_req(body, "rects"))
        spec = None
        if "k" in body or "eps" in body:
            spec = _legacy_spec(body, k_default=max(rects.shape[0], 1))
        return P.LossQuery(signal=ref, rects=rects,
                           labels=P._arr(np.float64, ndim=1)(_req(body, "labels")),
                           spec=spec)
    if path == "/query/fit":
        return P.FitRequest(
            signal=ref, spec=_legacy_spec(body),
            n_estimators=int(body.get("n_estimators", 10)),
            max_leaves=(int(body["max_leaves"])
                        if "max_leaves" in body else None),
            predict=arr2(body.get("predict")),
            seed=int(body.get("seed", 0)))
    if path == "/query/compress":
        return P.CompressRequest(
            signal=ref, spec=_legacy_spec(body),
            target_frac=(float(body["target_frac"])
                         if "target_frac" in body else None),
            style=str(body.get("style", "mean")),
            max_points=int(body.get("max_points", 4096)))
    raise ProtocolError(f"no legacy translation for {path}")


def _legacy_payload(resp: P._Wire) -> dict:
    """Shape a typed response like the pre-v1 flat JSON bodies: no "type"
    tag, ``served_from`` also published under its old name ``cache``, and
    compress points re-nested under "points" — so a legacy client's
    ``r["cache"]`` / ``r["points"]["X"]`` keep working behind the shim."""
    # drop nulls: pre-v1 bodies omitted absent keys (e.g. fit responses
    # only carried "predictions" when predict points were sent)
    payload = {k: v.tolist() if isinstance(v, np.ndarray) else v
               for k, v in resp.to_payload().items() if v is not None}
    payload.pop("type", None)
    if "served_from" in payload:
        payload["cache"] = payload["served_from"]
    if isinstance(resp, P.CompressResponse):
        payload["points"] = {"X": payload.pop("X"), "y": payload.pop("y"),
                             "w": payload.pop("w")}
    return payload


class _Handler(BaseHTTPRequestHandler):
    engine: CoresetEngine  # set by make_server on the subclass
    protocol_version = "HTTP/1.1"
    access_log = None      # file-like; make_server sets it (None = off)
    slow_ms: float | None = None   # only log requests slower than this
    stream_chunk_points: int = P.STREAM_CHUNK_POINTS   # v2 points/chunk
    _log_lock: threading.Lock = threading.Lock()
    _span = None           # this request's root span (per-request, set early)
    _status = 0

    # silence per-request stderr logging; the access log (opt-in) and
    # metrics carry the signal
    def log_message(self, fmt, *args):  # noqa: D102
        pass

    # ------------------------------------------------------------- plumbing
    def _reply(self, code: int, body: bytes, content_type: str,
               deprecated_for: str | None = None,
               retry_after: float | None = None):
        if code >= 400:
            # an error may leave the request body unread (oversized payload,
            # JSON abort) — reusing the keep-alive connection would parse the
            # leftover bytes as the next request line; close instead
            self.close_connection = True
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        sp = self._span
        if sp is not None:
            # every response — errors included — names its server-side
            # trace, so a client can always fetch /v1/trace/{id}
            self.send_header("traceparent",
                             obs.format_traceparent(sp.trace_id, sp.span_id))
            self.send_header("X-Coreset-Trace-Id", sp.trace_id)
        if retry_after is not None:
            # fractional seconds: RFC 9110 says integer delay-seconds, but
            # sub-second backoff is the whole point at ms-scale requests —
            # our SDK float()s the header, and integer-only parsers reading
            # "0.25" as garbage fall back to their own schedule, which is
            # exactly the no-header behavior
            self.send_header("Retry-After", f"{max(retry_after, 0.001):.3f}")
        if deprecated_for is not None:
            self.send_header("Deprecation", "true")
            self.send_header("Link",
                             f'<{deprecated_for}>; rel="successor-version"')
        self.end_headers()
        self.wfile.write(body)

    def _reply_msg(self, code: int, msg: P._Wire, encoding: str,
                   deprecated_for: str | None = None,
                   retry_after: float | None = None):
        # binary responses use the codec the client's Accept advertised
        # ("zlib" unless it explicitly said codec=zstd), so a zlib-only
        # client never receives a frame it cannot decode.  The advertised
        # codec is an upper bound, never a demand: a zstd-less server
        # degrades to zlib silently — the handler already ran, so raising
        # here would 415 a request whose state change was committed
        codec = None
        if encoding == "binary":
            codec = P._Wire.accept_codec(self.headers.get("Accept", ""))
            if codec == "zstd" and P.zstandard is None:
                codec = "zlib"
        ctype, body = msg.to_wire(encoding, binary_codec=codec)
        self._reply(code, body, ctype, deprecated_for, retry_after)

    def _reply_compress_stream(self, resp: P.CompressResponse) -> None:
        """v2 negotiated compress: write the response as one transfer-
        encoding chunk per protocol segment, each flushed before the next
        is encoded — server-side peak memory for the wire path is
        O(stream_chunk_points), not O(response points).

        Headers are committed before the first segment, so a mid-stream
        failure cannot be converted into an error envelope; the connection
        is torn down instead and the client's incremental decoder reports
        ``StreamTruncated`` (which it treats as retryable).
        """
        codec = P._Wire.accept_codec(self.headers.get("Accept", ""))
        if codec == "zstd" and P.zstandard is None:
            codec = "zlib"
        self._status = 200
        self.send_response(200)
        self.send_header("Content-Type", P.CONTENT_TYPE_STREAM)
        self.send_header("Transfer-Encoding", "chunked")
        sp = self._span
        if sp is not None:
            self.send_header("traceparent",
                             obs.format_traceparent(sp.trace_id, sp.span_id))
            self.send_header("X-Coreset-Trace-Id", sp.trace_id)
        self.end_headers()
        segments = 0
        try:
            for seg in P.compress_stream_segments(
                    resp, chunk_points=self.stream_chunk_points,
                    binary_codec=codec):
                self.wfile.write(b"%x\r\n" % len(seg) + seg + b"\r\n")
                self.wfile.flush()
                segments += 1
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            # client went away mid-stream; nothing to salvage on this
            # connection, and the headers are long gone
            self.close_connection = True
            self.engine.metrics.inc("http_stream_aborts")
            return
        self.engine.metrics.inc("http_stream_responses")
        self.engine.metrics.inc("http_stream_segments", segments)

    def _reply_json(self, code: int, payload,
                    content_type: str = "application/json",
                    deprecated_for: str | None = None):
        body = (payload if isinstance(payload, bytes)
                else json.dumps(payload).encode())
        self._reply(code, body, content_type, deprecated_for)

    def _error(self, http: int, code: str, message: str,
               deprecated_for: str | None = None, *,
               retry_after: float | None = None,
               tenant: str | None = None, reason: str | None = None):
        # errors are always JSON: the envelope must stay readable even when
        # the request's binary frame was the thing that failed to parse
        env = P.ErrorResponse(error=P.ErrorInfo(
            code=code, message=message, retry_after=retry_after,
            tenant=tenant, reason=reason))
        self._reply_msg(http, env, "json", deprecated_for,
                        retry_after=retry_after)

    def _admitted(self, eng: CoresetEngine, msg: P._Wire):
        """Front-door admission for one decoded request.  Returns a context
        manager: the admission Ticket (made current for the handler call, so
        inner engine hops — cluster scatter — are charged exactly once and
        its exit feeds the observed service time back into the predictor),
        or a no-op when the engine runs without admission.  Raises
        :class:`AdmissionRejected` → 503 + Retry-After before any engine
        work happens."""
        ctl = eng.admission
        if ctl is None:
            return contextlib.nullcontext()
        tenant = (self.headers.get("X-Coreset-Tenant")
                  or getattr(msg, "tenant", None) or DEFAULT_TENANT)
        sig = getattr(msg, "signal", None)
        ticket = ctl.admit(msg.kind, tenant,
                           deadline_ms=getattr(msg, "deadline_ms", None),
                           signal=sig.name if sig is not None else None)
        sp = self._span
        if sp:
            sp.set_attr("tenant", tenant)
        return ticket

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        if length > _MAX_BODY:
            raise ApiError(413, "payload_too_large",
                           f"body of {length} bytes exceeds {_MAX_BODY}")
        return self.rfile.read(length) if length else b""

    def _accept_encoding(self) -> str:
        accept = self.headers.get("Accept", "")
        return "binary" if P.CONTENT_TYPE_BINARY in accept else "json"

    # -------------------------------------------------------------- routing
    def _route(self, method: str) -> None:
        eng = self.engine
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        t0 = time.perf_counter()
        # latency metric label: client-supplied paths outside the route table
        # collapse to one bucket, else a URL scanner grows a histogram per
        # probed path and bloats every /metrics scrape; the dynamic trace
        # route collapses its id for the same reason
        if path in _ROUTES or path == "/v1/traces:recent":
            metric_route = f"{method} {path}"
        elif path.startswith("/v1/trace/"):
            metric_route = f"{method} /v1/trace/{{id}}"
        else:
            metric_route = f"{method} <unmatched>"
        successor = _LEGACY.get(path)      # non-None => deprecated shim
        v1_path = successor or path
        out_enc = self._accept_encoding()
        # continue the caller's trace (SDK-injected traceparent) or mint one
        root = obs.start_trace(metric_route,
                               traceparent=self.headers.get("traceparent"))
        self._span = root if root else None
        self._status = 0
        try:
            with obs.attach(root):
                if method == "GET" and v1_path in _V1_GET:
                    self._get(eng, v1_path, successor)
                elif method == "GET" and (path == "/v1/traces:recent"
                                          or path.startswith("/v1/trace/")):
                    self._get_trace(path, query)
                elif method == "POST" and v1_path in _V1_POST:
                    msg_cls, handler = _V1_POST[v1_path]
                    raw = self._body()
                    if successor is not None:
                        # legacy flat-dict schema; JSON only, like the old API
                        msg = _legacy_to_msg(path, json.loads(raw or b"{}"))
                        with self._admitted(eng, msg):
                            resp = handler(eng, msg)
                        self._reply_json(200, _legacy_payload(resp),
                                         deprecated_for=successor)
                    else:
                        ctype = self.headers.get("Content-Type", "")
                        if (ctype.split(";")[0].strip().lower() not in
                                ("", P.CONTENT_TYPE_JSON, P.CONTENT_TYPE_BINARY)):
                            raise ApiError(415, "unsupported_media",
                                           f"unsupported Content-Type {ctype!r}")
                        msg = P.decode(ctype, raw, expect=msg_cls)
                        with self._admitted(eng, msg):
                            resp = handler(eng, msg)
                        if (v1_path == "/v1/query/compress"
                                and out_enc == "binary"
                                and P.accept_stream(
                                    self.headers.get("Accept"))):
                            # Accept carried ";v=2": stream the response as
                            # length-prefixed segments over chunked
                            # transfer-encoding instead of one buffered
                            # frame (protocol.py, "v2 chunked streaming")
                            self._reply_compress_stream(resp)
                        else:
                            self._reply_msg(200, resp, out_enc)
                else:
                    eng.metrics.inc("http_404")
                    self._error(404, "not_found", f"no route {method} {path}")
                    return
            eng.metrics.inc("http_200")
            if successor is not None:
                eng.metrics.inc("http_deprecated")
        except AdmissionRejected as exc:
            # refused ON ARRIVAL (503 overloaded + Retry-After): the request
            # never touched the engine.  Distinct from 504 deadline_exceeded,
            # which is admitted work dying at its deadline.
            if exc.reason == "tenant_rate":
                deadline_ms = getattr(msg, "deadline_ms", None)
                self.server.refusal_holds.hold(
                    exc.tenant, exc.retry_after,
                    None if deadline_ms is None
                    else deadline_ms / 1e3 - (time.perf_counter() - t0))
            eng.metrics.inc("http_503")
            if root:
                root.set_attr("admission.rejected", True)
                root.set_attr("admission.reason", exc.reason)
                root.set_attr("admission.tenant", exc.tenant)
            self._error(503, "overloaded", exc.message, successor,
                        retry_after=exc.retry_after, tenant=exc.tenant,
                        reason=exc.reason)
        except ApiError as exc:
            eng.metrics.inc(f"http_{exc.http}")
            self._error(exc.http, exc.code, str(exc), successor,
                        retry_after=exc.retry_after)
        except UnknownSignalError as exc:
            # the one *intentional* KeyError (engine signal lookup); stray
            # KeyErrors from handler bugs still surface as 500 internal
            eng.metrics.inc("http_404")
            self._error(404, "not_found", str(exc.args[0] if exc.args else exc),
                        successor)
        except UnsupportedCodec as exc:
            # zstd frame on a zlib-only host: 415 tells the SDK to
            # renegotiate down to JSON, unlike a 400 which means bad request
            eng.metrics.inc("http_415")
            self._error(415, "unsupported_media", str(exc), successor)
        except (DeadlineExceeded, _FutTimeout) as exc:
            # the request's deadline_ms budget ran out (build queue wait or
            # query batching window) — a definite server-side timeout, not
            # a malformed request; the batch it was queued in still serves
            eng.metrics.inc("http_504")
            self._error(504, "deadline_exceeded",
                        str(exc) or "request deadline exceeded", successor)
        except (ProtocolError, ValueError, TypeError,
                json.JSONDecodeError) as exc:
            eng.metrics.inc("http_400")
            self._error(400, "bad_request", f"{type(exc).__name__}: {exc}",
                        successor)
        except Exception as exc:  # pragma: no cover - defensive 500
            eng.metrics.inc("http_500")
            self._error(500, "internal", f"{type(exc).__name__}: {exc}",
                        successor)
        finally:
            dt = time.perf_counter() - t0
            if root:
                root.set_attr("http.status", self._status)
                root.end()
            self._span = None
            # exemplar: a slow bucket in the latency histogram names a
            # concrete retrievable trace instead of an anonymous aggregate
            eng.metrics.observe(f"http {metric_route}", dt,
                                exemplar=root.trace_id if root else None)
            self._access_log_line(method, path, dt,
                                  root.trace_id if root else None)

    def _access_log_line(self, method: str, path: str, dt: float,
                         trace_id: str | None) -> None:
        """One structured JSON line per request (or per slow request when
        ``slow_ms`` filters) — opt-in, see ``make_server``."""
        fp = self.access_log
        if fp is None:
            return
        dur_ms = dt * 1e3
        slow = self.slow_ms is not None and dur_ms >= self.slow_ms
        if self.slow_ms is not None and not slow:
            return
        rec = {"ts": round(time.time(), 6), "method": method, "path": path,
               "status": self._status, "duration_ms": round(dur_ms, 3)}
        if trace_id:
            rec["trace_id"] = trace_id
        if slow:
            rec["slow"] = True
        line = json.dumps(rec) + "\n"
        try:
            with self._log_lock:   # interleaved lines from handler threads
                fp.write(line)
                fp.flush()
        except (OSError, ValueError):   # closed/full log must not 500 requests
            pass

    def _get_trace(self, path: str, query: str) -> None:
        """The trace-retrieval routes (JSON only; ids are dynamic path
        segments, so these live outside the static route table)."""
        params = parse_qs(query)
        if path == "/v1/traces:recent":
            try:
                limit = int(params.get("limit", ["50"])[0])
            except ValueError:
                raise ApiError(400, "bad_request",
                               "limit must be an integer") from None
            self._reply_json(200, {"traces": obs.TRACER.recent(limit)})
            return
        trace_id = path[len("/v1/trace/"):]
        fmt = params.get("format", ["json"])[0]
        # grace for the reply-before-finalize window: a request's response
        # is written BEFORE its root span ends (observation must not gate
        # the reply), so a client fetching its own trace straight off the
        # response headers can beat finalization by microseconds.  The wait
        # only engages for ids the tracer knows are in flight — unknown ids
        # still 404 immediately.
        if fmt == "chrome":
            body = obs.TRACER.chrome_json(trace_id, wait_s=_TRACE_WAIT_S)
            if body is None:
                raise ApiError(404, "not_found",
                               f"unknown trace {trace_id!r}")
            self._reply_json(200, body)
            return
        if fmt != "json":
            raise ApiError(400, "bad_request",
                           f"unknown trace format {fmt!r} "
                           "(expected json or chrome)")
        doc = obs.TRACER.get(trace_id, wait_s=_TRACE_WAIT_S)
        if doc is None:
            raise ApiError(404, "not_found", f"unknown trace {trace_id!r}")
        self._reply_json(200, doc)

    def _get(self, eng: CoresetEngine, v1_path: str,
             successor: str | None) -> None:
        if v1_path == "/v1/healthz":
            snap = eng.metrics.snapshot()
            self._reply_json(200, {
                "status": "ok", "protocol": P.PROTOCOL_VERSION,
                "uptime_s": snap["uptime_s"],
                "signals": len(eng.list_signals()),
                "cache_entries": len(eng.cache),
                "cache_bytes": eng.cache.nbytes,
                "builds_in_flight": eng.scheduler.in_flight()},
                deprecated_for=successor)
        elif v1_path == "/v1/stats":
            self._reply_json(200, eng.stats(), deprecated_for=successor)
        else:  # /v1/metrics
            eng.sync_autotune_metrics()   # scrape sees fresh ops_autotune_*
            self._reply_json(200, eng.metrics.render().encode(),
                             content_type="text/plain; version=0.0.4",
                             deprecated_for=successor)

    def do_GET(self):  # noqa: N802
        self._route("GET")

    def do_POST(self):  # noqa: N802
        self._route("POST")


def make_server(engine: CoresetEngine, host: str = "127.0.0.1",
                port: int = 0, *, access_log=None,
                slow_ms: float | None = None,
                stream_chunk_points: int | None = None) -> ThreadingHTTPServer:
    """Bind a ThreadingHTTPServer to (host, port); port 0 = ephemeral.

    ``access_log`` (a writable text file object, e.g. an opened path or
    ``sys.stderr``) turns on the JSON-lines access log: one object per
    request with method, path, status, duration_ms and trace_id.
    ``slow_ms`` filters it to requests at or above that duration — the
    slow-request log.  Both default off; the handler never logs otherwise.
    ``stream_chunk_points`` overrides the points-per-chunk of v2 streamed
    compress responses (default ``protocol.STREAM_CHUNK_POINTS``).
    """
    handler = type("CoresetHandler", (_Handler,), {
        "engine": engine, "access_log": access_log,
        "slow_ms": float(slow_ms) if slow_ms is not None else None,
        "stream_chunk_points": (int(stream_chunk_points)
                                if stream_chunk_points is not None
                                else P.STREAM_CHUNK_POINTS),
        "_log_lock": threading.Lock()})
    srv = _Server((host, port), handler)
    return srv


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # a barrier-released burst of concurrent clients (the coalescing gate,
    # cluster gathers) overflows socketserver's default listen backlog of 5
    # into kernel RSTs when the accept loop lags; give the queue real depth
    request_queue_size = 128

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.refusal_holds = _RefusalHolds()


def serve_forever_in_thread(srv: ThreadingHTTPServer) -> threading.Thread:
    t = threading.Thread(target=srv.serve_forever, name="coreset-http",
                         daemon=True)
    t.start()
    return t
