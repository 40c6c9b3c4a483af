"""CoresetClient — typed v1 SDK over stdlib urllib.

Every method takes/returns ``repro_torch.service.protocol`` messages (or numpy
arrays that are coerced into them) — callers never hand-roll dicts, and the
wire encoding is invisible to them:

  * ``encoding="binary"`` (default): requests ship as compressed npz frames
    and responses are requested in the same format via ``Accept`` — large
    signal registration skips ``tolist``/JSON entirely;
  * ``encoding="json"``: readable bodies, same dataclasses;
  * a server that rejects the binary media type (HTTP 415 — e.g. an older
    deployment) downgrades the client to JSON for the rest of its life.

Transient failures (connection errors, timeouts, HTTP 5xx) retry with
exponential backoff up to ``retries`` times — a ``Retry-After`` header on
a retryable 5xx (503 overload pushback) stretches the next sleep to at
least that many seconds; structured API errors (status < 500 with the v1
envelope) raise ``CoresetAPIError(http, code, message)`` immediately and
never retry.

Large ``compress`` responses stream: with ``stream=True`` (the default on
binary encoding) the client advertises ``;v=2`` in ``Accept`` and decodes
the server's chunked segment stream incrementally — same typed result,
same retry semantics (a stream that dies mid-transfer surfaces as a
retryable transport fault, a corrupt one as ``ProtocolError``).  v1-only
servers ignore the parameter and the buffered path is used unchanged;
``client.last_stream_chunks`` tells which happened (0 = buffered).

Every request carries a client-minted W3C ``traceparent`` header, so the
server-side trace of a call IS the client's trace id: after any call,
``client.last_trace_id`` names the trace ``client.trace(...)`` retrieves,
and a ``CoresetAPIError`` carries the failing request's ``trace_id`` —
the server-side story of an error is one GET away.

    from repro_torch.client import CoresetClient
    c = CoresetClient("http://127.0.0.1:8787")
    c.register_signal("img", values=y)
    r = c.query_loss("img", rects, labels, eps=0.3)
    print(r.loss, r.eps_eff, r.served_from)
"""
from __future__ import annotations

import json
import time
import urllib.error
import urllib.request

import numpy as np

from repro_torch import obs
from repro_torch.service import protocol as P

__all__ = ["CoresetClient", "CoresetAPIError", "TransportError",
           "AdmissionRejectedError"]


class CoresetAPIError(Exception):
    """Structured error from the service's uniform v1 envelope.
    ``trace_id`` (when the server returned one) names the server-side trace
    of the failing request — ``client.trace(err.trace_id)`` fetches it."""

    def __init__(self, http: int, code: str, message: str,
                 trace_id: str | None = None):
        tail = f" [trace {trace_id}]" if trace_id else ""
        super().__init__(f"[{http} {code}] {message}{tail}")
        self.http = http
        self.code = code
        self.message = message
        self.trace_id = trace_id


class AdmissionRejectedError(CoresetAPIError):
    """503 ``overloaded``: the server refused the request ON ARRIVAL
    (admission control) and every retry met the same pushback.
    ``retry_after`` is the server's final backoff hint in seconds;
    ``reason`` is the admission verdict (``deadline_unmeetable``,
    ``tenant_rate``, ``tenant_inflight``); ``tenant`` is who it was
    charged to."""

    def __init__(self, http: int, code: str, message: str,
                 trace_id: str | None = None, *,
                 retry_after: float | None = None,
                 tenant: str | None = None, reason: str | None = None):
        super().__init__(http, code, message, trace_id)
        self.retry_after = retry_after
        self.tenant = tenant
        self.reason = reason


class TransportError(Exception):
    """Connection-level failure after exhausting retries."""


class CoresetClient:
    def __init__(self, base_url: str, *, encoding: str = "binary",
                 timeout: float = 120.0, retries: int = 2,
                 backoff: float = 0.1, backoff_cap: float = 30.0,
                 deadline_ms: float | None = None,
                 stream: bool = True, tenant: str | None = None):
        if encoding not in ("binary", "json"):
            raise ValueError(f"encoding must be 'binary' or 'json', "
                             f"got {encoding!r}")
        self.base_url = base_url.rstrip("/")
        self.encoding = encoding
        # offer the v2 chunked stream on compress (binary encoding only);
        # servers without v2 serve the buffered v1 response unchanged
        self.stream = bool(stream)
        self.timeout = float(timeout)
        self.retries = int(retries)
        self.backoff = float(backoff)
        # ceiling on any single retry sleep, INCLUDING a server-sent
        # Retry-After: an admission-controlled server computes its hint
        # from the configured rate, and a tiny rate yields an honest but
        # enormous hint — a client must never block unboundedly on it
        self.backoff_cap = float(backoff_cap)
        # default server-side budget attached to every query/build request;
        # per-call deadline_ms overrides it.  Past the budget the server
        # fails the request 504 deadline_exceeded (never retried here — the
        # deadline passing is the definitive answer, and the batch the
        # request was queued in is unaffected)
        self.deadline_ms = float(deadline_ms) if deadline_ms is not None \
            else None
        # QoS identity: sent as X-Coreset-Tenant on every request so an
        # admission-controlled server charges this client's traffic to its
        # fair-share bucket (None = the server's default tenant)
        self.tenant = tenant
        # request-frame codec: None = best this host encodes; negotiated
        # down to "zlib" if the server 415s a zstd frame
        self._codec: str | None = None
        # trace propagation: every request carries a minted traceparent,
        # and these name the LAST request's trace (the server echoes the
        # trace id back in X-Coreset-Trace-Id, so both sides agree)
        self.last_traceparent: str | None = None
        self.last_trace_id: str | None = None
        # last compress: v2 segments decoded (0 = buffered v1 response);
        # last retryable 5xx: the server's Retry-After seconds, if any
        self.last_stream_chunks: int = 0
        self.last_retry_after: float | None = None

    def _deadline(self, deadline_ms: float | None) -> float | None:
        ms = deadline_ms if deadline_ms is not None else self.deadline_ms
        return float(ms) if ms is not None else None

    # ------------------------------------------------------------ transport
    def _request(self, method: str, path: str, body: bytes | None,
                 content_type: str | None, stream: bool = False):
        if self.encoding == "binary":
            # advertise the strongest codec THIS host can decode; the
            # server encodes its response accordingly (zlib unless zstd is
            # explicitly offered), so a 200 is always decodable here
            codec = "zstd" if P.zstandard is not None else "zlib"
            accept = f"{P.CONTENT_TYPE_BINARY};codec={codec}"
            if stream:
                # v2 offer: a stream-capable server answers with chunked
                # segments; everyone else ignores the parameter (v1)
                accept += ";v=2"
        else:
            accept = P.CONTENT_TYPE_JSON
        headers = {"Accept": accept}
        if self.tenant is not None:
            headers["X-Coreset-Tenant"] = self.tenant
        if content_type is not None:
            headers["Content-Type"] = content_type
        # W3C trace propagation: the server continues THIS trace id, so the
        # server-side trace of the call is retrievable under an id the
        # client chose (one fresh id per attempt — retries are new traces)
        trace_id = obs.mint_trace_id()
        tp = obs.format_traceparent(trace_id, obs.mint_span_id())
        headers["traceparent"] = tp
        self.last_traceparent = tp
        self.last_trace_id = trace_id
        req = urllib.request.Request(self.base_url + path, data=body,
                                     headers=headers, method=method)
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            self._note_trace(resp.headers)
            rtype = resp.headers.get("Content-Type", "")
            if rtype.split(";")[0].strip().lower() == P.CONTENT_TYPE_STREAM:
                # v2 negotiated: decode segments as they arrive off the
                # socket (urllib de-chunks the transfer encoding) — peak
                # client memory is O(chunk) + the assembled arrays, never
                # a second whole-body buffer
                msg, chunks = P.read_compress_stream(resp.read)
                self.last_stream_chunks = chunks
                return resp.status, rtype, msg
            return resp.status, rtype, resp.read()

    def _note_trace(self, headers) -> str | None:
        """Record the server's trace id for the last request (it normally
        equals the minted one; a proxy or non-tracing server may differ)."""
        tid = headers.get("X-Coreset-Trace-Id") if headers is not None else None
        if tid:
            self.last_trace_id = tid
        return tid

    def _raise_api_error(self, http: int, ctype: str, raw: bytes,
                         trace_id: str | None = None):
        trace_id = trace_id or self.last_trace_id
        try:
            env = P.decode(ctype, raw, expect=P.ErrorResponse)
            raise CoresetAPIError(http, env.error.code, env.error.message,
                                  trace_id)
        except P.ProtocolError:
            raise CoresetAPIError(http, "unknown",
                                  raw[:512].decode("utf-8", "replace"),
                                  trace_id) from None

    def _admission_error(self, ctype: str, raw: bytes,
                         trace_id: str | None,
                         retry_after: float | None,
                         ) -> AdmissionRejectedError | None:
        """Typed rejection from a 503 body carrying the ``overloaded``
        envelope; None for any other 503 (proxy, mid-restart, no body)."""
        try:
            env = P.decode(ctype, raw, expect=P.ErrorResponse)
        except (P.ProtocolError, ValueError):
            return None
        if env.error.code != "overloaded":
            return None
        return AdmissionRejectedError(
            503, env.error.code, env.error.message,
            trace_id or self.last_trace_id,
            retry_after=(env.error.retry_after if env.error.retry_after
                         is not None else retry_after),
            tenant=env.error.tenant, reason=env.error.reason)

    @staticmethod
    def _retry_after_s(headers) -> float | None:
        """Seconds form of a Retry-After header (the HTTP-date form is not
        worth a date parser on this path); absent/garbage -> None."""
        val = headers.get("Retry-After") if headers is not None else None
        if val is None:
            return None
        try:
            return max(0.0, float(val))
        except ValueError:
            return None

    def _call(self, path: str, msg: P._Wire, expect: type,
              retryable: bool = True, stream: bool = False):
        retries = self.retries if retryable else 0
        attempt = 0
        downgraded = False
        while True:
            ctype, body = msg.to_wire(self.encoding,
                                      binary_codec=self._codec)
            retry_after = None
            try:
                status, rtype, raw = self._request("POST", path, body, ctype,
                                                   stream=stream)
            except urllib.error.HTTPError as exc:
                raw = exc.read()
                err_tid = self._note_trace(exc.headers)
                if exc.code == 415 and self.encoding == "binary":
                    # format mismatches are not transient failures, so the
                    # renegotiation retries spend no budget slots: first
                    # drop the frame codec to stdlib zlib, then give up on
                    # binary entirely and speak JSON
                    if self._codec != "zlib":
                        self._codec = "zlib"
                        continue
                    if not downgraded:
                        self.encoding = "json"
                        downgraded = True
                        continue
                if exc.code >= 500 and exc.code != 504:
                    last = TransportError(f"HTTP {exc.code} from {path}: "
                                          f"{raw[:256]!r}")
                    # an overloaded server's 503 may carry Retry-After —
                    # honor it below instead of hammering the fixed
                    # exponential schedule into the same congestion
                    retry_after = self._retry_after_s(exc.headers)
                    self.last_retry_after = retry_after
                    if exc.code == 503:
                        # admission pushback still retries (the server said
                        # when), but once the budget is spent the caller
                        # gets the typed rejection, not a bare transport
                        # error: reason/tenant/retry_after survive
                        rej = self._admission_error(
                            exc.headers.get("Content-Type", ""), raw,
                            err_tid, retry_after)
                        if rej is not None:
                            last = rej
                else:
                    # < 500 (structured API error) and 504 deadline_exceeded
                    # raise immediately: a missed deadline is the answer,
                    # not a transient fault to retry against a fresh budget
                    self._raise_api_error(
                        exc.code, exc.headers.get("Content-Type", ""), raw,
                        trace_id=err_tid)
            except P.StreamTruncated as exc:
                # the v2 stream died mid-transfer: indistinguishable from a
                # dropped connection, so it retries like one (other
                # ProtocolErrors — corrupt frames — raise through: resending
                # the request would fetch the same corruption)
                last = TransportError(f"stream truncated from {path}: {exc}")
            except (urllib.error.URLError, TimeoutError, ConnectionError,
                    OSError) as exc:
                last = TransportError(f"{type(exc).__name__}: {exc}")
            else:
                if status >= 400:  # non-raising urlopen implementations
                    self._raise_api_error(status, rtype, raw)
                if isinstance(raw, P._Wire):
                    # _request already decoded a v2 stream incrementally
                    if not isinstance(raw, expect):
                        raise P.ProtocolError(
                            f"expected {expect.__name__}, streamed "
                            f"{type(raw).__name__}")
                    return raw
                self.last_stream_chunks = 0
                return P.decode(rtype, raw, expect=expect)
            if attempt >= retries:
                raise last
            delay = self.backoff * (2 ** attempt)
            if retry_after is not None:
                delay = max(delay, retry_after)
            time.sleep(min(delay, self.backoff_cap))
            attempt += 1

    @staticmethod
    def _spec(k: int | None, eps: float | None,
              k_default: int | None = None) -> P.CoresetSpec | None:
        if k is None and eps is None:
            return None
        kk = k if k is not None else k_default
        if kk is None:
            raise ValueError("eps given without k and no default k available")
        return P.CoresetSpec(k=int(kk), eps=float(eps if eps is not None else 0.2))

    # ------------------------------------------------------------- registry
    def register_signal(self, name: str, values=None, *, synthetic=None,
                        replace: bool = False) -> P.SignalInfo:
        msg = P.RegisterRequest(
            signal=P.SignalRef(name=name),
            values=(np.ascontiguousarray(values, np.float64)
                    if values is not None else None),
            synthetic=synthetic, replace=replace)
        # replace=True is idempotent; replace=False is not — retrying it
        # after a lost response would 409 a registration that succeeded
        return self._call("/v1/signals", msg, P.SignalInfo,
                          retryable=replace)

    def ingest(self, name: str, band=None, *, synthetic=None) -> P.SignalInfo:
        msg = P.IngestRequest(
            signal=P.SignalRef(name=name),
            band=(np.ascontiguousarray(band, np.float64)
                  if band is not None else None),
            synthetic=synthetic)
        # append-only state mutation with no dedup token: a retry after a
        # lost response would ingest the band twice and silently corrupt
        # the signal, so transport failures surface to the caller instead
        return self._call("/v1/ingest", msg, P.SignalInfo, retryable=False)

    def ingest_delta(self, name: str, band, *, row0: int | None = None,
                     ) -> P.IngestDeltaResponse:
        """Delta write: ship ONLY the changed rows.  ``row0`` pins the
        absolute row offset of the replaced band (on streamed signals it
        must start an ingested band); None appends at the current end.  The
        server patches its integral images and merge-reduce state
        incrementally instead of re-ingesting the whole signal."""
        msg = P.IngestDeltaRequest(
            signal=P.SignalRef(name=name),
            band=np.ascontiguousarray(band, np.float64),
            row0=int(row0) if row0 is not None else None)
        # replacement is idempotent (same row0 + bytes -> same version), so
        # it may retry; an append retry would double-ingest like ingest()
        return self._call("/v1/ingest:delta", msg, P.IngestDeltaResponse,
                          retryable=row0 is not None)

    def ingest_delta_burst(self, name: str, deltas,
                           ) -> P.IngestDeltaResponse:
        """MANY delta writes in one request: ``deltas`` is a sequence of
        ``(row0, band)`` pairs (row0=None appends).  The bands are
        concatenated on the wire and the server fans their per-band leaf
        rebuilds out through one batched scheduler submission instead of N
        sequential builds — the cheap way to apply a burst of band
        replacements."""
        deltas = [(None if r0 is None else int(r0),
                   np.ascontiguousarray(b, np.float64)) for r0, b in deltas]
        if not deltas:
            raise ValueError("burst needs at least one (row0, band) delta")
        msg = P.IngestDeltaRequest(
            signal=P.SignalRef(name=name),
            band=np.concatenate([b for _, b in deltas], axis=0),
            row0s=[r0 for r0, _ in deltas],
            rows=[int(b.shape[0]) for _, b in deltas])
        # retryable only when every delta is an idempotent replacement
        return self._call("/v1/ingest:delta", msg, P.IngestDeltaResponse,
                          retryable=all(r0 is not None for r0, _ in deltas))

    # -------------------------------------------------------------- queries
    def build(self, name: str, k: int, eps: float = 0.2, *,
              deadline_ms: float | None = None) -> P.BuildResponse:
        msg = P.BuildRequest(signal=P.SignalRef(name=name),
                             spec=P.CoresetSpec(k=k, eps=eps),
                             deadline_ms=self._deadline(deadline_ms))
        return self._call("/v1/build", msg, P.BuildResponse)

    def query_loss(self, name: str, rects, labels, *, k: int | None = None,
                   eps: float | None = None,
                   deadline_ms: float | None = None,
                   coalesce: bool = True) -> P.LossResponse:
        """One tree's loss.  Concurrent same-signal queries (from any
        connection) fuse server-side into one batched dispatch — the
        response's ``fused_batch_size`` says how many rode along;
        ``coalesce=False`` opts this request out."""
        rects = np.asarray(rects, np.int64).reshape(-1, 4)
        msg = P.LossQuery(
            signal=P.SignalRef(name=name), rects=rects,
            labels=np.asarray(labels, np.float64).ravel(),
            spec=self._spec(k, eps, k_default=max(rects.shape[0], 1)),
            deadline_ms=self._deadline(deadline_ms), coalesce=coalesce)
        return self._call("/v1/query/loss", msg, P.LossResponse)

    def query_loss_batch(self, name: str, rects, labels, *,
                         k: int | None = None, eps: float | None = None,
                         deadline_ms: float | None = None,
                         coalesce: bool = True) -> P.BatchLossResponse:
        """Score T same-signal segmentations in ONE fused request:
        ``rects`` (T, K, 4), ``labels`` (T, K).  ``coalesce=False`` skips
        the server's cross-request fusion and dispatches the batch alone."""
        rects = np.asarray(rects, np.int64)
        labels = np.asarray(labels, np.float64)
        if rects.ndim != 3:
            raise ValueError("batch rects must have shape (T, K, 4)")
        msg = P.BatchLossQuery(
            signal=P.SignalRef(name=name), rects=rects, labels=labels,
            spec=self._spec(k, eps, k_default=max(rects.shape[1], 1)),
            deadline_ms=self._deadline(deadline_ms), coalesce=coalesce)
        return self._call("/v1/query/loss:batch", msg, P.BatchLossResponse)

    def fit(self, name: str, k: int, eps: float = 0.2, *,
            n_estimators: int = 10, max_leaves: int | None = None,
            predict=None, seed: int = 0,
            deadline_ms: float | None = None) -> P.FitResponse:
        msg = P.FitRequest(
            signal=P.SignalRef(name=name), spec=P.CoresetSpec(k=k, eps=eps),
            n_estimators=n_estimators, max_leaves=max_leaves,
            predict=(np.asarray(predict, np.float64).reshape(-1, 2)
                     if predict is not None else None),
            seed=seed, deadline_ms=self._deadline(deadline_ms))
        return self._call("/v1/query/fit", msg, P.FitResponse)

    def compress(self, name: str, k: int, eps: float = 0.2, *,
                 target_frac: float | None = None, style: str = "mean",
                 max_points: int = 4096,
                 deadline_ms: float | None = None) -> P.CompressResponse:
        msg = P.CompressRequest(
            signal=P.SignalRef(name=name), spec=P.CoresetSpec(k=k, eps=eps),
            target_frac=target_frac, style=style, max_points=max_points,
            deadline_ms=self._deadline(deadline_ms))
        return self._call("/v1/query/compress", msg, P.CompressResponse,
                          stream=self.stream and self.encoding == "binary")

    # ------------------------------------------------------------ telemetry
    def _get_json(self, path: str) -> dict:
        try:
            status, _, raw = self._request("GET", path, None, None)
        except urllib.error.HTTPError as exc:
            self._raise_api_error(exc.code, exc.headers.get("Content-Type", ""),
                                  exc.read())
        if status >= 400:
            self._raise_api_error(status, "application/json", raw)
        return json.loads(raw)

    def healthz(self) -> dict:
        return self._get_json("/v1/healthz")

    def stats(self) -> dict:
        return self._get_json("/v1/stats")

    def metrics_text(self) -> str:
        _, _, raw = self._request("GET", "/v1/metrics", None, None)
        return raw.decode()

    def traces_recent(self, limit: int = 50) -> list[dict]:
        """Newest-first summaries of the server's completed traces."""
        return self._get_json(f"/v1/traces:recent?limit={int(limit)}")["traces"]

    def trace(self, trace_id: str | None = None, *,
              format: str | None = None) -> dict:
        """Fetch one server-side trace (default: the LAST request's —
        ``last_trace_id``).  ``format="chrome"`` returns Chrome trace-event
        JSON that Perfetto / chrome://tracing load directly."""
        tid = trace_id or self.last_trace_id
        if not tid:
            raise ValueError("no trace_id given and no request made yet")
        suffix = "?format=chrome" if format == "chrome" else ""
        return self._get_json(f"/v1/trace/{tid}{suffix}")
