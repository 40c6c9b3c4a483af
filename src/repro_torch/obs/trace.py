"""Spans, traces, and the completed-trace ring buffer.

Stdlib-only (the serving layer runs in a bare container, same constraint as
``service/metrics.py``).  The model is a deliberately small slice of
OpenTelemetry:

  * a **trace** is a tree of spans sharing one 128-bit ``trace_id``; the
    HTTP layer mints one per request (or *continues* the caller's via the
    W3C ``traceparent`` header, so an SDK-side id and the server-side trace
    are the same trace);
  * a **span** is one timed hop (http handler, scheduler wait, coreset
    build, ops dispatch) with attributes and optional **links** to spans in
    OTHER traces — the coalescing escape hatch: one fused dispatch span is
    linked from every request trace that rode in it, because a span cannot
    have N parents;
  * finished traces land in a bounded thread-safe ring buffer on the
    :class:`Tracer`, served by ``GET /v1/traces:recent`` and
    ``GET /v1/trace/{id}``, with a Chrome trace-event export
    (``?format=chrome``) that Perfetto loads directly.

Propagation is contextvar-based *within* a thread (``tracer.span(...)``
nests under the current span automatically) and explicit *across* threads:
a scheduler captures ``current_span()`` at submit and re-enters it on the
worker with :func:`Tracer.attach` — thread pools do not inherit context.

Overhead discipline: when no trace is active (pure-library callers, or
tracing disabled) every entry point returns the singleton :data:`NOOP`
span, whose methods do nothing — the hot ``ops.dispatch`` path pays one
contextvar read, nothing else.  The <5% serving-overhead budget is gated in
CI (``scripts/check_bench_regression.py``, ``tracing`` row).
"""
from __future__ import annotations

import contextvars
import json
import os
import random
import re
import threading
import time
from collections import OrderedDict

__all__ = [
    "Span", "SpanContext", "Tracer", "NOOP", "TRACER",
    "parse_traceparent", "format_traceparent", "mint_trace_id",
    "mint_span_id", "current_span",
]

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

# the current span of THIS thread of execution (contextvars, not
# threading.local: generators/ctx managers compose correctly, and worker
# threads get a clean slate instead of a stale inherited value)
_CURRENT: contextvars.ContextVar["Span | None"] = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)


# id minting sits on the per-span hot path (the <5% overhead budget), so
# ids come from a process-local PRNG seeded once from the OS — ~4x cheaper
# than os.urandom per call, and uniqueness (not secrecy) is all ids need.
# Single getrandbits calls are atomic under the GIL, so no lock.
_ID_RNG = random.Random(int.from_bytes(os.urandom(16), "big"))


def mint_trace_id() -> str:
    """128-bit lowercase-hex trace id (W3C trace-context format)."""
    return "%032x" % _ID_RNG.getrandbits(128)


def mint_span_id() -> str:
    """64-bit lowercase-hex span id."""
    return "%016x" % _ID_RNG.getrandbits(64)


# thread names are stable per thread; current_thread() costs ~0.5us per
# call, so cache the name in a threading.local for the span hot path
_TLS = threading.local()


def _thread_name() -> str:
    try:
        return _TLS.name
    except AttributeError:
        name = _TLS.name = threading.current_thread().name
        return name


def parse_traceparent(header: str | None) -> tuple[str, str] | None:
    """(trace_id, parent span_id) from a W3C ``traceparent`` header, or
    None when absent/malformed/all-zero (the spec says ignore, not fail)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


def format_traceparent(trace_id: str, span_id: str) -> str:
    """W3C header for an outgoing hop (always sampled: 01)."""
    return f"00-{trace_id}-{span_id}-01"


class SpanContext:
    """The addressable identity of a span — what links and traceparent
    headers carry across trace boundaries."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}


class Span:
    """One timed operation.  Create through the :class:`Tracer`; ``end()``
    records it (idempotent — double-end keeps the first duration)."""

    __slots__ = ("_tracer", "name", "trace_id", "span_id", "parent_id",
                 "start_pc", "end_pc", "attrs", "links", "thread", "_token")

    def __init__(self, tracer: "Tracer", name: str, trace_id: str,
                 span_id: str, parent_id: str | None, attrs: dict | None):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.end_pc: float | None = None
        # lazily materialized: most spans carry no attrs and no links, and
        # allocations per span add up on the hot path.  attrs is stored by
        # REFERENCE — every call site passes a fresh kwargs/literal dict,
        # and readers copy (_span_dict) before handing records out
        self.attrs: dict | None = attrs if attrs else None
        self.links: list[dict] | None = None
        self.thread = _thread_name()
        self._token = None
        self.start_pc = time.perf_counter()

    # ------------------------------------------------------------ recording
    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set_attr(self, key: str, value) -> None:
        a = self.attrs
        if a is None:
            a = self.attrs = {}
        a[key] = value

    def add_link(self, ctx: "SpanContext | Span", **attrs) -> None:
        """Link to a span in another trace (the coalesced-dispatch edge)."""
        link = {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
        if attrs:
            link["attrs"] = attrs
        if self.links is None:
            self.links = []
        self.links.append(link)

    def end(self) -> None:
        if self.end_pc is not None:
            return
        self.end_pc = time.perf_counter()
        self._tracer._record(self)

    # span objects are truthy; NOOP overrides to False so callers can
    # cheaply skip optional work (attribute formatting) when not tracing
    def __bool__(self) -> bool:
        return True


class _NoopSpan(Span):
    """Do-nothing span: returned whenever tracing is off or no trace is
    active, so call sites never branch."""

    __slots__ = ()

    def __init__(self):  # noqa: super().__init__ deliberately skipped
        pass

    name = "noop"
    trace_id = ""
    span_id = ""
    parent_id = None
    attrs: dict = {}
    links: list = []

    @property
    def context(self):
        return None

    def set_attr(self, key, value):
        pass

    def add_link(self, ctx, **attrs):
        pass

    def end(self):
        pass

    def __bool__(self):
        return False


NOOP = _NoopSpan()


class _SpanCM:
    """``with tracer.span(...)``: opens a child span on enter, makes it
    current, ends it on exit.  NOOP pass-through outside a trace."""

    __slots__ = ("_tracer", "_name", "_attrs", "_span", "_token")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict | None):
        self._tracer = tracer
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        sp = self._tracer.child_span(self._name, attrs=self._attrs)
        self._span = sp
        self._token = _CURRENT.set(sp) if sp else None
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._span.end()
        return False


class _AttachCM:
    """``with tracer.attach(span)``: make a captured span current on this
    thread for the duration.  No-op for None/NOOP spans."""

    __slots__ = ("_span", "_token")

    def __init__(self, span: Span | None):
        self._span = span
        self._token = None

    def __enter__(self) -> None:
        if self._span:
            self._token = _CURRENT.set(self._span)
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        return False


class _ActiveTrace:
    __slots__ = ("spans", "root_span_id")

    def __init__(self, root_span_id: str):
        self.spans: list[dict] = []
        self.root_span_id = root_span_id


class Tracer:
    """Span factory + bounded ring buffer of completed traces.

    A trace is *finalized* (moved to the ring) when its **root** span —
    the span the tracer created with no in-trace parent — ends.  In this
    codebase every child span ends before its root does (handlers block on
    the futures their spans wrap), but a straggler that ends after
    finalization is appended to the finished trace if it is still in the
    ring, and dropped otherwise — never lost silently: ``spans_dropped``
    counts them.
    """

    def __init__(self, capacity: int = 512, enabled: bool = True,
                 max_spans_per_trace: int = 256):
        self.capacity = int(capacity)
        self.max_spans_per_trace = int(max_spans_per_trace)
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        # readers waiting for an in-flight trace to finalize (see get()):
        # shares _lock, so notify happens under the same mutual exclusion
        self._cond = threading.Condition(self._lock)
        self._active: dict[str, _ActiveTrace] = {}
        self._finished: "OrderedDict[str, dict]" = OrderedDict()
        self.completed_total = 0
        self.spans_dropped = 0
        # export anchor: spans time with perf_counter (monotonic); exports
        # shift onto the wall clock through one (wall, pc) pair
        self._anchor_wall = time.time()
        self._anchor_pc = time.perf_counter()

    # -------------------------------------------------------------- control
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        self._enabled = bool(on)

    # -------------------------------------------------------------- creation
    def start_trace(self, name: str, *, traceparent: str | None = None,
                    links=None, attrs: dict | None = None) -> Span:
        """Open a new trace (or continue the caller's, when a valid
        ``traceparent`` is given) and return its root span.  The caller
        must ``attach()`` it to make it current, and ``end()`` it to
        finalize the trace."""
        if not self._enabled:
            return NOOP
        parent = parse_traceparent(traceparent)
        if parent is not None:
            trace_id, parent_id = parent
        else:
            trace_id, parent_id = mint_trace_id(), None
        span = Span(self, name, trace_id, mint_span_id(), parent_id, attrs)
        if links:
            for ctx in links:
                if ctx is not None:
                    span.add_link(ctx)
        with self._lock:
            self._active[trace_id] = _ActiveTrace(span.span_id)
        return span

    def child_span(self, name: str, *, parent: Span | SpanContext | None = None,
                   attrs: dict | None = None) -> Span:
        """A span under ``parent`` (default: this thread's current span).
        With no parent and no current span this is a NOOP — library callers
        outside a request pay one contextvar read and nothing else."""
        if not self._enabled:
            return NOOP
        if parent is None:
            parent = _CURRENT.get()
        if parent is None or not parent:
            return NOOP
        return Span(self, name, parent.trace_id, mint_span_id(),
                    parent.span_id, attrs)

    def span(self, name: str, **attrs) -> "_SpanCM":
        """Context manager: child of the current span, made current for the
        duration.  Yields the span (NOOP outside a trace).  Class-based
        rather than @contextmanager: the generator machinery costs ~1us per
        use, which matters at several spans per request."""
        return _SpanCM(self, name, attrs or None)

    def attach(self, span: Span | None) -> "_AttachCM":
        """Make ``span`` current on THIS thread (cross-thread re-entry: a
        scheduler captured it at submit, the worker attaches it)."""
        return _AttachCM(span)

    # ------------------------------------------------------------- recording
    # Spans are stored as tuples and turned into dicts only when read:
    # recording is per-span-end on the serving hot path, reading is a human
    # hitting /v1/trace — so the dict building belongs on the read side.
    # The hot branch is lock-free: dict.get and list.append are GIL-atomic,
    # and only finalize/straggler handling (rare) takes the lock.
    def _record(self, span: Span) -> None:
        dur = (span.end_pc - span.start_pc) * 1e6
        rec = (span.name, span.trace_id, span.span_id, span.parent_id,
               (self._anchor_wall + (span.start_pc - self._anchor_pc)) * 1e6,
               dur if dur > 0.0 else 0.0, span.thread, span.attrs, span.links)
        active = self._active.get(span.trace_id)
        if active is not None:
            if len(active.spans) < self.max_spans_per_trace:
                active.spans.append(rec)
            else:
                with self._lock:
                    self.spans_dropped += 1
            if span.span_id == active.root_span_id:
                with self._lock:
                    self._finalize_locked(span.trace_id, rec)
            return
        with self._lock:
            done = self._finished.get(span.trace_id)
            if done is not None and \
                    len(done["spans"]) < self.max_spans_per_trace:
                done["spans"].append(rec)   # straggler after finalize
            else:
                self.spans_dropped += 1

    def _finalize_locked(self, trace_id: str, root_rec: tuple) -> None:
        active = self._active.pop(trace_id, None)
        if active is None:      # already finalized by a racing end()
            return
        self._finished[trace_id] = {
            "trace_id": trace_id,
            "root": root_rec[0],
            "start_us": root_rec[4],
            "duration_us": root_rec[5],
            "spans": active.spans,
        }
        self.completed_total += 1
        while len(self._finished) > self.capacity:
            self._finished.popitem(last=False)
        self._cond.notify_all()

    @staticmethod
    def _span_dict(rec: tuple) -> dict:
        d = {"name": rec[0], "trace_id": rec[1], "span_id": rec[2],
             "parent_id": rec[3], "start_us": rec[4], "duration_us": rec[5],
             "thread": rec[6]}
        if rec[7]:
            d["attrs"] = dict(rec[7])
        if rec[8]:
            d["links"] = [dict(li) for li in rec[8]]
        return d

    # --------------------------------------------------------------- reading
    def recent(self, limit: int = 50) -> list[dict]:
        """Newest-first summaries of completed traces."""
        with self._lock:
            items = list(self._finished.values())
        out = []
        for t in reversed(items[-max(int(limit), 0):] if limit else items):
            out.append({"trace_id": t["trace_id"], "root": t["root"],
                        "start_us": t["start_us"],
                        "duration_us": t["duration_us"],
                        "spans": len(t["spans"])})
        return out

    def get(self, trace_id: str, *, resolve_links: bool = True,
            wait_s: float = 0.0) -> dict | None:
        """One completed trace, plus (one hop of) the traces its spans link
        to — so a request trace arrives together with the fused-dispatch
        trace it rode in.

        ``wait_s`` bounds a wait for a trace that is still ACTIVE: the HTTP
        layer writes the response body *before* the request's root span ends
        (the observation must not gate the reply), so a client that turns
        around and fetches its own trace can arrive in the microseconds
        between reply and finalize.  Waiting only applies to known in-flight
        trace ids — an id the tracer has never seen returns None immediately,
        so a bad id cannot stall the trace route."""
        with self._cond:
            if wait_s > 0.0:
                deadline = time.perf_counter() + wait_s
                while (trace_id not in self._finished
                       and trace_id in self._active):
                    left = deadline - time.perf_counter()
                    if left <= 0.0:
                        break
                    self._cond.wait(left)
            t = self._finished.get(trace_id)
            if t is None:
                return None
            spans = [self._span_dict(s) for s in t["spans"]]
            out = {"trace_id": t["trace_id"], "root": t["root"],
                   "start_us": t["start_us"], "duration_us": t["duration_us"],
                   "spans": spans}
            if resolve_links:
                linked_ids = []
                for s in spans:
                    for link in s.get("links", ()):
                        lid = link["trace_id"]
                        if lid != trace_id and lid not in linked_ids:
                            linked_ids.append(lid)
                linked = []
                for lid in linked_ids:
                    lt = self._finished.get(lid)
                    if lt is not None:
                        linked.append(
                            {"trace_id": lid, "root": lt["root"],
                             "spans": [self._span_dict(s)
                                       for s in lt["spans"]]})
                out["linked_traces"] = linked
        return out

    def chrome(self, trace_id: str, *, wait_s: float = 0.0) -> dict | None:
        """Chrome trace-event JSON (Perfetto loads it as-is): the trace's
        spans as complete ("X") events, linked traces as separate process
        groups, and flow arrows ("s"/"f") along every link."""
        t = self.get(trace_id, resolve_links=True, wait_s=wait_s)
        if t is None:
            return None
        events: list[dict] = []
        flow_id = 0

        def emit(spans, pid, label):
            nonlocal flow_id
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": label}})
            for s in spans:
                args = dict(s.get("attrs", {}))
                args["span_id"] = s["span_id"]
                if s.get("parent_id"):
                    args["parent_id"] = s["parent_id"]
                events.append({
                    "name": s["name"], "cat": "coreset", "ph": "X",
                    "ts": s["start_us"], "dur": s["duration_us"],
                    "pid": pid, "tid": s.get("thread", "?"),
                    "args": args})
                for link in s.get("links", ()):
                    flow_id += 1
                    events.append({"name": "link", "cat": "link", "ph": "s",
                                   "id": flow_id, "pid": pid,
                                   "tid": s.get("thread", "?"),
                                   "ts": s["start_us"] + s["duration_us"] / 2,
                                   "args": link})

        emit(t["spans"], 1, f"trace {t['trace_id'][:8]} ({t['root']})")
        for i, lt in enumerate(t.get("linked_traces", ()), start=2):
            emit(lt["spans"], i, f"linked {lt['trace_id'][:8]} ({lt['root']})")
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def chrome_json(self, trace_id: str, *, wait_s: float = 0.0) -> bytes | None:
        doc = self.chrome(trace_id, wait_s=wait_s)
        return None if doc is None else json.dumps(doc).encode()

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self._enabled, "capacity": self.capacity,
                    "buffered": len(self._finished),
                    "active": len(self._active),
                    "completed_total": self.completed_total,
                    "spans_dropped": self.spans_dropped}

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._finished.clear()


def current_span() -> Span | None:
    """This thread-of-execution's current span (None outside a trace)."""
    return _CURRENT.get()


# the process-global tracer every layer records into by default; tests
# build private Tracer instances instead of mutating this one
TRACER = Tracer()
