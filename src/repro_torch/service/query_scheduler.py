"""Cross-request query coalescing — the BuildScheduler pattern for *reads*.

The batched fitting-loss kernel (``csrc/fitting_loss.cu``, one tree a CTA)
only earns its T axis when many trees arrive in one dispatch.  A single
client can hand us that batch through ``/v1/query/loss:batch``, but
production traffic is the other shape: many *connections*, each carrying
one tree against the same hot signal.  Served naively that is one ``fitting_loss`` dispatch per
connection — the kernel's fixed cost (dispatch, transfer, tile fill) paid N
times for work one fused evaluation covers.

``QueryScheduler`` closes that gap server-side:

  * **enqueue** — incoming loss queries are bucketed by *fusion key*
    ``(coreset fingerprint, k, eps, backend)``: only queries that would
    score against the SAME cached coreset on the SAME backend may fuse
    (mixed-k queries resolve different coresets, so they never share a
    bucket);
  * **window** — a bucket waits a small batching window (default 2 ms) for
    co-travellers, flushing early when the T tile fills (``max_fuse``) or
    when waiting longer would push a request past its deadline;
  * **fuse** — the bucket's trees are padded to a common leaf count with
    zero-area rects (which contribute exactly zero loss — the smoothed
    assignment consumes no weight over an empty cumulative-area interval)
    and dispatched as ONE ``fitting_loss_batched`` evaluation;
  * **scatter** — per-request losses return to their futures, each response
    reporting the ``fused_batch_size`` it rode in.

Deadline semantics: a request whose deadline expires while queued fails
with :class:`DeadlineExceeded` (HTTP 504) *without* poisoning the batch —
the remaining requests still serve.  A request whose deadline is nearer
than the window trims the bucket's flush time instead of waiting.

The window is a deliberate latency-for-throughput trade: EVERY query —
including a solitary one with no co-traveller — waits up to ``window``
(default 2 ms) before dispatch.  Against the serving path's typical
multi-ms query latencies that is amortization, not overhead; a
latency-critical client with known-uncontended traffic opts out per
request (``coalesce=False``) or engine-wide and scores inline.

The same worker pool doubles as a generic fan-out (:meth:`map_fanout`):
``CoresetEngine.ingest_delta`` batches a delta burst's per-band leaf
``signal_coreset`` rebuilds through one submission instead of N sequential
builds.
"""
from __future__ import annotations

import concurrent.futures as _fut
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch import obs

from .metrics import ServiceMetrics

__all__ = ["QueryScheduler", "DeadlineExceeded", "FUSED_SIZE_BOUNDS"]

# fused-batch-size histogram buckets: powers of two up to well past any
# sane T tile
FUSED_SIZE_BOUNDS = (1, 2, 4, 8, 16, 32, 64, 128)


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before its result was produced.  The
    HTTP layer maps this (and result-wait timeouts) to 504 with the uniform
    error envelope."""


class _Pending:
    """One enqueued loss submission: its tree(s) plus where the answer goes.

    Storage is uniformly 3-D — ``rects`` (C, K, 4) / ``labels`` (C, K) with
    ``count`` = C trees — so a single query (C=1, the /query/loss path) and
    a client batch (C=T, the /query/loss:batch path) ride the SAME fusion
    buckets; ``batch`` only decides the result shape (scalar vs (C,) array).

    ``span`` is the request trace's ``query.scheduler_wait`` span, opened at
    enqueue on the submitting thread and ended when the answer (or the
    deadline error) reaches the future — so the request trace shows exactly
    how long it sat in the batching window, and carries the link to the
    fused dispatch span it rode in."""

    __slots__ = ("rects", "labels", "count", "batch", "deadline", "future",
                 "span")

    def __init__(self, rects: np.ndarray, labels: np.ndarray,
                 deadline: float | None, *, batch: bool = False):
        self.rects = rects
        self.labels = labels
        self.count = int(rects.shape[0])
        self.batch = batch
        self.deadline = deadline
        self.future: _fut.Future = _fut.Future()
        self.span = obs.child_span("query.scheduler_wait")

    def finish_span(self, **attrs) -> None:
        if self.span:
            for k, v in attrs.items():
                self.span.set_attr(k, v)
            self.span.end()


class _Bucket:
    """Queries sharing one fusion key, waiting out the batching window."""

    __slots__ = ("key", "execute", "items", "size", "flush_at", "window_at",
                 "trimmed")

    def __init__(self, key: tuple, execute: Callable, window: float,
                 now: float):
        self.key = key
        self.execute = execute
        self.items: list[_Pending] = []
        self.size = 0                   # total TREES queued (sum of counts)
        self.window_at = now + window   # the untrimmed window expiry
        self.flush_at = self.window_at
        self.trimmed = False            # a deadline pulled flush_at forward


class QueryScheduler:
    """Fuse concurrent same-key loss queries into batched dispatches.

    ``execute`` callables are supplied per submission (the engine closes
    them over the resolved coreset + pinned backend); the first submission
    of a bucket wins, which is safe because the fusion key already pins
    everything the executor depends on.
    """

    def __init__(self, *, window: float = 0.002, max_fuse: int = 16,
                 max_workers: int = 4, deadline_margin: float = 0.001,
                 metrics: ServiceMetrics | None = None):
        self.metrics = metrics or ServiceMetrics()
        self.window = float(window)
        self.max_fuse = int(max_fuse)
        self.deadline_margin = float(deadline_margin)
        self._pool = _fut.ThreadPoolExecutor(max_workers=max_workers,
                                             thread_name_prefix="coreset-query")
        self._cond = threading.Condition()
        self._buckets: dict[tuple, _Bucket] = {}
        self._closed = False
        self._flusher = threading.Thread(target=self._flush_loop,
                                         name="query-batcher", daemon=True)
        self._flusher.start()

    # ---------------------------------------------------------------- submit
    def submit(self, key: tuple, rects: np.ndarray, labels: np.ndarray,
               execute: Callable[[np.ndarray, np.ndarray], np.ndarray], *,
               deadline: float | None = None) -> _fut.Future:
        """Enqueue one (K, 4)/(K,) loss query under ``key``.

        Returns a future resolving to ``(loss, fused_batch_size)``.
        ``execute(rects3, labels2)`` must return the (T,) losses of the
        padded batch in ONE dispatch.  ``deadline`` is an absolute
        ``time.perf_counter()`` instant.
        """
        rects = np.ascontiguousarray(rects, np.int64).reshape(-1, 4)
        labels = np.ascontiguousarray(labels, np.float64).ravel()
        item = _Pending(rects[None], labels[None], deadline)
        return self._enqueue(key, execute, item)

    def submit_batch(self, key: tuple, rects: np.ndarray, labels: np.ndarray,
                     execute: Callable[[np.ndarray, np.ndarray], np.ndarray],
                     *, deadline: float | None = None) -> _fut.Future:
        """Enqueue a client batch of T trees — (T, K, 4)/(T, K) — into the
        SAME fusion bucket single queries use (the key pins coreset
        fingerprint + backend, so co-travelling singles and batches score
        identically).  Returns a future resolving to ``((T,) losses,
        fused_batch_size)`` where ``fused_batch_size`` counts every tree of
        the fused dispatch this batch rode in."""
        rects = np.ascontiguousarray(rects, np.int64)
        labels = np.ascontiguousarray(labels, np.float64)
        if rects.ndim != 3 or rects.shape[-1] != 4 or \
                labels.shape != rects.shape[:2]:
            raise ValueError("batch needs rects (T, K, 4) and labels (T, K)")
        item = _Pending(rects, labels, deadline, batch=True)
        return self._enqueue(key, execute, item)

    def _enqueue(self, key: tuple, execute: Callable,
                 item: _Pending) -> _fut.Future:
        now = time.perf_counter()
        deadline = item.deadline
        if deadline is not None and deadline <= now:
            item.finish_span(outcome="deadline_expired_pre_enqueue")
            item.future.set_exception(DeadlineExceeded(
                "deadline expired before the query was enqueued"))
            self.metrics.inc("query_deadline_expired")
            return item.future
        full = None
        with self._cond:
            if self._closed:
                raise RuntimeError("query scheduler is shut down")
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = self._buckets[key] = _Bucket(
                    key, execute, self.window, now)
            bucket.items.append(item)
            bucket.size += item.count
            if deadline is not None:
                cutoff = max(now, deadline - self.deadline_margin)
                if cutoff < bucket.flush_at:
                    bucket.flush_at = cutoff
                    bucket.trimmed = True
            if bucket.size >= self.max_fuse:
                full = self._buckets.pop(key)
            else:
                self._cond.notify()
        if full is not None:
            self._submit_dispatch(full, "full")
        return item.future

    def _submit_dispatch(self, bucket: _Bucket, reason: str) -> None:
        """Hand a popped bucket to the worker pool — or, if the pool
        refuses (shutdown raced the pop), dispatch inline on the calling
        thread: a popped bucket is invisible to the flusher and the drain,
        so failing to dispatch it would strand its futures and hang every
        deadline-less waiter forever."""
        try:
            self._pool.submit(self._dispatch, bucket, reason)
        except BaseException:
            self._dispatch(bucket, reason)

    # ----------------------------------------------------------- flush logic
    def _flush_loop(self) -> None:
        while True:
            due: list[_Bucket] = []
            with self._cond:
                if self._closed and not self._buckets:
                    return
                now = time.perf_counter()
                next_at = None
                for key in list(self._buckets):
                    b = self._buckets[key]
                    if b.flush_at <= now or self._closed:
                        due.append(self._buckets.pop(key))
                    elif next_at is None or b.flush_at < next_at:
                        next_at = b.flush_at
                if not due:
                    self._cond.wait(None if next_at is None
                                    else max(next_at - now, 0.0))
                    continue
            for b in due:
                reason = ("drain" if self._closed
                          else "deadline" if b.trimmed and b.flush_at < b.window_at
                          else "window")
                self._submit_dispatch(b, reason)

    def _dispatch(self, bucket: _Bucket, reason: str) -> None:
        """Fuse a bucket into one batched evaluation and scatter results."""
        self.metrics.inc("query_flushes", reason=reason)
        now = time.perf_counter()
        live: list[_Pending] = []
        for it in bucket.items:
            if it.deadline is not None and it.deadline <= now:
                # expired while queued: fail THIS request, serve the rest
                it.finish_span(outcome="deadline_expired_in_window")
                it.future.set_exception(DeadlineExceeded(
                    "deadline expired inside the batching window"))
                self.metrics.inc("query_deadline_expired")
            else:
                live.append(it)
        if not live:
            return
        total = sum(it.count for it in live)    # trees in the fused dispatch
        # the fused dispatch is shared work with N parents, which a span
        # tree cannot express: it gets its OWN trace, cross-linked both
        # ways — every request's wait span links to the fused span, and the
        # fused span links back to each request — so /v1/trace/{request}
        # resolves straight to the batch it rode in (and vice versa)
        req_ctxs = [it.span.context for it in live if it.span]
        fused = obs.start_trace(
            "query.fused_dispatch", links=req_ctxs,
            attrs={"reason": reason, "batch_size": total,
                   "requests": len(live)}) if req_ctxs \
            else obs.NOOP
        if fused:
            for it in live:
                it.span.add_link(fused.context, kind="fused_dispatch")
                it.span.set_attr("fused_trace_id", fused.trace_id)
        try:
            if len(live) == 1:
                rects3 = live[0].rects
                labels2 = live[0].labels
            else:
                kmax = max(it.rects.shape[1] for it in live)
                # zero-area padding rects consume no weight in the smoothed
                # assignment, so padded leaves contribute exactly 0 loss
                rects3 = np.zeros((total, kmax, 4), np.int64)
                labels2 = np.zeros((total, kmax), np.float64)
                off = 0
                for it in live:
                    rects3[off:off + it.count, :it.rects.shape[1]] = it.rects
                    labels2[off:off + it.count, :it.labels.shape[1]] = \
                        it.labels
                    off += it.count
            # attach the fused span so the ops.dispatch span underneath
            # nests in the fused trace, not in the flusher thread's void
            with obs.attach(fused):
                losses = np.asarray(bucket.execute(rects3, labels2),
                                    np.float64)
            if losses.shape != (total,):
                raise RuntimeError(
                    f"fused executor returned shape {losses.shape}, "
                    f"expected ({total},)")
        except BaseException as exc:
            self.metrics.inc("query_fused_failed")
            if fused:
                fused.set_attr("error", type(exc).__name__)
                fused.end()
            for it in live:
                it.finish_span(outcome="fused_dispatch_failed")
                it.future.set_exception(exc)
            return
        if fused:
            fused.end()
        self.metrics.inc("query_fused_dispatches")
        # co-travelling REQUESTS (not trees): a lone client batch of T trees
        # coalesced nothing; a batch joined by one single coalesced one
        self.metrics.inc("query_coalesced_total", len(live) - 1)
        self.metrics.observe("query_fused_batch_size", total,
                             bounds=FUSED_SIZE_BOUNDS, unit="")
        off = 0
        for it in live:
            it.finish_span(outcome="ok", fused_batch_size=total)
            if it.batch:
                it.future.set_result(
                    (losses[off:off + it.count].copy(), total))
            else:
                it.future.set_result((float(losses[off]), total))
            off += it.count

    # ---------------------------------------------------------------- fanout
    def map_fanout(self, fns: Sequence[Callable[[], object]]) -> list:
        """Run ``fns`` on the worker pool as ONE batched submission and
        return their results in order — the delta-burst leaf-rebuild path
        (N per-band ``signal_coreset`` builds in one fan-out instead of N
        sequential calls).  Falls back to inline execution once closed so
        shutdown-time callers still complete."""
        fns = list(fns)
        if not fns:
            return []
        self.metrics.inc("query_fanout_batches")
        self.metrics.inc("query_fanout_items", len(fns))
        with self._cond:
            closed = self._closed
        if closed or len(fns) == 1:
            return [fn() for fn in fns]
        futs = [self._pool.submit(fn) for fn in fns]
        return [f.result() for f in futs]

    # ------------------------------------------------------------- lifecycle
    def in_flight(self) -> int:
        with self._cond:
            return sum(len(b.items) for b in self._buckets.values())

    def load(self) -> dict:
        """Queue-pressure snapshot for admission control / the overload
        gate: queries still waiting in batching windows and how many fusion
        buckets they spread across (depth concentrated in one bucket drains
        in one dispatch; spread across many it drains serially)."""
        with self._cond:
            return {"queued": sum(len(b.items)
                                  for b in self._buckets.values()),
                    "buckets": len(self._buckets)}

    def shutdown(self, wait: bool = True) -> None:
        """Drain: every queued query is flushed (reason="drain") and served
        before the pool stops accepting work."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        if wait:
            self._flusher.join(timeout=5.0)
        self._pool.shutdown(wait=wait)
