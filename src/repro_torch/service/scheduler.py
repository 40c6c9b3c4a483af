"""Continuous-batching build scheduler.

Coreset builds are the expensive path (O(Nk) over the signal); concurrent
clients routinely ask for the same (signal, k, eps) — a tuning sweep fans
out dozens of identical build-then-query requests.  The scheduler gives the
serving layer three things:

  * **coalescing** — identical in-flight build keys share one future, so a
    thundering herd pays for one build;
  * **micro-batching** — requests are drained from the queue in small
    windows (``batch_window`` seconds) and dispatched together, which keeps
    the worker pool saturated without a lock per request;
  * **bounded concurrency** — at most ``max_workers`` builds run at once;
    each build itself fans row bands out via ``core.sharded`` (thread pool
    over band builds; NumPy releases the GIL in the hot loops), so total
    parallelism is workers x bands.

The design follows the continuous-batching front of ``launch/serve.py`` but
for *builds* instead of decode steps: arrivals during a window join the
current batch instead of waiting for a full one.
"""
from __future__ import annotations

import concurrent.futures as _fut
import queue
import threading
import time
from typing import Callable

from repro_torch import obs

from .metrics import ServiceMetrics
from .query_scheduler import DeadlineExceeded

__all__ = ["BuildScheduler"]

_SHUTDOWN = object()


class BuildScheduler:
    def __init__(self, max_workers: int = 4, batch_window: float = 0.004,
                 max_batch: int = 32, metrics: ServiceMetrics | None = None):
        self.metrics = metrics or ServiceMetrics()
        self.batch_window = float(batch_window)
        self.max_batch = int(max_batch)
        self._pool = _fut.ThreadPoolExecutor(max_workers=max_workers,
                                             thread_name_prefix="coreset-build")
        self._queue: queue.SimpleQueue = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._pending: dict[tuple, _fut.Future] = {}
        # key -> latest waiter deadline; absent = at least one forever-waiter
        self._deadlines: dict[tuple, float] = {}
        self._closed = False
        self._collector = threading.Thread(target=self._collect_loop,
                                           name="coreset-batcher", daemon=True)
        self._collector.start()

    # ---------------------------------------------------------------- submit
    def submit(self, key: tuple, fn: Callable[[], object], *,
               deadline: float | None = None) -> tuple[_fut.Future, bool]:
        """Enqueue a build; returns (future, created).

        ``created`` is False when an identical key was already in flight and
        the caller was coalesced onto its future.  ``deadline`` (absolute
        ``time.perf_counter()``) lets the worker skip a build every waiter
        has already abandoned: joining an in-flight key extends its deadline
        to the latest waiter's (None = wait forever), so a build is only
        dropped when ALL its waiters expired.
        """
        with self._lock:
            if self._closed:
                raise RuntimeError("scheduler is shut down")
            existing = self._pending.get(key)
            if existing is not None:
                if key in self._deadlines:
                    if deadline is None:   # a forever-waiter joined: never drop
                        del self._deadlines[key]
                    else:
                        self._deadlines[key] = max(self._deadlines[key],
                                                   deadline)
                self.metrics.inc("builds_coalesced")
                return existing, False
            fut: _fut.Future = _fut.Future()
            self._pending[key] = fut
            if deadline is not None:
                self._deadlines[key] = deadline
            # enqueue under the lock: shutdown() also takes it before posting
            # the sentinel, so an accepted item can never land behind
            # _SHUTDOWN and leave its future forever unresolved.  The
            # submitter's current span rides along: worker threads don't
            # inherit contextvars, so the build span re-parents explicitly
            self._queue.put((key, fn, fut, time.perf_counter(),
                             obs.current_span()))
        self.metrics.inc("builds_enqueued")
        return fut, True

    # --------------------------------------------------------- batching loop
    def _collect_loop(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SHUTDOWN:
                return
            batch = [item]
            deadline = time.perf_counter() + self.batch_window
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is _SHUTDOWN:
                    self._dispatch(batch)
                    return
                batch.append(nxt)
            self._dispatch(batch)

    def _dispatch(self, batch: list) -> None:
        self.metrics.inc("build_batches")
        self.metrics.inc("build_batch_items", len(batch))  # mean size = items/batches
        for key, fn, fut, enq_t, parent in batch:
            self.metrics.observe("build_queue_wait", time.perf_counter() - enq_t)
            self._pool.submit(self._run_one, key, fn, fut, parent)

    def _run_one(self, key: tuple, fn: Callable, fut: _fut.Future,
                 parent=None) -> None:
        with self._lock:
            dl = self._deadlines.get(key)
            expired = dl is not None and time.perf_counter() > dl
            if expired:
                # every waiter's deadline already passed: don't burn a
                # worker on a build nobody will read.  The key is popped
                # UNDER the same lock as the check, so a late submit cannot
                # coalesce onto the doomed future after the drop decision —
                # it starts a fresh build instead
                self._pending.pop(key, None)
                self._deadlines.pop(key, None)
        span = obs.child_span("build.run", parent=parent,
                              attrs={"key": str(key)})
        if expired:
            self.metrics.inc("builds_expired")
            if span:
                span.set_attr("outcome", "deadline_expired")
                span.end()
            fut.set_exception(DeadlineExceeded(
                "every waiter's deadline expired before the build started"))
            return
        if not fut.set_running_or_notify_cancel():
            if span:
                span.set_attr("outcome", "cancelled")
                span.end()
            return
        try:
            with obs.attach(span), self.metrics.timed("build"):
                result = fn()
        except BaseException as exc:  # propagate to every coalesced waiter
            self.metrics.inc("builds_failed")
            if span:
                span.set_attr("outcome", type(exc).__name__)
            fut.set_exception(exc)
        else:
            self.metrics.inc("builds_completed")
            if span:
                span.set_attr("outcome", "ok")
            fut.set_result(result)
        finally:
            span.end()
            with self._lock:
                self._pending.pop(key, None)
                self._deadlines.pop(key, None)

    # -------------------------------------------------------------- shutdown
    def in_flight(self) -> int:
        with self._lock:
            return len(self._pending)

    def load(self) -> dict:
        """Queue-pressure snapshot for admission control / the overload
        gate: coalesced build keys pending (submitted, not yet finished)
        and how many of them carry at least one waiter deadline."""
        with self._lock:
            return {"pending": len(self._pending),
                    "with_deadline": sum(d is not None
                                         for d in self._deadlines.values())}

    def shutdown(self, wait: bool = True) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(_SHUTDOWN)
        if wait:
            self._collector.join(timeout=5.0)
        self._pool.shutdown(wait=wait)
