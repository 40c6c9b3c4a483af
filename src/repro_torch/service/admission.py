"""Admission control & multi-tenant QoS: refuse un-meetable work on arrival.

The schedulers already fail doomed requests *at* their deadline (a 504 after
the queue wait proved fatal) — correct, but wasteful under overload: the
request still occupied queue slots, batching windows, and a pool thread
before dying.  This module moves the refusal to the front door.  An
:class:`AdmissionController` sits between HTTP decode and the engine
handlers (and between a cluster coordinator and its scatter RPCs) and makes
one O(1) decision per request:

  * **deadline guard** — per request class (``(kind, signal)``, the stable
    prefix of the QueryScheduler's fusion key) it tracks an EWMA of admitted
    end-to-end service time and the count of admitted-but-unfinished
    requests.  Predicted completion is ``ewma * (1 + depth / parallelism)``
    — the classic M/M/c shortcut: your own service time plus your share of
    draining everyone already ahead of you.  If the request carries a
    ``deadline_ms`` smaller than that, it is refused NOW (503
    ``overloaded``/``deadline_unmeetable``) instead of timing out at the
    deadline (504) — same outcome for the caller, none of the wasted work.
  * **weighted fair share** — each tenant (``X-Coreset-Tenant`` header, SDK
    ``tenant=`` arg, else ``"default"``) owns a token bucket refilled at
    ``rate_rps * w_t / sum(w)`` and an in-flight cap sized the same way, so
    a hot tenant degrades to *its* share instead of starving the rest.
    Weights come from config; unknown tenants join lazily at
    ``default_weight`` (shares are recomputed against the live weight sum,
    so a new tenant dilutes everyone proportionally, never to zero).

Every rejection carries a **Retry-After** hint: for rate rejections the time
until one token refills, for load rejections the predicted drain time —
both non-decreasing in queue depth, so well-behaved SDKs (ours honors
Retry-After) back off harder exactly when the server is deeper
under water.  Rejections never consume tokens: a retry storm cannot starve
the tenant's own future capacity.

Admitted work is untouched — the controller returns a :class:`Ticket` and
steps aside; coalescing, degraded mode, and the bytes of every response are
bitwise-identical to an engine without admission (gated by
``tests/test_admission.py``).  The decision itself is gated < 50µs in
``check_bench_regression.py`` (``qos`` suite).

Stdlib-only, same constraint as the rest of the serving layer.
"""
from __future__ import annotations

import contextvars
import threading
import time

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionRejected",
    "Ticket", "current_ticket", "DEFAULT_TENANT",
]

DEFAULT_TENANT = "default"

# the admission ticket of THIS thread of execution: set by the HTTP layer
# after it admits a request, read by inner layers (cluster coordinator) so
# one request is charged exactly once however many engine hops it makes
_TICKET: contextvars.ContextVar["Ticket | None"] = \
    contextvars.ContextVar("repro_admission_ticket", default=None)


def current_ticket() -> "Ticket | None":
    return _TICKET.get()


class AdmissionRejected(Exception):
    """Refused on arrival.  Maps to HTTP 503 + ``Retry-After`` with an
    ``overloaded`` envelope — distinct from 504 ``deadline_exceeded``,
    which is reserved for ADMITTED work that died at its deadline."""

    def __init__(self, reason: str, tenant: str, retry_after: float,
                 message: str):
        super().__init__(message)
        self.reason = reason
        self.tenant = tenant
        self.retry_after = retry_after
        self.message = message


class AdmissionConfig:
    """Static policy.  ``rate_rps``/``max_inflight`` are TOTALS split across
    tenants by weight; ``None`` disables that check entirely."""

    __slots__ = ("enabled", "tenants", "default_weight", "rate_rps",
                 "burst_s", "max_inflight", "alpha", "parallelism",
                 "deadline_guard")

    def __init__(self, *, enabled: bool = True,
                 tenants: dict[str, float] | None = None,
                 default_weight: float = 1.0,
                 rate_rps: float | None = None,
                 burst_s: float = 1.0,
                 max_inflight: int | None = None,
                 alpha: float = 0.2,
                 parallelism: int = 4,
                 deadline_guard: bool = True):
        self.enabled = bool(enabled)
        self.tenants = dict(tenants or {})
        self.default_weight = float(default_weight)
        self.rate_rps = None if rate_rps is None else float(rate_rps)
        self.burst_s = float(burst_s)
        self.max_inflight = None if max_inflight is None else int(max_inflight)
        self.alpha = float(alpha)
        self.parallelism = max(1, int(parallelism))
        self.deadline_guard = bool(deadline_guard)
        for name, w in self.tenants.items():
            if float(w) <= 0.0:
                raise ValueError(f"tenant {name!r} weight must be > 0")

    @classmethod
    def parse_tenants(cls, spec: str | None) -> dict[str, float]:
        """``"hot=2,cold=1"`` → ``{"hot": 2.0, "cold": 1.0}`` (CLI flag)."""
        out: dict[str, float] = {}
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            name, _, w = part.partition("=")
            out[name.strip()] = float(w) if w else 1.0
        return out


class _Tenant:
    __slots__ = ("name", "weight", "tokens", "refill_at", "inflight",
                 "admitted", "rejected")

    def __init__(self, name: str, weight: float, now: float):
        self.name = name
        self.weight = weight
        self.tokens = -1.0          # sentinel: bucket fills on first refill
        self.refill_at = now
        self.inflight = 0
        self.admitted = 0
        self.rejected = 0


class _Class:
    __slots__ = ("ewma_s", "depth")

    def __init__(self):
        self.ewma_s: float | None = None
        self.depth = 0


class Ticket:
    """Proof of admission.  ``done()`` (idempotent) releases the in-flight
    slots and feeds the observed service time back into the class EWMA —
    including for requests that later failed: their queue occupancy was
    real, and the predictor must see it."""

    __slots__ = ("_ctl", "_tenant", "_cls", "_t0", "_done", "_token")

    def __init__(self, ctl: "AdmissionController", tenant: _Tenant,
                 cls: _Class, t0: float):
        self._ctl = ctl
        self._tenant = tenant
        self._cls = cls
        self._t0 = t0
        self._done = False
        self._token = None

    def done(self) -> None:
        if self._done:
            return
        self._done = True
        self._ctl._finish(self, self._ctl._clock() - self._t0)

    # ---- contextvar plumbing: make this ticket current on the thread so
    # inner engine hops (cluster scatter) do not re-admit the same request
    def __enter__(self) -> "Ticket":
        self._token = _TICKET.set(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._token is not None:
            _TICKET.reset(self._token)
            self._token = None
        self.done()
        return False


class AdmissionController:
    """One lock, O(1) state per (tenant, class); ``admit`` is the only hot
    path and stays well under the 50µs CI gate.  ``clock`` is injectable so
    the fair-share property tests run on a fake clock."""

    def __init__(self, config: AdmissionConfig | None = None, *,
                 metrics=None, clock=time.perf_counter):
        self.config = config or AdmissionConfig()
        self.metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._tenants: dict[str, _Tenant] = {
            name: _Tenant(name, float(w), now)
            for name, w in self.config.tenants.items()}
        self._weight_sum = sum(t.weight for t in self._tenants.values())
        self._classes: dict[tuple, _Class] = {}
        self._admitted_total = 0
        self._rejected_total = 0
        self._rejected_by_reason: dict[str, int] = {}

    # ------------------------------------------------------------------ admit
    def admit(self, kind: str, tenant: str | None = None, *,
              deadline_ms: float | None = None,
              signal: str | None = None) -> Ticket:
        """Admit or raise :class:`AdmissionRejected`.  ``kind`` is the
        request kind (``loss_query``, ``build``, ...), ``signal`` the target
        signal name — together the service-time class."""
        cfg = self.config
        name = tenant or DEFAULT_TENANT
        now = self._clock()
        with self._lock:
            ten = self._tenants.get(name)
            if ten is None:
                ten = self._tenants[name] = \
                    _Tenant(name, cfg.default_weight, now)
                self._weight_sum += ten.weight
            share = ten.weight / self._weight_sum if self._weight_sum else 1.0

            if not cfg.enabled:
                return self._admit_locked(ten, kind, signal, now)

            # 1) per-tenant in-flight cap (weighted slice of the total)
            if cfg.max_inflight is not None:
                cap = max(1, round(cfg.max_inflight * share))
                if ten.inflight >= cap:
                    # drain time for the tenant's own backlog: its in-flight
                    # work through its slice of the pool — non-decreasing in
                    # depth by construction
                    est = self._ewma_of(kind, signal)
                    retry = max(0.01, (ten.inflight - cap + 1) * est
                                / max(1.0, cfg.parallelism * share))
                    self._reject_locked(ten, name, "tenant_inflight", retry)

            # 2) deadline guard: predicted completion vs the caller's
            #    budget.  Runs BEFORE the token bucket so a doomed request
            #    does not burn the tenant's rate capacity on its way out.
            if cfg.deadline_guard and deadline_ms is not None:
                cls = self._classes.get((kind, signal))
                if cls is not None and cls.ewma_s is not None:
                    predicted = cls.ewma_s * \
                        (1.0 + cls.depth / cfg.parallelism)
                    if predicted > deadline_ms / 1e3:
                        retry = max(0.01, cls.ewma_s * cls.depth
                                    / cfg.parallelism)
                        self._reject_locked(
                            ten, name, "deadline_unmeetable", retry)

            # 3) per-tenant token bucket (weighted slice of the total rate).
            #    Rejections never consume tokens: a retry storm cannot eat
            #    the tenant's own future capacity.
            if cfg.rate_rps is not None:
                rate = cfg.rate_rps * share
                cap_tokens = max(1.0, rate * cfg.burst_s)
                if ten.tokens < 0.0:            # first sight: full bucket
                    ten.tokens = cap_tokens
                else:
                    ten.tokens = min(
                        cap_tokens,
                        ten.tokens + (now - ten.refill_at) * rate)
                ten.refill_at = now
                if ten.tokens < 1.0:
                    retry = max(0.01, (1.0 - ten.tokens) / rate)
                    self._reject_locked(ten, name, "tenant_rate", retry)
                ten.tokens -= 1.0

            return self._admit_locked(ten, kind, signal, now)

    def _admit_locked(self, ten: _Tenant, kind: str, signal: str | None,
                      now: float) -> Ticket:
        cls = self._classes.get((kind, signal))
        if cls is None:
            cls = self._classes[(kind, signal)] = _Class()
        ten.inflight += 1
        ten.admitted += 1
        cls.depth += 1
        self._admitted_total += 1
        m = self.metrics
        if m is not None:
            m.inc("admission_admitted_total", tenant=ten.name)
        return Ticket(self, ten, cls, now)

    def _reject_locked(self, ten: _Tenant, name: str, reason: str,
                       retry_after: float):
        ten.rejected += 1
        self._rejected_total += 1
        self._rejected_by_reason[reason] = \
            self._rejected_by_reason.get(reason, 0) + 1
        m = self.metrics
        if m is not None:
            m.inc("admission_rejected_total", reason=reason, tenant=name)
        raise AdmissionRejected(
            reason, name, retry_after,
            f"admission refused for tenant {name!r}: {reason} "
            f"(retry after {retry_after:.3f}s)")

    def _ewma_of(self, kind: str, signal: str | None) -> float:
        cls = self._classes.get((kind, signal))
        if cls is not None and cls.ewma_s is not None:
            return cls.ewma_s
        return 0.05                             # cold-start guess: 50ms

    # ----------------------------------------------------------------- finish
    def _finish(self, ticket: Ticket, dur_s: float) -> None:
        a = self.config.alpha
        with self._lock:
            ten, cls = ticket._tenant, ticket._cls
            ten.inflight = max(0, ten.inflight - 1)
            cls.depth = max(0, cls.depth - 1)
            if cls.ewma_s is None:
                cls.ewma_s = dur_s
            else:
                cls.ewma_s += a * (dur_s - cls.ewma_s)
        m = self.metrics
        if m is not None:
            m.set_gauge("admission_tenant_inflight", ten.inflight,
                        tenant=ten.name)
            m.observe("admission_service_time", dur_s, tenant=ten.name)

    # ------------------------------------------------------------------ stats
    def snapshot(self) -> dict:
        with self._lock:
            tenants = {
                name: {"weight": t.weight,
                       "share": t.weight / self._weight_sum
                       if self._weight_sum else 1.0,
                       "inflight": t.inflight,
                       "tokens": round(max(t.tokens, 0.0), 3),
                       "admitted": t.admitted, "rejected": t.rejected}
                for name, t in self._tenants.items()}
            classes = {
                f"{kind}:{signal or '*'}": {
                    "ewma_ms": None if c.ewma_s is None
                    else round(c.ewma_s * 1e3, 3),
                    "depth": c.depth}
                for (kind, signal), c in self._classes.items()}
            return {
                "enabled": self.config.enabled,
                "rate_rps": self.config.rate_rps,
                "max_inflight": self.config.max_inflight,
                "parallelism": self.config.parallelism,
                "admitted_total": self._admitted_total,
                "rejected_total": self._rejected_total,
                "rejected_by_reason": dict(self._rejected_by_reason),
                "tenants": tenants,
                "classes": classes,
            }
