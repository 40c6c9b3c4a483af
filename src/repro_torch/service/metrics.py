"""Service telemetry: counters + log-bucketed latency histograms.

Stdlib-only (the serving layer must run in a bare container), thread-safe,
and renderable both as JSON (``snapshot`` — the /stats endpoint) and as
Prometheus text exposition (``render`` — the /metrics endpoint), so the
engine can sit behind a standard scrape without extra dependencies.

Both counters and histograms take Prometheus-style labels
(``inc("query_flushes", reason="window")``,
``observe("ops_dispatch", dt, op="fitting_loss", backend="numpy")``); label
*values* are escaped per the exposition spec (``\\`` -> ``\\\\``, ``"`` ->
``\\"``, newline -> ``\\n``) so a hostile or merely unlucky value cannot
corrupt the whole scrape body.  All series of one labeled family render
under a single ``# TYPE`` header, grouped contiguously.

Histogram buckets may carry an **exemplar**: the most recent trace id that
landed in that bucket, rendered OpenMetrics-style
(``..._bucket{le="0.1"} 5 # {trace_id="<id>"} 0.07``) — a p99 bucket links
to a concrete retrievable trace instead of an anonymous aggregate.

Uptime reads the monotonic clock (an NTP step must not make ``uptime_s``
jump); ``started_at`` remains the wall-clock epoch for display.
"""
from __future__ import annotations

import re
import threading
import time

__all__ = ["Histogram", "ServiceMetrics", "escape_label_value"]


# Geometric bucket bounds: 100us .. ~100s, x2 per bucket (21 buckets + inf).
_BOUNDS = tuple(1e-4 * 2.0 ** i for i in range(21))

_san = lambda n: re.sub(r"[^a-zA-Z0-9_:]", "_", n)  # noqa: E731


def escape_label_value(value) -> str:
    """Escape a label value per the Prometheus exposition format: backslash
    first (an already-escaped quote must not double-escape), then quote and
    newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels_key(labels: dict) -> str:
    """Canonical ``name{...}`` suffix for a label set (sorted, escaped)."""
    body = ",".join(f'{k}="{escape_label_value(v)}"'
                    for k, v in sorted(labels.items()))
    return f"{{{body}}}"


class Histogram:
    """Histogram over fixed bucket bounds.  Defaults to the geometric
    latency buckets (seconds); pass ``bounds``/``unit`` for other scales —
    e.g. the fused-batch-size histogram uses powers of two and no unit.
    Each bucket remembers the last exemplar (trace id, value) observed
    into it."""

    __slots__ = ("bounds", "unit", "counts", "count", "sum", "max",
                 "exemplars")

    def __init__(self, bounds: tuple = _BOUNDS, unit: str = "seconds") -> None:
        self.bounds = tuple(bounds)
        self.unit = unit
        self.counts = [0] * (len(self.bounds) + 1)
        self.exemplars: list[tuple[str, float] | None] = \
            [None] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.max = 0.0

    def observe(self, value: float, exemplar: str | None = None) -> None:
        i = 0
        while i < len(self.bounds) and value > self.bounds[i]:
            i += 1
        self.counts[i] += 1
        if exemplar is not None:
            self.exemplars[i] = (exemplar, value)
        self.count += 1
        self.sum += value
        if value > self.max:
            self.max = value

    def quantile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q-quantile."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target:
                return self.bounds[i] if i < len(self.bounds) else self.max
        return self.max

    def snapshot(self) -> dict:
        mean = self.sum / self.count if self.count else 0.0
        # suffix the JSON keys with the unit only for the seconds default,
        # so existing dashboards keep their p50_s fields
        sfx = "_s" if self.unit == "seconds" else ""
        return {"count": self.count, f"mean{sfx}": mean,
                f"p50{sfx}": self.quantile(0.5), f"p90{sfx}": self.quantile(0.9),
                f"p99{sfx}": self.quantile(0.99), f"max{sfx}": self.max}


class ServiceMetrics:
    """Named counters and histograms behind one lock (contention is tiny
    relative to the numpy work per request)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, Histogram] = {}
        self.started_at = time.time()       # wall clock, display only
        self._started_mono = time.monotonic()  # uptime source (NTP-immune)

    # --------------------------------------------------------------- writers
    def inc(self, name: str, by: int = 1, **labels) -> None:
        """Bump a counter.  ``labels`` dimensions the metric the Prometheus
        way — ``inc("query_flushes", reason="window")`` is stored (and
        rendered) as ``query_flushes{reason="window"}`` with the value
        escaped per the exposition spec."""
        if labels:
            name = f"{name}{_labels_key(labels)}"
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + by

    def set_gauge(self, name: str, value: float, **labels) -> None:
        """Set a gauge to an absolute value (last write wins) — liveness
        flags and level readings that go *down* as well as up, e.g.
        ``set_gauge("cluster_worker_up", 1, worker="w0")``.  Labels
        dimension the family exactly like :meth:`inc`."""
        if labels:
            name = f"{name}{_labels_key(labels)}"
        with self._lock:
            self._gauges[name] = float(value)

    def get_gauge(self, name: str, **labels) -> float | None:
        if labels:
            name = f"{name}{_labels_key(labels)}"
        with self._lock:
            return self._gauges.get(name)

    def observe(self, name: str, value: float, *, bounds: tuple | None = None,
                unit: str | None = None, exemplar: str | None = None,
                **labels) -> None:
        """Record a histogram sample.  ``bounds``/``unit`` apply on first
        observation of ``name`` (latency seconds by default); ``labels``
        dimension the family like :meth:`inc`; ``exemplar`` attaches a
        trace id to the bucket the sample lands in."""
        if labels:
            name = f"{name}{_labels_key(labels)}"
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                kw = {}
                if bounds is not None:
                    kw["bounds"] = bounds
                if unit is not None:
                    kw["unit"] = unit
                h = self._hists[name] = Histogram(**kw)
            h.observe(value, exemplar)

    def timed(self, name: str):
        """Context manager: observe the elapsed wall time under ``name``."""
        return _Timer(self, name)

    def get(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # --------------------------------------------------------------- readers
    def uptime_s(self) -> float:
        return time.monotonic() - self._started_mono

    def snapshot(self) -> dict:
        with self._lock:
            out = {
                "uptime_s": time.monotonic() - self._started_mono,
                "counters": dict(self._counters),
                "latency": {k: h.snapshot() for k, h in self._hists.items()},
            }
            if self._gauges:
                out["gauges"] = dict(self._gauges)
            return out

    def render(self) -> str:
        """Prometheus text exposition format.  Metric names must match
        [a-zA-Z_:][a-zA-Z0-9_:]* — route-derived names ("http GET /healthz")
        are sanitized here so one bad name can't invalidate the whole scrape
        body; snapshot() keeps the readable originals.  Series are grouped
        per family with exactly one # TYPE header each (sorting alone does
        not guarantee contiguity: "f_total" sorts between "f" and "f{...}"),
        and label bodies pass through verbatim — values were escaped at
        write time."""
        counter_fams: dict[str, list[tuple[str, int]]] = {}
        gauge_fams: dict[str, list[tuple[str, float]]] = {}
        hist_fams: dict[str, list[tuple[str, Histogram]]] = {}
        with self._lock:
            for name, v in sorted(self._counters.items()):
                base, brace, labels = name.partition("{")
                fam = f"coreset_{_san(base)}"
                counter_fams.setdefault(fam, []).append(
                    (brace + labels, v))
            for name, g in sorted(self._gauges.items()):
                base, brace, labels = name.partition("{")
                fam = f"coreset_{_san(base)}"
                gauge_fams.setdefault(fam, []).append((brace + labels, g))
            for name, h in sorted(self._hists.items()):
                base, brace, labels = name.partition("{")
                sfx = f"_{_san(h.unit)}" if h.unit else ""
                fam = f"coreset_{_san(base)}{sfx}"
                hist_fams.setdefault(fam, []).append((labels[:-1], h))
            lines = []
            for fam, series in counter_fams.items():
                lines.append(f"# TYPE {fam} counter")
                for labels, v in series:
                    lines.append(f"{fam}{labels} {v}")
            for fam, series in gauge_fams.items():
                lines.append(f"# TYPE {fam} gauge")
                for labels, g in series:
                    lines.append(f"{fam}{labels} {g:g}")
            for fam, series in hist_fams.items():
                lines.append(f"# TYPE {fam} histogram")
                for labels, h in series:
                    pre = f"{labels}," if labels else ""
                    acc = 0
                    for i, (bound, c) in enumerate(zip(h.bounds, h.counts)):
                        acc += c
                        line = f'{fam}_bucket{{{pre}le="{bound:g}"}} {acc}'
                        ex = h.exemplars[i]
                        if ex is not None:
                            line += (f' # {{trace_id="'
                                     f'{escape_label_value(ex[0])}"}} '
                                     f"{ex[1]:g}")
                        lines.append(line)
                    line = f'{fam}_bucket{{{pre}le="+Inf"}} {h.count}'
                    ex = h.exemplars[-1]
                    if ex is not None:
                        line += (f' # {{trace_id="'
                                 f'{escape_label_value(ex[0])}"}} {ex[1]:g}')
                    lines.append(line)
                    br = f"{{{labels}}}" if labels else ""
                    lines.append(f"{fam}_sum{br} {h.sum:g}")
                    lines.append(f"{fam}_count{br} {h.count}")
        return "\n".join(lines) + "\n"


class _Timer:
    __slots__ = ("_m", "_name", "_t0")

    def __init__(self, metrics: ServiceMetrics, name: str):
        self._m = metrics
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._m.observe(self._name, time.perf_counter() - self._t0)
        return False
