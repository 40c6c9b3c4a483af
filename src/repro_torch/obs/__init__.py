"""repro_torch.obs — end-to-end request tracing + op-level profiling (stdlib-only).

One process-global :class:`Tracer` (``obs.TRACER``) that every layer of the
serving hot path records spans into:

    HTTP handler  ->  QueryScheduler wait / fused dispatch (linked)
                  ->  BuildScheduler build
                  ->  engine cache lookup / compress
                  ->  repro_torch.ops dispatch (op, backend, shape bucket)

plus the :mod:`repro_torch.obs.profile` hook point the dispatcher feeds, so the
engine can turn per-dispatch wall time into Prometheus families.  See
DESIGN.md "Observability" for the span taxonomy and linking semantics.

The module-level helpers below delegate to ``TRACER`` — call sites read as
``obs.span("cache.lookup")`` without threading a tracer through every
constructor.  Tests that need isolation build their own ``Tracer``.
"""
from __future__ import annotations

from . import profile
from .trace import (NOOP, TRACER, Span, SpanContext, Tracer, current_span,
                    format_traceparent, mint_span_id, mint_trace_id,
                    parse_traceparent)

__all__ = [
    "NOOP", "TRACER", "Span", "SpanContext", "Tracer", "profile",
    "current_span", "parse_traceparent", "format_traceparent",
    "mint_trace_id", "mint_span_id",
    "span", "child_span", "start_trace", "attach", "set_enabled",
]


def span(name: str, **attrs):
    """Context manager: child span of the current one (NOOP outside)."""
    return TRACER.span(name, **attrs)


def child_span(name: str, *, parent=None, attrs: dict | None = None):
    return TRACER.child_span(name, parent=parent, attrs=attrs)


def start_trace(name: str, *, traceparent: str | None = None, links=None,
                attrs: dict | None = None):
    return TRACER.start_trace(name, traceparent=traceparent, links=links,
                              attrs=attrs)


def attach(span_obj):
    return TRACER.attach(span_obj)


def set_enabled(on: bool) -> None:
    TRACER.set_enabled(on)
