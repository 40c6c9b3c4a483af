"""Op-level profiling hooks for ``repro_torch.ops.dispatch``.

The dispatcher is the one chokepoint every backend call crosses, so this is
where per-(op, backend, shape-bucket) wall time becomes observable.  The
registry stays dependency-free: it calls :func:`record` after each dispatch
and whoever wants the numbers (the serving engine, a bench) registers a
hook.  With no hooks installed the cost is one ``if not _HOOKS`` check.

Shape buckets: problem "size" (op-specific, see ``repro_torch.ops``) collapses to
its power-of-two ceiling — ``le_2^12`` means ``2^11 < size <= 2^12`` — so
the Prometheus label space stays bounded (~20 buckets) while still
separating the tiny dispatches the numpy oracle should win from the large
ones that should have promoted to an accelerator backend.
"""
from __future__ import annotations

import threading
from typing import Callable

__all__ = ["add_hook", "remove_hook", "record", "shape_bucket", "hooks"]

# fn(op: str, backend: str, size: int | None, seconds: float)
_HOOKS: list[Callable] = []
_LOCK = threading.Lock()


def add_hook(fn: Callable) -> Callable:
    """Register a dispatch observer; returns ``fn`` for symmetry."""
    with _LOCK:
        if fn not in _HOOKS:
            _HOOKS.append(fn)
    return fn


def remove_hook(fn: Callable) -> None:
    with _LOCK:
        try:
            _HOOKS.remove(fn)
        except ValueError:
            pass


def hooks() -> tuple:
    return tuple(_HOOKS)


def record(op: str, backend: str, size: int | None, seconds: float) -> None:
    """Fan one dispatch observation out to every hook.  Hook exceptions are
    swallowed: telemetry must never fail the computation it observes."""
    for fn in tuple(_HOOKS):
        try:
            fn(op, backend, size, seconds)
        except Exception:  # noqa: BLE001 - observability is best-effort
            pass


def shape_bucket(size: int | None) -> str:
    """Power-of-two ceiling label for a problem size (``le_2^b``)."""
    if size is None:
        return "none"
    size = int(size)
    if size <= 1:
        return "le_2^0"
    return f"le_2^{(size - 1).bit_length()}"
