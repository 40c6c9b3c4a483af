"""Backend registry and dispatch for the canonical op surface.

Each op name maps to up to three registered backends:

    numpy  — the float64 host oracle, the same code as the reference's;
    torch  — the plain PyTorch versions of the kernels, on the CPU;
    cuda   — the hand-written Hopper kernels, on the card.

Selection order:

  1. the ``backend=`` argument;
  2. a :func:`backend_override` context;
  3. the ``REPRO_TORCH_OPS_BACKEND`` environment variable: one backend name
     for every op, or a comma list of ``op=backend`` pairs with an optional
     bare default (``REPRO_TORCH_OPS_BACKEND=torch,fitting_loss=numpy``);
  4. the autotune cache (``autotune.py``): a measured winner for this (op,
     device, size bucket) that beat the numpy oracle at tune time, and for
     the precision-pinned ops (``PINNED_OPS``) only with a parity
     certificate; with a card only a ``cuda`` winner, so that a tuned
     entry never sends work to the CPU;
  5. ``cuda`` when ``torch.cuda.is_available()``, as the reference takes
     ``pallas`` on a TPU;
  6. otherwise raise: there is no silent CPU path, the caller pins ``numpy``
     or ``torch`` to run on the CPU.

The reference's size threshold has no counterpart here.  Every dispatch
crosses one seam that opens an ``ops.dispatch`` span (``repro_torch.obs``)
and feeds the profile hooks, as the reference's does, and counts its calls
and host seconds per (op, backend).  Implementations are registered as
factories resolved on first use, so importing ``repro_torch.ops`` builds no
kernel.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable

from repro_torch.obs import profile as _profile
from repro_torch.obs import trace as _trace

__all__ = [
    "OPS", "BACKENDS", "ENV_VAR", "PINNED_OPS", "BackendError", "register",
    "available_backends", "select_backend", "resolve", "dispatch", "bind",
    "backend_override", "dispatch_counts", "dispatch_seconds",
    "reset_dispatch_counts", "snapshot",
]

OPS = ("sat_moments", "delta_sat", "fitting_loss", "fitting_loss_batched",
       "hist_split", "streaming_compress")
BACKENDS = ("numpy", "torch", "cuda")
ENV_VAR = "REPRO_TORCH_OPS_BACKEND"
# the reference's precision-pinned ops (its XLA_SIZE_THRESHOLD is None): they
# feed the variance identity S2 - S1^2/S0, so a tuned float32 path takes them
# off the float64 oracle only with a parity certificate (autotune._allowed)
PINNED_OPS = frozenset({"sat_moments", "delta_sat", "hist_split",
                        "streaming_compress"})


class BackendError(KeyError):
    """Unknown op or backend name, or an op/backend pair with nothing
    registered."""


_FACTORIES: dict[tuple[str, str], Callable[[], Callable]] = {}
_RESOLVED: dict[tuple[str, str], Callable] = {}
_LOCK = threading.Lock()
_OVERRIDE: list[str] = []   # backend_override stack (innermost last)
_DISPATCHES: collections.Counter = collections.Counter()
_SECONDS: collections.Counter = collections.Counter()


def register(op: str, backend: str):
    """Decorator: register a lazy factory for (op, backend)."""
    if op not in OPS:
        raise BackendError(f"unknown op {op!r}; ops are {OPS}")
    if backend not in BACKENDS:
        raise BackendError(f"unknown backend {backend!r}; backends are {BACKENDS}")

    def deco(factory: Callable[[], Callable]) -> Callable[[], Callable]:
        _FACTORIES[(op, backend)] = factory
        return factory

    return deco


def available_backends(op: str) -> tuple[str, ...]:
    return tuple(b for b in BACKENDS if (op, b) in _FACTORIES)


def _env_choice(op: str) -> str | None:
    """Parse REPRO_TORCH_OPS_BACKEND: bare default + op-specific pins."""
    spec = os.environ.get(ENV_VAR, "").strip()
    if not spec:
        return None
    default = specific = None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            o, b = (s.strip() for s in part.split("=", 1))
            if o not in OPS:
                raise BackendError(f"{ENV_VAR}={spec!r} names unknown op {o!r}; "
                                   f"ops are {OPS}")
            if o == op:
                specific = b
        elif default is None:
            default = part
    choice = specific or default
    if choice is not None and choice not in BACKENDS:
        raise BackendError(f"{ENV_VAR}={spec!r} names unknown backend "
                           f"{choice!r}; valid backends are {BACKENDS}")
    return choice


def _size(size):
    """A dispatch's problem size: an int, None, or a zero-argument callable
    that gives it, read only where it is needed (a warm cache, a trace, a
    profile hook), so that a dispatch that selection refuses never touches
    its arguments."""
    return size() if callable(size) else size


def select_backend(op: str, size=None) -> str:
    """The backend :func:`dispatch` would use for ``op`` at ``size``."""
    if op not in OPS:
        raise BackendError(f"unknown op {op!r}; ops are {OPS}")
    if _OVERRIDE:
        return _OVERRIDE[-1]
    env = _env_choice(op)
    if env is not None:
        return env
    from . import autotune
    tuned = autotune.tuned_backend(op, size)
    if tuned is not None:
        return tuned
    import torch
    if torch.cuda.is_available():
        return "cuda"
    raise RuntimeError(
        f"no CUDA device for op {op!r}: pin backend='numpy' or 'torch' "
        f"(argument, ops.backend_override or {ENV_VAR}) to run on the CPU")


def resolve(op: str, backend: str | None = None,
            size=None) -> tuple[str, Callable]:
    """(backend name, callable) after selection + lazy factory resolution."""
    name = backend or select_backend(op, size)
    key = (op, name)
    fn = _RESOLVED.get(key)
    if fn is None:
        with _LOCK:
            fn = _RESOLVED.get(key)
            if fn is None:
                factory = _FACTORIES.get(key)
                if factory is None:
                    raise BackendError(
                        f"no {name!r} backend registered for op {op!r}; "
                        f"available: {available_backends(op)}")
                fn = _RESOLVED[key] = factory()
    return name, fn


def _counted(op: str, name: str, size, fn: Callable, args, kw, count: int = 1):
    # the observability seam: outside a trace the span is the NOOP singleton
    # and with no hooks installed the profile branch is one falsy check
    with _LOCK:
        _DISPATCHES[(op, name)] += count
    span = _trace.TRACER.child_span("ops.dispatch")
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _SECONDS[(op, name)] += dt
        if span or _profile._HOOKS:
            size = _size(size)
            if span:
                span.set_attr("op", op)
                span.set_attr("backend", name)
                span.set_attr("size", size)
                span.set_attr("shape_bucket", _profile.shape_bucket(size))
                span.end()
            if _profile._HOOKS:
                _profile.record(op, name, size, dt)


def dispatch(op: str, *args, backend: str | None = None, size=None, **kw):
    name, fn = resolve(op, backend, size)
    return _counted(op, name, size, fn, args, kw)


def bind(op: str, *args, backend: str | None = None, **kw) -> Callable:
    """Resolve ``op``'s backend once, at the size of its first argument (a
    tree's codes for ``hist_split``), and bind its leading arguments there
    (the backend's ``fn.bind``: ``hist_split`` keeps a tree's data on the
    device, or runs the tuned variant on each node's rows).  Each call of
    the result counts as one dispatch of ``op`` at the node's size (its
    rows times the codes' features); the
    binding's host seconds (its upload) count toward ``op``'s seconds."""
    size = getattr(args[0], "size", None) if args else None
    name, fn = resolve(op, backend, size)
    bound = _counted(op, name, size, fn.bind, args, kw, count=0)

    def call(rows, *a, **k):
        return _counted(op, name, lambda: len(rows) * args[0].shape[1], bound,
                        (rows, *a), k)
    return call


def dispatch_counts() -> dict[tuple[str, str], int]:
    """Dispatches per (op, backend) since import or the last reset."""
    with _LOCK:
        return dict(_DISPATCHES)


def dispatch_seconds() -> dict[tuple[str, str], float]:
    """Host seconds spent inside dispatches per (op, backend) since import
    or the last reset: the backend's whole call, transfers included."""
    with _LOCK:
        return dict(_SECONDS)


def reset_dispatch_counts() -> None:
    """Zero both the counts and the seconds."""
    with _LOCK:
        _DISPATCHES.clear()
        _SECONDS.clear()


@contextlib.contextmanager
def backend_override(backend: str):
    """Force every dispatch inside the context onto one backend."""
    if backend not in BACKENDS:
        raise BackendError(f"unknown backend {backend!r}; backends are {BACKENDS}")
    _OVERRIDE.append(backend)
    try:
        yield
    finally:
        _OVERRIDE.pop()


def snapshot() -> dict:
    """Selection state per op: its backends, the backend a dispatch with no
    size would take (None where selection raises: no card and no pin), the
    environment pin and whether the op is precision-pinned."""
    out = {}
    for op in OPS:
        try:
            selected = select_backend(op)
        except RuntimeError:
            selected = None
        out[op] = {"available": list(available_backends(op)),
                   "selected": selected, "env_override": _env_choice(op),
                   "pinned": op in PINNED_OPS}
    return out
