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
  4. ``cuda`` when ``torch.cuda.is_available()``;
  5. otherwise raise: there is no silent CPU path, the caller pins ``numpy``
     or ``torch`` to run on the CPU.

The reference's size threshold and autotune cache have no counterpart here.
Implementations are registered as factories resolved on first use, so
importing ``repro_torch.ops`` builds no kernel.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Callable

__all__ = [
    "OPS", "BACKENDS", "ENV_VAR", "BackendError", "register",
    "available_backends", "select_backend", "resolve", "dispatch", "bind",
    "backend_override", "dispatch_counts", "dispatch_seconds",
    "reset_dispatch_counts",
]

OPS = ("sat_moments", "delta_sat", "fitting_loss", "fitting_loss_batched",
       "hist_split", "streaming_compress")
BACKENDS = ("numpy", "torch", "cuda")
ENV_VAR = "REPRO_TORCH_OPS_BACKEND"


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


def select_backend(op: str) -> str:
    """The backend :func:`dispatch` would use for ``op``."""
    if op not in OPS:
        raise BackendError(f"unknown op {op!r}; ops are {OPS}")
    if _OVERRIDE:
        return _OVERRIDE[-1]
    env = _env_choice(op)
    if env is not None:
        return env
    import torch
    if torch.cuda.is_available():
        return "cuda"
    raise RuntimeError(
        f"no CUDA device for op {op!r}: pin backend='numpy' or 'torch' "
        f"(argument, ops.backend_override or {ENV_VAR}) to run on the CPU")


def resolve(op: str, backend: str | None = None) -> tuple[str, Callable]:
    """(backend name, callable) after selection + lazy factory resolution."""
    name = backend or select_backend(op)
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


def _counted(op: str, name: str, fn: Callable, args, kw, count: int = 1):
    with _LOCK:
        _DISPATCHES[(op, name)] += count
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            _SECONDS[(op, name)] += dt


def dispatch(op: str, *args, backend: str | None = None, **kw):
    name, fn = resolve(op, backend)
    return _counted(op, name, fn, args, kw)


def bind(op: str, *args, backend: str | None = None, **kw) -> Callable:
    """Resolve ``op``'s backend once and bind its leading arguments there
    (the backend's ``fn.bind``: ``hist_split`` keeps a tree's data on the
    device).  Each call of the result counts as one dispatch of ``op``; the
    binding's host seconds (its upload) count toward ``op``'s seconds."""
    name, fn = resolve(op, backend)
    bound = _counted(op, name, fn.bind, args, kw, count=0)

    def call(*a, **k):
        return _counted(op, name, bound, a, k)
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
