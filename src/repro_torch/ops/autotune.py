"""Kernel autotuning and compensated-precision promotion for ``repro_torch.ops``.

The port of ``repro.ops.autotune``.  Three parts:

  * a **search**: per (op, backend) configuration space — the cuda
    kernels' types and histogram variants and tiles, the torch backend's
    lowerings and compensated flag — measured against the numpy oracle on
    representative problems;
  * a **persisted cache**: ``~/.cache/repro_torch/autotune.json`` (override
    with ``REPRO_TORCH_AUTOTUNE_CACHE``), versioned by a fingerprint of the
    backend and kernel sources, the CUDA sources included, so stale entries
    never outlive the code they measured; corrupt or mismatched caches are
    ignored, never fatal;
  * a **dispatch consult**: ``registry.select_backend`` asks
    :func:`tuned_backend` before it falls back to the card, and each torch
    and cuda backend asks :func:`plan` for its tuned configuration at call
    time.  A cold cache reproduces the untuned behaviour bitwise.  Where a
    card is present only a cuda entry is promoted (torch is the CPU, and
    dispatch never moves work off the card); where none is, never one.

The port reads its own environment variables (a shared one would reach the
reference inside every parity test): ``REPRO_TORCH_AUTOTUNE_CACHE``,
``REPRO_TORCH_AUTOTUNE`` ("0"/"off" disables consultation) and
``REPRO_TORCH_OPS_PRECISION`` (f64 | compensated | fast).

Precision promotion: an entry for a precision-pinned op
(``registry.PINNED_OPS``) carries a *parity certificate*, the measured
scaled relative error of its config against the float64 oracle.  In the
default ``compensated`` mode only a compensated config, or a float64 one
(the card's native ``dtype`` "float64" or ``variant`` "f64", the torch
backend's default), whose certificate passes :data:`PARITY_RTOL` can lift
the pin; ``fast`` also lets plain float32 configs through; ``f64`` never
lifts it.  The same rule holds for the config :func:`plan` serves to a
pinned op, since the port's cuda backend, unlike a TPU, computes in float64
by default: a float32 winner is not run where the mode does not allow it
(``f64`` serves float64 configs only).  So that such a winner does not
hide the backend's best allowed config (the card's float64 path, say), a
pinned op's entry also keeps, under ``modes``, the fastest candidate each
of the ``compensated`` and ``f64`` modes allows; dispatch and ``plan``
take that one where the winner is not allowed.

The tuner records every candidate that raises, and prints it: a kernel that
does not build or launch on the card is a failure to report, not a lost
candidate.  On a host with no card it skips the cuda backend and says so.

CLI::

    python -m repro_torch.ops.autotune [--ops OP,OP] [--budget quick|full]
                                       [--cache PATH] [--json]
"""
from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import pathlib
import platform
import sys
import threading
import time
import traceback

import numpy as np

from repro_torch.obs.profile import shape_bucket

from . import registry

__all__ = [
    "CACHE_ENV_VAR", "DISABLE_ENV_VAR", "PRECISION_ENV_VAR", "PARITY_RTOL",
    "SEARCH_SPACE", "LARGE_SHAPES", "TUNABLE_OPS",
    "TuneCache", "cache_path", "kernel_fingerprint", "device_kind",
    "precision_mode", "get_cache", "reset_cache", "plan", "tuned_backend",
    "tune_op", "tune_all", "counters_snapshot", "snapshot", "main",
]

CACHE_ENV_VAR = "REPRO_TORCH_AUTOTUNE_CACHE"
DISABLE_ENV_VAR = "REPRO_TORCH_AUTOTUNE"        # "0"/"off" disables consultation
PRECISION_ENV_VAR = "REPRO_TORCH_OPS_PRECISION"  # f64 | compensated | fast
SCHEMA_VERSION = 1
PARITY_RTOL = 1e-6     # certificate bound of a pinned op vs the f64 oracle
_TUNED = ("torch", "cuda")     # the backends a cache entry can name

_SCANS = {"torch": [{"compensated": False}, {"compensated": True}],
          "cuda": [{"dtype": "float64"}, {"dtype": "float32"}]}

# ----------------------------------------------------------- search spaces
# Each op/backend maps to the list of configurations the tuner measures;
# backends.py reads the keys.  torch mirrors the reference's xla lists (its
# {"compensated": False} is the float64 default); cuda the reference's
# pallas lists, with the card's float64 paths added.  Launch shapes are the
# sources' own (sat_launch_shape, fl_launch_shape, hist_f32_launch_shape):
# the tuner records them, it does not search them.
SEARCH_SPACE: dict[str, dict[str, list[dict]]] = {
    "sat_moments": _SCANS,
    "delta_sat": _SCANS,
    "hist_split": {
        "torch": [{"variant": "vmap", "compensated": False},
                  {"variant": "flat", "compensated": False},
                  {"variant": "chunked", "compensated": True}],
        "cuda": [{"variant": "f64"}]
                + [{"variant": "fused", "tile_p": t}
                   for t in (512, 1024, 2048, 4096, 8192)]
                + [{"variant": "partials", "compensated": True, "tile_p": t}
                   for t in (1024, 2048, 4096, 8192)]
                + [{"variant": "legacy", "tile_p": 512}],
    },
    "fitting_loss": {"torch": [{}], "cuda": [{}]},
    "fitting_loss_batched": {"torch": [{}], "cuda": [{}]},
    "streaming_compress": _SCANS,
}

# The reference's canonical large-bucket problem shapes, unchanged.
LARGE_SHAPES = {
    "sat_moments": {"n": 384, "m": 384},
    "delta_sat": {"band": 64, "m": 2048},
    "hist_split": {"P": 120_000, "F": 8, "B": 256},
    "fitting_loss_batched": {"n": 320, "m": 240, "k": 8, "T": 64},
}

TUNABLE_OPS = ("sat_moments", "delta_sat", "hist_split",
               "fitting_loss_batched")

_COUNTERS = {"cache_hit": 0, "cache_miss": 0, "tune_runs": 0,
             "promoted_f32": 0, "tuned_dispatch": 0, "cache_load_errors": 0,
             "pin_held": 0}


def _count(name: str, by: int = 1) -> None:
    # deliberately lock-free: these sit on the dispatch hot path, and a
    # rare lost increment in telemetry beats a lock acquire per dispatch
    _COUNTERS[name] = _COUNTERS.get(name, 0) + by


def counters_snapshot() -> dict:
    return dict(_COUNTERS)


def _enabled() -> bool:
    return os.environ.get(DISABLE_ENV_VAR, "").strip().lower() not in (
        "0", "off", "false", "no")


def precision_mode() -> str:
    """``f64`` (never lift a pin), ``compensated`` (lift only with a parity
    certificate — the default), or ``fast`` (plain-float32 promotion
    allowed)."""
    mode = os.environ.get(PRECISION_ENV_VAR, "").strip().lower()
    return mode if mode in ("f64", "compensated", "fast") else "compensated"


def _fingerprint(pkg: pathlib.Path) -> str:
    """Hash of the backend, kernel and CUDA sources under the package
    directory ``pkg``, the search space and the schema version."""
    kernels, csrc = pkg / "kernels", pkg / "csrc"
    h = hashlib.sha256()
    for p in sorted((pkg / "ops" / "backends.py", *kernels.glob("*/kernel.py"),
                     *kernels.glob("*/ref.py"), *csrc.glob("*.cu"),
                     *csrc.glob("*.cuh"))):
        try:
            h.update(p.read_bytes())
        except OSError:
            pass
    h.update(repr(sorted(SEARCH_SPACE.items())).encode())
    h.update(str(SCHEMA_VERSION).encode())
    return h.hexdigest()[:12]


@functools.cache
def kernel_fingerprint() -> str:
    """This checkout's fingerprint: a cache entry measured against other
    code is stale and must not be consulted."""
    return _fingerprint(pathlib.Path(__file__).resolve().parents[1])


@functools.cache
def device_kind() -> str:
    """The card's name (``torch.cuda.get_device_name()``), or "cpu" on a
    host without one: cache entries do not transfer across devices."""
    import torch
    return torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu"


def _has_card() -> bool:
    import torch
    return torch.cuda.is_available()


def host_fingerprint() -> str:
    """Provenance string for tuned entries: which machine produced a number."""
    return (f"{platform.system()}-{platform.machine()}"
            f"-py{platform.python_version()}-cpus{os.cpu_count()}")


def cache_path() -> pathlib.Path:
    env = os.environ.get(CACHE_ENV_VAR, "").strip()
    if env:
        return pathlib.Path(env).expanduser()
    return pathlib.Path("~/.cache/repro_torch/autotune.json").expanduser()


class TuneCache:
    """The persisted tuning table: (op, backend, device, bucket) -> entry.

    An entry records the winning config, its measured wall time, the numpy
    oracle's wall time on the same problem, the config's measured scaled
    relative error against that oracle (the parity certificate promotion of
    a pinned op is gated on), for a pinned op the fastest candidate each
    precision mode allows (``modes``) and, for the cuda backend, the launch
    that the source's C query gives at the problem's shape.
    """

    def __init__(self, path: pathlib.Path | None = None):
        self.path = path or cache_path()
        self.entries: dict[str, dict] = {}
        self.loaded_from_disk = False

    @staticmethod
    def key(op: str, backend: str, device: str, bucket: str) -> str:
        return f"{op}|{backend}|{device}|{bucket}"

    def load(self) -> "TuneCache":
        """Tolerant load: corrupt JSON, wrong schema version, or a kernel-
        fingerprint mismatch all yield an empty cache (the untuned rules
        apply) — a bad cache file must never take down dispatch."""
        self.entries = {}
        self.loaded_from_disk = False
        try:
            doc = json.loads(self.path.read_text())
        except (OSError, ValueError):
            if self.path.exists():
                _count("cache_load_errors")
            return self
        if not isinstance(doc, dict) or doc.get("version") != SCHEMA_VERSION:
            _count("cache_load_errors")
            return self
        if doc.get("fingerprint") != kernel_fingerprint():
            # stale by construction: the kernels changed under the entries
            _count("cache_load_errors")
            return self
        entries = doc.get("entries")
        if isinstance(entries, dict):
            self.entries = {k: v for k, v in entries.items()
                            if isinstance(v, dict) and "config" in v}
            self.loaded_from_disk = True
        return self

    def save(self) -> pathlib.Path:
        """Atomic write (tmp + rename): a concurrent reader never sees a
        torn file, which load() would otherwise discard as corrupt."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        doc = {"version": SCHEMA_VERSION, "fingerprint": kernel_fingerprint(),
               "host": host_fingerprint(), "entries": self.entries}
        tmp = self.path.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(doc, indent=1, default=float))
        tmp.replace(self.path)
        return self.path

    def put(self, op: str, backend: str, bucket: str, entry: dict) -> None:
        self.entries[self.key(op, backend, device_kind(), bucket)] = entry
        _DECISIONS.clear()     # new measurements invalidate memoized picks

    def get(self, op: str, backend: str, bucket: str) -> dict | None:
        return self.entries.get(self.key(op, backend, device_kind(), bucket))

    def for_op(self, op: str, bucket: str) -> dict[str, dict]:
        """backend -> entry for every backend tuned at this bucket."""
        out = {}
        for backend in _TUNED:
            e = self.get(op, backend, bucket)
            if e is not None:
                out[backend] = e
        return out


_CACHE: TuneCache | None = None
_CACHE_KEY: str | None = None     # value of $REPRO_TORCH_AUTOTUNE_CACHE at load
_CACHE_LOCK = threading.Lock()

# (op, bucket, mode) -> (backend or None, whether it promotes off float64)
_DECISIONS: dict[tuple, tuple[str | None, bool]] = {}


def get_cache() -> TuneCache:
    """The in-process cache, reloaded when the env var is repointed.  The
    staleness check is one environ lookup + string compare: this sits on
    the dispatch hot path."""
    global _CACHE, _CACHE_KEY
    key = os.environ.get(CACHE_ENV_VAR, "")
    if _CACHE is None or _CACHE_KEY != key:
        with _CACHE_LOCK:
            if _CACHE is None or _CACHE_KEY != key:
                _CACHE = TuneCache().load()
                _CACHE_KEY = key
                _DECISIONS.clear()
    return _CACHE


def reset_cache() -> None:
    """Drop the in-process cache so the next consult re-reads disk/env —
    tests repoint ``REPRO_TORCH_AUTOTUNE_CACHE`` (or tune in-process) and
    call this."""
    global _CACHE
    with _CACHE_LOCK:
        _CACHE = None
        _DECISIONS.clear()


# ------------------------------------------------------- dispatch consults
def plan(op: str, backend: str, size: int | None) -> dict:
    """The tuned configuration a torch or cuda backend should run with at
    this problem size — ``{}`` on a cold miss (the backend's defaults
    apply), and for a pinned op also where the precision mode does not
    allow the entry's config (counted as ``pin_held``).  Called by
    backends.py on every such dispatch; one dict lookup when warm."""
    if backend == "numpy" or not _enabled():
        return {}
    entry = get_cache().get(op, backend, shape_bucket(size))
    if entry is None:
        _count("cache_miss")
        return {}
    choice = _choice(op, entry, precision_mode())
    if choice is None:
        _count("pin_held")
        return {}
    _count("cache_hit")
    return dict(choice.get("config") or {})


def tuned_backend(op: str, size) -> str | None:
    """The backend the tuning cache recommends for ``op`` at ``size`` (an
    int, or a zero-argument callable giving it), or ``None`` when the
    untuned rules decide (cold cache, no winning entry, or a precision pin
    with no passing certificate).

    On the hot path (warm cache) this is a memoized dict lookup — the full
    decision below runs once per (op, bucket, precision mode)."""
    if size is None:
        return None
    cache = get_cache()
    if not cache.entries or not _enabled():
        return None
    pinned = op in registry.PINNED_OPS
    mode = precision_mode()
    if pinned and mode == "f64":
        return None          # the escape hatch: never lift the pin
    key = (op, shape_bucket(registry._size(size)), mode)
    decision = _DECISIONS.get(key)
    if decision is None:
        decision = _DECISIONS[key] = _decide(cache, op, key[1], pinned, mode)
    best_name, promoted = decision
    if best_name is not None:
        _count("tuned_dispatch")
        if promoted:
            _count("promoted_f32")
    return best_name


def _float64(cfg: dict) -> bool:
    """A config that sums in float64: the backends' default, the card's
    native path (``dtype`` "float64", ``variant`` "f64")."""
    return (cfg.get("dtype", "float64") == "float64"
            and cfg.get("variant", "f64") == "f64"
            and not cfg.get("compensated"))


def _allowed(entry: dict, mode: str) -> bool:
    """Whether a pinned op's entry may run in precision ``mode``: ``fast``
    any config; ``compensated`` a compensated or float64 one with a passing
    parity certificate; ``f64`` a float64 one."""
    cfg = entry.get("config") or {}
    if mode == "fast":
        return True
    if mode == "f64":
        return _float64(cfg)
    rel = entry.get("rel_err")
    return ((bool(cfg.get("compensated")) or _float64(cfg))
            and rel is not None and rel <= PARITY_RTOL)


def _choice(op: str, entry: dict, mode: str) -> dict | None:
    """The measurement of ``entry`` that ``mode`` lets ``op`` run: the
    winner itself, or for a pinned op whose winner the mode does not allow,
    the fastest candidate it does (``modes``), or None (the pin holds)."""
    if op not in registry.PINNED_OPS or _allowed(entry, mode):
        return entry
    return (entry.get("modes") or {}).get(mode)


def _decide(cache: TuneCache, op: str, bucket: str, pinned: bool,
            mode: str) -> tuple[str | None, bool]:
    """(the backend to promote or None, whether that pick takes a pinned op
    off float64).  With a card only a cuda entry is a pick, since torch is
    the CPU; without one, never a cuda entry."""
    card = _has_card()
    best_name, best_us, best_cfg = None, None, {}
    for backend, entry in cache.for_op(op, bucket).items():
        if (backend == "cuda") != card:
            continue
        choice = _choice(op, entry, mode)
        if choice is None:
            continue         # no parity certificate: the pin holds
        us, numpy_us = choice.get("us"), entry.get("numpy_us")
        if not us or not numpy_us or us >= numpy_us:
            continue         # the oracle won at tune time: nothing to gain
        if best_us is None or us < best_us:
            best_name, best_us = backend, us
            best_cfg = choice.get("config") or {}
    return best_name, (best_name is not None and pinned
                       and not _float64(best_cfg))


def snapshot() -> dict:
    """Cache + counter state, for stats and provenance."""
    cache = get_cache()
    return {"enabled": _enabled(), "cache_path": str(cache.path),
            "cache_loaded": cache.loaded_from_disk,
            "entries": len(cache.entries),
            "fingerprint": kernel_fingerprint(),
            "precision_mode": precision_mode(),
            "counters": counters_snapshot()}


# ------------------------------------------------------------------ tuning
def _scaled_rel_err(got, want) -> float:
    """max |a-b| scaled by the output's own magnitude (floor 1): the error
    measure the S2 - S1^2/S0 identity actually feels.  Elementwise relative
    error is meaningless here — integral images pass through near-zero
    entries whose denominators amplify benign f32 rounding."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
    return float(np.max(np.abs(got - want))) / scale if got.size else 0.0


def _time_call(fn, repeat: int) -> tuple[float, object]:
    fn()                                    # warmup / kernel build
    t0 = time.perf_counter()
    out = None
    for _ in range(repeat):
        out = fn()
    return (time.perf_counter() - t0) / repeat, out


def _problem(op: str, rng: np.random.Generator, fast: bool) -> tuple:
    """(call_factory, size, launch_of) for a representative large-bucket
    problem.  ``call_factory(backend, config)`` returns a zero-arg callable
    running the op end to end through the public wrapper (so the timing
    includes the same host<->device traffic dispatch pays);
    ``launch_of(config)`` is the cuda launch at this shape that the
    source's C query gives (None where the source has no query)."""
    from repro_torch import ops
    if op == "sat_moments":
        n = 256 if fast else LARGE_SHAPES[op]["n"]
        y = rng.normal(size=(n, n))

        def launch_of(cfg):
            from repro_torch.kernels.sat2d.kernel import launch_shape
            return launch_shape("moments", n, n)
        return (lambda backend, cfg:
                lambda: ops.sat_moments(y, backend=backend, config=cfg)), \
            3 * y.size, launch_of
    if op == "delta_sat":
        shp = LARGE_SHAPES[op]
        b, m = (32, 512) if fast else (shp["band"], shp["m"])
        y = rng.normal(size=(b + 1, m))
        carry = ops.sat_moments(y[:1], backend="numpy")[:, 0, :]
        tail = y[1:]

        def launch_of(cfg):
            from repro_torch.kernels.sat2d.kernel import launch_shape
            return launch_shape("delta", b, m)
        return (lambda backend, cfg:
                lambda: ops.delta_sat(carry, tail, backend=backend,
                                      config=cfg)), 3 * tail.size, launch_of
    if op == "hist_split":
        shp = LARGE_SHAPES[op]
        P, F, B = (40_000, 4, 64) if fast else (shp["P"], shp["F"], shp["B"])
        codes = rng.integers(0, B, size=(P, F)).astype(np.uint8)
        w = rng.uniform(0.5, 1.5, P)
        yv = rng.normal(size=P)
        wy, wy2 = w * yv, w * yv * yv

        def launch_of(cfg):
            from repro_torch.kernels.histsplit.kernel import launch_shape
            variant = cfg.get("variant", "f64")
            if variant == "f64":
                return None
            return launch_shape(variant, P, F, B, int(cfg.get("tile_p", 2048)))
        return (lambda backend, cfg:
                lambda: ops.hist_split(codes, w, wy, wy2, B, backend=backend,
                                       config=cfg)), codes.size, launch_of
    if op == "fitting_loss_batched":
        from repro_torch.core import random_tree_segmentation, signal_coreset
        from repro_torch.data import piecewise_signal
        shp = LARGE_SHAPES[op]
        n, m, k, T = ((96, 80, 6, 16) if fast else
                      (shp["n"], shp["m"], shp["k"], shp["T"]))
        y = piecewise_signal(n, m, k, noise=0.2, seed=3)
        with registry.backend_override("numpy"):
            cs = signal_coreset(y, k, 0.25)
        segs = [random_tree_segmentation(n, m, k, rng) for _ in range(T)]
        sr = np.stack([s.rects for s in segs]).astype(np.float64)
        sl = np.stack([s.labels for s in segs])

        def launch_of(cfg):
            from repro_torch.kernels.fitting_loss.kernel import launch_shape
            return launch_shape(cs.num_blocks, T)
        return (lambda backend, cfg:
                lambda: ops.fitting_loss_batched(cs, sr, sl, backend=backend,
                                                 config=cfg)), \
            ops.fitting_loss_batched_size(cs, sr), launch_of
    raise ValueError(f"no tuning problem defined for op {op!r}")


def tune_op(op: str, *, budget: str = "quick", seed: int = 0,
            verbose: bool = False) -> dict[str, dict]:
    """Measure every configured (backend, config) for ``op`` on its
    representative problem and record the per-backend winner (with the
    numpy-oracle baseline and the parity certificate) into the cache.

    Returns backend -> the winning entry, plus ``candidates`` (every config
    measured, with its time and error) and ``failed`` (every config that
    raised, with its error, also printed to stderr); or ``{"skipped": ...}``
    for the cuda backend on a host with no card."""
    _count("tune_runs")
    rng = np.random.default_rng(seed)
    fast = budget == "quick"
    repeat = 2 if fast else 5
    call_of, size, launch_of = _problem(op, rng, fast)
    bucket = shape_bucket(size)
    numpy_us, want = _time_call(call_of("numpy", {}), repeat)
    numpy_us *= 1e6
    cache = get_cache()
    results: dict[str, dict] = {}
    for backend, configs in SEARCH_SPACE[op].items():
        if backend == "cuda" and not _has_card():
            results[backend] = {"skipped": "no CUDA device"}
            continue
        best, candidates, failed = None, [], []
        for cfg in configs:
            try:
                us, got = _time_call(call_of(backend, cfg), repeat)
            except Exception as exc:  # noqa: BLE001 — the tuner's boundary:
                # a config that cannot run is recorded and reported, never
                # dropped in silence (on the card it is a kernel that did
                # not build or launch)
                failed.append({"config": cfg,
                               "error": f"{type(exc).__name__}: {exc}"})
                print(f"[autotune] {op}/{backend} {cfg} failed:\n"
                      f"{traceback.format_exc()}", file=sys.stderr)
                continue
            rel = _scaled_rel_err(_comparable(op, got), _comparable(op, want))
            entry = {"config": cfg, "us": us * 1e6, "numpy_us": numpy_us,
                     "rel_err": rel, "size": int(size), "bucket": bucket,
                     "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
                     "host": host_fingerprint()}
            candidates.append({"config": cfg, "us": entry["us"],
                               "rel_err": rel})
            if verbose:
                print(f"[autotune] {op}/{backend} {cfg}: "
                      f"{entry['us']:.0f}us (numpy {numpy_us:.0f}us) "
                      f"rel_err={rel:.2e}")
            if best is None or entry["us"] < best["us"]:
                best = entry
        if best is not None:
            if backend == "cuda":
                best["launch"] = launch_of(best["config"])
            if op in registry.PINNED_OPS:
                best["modes"] = {}
                for mode in ("compensated", "f64"):
                    allowed = [c for c in candidates if _allowed(c, mode)]
                    if allowed:
                        best["modes"][mode] = min(allowed, key=lambda c: c["us"])
            cache.put(op, backend, bucket, best)
            results[backend] = {**best, "candidates": candidates,
                                "failed": failed}
        else:
            results[backend] = {"candidates": [], "failed": failed}
    return results


def _comparable(op: str, out):
    """Project an op's output to the array the parity certificate compares
    (streaming_compress returns coreset objects; everything else arrays)."""
    if op == "streaming_compress":
        return np.concatenate([np.sort(np.asarray(c.moments), axis=None)
                               for c in out])
    return out


def tune_all(ops_list=None, *, budget: str = "quick", seed: int = 0,
             verbose: bool = False, save: bool = True) -> dict:
    """Tune every (or the named) tunable op and persist the cache."""
    results = {}
    for op in (ops_list or TUNABLE_OPS):
        if op not in TUNABLE_OPS:
            raise ValueError(f"op {op!r} is not tunable; "
                             f"tunable ops: {TUNABLE_OPS}")
        results[op] = tune_op(op, budget=budget, seed=seed, verbose=verbose)
    if save:
        get_cache().save()
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.ops.autotune",
        description="Populate the kernel tuning cache for this host.")
    ap.add_argument("--ops", default=None,
                    help=f"comma list of ops to tune (default: all of "
                         f"{','.join(TUNABLE_OPS)})")
    ap.add_argument("--budget", choices=("quick", "full"), default="quick")
    ap.add_argument("--cache", default=None,
                    help=f"cache file (default: ${CACHE_ENV_VAR} or "
                         f"~/.cache/repro_torch/autotune.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true",
                    help="print the tuned entries as JSON on stdout")
    args = ap.parse_args(argv)
    if args.cache:
        os.environ[CACHE_ENV_VAR] = args.cache
        reset_cache()
    ops_list = ([s.strip() for s in args.ops.split(",") if s.strip()]
                if args.ops else None)
    results = tune_all(ops_list, budget=args.budget, seed=args.seed,
                       verbose=not args.json)
    path = get_cache().save()
    keys = ("config", "us", "numpy_us", "rel_err", "modes", "launch",
            "failed", "skipped")
    summary = {"cache": str(path), "fingerprint": kernel_fingerprint(),
               "device": device_kind(),
               "entries": len(get_cache().entries),
               "tuned": {op: {b: {k: e[k] for k in keys if k in e}
                              for b, e in per.items()}
                         for op, per in results.items()}}
    if args.json:
        print(json.dumps(summary, indent=1, default=float))
    else:
        print(f"[autotune] wrote {len(get_cache().entries)} entr"
              f"{'y' if len(get_cache().entries) == 1 else 'ies'} to {path} "
              f"(fingerprint {kernel_fingerprint()}, device {device_kind()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
