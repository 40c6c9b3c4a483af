#!/usr/bin/env python
"""The ``qos`` gate of ``repro_torch``: admission control MUST hold its QoS
contract under overload.

Boots the full HTTP service in-process and runs two phases:

  1. **baseline** — no admission: a short closed loop measures the engine's
     unloaded capacity (rps) and the cold-tenant p95 latency floor;
  2. **overload** — admission on (total rate = ``RATE_FRAC`` x measured
     capacity, tenants hot=2 / cold1=1 / cold2=1): the hot tenant hammers
     an unthrottled closed loop (~4x its share of offered load) while the
     two cold tenants trickle well under their shares.

Gates (those of the reference's gate, verbatim):

  * **no admitted 504s** — every deadline-expired response is a refusal
    the admission layer failed to make; admitted work must finish;
  * **hot capped near its share** — the hot tenant's admitted throughput
    lands within ±20% of ``rate * w_hot / sum(w)`` (+ the one-time token
    burst): overload degrades the aggressor to its share, not to zero and
    not past its share;
  * **cold p95 protected** — cold-tenant p95 under overload <= 2x its
    unloaded p95: the aggressor's queue pressure never reaches the
    well-behaved tenants;
  * plus sanity: rejects carry Retry-After, and zero cold rejections (the
    colds offered under their shares, so refusing them would be unfair).

The phases, constants, bars and defaults are those of
``scripts/overload_gate.py``, its SKIP (capacity under 20 rps) included,
and so are the closed loops (``drive``): as many for each tenant, the same
2 ms reject turnaround and cold pace.  They run elsewhere: each tenant's
loops are threads of a process of the tenant's own (``tenant_process``,
started with ``spawn`` before the baseline phase and idle until its phase),
which sends its counts back through a pipe.  The gate's own interpreter
holds only the server, the engine and admission, as in a deployment whose
clients are remote: run as threads beside the server, the hot tenant's
refused requests (re-sent 2 ms after each refusal) cost that one
interpreter about as much client work as the baseline's admitted ones, and
the cold tenants' requests waited on it.
The ops run where selection puts them: unpinned on the card (the server's
start-up work, ``serve_coresets.runtime_hygiene``, builds and loads every
kernel first), or on the CPU under ``REPRO_TORCH_OPS_BACKEND=numpy|torch``.
With neither a card nor a pin it exits 2 and starts nothing.

Run:  python scripts/overload_gate_torch.py [--duration 3.0] [--smoke]
      REPRO_TORCH_OPS_BACKEND=numpy python scripts/overload_gate_torch.py
"""
from __future__ import annotations

import argparse
import multiprocessing
import pathlib
import sys
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.client import AdmissionRejectedError, CoresetClient  # noqa: E402
from repro_torch.core.segmentation import random_tree_segmentation  # noqa: E402
from repro_torch.data.signals import piecewise_signal  # noqa: E402
from repro_torch.service import (AdmissionConfig, AdmissionController,  # noqa: E402
                           CoresetEngine, make_server,
                           serve_forever_in_thread)

N, M, KMAX = 96, 64, 8
WEIGHTS = {"hot": 2.0, "cold1": 1.0, "cold2": 1.0}
RATE_FRAC = 0.5        # admitted rate = this fraction of measured capacity
BURST_S = 0.2
HOT_SHARE_TOL = 0.20   # +-20% around the hot tenant's configured share
COLD_P95_FACTOR = 2.0
DEADLINE_MS = 10_000.0   # generous: admitted work must ALWAYS make it


class TenantStats:
    def __init__(self, name: str):
        self.name = name
        self.ok = 0
        self.rejected = 0
        self.expired = 0           # 504s — must stay zero
        self.errors = 0
        self.latencies: list[float] = []
        self.retry_afters: list[float] = []
        self.lock = threading.Lock()


def p95(xs: list[float]) -> float:
    return float(np.percentile(xs, 95)) if xs else 0.0


def drive(base: str, stats: TenantStats, segs, stop: threading.Event,
          pace_s: float | None) -> None:
    """One closed-loop client thread: ``pace_s=None`` hammers (offered load
    bounded only by round-trip + reject turnaround), else one request per
    ``pace_s`` seconds."""
    cl = CoresetClient(base, tenant=stats.name, retries=0,
                       deadline_ms=DEADLINE_MS)
    rng = np.random.default_rng(hash(stats.name) % (2**32))
    while not stop.is_set():
        q = segs[int(rng.integers(len(segs)))]
        t0 = time.perf_counter()
        try:
            cl.query_loss("sig", q.rects, q.labels, eps=0.3)
            dt = time.perf_counter() - t0
            with stats.lock:
                stats.ok += 1
                stats.latencies.append(dt)
        except AdmissionRejectedError as exc:
            with stats.lock:
                stats.rejected += 1
                if exc.retry_after is not None:
                    stats.retry_afters.append(exc.retry_after)
            time.sleep(0.002)     # reject turnaround: keep offering ~fast
        except Exception as exc:  # noqa: BLE001
            code = getattr(exc, "code", "")
            with stats.lock:
                if code == "deadline_exceeded":
                    stats.expired += 1
                else:
                    stats.errors += 1
        if pace_s is not None:
            time.sleep(pace_s)


def tenant_process(conn, base: str, name: str, segs) -> None:
    """One tenant's closed loops in a process of their own.  Warms the
    process's HTTP client (its first request builds urllib's opener and
    loads the default TLS certificates, tens of ms that a long-running
    client, or a loop in the gate's own warm process, does not pay inside
    its loop), says it is ready, takes its loops' paces (one ``drive``
    thread a pace), runs them until told to stop, then sends back its
    ``TenantStats`` fields."""
    stats = TenantStats(name)
    CoresetClient(base).healthz()
    conn.send(None)
    paces = conn.recv()
    stop = threading.Event()
    threads = [threading.Thread(target=drive, args=(base, stats, segs, stop, pace))
               for pace in paces]
    for t in threads:
        t.start()
    conn.recv()
    stop.set()
    for t in threads:
        t.join()
    conn.send({k: v for k, v in vars(stats).items() if k != "lock"})


def start_tenants(base: str, names, segs) -> dict:
    """One spawned process a tenant, each waiting for its paces; returns
    {name: (process, pipe end)} once every one is ready."""
    ctx = multiprocessing.get_context("spawn")
    procs = {}
    for name in names:
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=tenant_process, args=(child, base, name, segs),
                           name=f"tenant-{name}", daemon=True)
        proc.start()
        child.close()
        procs[name] = (proc, conn)
    for _, conn in procs.values():
        conn.recv()
    return procs


def run_tenants(procs: dict, paces: dict, seconds: float) -> dict:
    """Each named tenant's loops at their paces for ``seconds``; returns
    each one's ``TenantStats`` as its process counted them."""
    running = {name: procs[name] for name in paces}
    for name, (_, conn) in running.items():
        conn.send(paces[name])
    time.sleep(seconds)
    for _, conn in running.values():
        conn.send(None)
    out = {}
    for name, (proc, conn) in running.items():
        out[name] = TenantStats(name)
        vars(out[name]).update(conn.recv())
        proc.join()
    return out


def stop_tenants(procs: dict) -> None:
    """Kill every tenant process still running and reap it."""
    for proc, conn in procs.values():
        if proc.is_alive():
            proc.kill()
        proc.join()
        conn.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--duration", type=float, default=3.0,
                    help="overload phase seconds")
    ap.add_argument("--baseline", type=float, default=1.5,
                    help="unloaded capacity-measurement seconds")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="shorter phases (CI wall-clock)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.duration, args.baseline = 2.0, 1.0

    from repro_torch.launch.serve_coresets import (require_backends,
                                                   runtime_hygiene)
    try:
        backends = require_backends()
    except RuntimeError as exc:
        print(f"overload_gate_torch: {exc}; nothing was run", file=sys.stderr)
        return 2
    runtime_hygiene(backends, verbose=False)

    eng = CoresetEngine(workers=args.workers)
    srv = make_server(eng)
    serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    failures: list[str] = []
    tenants: dict = {}
    try:
        y = piecewise_signal(N, M, KMAX, noise=0.15, seed=7)
        setup = CoresetClient(base)
        setup.register_signal("sig", values=y)
        setup.build("sig", KMAX, 0.2)          # anchor: queries are cache hits
        rng = np.random.default_rng(1)
        segs = [random_tree_segmentation(N, M, 6, rng) for _ in range(16)]
        for q in segs[:4]:                     # warm the scoring path
            setup.query_loss("sig", q.rects, q.labels, eps=0.3)
        tenants = start_tenants(base, ["baseline", *WEIGHTS], segs)

        # ---- phase 1: unloaded capacity + cold p95 floor (no admission)
        bstats = run_tenants(tenants, {"baseline": [None] * 4},
                             args.baseline)["baseline"]
        capacity = bstats.ok / args.baseline
        cold_p95_floor = p95(bstats.latencies)
        print(f"[overload_gate_torch] baseline: capacity={capacity:.0f} rps  "
              f"p95={cold_p95_floor * 1e3:.2f} ms  (n={bstats.ok})")
        if capacity < 20:
            print("[overload_gate_torch] SKIP: capacity too low to overload "
                  "meaningfully on this machine")
            return 0

        # ---- phase 2: admission on, one hot tenant at ~4x its share
        rate = RATE_FRAC * capacity
        ctl = AdmissionController(AdmissionConfig(
            tenants=dict(WEIGHTS), rate_rps=rate, burst_s=BURST_S,
            parallelism=args.workers))
        ctl.metrics = eng.metrics
        eng.admission = ctl
        wsum = sum(WEIGHTS.values())
        hot_share = rate * WEIGHTS["hot"] / wsum
        cold_share = rate * WEIGHTS["cold1"] / wsum
        # colds trickle at ~40% of their own share -> must never be refused
        cold_pace = 1.0 / max(cold_share * 0.4, 1.0)
        tstats = run_tenants(tenants, {"hot": [None] * 4, "cold1": [cold_pace],
                                       "cold2": [cold_pace]}, args.duration)

        hot = tstats["hot"]
        hot_rps = hot.ok / args.duration
        offered = sum(s.ok + s.rejected for s in tstats.values()) \
            / args.duration
        cold_lat = tstats["cold1"].latencies + tstats["cold2"].latencies
        cold_p95 = p95(cold_lat)
        print(f"[overload_gate_torch] overload: offered={offered:.0f} rps "
              f"(~{offered / max(rate, 1e-9):.1f}x admitted rate {rate:.0f})")
        for name, s in tstats.items():
            print(f"[overload_gate_torch]   {name}: ok={s.ok} rejected={s.rejected}"
                  f" expired_504={s.expired} errors={s.errors} "
                  f"p95={p95(s.latencies) * 1e3:.2f} ms")

        # gate 1: admitted requests never die at their deadline
        expired = sum(s.expired for s in tstats.values())
        if expired:
            failures.append(f"{expired} admitted requests returned 504 "
                            "deadline_exceeded under overload")
        errors = sum(s.errors for s in tstats.values())
        if errors:
            failures.append(f"{errors} unexpected errors under overload")

        # gate 2: hot tenant capped near its share (+ the one-time burst)
        burst_allowance = hot_share * BURST_S / args.duration
        lo = hot_share * (1.0 - HOT_SHARE_TOL)
        hi = hot_share * (1.0 + HOT_SHARE_TOL) + burst_allowance
        if not (lo <= hot_rps <= hi):
            failures.append(
                f"hot tenant admitted {hot_rps:.0f} rps, outside "
                f"[{lo:.0f}, {hi:.0f}] (share {hot_share:.0f} +-20%)")
        if hot.rejected == 0:
            failures.append("hot tenant was never pushed back — "
                            "the overload did not overload")

        # gate 3: cold p95 under overload bounded by the unloaded floor
        if cold_p95 > COLD_P95_FACTOR * max(cold_p95_floor, 1e-4):
            failures.append(
                f"cold p95 {cold_p95 * 1e3:.2f} ms > "
                f"{COLD_P95_FACTOR:.0f}x unloaded "
                f"{cold_p95_floor * 1e3:.2f} ms")
        cold_rej = tstats["cold1"].rejected + tstats["cold2"].rejected
        if cold_rej:
            failures.append(f"{cold_rej} cold-tenant requests rejected "
                            "despite offering under their shares")

        # sanity: pushback carried usable Retry-After hints
        if hot.retry_afters and min(hot.retry_afters) <= 0:
            failures.append("503 responses carried non-positive Retry-After")
        snap = eng.stats()["admission"]
        if snap["rejected_total"] != sum(s.rejected for s in tstats.values()):
            failures.append("admission snapshot disagrees with client-side "
                            "reject count")
    finally:
        stop_tenants(tenants)
        srv.shutdown()
        srv.server_close()
        eng.close()

    for f in failures:
        print(f"[overload_gate_torch] FAIL: {f}")
    print(f"[overload_gate_torch] {'PASS' if not failures else 'FAIL'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
