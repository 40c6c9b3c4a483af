"""Coreset serving launcher: v1 HTTP front over the CoresetEngine.

  python -m repro_torch.launch.serve_coresets --port 8787      # serve
  python -m repro_torch.launch.serve_coresets --smoke          # self-check
  python -m repro_torch.launch.serve_coresets --role worker --port 9001
  python -m repro_torch.launch.serve_coresets --role coordinator \
      --peers http://127.0.0.1:9001,http://127.0.0.1:9002      # cluster

The server runs its loss queries, builds and forest fits on the card.  On
the CPU pin a backend (``REPRO_TORCH_OPS_BACKEND=numpy`` or ``torch``):
with neither a card nor a pin it does not boot.  Every role (``single``,
``worker``, ``coordinator``) boots the same way, and its boot line names
the backends its ops dispatch to (``ops on [...]``).

``--smoke`` boots the server on an ephemeral port and drives it exclusively
through the typed SDK (``repro_torch.client.CoresetClient`` — both the binary and
JSON encodings) with >= 4 concurrent client threads (register + build +
tree-loss + forest-fit + streamed ingest), then asserts:

  * at least one *dominance* cache hit was served (a (k', eps') coreset
    answered a (k <= k', eps >= eps') request without a rebuild);
  * the streamed-ingest coreset's Algorithm-5 loss agrees with a one-shot
    ``signal_coreset`` build within the composed eps bound
    (|L_stream - L_oneshot| <= (eps_eff + eps) * true_loss);
  * a fused ``/v1/query/loss:batch`` of T segmentations matches T
    sequential ``/v1/query/loss`` answers while consuming ONE engine
    scoring call instead of T;
  * legacy unversioned routes still answer, with the ``Deprecation``
    header and a ``Link: </v1/...>; rel="successor-version"`` pointer;

and prints the backend that scored the loss queries.  Exit code 0 iff all
checks pass.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import urllib.request

import numpy as np

from repro_torch.client import CoresetClient
from repro_torch.service import CoresetEngine, ServiceMetrics, make_server, serve_forever_in_thread

__all__ = ["main", "run_smoke", "require_backends"]


def run_smoke(*, clients: int = 4, rounds: int = 6, verbose: bool = True) -> int:
    from repro_torch.core import fitting_loss, random_tree_segmentation, signal_coreset, true_loss
    from repro_torch.data.signals import piecewise_signal
    from repro_torch import ops

    metrics = ServiceMetrics()
    engine = CoresetEngine(workers=4, metrics=metrics)
    srv = make_server(engine)
    serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    n, m, k_max, eps_tight = 96, 64, 8, 0.2
    y = piecewise_signal(n, m, k_max, noise=0.15, seed=7)
    setup = CoresetClient(base, encoding="binary")
    setup.register_signal("dense", values=y)
    # anchor build: the (k_max, eps_tight) coreset every later query dominates
    setup.build("dense", k_max, eps_tight)

    errors: list[str] = []
    rng_global = np.random.default_rng(123)
    band_rows = 16
    stream_eps = 0.25

    def query_client(cid: int) -> None:
        # odd clients speak JSON, even speak binary: both negotiated paths
        # are exercised under concurrency
        cl = CoresetClient(base, encoding="json" if cid % 2 else "binary")
        rng = np.random.default_rng(1000 + cid)
        try:
            for _ in range(rounds):
                kq = int(rng.integers(3, k_max + 1))
                q = random_tree_segmentation(n, m, kq, rng)
                r = cl.query_loss("dense", q.rects, q.labels, eps=0.3)
                tl = true_loss(y, q.rects, q.labels)
                if tl > 1e-9 and abs(r.loss - tl) / tl > 0.3 + 1e-6:
                    errors.append(f"client {cid}: rel err "
                                  f"{abs(r.loss - tl) / tl:.3f} > eps")
            cl.fit("dense", k_max, eps_tight, n_estimators=3,
                   predict=[[1, 1], [n - 2, m - 2]])
        except Exception as exc:  # noqa: BLE001
            errors.append(f"client {cid}: {type(exc).__name__}: {exc}")

    def ingest_client() -> None:
        cl = CoresetClient(base, encoding="binary")
        try:
            for i in range(0, n, band_rows):
                cl.ingest("stream", band=y[i:i + band_rows])
            cl.build("stream", k_max, stream_eps)
        except Exception as exc:  # noqa: BLE001
            errors.append(f"ingest: {type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=query_client, args=(cid,))
               for cid in range(max(clients - 1, 3))]
    threads.append(threading.Thread(target=ingest_client))
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    # ---- streamed-ingest consistency vs one-shot build (composed eps bound)
    q = random_tree_segmentation(n, m, 6, rng_global)
    r_stream = setup.query_loss("stream", q.rects, q.labels,
                                eps=stream_eps, k=k_max)
    cs_one = signal_coreset(y, k_max, stream_eps)
    l_one = fitting_loss(cs_one, q.rects, q.labels)
    tl = true_loss(y, q.rects, q.labels)
    composed = r_stream.eps_eff + stream_eps
    gap = abs(r_stream.loss - l_one) / max(tl, 1e-12)
    if gap > composed:
        errors.append(f"streamed vs one-shot gap {gap:.3f} > composed "
                      f"bound {composed:.3f}")

    # ---- fused batch query: one scoring call, answers match sequential
    T = 8
    segs = [random_tree_segmentation(n, m, 5, rng_global) for _ in range(T)]
    batch_rects = np.stack([s.rects for s in segs])
    batch_labels = np.stack([s.labels for s in segs])
    calls_before = metrics.get("loss_scoring_calls")
    rb = setup.query_loss_batch("dense", batch_rects, batch_labels, eps=0.3)
    fused_calls = metrics.get("loss_scoring_calls") - calls_before
    backends = {b: metrics.get(f"ops_backend_{b}") for b in ops.BACKENDS}
    if fused_calls != 1:
        errors.append(f"batch query consumed {fused_calls} scoring calls, "
                      "expected 1")
    seq = [setup.query_loss("dense", s.rects, s.labels, eps=0.3).loss
           for s in segs]
    if not np.allclose(rb.losses, seq, rtol=1e-4):
        errors.append("batch losses diverge from sequential /v1/query/loss")

    # ---- legacy shim still answers, with the Deprecation header
    req = urllib.request.Request(
        base + "/healthz")
    with urllib.request.urlopen(req, timeout=30) as resp:
        legacy_health = json.loads(resp.read())
        if resp.headers.get("Deprecation") != "true":
            errors.append("legacy /healthz missing Deprecation header")
        if "/v1/healthz" not in (resp.headers.get("Link") or ""):
            errors.append("legacy /healthz missing successor-version Link")

    health = setup.healthz()
    dominated = metrics.get("cache_hit_dominated")
    if dominated < 1:
        errors.append("no dominance cache hit was served")
    if health.get("status") != "ok" or legacy_health.get("status") != "ok":
        errors.append(f"healthz: {health} / legacy {legacy_health}")

    srv.shutdown()
    srv.server_close()
    engine.close()

    if verbose:
        snap = metrics.snapshot()
        print(f"[smoke] clients={len(threads)} http_200="
              f"{snap['counters'].get('http_200', 0)} "
              f"builds={snap['counters'].get('builds_completed', 0)} "
              f"exact_hits={snap['counters'].get('cache_hit_exact', 0)} "
              f"dominance_hits={dominated} "
              f"batch_scoring_calls={fused_calls} "
              f"stream_gap={gap:.4f} (bound {composed:.3f})")
        print("[smoke] loss queries scored on " + ", ".join(
            f"{b} ({c} calls)" for b, c in backends.items() if c))
        for e in errors:
            print(f"[smoke] FAIL: {e}")
        print(f"[smoke] {'PASS' if not errors else 'FAIL'}")
    return 0 if not errors else 1


def require_backends() -> dict:
    """The backend each op dispatches to, as selection gives it.  Raises
    (and so the server does not boot) where there is no card and the caller
    pinned neither ``numpy`` nor ``torch``: the server never falls back to
    the CPU on its own, and a ``cuda`` pin needs the card."""
    from repro_torch import ops
    from repro_torch.kernels import common
    backends = {op: ops.select_backend(op) for op in ops.OPS}
    if "cuda" in backends.values():
        common.require_cuda()
    return backends


def _runtime_hygiene(backends: dict, verbose: bool = True) -> None:
    """Serving-process start-up work, so the first request does not pay it:

      * where an op runs on the card, build every CUDA kernel of
        ``repro_torch/csrc`` (one ``nvcc`` a source, all at once, skipped
        where a build of the same source is on disk) and load each
        library once;
      * pre-load the kernel autotune cache so the first dispatch does not
        pay the disk read + fingerprint check mid-request.

    Nothing here is swallowed: a failed build stops the server booting.
    """
    from repro_torch.kernels import common
    from repro_torch.ops import autotune
    if "cuda" in backends.values():
        built = common.build()
        names = sorted(p.stem for p in common.CSRC.glob("*.cu"))
        for name in names:
            common.library(name)
        if verbose:
            print(f"[serve_coresets] CUDA kernels loaded: {', '.join(names)} "
                  f"({len(built)} built now)", flush=True)
    snap = autotune.snapshot()
    if verbose:
        print(f"[serve_coresets] autotune cache: {snap['entries']} "
              f"entries from {snap['cache_path']} "
              f"(loaded={snap['cache_loaded']}, "
              f"fingerprint {snap['fingerprint']}, "
              f"precision={snap['precision_mode']})", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--role", choices=("single", "worker", "coordinator"),
                    default="single",
                    help="single = the classic one-process engine; worker = "
                         "a ShardWorker band server (cluster data plane); "
                         "coordinator = ClusterEngine scattering dense "
                         "builds to --peers behind the full v1 API")
    ap.add_argument("--peers", default="",
                    help="coordinator only: comma-separated worker base "
                         "URLs, e.g. http://10.0.0.2:9001,http://10.0.0.3:9001")
    ap.add_argument("--worker-id", default=None,
                    help="worker only: stable id reported in acks/metrics "
                         "(default host:port)")
    ap.add_argument("--rpc-timeout", type=float, default=30.0,
                    help="coordinator only: per-band-RPC deadline seconds")
    ap.add_argument("--reprobe-s", type=float, default=1.0,
                    help="coordinator only: cooldown before re-probing a "
                         "down worker")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--cache-mb", type=int, default=256)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--num-bands", type=int, default=4)
    ap.add_argument("--query-window-ms", type=float, default=2.0,
                    help="cross-request loss-query batching window")
    ap.add_argument("--query-max-fuse", type=int, default=16,
                    help="flush a query bucket early once this many trees "
                         "queue (the batched kernel's T tile)")
    ap.add_argument("--no-coalesce", action="store_true",
                    help="disable cross-request query coalescing engine-wide")
    ap.add_argument("--no-tracing", action="store_true",
                    help="disable request tracing (spans, /v1/trace/*)")
    ap.add_argument("--access-log", metavar="PATH", default=None,
                    help="JSON-lines access log: one object per request "
                         "(method, path, status, duration_ms, trace_id); "
                         "'-' = stderr.  Off by default")
    ap.add_argument("--slow-ms", type=float, default=None,
                    help="with --access-log, only log requests taking at "
                         "least this many milliseconds (slow-request log)")
    ap.add_argument("--admission", action="store_true",
                    help="enable front-door admission control: 503 + "
                         "Retry-After for work predicted to miss its "
                         "deadline_ms, plus per-tenant weighted fair-share "
                         "rate/in-flight caps (X-Coreset-Tenant header)")
    ap.add_argument("--admission-rate", type=float, default=None,
                    metavar="RPS",
                    help="total admitted requests/second, split across "
                         "tenants by weight (default: unlimited)")
    ap.add_argument("--admission-burst-s", type=float, default=1.0,
                    help="token-bucket depth in seconds of a tenant's rate "
                         "share")
    ap.add_argument("--admission-max-inflight", type=int, default=None,
                    help="total in-flight requests, split across tenants by "
                         "weight (default: unlimited)")
    ap.add_argument("--admission-tenants", default="",
                    metavar="NAME=W,...",
                    help="tenant weights, e.g. 'gold=4,silver=2' — unknown "
                         "tenants join at --admission-default-weight")
    ap.add_argument("--admission-default-weight", type=float, default=1.0)
    ap.add_argument("--no-deadline-guard", action="store_true",
                    help="with --admission, keep fair-share caps but never "
                         "reject on predicted deadline misses")
    ap.add_argument("--no-runtime-hygiene", action="store_true",
                    help="skip startup hygiene (the CUDA kernels' build "
                         "and load, autotune-cache preload)")
    ap.add_argument("--smoke", action="store_true",
                    help="self-check with concurrent SDK clients, then exit")
    args = ap.parse_args()
    peers = [p.strip() for p in args.peers.split(",") if p.strip()]
    if args.role == "coordinator" and not peers:
        ap.error("--role coordinator requires --peers")

    backends = require_backends()
    if not args.no_runtime_hygiene:
        _runtime_hygiene(backends, verbose=not args.smoke)

    if args.smoke:
        sys.exit(run_smoke())

    if args.no_tracing:
        from repro_torch import obs
        obs.set_enabled(False)

    admission = None
    if args.admission:
        from repro_torch.service.admission import AdmissionConfig, AdmissionController
        admission = AdmissionController(AdmissionConfig(
            tenants=AdmissionConfig.parse_tenants(args.admission_tenants),
            default_weight=args.admission_default_weight,
            rate_rps=args.admission_rate,
            burst_s=args.admission_burst_s,
            max_inflight=args.admission_max_inflight,
            parallelism=args.workers,
            deadline_guard=not args.no_deadline_guard))
    elif (args.admission_rate is not None
          or args.admission_max_inflight is not None
          or args.admission_tenants):
        ap.error("--admission-* options require --admission")

    access_fp = None
    if args.access_log is not None:
        access_fp = (sys.stderr if args.access_log == "-"
                     else open(args.access_log, "a", buffering=1))
    elif args.slow_ms is not None:
        ap.error("--slow-ms requires --access-log")

    ops_on = sorted(set(backends.values()))
    if args.role == "worker":
        from repro_torch.cluster import ShardWorker, make_worker_server
        worker = ShardWorker(worker_id=args.worker_id
                             or f"{args.host}:{args.port}")
        srv = make_worker_server(worker, host=args.host, port=args.port)
        print(f"[serve_coresets] worker {worker.worker_id} listening on "
              f"http://{args.host}:{srv.server_address[1]}  "
              f"(POST /v1/worker/band:assign band:delta band:build; "
              f"GET /v1/healthz /v1/metrics; ops on {ops_on})", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            srv.shutdown()
            srv.server_close()
        return

    if args.role == "coordinator":
        from repro_torch.cluster import ClusterEngine
        engine = ClusterEngine(peers, rpc_timeout=args.rpc_timeout,
                               reprobe_s=args.reprobe_s,
                               cache_bytes=args.cache_mb << 20,
                               workers=args.workers,
                               query_window=args.query_window_ms / 1e3,
                               query_max_fuse=args.query_max_fuse,
                               coalesce=not args.no_coalesce,
                               admission=admission)
        up = sum("error" not in h for h in engine.probe_workers().values())
        print(f"[serve_coresets] coordinator: {up}/{len(peers)} workers up",
              flush=True)
    else:
        engine = CoresetEngine(cache_bytes=args.cache_mb << 20,
                               workers=args.workers,
                               num_bands=args.num_bands,
                               query_window=args.query_window_ms / 1e3,
                               query_max_fuse=args.query_max_fuse,
                               coalesce=not args.no_coalesce,
                               admission=admission)
    srv = make_server(engine, host=args.host, port=args.port,
                      access_log=access_fp, slow_ms=args.slow_ms)
    print(f"[serve_coresets] listening on http://{args.host}:"
          f"{srv.server_address[1]}  (v1: POST /v1/signals /v1/ingest "
          f"/v1/build /v1/query/loss /v1/query/loss:batch /v1/query/fit "
          f"/v1/query/compress; GET /v1/healthz /v1/stats /v1/metrics "
          f"/v1/traces:recent /v1/trace/{{id}}; "
          f"legacy unversioned routes deprecated; ops on {ops_on})",
          flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        if access_fp is not None and access_fp is not sys.stderr:
            access_fp.close()


if __name__ == "__main__":
    main()
