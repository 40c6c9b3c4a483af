#!/usr/bin/env python
"""The ``trace`` gate of ``repro_torch``: end-to-end tracing MUST hold
across the stack.

Boots the full HTTP service in-process, drives it through the typed SDK,
and asserts the observability pipeline end to end:

  * **propagation** — the client-minted W3C ``traceparent`` id IS the
    server-side trace id (echoed in ``X-Coreset-Trace-Id`` and retrievable
    at ``GET /v1/trace/{id}``);
  * **taxonomy** — a single coalesced ``/v1/query/loss`` trace contains the
    http root, ``query.scheduler_wait``, and (via its linked fused-dispatch
    trace) an ``ops.dispatch`` span carrying op/backend attributes;
  * **coverage** — the root span's direct children account for >= 80% of
    its wall time (the trace explains where the request went, it does not
    just bracket it);
  * **linking** — a barrier-released burst of concurrent same-signal
    queries produces >= 2 request traces linked to ONE shared
    ``query.fused_dispatch`` trace;
  * **export** — ``?format=chrome`` returns structurally valid Chrome
    trace-event JSON (Perfetto-loadable: X events with ts/dur, process
    metadata, flow events along links).

The checks, bars and defaults are those of ``scripts/trace_gate.py``.
The ops run where selection puts them: unpinned on the card (the server's
start-up work, ``serve_coresets.runtime_hygiene``, builds and loads every
kernel before the engine boots, so no traced request pays a build), or on
the CPU under ``REPRO_TORCH_OPS_BACKEND=numpy|torch``.  With neither a card
nor a pin it exits 2 and starts nothing.

Run:  python scripts/trace_gate_torch.py [--n 8] [--window 0.1]
      REPRO_TORCH_OPS_BACKEND=numpy python scripts/trace_gate_torch.py
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import threading

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.client import CoresetClient  # noqa: E402
from repro_torch.core.segmentation import random_tree_segmentation  # noqa: E402
from repro_torch.data.signals import piecewise_signal  # noqa: E402
from repro_torch.service import (CoresetEngine, make_server,  # noqa: E402
                           serve_forever_in_thread)

MIN_COVERAGE = 0.80


def span_names(trace: dict) -> list[str]:
    return [s["name"] for s in trace["spans"]]


def root_of(trace: dict) -> dict:
    # the root is the span whose span_id no other span claims as parent of
    # itself — i.e. the one with no in-trace parent
    ids = {s["span_id"] for s in trace["spans"]}
    roots = [s for s in trace["spans"]
             if s.get("parent_id") not in ids]
    assert len(roots) == 1, f"expected one root, got {len(roots)}"
    return roots[0]


def child_coverage(trace: dict) -> float:
    """Fraction of the root span's duration covered by its direct
    children (union of their intervals, so overlap is not double-counted)."""
    root = root_of(trace)
    if root["duration_us"] <= 0:
        return 1.0
    kids = [s for s in trace["spans"]
            if s.get("parent_id") == root["span_id"]]
    ivals = sorted((s["start_us"], s["start_us"] + s["duration_us"])
                   for s in kids)
    covered, cursor = 0.0, None
    for a, b in ivals:
        if cursor is None or a > cursor:
            covered += b - a
            cursor = b
        elif b > cursor:
            covered += b - cursor
            cursor = b
    return covered / root["duration_us"]


def check_chrome(doc: dict) -> list[str]:
    errs = []
    if "traceEvents" not in doc or not isinstance(doc["traceEvents"], list):
        return ["chrome export missing traceEvents list"]
    evs = doc["traceEvents"]
    xs = [e for e in evs if e.get("ph") == "X"]
    if not xs:
        errs.append("chrome export has no complete (X) events")
    for e in xs:
        for field in ("name", "ts", "dur", "pid", "tid"):
            if field not in e:
                errs.append(f"X event missing {field!r}: {e}")
                break
    if not any(e.get("ph") == "M" and e.get("name") == "process_name"
               for e in evs):
        errs.append("chrome export missing process_name metadata")
    if not any(e.get("ph") == "s" for e in evs):
        errs.append("chrome export missing flow (link) events")
    return errs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8,
                    help="concurrent queries for the link check")
    ap.add_argument("--window", type=float, default=0.1,
                    help="server batching window (generous: CI boxes jitter)")
    ap.add_argument("--rows", type=int, default=160)
    ap.add_argument("--cols", type=int, default=96)
    ap.add_argument("--k", type=int, default=6)
    args = ap.parse_args(argv)
    n = int(args.n)

    from repro_torch.launch.serve_coresets import (require_backends,
                                                   runtime_hygiene)
    try:
        backends = require_backends()
    except RuntimeError as exc:
        print(f"trace_gate_torch: {exc}; nothing was run", file=sys.stderr)
        return 2
    runtime_hygiene(backends, verbose=False)

    eng = CoresetEngine(query_window=args.window, query_max_fuse=n, workers=4)
    srv = make_server(eng)
    serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    y = piecewise_signal(args.rows, args.cols, args.k, noise=0.15, seed=7)
    cl = CoresetClient(base, retries=0)
    cl.register_signal("gate", y)
    cl.build("gate", args.k, 0.3)   # pre-build: traces measure the query path

    rng = np.random.default_rng(7)
    tree = random_tree_segmentation(args.rows, args.cols, args.k, rng)

    fails: list[str] = []

    # ---- 1. propagation: client-minted id == server trace id
    r = cl.query_loss("gate", tree.rects, tree.labels, eps=0.3)
    sent_id = (cl.last_traceparent or "").split("-")[1] \
        if cl.last_traceparent else ""
    if not sent_id or cl.last_trace_id != sent_id:
        fails.append(f"traceparent did not propagate: sent {sent_id!r}, "
                     f"server answered {cl.last_trace_id!r}")
    query_tid = cl.last_trace_id
    trace = cl.trace(query_tid)
    names = span_names(trace)
    print(f"[trace_gate_torch] trace {trace['trace_id'][:8]}: {names}")

    # ---- 2. taxonomy: required spans, in the trace or its linked traces
    if not any(nm.startswith("POST /v1/query/loss") for nm in names):
        fails.append(f"no http root span in {names}")
    if "query.scheduler_wait" not in names:
        fails.append(f"no query.scheduler_wait span in {names}")
    linked = trace.get("linked_traces", [])
    linked_spans = [s for lt in linked for s in lt["spans"]]
    fused = [s for s in linked_spans if s["name"] == "query.fused_dispatch"]
    if not fused:
        fails.append("request trace links to no query.fused_dispatch trace")
    dispatches = [s for s in trace["spans"] + linked_spans
                  if s["name"] == "ops.dispatch"]
    if not dispatches:
        fails.append("no ops.dispatch span anywhere in the trace graph")
    elif not all(s.get("attrs", {}).get("op")
                 and s.get("attrs", {}).get("backend") for s in dispatches):
        fails.append(f"ops.dispatch span missing op/backend attrs: "
                     f"{[s.get('attrs') for s in dispatches]}")

    # ---- 3. coverage: direct children explain >= 80% of the root
    cov = child_coverage(trace)
    print(f"[trace_gate_torch] root child coverage {cov:.1%} "
          f"(required >= {MIN_COVERAGE:.0%})")
    if cov < MIN_COVERAGE:
        fails.append(f"child spans cover only {cov:.1%} of the request root")

    # ---- 4. linking: a concurrent burst shares ONE fused-dispatch trace
    trees = [random_tree_segmentation(args.rows, args.cols, args.k, rng)
             for _ in range(n)]
    tids: list = [None] * n
    barrier = threading.Barrier(n)

    def worker(i: int) -> None:
        client = CoresetClient(base, retries=0)
        barrier.wait()
        client.query_loss("gate", trees[i].rects, trees[i].labels, eps=0.3)
        tids[i] = client.last_trace_id

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    if any(t is None for t in tids):
        fails.append("concurrent burst: some requests never completed")
    else:
        # fused trace id each request linked to, counted across the burst
        fused_of: dict[str, int] = {}
        for tid in tids:
            tr = cl.trace(tid)
            for s in tr["spans"]:
                for link in s.get("links", ()):
                    if any(lt["trace_id"] == link["trace_id"]
                           and lt["root"] == "query.fused_dispatch"
                           for lt in tr.get("linked_traces", [])):
                        fused_of[link["trace_id"]] = \
                            fused_of.get(link["trace_id"], 0) + 1
        best = max(fused_of.values(), default=0)
        print(f"[trace_gate_torch] burst of {n}: fused-trace fan-in {fused_of} "
              f"(best {best}, required >= 2)")
        if best < 2:
            fails.append("no fused-dispatch trace is linked from >= 2 "
                         "request traces")

    # ---- 5. chrome export is structurally valid
    chrome = cl.trace(query_tid, format="chrome")
    errs = check_chrome(chrome)
    if errs:
        fails.extend(errs)
    else:
        print(f"[trace_gate_torch] chrome export: "
              f"{len(chrome['traceEvents'])} events OK")

    srv.shutdown()
    srv.server_close()
    eng.close()

    for f in fails:
        print(f"[trace_gate_torch] FAIL: {f}")
    print(f"[trace_gate_torch] {'PASS' if not fails else 'FAIL'}")
    return 0 if not fails else 1


if __name__ == "__main__":
    sys.exit(main())
