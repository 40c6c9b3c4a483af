#!/usr/bin/env python
"""The ``coalesce`` gate of ``repro_torch``: concurrent same-signal loss
queries MUST fuse.

Boots the full HTTP service in-process, fires N (default 16) concurrent
``/v1/query/loss`` requests for the same signal from N independent SDK
clients (each its own connection — the exact shape cross-request coalescing
exists for), and asserts:

  * the N requests consumed at most ``N // 4`` scoring dispatches
    (``loss_scoring_calls`` delta), i.e. ``query_coalesced_total`` grew by
    at least ``N - N // 4``;
  * every per-request loss is within 1e-9 (relative) of the uncoalesced
    path (``coalesce=False`` — the inline ``fitting_loss`` escape hatch);
  * responses report the fusion honestly (``fused_batch_size`` sums to the
    number of requests, every response names a backend).

The checks, bars and defaults are those of ``scripts/coalesce_gate.py``.
The ops run where selection puts them: unpinned on the card (the server's
start-up work, ``serve_coresets.runtime_hygiene``, builds and loads every
kernel before the engine boots), or on the CPU under
``REPRO_TORCH_OPS_BACKEND=numpy|torch``.  With neither a card nor a pin it
exits 2 and starts nothing.

Run:  python scripts/coalesce_gate_torch.py [--n 16] [--window 0.1]
      REPRO_TORCH_OPS_BACKEND=numpy python scripts/coalesce_gate_torch.py
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16,
                    help="concurrent same-signal loss queries")
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
        print(f"coalesce_gate_torch: {exc}; nothing was run", file=sys.stderr)
        return 2
    runtime_hygiene(backends, verbose=False)

    eng = CoresetEngine(query_window=args.window, query_max_fuse=n, workers=4)
    srv = make_server(eng)
    serve_forever_in_thread(srv)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    y = piecewise_signal(args.rows, args.cols, args.k, noise=0.15, seed=7)
    warm = CoresetClient(base, retries=0)
    warm.register_signal("gate", y)
    warm.build("gate", args.k, 0.3)   # pre-build: the gate measures QUERIES

    rng = np.random.default_rng(7)
    trees = [random_tree_segmentation(args.rows, args.cols, args.k, rng)
             for _ in range(n)]

    # ---- uncoalesced reference: the coalesce=off escape hatch, serially
    ref = [warm.query_loss("gate", t.rects, t.labels, eps=0.3,
                           coalesce=False).loss for t in trees]
    calls0 = eng.metrics.get("loss_scoring_calls")
    coal0 = eng.metrics.get("query_coalesced_total")

    # ---- N concurrent clients, one query each, barrier-released together
    results: list = [None] * n
    barrier = threading.Barrier(n)

    def worker(i: int) -> None:
        client = CoresetClient(base, retries=0)
        barrier.wait()
        t = trees[i]
        results[i] = client.query_loss("gate", t.rects, t.labels, eps=0.3)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)

    failures = [i for i, r in enumerate(results) if r is None]
    if failures:
        print(f"[coalesce_gate_torch] FAIL: requests {failures} never completed")
        return 1

    dispatches = eng.metrics.get("loss_scoring_calls") - calls0
    coalesced = eng.metrics.get("query_coalesced_total") - coal0
    rel = max(
        abs(results[i].loss - ref[i]) / max(abs(ref[i]), 1e-30)
        for i in range(n))
    fused_sizes = sorted(r.fused_batch_size for r in results)
    backends = sorted({r.backend for r in results})

    max_dispatches = n // 4
    print(f"[coalesce_gate_torch] {n} concurrent queries -> {dispatches} scoring "
          f"dispatches (allowed <= {max_dispatches}), "
          f"query_coalesced_total += {coalesced} "
          f"(required >= {n - max_dispatches})")
    print(f"[coalesce_gate_torch] fused_batch_size: {fused_sizes}, "
          f"backends: {backends}, loss parity rel={rel:.2e}")

    srv.shutdown()
    srv.server_close()
    eng.close()

    if dispatches > max_dispatches:
        print(f"[coalesce_gate_torch] FAIL: {dispatches} scoring dispatches "
              f"> {max_dispatches} — coalescing is not fusing")
        return 1
    if coalesced < n - max_dispatches:
        print(f"[coalesce_gate_torch] FAIL: only {coalesced} queries coalesced")
        return 1
    if rel > 1e-9:
        print(f"[coalesce_gate_torch] FAIL: coalesced losses off the uncoalesced "
              f"path by {rel:.2e} > 1e-9")
        return 1
    # every request of an s-way fusion reports s, so the reported sizes sum
    # to sum(s_j^2) over batches, which is >= n + 2*coalesced whenever the
    # counters are honest ((s-1)(s-2) >= 0 per batch)
    if fused_sizes[0] < 1 or sum(fused_sizes) < n + 2 * coalesced:
        print("[coalesce_gate_torch] FAIL: fused_batch_size under-reports the "
              "fusion the counters claim")
        return 1
    if any(not b for b in backends):
        print("[coalesce_gate_torch] FAIL: response missing backend")
        return 1
    print("[coalesce_gate_torch] PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
