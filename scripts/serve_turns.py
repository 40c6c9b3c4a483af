"""Time the loss queries of this checkout's serving path against another
checkout's, in turns, on one CUDA card.

    git archive <commit> src/repro_torch | tar -x -C build/parent
    python3 scripts/serve_turns.py --other parent=build/parent

Each ``--other NAME=ROOT`` names a checkout whose ``ROOT/src`` holds a
``repro_torch``.  The requests are ``chip_smoke.py``'s serve phase's: the
coreset of ``piecewise_signal(4096, 4096, k=64, noise=0.15, seed=0)``
(k = 64, eps = 0.3), built once on numpy by this checkout and handed to
every turn as arrays, answers single-tree ``ops.fitting_loss`` requests and
T = 256 ``best_segmentation`` requests of ``random_tree_segmentation``
trees with 64 leaves (rng seed 1), each timed on the host clock with its
result on the host.  Each turn is a process of its own that imports its
checkout's ``repro_torch`` (whose kernels build under that checkout's
``build/``), serves two warm-up requests of each kind, then ``--requests``
single and ``--requests // 8`` batched ones, every loss held to the numpy
oracle within 1e-3 (``chip_smoke.py``'s bar) and both loss kernels
launched.  Turns run in the order others, this, this, others reversed.
One JSON line a turn (p50, mean and max ms of each kind, and the loss
kernels' launches), then nvidia-smi's name and power limit.  Exits
non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import pickle
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
N = M = 4096
K_CORESET, EPS, LEAVES, BATCH = 64, 0.3, 64, 256


def turn(root: pathlib.Path, coreset: pathlib.Path, requests: int) -> int:
    """Serve the requests with ``root``'s ``repro_torch`` and print one JSON
    line."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    import repro_torch
    from repro_torch import ops
    from repro_torch.core import SignalCoreset, fitting_loss, random_tree_segmentation
    from repro_torch.kernels.fitting_loss import kernel as fk
    from repro_torch.trees import best_segmentation
    if not pathlib.Path(repro_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}'s")
    with open(coreset, "rb") as f:
        cs = SignalCoreset.from_arrays(pickle.load(f))
    rng = np.random.default_rng(1)

    def trees(t):
        segs = [random_tree_segmentation(N, M, LEAVES, rng) for _ in range(t)]
        return (np.stack([s.rects for s in segs]).astype(np.float64),
                np.stack([s.labels for s in segs]))

    def single():
        r, lab = trees(1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = ops.fitting_loss(cs, r[0], lab[0])
        s = time.perf_counter() - t0
        want = fitting_loss(cs, r[0], lab[0])
        return s, bool(np.isfinite(loss) and abs(loss - want) <= 1e-3 * abs(want))

    def batched():
        r, lab = trees(BATCH)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i, loss = best_segmentation(cs, r, lab)
        s = time.perf_counter() - t0
        want = np.array([fitting_loss(cs, a, b) for a, b in zip(r, lab)])
        return s, bool(np.isfinite(loss) and want[i] <= want.min() * (1 + 1e-3)
                       and abs(loss - want[i]) <= 1e-3 * abs(want[i]))

    for fn in (single, single, batched, batched):
        fn()
    fk.FITTING_LOSS.launches = fk.FITTING_LOSS_BATCHED.launches = 0
    runs = {"single": [single() for _ in range(requests)],
            "batched": [batched() for _ in range(max(requests // 8, 1))]}
    launches = {"fitting_loss": fk.FITTING_LOSS.launches,
                "fitting_loss_batched": fk.FITTING_LOSS_BATCHED.launches}
    out = {"root": str(root), "launches": launches,
           "ok": all(ok for r in runs.values() for _, ok in r) and min(launches.values()) > 0}
    for kind, r in runs.items():
        ms = [s * 1e3 for s, _ in r]
        out[kind] = {"requests": len(ms), "p50_ms": float(np.median(ms)),
                     "mean_ms": float(np.mean(ms)), "max_ms": max(ms)}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=ROOT",
                    help="a checkout whose src/ holds a repro_torch")
    ap.add_argument("--requests", type=int, default=64,
                    help="single-tree requests a turn (batched: an eighth)")
    ap.add_argument("--turn", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--coreset", type=pathlib.Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("serve_turns: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if args.turn is not None:
        return turn(args.turn.resolve(), args.coreset, args.requests)

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import ops
    from repro_torch.core import signal_coreset
    from repro_torch.data import piecewise_signal
    with ops.backend_override("numpy"):
        cs = signal_coreset(piecewise_signal(N, M, K_CORESET, noise=0.15, seed=0),
                            K_CORESET, EPS)
    work = ROOT / "build" / "serve_turns"
    work.mkdir(parents=True, exist_ok=True)
    coreset = work / "coreset.pkl"
    with open(coreset, "wb") as f:
        pickle.dump(cs.to_arrays(), f)

    roots = {name: pathlib.Path(path).resolve()
             for name, path in (s.partition("=")[::2] for s in args.other)}
    roots["this"] = ROOT
    others = [n for n in roots if n != "this"]
    failed = []
    for name in others + ["this", "this"] + others[::-1]:
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", str(roots[name]), "--coreset", str(coreset),
             "--requests", str(args.requests)],
            capture_output=True, text=True, timeout=600)
        lines = proc.stdout.strip().splitlines()
        if lines:
            print(json.dumps({"name": name, **json.loads(lines[-1])}), flush=True)
        if proc.returncode != 0 or not lines:
            failed.append(f"{name}: exit {proc.returncode}: {proc.stderr[-2000:]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if failed:
        print("serve_turns: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
