"""Time the Algorithm-5 loss kernel of this checkout against the same kernel
built from other sources, in turns, on one CUDA card.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/fitting_loss_turns.py \\
        --other parent=build/parent/src/repro_torch/csrc/fitting_loss.cu

Each ``--other NAME=PATH`` names a ``fitting_loss.cu`` with this checkout's C
interface (``fitting_loss_batched`` taking the launch shape and
``fl_launch_shape`` giving it), such as an edited copy; its directory also
holds the ``common.cuh`` it includes.  All are built at once with this
checkout's nvcc flags, and each runs at its own ``fl_launch_shape``'s launch
with partials of its own chunks.

The inputs are ``chip_smoke.py``'s serving shapes: the coreset of
``piecewise_signal(4096, 4096, k=64, noise=0.15, seed=0)`` (k = 64,
eps = 0.3, numpy backend) against ``random_tree_segmentation`` trees of 64
leaves (rng seed 1), at T = 1 and T = 256.  Each build is held to the plain
version (``chip_smoke``'s bar, 1e-4 relative).  This checkout's kernel also
runs at the launch shapes of ``VARIANTS`` beside ``kernel.launch_shape``'s
own, each equal to it bitwise (the launch shape changes no sum), which time
that choice.  Every build and variant is timed by CUDA events in the order
others, this, this, others reversed.  One JSON line a T, with the bound as
``chip_smoke.py`` counts it and the overlap shares, then nvidia-smi's name
and power limit.  Exits non-zero without a card or when a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from flash_attention_turns import build_library  # noqa: E402

TREES = (1, 256)
LEAVES = 64
# (warps a CTA, CTAs a tree) timed beside the default
VARIANTS = {1: [(1, 34), (2, 34), (4, 17), (8, 9), (16, 5), (16, 1)],
            256: [(8, 1), (14, 1), (7, 2), (8, 2), (16, 2)]}


def caller(lib: ctypes.CDLL):
    """A function of (blk, seg, shape) launching ``lib``'s
    ``fitting_loss_batched`` as the port's launcher does, at ``lib``'s own
    launch shape or at ``shape``, (warps, splits), where one is given."""
    import torch
    from repro_torch.kernels.fitting_loss import kernel as fk
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.fitting_loss_batched
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
    fn.restype = ctypes.c_int

    def run(blk, seg, shape=None):
        B, (T, K) = blk.shape[0], seg.shape[:2]
        launch = fk.launch_shape(B, T, lib=lib)
        warps, splits = shape or (launch["warps"], launch["splits"])
        partial = torch.empty((T, launch["chunks"]), dtype=torch.float32, device=blk.device)
        out = torch.empty(T, dtype=torch.float32, device=blk.device)
        stream = torch.cuda.current_stream().cuda_stream
        done = fk.done_counts(blk.device, stream, T)
        rc = fn(blk.data_ptr(), seg.data_ptr(), partial.data_ptr(), done.data_ptr(),
                out.data_ptr(), B, T, K, warps, splits, stream)
        if rc != 0:
            raise RuntimeError(f"fitting_loss_batched returned {rc}")
        return out
    return run


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="a fitting_loss.cu with this checkout's interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fitting_loss_turns: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import ops
    from repro_torch.core import random_tree_segmentation, signal_coreset
    from repro_torch.data import piecewise_signal
    from repro_torch.kernels import common
    from repro_torch.kernels.fitting_loss import kernel as fk
    from repro_torch.kernels.fitting_loss.ref import fitting_loss_batched_ref

    from concurrent.futures import ThreadPoolExecutor
    specs = [s.partition("=")[::2] for s in args.other]
    with ThreadPoolExecutor(max(len(specs), 1)) as pool:
        libs = list(pool.map(lambda s: build_library(s[0], pathlib.Path(s[1]).resolve()),
                             specs))
    builds = {name: caller(lib) for (name, _), lib in zip(specs, libs)}
    builds["this"] = caller(common.library("fitting_loss"))
    others = [n for n in builds if n != "this"]
    order = others + ["this", "this"] + others[::-1]

    n = m = 4096
    with ops.backend_override("numpy"):
        coreset = signal_coreset(piecewise_signal(n, m, 64, noise=0.15, seed=0), 64, 0.3)
    rng = np.random.default_rng(1)
    segs = [random_tree_segmentation(n, m, LEAVES, rng) for _ in range(max(TREES))]

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    cr, cl, cw = dev(coreset.rects), dev(coreset.labels), dev(coreset.weights)
    blk = fk.pack_blocks(cr, cl, cw)
    B = blk.shape[0]
    failed = []
    for T in TREES:
        sr = dev(np.stack([s.rects for s in segs[:T]]))
        sl = dev(np.stack([s.labels for s in segs[:T]]))
        seg = fk.pack_trees(sr, sl)
        launch = fk.launch_shape(B, T)
        default = (launch["warps"], launch["splits"])
        plain = fitting_loss_batched_ref(cr, cl, cw, sr, sl).cpu().numpy()
        errs = {}
        for name, run in builds.items():
            got = run(blk, seg).cpu().numpy()
            errs[name] = float(cs.rel_err(got, plain).max())
            if not errs[name] <= 1e-4:
                failed.append(f"{name} at T={T}: {errs[name]} from the plain version")
        ref = builds["this"](blk, seg)
        variants = [v for v in VARIANTS[T] if v[1] <= launch["chunks"]]
        for v in variants:
            if not torch.equal(builds["this"](blk, seg, v), ref):
                failed.append(f"launch {v} at T={T} differs from {default}")
        ms = {name: [] for name in builds}
        for name in order:
            ms[name].append(cs.device_ms(lambda run=builds[name]: run(blk, seg), 20)[0])
        variant_ms = {"x".join(map(str, v)): cs.device_ms(
            lambda v=v: builds["this"](blk, seg, v), 20)[0] for v in variants}
        ops_, work = cs.fl_work(cr, sr)
        ops_ = int(ops_.sum())
        print(json.dumps({
            "kernel": "fitting_loss" if T == 1 else "fitting_loss_batched", "T": T, "B": B,
            "K": LEAVES, "order": order, "ms": ms, "launch": launch,
            "variants_ms": variant_ms, "plain_ms": cs.device_ms(
                lambda: fitting_loss_batched_ref(cr, cl, cw, sr, sl), 5)[0],
            "overlap_share": cs.fl_shares(work, T, B, LEAVES),
            "ops": ops_, **cs.bound(B * 64 + T * LEAVES * 32 + T * 4, ops_,
                                    cs.FP32_OPS_PER_S),
            "max_rel_err": errs}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if failed:
        print("fitting_loss_turns: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
