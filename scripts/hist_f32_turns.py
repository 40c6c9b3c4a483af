"""Time the float32 histogram kernels of this checkout against the same
kernels built from other sources, in turns, on one CUDA card.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/hist_f32_turns.py \\
        --other parent=build/parent/src/repro_torch/csrc/histsplit.cu

Each ``--other NAME=PATH`` names a ``histsplit.cu`` with this checkout's C
interface for ``hist_fused_f32``, ``hist_partials_f32`` and
``hist_legacy_f32``; its directory also holds the ``common.cuh`` it
includes.  All are built at once with this checkout's nvcc flags.

The inputs are ``chip_smoke.py``'s: the full training root and the coreset
root of the §5 signal (``sensor_matrix(9358, 15, seed=0)``), the 2^24
points of ``piecewise_signal(4096, 4096, k=64, noise=0.15, seed=0)``, and
the skewed node of 2^20 points in one bin, F = 2, 256 bins, tiles of 2048
points.  At each, every build's result of each kernel is held bitwise to
this checkout's (the kernels keep one order of adds), then every build is
timed by CUDA events in the order others, this, this, others reversed, and
each build's device ms by kernel (torch.profiler), which splits fused and
legacy into the tile kernel and the tile reduction.  One JSON line a
(shape, kernel) with each build's times, this build's launch of that
kernel, legacy's included (``kernel.launch_shape``: fused and partials
fold features into a CTA once the tiles fill the card, legacy keeps a CTA
a (tile, feature)), and the bound as ``chip_smoke.py`` counts it,
then nvidia-smi's name and power limit.  Exits non-zero without a card or
when a check fails.
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
from sat_delta_turns import pass_ms  # noqa: E402

REPS = 20


def callers(lib: ctypes.CDLL) -> dict:
    """{variant: function of (codes, vals)} launching ``lib``'s float32
    kernels as the port's launcher does, at chip_smoke's tile."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.histsplit import kernel as hk
    kernels = {"fused": hk.HIST_FUSED, "partials": hk.HIST_PARTIALS,
               "legacy": hk.HIST_LEGACY}
    runs = {}
    for variant, kern in kernels.items():
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes
        fn.restype = ctypes.c_int

        def run(codes, vals, fn=fn, variant=variant, B=cs.HIST_BINS, tp=cs.HIST_TILE):
            P, F = codes.shape
            C = -(-P // tp)
            stream = torch.cuda.current_stream().cuda_stream
            if variant == "partials":
                out = torch.empty((C, F, B, 6), dtype=torch.float32, device=codes.device)
                rc = fn(codes.data_ptr(), vals.data_ptr(), out.data_ptr(), P, F, B, tp, stream)
            else:
                partial = torch.empty((C, F, B, 3), dtype=torch.float32, device=codes.device)
                out = torch.empty((F, B, 3), dtype=torch.float32, device=codes.device)
                rc = fn(codes.data_ptr(), vals.data_ptr(), partial.data_ptr(), out.data_ptr(),
                        P, F, B, tp, stream)
            if rc != 0:
                raise RuntimeError(f"{fn.__name__} returned {rc}")
            return out
        runs[variant] = run
    return runs


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="a histsplit.cu with this checkout's interface")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("hist_f32_turns: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    from repro_torch.data import patch_mask, piecewise_signal, sensor_matrix
    from repro_torch.kernels import common
    from repro_torch.kernels.histsplit import kernel as hk
    from repro_torch.kernels.histsplit.ops import pack_values

    from concurrent.futures import ThreadPoolExecutor
    specs = [s.partition("=")[::2] for s in args.other]
    with ThreadPoolExecutor(max(len(specs), 1)) as pool:
        libs = list(pool.map(lambda s: build_library(s[0], pathlib.Path(s[1]).resolve()),
                             specs))
    builds = {name: callers(lib) for (name, _), lib in zip(specs, libs)}
    builds["this"] = callers(common.library("histsplit"))
    others = [n for n in builds if n != "this"]
    order = others + ["this", "this"] + others[::-1]

    ys = sensor_matrix(9358, 15, seed=0)
    train, _ = patch_mask(*ys.shape, CONFIG.test_fraction, CONFIG.patch, seed=1)
    y = piecewise_signal(4096, 4096, 64, noise=0.15, seed=0)
    shapes = {**cs.hist_roots(ys, train, y), "skewed_2^20": cs.skewed_node()}
    del y
    B, tp = cs.HIST_BINS, cs.HIST_TILE
    failed = []
    for label, (codes, w, wy, wy2) in shapes.items():
        P, F = codes.shape
        C = -(-P // tp)
        c = torch.as_tensor(codes, device="cuda")
        dev = [torch.as_tensor(a, device="cuda") for a in (w, wy, wy2)]
        for variant in ("fused", "partials", "legacy"):
            vals = pack_values(*dev, variant)
            S, size = vals.shape[1], vals.element_size()
            ref = builds["this"][variant](c, vals)
            for name in others:
                if not torch.equal(builds[name][variant](c, vals), ref):
                    failed.append(f"{name}'s {variant} at {label} differs from this build's")
            ms = {name: [] for name in builds}
            for name in order:
                ms[name].append(cs.device_ms(
                    lambda run=builds[name][variant]: run(c, vals), REPS)[0])
            out_bytes = (C if variant == "partials" else 1) * F * B * S * size
            print(json.dumps({
                "kernel": f"hist_{variant}_f32", "shape": label, "P": P, "F": F,
                "n_bins": B, "tile_p": tp, "order": order, "ms": ms,
                "pass_ms": {name: pass_ms(run[variant], (c, vals))
                            for name, run in builds.items()},
                "launch": hk.launch_shape(variant, P, F, B, tp),
                **cs.bound(P * F + P * S * size + out_bytes, S * P * F, cs.FP32_FLOP_PER_S)}),
                flush=True)
            del vals, ref
        del c, dev
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if failed:
        print("hist_f32_turns: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
