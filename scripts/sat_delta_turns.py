"""Time the sat2d kernels of this checkout against the same kernels built from
other sources, in turns, on one CUDA card.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/sat_delta_turns.py \\
        --other parent=build/parent/src/repro_torch/csrc/sat2d.cu

Each ``--other NAME=PATH`` names a ``sat2d.cu`` whose directory also holds
the ``common.cuh`` it includes; it is built with this checkout's nvcc flags
(``flash_attention_turns.build_library``), all of them at once.  An edited
copy of this checkout's ``sat2d.cu`` (other launch constants) times a
design variant the same way.
The delta kernels run at the write path's two tails of the 4096-wide signal
(``chip_smoke.PATCH_ROWS``): float64 held bitwise to the numpy oracle,
float32 to ``chip_smoke.SAT_F32_TOL`` of the plain version on the card, each
beside the library call (carry + ``cumsum∘cumsum``) and the bound.
sat_moments runs at the build's 4096 x 4096 and at a stream frame's
256 x 1024, sat_stack at one merge-reduce level's 12 planes of 512 x 1024,
every build bitwise equal to this one's (and float64 sat_moments to numpy).
Every (kernel, shape) gives each build's device ms by kernel
(torch.profiler), which splits its passes, and this checkout's launch.
Every build is timed by CUDA events in the order others, this, this,
others reversed, so that a drift of the card's clock shows as a difference
between a build's two times.  One JSON line a (kernel, shape), then
nvidia-smi's name and power limit.  Exits non-zero without a card or when a
check fails.
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

M = 4096
MOMENTS_SHAPES = {"4096x4096": (4096, 4096), "band_256x1024": (256, 1024)}
STACK_SHAPE = (12, 512, 1024)


def callers(lib: ctypes.CDLL) -> dict:
    """{kernel name: function of its input tensors} launching ``lib``'s
    entry as the port's launchers do."""
    import torch
    P, I = ctypes.c_void_p, ctypes.c_int

    def entry(symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def checked(symbol, rc):
        if rc != 0:
            raise RuntimeError(f"{symbol} returned {rc}")

    def delta(symbol):
        fn = entry(symbol, [P, P, P, I, I, P])

        def run(carry, tail):
            b, m = tail.shape
            out = torch.empty((3, b, m), dtype=tail.dtype, device=tail.device)
            checked(symbol, fn(carry.data_ptr(), tail.data_ptr(), out.data_ptr(), b, m,
                               torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def moments(symbol):
        fn = entry(symbol, [P, P, I, I, P])

        def run(y):
            n, m = y.shape
            out = torch.empty((3, n, m), dtype=y.dtype, device=y.device)
            checked(symbol, fn(y.data_ptr(), out.data_ptr(), n, m,
                               torch.cuda.current_stream().cuda_stream))
            return out
        return run

    def stack(symbol):
        fn = entry(symbol, [P, P, ctypes.c_longlong, I, I, P])

        def run(stk):
            B, n, m = stk.shape
            out = torch.empty_like(stk)
            checked(symbol, fn(stk.data_ptr(), out.data_ptr(), B, n, m,
                               torch.cuda.current_stream().cuda_stream))
            return out
        return run

    return {f"sat_{kind}_{t}": make(f"sat_{kind}_{t}")
            for kind, make in (("delta", delta), ("moments", moments), ("stack", stack))
            for t in ("f64", "f32")}


def pass_ms(run, inputs, reps: int = 10) -> dict:
    """Device ms a call of each kernel ``run`` launches, by name, from
    torch.profiler over ``reps`` calls."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run(*inputs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run(*inputs)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            name = re.search(r"(\w+)(<|\(|$)", e.key.split("::")[-1]).group(1)
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / reps
    return out


def main() -> int:
    import numpy as np
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another sat2d.cu to time beside this checkout's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sat_delta_turns: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch import ops
    from repro_torch.kernels import common
    from repro_torch.kernels.sat2d import kernel as sk
    from repro_torch.kernels.sat2d.ref import delta_sat_ref

    from concurrent.futures import ThreadPoolExecutor
    specs = [spec.partition("=")[::2] for spec in args.other]
    with ThreadPoolExecutor(max(len(specs), 1)) as pool:
        libs = list(pool.map(lambda s: build_library(s[0], pathlib.Path(s[1]).resolve()),
                             specs))
    builds = {name: callers(lib) for (name, _), lib in zip(specs, libs)}
    builds["this"] = callers(common.library("sat2d"))
    others = [n for n in builds if n != "this"]
    order = others + ["this", "this"] + others[::-1]
    failed = []

    def turns(kernel, label, inputs, library, bound, extra):
        ms = {name: [] for name in builds}
        for name in order:
            run = builds[name][kernel]
            ms[name].append(cs.device_ms(lambda run=run: run(*inputs), 10)[0])
        print(json.dumps({"kernel": kernel, "shape": label, "order": order, "ms": ms,
                          "library_ms": cs.device_ms(library, 10)[0], **bound,
                          "pass_ms": {name: pass_ms(fns[kernel], inputs)
                                      for name, fns in builds.items()}, **extra}),
              flush=True)

    rng = np.random.default_rng(0)
    for b in cs.PATCH_ROWS:
        label = f"tail_{b}"
        carry_h, tail_h = rng.normal(size=(3, M)) * 1e3, rng.normal(size=(b, M))
        want = ops.delta_sat(carry_h, tail_h, backend="numpy")
        for dtype, t in ((torch.float64, "f64"), (torch.float32, "f32")):
            kernel = f"sat_delta_{t}"
            c = torch.as_tensor(carry_h, dtype=dtype, device="cuda")
            x = torch.as_tensor(tail_h, dtype=dtype, device="cuda")
            plain = delta_sat_ref(c, x)
            errs = {}
            for name, fns in builds.items():
                got = fns[kernel](c, x)
                if dtype == torch.float64:
                    errs[name] = float((got.cpu() - torch.as_tensor(want)).abs().max())
                    if not np.array_equal(got.cpu().numpy(), want):
                        failed.append(f"{name} {kernel} at {label} differs from numpy")
                else:
                    errs[name] = cs._scaled_max_err(got, plain, (1, 2))[1]
                    if errs[name] > cs.SAT_F32_TOL:
                        failed.append(f"{name} {kernel} at {label}: {errs[name]} scaled")
                del got
            del plain
            stk = torch.stack([torch.ones_like(x), x, x * x])
            size = torch.finfo(dtype).bits // 8
            peak = cs.FP64_FLOP_PER_S if dtype == torch.float64 else cs.FP32_FLOP_PER_S
            turns(kernel, label, (c, x),
                  lambda c=c, stk=stk: c[:, None, :] + torch.cumsum(torch.cumsum(stk, dim=2),
                                                                    dim=1),
                  cs.bound((4 * b * M + 3 * M) * size, 7 * b * M, peak),
                  {"b": b, "m": M, "launch": sk.launch_shape("delta", b, M),
                   ("max_abs_err" if t == "f64" else "scaled_err"): errs})
            del stk, c, x

    cases = [("moments", label, rng.normal(size=shape))
             for label, shape in MOMENTS_SHAPES.items()]
    cases.append(("stack", "x".join(map(str, STACK_SHAPE)),
                  rng.normal(size=STACK_SHAPE) * (rng.random(STACK_SHAPE) < 0.4)))
    for kind, label, host in cases:
        for dtype, t in ((torch.float64, "f64"), (torch.float32, "f32")):
            kernel = f"sat_{kind}_{t}"
            x = torch.as_tensor(host, dtype=dtype, device="cuda")
            ref = builds["this"][kernel](x).view(torch.uint8)
            same = {name: bool(torch.equal(fns[kernel](x).view(torch.uint8), ref))
                    for name, fns in builds.items()}
            if not all(same.values()):
                failed.append(f"{kernel} at {label} differs between builds: {same}")
            if kernel == "sat_moments_f64":
                stk = np.stack([np.ones_like(host), host, host * host])
                if not np.array_equal(ref.view(torch.float64).cpu().numpy(),
                                      np.cumsum(np.cumsum(stk, axis=2), axis=1)):
                    failed.append(f"sat_moments_f64 at {label} differs from numpy")
                del stk
            del ref
            size = torch.finfo(dtype).bits // 8
            peak = cs.FP64_FLOP_PER_S if dtype == torch.float64 else cs.FP32_FLOP_PER_S
            if kind == "moments":
                stk = torch.stack([torch.ones_like(x), x, x * x])
                lib = (lambda stk=stk: torch.cumsum(torch.cumsum(stk, dim=2), dim=1))
                bound = cs.bound(4 * x.numel() * size, 7 * x.numel(), peak)
                launch = sk.launch_shape("moments", *host.shape)
            else:
                lib = (lambda x=x: torch.cumsum(torch.cumsum(x, dim=-2), dim=-1))
                bound = cs.bound(2 * x.numel() * size, 2 * x.numel(), peak)
                launch = sk.launch_shape("stack", *host.shape[1:], planes=host.shape[0])
            turns(kernel, label, (x,), lib, bound,
                  {"launch": launch, "bitwise_equal_to_this": same})
            del x
            torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if failed:
        print("sat_delta_turns: " + "; ".join(failed), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
