"""Time the flash-attention kernels of this checkout against the same
kernels built from other sources, in turns, on one CUDA card.

    git archive <commit> src/repro_torch/csrc | tar -x -C build/parent
    python3 scripts/flash_attention_turns.py \\
        --other parent=build/parent/src/repro_torch/csrc/flash_attention.cu

Each ``--other NAME=PATH`` names a ``flash_attention.cu`` whose directory
also holds the ``common.cuh`` it includes; it is built with this checkout's
nvcc flags.  At every shape of ``chip_smoke.FA_SHAPES`` (``--dtype`` keeps
the bfloat16 or the float32 ones) each build's kernel of the shape's dtype
is held to ``flash_attention_plain`` (max abs and relative Frobenius error
within ``chip_smoke.FA_TOL``), then timed by CUDA events in the order
others, this, this, others reversed, so that a drift of the card's clock
shows as a difference between a build's two times.  One JSON line a shape,
then nvidia-smi's name and power limit.  Exits non-zero without a card or
when a build disagrees with the plain version.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def build_library(name: str, source: pathlib.Path) -> ctypes.CDLL:
    """The library built from ``source``, a ``csrc`` file whose directory
    also holds the ``common.cuh`` it includes, with this checkout's flags."""
    from repro_torch.kernels import common
    h = hashlib.blake2b(digest_size=8)
    for p in (source, source.with_name("common.cuh")):
        h.update(p.read_bytes())
    h.update(" ".join(common.NVCC_FLAGS).encode())
    out = common.BUILD_DIR / f"turns-{name}-{source.stem}-{h.hexdigest()}.so"
    if not out.exists():
        common.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        r = subprocess.run([common._nvcc(), *common.NVCC_FLAGS, "-o", str(out), str(source)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{r.stdout}{r.stderr}")
    return ctypes.CDLL(str(out))


SYMBOLS = {"bfloat16": "flash_attention_bf16", "float32": "flash_attention_f32"}


def build_other(name: str, source: pathlib.Path) -> dict:
    """{dtype: function of (q, k, v)} launching the kernels built from
    ``source``."""
    lib = build_library(name, source)
    from repro_torch.kernels.flash_attention.kernel import _ARGS
    runs = {}
    for dt, symbol in SYMBOLS.items():
        fn = getattr(lib, symbol)
        fn.argtypes = _ARGS
        fn.restype = ctypes.c_int
        runs[dt] = caller(fn, symbol)
    return runs


def caller(fn, symbol: str):
    """A function of (q, k, v) that launches ``fn`` as the port's launcher
    does, causal."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import empty_row_divisor

    def run(q, k, v):
        B, Hq, Lq, D = q.shape
        Hkv, Lk = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Lq, Lk,
                D, 1, 1.0 / float(D) ** 0.5, empty_row_divisor(Lk),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{symbol} returned {rc}")
        return out
    return run


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another flash_attention.cu to time beside this checkout's")
    ap.add_argument("--dtype", choices=sorted(SYMBOLS), action="append",
                    help="time the shapes of this dtype only (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_attention_turns: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain

    builds = {}
    for spec in args.other:
        name, _, path = spec.partition("=")
        builds[name] = build_other(name, pathlib.Path(path).resolve())
    builds["this"] = {dt: (lambda q, k, v: fa.flash_attention_cuda(q, k, v))
                      for dt in SYMBOLS}
    others = [n for n in builds if n != "this"]
    order = others + ["this", "this"] + others[::-1]

    labels = [lb for lb, s in cs.FA_SHAPES.items() if s[-1] in (args.dtype or SYMBOLS)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    failed = False
    for label in labels:
        B, Hq, Hkv, Lq, Lk, D, dt = cs.FA_SHAPES[label]
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
        plain = flash_attention_plain(q, k, v).float()
        errs = {}
        for name, runs in builds.items():
            d = runs[dt](q, k, v).float() - plain
            errs[name] = {"max_abs_err": float(d.abs().max()),
                          "rel_fro_err": float(d.norm() / plain.norm())}
            failed |= max(errs[name].values()) > cs.FA_TOL[dt]
            del d
        del plain
        reps = 3 if Lq > 8192 else 20
        ms = {name: [] for name in builds}
        for name in order:
            ms[name].append(cs.device_ms(lambda run=builds[name][dt]: run(q, k, v), reps)[0])
        library_ms = cs.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)[0]
        flops = 4 * B * Hq * D * cs.visible_pairs(Lq, Lk, True)
        peak = cs.BF16_FLOP_PER_S if dt == "bfloat16" else cs.F32_3XTF32_FLOP_PER_S
        print(json.dumps({
            "shape": label, "B": B, "Hq": Hq, "Hkv": Hkv, "Lq": Lq, "Lk": Lk, "D": D,
            "dtype": dt, "order": order, "ms": ms, "library_ms": library_ms, "flops": flops,
            "tflop_per_s": {n: flops / (sum(t) / len(t)) / 1e9 for n, t in ms.items()},
            **cs.bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(), flops,
                       peak),
            "errors": errs}), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    if failed:
        print("flash_attention_turns: a build disagrees with the plain version",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
