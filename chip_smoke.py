"""Drive the repro_torch main path on one CUDA card and check it.

    python3 chip_smoke.py

at one size: slice 1 at a 4096 x 4096 signal, trees of 64 leaves, batches
of 256; slice 2 (the §5 tuning path) at the Air-Quality shape 9358 x 15 of
the paper's §5, the signal-tree config's coreset and forests.

Phases, one JSON line each:

  device      the card's name and count, and nvidia-smi's name and power limit
  build       nvcc of every source in src/repro_torch/csrc, all at once
  kernels     each kernel against its plain PyTorch version on the card (and
              the float64 scan against numpy, bitwise), with CUDA-event times
              beside the plain version's, a library call's and the bound
  build_path  signal_coreset on the cuda backend; its fingerprint must equal
              the numpy backend's
  serve       single-tree loss requests, then batched (loss:batch / tuning
              sweep) requests through best_segmentation, against the numpy
              oracle
  counts      the launches of every kernel during build_path + serve, then
              those of the script's own float32 sat_moments call (off the
              main path: the build uses float64)
  build_stages  host seconds of each numpy stage of the build, one by one
  hist_kernels  each histsplit kernel against its plain version on the card
              (the float64 one against numpy, bitwise) at three shapes: the
              full training set's root node, the coreset's root node and
              the 2^24 points of the 4096 x 4096 raster, with times
  tuning      tune_k over k in KS with methods full, coreset and uniform,
              once on the auto backend (the card) and once on numpy: equal
              results bitwise, the coreset within 2x of the full data's SSE;
              the launches of every kernel during the auto run, the
              hist_split dispatches and their host seconds on both runs
  variants    the float32 histsplit variants through ops.hist_split, the
              script's own calls off the main path (which uses float64)

then the kernel table, nvidia-smi's line, and a last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero before the
last line.  Without a CUDA device, or without the repository around it, the
script exits non-zero and prints no result.  It imports torch and numpy and
the repro_torch package only.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FP64_FLOP_PER_S = 34e12
# float32 operations per (tree, block, leaf) in csrc/fitting_loss.cu: two
# clipped overlaps (4 each), z, Z, Z - z (3), and per point min, max, sub,
# max, sub, two products and the add (8 x 4)
FL_OPS_PER_TRIPLE = 43
# the tuning sweep of slice 2 and cart's histogram width (max_bins + 1)
KS = [8, 16, 32, 64, 128, 256]
HIST_BINS = 256
HIST_TILE = 2048
# bars of the float32 histsplit variants against their plain versions and
# the float64 oracle, in the reference's scaled measure (scaled_err): its
# float32 kernel tolerance (tests/test_ops.py) and the compensated path's
# certificate (ops/autotune.py PARITY_RTOL)
HIST_F32_TOL = 2e-4
HIST_PARTIALS_TOL = 1e-6


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def rel_err(got, want):
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(np.abs(want), 1e-30)


def scaled_err(got, want) -> float:
    """max |got - want| over the output's largest magnitude (floor 1), the
    reference's certificate measure: a bin whose w*y sum cancels to near
    zero keeps the rounding error of its terms, which an elementwise
    relative error would blow up."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel."""
    import torch
    if not _SPIN_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        stop.record()
        stop.synchronize()
        _SPIN_CYCLES_PER_MS.append(10_000_000 / start.elapsed_time(stop))
    return _SPIN_CYCLES_PER_MS[0]


def device_ms(fn, reps: int) -> tuple[float, float]:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls, by CUDA
    events after a warm-up, and the mean host wall ms of one call.

    A spin kernel holds the stream while the calls are queued, so the events
    see the device's work only, not the host's launch path between calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_cycles_per_ms() * (2 * wall_ms + 1)))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps, wall_ms / reps


def host_ms(fn, reps: int) -> float:
    """Mean host wall ms of one call of ``fn`` that returns its result on
    the host, after a warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    built = common.build()
    regs = {name: [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
            for name, r in built.items()}
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: v["seconds"] for k, v in built.items()}, ptxas=regs)


def check_sat(y_host, dtype, kern, plain_tol):
    """The sat_moments kernel in ``dtype`` against its plain version on the
    card (and, in float64, numpy bitwise).  Returns its table row."""
    import numpy as np
    import torch
    from repro_torch.kernels.sat2d import kernel as sat_kernel
    from repro_torch.kernels.sat2d.ref import sat_moments_ref
    y = torch.as_tensor(y_host, dtype=dtype, device="cuda")
    got = sat_kernel.sat_moments_cuda(y)
    plain = sat_moments_ref(y)
    torch.cuda.synchronize()
    err = []
    for c in range(3):
        d = (got[c].double() - plain[c].double()).abs().max().item()
        scale = plain[c].double().abs().max().item()
        err.append(d)
        check(d <= plain_tol * scale,
              f"sat_moments {dtype} channel {c} vs plain: {d} > {plain_tol} x {scale}")
    if dtype == torch.float64:
        stk = np.stack([np.ones_like(y_host), y_host, y_host * y_host])
        want = np.cumsum(np.cumsum(stk, axis=2), axis=1)
        check(np.array_equal(got.cpu().numpy(), want),
              "sat_moments float64 kernel differs from numpy")
        del stk, want
    n, m = y_host.shape
    stk = torch.stack([torch.ones_like(y), y, y * y])
    size = torch.finfo(dtype).bits // 8
    ms, wall_ms = device_ms(lambda: sat_kernel.sat_moments_cuda(y), 10)
    row = {
        "ms": ms, "wall_ms": wall_ms,
        "plain_ms": device_ms(lambda: sat_moments_ref(y), 10)[0],
        "library_ms": device_ms(
            lambda: torch.cumsum(torch.cumsum(stk, dim=2), dim=1), 10)[0],
        "max_abs_err": max(err),
    }
    bytes_ = 4 * n * m * size                     # read y, write 3 images
    ops_ = 7 * n * m                              # 3 scans x 2 adds + y*y
    peak = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
    row.update(bound(bytes_, ops_, peak))
    row.update(name=f"sat_moments_{'f64' if dtype == torch.float64 else 'f32'}",
               kernel=kern)
    return row


def bound(bytes_, ops_, peak):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def check_fitting_loss(cs, rects, labels):
    """Both loss kernels at the serving shapes against the plain version on
    the card and the numpy oracle; tree alone equals tree in a batch."""
    import numpy as np
    import torch
    from repro_torch.core import fitting_loss as oracle
    from repro_torch.kernels.fitting_loss import kernel as fl_kernel
    from repro_torch.kernels.fitting_loss.ref import (fitting_loss_batched_ref,
                                                      fitting_loss_ref)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

    cr, cl, cw, sr, sl = (dev(a) for a in (cs.rects, cs.labels, cs.weights,
                                           rects, labels))
    blk = fl_kernel.pack_blocks(cr, cl, cw)
    seg = fl_kernel.pack_trees(sr, sl)
    got = fl_kernel.fitting_loss_batched_cuda(blk, seg).cpu().numpy()
    plain = fitting_loss_batched_ref(cr, cl, cw, sr, sl).cpu().numpy()
    want = np.array([oracle(cs, r, lab) for r, lab in zip(rects, labels)])
    check(np.isfinite(got).all() and got.shape == (len(rects),),
          "batched losses not finite or misshapen")
    check(rel_err(got, plain).max() <= 1e-4,
          f"batched kernel vs plain: {rel_err(got, plain).max()}")
    check(rel_err(got, want).max() <= 1e-3,
          f"batched kernel vs numpy oracle: {rel_err(got, want).max()}")
    alone = np.array([fl_kernel.fitting_loss_cuda(blk, seg[t]).item()
                      for t in range(len(rects))], np.float32)
    check(np.array_equal(alone, got), "tree alone differs from tree in batch")
    # the coalescer pads strangers' trees with zero-area leaves
    T, K = labels.shape
    padded = torch.cat([seg, torch.zeros((T, 9, 8), device="cuda")], dim=1)
    check(np.array_equal(fl_kernel.fitting_loss_batched_cuda(blk, padded)
                         .cpu().numpy(), got),
          "zero-area padding leaves changed a loss")
    single_plain = fitting_loss_ref(cr, cl, cw, sr[0], sl[0]).item()
    B = cs.num_blocks
    in_bytes = B * 16 * 4
    rows = []
    for name, T_, fn, pfn, err in (
            ("fitting_loss", 1, lambda: fl_kernel.fitting_loss_cuda(blk, seg[0]),
             lambda: fitting_loss_ref(cr, cl, cw, sr[0], sl[0]),
             abs(float(alone[0]) - single_plain)),
            ("fitting_loss_batched", T,
             lambda: fl_kernel.fitting_loss_batched_cuda(blk, seg),
             lambda: fitting_loss_batched_ref(cr, cl, cw, sr, sl),
             float(np.abs(got - plain).max()))):
        ms, wall_ms = device_ms(fn, 20)
        row = {"name": name, "ms": ms, "wall_ms": wall_ms,
               "plain_ms": device_ms(pfn, 5)[0],
               "library_ms": None, "max_abs_err": err,
               "kernel": (fl_kernel.FITTING_LOSS if T_ == 1
                          else fl_kernel.FITTING_LOSS_BATCHED)}
        row.update(bound(in_bytes + T_ * K * 8 * 4 + T_ * 4,
                         FL_OPS_PER_TRIPLE * T_ * B * K, FP32_FLOP_PER_S))
        rows.append(row)
    return rows, float(rel_err(got, want).max())


def phase_build_stages(y, ps, k, eps, cs):
    """Host seconds of each numpy stage of ``signal_coreset``, run one by one
    on the same prefix stats; together they must rebuild ``cs`` exactly."""
    import numpy as np
    from repro_torch.core import (balanced_partition, bicriteria,
                                  block_representatives, greedy_tree, true_loss)
    from repro_torch.core.coreset import resolve_partition_params
    sec = {}
    t0 = time.perf_counter()
    bic = bicriteria(y, k)
    sec["bicriteria"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g = greedy_tree(ps, k)
    sigma = max(bic.sigma, true_loss(y, g.rects, g.labels, ps=ps) / 6.0)
    sec["greedy_sigma_floor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tol, max_slices = resolve_partition_params(sigma, k, eps, "practical",
                                               bic.alpha_hat)
    part = balanced_partition(ps, tol, max_slices)
    sec["balanced_partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    n, m = y.shape
    block_id = part.block_id_raster(n, m)
    _, _, moments = block_representatives(y.ravel(), block_id.ravel(),
                                          part.num_blocks)
    sec["caratheodory"] = time.perf_counter() - t0
    check(np.array_equal(part.rects, cs.rects)
          and np.array_equal(moments, cs.moments),
          "the stage-by-stage rebuild differs from signal_coreset's")
    emit("build_stages", host_seconds=sec)


def hist_inputs(X, y, w):
    """hist_split's inputs at a forest tree's root over (X, y, w): cart's own
    quantile binning into uint8 codes, and the (w, wy, wy2) channels."""
    from repro_torch.trees import apply_bins, quantile_bins
    codes = apply_bins(X, quantile_bins(X, HIST_BINS - 1))
    return codes, w, w * y, w * y * y


def check_histsplit(shapes):
    """Each histsplit kernel at each of ``shapes`` against its plain version
    on the card, the float64 one also against numpy bitwise and the fused
    one against itself over two runs, with CUDA-event times beside the plain
    version's, the library call's (torch.bincount per feature and channel)
    and the bound; for the float64 one also the host ms of one whole
    ops.hist_split call on the card and on numpy.  Returns one table row
    per kernel; its times are those at the first shape, every shape's are
    under ``at_shapes``."""
    import numpy as np
    import torch
    from repro_torch import ops
    from repro_torch.kernels.histsplit import kernel as hk
    from repro_torch.kernels.histsplit.ops import pack_values
    from repro_torch.kernels.histsplit.ref import histograms_ref, partials_ref
    kernels = {"f64": ("hist_f64", hk.HIST_F64),
               "fused": ("hist_fused_f32", hk.HIST_FUSED),
               "partials": ("hist_partials_f32", hk.HIST_PARTIALS),
               "legacy": ("hist_legacy_f32", hk.HIST_LEGACY)}
    rows = {v: {"name": name, "kernel": kern, "at_shapes": []}
            for v, (name, kern) in kernels.items()}
    B = HIST_BINS
    for label, (codes, w, wy, wy2) in shapes.items():
        P, F = codes.shape
        C = -(-P // HIST_TILE)
        reps = 3 if P > 1 << 20 else 20
        oracle = ops.hist_split(codes, w, wy, wy2, B, backend="numpy")
        c = torch.as_tensor(codes, device="cuda")
        cols = [c[:, f].contiguous() for f in range(F)]
        tile = torch.arange(P, device="cuda") // HIST_TILE * B
        dev = [torch.as_tensor(a, device="cuda") for a in (w, wy, wy2)]
        for variant, row in rows.items():
            vals = pack_values(*dev, variant)
            S, size = vals.shape[1], vals.element_size()

            def kern(vals=vals, variant=variant):
                return hk.histograms_cuda(c, vals, B, variant=variant,
                                          tile_p=HIST_TILE)
            if variant == "partials":
                def plain(vals=vals):
                    return partials_ref(c, vals, B, HIST_TILE)
                ids = [tile + col for col in cols]

                def library(vals=vals, ids=ids):
                    return [torch.bincount(i, weights=vals[:, s], minlength=C * B)
                            for i in ids for s in range(S)]
            else:
                def plain(vals=vals):
                    return histograms_ref(c, vals, B)

                def library(vals=vals):
                    return [torch.bincount(col, weights=vals[:, s], minlength=B)
                            for col in cols for s in range(S)]
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = float((got.double() - want.double()).abs().max())
            at = {"shape": label, "P": P, "max_abs_err": err}
            if variant == "f64":
                check(np.array_equal(got.cpu().numpy(), oracle),
                      f"hist f64 at {label} differs from numpy")
                # what one node's op call costs end to end: pack, one
                # upload, the launch, the copy back; beside numpy's
                for backend in ("cuda", "numpy"):
                    at[f"{backend}_op_call_ms"] = host_ms(
                        lambda backend=backend: ops.hist_split(
                            codes, w, wy, wy2, B, backend=backend), reps)
                at["scaled_err"] = scaled_err(got.cpu(), want.cpu())
                check(at["scaled_err"] <= 1e-12,
                      f"hist f64 at {label} vs plain: {at['scaled_err']}")
            else:
                at["scaled_err"] = scaled_err(got.cpu(), want.cpu())
                check(at["scaled_err"] <= HIST_F32_TOL,
                      f"hist {variant} at {label} vs plain: {at['scaled_err']}")
            if variant == "partials":
                p = got.cpu().numpy().astype(np.float64)
                at["certificate"] = scaled_err(
                    p[..., :3].sum(axis=0) + p[..., 3:].sum(axis=0), oracle)
                check(at["certificate"] <= HIST_PARTIALS_TOL,
                      f"hist partials at {label} vs numpy: {at['certificate']}")
            if variant == "fused":
                check(torch.equal(kern(), got),
                      f"hist fused at {label} differs from run to run")
            at["ms"], at["wall_ms"] = device_ms(kern, reps)
            at["plain_ms"] = device_ms(plain, reps)[0]
            at["library_ms"] = device_ms(library, reps)[0]
            out_bytes = (C if variant == "partials" else 1) * F * B * S * size
            peak = FP64_FLOP_PER_S if variant == "f64" else FP32_FLOP_PER_S
            at.update(bound(P * F + P * S * size + out_bytes, S * P * F, peak))
            row["at_shapes"].append(at)
    for row in rows.values():
        first = row["at_shapes"][0]
        row.update({key: first[key] for key in (
            "ms", "wall_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        row["max_abs_err"] = max(a["max_abs_err"] for a in row["at_shapes"])
    return list(rows.values())


def phase_tuning(y, train, test, kernels):
    """The §5 sweep on the auto backend (the card) with every kernel's count
    at 0 just before it, then on numpy; returns the auto run's launches."""
    import numpy as np
    from repro_torch import ops
    from repro_torch.configs import CONFIG
    from repro_torch.trees import tune_k
    kw = dict(ks=KS, coreset_k=CONFIG.k, target_frac=CONFIG.target_frac,
              n_estimators=CONFIG.n_estimators)
    runs = {}
    for backend in ("auto", "numpy"):
        if backend == "auto":
            for kern in kernels.values():
                kern.launches = 0
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        res = tune_k(y, train, test, hist_backend=backend, **kw)
        wall = time.perf_counter() - t0
        if backend == "auto":
            launches = {name: kern.launches for name, kern in kernels.items()}
        runs[backend] = {
            "result": res, "seconds": wall,
            "dispatches": {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()},
            "dispatch_seconds": {f"{o}/{b}": t for (o, b), t
                                 in ops.dispatch_seconds().items()}}
    res, res_np = runs["auto"]["result"], runs["numpy"]["result"]
    calls = runs["auto"]["dispatches"].get("hist_split/cuda", 0)
    check(calls > 0 and set(runs["auto"]["dispatches"]) == {"hist_split/cuda"},
          f"tune_k on auto dispatched {runs['auto']['dispatches']}")
    check(launches["hist_f64"] == calls,
          f"{launches['hist_f64']} float64 histsplit launches for {calls} dispatches")
    check(all(np.isfinite(v).all() for v in res.losses.values()),
          "held-out SSE not finite")
    check(res.losses == res_np.losses, "cuda and numpy tune_k losses differ")
    check(res.best_k == res_np.best_k and res.sizes == res_np.sizes,
          "cuda and numpy tune_k best k or sizes differ")
    check(min(res.losses["coreset"]) <= 2 * min(res.losses["full"]),
          "coreset SSE beyond twice the full data's")
    hs = runs["auto"]["dispatch_seconds"]["hist_split/cuda"]
    hs_np = runs["numpy"]["dispatch_seconds"]["hist_split/numpy"]
    emit("tuning", n=y.shape[0], m=y.shape[1], ks=KS, coreset_k=CONFIG.k,
         target_frac=CONFIG.target_frac, n_estimators=CONFIG.n_estimators,
         methods={name: {"seconds": res.times[name], "size": res.sizes[name],
                         "best_k": res.best_k[name],
                         "min_sse": min(res.losses[name]),
                         "numpy_seconds": res_np.times[name]}
                  for name in res.losses},
         losses=res.losses, wall_s=runs["auto"]["seconds"],
         numpy_wall_s=runs["numpy"]["seconds"],
         hist_split_dispatches=calls, launches=launches,
         hist_split_host_s=hs, numpy_hist_split_host_s=hs_np,
         hist_split_ms_per_call=hs / calls * 1e3,
         numpy_hist_split_ms_per_call=hs_np / runs["numpy"]["dispatches"][
             "hist_split/numpy"] * 1e3)
    return launches


def phase_variants(inputs, kernels):
    """The float32 histsplit variants through ops.hist_split on the card:
    the script's own calls, off the main path, counted apart and held to
    the numpy oracle.  Returns their launches."""
    from repro_torch import ops
    oracle = ops.hist_split(*inputs, HIST_BINS, backend="numpy")
    own, errs = {}, {}
    for variant, name, tol in (("fused", "hist_fused_f32", HIST_F32_TOL),
                               ("legacy", "hist_legacy_f32", HIST_F32_TOL),
                               ("partials", "hist_partials_f32", HIST_PARTIALS_TOL)):
        kernels[name].launches = 0
        got = ops.hist_split(*inputs, HIST_BINS, backend="cuda", variant=variant)
        own[name] = kernels[name].launches
        errs[name] = scaled_err(got, oracle)
        check(errs[name] <= tol, f"ops.hist_split {variant} vs numpy: {errs[name]}")
    emit("variants", P=len(inputs[1]), launches=own, scaled_err_vs_numpy=errs)
    return own


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch import ops
    from repro_torch.configs import CONFIG
    from repro_torch.core import (PrefixStats, fitting_loss,
                                  random_tree_segmentation, signal_coreset)
    from repro_torch.data import patch_mask, piecewise_signal, sensor_matrix
    from repro_torch.kernels.fitting_loss import kernel as fl_kernel
    from repro_torch.kernels.sat2d import kernel as sat_kernel
    from repro_torch.trees import best_segmentation, signal_to_points

    smi = phase_device()
    phase_build()

    n = m = 4096
    k, eps, leaves, batch = 64, 0.3, 64, 256
    y = piecewise_signal(n, m, k, noise=0.15, seed=0)

    # the numpy-backend build: the fingerprint the cuda build must reproduce,
    # and the coreset whose shapes the loss kernels are checked at
    t0 = time.perf_counter()
    with ops.backend_override("numpy"):
        ps_np_s = time.perf_counter()
        PrefixStats.build(y)
        ps_np_s = time.perf_counter() - ps_np_s
        cs_np = signal_coreset(y, k, eps)
    numpy_build_s = time.perf_counter() - t0

    rng = np.random.default_rng(1)

    def trees(t):
        segs = [random_tree_segmentation(n, m, leaves, rng) for _ in range(t)]
        return (np.stack([s.rects for s in segs]).astype(np.float64),
                np.stack([s.labels for s in segs]))

    # ---------------------------------------------------------------- kernels
    rows = [check_sat(y, torch.float64, sat_kernel.SAT_MOMENTS_F64, 1e-12),
            check_sat(y, torch.float32, sat_kernel.SAT_MOMENTS_F32, 5e-4)]
    fl_rows, fl_oracle_err = check_fitting_loss(cs_np, *trees(batch))
    rows += fl_rows
    emit("kernels", checked=[r["name"] for r in rows],
         fitting_loss_vs_oracle_max_rel=fl_oracle_err,
         times_ms={r["name"]: {key: r[key] for key in (
             "ms", "wall_ms", "plain_ms", "library_ms", "bound_ms")} for r in rows})

    # ------------------------------------------------------------- main path
    for r in rows:
        r["kernel"].launches = 0
    ops.reset_dispatch_counts()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ps = PrefixStats.build(y)
    torch.cuda.synchronize()
    ps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cs = signal_coreset(y, k, eps, _stats=ps)
    host_s = time.perf_counter() - t0
    check(cs.fingerprint() == cs_np.fingerprint(),
          "cuda-backend coreset fingerprint differs from the numpy backend's")
    emit("build_path", n=n, m=m, k=k, eps=eps, blocks=cs.num_blocks,
         fingerprint=cs.fingerprint(), prefix_stats_s=ps_s,
         host_stages_s=host_s, build_s=ps_s + host_s,
         numpy_prefix_stats_s=ps_np_s, numpy_build_s=numpy_build_s,
         sat_moments_f64_device_ms=rows[0]["ms"])

    single_lat, single_err = [], []
    for _ in range(8):
        r, lab = trees(1)
        t0 = time.perf_counter()
        loss = ops.fitting_loss(cs, r[0], lab[0])
        single_lat.append(time.perf_counter() - t0)
        check(np.isfinite(loss), "single loss not finite")
        single_err.append(float(rel_err(loss, fitting_loss(cs, r[0], lab[0]))))
    batch_lat, batch_err, best = [], [], []
    for _ in range(4):
        r, lab = trees(batch)
        t0 = time.perf_counter()
        i, loss = best_segmentation(cs, r, lab)
        batch_lat.append(time.perf_counter() - t0)
        want = np.array([fitting_loss(cs, a, b) for a, b in zip(r, lab)])
        check(np.isfinite(loss) and 0 <= i < batch,
              "best segmentation not finite or out of range")
        check(want[i] <= want.min() * (1 + 1e-3),
              f"best segmentation {i} is not the oracle's best within 1e-3")
        batch_err.append(float(rel_err(loss, want[i])))
        best.append([i, loss])
    check(max(single_err) <= 1e-3 and max(batch_err) <= 1e-3,
          f"served losses vs numpy oracle: {max(single_err)}, {max(batch_err)}")
    emit("serve", single={"requests": 8, "p50_s": float(np.median(single_lat)),
                          "max_s": max(single_lat), "max_rel_err": max(single_err)},
         batched={"requests": 4, "trees": batch, "leaves": leaves,
                  "p50_s": float(np.median(batch_lat)), "max_s": max(batch_lat),
                  "best_max_rel_err": max(batch_err), "best": best})

    counts = {r["name"]: r["kernel"].launches for r in rows}
    dispatches = {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()}
    # the build/serve path uses float64 images; the float32 kernel (the TPU
    # kernel's own type) runs in a call of the script's own, counted apart
    # and held to the float64 images
    own = sat_kernel.SAT_MOMENTS_F32
    own.launches = 0
    s32 = ops.sat_moments(y, dtype=np.float32)
    own_counts = {"sat_moments_f32": own.launches}
    for c, p in enumerate((ps.p0, ps.p1, ps.p2)):
        d = np.abs(s32[c].astype(np.float64) - p[1:, 1:]).max()
        check(d <= 5e-4 * np.abs(p).max(), f"float32 images channel {c}: {d}")
    del s32
    counts.update(own_counts)
    emit("counts", launches={name: c for name, c in counts.items()
                             if name not in own_counts},
         dispatches=dispatches, outside_main_path=own_counts)
    for name, c in counts.items():
        check(c > 0, f"kernel {name} was not launched")
    phase_build_stages(y, ps, k, eps, cs)

    # ------------------------------------------- slice 2: the §5 tuning path
    ys = sensor_matrix(9358, 15, seed=0)
    train, test = patch_mask(*ys.shape, CONFIG.test_fraction, CONFIG.patch,
                             seed=1)
    X_tr, y_tr = signal_to_points(ys, train)
    roots = {"full_root": hist_inputs(X_tr, y_tr, np.ones(len(y_tr))),
             "coreset_root": hist_inputs(*CONFIG.build(ys, mask=train).as_points())}
    X_r, y_r = signal_to_points(y)
    roots["raster_2^24"] = hist_inputs(X_r, y_r, np.ones(len(y_r)))
    del X_r, y_r
    hist_rows = check_histsplit(roots)
    emit("hist_kernels", checked=[r["name"] for r in hist_rows],
         at_shapes={r["name"]: r["at_shapes"] for r in hist_rows})
    del roots["raster_2^24"]
    rows += hist_rows

    kernels = {r["name"]: r["kernel"] for r in rows}
    tuning_counts = phase_tuning(ys, train, test, kernels)
    counts.update({name: c for name, c in tuning_counts.items()
                   if name.startswith("hist_")})
    variant_counts = phase_variants(roots["coreset_root"], kernels)
    counts.update(variant_counts)
    own_counts.update(variant_counts)

    replaces = {
        "sat_moments_f64": "src/repro/kernels/sat2d/kernel.py:78",
        "sat_moments_f32": "src/repro/kernels/sat2d/kernel.py:78",
        "fitting_loss": "src/repro/kernels/fitting_loss/kernel.py:100",
        "fitting_loss_batched": "src/repro/kernels/fitting_loss/kernel.py:163",
        "hist_f64": "src/repro/kernels/histsplit/kernel.py:151",
        "hist_fused_f32": "src/repro/kernels/histsplit/kernel.py:151",
        "hist_partials_f32": "src/repro/kernels/histsplit/kernel.py:137",
        "hist_legacy_f32": "src/repro/kernels/histsplit/kernel.py:124",
    }
    sources = {"sat": "sat2d", "fit": "fitting_loss", "his": "histsplit"}
    table = []
    for r in rows:
        table.append({"name": r["name"], "route": "cuda",
                      "source": f"src/repro_torch/csrc/{sources[r['name'][:3]]}.cu",
                      "replaces": replaces[r["name"]],
                      "launches": counts[r["name"]],
                      "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                      "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                      "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                      **({"launched_by": "chip_smoke's own call, outside the "
                                         "main paths"}
                         if r["name"] in own_counts else {}),
                      **({"timed_at": r["at_shapes"][0]["shape"]}
                         if "at_shapes" in r else {})})
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
        sys.exit(1)
