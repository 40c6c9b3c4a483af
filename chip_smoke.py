"""Drive the repro_torch main path on one CUDA card and check it.

    python3 chip_smoke.py

at one size: slice 1 at a 4096 x 4096 signal, trees of 64 leaves, batches
of 256; slice 2 (the §5 tuning path) at the Air-Quality shape 9358 x 15 of
the paper's §5, the signal-tree config's coreset and forests; slice 3 (the
write path) with row patches of the slice-1 signal and a line-scan stream of
eight 256 x 1024 frames; slice 4 (LM serving) with qwen2-0.5b at full width
(24 layers, d_model 896, 14 query and 2 KV heads of 64, vocab 151,936) and
random weights from a seeded generator.

Phases, one JSON line each:

  device      the card's name and count, and nvidia-smi's name and power limit
  build       nvcc of every source in src/repro_torch/csrc, all at once, with
              each entry's registers and spills (ptxas); the fa_bf16 and
              fa_f32 instantiations, the ten sat2d entries, fl_score and
              histsplit's two hist_sort_kernel entries must not spill
  kernels     each kernel against its plain PyTorch version on the card (and
              the float64 scan against numpy, bitwise), with CUDA-event times
              beside the plain version's, a library call's and the bound;
              sat_moments at the 4096 x 4096 signal and at a stream frame
              (256 x 1024), each with its launch (both passes' CTAs and
              ring depths)
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
              at three shapes: the full training set's root node, the
              coreset's root node and the 2^24 points of the 4096 x 4096
              raster, with times.  The float64 kernel runs at each with all
              rows and with a node's rows (a stable random half), and at a
              skewed 2^20-point node with every code in one bin: bitwise
              numpy's bincount, within 1e-12 of its plain version on the
              card, the same from run to run; device ms, host ms a call
              through the resident path (ResidentHist, the trees' path),
              bincount x6 ms and the bytes bound.  The float32 kernels run
              at the three shapes and at the skewed node, each the same
              from run to run; each also bitwise the CPU's in-order sums
              (partials_ref) at the two roots, with each shape's launch
              (the source's hist_f32_launch_shape) and its entry's
              registers and spills; legacy bitwise fused at every shape
  tuning      tune_k over k in KS with methods full, coreset and uniform,
              once on the auto backend (the card) and once on numpy: equal
              results bitwise, the coreset within 2x of the full data's SSE;
              the launches of every kernel during the auto run (one
              hist_f64_node launch a hist_split/cuda dispatch), the
              hist_split dispatches and their host seconds on both runs
  variants    the histsplit op surface, ops.hist_split on the card in every
              variant (float64 bitwise numpy's, the float32 ones within
              their bars), the script's own calls off the main path (the
              trees go through ResidentHist)
  write_kernels  the delta and stack kernels against their plain versions at
              the write path's shapes: float64 bitwise equal to numpy and to
              the plain version run on the CPU (where torch's scans keep the
              kernels' order), float32 within 5e-4 of the plain version on
              the card; with times, the library call's and the bound, and
              at each shape the launch (each pass's CTAs and ring depth)
  write_path  three chained row patches of the slice-1 signal's prefix stats
              on the card (rows 2048-2303 replaced, a 256-row band appended,
              the last 256 rows replaced), bitwise equal to the numpy build
              of the final signal; host ms per patch beside the builds'
  stream      a StreamingBuilder over eight frames with two replaced, and
              sharded_coreset of the final signal in eight bands, on the
              card and on numpy: equal fingerprints; seconds per insert,
              flush and run, and the streaming_compress dispatch seconds
  write_counts  the launches of every kernel during write_path + stream,
              then those of the script's own float32 delta and stack calls
  lm_kernels  the flash-attention kernels against their plain version on the
              card at the prefill's shape (4 x 14 heads x 2048, bf16),
              prefill_32k's length (1 x 14 x 32768, bf16), yi-9b's heads
              of 128 (prefill_d128: 1 x 32 query and 4 KV heads x 4096,
              bf16) and the float32 path's and a ragged float32 shape, with
              times beside the plain version's,
              scaled_dot_product_attention's and the bound
  lm_serve    prefill of 4 x 2048 prompt tokens through the kernel (24
              launches, one a layer), its logits against attn_impl="torch";
              the float32 model's prefill logits against teacher-forced
              decode at every position of a 4 x 64 prompt; greedy generate
              of 32 tokens after 4 x 64; host seconds, tokens/s, ms a step,
              and the device's busy time (torch.profiler) in a prefill and
              a decode step

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
BF16_FLOP_PER_S = 989e12
# dense TF32 on the tensor cores; a 3xTF32 product is three of them
TF32_FLOP_PER_S = 495e12
F32_3XTF32_FLOP_PER_S = TF32_FLOP_PER_S / 3
# the loss kernel's work, as these inputs need it in its design (fl_work): a
# box test of every (tree, 32-block chunk, leaf) (a min, a max and a compare
# for the rows and for the columns); the overlap z of every block of a
# chunk with each leaf that overlaps some block of it (two clipped overlaps
# of 4 operations, the product and the test z > 0); and for the (tree,
# block, leaf) triples with z > 0 the body: Z, Z - z, and per point min,
# max, sub, max, sub, two products and the add (2 + 8 x 4).  Adds,
# multiplies, mins and maxes issue at half the FMA-counted float32 peak
FL_BOX_OPS = 6
FL_OVERLAP_OPS = 10
FL_BODY_OPS = 34
FP32_OPS_PER_S = FP32_FLOP_PER_S / 2
# the tuning sweep of slice 2 and cart's histogram width (max_bins + 1)
KS = [8, 16, 32, 64, 128, 256]
HIST_BINS = 256
HIST_TILE = 2048
# the float64 histogram's extra nodes: a node's rows are a stable random half
# of its root's (rng seed HIST_ROWS_SEED); the skewed node has HIST_SKEWED
# points, every code the same bin
HIST_ROWS_SEED = 7
HIST_SKEWED = 1 << 20
# bars of the float32 histsplit variants against their plain versions and
# the float64 oracle, in the reference's scaled measure (scaled_err): its
# float32 kernel tolerance (tests/test_ops.py) and the compensated path's
# certificate (ops/autotune.py PARITY_RTOL)
HIST_F32_TOL = 2e-4
HIST_PARTIALS_TOL = 1e-6
# the write path of slice 3: row patches of the slice-1 signal (first row,
# rows) replaced, then a band of STREAM_ROWS appended and replaced; a stream
# of STREAM_BANDS frames of STREAM_ROWS x STREAM_M with STREAM_REPLACE
# replaced.  The float32 scans' bar is the reference's kernel tolerance
# (tests/test_ops.py, rtol 5e-4), here scaled by each channel's largest value
PATCH_ROWS = (2048, 256)
STREAM_M, STREAM_K, STREAM_EPS = 1024, 32, 0.3
STREAM_BANDS, STREAM_ROWS, STREAM_REPLACE = 8, 256, (1, 6)
SAT_F32_TOL = 5e-4
# slice 4: LM serving.  The flash-attention kernel against its plain version
# (max abs error; bf16: a P entry that rounds the other way and the output's
# last bit, float32: the order of the sums), at (B, Hq, Hkv, Lq, Lk, D)
LM_ARCH = "qwen2-0.5b"
FA_SHAPES = {"prefill": (4, 14, 2, 2048, 2048, 64, "bfloat16"),
             "prefill_32k": (1, 14, 2, 32768, 32768, 64, "bfloat16"),
             "prefill_d128": (1, 32, 4, 4096, 4096, 128, "bfloat16"),
             "f32_path": (4, 14, 2, 64, 64, 64, "float32"),
             "f32_ragged": (2, 4, 2, 300, 300, 32, "float32")}
FA_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
LM_PREFILL = (4, 2048)        # prompts x tokens of the full-width prefill
LM_XCHECK = (4, 64)           # float32 prefill against teacher-forced decode
LM_GEN = (4, 64, 32)          # prompts, prompt tokens, new tokens
# bf16 kernel-path logits against attn_impl="torch" (relative Frobenius);
# float32 prefill against decode, the reference's own bar
# (tests/test_models_smoke.py), abs and rel
LM_LOGITS_TOL = 2e-2
LM_DECODE_TOL = 2e-3
# the bf16 kernel path may stand no farther from the float32 model's logits
# than the bf16 plain path does, times this margin (both read ~1.5e-2)
LM_F32_MARGIN = 1.1


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


def ptxas_entries(log: str) -> dict:
    """{entry function: {registers, spill_stores, spill_loads}} from nvcc's
    ``-Xptxas -v`` output."""
    import re
    entries, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = entries.setdefault(m.group(1), {})
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                cur["registers"] = int(m.group(1))
    return entries


def phase_build():
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    built = common.build()
    regs = {name: [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
            for name, r in built.items()}
    entries = {name: ptxas_entries(r["log"]) for name, r in built.items()}
    emit("build", seconds=time.perf_counter() - t0,
         per_source={k: v["seconds"] for k, v in built.items()}, ptxas=regs,
         ptxas_entries=entries,
         warnings=[ln.strip() for r in built.values() for ln in r["log"].splitlines()
                   if "warning" in ln.lower()])
    # the attention kernels (three head widths each), every sat2d entry
    # (row_scan: moments mode at 1 and 4 rows a CTA and plain mode;
    # col_scan at 1 and 3 warps a CTA; two types), the fitting_loss entry
    # and histsplit's in-tile sort (S = 3: fused and legacy; S = 6: partials)
    # must not spill
    for source, name, count in (("flash_attention", "fa_bf16", 3),
                                ("flash_attention", "fa_f32", 3), ("sat2d", "", 10),
                                ("fitting_loss", "fl_score", 1),
                                ("histsplit", "hist_sort_kernel", 2)):
        if source in built:
            found = {f: e for f, e in entries[source].items() if name in f}
            check(len(found) == count and all(e.get("spill_stores") == 0
                                              and e.get("spill_loads") == 0
                                              for e in found.values()),
                  f"the {name} entries spill or are missing: {found}")
    return entries


def check_sat(shapes, dtype, kern, plain_tol):
    """The sat_moments kernel in ``dtype`` at each of ``shapes`` ({label: y})
    against its plain version on the card (and, in float64, numpy
    bitwise), with times and its launch.  Returns its table row, timed at
    the first shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.sat2d import kernel as sat_kernel
    from repro_torch.kernels.sat2d.ref import sat_moments_ref
    at_shapes = []
    for label, y_host in shapes.items():
        y = torch.as_tensor(y_host, dtype=dtype, device="cuda")
        got = sat_kernel.sat_moments_cuda(y)
        plain = sat_moments_ref(y)
        torch.cuda.synchronize()
        err = []
        for c in range(3):
            d = (got[c].double() - plain[c].double()).abs().max().item()
            scale = plain[c].double().abs().max().item()
            err.append(d)
            check(d <= plain_tol * scale, f"sat_moments {dtype} at {label} channel "
                  f"{c} vs plain: {d} > {plain_tol} x {scale}")
        if dtype == torch.float64:
            stk = np.stack([np.ones_like(y_host), y_host, y_host * y_host])
            want = np.cumsum(np.cumsum(stk, axis=2), axis=1)
            check(np.array_equal(got.cpu().numpy(), want),
                  f"sat_moments float64 kernel at {label} differs from numpy")
            del stk, want
        del got, plain
        n, m = y_host.shape
        stk = torch.stack([torch.ones_like(y), y, y * y])
        size = torch.finfo(dtype).bits // 8
        ms, wall_ms = device_ms(lambda: sat_kernel.sat_moments_cuda(y), 10)
        at = {
            "shape": label, "n": n, "m": m,
            "launch": sat_kernel.launch_shape("moments", n, m),
            "ms": ms, "wall_ms": wall_ms,
            "plain_ms": device_ms(lambda: sat_moments_ref(y), 10)[0],
            "library_ms": device_ms(
                lambda: torch.cumsum(torch.cumsum(stk, dim=2), dim=1), 10)[0],
            "max_abs_err": max(err),
        }
        bytes_ = 4 * n * m * size                     # read y, write 3 images
        ops_ = 7 * n * m                              # 3 scans x 2 adds + y*y
        peak = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
        at.update(bound(bytes_, ops_, peak))
        at_shapes.append(at)
        del y, stk
    row = {"name": f"sat_moments_{'f64' if dtype == torch.float64 else 'f32'}",
           "kernel": kern, "at_shapes": at_shapes}
    return _rows_from_shapes([row])[0]


def bound(bytes_, ops_, peak):
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def fl_work(rects, seg_rects):
    """The loss kernel's operations for each of the (T, K, 4) trees against
    the (B, 4) blocks on the card, as its design needs them for these inputs
    (FL_*_OPS), and the counts they come from (kernel.work)."""
    from repro_torch.kernels.fitting_loss import kernel as fl_kernel
    chunk = fl_kernel.launch_shape(rects.shape[0], 1)["chunk"]
    work = fl_kernel.work(rects, seg_rects, chunk)
    ops_ = (FL_BOX_OPS * work["box_tests"] + FL_OVERLAP_OPS * chunk * work["chunk_hits"]
            + FL_BODY_OPS * work["live_pairs"])
    return ops_, work


def fl_shares(work, T, B, K) -> dict:
    """The first T trees' shares of (block, leaf) pairs that overlap and of
    (chunk, leaf) pairs with any overlapping block."""
    return {"pairs": float(work["live_pairs"][:T].sum()) / (T * B * K),
            "chunks": float(work["chunk_hits"][:T].sum()) / float(work["box_tests"][:T].sum())}


def check_fitting_loss(cs, rects, labels):
    """Both loss kernels at the serving shapes against the plain version on
    the card and the numpy oracle; tree alone equals tree in a batch, and
    zero-area leaves, appended or inserted, change nothing.  Each row has
    its launch, the share of (block, leaf) pairs that overlap and of
    (32-block chunk, leaf) pairs with any, and a bound that counts the work
    the kernel's design needs for these inputs (fl_work)."""
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
    zeros = torch.zeros((T, 9, 8), device="cuda")
    padded = torch.cat([seg, zeros], dim=1)
    inserted = torch.cat([seg[:, :K // 2], zeros, seg[:, K // 2:]], dim=1)
    for what, trees_ in (("appended", padded), ("inserted", inserted)):
        check(np.array_equal(fl_kernel.fitting_loss_batched_cuda(blk, trees_)
                             .cpu().numpy(), got),
              f"zero-area leaves {what} changed a loss")
    single_plain = fitting_loss_ref(cr, cl, cw, sr[0], sl[0]).item()
    B = cs.num_blocks
    in_bytes = B * 16 * 4
    ops_, work = fl_work(cr, sr)
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
        row.update(bound(in_bytes + T_ * K * 8 * 4 + T_ * 4, int(ops_[:T_].sum()),
                         FP32_OPS_PER_S))
        row.update(launch=fl_kernel.launch_shape(B, T_),
                   overlap_share=fl_shares(work, T_, B, K))
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


def hist_roots(ys, train, y) -> dict:
    """hist_split's inputs at the three shapes of the histogram phases: the
    root of a tree over the §5 signal's training points (full_root), over
    its coreset's (coreset_root), and over the 2^24 points of the slice-1
    raster ``y``."""
    import numpy as np
    from repro_torch.configs import CONFIG
    from repro_torch.trees import signal_to_points
    X_tr, y_tr = signal_to_points(ys, train)
    roots = {"full_root": hist_inputs(X_tr, y_tr, np.ones(len(y_tr))),
             "coreset_root": hist_inputs(*CONFIG.build(ys, mask=train).as_points())}
    X_r, y_r = signal_to_points(y)
    roots["raster_2^24"] = hist_inputs(X_r, y_r, np.ones(len(y_r)))
    return roots


def _rows_from_shapes(rows):
    """Table rows whose times are those at the first shape."""
    rows = list(rows)
    for row in rows:
        first = row["at_shapes"][0]
        row.update({key: first[key] for key in (
            "ms", "wall_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
        row["max_abs_err"] = max(a["max_abs_err"] for a in row["at_shapes"])
    return rows


def skewed_node():
    """A node of HIST_SKEWED points whose codes all name one bin: hist_f64's
    worst case, one chain as long as the node."""
    import numpy as np
    rng = np.random.default_rng(3)
    codes = np.full((HIST_SKEWED, 2), 7, np.uint8)
    w = rng.uniform(0.1, 2, HIST_SKEWED)
    y = rng.normal(size=HIST_SKEWED)
    return codes, w, w * y, w * y * y


def check_hist_f64(shapes):
    """hist_f64 at each of ``shapes`` with all rows and with a node's rows
    (a stable random half), and at the skewed node: bitwise numpy's
    bincount over the rows, within 1e-12 of its plain version (the four
    passes in PyTorch) on the card, the same over two runs; CUDA-event
    times beside the plain version's, the library call's (torch.bincount
    per feature and channel over the rows' codes) and the bytes bound; the
    host ms of one call through the resident path the trees take and of
    numpy's per-node call, and with all rows the op surface's call on the
    card and on numpy.  Returns the table rows of hist_f64 (times at the
    first shape) and hist_f64_node (times at the coreset root's rows)."""
    import numpy as np
    import torch
    from repro_torch import ops
    from repro_torch.kernels.histsplit import kernel as hk
    from repro_torch.kernels.histsplit.ops import ResidentHist, pack_values
    from repro_torch.kernels.histsplit.ref import hist_rows_ref
    B = HIST_BINS
    cases = {}
    for label, inputs in shapes.items():
        P = inputs[0].shape[0]
        rng = np.random.default_rng(HIST_ROWS_SEED)
        cases[label] = (inputs, None)
        cases[f"{label}/rows"] = (inputs, np.sort(rng.choice(P, P // 2,
                                                             replace=False)))
    cases["skewed_2^20"] = (skewed_node(), None)
    at_shapes = []
    for label, ((codes, w, wy, wy2), idx) in cases.items():
        P, F = codes.shape
        n = P if idx is None else len(idx)
        sel = slice(None) if idx is None else idx
        reps = 3 if n > 1 << 20 else (5 if n == 1 << 20 else 20)
        oracle = ops.hist_split(codes[sel], w[sel], wy[sel], wy2[sel], B,
                                backend="numpy")
        c = torch.as_tensor(codes, device="cuda")
        vals = pack_values(*(torch.as_tensor(a, device="cuda")
                             for a in (w, wy, wy2)))
        r = None if idx is None else torch.as_tensor(idx, dtype=torch.int32,
                                                     device="cuda")
        rl = None if r is None else r.long()
        scratch = torch.empty(hk.f64_scratch_bytes(n, F, B), dtype=torch.uint8,
                              device="cuda")

        def kern(c=c, vals=vals, r=r, scratch=scratch):
            return hk.hist_rows_cuda(c, vals, r, B, scratch)

        def plain(c=c, vals=vals, rl=rl):
            return hist_rows_ref(c, vals, rl, B)

        def library(c=c, vals=vals, rl=rl, F=F):
            sub = c if rl is None else c[rl]
            v = vals if rl is None else vals[rl]
            return [torch.bincount(sub[:, f], weights=v[:, s], minlength=B)
                    for f in range(F) for s in range(3)]
        got, want = kern(), plain()
        torch.cuda.synchronize()
        got_host = got.cpu().numpy()
        check(np.array_equal(got_host, oracle),
              f"hist f64 at {label} differs from numpy")
        check(torch.equal(kern(), got), f"hist f64 at {label} differs from "
              "run to run")
        at = {"shape": label, "P": P, "n": n,
              "max_abs_err": float((got - want).abs().max()),
              "scaled_err": scaled_err(got_host, want.cpu()),
              "plain_bitwise": bool(torch.equal(got, want))}
        check(at["scaled_err"] <= 1e-12,
              f"hist f64 at {label} vs plain: {at['scaled_err']}")
        res = ResidentHist(codes, w, wy, wy2, B, device="cuda")
        rows = np.arange(P) if idx is None else idx
        check(np.array_equal(res(rows), oracle),
              f"resident hist f64 at {label} differs from numpy")
        at["resident_call_ms"] = host_ms(lambda res=res, rows=rows: res(rows),
                                         reps)
        node_np = ops.bind("hist_split", codes, w, wy, wy2, B, backend="numpy")
        at["numpy_node_call_ms"] = host_ms(
            lambda node_np=node_np, rows=rows: node_np(rows), reps)
        if idx is None:
            # the op surface: pack, one upload, the launch, the copy back
            for backend in ("cuda", "numpy"):
                at[f"{backend}_op_call_ms"] = host_ms(
                    lambda backend=backend: ops.hist_split(
                        codes, w, wy, wy2, B, backend=backend), reps)
        del res
        at["ms"], at["wall_ms"] = device_ms(kern, reps)
        at["plain_ms"] = device_ms(plain, reps)[0]
        at["library_ms"] = device_ms(library, reps)[0]
        out_bytes = F * B * 24
        in_bytes = P * F + P * 24 if idx is None else (4 + F + 24) * n
        at.update(bound(in_bytes + out_bytes, 3 * n * F, FP64_FLOP_PER_S))
        at_shapes.append(at)
        del c, vals, r, rl, scratch, got, want
        torch.cuda.empty_cache()
    keys = ("ms", "wall_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    err = max(a["max_abs_err"] for a in at_shapes)
    first = at_shapes[0]
    node = next(a for a in at_shapes if a["shape"] == "coreset_root/rows")
    return [{"name": "hist_f64", "kernel": hk.HIST_F64, "at_shapes": at_shapes,
             "max_abs_err": err, **{k: first[k] for k in keys}},
            {"name": "hist_f64_node", "kernel": hk.HIST_F64_NODE,
             "max_abs_err": err, "timed_at": node["shape"],
             "round_trip_host_ms": node["resident_call_ms"],
             **{k: node[k] for k in keys}}]


def _ptxas_of(entries: dict, *marks: str) -> dict | None:
    """The ptxas line (registers, spills) of the one entry whose mangled name
    holds every one of ``marks``; None where this run did not build it."""
    found = [e for name, e in entries.items() if all(m in name for m in marks)]
    return found[0] if len(found) == 1 else None


def check_histsplit(shapes, entries):
    """Each float32 histsplit kernel at each of ``shapes`` and at a skewed
    node of HIST_SKEWED points in one bin, against its plain version on the
    card, each kernel also against itself over two runs, with CUDA-event
    times beside the plain version's, the library call's (torch.bincount per
    feature and channel) and the bound.  At the roots of fewer than 2^17
    points fused and partials are also held bitwise to ``partials_ref`` run
    on the CPU (a chain in point order a tile; fused adds the tiles in tile
    order; legacy is fused's sort on the (tile, feature) grid, so it is
    also held bitwise to fused at every shape).  Each kernel carries its
    launch (``kernel.launch_shape``, the source's own query) and
    ``entries``' ptxas line of the entry it launches.
    Returns one table row per kernel; its times are those at the first
    shape, every shape's are under ``at_shapes``."""
    import numpy as np
    import torch
    from repro_torch.kernels.histsplit import kernel as hk
    from repro_torch import ops
    from repro_torch.kernels.histsplit.ops import pack_values
    from repro_torch.kernels.histsplit.ref import histograms_ref, partials_ref
    kernels = {"fused": ("hist_fused_f32", hk.HIST_FUSED),
               "partials": ("hist_partials_f32", hk.HIST_PARTIALS),
               "legacy": ("hist_legacy_f32", hk.HIST_LEGACY)}
    ptxas = {"fused": _ptxas_of(entries, "hist_sort_kernel", "ILi3E"),
             "partials": _ptxas_of(entries, "hist_sort_kernel", "ILi6E"),
             "legacy": _ptxas_of(entries, "hist_sort_kernel", "ILi3E")}
    rows = {v: {"name": name, "kernel": kern, "at_shapes": [], "ptxas": ptxas[v]}
            for v, (name, kern) in kernels.items()}
    B = HIST_BINS
    for label, (codes, w, wy, wy2) in {**shapes, "skewed_2^20": skewed_node()}.items():
        P, F = codes.shape
        C = -(-P // HIST_TILE)
        reps = 3 if P > 1 << 20 else (5 if P == 1 << 20 else 20)
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
            at["scaled_err"] = scaled_err(got.cpu(), want.cpu())
            check(at["scaled_err"] <= HIST_F32_TOL,
                  f"hist {variant} at {label} vs plain: {at['scaled_err']}")
            if variant == "partials":
                p = got.cpu().numpy().astype(np.float64)
                at["certificate"] = scaled_err(
                    p[..., :3].sum(axis=0) + p[..., 3:].sum(axis=0), oracle)
                check(at["certificate"] <= HIST_PARTIALS_TOL,
                      f"hist partials at {label} vs numpy: {at['certificate']}")
            check(torch.equal(kern(), got),
                  f"hist {variant} at {label} differs from run to run")
            if P < 1 << 17:
                parts = partials_ref(c.cpu(), vals.cpu(), B, HIST_TILE)
                if variant != "partials":
                    in_order = parts[0].clone()
                    for t in range(1, C):
                        in_order += parts[t]
                    parts = in_order
                at["cpu_order_bitwise"] = bool(torch.equal(got.cpu(), parts))
                check(at["cpu_order_bitwise"], f"hist {variant} at {label} "
                      "differs from the CPU's in-order sums")
            if variant == "fused":
                fused = got
            elif variant == "legacy":
                at["fused_bitwise"] = bool(torch.equal(got, fused))
                check(at["fused_bitwise"], f"hist legacy at {label} differs from fused")
            at["launch"] = hk.launch_shape(variant, P, F, B, HIST_TILE)
            at["ms"], at["wall_ms"] = device_ms(kern, reps)
            at["plain_ms"] = device_ms(plain, reps)[0]
            at["library_ms"] = device_ms(library, reps)[0]
            out_bytes = (C if variant == "partials" else 1) * F * B * S * size
            at.update(bound(P * F + P * S * size + out_bytes, S * P * F,
                            FP32_FLOP_PER_S))
            if variant == "legacy":   # its grid stages the values once a feature
                at["grid_bytes"] = P * F + F * P * S * size + out_bytes
            row["at_shapes"].append(at)
        del c, cols, tile, dev, fused
        torch.cuda.empty_cache()
    return _rows_from_shapes(rows.values())


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
    check(launches["hist_f64_node"] == calls,
          f"{launches['hist_f64_node']} float64 node launches for {calls} "
          "hist_split/cuda dispatches")
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
    """Every histsplit variant through ops.hist_split on the card: the
    script's own calls, off the main path (the trees bind their data and
    launch hist_f64_node), counted apart and held to the numpy oracle, the
    float64 one bitwise.  Returns their launches."""
    from repro_torch import ops
    oracle = ops.hist_split(*inputs, HIST_BINS, backend="numpy")
    own, errs = {}, {}
    for variant, name, tol in (("f64", "hist_f64", 0.0),
                               ("fused", "hist_fused_f32", HIST_F32_TOL),
                               ("legacy", "hist_legacy_f32", HIST_F32_TOL),
                               ("partials", "hist_partials_f32", HIST_PARTIALS_TOL)):
        kernels[name].launches = 0
        got = ops.hist_split(*inputs, HIST_BINS, backend="cuda", variant=variant)
        own[name] = kernels[name].launches
        errs[name] = scaled_err(got, oracle)
        check(errs[name] <= tol, f"ops.hist_split {variant} vs numpy: {errs[name]}")
    emit("variants", P=len(inputs[1]), launches=own, scaled_err_vs_numpy=errs)
    return own

def _scaled_max_err(got, want, planes_dims):
    """max |got - want| and the largest of it over its plane's largest
    |want| (floor 1), both as floats; the planes are the leading dims."""
    d = (got.double() - want.double()).abs()
    scale = want.double().abs().amax(dim=planes_dims, keepdim=True).clamp(min=1.0)
    return float(d.max()), float((d / scale).max())


def check_delta(cases):
    """The delta kernels at the write path's tail shapes ``cases`` ({label:
    (carry, tail)}): float64 bitwise equal to the numpy oracle and to the
    plain version run on the CPU, float32 within SAT_F32_TOL of the plain
    version on the card, with CUDA-event times beside the plain version's,
    the library call's (cumsum∘cumsum of the pre-stacked tail, plus the
    carry) and the bound.  One table row per kernel, timed at the first
    shape, every shape's numbers under ``at_shapes``."""
    import numpy as np
    import torch
    from repro_torch import ops
    from repro_torch.kernels.sat2d import kernel as sk
    from repro_torch.kernels.sat2d.ref import delta_sat_ref
    rows = {torch.float64: {"name": "sat_delta_f64", "kernel": sk.SAT_DELTA_F64,
                            "at_shapes": []},
            torch.float32: {"name": "sat_delta_f32", "kernel": sk.SAT_DELTA_F32,
                            "at_shapes": []}}
    for label, (carry, tail) in cases.items():
        want = ops.delta_sat(carry, tail, backend="numpy")
        b, m = tail.shape
        for dtype, row in rows.items():
            c = torch.as_tensor(carry, dtype=dtype, device="cuda")
            t = torch.as_tensor(tail, dtype=dtype, device="cuda")
            got = sk.delta_sat_cuda(c, t)
            plain = delta_sat_ref(c, t)
            torch.cuda.synchronize()
            at = {"shape": label, "b": b, "m": m, "launch": sk.launch_shape("delta", b, m)}
            err, scaled = _scaled_max_err(got, plain, (1, 2))
            at["max_abs_err_vs_card_plain"] = err
            if dtype == torch.float64:
                host = got.cpu()
                check(np.array_equal(host.numpy(), want),
                      f"sat_delta_f64 at {label} differs from numpy")
                cpu_plain = delta_sat_ref(c.cpu(), t.cpu())
                check(torch.equal(host, cpu_plain),
                      f"sat_delta_f64 at {label} differs from its plain version")
                at["max_abs_err"] = float((host - cpu_plain).abs().max())
                del host, cpu_plain
            else:
                check(scaled <= SAT_F32_TOL,
                      f"sat_delta_f32 at {label} vs plain: {scaled} scaled")
                at["max_abs_err"], at["scaled_err"] = err, scaled
            del got, plain
            stk = torch.stack([torch.ones_like(t), t, t * t])
            at["ms"], at["wall_ms"] = device_ms(lambda: sk.delta_sat_cuda(c, t), 10)
            at["plain_ms"] = device_ms(lambda: delta_sat_ref(c, t), 10)[0]
            at["library_ms"] = device_ms(
                lambda: c[:, None, :] + torch.cumsum(torch.cumsum(stk, dim=2), dim=1),
                10)[0]
            del stk
            size = torch.finfo(dtype).bits // 8
            peak = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
            # read the tail and the carry, write 3 rows per tail row; y*y,
            # then 3 row and 3 column adds per cell
            at.update(bound((4 * b * m + 3 * m) * size, 7 * b * m, peak))
            row["at_shapes"].append(at)
    return _rows_from_shapes(rows.values())


def check_stack(stk_host):
    """The stack kernels on one merge-reduce level's padded moment rasters
    (L, 3, n, m): float64 bitwise equal to numpy in build_moments' order
    (columns first) and to the plain version run on the CPU, float32 (rows
    first) within SAT_F32_TOL of the plain version on the card, with times,
    the library call's (cumsum∘cumsum) and the bound."""
    import numpy as np
    import torch
    from repro_torch.kernels.sat2d import kernel as sk
    from repro_torch.kernels.sat2d.ref import STACK_ORDER, sat_stack_ref
    L, _, n, m = stk_host.shape
    flat = stk_host.reshape(L * 3, n, m)
    want = np.cumsum(np.cumsum(flat, axis=1), axis=2)
    rows = []
    for dtype, name, kern in ((torch.float64, "sat_stack_f64", sk.SAT_STACK_F64),
                              (torch.float32, "sat_stack_f32", sk.SAT_STACK_F32)):
        order = STACK_ORDER[dtype]
        x = torch.as_tensor(flat, dtype=dtype, device="cuda")
        got = sk.sat_stack_cuda(x)
        plain = sat_stack_ref(x, order)
        torch.cuda.synchronize()
        err, scaled = _scaled_max_err(got, plain, (1, 2))
        row = {"name": name, "kernel": kern, "order": order,
               "shape": [L * 3, n, m], "max_abs_err_vs_card_plain": err,
               "launch": sk.launch_shape("stack", n, m, planes=L * 3)}
        if dtype == torch.float64:
            host = got.cpu()
            check(np.array_equal(host.numpy(), want),
                  "sat_stack_f64 differs from numpy's build_moments order")
            cpu_plain = sat_stack_ref(x.cpu(), order)
            check(torch.equal(host, cpu_plain),
                  "sat_stack_f64 differs from its plain version")
            row["max_abs_err"] = float((host - cpu_plain).abs().max())
            del host, cpu_plain
        else:
            check(scaled <= SAT_F32_TOL, f"sat_stack_f32 vs plain: {scaled} scaled")
            row["max_abs_err"], row["scaled_err"] = err, scaled
        del got, plain
        row["ms"], row["wall_ms"] = device_ms(lambda: sk.sat_stack_cuda(x), 10)
        row["plain_ms"] = device_ms(lambda: sat_stack_ref(x, order), 10)[0]
        row["library_ms"] = device_ms(
            lambda: torch.cumsum(torch.cumsum(x, dim=-2), dim=-1), 10)[0]
        size = torch.finfo(dtype).bits // 8
        peak = FP64_FLOP_PER_S if dtype == torch.float64 else FP32_FLOP_PER_S
        row.update(bound(2 * x.numel() * size, 2 * x.numel(), peak))
        rows.append(row)
        del x
    return rows


def write_path_signals(y):
    """The write path's signals: the slice-1 signal after each of the three
    patches, and the (first row, tail) of each patch."""
    import numpy as np
    from repro_torch.data import piecewise_signal
    n, m = y.shape
    first, rows = PATCH_ROWS

    def fresh(r, seed):
        return piecewise_signal(r, m, 64, noise=0.15, seed=seed)
    y1 = y.copy()
    y1[first:first + rows] = fresh(rows, 1)
    y2 = np.vstack([y1, fresh(STREAM_ROWS, 2)])
    y3 = y2.copy()
    y3[n:] = fresh(STREAM_ROWS, 3)
    return [(y1, first), (y2, n), (y3, n)]


def phase_write_path(ps, patches, kernels):
    """The three chained patches on the auto backend (the card), each on a
    copy, with every kernel's count at 0 just before them; the last held
    bitwise to the builds of the final signal on cuda and numpy.  Host ms
    per patch and of the final signal's builds, and the patches' launches."""
    import numpy as np
    import torch
    from repro_torch import ops
    from repro_torch.core import PrefixStats
    patch_ms = []
    cur = ps
    for kern in kernels.values():
        kern.launches = 0
    ops.reset_dispatch_counts()
    for yk, r0 in patches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt = cur.patch_rows(r0, yk[r0:], copy=True)
        patch_ms.append((time.perf_counter() - t0) * 1e3)
        check(nxt is not cur and nxt.shape == yk.shape,
              f"patch at row {r0} gave shape {nxt.shape}")
        cur = nxt
    launches = {name: kern.launches for name, kern in kernels.items()}
    dispatches = {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()}
    final = patches[-1][0]
    builds = {}
    for backend in ("cuda", "numpy"):
        t0 = time.perf_counter()
        with ops.backend_override(backend):
            want = PrefixStats.build(final)
        builds[backend] = (time.perf_counter() - t0) * 1e3
        check(all(np.array_equal(a, b) for a, b in zip(
            (cur.p0, cur.p1, cur.p2), (want.p0, want.p1, want.p2))),
              f"chained patches differ from the {backend} build of the final signal")
        del want
    check(ps.shape == patches[0][0].shape, "the patched copies moved the original")
    return {"patches": [{"r0": r0, "tail_rows": yk.shape[0] - r0,
                         "rows_after": yk.shape[0], "host_ms": ms}
                        for (yk, r0), ms in zip(patches, patch_ms)],
            "build_host_ms": builds, "dispatches": dispatches}, launches


def stream_frames():
    from repro_torch.data import piecewise_signal
    bands = [piecewise_signal(STREAM_ROWS, STREAM_M, 8, noise=0.15, seed=s)
             for s in range(STREAM_BANDS)]
    new = {i: piecewise_signal(STREAM_ROWS, STREAM_M, 8, noise=0.15, seed=100 + i)
           for i in STREAM_REPLACE}
    return bands, new


def run_stream(bands, new, backend):
    """One run of the stream on ``backend`` ("auto" is the card): inserts,
    replacements, the flush and result(), then sharded_coreset of the final
    signal; seconds of each and the dispatches' host seconds."""
    import contextlib
    import numpy as np
    from repro_torch import ops
    from repro_torch.core import StreamingBuilder, sharded_coreset
    ctx = (contextlib.nullcontext() if backend == "auto"
           else ops.backend_override(backend))
    ops.reset_dispatch_counts()
    with ctx:
        t_run = time.perf_counter()
        sb = StreamingBuilder(m=STREAM_M, k=STREAM_K, eps=STREAM_EPS)
        insert_s = []
        for b in bands:
            t0 = time.perf_counter()
            sb.insert_band(b)
            insert_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        for i, b in new.items():
            sb.replace_band(i, b)
        replace_s = time.perf_counter() - t0
        dirty = sb.dirty_buckets
        t0 = time.perf_counter()
        flushed = sb.flush_dirty()
        flush_s = time.perf_counter() - t0
        cs = sb.result()
        run_s = time.perf_counter() - t_run
        final = np.vstack([new.get(i, b) for i, b in enumerate(bands)])
        t0 = time.perf_counter()
        sh = sharded_coreset(final, STREAM_K, STREAM_EPS, STREAM_BANDS,
                             recompress_result=True)
        sharded_s = time.perf_counter() - t0
    return {"cs": cs, "sharded": sh, "signal_shape": final.shape,
            "insert_s": insert_s, "replace_s": replace_s, "flush_s": flush_s,
            "run_s": run_s, "sharded_s": sharded_s, "dirty_buckets": dirty,
            "flushed": flushed, "recompressed": sb.buckets_recompressed_total,
            "max_level": sb.max_level,
            "dispatches": {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()},
            "dispatch_s": {f"{o}/{b}": t for (o, b), t in ops.dispatch_seconds().items()}}


def level_one_stack(bands, new):
    """The padded moment rasters the stream's first flush level integrates:
    the four two-frame buckets of the final frames, built on numpy."""
    import numpy as np
    from repro_torch import ops
    from repro_torch.core import sharded_coreset
    from repro_torch.core.streaming import _recompress_prep
    from repro_torch.ops.backends import _stack_rasters
    final = [new.get(i, b) for i, b in enumerate(bands)]
    with ops.backend_override("numpy"):
        # a two-band sharded_coreset without the shared tolerance is the
        # composition of the two frames' leaf coresets, as a merge makes it
        buckets = [sharded_coreset(np.vstack(final[i:i + 2]), STREAM_K,
                                   STREAM_EPS, 2, share_tolerance=False)
                   for i in range(0, len(final), 2)]
    return buckets, _stack_rasters([_recompress_prep(b) for b in buckets])


def phase_stream(bands, new, kernels):
    """The stream on numpy, then on the auto backend (the card) with every
    kernel's count at 0 just before it; equal fingerprints.  Returns the
    auto run's launches."""
    import numpy as np
    from repro_torch import ops
    runs = {"numpy": run_stream(bands, new, "numpy")}
    for kern in kernels.values():
        kern.launches = 0
    runs["auto"] = run_stream(bands, new, "auto")
    launches = {name: kern.launches for name, kern in kernels.items()}
    got, want = runs["auto"], runs["numpy"]
    check(set(got["dispatches"]) == {"sat_moments/cuda", "streaming_compress/cuda"},
          f"the stream on auto dispatched {got['dispatches']}")
    check(got["cs"].fingerprint() == want["cs"].fingerprint(),
          "the stream's coreset on cuda differs from numpy's")
    check(got["sharded"].fingerprint() == want["sharded"].fingerprint(),
          "sharded_coreset on cuda differs from numpy's")
    check(got["recompressed"] == want["recompressed"] and got["flushed"] > 0,
          f"recompressions {got['recompressed']} against numpy's {want['recompressed']}")
    n, m = got["signal_shape"]
    for cs in (got["cs"], got["sharded"]):
        check(np.isfinite(cs.moments).all() and np.isclose(cs.total_mass(), n * m),
              "stream coreset not finite or loses mass")
    calls = got["dispatches"]["streaming_compress/cuda"]
    check(launches["sat_stack_f64"] == calls,
          f"{launches['sat_stack_f64']} stack launches for {calls} dispatches")

    def summary(r):
        return {"insert_s": r["insert_s"],
                "insert_mean_s": float(np.mean(r["insert_s"])),
                "replace_s": r["replace_s"], "flush_s": r["flush_s"],
                "run_s": r["run_s"], "sharded_s": r["sharded_s"],
                "dispatches": r["dispatches"], "dispatch_s": r["dispatch_s"]}
    emit("stream", frames=STREAM_BANDS, rows=STREAM_ROWS, m=STREAM_M,
         k=STREAM_K, eps=STREAM_EPS, replaced=list(STREAM_REPLACE),
         dirty_buckets=got["dirty_buckets"], flushed=got["flushed"],
         recompressed=got["recompressed"], max_level=got["max_level"],
         blocks=got["cs"].num_blocks, fingerprint=got["cs"].fingerprint(),
         sharded_blocks=got["sharded"].num_blocks,
         sharded_fingerprint=got["sharded"].fingerprint(),
         cuda=summary(got), numpy=summary(want),
         cells_per_level=ops.streaming_compress_size([got["cs"]]),
         launches=launches)
    return launches


def visible_pairs(Lq: int, Lk: int, causal: bool) -> int:
    """(query, key) pairs attention visits: query i sees keys <= i + Lk - Lq
    with causal (decode-style alignment), all Lk without."""
    if not causal:
        return Lq * Lk
    off = Lk - Lq
    return sum(min(Lk, max(i + off + 1, 0)) for i in range(Lq))


def check_flash_attention():
    """Both flash-attention kernels at FA_SHAPES against their plain version
    on the card, with CUDA-event times beside the plain version's, one
    scaled_dot_product_attention call's (causal, GQA; timed only, the port
    never calls it) and the bound.  One table row per kernel, timed at its
    first shape, every shape's numbers under ``at_shapes``."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    rows = {"bfloat16": {"name": "flash_attention_bf16",
                         "kernel": fa.FLASH_ATTENTION_BF16, "at_shapes": []},
            "float32": {"name": "flash_attention_f32",
                        "kernel": fa.FLASH_ATTENTION_F32, "at_shapes": []}}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (B, Hq, Hkv, Lq, Lk, D, dt) in FA_SHAPES.items():
        dtype = getattr(torch, dt)
        q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dtype)
                   for s in ((B, Hq, Lq, D), (B, Hkv, Lk, D), (B, Hkv, Lk, D)))
        got = fa.flash_attention_cuda(q, k, v)
        plain = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        d = (got.float() - plain.float())
        err = float(d.abs().max())
        fro = float(d.norm() / plain.float().norm())
        check(bool(torch.isfinite(got.float()).all()) and got.shape == q.shape,
              f"flash attention at {label} not finite or misshapen")
        check(err <= FA_TOL[dt] and fro <= FA_TOL[dt],
              f"flash attention at {label} vs plain: max abs {err}, rel fro {fro}")
        check(torch.equal(fa.flash_attention_cuda(q, k, v), got),
              f"flash attention at {label} differs from run to run")
        del d, got, plain
        reps = 3 if Lq > 8192 else 10
        at = {"shape": label, "B": B, "Hq": Hq, "Hkv": Hkv, "Lq": Lq, "Lk": Lk,
              "D": D, "dtype": dt, "max_abs_err": err, "rel_fro_err": fro}
        at["ms"], at["wall_ms"] = device_ms(lambda: fa.flash_attention_cuda(q, k, v), reps)
        at["plain_ms"] = device_ms(lambda: flash_attention_plain(q, k, v), 2)[0]
        at["library_ms"] = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps)[0]
        size = q.element_size()
        flops = 4 * B * Hq * D * visible_pairs(Lq, Lk, True)
        peak = BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_3XTF32_FLOP_PER_S
        at.update(bound((2 * q.numel() + k.numel() + v.numel()) * size, flops, peak))
        at["flops"] = flops
        rows[dt]["at_shapes"].append(at)
        del q, k, v
        torch.cuda.empty_cache()
    return _rows_from_shapes(rows.values())


def device_busy(fn) -> tuple[float, list]:
    """One call of ``fn`` under torch.profiler: the device's busy ms (the
    sum of its kernels' own times, the profiler's "Self CUDA time total")
    and the six kernels with the most time, [name, ms] each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    check(busy > 0, "the profiler saw no device time")
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return busy, [[e.key[:100], e.self_device_time_total / 1e3] for e in top]


def _rel_fro(got, want) -> float:
    """||got - want|| / ||want|| over the leading axis one slice at a time
    (the logits are ~2.5 GB in bf16)."""
    num = den = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        num += float((a - b).double().pow(2).sum())
        den += float(b.double().pow(2).sum())
    return (num / den) ** 0.5


def phase_lm_serve(kernels, fa_rows):
    """qwen2-0.5b at full width on the card: the prefill through the kernel
    with every kernel's count at 0 just before it, against attn_impl="torch"
    (both against the same weights in float32); the float32 model's prefill
    against teacher-forced decode; greedy generate; the device's busy time
    in a prefill and a decode step.  Returns the launches of the bf16
    prefill and of the float32 cross-check's."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)
    # float32 products in full float32 (the f32 cross-check's premise)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = get_arch(LM_ARCH)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    B, L = LM_PREFILL
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, L)), device="cuda")

    def run(impl=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = prefill(cfg, params, {"tokens": toks}, attn_impl=impl)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for kern in kernels.values():
        kern.launches = 0
    logits, cold_s = run()
    launches = {name: kern.launches for name, kern in kernels.items()}
    check(launches["flash_attention_bf16"] == cfg.n_layers
          and sum(launches.values()) == cfg.n_layers,
          f"prefill launched {launches}, not the bf16 kernel once a layer")
    check(logits.shape == (B, L, cfg.vocab) and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), "prefill logits not finite or misshapen")
    warm = [run()[1] for _ in range(3)]
    plain_logits, plain_s = run("torch")
    fro = _rel_fro(logits, plain_logits)
    check(fro <= LM_LOGITS_TOL, f"kernel-path logits vs attn_impl='torch': {fro}")
    plain_warm = run("torch")[1]
    # both bf16 paths against the same weights run in float32 (through the
    # f32 kernel): which of the two is nearer the function they round
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = cast_params(params, torch.float32)
    exact, _ = prefill(cfg32, p32, {"tokens": toks})
    fro32 = {"kernel": _rel_fro(logits, exact), "plain": _rel_fro(plain_logits, exact)}
    check(fro32["kernel"] <= LM_F32_MARGIN * fro32["plain"],
          f"kernel-path logits farther from the float32 model than the plain path's: {fro32}")
    del logits, plain_logits, exact
    torch.cuda.empty_cache()
    prefill_s = float(np.median(warm))
    kern_ms = fa_rows["flash_attention_bf16"]["at_shapes"][0]["ms"]
    # the device's busy time in one prefill, beside the host's
    prefill_busy_ms, prefill_top = device_busy(
        lambda: prefill(cfg, params, {"tokens": toks}))

    # float32: the same weights, prefill through the f32 kernel against
    # teacher-forced decode at every position
    B2, L2 = LM_XCHECK
    t32 = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B2, L2)), device="cuda")
    kernels["flash_attention_f32"].launches = 0
    full, _ = prefill(cfg32, p32, {"tokens": t32})
    f32_launches = kernels["flash_attention_f32"].launches
    check(f32_launches == cfg.n_layers,
          f"float32 prefill launched the f32 kernel {f32_launches} times")
    cache = init_cache(cfg32, B2, L2, device="cuda")
    steps = torch.stack([decode_step(cfg32, p32, cache, {"tokens": t32[:, t:t + 1]})[0][:, 0]
                         for t in range(L2)], dim=1)
    diff = (steps - full).abs()
    dec_abs = float(diff.max())
    dec_excess = float((diff - LM_DECODE_TOL * full.abs()).max())
    check(dec_excess <= LM_DECODE_TOL,
          f"float32 prefill vs decode: max abs {dec_abs}, beyond 2e-3 + 2e-3|x|")
    del p32, full, steps, diff, cache
    torch.cuda.empty_cache()

    # greedy generation on the bf16 model: the prompt's decode steps, then
    # the new tokens'; the decode path launches no kernel
    Bg, Lp, new = LM_GEN
    prompts = rng.integers(0, cfg.vocab, size=(Bg, Lp)).astype(np.int32)
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, new, greedy=True)
    gen_s = time.perf_counter() - t0
    check(out.shape == (Bg, Lp + new) and np.array_equal(out[:, :Lp], prompts)
          and ((out >= 0) & (out < cfg.vocab)).all(), "generate's tokens misshapen")
    check(sum(k.launches for k in kernels.values()) == 0,
          "generate launched a kernel (decode attention is plain)")
    # one decode step's device busy time, at the first new token's position
    cache = init_cache(cfg, Bg, Lp + new, device="cuda")
    step_tok = torch.as_tensor(out[:, Lp:Lp + 1], device="cuda")

    def step():
        decode_step(cfg, params, dict(cache, pos=Lp), {"tokens": step_tok})
    step()
    step_busy_ms, step_top = device_busy(step)
    del cache
    emit("lm_serve", arch=cfg.name, params=cfg.param_count(),
         weights_bytes=sum(t.numel() * t.element_size() for t in _leaves(params)),
         prefill={"batch": B, "tokens": L, "host_s": prefill_s, "cold_host_s": cold_s,
                  "host_s_runs": warm, "tokens_per_s": B * L / prefill_s,
                  "plain_attention_host_s": plain_warm,
                  "plain_attention_cold_host_s": plain_s,
                  "device_busy_ms": prefill_busy_ms,
                  "device_idle_share": 1 - prefill_busy_ms / 1e3 / prefill_s,
                  "device_top_kernels_ms": prefill_top,
                  "attention_device_ms": cfg.n_layers * kern_ms,
                  "attention_share_of_busy": cfg.n_layers * kern_ms / prefill_busy_ms,
                  "logits_rel_fro_vs_plain": fro,
                  "logits_rel_fro_vs_float32_model": fro32, "launches": launches},
         float32_check={"batch": B2, "tokens": L2, "max_abs_err": dec_abs,
                        "max_excess_over_bar": dec_excess,
                        "f32_launches": f32_launches},
         generate={"batch": Bg, "prompt": Lp, "new_tokens": new, "host_s": gen_s,
                   "decode_steps": Lp + new,
                   "ms_per_step": gen_s * 1e3 / (Lp + new),
                   "step_device_busy_ms": step_busy_ms,
                   "step_device_idle_share": 1 - step_busy_ms / (gen_s * 1e3 / (Lp + new)),
                   "step_top_kernels_ms": step_top,
                   "new_tokens_per_s": Bg * new / gen_s,
                   "first_new": out[:, Lp].tolist()},
         peak_memory_gb=torch.cuda.max_memory_allocated() / 2**30,
         seconds=time.perf_counter() - t_phase)
    del params
    torch.cuda.empty_cache()
    return {"flash_attention_bf16": launches["flash_attention_bf16"],
            "flash_attention_f32": f32_launches}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


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
    from repro_torch.kernels.sat2d import kernel as sat_kernel
    from repro_torch.trees import best_segmentation

    smi = phase_device()
    ptxas = phase_build()

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
    # the build's signal, then one of the stream's frames
    sat_shapes = {f"{n}x{m}": y,
                  f"band_{STREAM_ROWS}x{STREAM_M}": stream_frames()[0][0]}
    rows = [check_sat(sat_shapes, torch.float64, sat_kernel.SAT_MOMENTS_F64, 1e-12),
            check_sat(sat_shapes, torch.float32, sat_kernel.SAT_MOMENTS_F32, SAT_F32_TOL)]
    fl_rows, fl_oracle_err = check_fitting_loss(cs_np, *trees(batch))
    rows += fl_rows
    emit("kernels", checked=[r["name"] for r in rows],
         fitting_loss_vs_oracle_max_rel=fl_oracle_err,
         times_ms={r["name"]: {key: r[key] for key in (
             "ms", "wall_ms", "plain_ms", "library_ms", "bound_ms")} for r in rows},
         at_shapes={r["name"]: r["at_shapes"] for r in rows if "at_shapes" in r})

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
    roots = hist_roots(ys, train, y)
    t0 = time.perf_counter()
    hist_rows = check_hist_f64(roots) + check_histsplit(roots,
                                                        ptxas.get("histsplit", {}))
    emit("hist_kernels", checked=[r["name"] for r in hist_rows],
         at_shapes={r["name"]: r["at_shapes"] for r in hist_rows
                    if "at_shapes" in r},
         ptxas={r["name"]: r["ptxas"] for r in hist_rows if "ptxas" in r},
         node_kernel={k: v for k, v in hist_rows[1].items() if k != "kernel"},
         seconds=time.perf_counter() - t0)
    del roots["raster_2^24"]
    rows += hist_rows

    kernels = {r["name"]: r["kernel"] for r in rows}
    tuning_counts = phase_tuning(ys, train, test, kernels)
    counts.update({name: c for name, c in tuning_counts.items()
                   if name.startswith("hist_")})
    variant_counts = phase_variants(roots["coreset_root"], kernels)
    counts.update(variant_counts)
    own_counts.update(variant_counts)

    # -------------------------------------------- slice 3: the write path
    patches = write_path_signals(y)
    # the two tail shapes of the three patches (2048 and 256 rows)
    delta_cases = {f"tail_{yk.shape[0] - r0}": (ps.carry_row(r0), yk[r0:])
                   for yk, r0 in patches[:2]}
    bands, new = stream_frames()
    level1, stk = level_one_stack(bands, new)
    write_rows = check_delta(delta_cases) + check_stack(stk)
    emit("write_kernels", checked=[r["name"] for r in write_rows],
         at_shapes={r["name"]: r.get("at_shapes", [{"shape": r.get("shape"),
                                                    "launch": r.get("launch")}])
                    for r in write_rows},
         stack_order={r["name"]: r["order"] for r in write_rows if "order" in r})
    rows += write_rows
    kernels = {r["name"]: r["kernel"] for r in rows}
    write, write_launches = phase_write_path(ps, patches, kernels)
    check(write_launches["sat_delta_f64"] == len(patches),
          f"{write_launches['sat_delta_f64']} delta launches for {len(patches)} patches")
    check(write["dispatches"] == {"delta_sat/cuda": len(patches)},
          f"write path dispatched {write['dispatches']}")
    delta_ms = {a["shape"]: a["ms"] for a in write_rows[0]["at_shapes"]}
    for p in write["patches"]:
        p["device_ms"] = delta_ms[f"tail_{p['tail_rows']}"]
    emit("write_path", n=n, m=m, **write, launches=write_launches)
    del patches, delta_cases
    stream_launches = phase_stream(bands, new, kernels)
    path3 = {name: write_launches[name] + stream_launches[name] for name in kernels}
    for name in ("sat_delta_f64", "sat_stack_f64", "sat_moments_f64"):
        check(path3[name] > 0, f"kernel {name} was not launched on the write path")
    # the float32 variants (the TPU kernel's type) in calls of the script's
    # own, counted apart and held to the float64 results
    own3 = {}
    kern = kernels["sat_delta_f32"]
    kern.launches = 0
    carry, tail = ps.carry_row(n - STREAM_ROWS), y[n - STREAM_ROWS:]
    d32 = ops.delta_sat(carry, tail, dtype=np.float32)
    d64 = ops.delta_sat(carry, tail)
    own3["sat_delta_f32"] = kern.launches
    d32_err = float((np.abs(d32 - d64) / np.abs(d64).max(axis=(1, 2), keepdims=True)).max())
    check(d32_err <= SAT_F32_TOL, f"float32 delta_sat vs float64: {d32_err}")
    kern = kernels["sat_stack_f32"]
    kern.launches = 0
    rc32 = ops.streaming_compress(level1, dtype=np.float32)
    own3["sat_stack_f32"] = kern.launches
    for a, b in zip(rc32, level1):
        check(np.isclose(a.total_mass(), b.total_mass()),
              "float32 streaming_compress lost mass")
    del d32, d64, rc32
    emit("write_counts", launches=path3, outside_main_path=own3,
         float32_delta_scaled_err=d32_err)
    for name, c in own3.items():
        check(c == 1, f"{c} launches of {name} in one call")
    for name, c in path3.items():
        counts[name] = counts.get(name, 0) + c
    counts.update(own3)
    own_counts.update(own3)

    # ------------------------------------------------- slice 4: LM serving
    t0 = time.perf_counter()
    fa_rows = check_flash_attention()
    emit("lm_kernels", checked=[r["name"] for r in fa_rows],
         at_shapes={r["name"]: r["at_shapes"] for r in fa_rows},
         seconds=time.perf_counter() - t0)
    rows += fa_rows
    kernels = {r["name"]: r["kernel"] for r in rows}
    lm_counts = phase_lm_serve(kernels, {r["name"]: r for r in fa_rows})
    counts.update(lm_counts)

    replaces = {
        "sat_moments_f64": "src/repro/kernels/sat2d/kernel.py:78",
        "sat_moments_f32": "src/repro/kernels/sat2d/kernel.py:78",
        "fitting_loss": "src/repro/kernels/fitting_loss/kernel.py:100",
        "fitting_loss_batched": "src/repro/kernels/fitting_loss/kernel.py:163",
        "hist_f64": "src/repro/kernels/histsplit/kernel.py:151",
        "hist_f64_node": "src/repro/kernels/histsplit/kernel.py:151",
        "hist_fused_f32": "src/repro/kernels/histsplit/kernel.py:151",
        "hist_partials_f32": "src/repro/kernels/histsplit/kernel.py:137",
        "hist_legacy_f32": "src/repro/kernels/histsplit/kernel.py:124",
        "sat_delta_f64": "src/repro/kernels/sat2d/kernel.py:89",
        "sat_delta_f32": "src/repro/kernels/sat2d/kernel.py:89",
        "sat_stack_f64": "src/repro/kernels/sat2d/kernel.py:78",
        "sat_stack_f32": "src/repro/kernels/sat2d/kernel.py:78",
        "flash_attention_bf16": "src/repro/kernels/flash_attention/kernel.py:93",
        "flash_attention_f32": "src/repro/kernels/flash_attention/kernel.py:93",
    }
    sources = {"sat": "sat2d", "fit": "fitting_loss", "his": "histsplit",
               "fla": "flash_attention"}
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
                      **({"launched_by": "prefill of the float32 model (the "
                                         "cross-check against decode)"}
                         if r["name"] == "flash_attention_f32" else {}),
                      **({"timed_at": r["at_shapes"][0]["shape"]}
                         if "at_shapes" in r else {}),
                      **({key: r[key] for key in ("timed_at",
                                                  "round_trip_host_ms")}
                         if "round_trip_host_ms" in r else {}),
                      **({key: r[key] for key in ("launch", "overlap_share")}
                         if "overlap_share" in r else {})})
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
