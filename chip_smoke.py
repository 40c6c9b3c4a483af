"""Drive the repro_torch main path on one CUDA card and check it.

    python3 chip_smoke.py

at one size: slice 1 at a 4096 x 4096 signal, trees of 64 leaves, batches
of 256; slice 2 (the §5 tuning path) at the Air-Quality shape 9358 x 15 of
the paper's §5, the signal-tree config's coreset and forests; slice 3 (the
write path) with row patches of the slice-1 signal and a line-scan stream of
eight 256 x 1024 frames; slice 4 (LM serving) with qwen2-0.5b at full width
(24 layers, d_model 896, 14 query and 2 KV heads of 64, vocab 151,936) and
random weights from a seeded generator; the SSM families (models/ssm.py)
with falcon-mamba-7b (Mamba1, d_model 4096, d_inner 8192, state 16, vocab
65,024) and zamba2-1.2b (Mamba2, d_model 2048, 64 heads of 64, state 64,
one shared GQA block of 32 heads every 6 layers) at full width, cut in
depth to 8 of 64 and 12 of 38 layers; the MoE families (models/moe.py, MLA in models/attention.py)
with qwen3-moe-235b-a22b (128 experts, top 8, 64 query and 4 KV heads of
128) and deepseek-v2-236b (MLA, 160 routed and 2 shared experts, top 6) at
full width, cut in depth to 6 and 4 layers; the modality frontends
(models/model.py's embed_inputs and head) with musicgen-medium (12 of 48 layers,
d_model 1536, 24 query and 24 KV heads of 64, 4 codebooks of 2048) and
pixtral-12b (10 of 40 layers, d_model 5120, 32 query and 8 KV heads of 128, vocab
131,072, 256 patch embeddings) at full width; LM training (train/, checkpoint/,
runtime/, launch/train.py) with the same model at full width, 4 x 2048
tokens a step; the coreset server (service/,
client/) with slice 1's signal, its trees and batches over HTTP, a 20-tree
forest and the stream's frames; the distributed serving plane (cluster/)
with slice 1's signal over four worker processes on the one card; the mesh
half (core/sharded.py's sat_pjit and fitting_loss_batched(mesh=),
CoresetEngine(mesh=)) with slice 1's signal on one NCCL rank and on four
gloo ranks of the one card.

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
              bf16), zamba2-1.2b's shared block (4 x 32 query and 32 KV
              heads x 2048, bf16), qwen3-moe's layout (qwen3_moe_prefill:
              4 x 64 query and 4 KV heads of 128 x 2048, bf16), musicgen's
              (musicgen_prefill: 4 x 24 query and 24 KV heads of 64 x 2048)
              and pixtral's (pixtral_prefill: 4 x 32 query and 8 KV heads
              of 128 x 2048) and the float32 path's and a ragged
              float32 shape, with
              times beside the plain version's,
              scaled_dot_product_attention's and the bound
  lm_serve    prefill of 4 x 2048 prompt tokens through the kernel (24
              launches, one a layer), its logits against attn_impl="torch";
              the float32 model's prefill logits against teacher-forced
              decode at every position of a 4 x 64 prompt; greedy generate
              of 32 tokens after 4 x 64; host seconds, tokens/s, ms a step,
              and the device's busy time (torch.profiler) in a prefill and
              a decode step
  lm_serve_ssm  falcon-mamba-7b (8 of 64 layers), then zamba2-1.2b (12 of
              38), at full width (bf16,
              seeded random weights), every kernel's count at 0 before
              each part: a 4 x 2048 prefill (finite logits; falcon launches
              no kernel, zamba2's shared block the bf16 kernel once every
              6 layers;
              each of its outputs within 2e-2 of attn_impl="torch" on the
              same input, its logits no farther from the float32 model's
              than the plain path's, times 1.1); the float32
              model's prefill against teacher-forced decode at every
              position of 4 x 64 (2e-3); greedy generate of 32 tokens after
              4 x 64 (no kernel); the reduced float32 model on the card
              against the CPU from the same weights (logits 1e-4, greedy
              tokens equal).  Tokens/s, busy time and top kernels of a
              prefill, one layer's chunked scan alone (CUDA events) and its
              share, ms a decode step and its busy time, the parameters
              (the sum of the tensors' sizes), peak memory; ssm_launches in
              the kernel table
  lm_serve_moe  qwen3-moe-235b-a22b (6 of its 94 layers), then
              deepseek-v2-236b (4 of 60), at full width (bf16, seeded random
              weights), each freed before the next, every kernel's count at
              0 before each part: (a) a 4 x 2048 prefill (qwen3-moe through
              the bf16 kernel, 6 launches; deepseek on attn_impl="torch",
              none: MLA's mixed head sizes are no shape of the kernel),
              finite logits, a second prefill bitwise equal (no
              atomics-ordered combine), each layer's share of assignments
              dropped at capacity; (b) qwen3-moe only: each layer's
              attention, the kernel against attn_impl="torch" on the same
              input within 2e-2, and the logits' distance between the two
              paths (no bar: top-k routing is discontinuous); (c) the first
              layer with the embedding, head and final norm in float32 at
              capacity_factor n_experts / moe_top_k (nothing drops): prefill
              against teacher-forced decode at every position of 4 x 64
              (2e-3); (d) greedy generate of 32 tokens after 4 x 64 (no
              kernel); (e) the reduced float32 model on the card against the
              CPU (logits 1e-4, greedy tokens equal).  Parameters by the
              tensors' sizes beside param_count() and active_param_count() at
              the cut depth, tokens/s, busy time, idle share and top kernels
              of a prefill, the 2 x active parameters x tokens bound, one MoE
              layer alone and its parts (CUDA events), ms a decode step and
              its busy time, peak memory; moe_launches in the kernel table
  lm_serve_frontends  musicgen-medium (12 of 48 layers), then pixtral-12b
              (10 of 40), at full width (bf16,
              seeded random weights), each freed before the next, every
              kernel's count at 0 before each part: (a) a 4 x 2048 prefill
              (musicgen's (4, 2048, 4) codebook tokens, logits (4, 2048, 4,
              2048); pixtral's 256 seeded patch embeddings before 1,792
              text tokens, logits (4, 2048, 131072)), the bf16 kernel once a
              layer, finite logits, a second prefill bitwise equal;
              (b) each layer's attention, the kernel against
              attn_impl="torch" on the same input within 2e-2; (c) float32
              (musicgen whole, pixtral's first layer with its embedding,
              head and final norm) prefill against teacher-forced decode at
              every position of 4 x 64 codebook or text tokens (2e-3; the f32
              kernel 48 and 1 times); (d) greedy decoding of 32 tokens after
              4 x 64 (pixtral through generate, musicgen through a loop of
              decode steps with an argmax a codebook; no kernel); (e) the
              reduced float32 model on the card against the CPU (logits
              1e-4, greedy tokens equal).  Tokens/s, busy time, idle share
              and top kernels of a prefill, the 2 x non-embedding parameters
              x tokens bound, ms a decode step and its busy time, peak
              memory; frontend_launches in the kernel table
  lm_train    LM training on the card, every kernel's count at 0 before each
              part and none launched: (a) the reduced qwen2 in float32, 3
              make_train_step steps on the card and on the CPU from the same
              weights and TokenStream batches (losses within 1e-4 relative,
              weights within 1e-4), and on the card with remat (losses
              bitwise); (b) qwen2-0.5b as configured (bf16, remat) through
              train_loop, 6 steps at 4 x 2048: every loss and grad norm
              finite, the first beside ln V, the median step ms of steps
              2-6, tokens/s, peak memory, one more step's device busy
              time, kernel count and top operations (torch.profiler), the
              optimizer's device ms alone and one layer's plain attention
              forward and forward + backward (CUDA events); (c) a reduced config
              (state under ~100 MB) crashed at step 7 and resumed from the
              checkpoint of step 5, its weights within the reference test's
              rtol 1e-5 / atol 1e-6 of an uninterrupted run's (and whether
              bitwise), the checkpoint's bytes and save seconds; (d)
              python -m repro_torch.launch.train --reduced twice in one
              checkpoint directory, the second run resuming from step 3
              (train_launches in the kernel table)
  lm_train_families  zamba2-1.2b and musicgen-medium through the trainer,
              every kernel's count at 0 before each part: (a) full width at
              6 and 2 layers in float32, 3 steps of 1 x 128 on the card
              against the CPU from one set of weights (losses within 1e-4
              relative; each step's gradients compared, the first's worst
              leaf within 1e-4 of its norm; the params within 1e-4, but for
              zamba2 at full width at most 1e-5 of them past it and none
              further apart than AdamW can drift in 3 steps, each step's
              sign flips and the params where none flipped recorded, all
              its params held at the reduced width), remat on against off
              (losses bitwise); (b) full width
              and depth in bf16 with remat through train_loop, 3 steps at
              4 x 2048: losses and grad norms finite, the batches' shapes
              ((4, 2048, 4) for musicgen), step ms, tokens/s, peak memory,
              one step's device busy time and top kernels, zamba2's SSD
              loop's share of a step; no kernel launched
              (train_families_launches in the kernel table)
  lm_train_dp  LM training over two gloo ranks sharing the card, processes
              of this script (--mesh-rank) whose collectives cross through
              host copies (NCCL refuses two ranks on one card), each rank
              counting its kernels' launches over its path (none may
              launch): (a) qwen2-0.5b as configured (bf16, remat) through
              train_loop over a (2, 1) mesh with ZeRO-1, lm_train's 4 x 2048
              batch split 2 x 2048 a rank, 3 steps: the ranks' losses and
              grad norms bitwise equal, their gathered params bitwise equal
              after the last step (sha256), each rank's optimizer bytes within
              1 % of half the one-rank 12 B a parameter; the median step ms,
              tokens/s, each rank's peak memory, the sync's ms and bytes
              (the float32 all-reduce of the gradients' rows, one a rank) and
              the gather's, the
              global losses beside lm_train's first 3; (b) the reduced
              float32 qwen2 over the same ranks, 3 steps, against one rank
              on the card in this process (losses within 1e-5 relative,
              weights within 1e-4, which the steps move past), and saved at
              step 2; (c) a world of one rank: plan_mesh(1, 1), the step-2
              checkpoint through restore(shardings=) (each part bitwise its
              slice of the whole), step 3 within the same bars of (b)'s
              (train_dp_launches in the kernel table)
  lm_train_tp  the partitioned step (train/partitioned.py) over gloo ranks
              sharing the card, processes of this script, their world on
              launch/transport.py (each collective staged through host
              copies and counted by kind) and their mesh a "cuda" one: (a)
              qwen2-0.5b as configured through train_loop over a (1, 2) mesh
              (heads, FFN and vocab cut over "model"), lm_train's 4 x 2048
              batch, 3 steps: the ranks' losses bitwise equal; step ms,
              tokens/s, each kind's calls, bytes and host-copy / collective
              / copy-back ms, each rank's peak memory and parameters; (b)
              the reduced float32 qwen2 over (1, 2) and (2, 2) against one
              rank on the card (losses within 1e-5 relative, weights within
              1e-4), saved at step 2 over (1, 2) and resumed from it on one
              rank; (c) the reduced float32 qwen3-moe over (2, 1) and (2, 2)
              (dispatch groups from the mesh, experts cut over "model" at
              (2, 2)) against (2, 1) on two CPU gloo ranks (losses within
              1e-5, weights within 1e-4, once no router pick is within 1e-5
              of a tie), the share of picks dropped at capacity; (d) the dry
              run's prediction of (a)'s step on a (1, 2) fake mesh against a
              fourth step counted on the ranks: argument bytes, FLOPs and
              the collectives' calls and bytes by kind equal, the peak
              within 10 % (train_tp_launches in the kernel table)
  lm_dryrun   the dry run (launch/dryrun.py: the partitioned step over
              DTensors on a fake process group and fake tensors, CPU
              only, child processes of this script) held to the card: (a)
              lm_train's step (qwen2-0.5b, bf16, remat, 4 x 2048 in one
              microbatch, attn_impl="torch") predicted on a (1, 1) fake
              mesh, then run on the card: argument bytes equal the real
              state's and batch's, FLOPs equal FlopCounterMode's over the
              real step, the predicted peak within 10 % of
              max_memory_allocated after reset_peak_memory_stats (less what
              was allocated before the state), both printed; (b) train_4k
              on the 16 x 16 mesh of a fake world of 256 ranks for
              qwen2-0.5b, falcon-mamba-7b, zamba2-1.2b, qwen3-moe-235b-a22b,
              deepseek-v2-236b and pixtral-12b, cut to the period's
              layers (1, zamba2's 6), in parallel, started once lm_train_tp's
              timed steps are over: each OK line with its per-rank peak GiB
              and the phase's seconds; no kernel launched
  coreset_serve  the coreset server on the card: CoresetEngine behind the
              HTTP API on an ephemeral port, no backend pinned, driven only
              by the binary SDK with every kernel's count at 0 just before:
              slice 1's signal registered as a synthetic spec, built (k 64,
              eps 0.3), then (32, 0.4) served dominated; 4 client threads
              each send 8 single-tree queries and 2 batches of 256 trees;
              one single held in a longer window so that a batch joins it
              (one scoring call for both); one uncoalesced single (the T = 1
              kernel); a 20-tree forest fit, bitwise one fitted on numpy;
              the stream's eight frames ingested, then built, equal to
              StreamingBuilder's on numpy.  Every served loss within 1e-3
              of the numpy oracle on the served coreset; /v1/stats's
              ops_backend_cuda above 0 and the others 0; one scoring call a
              fusion; sat_moments_f64, fitting_loss_batched and
              hist_f64_node launched.  The build's seconds, p50 and p99 of
              both request kinds, the dominated request's ms and each
              kernel's launches (serving_launches in the kernel table)
  coreset_cluster  the distributed serving plane on the card: 4 processes
              of serve_coresets --role worker (unpinned, each boot line
              "ops on ['cuda']", each in a session of its own, stopped in a
              finally) and a ClusterEngine coordinator in this process
              behind the HTTP API, one band a worker, every kernel's count
              at 0 just before: slice 1's signal registered as the
              synthetic spec (four 1024 x 4096 bands scattered), built at
              (64, 0.3): fingerprint-equal to coreset_serve's, one gather,
              no degraded build, each worker's worker_band_builds 1;
              coreset_serve's query traffic and one uncoalesced single,
              every loss within 1e-3 of the numpy oracle, ops_backend_cuda
              every scoring call; rows 960-1215 replaced (two workers take
              a band:delta, the re-cache gather heals nothing), the rebuild
              equal to single-host sharded_coreset of the patched signal on
              the card; a worker terminated (the same coreset, one degraded
              build, its worker_up gauge 0) and restarted empty on its port
              (the same coreset, one rejoin, one no_band heal, no new
              degraded build); sat_moments_f64, sat_delta_f64,
              fitting_loss and fitting_loss_batched launched in this
              process (the workers' launches are in theirs, uncounted).
              The build's, the gather's and the register's seconds beside
              coreset_serve's, each worker's band build seconds, p50 and
              p99 of both request kinds (cluster_launches in the kernel
              table)
  coreset_mesh  the mesh half on the card, every rank a process of this
              script (--mesh-rank; this process starts no group), each rank
              zeroing its kernels' counts just before its path: one NCCL
              rank, CoresetEngine(mesh=make_local_mesh(1)) on slice 1's
              signal (coreset_serve's fingerprint) and coreset_serve's eight
              T = 256 batches, bitwise the engine without a mesh on the same
              coreset and within 1e-5 of the numpy oracle, eight
              ops_backend_cuda+all_reduce scoring calls, then sat_pjit at
              4096 x 4096 float32 against sat_moments; two NCCL ranks on the
              one card, which NCCL must refuse ("Duplicate GPU detected");
              four gloo ranks on the one card (their collectives through the
              host), the sharded scorer on the same coreset (handed over in
              a .npz, its fingerprint checked) and batches within 1e-4 of the
              one-device kernel and rtol 2e-3 / atol 1e-3 of the oracle, a
              padding-only slab exactly 0 on the card, and sat_pjit with
              1,024 rows a rank, gathered, against sat_moments.  The ranks'
              launches summed (kernel 4 one a rank a call, kernel 2 one a
              rank a band; mesh_launches in the kernel table); host ms of a
              scorer call, a sat_pjit and each collective on both meshes
              beside the one-device scorer's and sat_pjit's
  coreset_gates  the server's four gates and the paper's four examples
              (scripts/*_gate_torch.py, examples/*_torch.py), each run
              unpinned in this process (the gate's main(argv), the
              example's __main__ by runpy), its stdout captured, every
              kernel's count and the dispatch counts at 0 just before it:
              coalesce and trace at the serve phase's 4096 x 4096 signal,
              k = 64 (16 and 8 concurrent 64-leaf queries), stream and
              overload at their own sizes (overload at its defaults, 3.0 s
              of overload and 1.5 s of baseline); each gate's last line
              "[<name>] PASS" and its return code 0 (a SKIP fails), every
              op dispatched to cuda; each example's stdout, its seconds and
              speed-ups masked, equal to the same example's run pinned on
              numpy in a child process, client_quickstart's two lines of
              losses scored by the float32 kernels held within 1e-3 of
              numpy's float64 answers; sat_moments_f64, sat_stack_f64,
              fitting_loss, fitting_loss_batched and hist_f64_node
              launched, the float32 histogram and attention kernels not.
              Each run's seconds, dispatches, launches and its own printed
              figures (gates_launches in the kernel table)
  autotune    last, and the only phase with a warm tuning cache (every
              phase runs with REPRO_TORCH_AUTOTUNE_CACHE pointed at a file
              in a temporary directory, cold until here; the default cache
              is never read or written): tune_all(budget="full") at the
              reference's LARGE_SHAPES, one line per op and backend (the
              winner, us, numpy_us, rel_err, the source's launch shape, every
              candidate and any failed one); every float64 cuda candidate
              exact (rel_err 0), every compensated one within 1e-6, none
              failed; the saved cache reloaded equal; tuned_backend at each
              bucket in the f64, compensated and fast precision modes (f64
              lifts no pin); then each op dispatched once at its tuned size
              with no backend and no config, which must take the selected
              backend and the planned config's kernel

then a timeline line (the wall seconds of each part of the run), the
kernel table, nvidia-smi's line, and a last line
{"ok": true, "device": {...}}.  Any failed check exits non-zero before the
last line.  Without a CUDA device, or without the repository around it, the
script exits non-zero and prints no result.  It imports torch and numpy and
the repro_torch package only.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
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
             "zamba2_prefill": (4, 32, 32, 2048, 2048, 64, "bfloat16"),
             "qwen3_moe_prefill": (4, 64, 4, 2048, 2048, 128, "bfloat16"),
             "musicgen_prefill": (4, 24, 24, 2048, 2048, 64, "bfloat16"),
             "pixtral_prefill": (4, 32, 8, 2048, 2048, 128, "bfloat16"),
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
# the state-space families (models/ssm.py): falcon-mamba-7b (Mamba1) and
# zamba2-1.2b (Mamba2 with a shared GQA block every 6 layers) at full width
# with lm_serve's traffic and bars; the shared block's launches of the bf16
# kernel in one prefill (n_layers // attn_every); the reduced float32 models
# on the card against the CPU within SSM_CPU_TOL (abs + rel, lm_train (a)'s
# bar), SSM_CPU_GEN greedy tokens after SSM_CPU_PROMPT equal
# zamba2's bf16 logits are ill-conditioned in the rounding: two bf16 paths
# that round differently anywhere drift apart over 38 Mamba2 layers (with
# random weights its bf16 logits stand ~0.5 from the float32 model's on
# either attention path, PERF.md §6), so LM_LOGITS_TOL holds each
# application of the shared block (the kernel against attn_impl="torch" on
# the same input), and the logits as lm_serve's LM_F32_MARGIN does
SSM_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
# both cut in depth so that the whole script, lm_train_tp included, keeps
# its time limit (at full depth: PR 29's figures, PERF.md §5)
SSM_LAYERS = {"falcon-mamba-7b": 8, "zamba2-1.2b": 12}
SSM_CPU_TOL = 1e-4
SSM_CPU_PROMPT, SSM_CPU_GEN = (2, 24), 16
# the MoE families (models/moe.py, MLA): each arch at full width with its
# depth cut to MOE_LAYERS, so that the bf16 model fits the card beside the
# plain MLA attention's (4, 128, 2048, 2048) float32 scores; MOE_ATTN the
# prefill's attn_impl (deepseek's MLA heads, 192 wide for query and key and
# 128 for the value, are no shape of the flash-attention kernel, nor of the
# reference's Pallas kernel); lm_serve's traffic and bars, the float32
# cross-check on the first layer at a capacity where nothing drops, the
# reduced float32 models against the CPU within SSM_CPU_TOL
MOE_LAYERS = {"qwen3-moe-235b-a22b": 6, "deepseek-v2-236b": 4}
MOE_ATTN = {"qwen3-moe-235b-a22b": None, "deepseek-v2-236b": "torch"}
# the modality frontends (models/model.py's embed_inputs and head):
# musicgen-medium's (B, L, 4) codebook tokens and (B, L, 4, 2048) logits,
# pixtral-12b's n_patches = 256 patch embeddings (seeded standard normals
# in bf16, as the reference's tests draw them) before 1,792 text tokens;
# both at full width, cut in depth to FRONTEND_LAYERS so that the whole
# script keeps its time limit (at full depth: PR 31's figures, PERF.md §5),
# with lm_serve's traffic and bars.  The float32 cross-check runs musicgen
# whole and pixtral's first
# FRONTEND_F32_LAYERS layer, embedding, head and final norm (its whole
# float32 model, 49 GB, does not fit beside the bf16 one); pixtral's
# decode and generate take text only, as the reference's do, and musicgen
# decodes greedily through a loop of decode steps (no generate takes
# codebooks: the reference's own test)
FRONTEND_ARCHS = ("musicgen-medium", "pixtral-12b")
FRONTEND_F32_LAYERS = {"pixtral-12b": 1}
FRONTEND_LAYERS = {"musicgen-medium": 12, "pixtral-12b": 10}
# LM training (train/, checkpoint/, runtime/, launch/train.py): (a) the
# reduced qwen2 in float32, LM_TRAIN_XCHECK (batch, tokens, steps) on the
# card and on the CPU from the same weights, with LM_TRAIN_OPT (warmup and
# the clip active; an lr at which Adam's g / (|g| + eps) keeps the float32
# roundings of near-zero gradients under the bar, tests/test_torch_train.py),
# losses within LM_TRAIN_TOL relative and the weights within LM_TRAIN_TOL;
# (b) qwen2-0.5b as configured (bf16, remat), train_loop for
# LM_TRAIN_FULL (batch, tokens, steps), the serving prefill's shape; (c)
# crash at LM_TRAIN_RESUME's fail_at and resume from save_every, on a
# reduced config whose whole state stays under ~100 MB, held to the
# reference test's bar (tests/test_train_infra.py); (d) the CLI
LM_TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
LM_TRAIN_XCHECK = (4, 64, 3)
LM_TRAIN_TOL = 1e-4
LM_TRAIN_FULL = (4, 2048, 6)
LM_TRAIN_SMALL = dict(n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, d_ff=768,
                      vocab=4096)
LM_TRAIN_RESUME = dict(steps=10, batch=4, seq_len=256, save_every=5)
LM_TRAIN_FAIL_AT = 7
LM_TRAIN_RESUME_RTOL, LM_TRAIN_RESUME_ATOL = 1e-5, 1e-6
LM_TRAIN_CLI_TIMEOUT_S = 300
# lm_train_families: the SSM-hybrid and audio families through the trainer.
# (a) full width at a cut depth in float32, card against CPU: zamba2 at 6
# layers (its shared block runs after every 6th, so once), musicgen at 2;
# batch, tokens and steps.  (b) full width and depth in bf16 with remat
# through train_loop: LM_TRAIN_FULL's batch and tokens, 3 steps
TRAIN_FAMILIES = ("zamba2-1.2b", "musicgen-medium")
TRAIN_FAMILIES_LAYERS = {"zamba2-1.2b": 6, "musicgen-medium": 2}
TRAIN_FAMILIES_XCHECK = (1, 128, 3)
TRAIN_FAMILIES_FULL = (LM_TRAIN_FULL[0], LM_TRAIN_FULL[1], 3)
# zamba2's full-width float32 gradients differ between the card and the CPU
# by ~3e-5 of a leaf's norm (the SSD's exp of prefix-sum differences near
# 88), ~1e-6 absolute: hundreds of elements of |g| below that take the other
# sign, and AdamW's update, ~lr x sign(g) in its first steps, puts ~1e-3
# between the runs' params there (and a same-signed gradient at the noise's
# size moves m / sqrt(v) by up to a third).  So at full width at most
# TRAIN_FAMILIES_MAX_OVER_TOL_SHARE of its params may lie past LM_TRAIN_TOL,
# and none further apart than two AdamW runs can drift (each step moves an
# element by at most lr_t: |m_hat| / sqrt(v_hat) <= 1.001 over the first
# three steps at these betas); all of them are held at the reduced width.
# Each step's sign flips, and the params where none flipped, are recorded
TRAIN_FAMILIES_SIGN_NOISE = ("zamba2-1.2b",)
TRAIN_FAMILIES_MAX_OVER_TOL_SHARE = 1e-5
# LM training over ranks (train/zero1.py, sharding/, runtime/elastic.py,
# restore(shardings=)): LM_DP_RANKS gloo ranks on the card over a
# (LM_DP_RANKS, 1) mesh; (a) lm_train's full-width batch for LM_DP_STEPS
# steps; (b) LM_DP_SMALL in float32 for LM_DP_LOOP with LM_TRAIN_OPT, against
# one rank within LM_DP_LOSS_RTOL (losses) and LM_TRAIN_TOL (weights), saving
# at step LM_DP_SAVE_AT; (c) that checkpoint restored onto one rank.  Each
# rank's optimizer bytes within LM_DP_OPT_SHARE_TOL of its 1 / LM_DP_RANKS
# share; the ranks stopped after LM_DP_TIMEOUT_S
LM_DP_RANKS, LM_DP_STEPS, LM_DP_TIMEOUT_S = 2, 3, 600
# the dry run (launch/dryrun.py): (a) its prediction of lm_train's step (the
# full-width batch, one microbatch) on a (1, 1) fake mesh against the card:
# argument bytes and FLOPs exactly, the peak within LM_DRYRUN_PEAK_TOL of
# max_memory_allocated; (b) one train_4k cell a family on the 16 x 16 mesh of
# a fake world, cut to its period's layers (1, zamba2's 6; the full depths are
# the CPU sweep's, PERF.md), the cells as processes in parallel, each stopped after
# LM_DRYRUN_TIMEOUT_S
LM_DRYRUN_PEAK_TOL = 0.10
LM_DRYRUN_CELLS = ("qwen2-0.5b", "falcon-mamba-7b", "zamba2-1.2b",
                   "qwen3-moe-235b-a22b", "deepseek-v2-236b", "pixtral-12b")
LM_DRYRUN_TIMEOUT_S = 300
LM_DP_SMALL = dict(n_layers=4)
LM_DP_LOOP = dict(steps=3, batch=4, seq_len=64)
LM_DP_SAVE_AT, LM_DP_LOSS_RTOL, LM_DP_OPT_SHARE_TOL = 2, 1e-5, 0.01
# the partitioned step over ranks (train/partitioned.py, launch/transport.py):
# (a) lm_train's full-width batch over LM_TP_MESH for LM_TP_STEPS steps, then
# one more counted for (d); (b) LM_DP_SMALL / LM_DP_LOOP over LM_TP_MESH and
# LM_TP_MESH4 against one rank, saved at LM_DP_SAVE_AT over LM_TP_MESH; (c)
# LM_TP_MOE reduced, float32, for LM_DP_LOOP over LM_TP_MOE_MESHES against
# (2, 1) on CPU ranks, within LM_TP_MOE_RTOL (losses) and LM_TRAIN_TOL
# (weights) once the smallest gap of a token's k-th over its (k+1)-th router
# probability exceeds LM_TP_ROUTER_MARGIN; the ranks stopped after
# LM_TP_TIMEOUT_S
LM_TP_MESH, LM_TP_MESH4, LM_TP_STEPS, LM_TP_TIMEOUT_S = (1, 2), (2, 2), 3, 600
LM_TP_MOE = "qwen3-moe-235b-a22b"
LM_TP_MOE_MESHES = ((2, 1), (2, 2))
LM_TP_MOE_RTOL, LM_TP_ROUTER_MARGIN = 1e-5, 1e-5
# the coreset server (service/, client/): slice 1's signal registered as a
# synthetic spec (generated server-side, nothing uploaded), built, then a
# weaker (k, eps) that the cache must serve dominated; SERVE_CLIENTS threads
# of the binary SDK each send SERVE_SINGLES single-tree queries and
# SERVE_BATCHES batches of SERVE_T trees (trees of 64 leaves, rng seed 1),
# a SERVE_FOREST-tree fit, and the stream's frames ingested into a second
# signal.  The fusion probe holds one single in a window of SERVE_PROBE_S so
# that a batch joins it.  Losses are held to the serve phase's bar
SERVE_SIGNAL = {"kind": "piecewise", "n": 4096, "m": 4096, "k": 64, "seed": 0}
SERVE_K, SERVE_EPS, SERVE_DOMINATED = 64, 0.3, (32, 0.4)
SERVE_CLIENTS, SERVE_SINGLES, SERVE_BATCHES, SERVE_T = 4, 8, 2, 256
SERVE_FOREST, SERVE_PROBE_S, SERVE_TOL = 20, 0.5, 1e-3
# the distributed serving plane (cluster/): CLUSTER_WORKERS processes of
# serve_coresets --role worker, one band each, behind a ClusterEngine in this
# process; the delta replaces rows CLUSTER_DELTA, across the band boundary at
# 1024, so two workers take a band:delta; worker CLUSTER_VICTIM is
# terminated, then restarted empty on its port, and the coordinator probes a
# down worker again CLUSTER_REPROBE_S after marking it down
# coreset_gates: the gates as (script, argv), coalesce and trace at the serve
# phase's signal; stream and overload at their own sizes, which their
# contracts fix (overload at its defaults, not --smoke); the examples at
# their documented sizes, each beside its run pinned on numpy
_SERVE_ARGS = ["--rows", str(SERVE_SIGNAL["n"]), "--cols", str(SERVE_SIGNAL["m"]),
               "--k", str(SERVE_SIGNAL["k"])]
GATES = (("coalesce_gate_torch", _SERVE_ARGS), ("trace_gate_torch", _SERVE_ARGS),
         ("overload_gate_torch", []), ("stream_gate_torch", []))
# the gates after which the examples' numpy twins start: the timed overload
# gate has run, and the stream gate (no timing contract) overlaps them
TWINS_AFTER = "overload_gate_torch"
EXAMPLES = ("quickstart_torch", "image_compression_torch",
            "automl_tuning_torch", "client_quickstart_torch")
# the lines of an example whose numbers are losses the server scored with
# the float32 loss kernels: held to numpy's float64 answers within SERVE_TOL
EXAMPLE_SERVED_LINES = {"client_quickstart_torch": ("tree loss ", "batch of ")}
# the kernels the eight must launch (the streamed signals' appends and
# replacements recompress through sat_stack, so sat_delta_f64 is not among
# them), and the float32 histogram and attention kernels they must not
GATES_LAUNCHED = ("sat_moments_f64", "sat_stack_f64", "fitting_loss",
                  "fitting_loss_batched", "hist_f64_node")
GATES_NOT_LAUNCHED = ("hist_fused_f32", "hist_partials_f32", "hist_legacy_f32",
                      "flash_attention_bf16", "flash_attention_f32")
EXAMPLE_TIMEOUT_S = 300
CLUSTER_WORKERS, CLUSTER_DELTA = 4, (960, 1216)
CLUSTER_VICTIM, CLUSTER_REPROBE_S = 2, 1.0
# the mesh (core/sharded.py's mesh half, CoresetEngine(mesh=)): one NCCL rank,
# the mesh a one-card host has; MESH_RANKS gloo ranks on the one card (NCCL
# refuses two ranks on one card, which two NCCL ranks confirm); each rank a
# process of this script (--mesh-rank), stopped after MESH_TIMEOUT_S.  The
# sharded scorer is held to the one-device kernel (the batched-against-dense
# gate, scripts/ci_smoke.sh) and to the oracle at the reference mesh test's
# bars (tests/test_ops.py); the one-rank engine's losses bitwise to the
# engine without a mesh
MESH_RANKS, MESH_TIMEOUT_S, MESH_REPS = 4, 300, 10
MESH_KERNEL_RTOL, MESH_ORACLE_RTOL, MESH_ORACLE_ATOL = 1e-4, 2e-3, 1e-3
MESH_ENGINE_TOL = 1e-5


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
        got = ops.hist_split(*inputs, HIST_BINS, backend="cuda",
                             config={"variant": variant})
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


def device_busy(fn, top: int = 6) -> tuple[float, list, int]:
    """One call of ``fn`` under torch.profiler, recording the device's
    activity only: the device's busy ms (the sum of its kernels' own times,
    the profiler's "Self CUDA time total"), the ``top`` kernels with the
    most time, [name, ms, calls] each, and the number of device kernels it
    ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    check(busy > 0, "the profiler saw no device time")
    most = sorted(kern, key=lambda e: -e.self_device_time_total)[:top]
    return (busy, [[e.key[:100], e.self_device_time_total / 1e3, e.count] for e in most],
            sum(e.count for e in kern))


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
    from repro_torch.tree import leaves
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
    prefill_busy_ms, prefill_top, _ = device_busy(
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
    step_busy_ms, step_top, _ = device_busy(step)
    del cache
    emit("lm_serve", arch=cfg.name, params=cfg.param_count(),
         weights_bytes=sum(t.numel() * t.element_size() for t in leaves(params)),
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


def ssm_scan_ms(cfg, B: int, L: int) -> dict:
    """Device ms of one layer's chunked scan (Mamba1's ``_mamba1_ssm_chunked``
    or Mamba2's ``_mamba2_ssd_chunked``) at (B, L), on inputs of the
    model's ranges (decays exp(Δ·A), Δ = softplus of a normal draw); the
    work does not depend on the values.  With its float32 bytes: the
    inputs read once and y written once."""
    import torch
    from repro_torch.models import ssm
    g = torch.Generator(device="cuda").manual_seed(1)
    di, s, Q = cfg.d_inner, cfg.ssm_state, cfg.ssm_chunk

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    if cfg.mamba_version == 1:
        delta = torch.nn.functional.softplus(randn(B, L, di))
        A = -torch.arange(1, s + 1, device="cuda", dtype=torch.float32).expand(di, s)
        args = (torch.exp(delta[..., None] * A), delta[..., None] * randn(B, L, 1, s),
                randn(B, L, s), Q)
        fn = ssm._mamba1_ssm_chunked
        out = B * L * di
    else:
        H, P = cfg.ssm_heads, cfg.mamba_headdim
        delta = torch.nn.functional.softplus(randn(B, L, H))
        args = (torch.exp(-delta), randn(B, L, H, P) * delta[..., None], randn(B, L, s),
                randn(B, L, s), Q)
        fn = ssm._mamba2_ssd_chunked
        out = B * L * H * P
    ms = device_ms(lambda: fn(*args), 2)[0]
    nbytes = 4 * (sum(a.numel() for a in args[:-1]) + out)
    del args
    torch.cuda.empty_cache()
    return {"ms": ms, "bytes": nbytes, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def frontend_batch(cfg, B: int, L: int, rng, device, patch_dtype=None) -> dict:
    """Seeded inputs of L positions on ``device``: (B, L) tokens; for the
    audio frontend (B, L, C) codebook tokens; for the vision frontend
    n_patches standard-normal patch embeddings in ``patch_dtype`` (the
    model's casts them to its own) and L - n_patches text tokens."""
    import numpy as np
    import torch
    if cfg.frontend == "audio_codebooks":
        return {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab, size=(B, L, cfg.n_codebooks)), device=device)}
    if cfg.frontend != "vision_stub":
        return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, L)),
                                          device=device)}
    patches = rng.standard_normal(size=(B, cfg.n_patches, cfg.d_model), dtype=np.float32)
    return {"patch_embeds": torch.as_tensor(patches, device=device).to(
                patch_dtype or torch.bfloat16),
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, L - cfg.n_patches)),
                                      device=device)}


def greedy_decode(cfg, params, prompts, new: int):
    """Greedy tokens after ``prompts`` on the parameters' device: (B, Lp)
    text prompts through ``generate``; musicgen's (B, Lp, C) codebook
    prompts through a loop of decode steps taking each codebook's argmax,
    ``generate``'s loop (no generate takes codebooks; the reference's own
    test decodes so).  Returns (B, Lp + new[, C]) int32."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import decode_step, init_cache
    if cfg.frontend != "audio_codebooks":
        return generate(cfg, params, prompts, new, greedy=True)
    device = params["embed"]["table"].device
    B, Lp, _ = prompts.shape
    cache = init_cache(cfg, B, Lp + new, device=device)
    toks = torch.as_tensor(np.asarray(prompts, np.int32), device=device)
    out = [toks]
    with torch.no_grad():
        for t in range(Lp):
            logits, cache = decode_step(cfg, params, cache, {"tokens": toks[:, t:t + 1]})
        for _ in range(new):
            cur = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)[:, None]
            out.append(cur)
            logits, cache = decode_step(cfg, params, cache, {"tokens": cur})
    return torch.cat(out, dim=1).cpu().numpy()


def _cpu_parity(arch: str, attn_impl=None) -> dict:
    """The reduced float32 model on the card against the CPU from the same
    weights and inputs (``frontend_batch``'s: codebook tokens, patch
    embeddings): prefill logits (the card's attention through
    ``attn_impl``, by default the f32 kernel, the CPU's the plain one)
    within SSM_CPU_TOL, greedy tokens (``greedy_decode``'s, on the text or
    codebook tokens) equal."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.models import init_params, prefill
    from repro_torch.tree import tree_map
    cfg = reduced_config(get_arch(arch), dtype="float32", remat=False)
    cpu = init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to("cuda"), cpu)
    B, L = SSM_CPU_PROMPT
    batch = frontend_batch(cfg, B, L + cfg.n_patches, np.random.default_rng(2), "cpu",
                           torch.float32)
    want, _ = prefill(cfg, cpu, batch, attn_impl="torch")
    got, _ = prefill(cfg, card, {k: v.to("cuda") for k, v in batch.items()},
                     attn_impl=attn_impl)
    got = got.cpu()
    excess = float(((got - want).abs() - SSM_CPU_TOL * want.abs()).max())
    err = float((got - want).abs().max())
    check(excess <= SSM_CPU_TOL,
          f"{arch} reduced float32 logits card vs CPU: max abs {err}")
    toks = batch["tokens"].numpy().astype(np.int32)
    gen_cpu = greedy_decode(cfg, cpu, toks, SSM_CPU_GEN)
    gen_card = greedy_decode(cfg, card, toks, SSM_CPU_GEN)
    check(np.array_equal(gen_cpu, gen_card), f"{arch} reduced greedy tokens card vs CPU")
    return {"batch": B, "tokens": L, "logits_max_abs_err": err,
            "max_excess_over_bar": excess, "new_tokens": SSM_CPU_GEN,
            "greedy_equal": True}


def _shared_block_errs(cfg, params, batch: dict) -> list:
    """One bf16 prefill of ``batch`` in which every ``gqa_forward`` (each
    application of the hybrid's shared block, each layer of a GQA model)
    runs the kernel and the plain attention on the same input: each
    output's relative Frobenius distance, the kernel's against the plain."""
    from repro_torch.models import attention, prefill
    real, errs = attention.gqa_forward, []

    def both(p, c, h, positions, attn_impl=None, **kw):
        out = real(p, c, h, positions, "cuda", **kw)
        errs.append(_rel_fro(out, real(p, c, h, positions, "torch", **kw)))
        return out
    attention.gqa_forward = both
    try:
        prefill(cfg, params, batch)
    finally:
        attention.gqa_forward = real
    return errs


def _serve_ssm(arch: str, kernels) -> dict:
    """One SSM-family model at full width on the card (its depth cut to
    SSM_LAYERS where listed), lm_serve's parts."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)
    from repro_torch.tree import leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_arch(arch)
    cfg = dataclasses.replace(cfg, n_layers=SSM_LAYERS.get(arch, cfg.n_layers))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    # the hybrid's shared block: one bf16 kernel launch an application
    shared = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" and cfg.attn_every else 0
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
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    check(launches == ({"flash_attention_bf16": shared} if shared else {}),
          f"{arch} prefill launched {launches}, not the bf16 kernel {shared} times")
    check(logits.shape == (B, L, cfg.vocab) and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), f"{arch} prefill logits not finite or misshapen")
    warm = [run()[1] for _ in range(2)]
    attn_check = None
    if shared:
        blocks = _shared_block_errs(cfg, params, {"tokens": toks})
        check(len(blocks) == shared and max(blocks) <= LM_LOGITS_TOL,
              f"{arch} shared block, kernel vs attn_impl='torch': {blocks}")
        plain_logits, _ = run("torch")
        exact, _ = prefill(dataclasses.replace(cfg, dtype="float32"),
                           cast_params(params, torch.float32), {"tokens": toks})
        fro32 = {"kernel": _rel_fro(logits, exact), "plain": _rel_fro(plain_logits, exact)}
        check(fro32["kernel"] <= LM_F32_MARGIN * fro32["plain"],
              f"{arch} kernel-path logits farther from the float32 model than the "
              f"plain path's: {fro32}")
        attn_check = {"block_out_rel_fro_vs_plain": blocks,
                      "logits_rel_fro_vs_plain": _rel_fro(logits, plain_logits),
                      "logits_rel_fro_vs_float32_model": fro32}
        del plain_logits, exact
    del logits
    torch.cuda.empty_cache()
    prefill_s = float(np.median(warm))
    busy_ms, top, n_kernels = device_busy(lambda: prefill(cfg, params, {"tokens": toks}), top=8)
    prefill_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    scan = ssm_scan_ms(cfg, B, L)

    # float32: prefill against teacher-forced decode at every position
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = cast_params(params, torch.float32)
    B2, L2 = LM_XCHECK
    t32 = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B2, L2)), device="cuda")
    kernels["flash_attention_f32"].launches = 0
    full, _ = prefill(cfg32, p32, {"tokens": t32})
    f32_launches = kernels["flash_attention_f32"].launches
    check(f32_launches == shared, f"{arch} float32 prefill launched the f32 kernel "
                                  f"{f32_launches} times, not {shared}")
    cache = init_cache(cfg32, B2, L2, device="cuda")
    steps = torch.stack([decode_step(cfg32, p32, cache, {"tokens": t32[:, t:t + 1]})[0][:, 0]
                         for t in range(L2)], dim=1)
    diff = (steps - full).abs()
    dec_abs = float(diff.max())
    dec_excess = float((diff - LM_DECODE_TOL * full.abs()).max())
    check(dec_excess <= LM_DECODE_TOL,
          f"{arch} float32 prefill vs decode: max abs {dec_abs}, beyond 2e-3 + 2e-3|x|")
    del p32, full, steps, diff, cache
    torch.cuda.empty_cache()

    # greedy generation on the bf16 model; decode launches no kernel
    Bg, Lp, new = LM_GEN
    prompts = rng.integers(0, cfg.vocab, size=(Bg, Lp)).astype(np.int32)
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, new, greedy=True)
    gen_s = time.perf_counter() - t0
    check(out.shape == (Bg, Lp + new) and np.array_equal(out[:, :Lp], prompts)
          and ((out >= 0) & (out < cfg.vocab)).all(), f"{arch} generate's tokens misshapen")
    check(sum(k.launches for k in kernels.values()) == 0,
          f"{arch} generate launched a kernel (decode is plain)")
    cache = init_cache(cfg, Bg, Lp + new, device="cuda")
    step_tok = torch.as_tensor(out[:, Lp:Lp + 1], device="cuda")

    def step():
        decode_step(cfg, params, dict(cache, pos=Lp), {"tokens": step_tok})
    step()
    step_busy_ms, step_top, _ = device_busy(step)
    ms_step = gen_s * 1e3 / (Lp + new)
    del cache, params
    torch.cuda.empty_cache()
    flops = 2 * n_params * B * L
    return {"arch": arch, "n_layers": cfg.n_layers, "params": n_params,
            "config_param_count": cfg.param_count(),
            "weights_bytes": 2 * n_params,
            "prefill": {"batch": B, "tokens": L, "host_s": prefill_s, "cold_host_s": cold_s,
                        "host_s_runs": warm, "tokens_per_s": B * L / prefill_s,
                        "device_busy_ms": busy_ms,
                        "device_idle_share": 1 - busy_ms / 1e3 / prefill_s,
                        "device_kernels": n_kernels, "device_top_kernels_ms": top,
                        "flops_2n": flops, "flops_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
                        "peak_memory_gb": prefill_peak_gb,
                        "scan_layer_device_ms": scan["ms"],
                        "scan_layer_bytes_bound_ms": scan["bytes_bound_ms"],
                        "scan_share_of_busy": cfg.n_layers * scan["ms"] / busy_ms,
                        "launches": launches, "attention_check": attn_check},
            "float32_check": {"batch": B2, "tokens": L2, "max_abs_err": dec_abs,
                              "max_excess_over_bar": dec_excess,
                              "f32_launches": f32_launches},
            "generate": {"batch": Bg, "prompt": Lp, "new_tokens": new, "host_s": gen_s,
                         "decode_steps": Lp + new, "ms_per_step": ms_step,
                         "step_device_busy_ms": step_busy_ms,
                         "step_device_idle_share": 1 - step_busy_ms / ms_step,
                         "step_top_kernels_ms": step_top,
                         "new_tokens_per_s": Bg * new / gen_s,
                         "first_new": out[:, Lp].tolist()},
            "reduced_float32_vs_cpu": _cpu_parity(arch),
            "peak_memory_gb_with_float32_copy": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_model}


def phase_lm_serve_ssm(kernels) -> dict:
    """The SSM families at full width on the card (falcon-mamba-7b at
    SSM_LAYERS' depth, then zamba2-1.2b), every kernel's count at 0 before each part.  Returns the
    kernels' launches in zamba2's bf16 prefill."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    models = [_serve_ssm(arch, kernels) for arch in SSM_ARCHS]
    emit("lm_serve_ssm", models=models, seconds=time.perf_counter() - t0)
    return {name: sum(m["prefill"]["launches"].get(name, 0) for m in models)
            for name in kernels}


def _moe_probe(fn):
    """``fn()`` with the MoE layer's ``dispatch`` and ``moe_forward``
    wrapped: returns (its result, each MoE layer's share of assignments
    dropped at capacity, from ``dispatch``'s ``keep``, and a copy of the
    first MoE layer's input)."""
    from repro_torch.models import moe
    real_dispatch, real_forward = moe.dispatch, moe.moe_forward
    drops, first = [], []

    def dispatch(*a, **kw):
        out = real_dispatch(*a, **kw)
        keep = out[1][3]
        drops.append(float((~keep).sum()) / keep.numel())
        return out

    def forward(p, cfg, x, **kw):
        if not first:
            first.append(x.detach().clone())
        return real_forward(p, cfg, x, **kw)
    moe.dispatch, moe.moe_forward = dispatch, forward
    try:
        return fn(), drops, first[0] if first else None
    finally:
        moe.dispatch, moe.moe_forward = real_dispatch, real_forward


def moe_layer_ms(cfg, p: dict, x) -> dict:
    """Device ms of one MoE layer on x (B, L, d), whole and in its parts
    (the float32 router, dispatch, the expert products, combine), by CUDA
    events; the expert products' FLOPs over all E x C slots and the share
    of slots a pick fills."""
    import torch
    from repro_torch.models import moe
    B, L, d = x.shape
    T, E, dff = B * L, cfg.n_experts, cfg.d_ff_expert
    C = moe.capacity(cfg, T)
    xt = x.reshape(T, d)
    _, gates, experts = moe.route(p, cfg, xt)
    h, meta = moe.dispatch(xt, experts, gates, E, C)

    def expert_products():
        y = torch.bmm(h, p["wi"]) * torch.nn.functional.silu(torch.bmm(h, p["wg"]))
        return torch.bmm(y, p["wo"])
    y = expert_products()
    flops = 2 * 3 * E * C * d * dff
    out = {"capacity": C, "slots": E * C,
           "slots_filled_share": float(meta[3].sum()) / (E * C),
           "layer_ms": device_ms(lambda: moe.moe_forward(p, cfg, x), 3)[0],
           "router_ms": device_ms(lambda: moe.route(p, cfg, xt), 3)[0],
           "dispatch_ms": device_ms(lambda: moe.dispatch(xt, experts, gates, E, C), 3)[0],
           "experts_ms": device_ms(expert_products, 3)[0],
           "combine_ms": device_ms(lambda: moe.combine(y, meta, T), 3)[0],
           "experts_flops": flops,
           "experts_flops_bound_ms": flops / BF16_FLOP_PER_S * 1e3}
    if "shared" in p:
        from repro_torch.models.layers import swiglu
        out["shared_experts_ms"] = device_ms(lambda: swiglu(p["shared"], xt), 3)[0]
    del h, meta, y
    return out


def _serve_moe(arch: str, kernels) -> dict:
    """One MoE arch at full width and a cut depth on the card, parts (a)-(e)
    of the lm_serve_moe phase."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import generate
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)
    from repro_torch.tree import leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS[arch])
    impl = MOE_ATTN[arch]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    weights_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    # qwen3-moe's GQA layers: one bf16 kernel launch a layer
    kernel_layers = 0 if cfg.is_mla else cfg.n_layers
    rng = np.random.default_rng(0)
    B, L = LM_PREFILL
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B, L)), device="cuda")

    def run(attn_impl=impl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = prefill(cfg, params, {"tokens": toks}, attn_impl=attn_impl)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) the bf16 prefill
    for kern in kernels.values():
        kern.launches = 0
    logits, cold_s = run()
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    check(launches == ({"flash_attention_bf16": kernel_layers} if kernel_layers else {}),
          f"{arch} prefill launched {launches}, not the bf16 kernel {kernel_layers} times")
    check(logits.shape == (B, L, cfg.vocab) and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), f"{arch} prefill logits not finite or misshapen")
    warm = [run()[1] for _ in range(2)]
    (again, _), drops, x0 = _moe_probe(run)
    check(torch.equal(again, logits), f"{arch} two bf16 prefills differ")
    check(len(drops) == cfg.n_layers, f"{arch}: {len(drops)} MoE layers dispatched")
    del again
    # (b) qwen3-moe: each layer's attention, the kernel against the plain
    attn_check = None
    if kernel_layers:
        for kern in kernels.values():
            kern.launches = 0
        errs = _shared_block_errs(cfg, params, {"tokens": toks})
        check(len(errs) == kernel_layers and max(errs) <= LM_LOGITS_TOL,
              f"{arch} attention, kernel vs attn_impl='torch': {errs}")
        plain_logits, plain_s = run("torch")
        attn_check = {"layer_out_rel_fro_vs_plain": errs,
                      "logits_rel_fro_vs_plain": _rel_fro(logits, plain_logits),
                      "plain_attention_cold_host_s": plain_s}
        del plain_logits
    del logits
    torch.cuda.empty_cache()
    prefill_s = float(np.median(warm))
    busy_ms, top, n_kernels = device_busy(
        lambda: prefill(cfg, params, {"tokens": toks}, attn_impl=impl), top=8)
    prefill_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    layer = moe_layer_ms(cfg, params["layers"][0]["mlp"], x0)
    del x0
    torch.cuda.empty_cache()

    # (c) float32: the first layer, embedding, head and final norm at a
    # capacity where no assignment drops, prefill against teacher-forced
    # decode at every position
    cfg32 = dataclasses.replace(cfg, n_layers=1, dtype="float32",
                                capacity_factor=cfg.n_experts / cfg.moe_top_k)
    p32 = cast_params({"embed": params["embed"], "head": params["head"],
                       "layers": params["layers"][:1], "final_ln": params["final_ln"]},
                      torch.float32)
    B2, L2 = LM_XCHECK
    t32 = torch.as_tensor(rng.integers(0, cfg.vocab, size=(B2, L2)), device="cuda")
    for kern in kernels.values():
        kern.launches = 0
    (full32, _), drops32, _ = _moe_probe(
        lambda: prefill(cfg32, p32, {"tokens": t32}, attn_impl=impl))
    f32_launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    check(f32_launches == ({"flash_attention_f32": 1} if kernel_layers else {}),
          f"{arch} float32 prefill launched {f32_launches}")
    cache = init_cache(cfg32, B2, L2, device="cuda")
    steps, dec_drops, _ = _moe_probe(lambda: torch.stack(
        [decode_step(cfg32, p32, cache, {"tokens": t32[:, t:t + 1]})[0][:, 0]
         for t in range(L2)], dim=1))
    check(max(drops32 + dec_drops) == 0, f"{arch} float32 check dropped assignments: "
                                         f"{drops32}, {max(dec_drops)}")
    diff = (steps - full32).abs()
    dec_abs = float(diff.max())
    dec_excess = float((diff - LM_DECODE_TOL * full32.abs()).max())
    check(dec_excess <= LM_DECODE_TOL,
          f"{arch} float32 prefill vs decode: max abs {dec_abs}, beyond 2e-3 + 2e-3|x|")
    del p32, full32, steps, diff, cache
    torch.cuda.empty_cache()

    # (d) greedy generation on the bf16 model; decode launches no kernel
    Bg, Lp, new = LM_GEN
    prompts = rng.integers(0, cfg.vocab, size=(Bg, Lp)).astype(np.int32)
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, new, greedy=True)
    gen_s = time.perf_counter() - t0
    check(out.shape == (Bg, Lp + new) and np.array_equal(out[:, :Lp], prompts)
          and ((out >= 0) & (out < cfg.vocab)).all(), f"{arch} generate's tokens misshapen")
    check(sum(k.launches for k in kernels.values()) == 0,
          f"{arch} generate launched a kernel (decode is plain)")
    cache = init_cache(cfg, Bg, Lp + new, device="cuda")
    step_tok = torch.as_tensor(out[:, Lp:Lp + 1], device="cuda")

    def step():
        decode_step(cfg, params, dict(cache, pos=Lp), {"tokens": step_tok})
    step()
    step_busy_ms, step_top, _ = device_busy(step)
    ms_step = gen_s * 1e3 / (Lp + new)
    del cache, params
    torch.cuda.empty_cache()
    # (e) the reduced float32 model, on the card against the CPU
    for kern in kernels.values():
        kern.launches = 0
    reduced = _cpu_parity(arch, impl)
    reduced["launches"] = {name: kern.launches for name, kern in kernels.items()
                           if kern.launches}
    active = cfg.active_param_count()
    flops = 2 * active * B * L
    return {"arch": arch, "n_layers": cfg.n_layers, "full_n_layers": full.n_layers,
            "params": n_params, "weights_bytes": weights_bytes,
            "config_param_count": cfg.param_count(),
            "config_active_param_count": active,
            "full_param_count": full.param_count(),
            "full_active_param_count": full.active_param_count(),
            "attn_impl": impl or "cuda",
            "prefill": {"batch": B, "tokens": L, "host_s": prefill_s, "cold_host_s": cold_s,
                        "host_s_runs": warm, "tokens_per_s": B * L / prefill_s,
                        "device_busy_ms": busy_ms,
                        "device_idle_share": 1 - busy_ms / 1e3 / prefill_s,
                        "device_kernels": n_kernels, "device_top_kernels_ms": top,
                        "flops_2n_active": flops,
                        "flops_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
                        "peak_memory_gb": prefill_peak_gb,
                        "dropped_share_by_layer": drops,
                        "moe_layer": layer,
                        "moe_share_of_busy": cfg.n_layers * layer["layer_ms"] / busy_ms,
                        "launches": launches, "attention_check": attn_check,
                        "bitwise_repeat": True},
            "float32_check": {"n_layers": 1, "batch": B2, "tokens": L2,
                              "capacity_factor": cfg32.capacity_factor,
                              "max_abs_err": dec_abs, "max_excess_over_bar": dec_excess,
                              "dropped": 0, "launches": f32_launches},
            "generate": {"batch": Bg, "prompt": Lp, "new_tokens": new, "host_s": gen_s,
                         "decode_steps": Lp + new, "ms_per_step": ms_step,
                         "step_device_busy_ms": step_busy_ms,
                         "step_device_idle_share": 1 - step_busy_ms / ms_step,
                         "step_top_kernels_ms": step_top,
                         "new_tokens_per_s": Bg * new / gen_s,
                         "first_new": out[:, Lp].tolist()},
            "reduced_float32_vs_cpu": reduced,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_model}


def phase_lm_serve_moe(kernels) -> dict:
    """The MoE families at full width and a cut depth on the card
    (qwen3-moe-235b-a22b, then deepseek-v2-236b), every kernel's count at
    0 before each part.  Returns the kernels' launches in the bf16
    prefills."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    models = [_serve_moe(arch, kernels) for arch in MOE_LAYERS]
    emit("lm_serve_moe", models=models, seconds=time.perf_counter() - t0)
    return {name: sum(m["prefill"]["launches"].get(name, 0) for m in models)
            for name in kernels}


def _serve_frontend(arch: str, kernels) -> dict:
    """One frontend arch at full width on the card (its depth cut to
    FRONTEND_LAYERS), parts (a)-(e) of the lm_serve_frontends phase."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import (cast_params, decode_step, init_cache,
                                    init_params, prefill)
    from repro_torch.models.layers import head_shape
    from repro_torch.tree import leaves
    t_model = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(get_arch(arch), n_layers=FRONTEND_LAYERS[arch])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_model
    n_params = sum(t.numel() for t in leaves(params))
    rng = np.random.default_rng(0)
    B, L = LM_PREFILL
    batch = frontend_batch(cfg, B, L, rng, "cuda")

    def run(attn_impl=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = prefill(cfg, params, batch, attn_impl=attn_impl)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # (a) the bf16 prefill, one kernel launch a layer, twice bitwise
    for kern in kernels.values():
        kern.launches = 0
    logits, cold_s = run()
    launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    check(launches == {"flash_attention_bf16": cfg.n_layers},
          f"{arch} prefill launched {launches}, not the bf16 kernel {cfg.n_layers} times")
    check(tuple(logits.shape) == (B, L) + head_shape(cfg) and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()), f"{arch} prefill logits not finite or "
                                                  f"misshapen: {tuple(logits.shape)}")
    warm = [run()[1] for _ in range(2)]
    again, _ = run()
    check(torch.equal(again, logits), f"{arch} two bf16 prefills differ")
    del again
    prefill_peak_gb = torch.cuda.max_memory_allocated() / 2**30
    # (b) each layer's attention, the kernel against the plain on its input
    errs = _shared_block_errs(cfg, params, batch)
    check(len(errs) == cfg.n_layers and max(errs) <= LM_LOGITS_TOL,
          f"{arch} attention, kernel vs attn_impl='torch': {errs}")
    plain_logits, plain_s = run("torch")
    attn_check = {"layer_out_rel_fro_vs_plain": errs,
                  "logits_rel_fro_vs_plain": _rel_fro(logits, plain_logits),
                  "plain_attention_cold_host_s": plain_s}
    del logits, plain_logits
    torch.cuda.empty_cache()
    prefill_s = float(np.median(warm))
    busy_ms, top, n_kernels = device_busy(lambda: prefill(cfg, params, batch), top=8)

    # (c) float32 (musicgen whole; pixtral's first layer, embedding, head and
    # final norm) prefill through the f32 kernel against teacher-forced
    # decode at every position, on codebook or text tokens
    n32 = FRONTEND_F32_LAYERS.get(arch, cfg.n_layers)
    cfg32 = dataclasses.replace(cfg, n_layers=n32, dtype="float32")
    p32 = cast_params(dict(params, layers=params["layers"][:n32]), torch.float32)
    B2, L2 = LM_XCHECK
    t32 = frontend_batch(cfg, B2, L2 + cfg.n_patches, rng, "cuda")["tokens"]
    for kern in kernels.values():
        kern.launches = 0
    full32, _ = prefill(cfg32, p32, {"tokens": t32})
    f32_launches = {name: kern.launches for name, kern in kernels.items() if kern.launches}
    check(f32_launches == {"flash_attention_f32": n32},
          f"{arch} float32 prefill launched {f32_launches}, not the f32 kernel {n32} times")
    cache = init_cache(cfg32, B2, L2, device="cuda")
    steps = torch.stack([decode_step(cfg32, p32, cache, {"tokens": t32[:, t:t + 1]})[0][:, 0]
                         for t in range(L2)], dim=1)
    check(steps.shape == full32.shape, f"{arch} decode logits {tuple(steps.shape)}")
    diff = (steps - full32).abs()
    dec_abs = float(diff.max())
    dec_excess = float((diff - LM_DECODE_TOL * full32.abs()).max())
    check(dec_excess <= LM_DECODE_TOL,
          f"{arch} float32 prefill vs decode: max abs {dec_abs}, beyond 2e-3 + 2e-3|x|")
    del p32, full32, steps, diff, cache
    torch.cuda.empty_cache()

    # (d) greedy decoding on the bf16 model; decode launches no kernel
    Bg, Lp, new = LM_GEN
    prompts = frontend_batch(cfg, Bg, Lp + cfg.n_patches, rng, "cpu")["tokens"].numpy()
    prompts = prompts.astype(np.int32)
    for kern in kernels.values():
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = greedy_decode(cfg, params, prompts, new)
    gen_s = time.perf_counter() - t0
    check(out.shape == (Bg, Lp + new) + prompts.shape[2:]
          and np.array_equal(out[:, :Lp], prompts)
          and ((out >= 0) & (out < cfg.vocab)).all(), f"{arch} greedy tokens misshapen")
    check(sum(k.launches for k in kernels.values()) == 0,
          f"{arch} greedy decoding launched a kernel (decode is plain)")
    cache = init_cache(cfg, Bg, Lp + new, device="cuda")
    step_tok = torch.as_tensor(out[:, Lp:Lp + 1], device="cuda")

    def step():
        decode_step(cfg, params, dict(cache, pos=Lp), {"tokens": step_tok})
    step()
    step_busy_ms, step_top, _ = device_busy(step)
    ms_step = gen_s * 1e3 / (Lp + new)
    emb = params["embed"]["table"].numel()
    del cache, params
    torch.cuda.empty_cache()
    # (e) the reduced float32 model, on the card against the CPU
    for kern in kernels.values():
        kern.launches = 0
    reduced = _cpu_parity(arch)
    reduced["launches"] = {name: kern.launches for name, kern in kernels.items()
                           if kern.launches}
    flops = 2 * (n_params - emb) * B * L
    return {"arch": arch, "n_layers": cfg.n_layers, "params": n_params,
            "weights_bytes": 2 * n_params, "config_param_count": cfg.param_count(),
            "init_s": init_s,
            "prefill": {"batch": B, "tokens": L, "patches": cfg.n_patches,
                        "logits_shape": [B, L, *head_shape(cfg)],
                        "host_s": prefill_s, "cold_host_s": cold_s,
                        "host_s_runs": warm, "tokens_per_s": B * L / prefill_s,
                        "device_busy_ms": busy_ms,
                        "device_idle_share": 1 - busy_ms / 1e3 / prefill_s,
                        "device_kernels": n_kernels, "device_top_kernels_ms": top,
                        "flops_2n_nonembed": flops,
                        "flops_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
                        "peak_memory_gb": prefill_peak_gb,
                        "launches": launches, "attention_check": attn_check,
                        "bitwise_repeat": True},
            "float32_check": {"n_layers": n32, "batch": B2, "tokens": L2,
                              "max_abs_err": dec_abs, "max_excess_over_bar": dec_excess,
                              "launches": f32_launches},
            "greedy": {"via": ("decode_step loop, argmax a codebook"
                               if cfg.n_codebooks else "generate"),
                       "batch": Bg, "prompt": Lp, "new_tokens": new, "host_s": gen_s,
                       "decode_steps": Lp + new, "ms_per_step": ms_step,
                       "step_device_busy_ms": step_busy_ms,
                       "step_device_idle_share": 1 - step_busy_ms / ms_step,
                       "step_top_kernels_ms": step_top,
                       "new_tokens_per_s": Bg * new / gen_s,
                       "first_new": out[:, Lp].tolist()},
            "reduced_float32_vs_cpu": reduced,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 2**30,
            "seconds": time.perf_counter() - t_model}


def phase_lm_serve_frontends(kernels) -> dict:
    """The modality frontends at full width on the card, cut in depth
    (musicgen-medium, then pixtral-12b), every kernel's count at 0 before
    each part.  Returns the kernels' launches in the bf16 prefills."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    models = [_serve_frontend(arch, kernels) for arch in FRONTEND_ARCHS]
    emit("lm_serve_frontends", models=models, seconds=time.perf_counter() - t0)
    return {name: sum(m["prefill"]["launches"].get(name, 0) for m in models)
            for name in kernels}


def lm_train_flops(cfg, B: int, L: int) -> dict:
    """A train step's floating-point work on (B, L) tokens: the matmuls
    (2 a multiply-add) and the causal attention's visible pairs (4·hd each,
    the QKᵀ and PV products) in the forward, the backward twice the
    forward, and remat's recompute of the layers' forward; beside them
    6·N·tokens, N every parameter."""
    d, H, Hkv, hd, nl = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.n_layers
    tokens = B * L
    layer = d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * cfg.d_ff
    head = 2 * tokens * d * cfg.vocab
    layers = nl * (2 * tokens * layer + 4 * B * H * hd * visible_pairs(L, L, True))
    forward = layers + head
    return {"forward": forward, "step": 3 * forward,
            "remat_recompute": layers if cfg.remat else 0}


def _max_abs(a_tree, b_tree) -> float:
    """The largest |a - b| over two trees of one structure, leaf by leaf."""
    from repro_torch.tree import flatten
    (ka, la), (kb, lb) = flatten(a_tree), flatten(b_tree)
    check(ka == kb, f"trees of different structures: {ka[:3]}... vs {kb[:3]}...")
    return max(float((a.detach().cpu().double() - b.detach().cpu().double()).abs().max())
               for a, b in zip(la, lb))


def _grads_at(cfg, params, batch: dict) -> list:
    """The gradient of ``loss_fn`` at ``params`` on ``batch``, leaf by leaf,
    where the params lie."""
    import torch
    from repro_torch import train
    from repro_torch.tree import flatten, leaves, tree_map, unflatten
    dev = leaves(params)[0].device
    _, lv = flatten(tree_map(lambda t: t.detach().requires_grad_(True), params))
    loss, _ = train.loss_fn(cfg, unflatten(params, lv),
                            {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
    return list(torch.autograd.grad(loss, lv))


def _trees_equal(a_tree, b_tree) -> bool:
    import torch
    from repro_torch.tree import flatten
    (ka, la), (kb, lb) = flatten(a_tree), flatten(b_tree)
    return ka == kb and all(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
                            for a, b in zip(la, lb))


class _GradSigns:
    """The card's and the CPU's gradients at each step of their own runs,
    compared leaf by leaf: each step's worst leaf's ||card - CPU|| / ||CPU||,
    the elements whose sign differs where |CPU's| > Adam's eps (AdamW's
    update is about lr x sign(g) there in its first steps, so each such
    element puts up to ~2 lr between the two runs' params), and the
    elements whose sign differed at any step, at any size."""

    def __init__(self, keys):
        self.keys, self.card, self.flipped = keys, [], None
        self.rel, self.worst, self.flips, self.flip_max = [], [], [], []

    def add(self, dev: str, grads) -> None:
        if dev == "cuda":
            self.card.append([g.cpu() for g in grads])
            return
        import torch
        from repro_torch.train import AdamWConfig
        eps = AdamWConfig().eps
        card, self.card[len(self.rel)] = self.card[len(self.rel)], None
        if self.flipped is None:
            self.flipped = [torch.zeros(g.shape, dtype=torch.bool) for g in grads]
        rel, flips, flip_max = {}, 0, 0.0
        for i, (k, a, b) in enumerate(zip(self.keys, card, grads)):
            a, b = a.double(), b.detach().double()
            rel[k] = float((a - b).norm() / max(float(b.norm()), 1e-30))
            differ = a.sign() != b.sign()
            self.flipped[i] |= differ
            over = differ & (b.abs() > eps)
            flips += int(over.sum())
            if over.any():
                flip_max = max(flip_max, float(b.abs()[over].max()))
        worst = max(rel, key=rel.get)
        self.rel.append(rel[worst])
        self.worst.append(worst)
        self.flips.append(flips)
        self.flip_max.append(flip_max)

    def params(self, card_p, cpu_p) -> dict:
        """The params' distance on the elements whose gradient never took
        two signs, and the count of those that did."""
        from repro_torch.tree import leaves
        diffs = [(a.detach().cpu().double() - b.detach().cpu().double()).abs()
                 for a, b in zip(leaves(card_p), leaves(cpu_p))]
        kept = [d[~f] for d, f in zip(diffs, self.flipped)]
        return {"params_numel": sum(d.numel() for d in diffs),
                "params_over_tol": sum(int((d > LM_TRAIN_TOL).sum()) for d in diffs),
                "elements_flipped_any_step": sum(int(f.sum()) for f in self.flipped),
                "params_over_tol_unflipped": sum(int((d > LM_TRAIN_TOL).sum())
                                                 for d in kept),
                "params_max_abs_err_unflipped": max(float(d.max()) if d.numel() else 0.0
                                                    for d in kept)}

    def fields(self) -> dict:
        return {"grads_max_leaf_rel_err": self.rel[0], "grads_worst_leaf": self.worst[0],
                "grads_max_leaf_rel_err_by_step": self.rel,
                "grads_worst_leaf_by_step": self.worst,
                "grad_sign_flips_by_step": self.flips,
                "grad_sign_flips_max_abs_by_step": self.flip_max}


def _train_card_vs_cpu(cfg_a, stream, n_steps: int, launched, signs: bool = False,
                       hold_all: bool = True) -> dict:
    """``n_steps`` of ``make_train_step`` with LM_TRAIN_OPT on ``stream``'s
    batches from one set of float32 weights made on the card: on the card
    and on the CPU with remat off, and on the card with remat on.  Checks
    the losses within LM_TRAIN_TOL relative, the params having moved by
    more than 10 x LM_TRAIN_TOL and (``hold_all``) within LM_TRAIN_TOL
    absolute, remat's losses equal to the card's, and no kernel launched.
    ``signs``: each run's gradient at each step, before it is taken, the
    card's against the CPU's (``_GradSigns``), the first step's worst leaf
    within LM_TRAIN_TOL; without ``hold_all``, at most
    TRAIN_FAMILIES_MAX_OVER_TOL_SHARE of the params past LM_TRAIN_TOL and
    none further apart than 2.002 x the steps' summed learning rates."""
    import dataclasses
    import math
    import torch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, cosine_lr, make_train_step
    from repro_torch.tree import flatten, tree_map
    init = init_params(cfg_a, torch.Generator(device="cuda").manual_seed(0))
    grads = _GradSigns(flatten(init)[0]) if signs else None
    runs = {}
    for dev, remat in (("cuda", False), ("cpu", False), ("cuda", True)):
        cfg = dataclasses.replace(cfg_a, remat=remat)
        p = tree_map(lambda t: t.to(dev, copy=True), init)
        o = adamw_init(p)
        step = make_train_step(cfg, AdamWConfig(**LM_TRAIN_OPT))
        losses = []
        for s in range(n_steps):
            if grads is not None and not remat:
                grads.add(dev, _grads_at(cfg, p, stream.batch_at(s)))
            b = {k: torch.as_tensor(v, device=dev) for k, v in stream.batch_at(s).items()}
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        runs[dev, remat] = (losses, p)
    (card, card_p), (cpu, cpu_p) = runs["cuda", False], runs["cpu", False]
    remat_losses, remat_p = runs["cuda", True]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    param_abs = _max_abs(card_p, cpu_p)
    moved = _max_abs(card_p, init)
    check(all(map(math.isfinite, card)) and loss_rel <= LM_TRAIN_TOL,
          f"{cfg_a.name}: card vs CPU train losses: {card} vs {cpu}")
    check((param_abs <= LM_TRAIN_TOL or not hold_all) and moved > 10 * LM_TRAIN_TOL,
          f"{cfg_a.name}: card vs CPU params after {n_steps} steps: {param_abs} "
          f"(moved {moved})")
    check(remat_losses == card,
          f"{cfg_a.name}: remat changed the losses: {remat_losses} vs {card}")
    part = {"arch": cfg_a.name, "dtype": "float32", "batch": stream.batch,
            "tokens": stream.seq_len, "steps": n_steps, "optimizer": LM_TRAIN_OPT,
            "card_losses": card, "cpu_losses": cpu, "max_loss_rel_err": loss_rel,
            "params_max_abs_err": param_abs, "params_moved": moved,
            "params_all_held_to_tol": hold_all,
            "remat_losses_bitwise": remat_losses == card,
            "remat_params_bitwise": _trees_equal(remat_p, card_p),
            "launches": launched()}
    if grads is not None:
        part.update(grads.fields(), **grads.params(card_p, cpu_p))
        check(part["grads_max_leaf_rel_err"] <= LM_TRAIN_TOL,
              f"{cfg_a.name}: card vs CPU gradient of {part['grads_worst_leaf']}: "
              f"{part['grads_max_leaf_rel_err']}")
        ocfg = AdamWConfig(**LM_TRAIN_OPT)
        part["params_drift_bound"] = 2.002 * sum(
            float(cosine_lr(ocfg, torch.tensor(t))) for t in range(1, n_steps + 1))
        check(hold_all or (part["params_over_tol"] <= TRAIN_FAMILIES_MAX_OVER_TOL_SHARE
                           * part["params_numel"]
                           and param_abs <= part["params_drift_bound"]),
              f"{cfg_a.name}: card vs CPU params: {part['params_over_tol']} of "
              f"{part['params_numel']} past {LM_TRAIN_TOL}, {param_abs} apart "
              f"(bound {part['params_drift_bound']})")
    check(not part["launches"], f"{cfg_a.name}: the (a) steps launched {part['launches']}")
    return part


def phase_lm_train(kernels, smi):
    """LM training on the card, every kernel's count at 0 before each
    part: (a) the reduced float32 qwen2's steps on the card against the
    CPU's from the same weights and batches, and with remat on against off;
    (b) qwen2-0.5b at full width through train_loop, with its losses, grad
    norms, step ms, tokens/s, peak memory and one step's device busy time;
    (c) crash and resume against an uninterrupted run, with the
    checkpoint's bytes and save seconds; (d) the CLI twice, the second
    resuming.  No part may launch a kernel.  Returns the launches of every
    kernel over (a)–(c) (the CLI's are its own processes') and (b)'s
    losses."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import train_loop
    from repro_torch.models.attention import chunked_attention
    from repro_torch.train import AdamWConfig, adamw_apply, make_train_step
    from repro_torch.tree import leaves, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    for kern in kernels.values():
        kern.launches = 0
    launched = lambda: {n: k.launches for n, k in kernels.items() if k.launches}  # noqa: E731

    # (a) the card against the CPU, and remat on against off
    B, L, n_steps = LM_TRAIN_XCHECK
    cfg_a = dataclasses.replace(reduced_config(get_arch(LM_ARCH)), dtype="float32",
                                remat=False)
    part_a = _train_card_vs_cpu(cfg_a, TokenStream(cfg_a.vocab, B, L, seed=0), n_steps,
                                launched)

    # (b) full width through train_loop
    cfg_b = get_arch(LM_ARCH)
    B, L, n_steps = LM_TRAIN_FULL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_loop(cfg_b, steps=n_steps, batch=B, seq_len=L, device="cuda",
                       log_every=1)
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms, step_s = state["losses"], state["grad_norms"], state["step_s"]
    check(len(losses) == n_steps and all(map(math.isfinite, losses + gnorms)),
          f"full-width losses {losses}, grad norms {gnorms}")
    launches_b = launched()
    check(not launches_b, f"full-width training launched {launches_b}")
    step_ms = float(np.median(step_s[1:])) * 1e3
    n_params = sum(t.numel() for t in leaves(state["params"]))
    flops = lm_train_flops(cfg_b, B, L)
    # one more step of the same function on the trained state, under the
    # profiler: the device's busy time in a step
    step_fn = make_train_step(cfg_b, AdamWConfig(total_steps=n_steps))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             TokenStream(cfg_b.vocab, B, L, seed=0).batch_at(n_steps).items()}
    busy_ms, top, n_kernels = device_busy(
        lambda: step_fn(state["params"], state["opt"], batch), top=12)
    check(not launched(), "the profiled step launched a kernel")
    # where a step's device time goes: the optimizer alone (zero grads of
    # the params' dtypes), and one layer's plain attention at the step's
    # shape, forward and forward + backward (a step runs a layer's forward
    # once, then with remat its forward again and its backward)
    ocfg = AdamWConfig(total_steps=n_steps)
    zero = tree_map(torch.zeros_like, state["params"])
    opt_ms = device_ms(lambda: adamw_apply(ocfg, zero, state["opt"], state["params"]), 2)[0]
    del zero
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((B, h, L, cfg_b.hd), generator=gen, device="cuda",
                           dtype=torch.bfloat16).requires_grad_(True)
               for h in (cfg_b.n_heads, cfg_b.n_kv_heads, cfg_b.n_kv_heads))
    attend = lambda: chunked_attention(  # noqa: E731
        q, k, v, q_chunk=cfg_b.attn_q_chunk, k_chunk=cfg_b.attn_k_chunk, impl="torch")
    attn_fwd_ms = device_ms(attend, 3)[0]
    attn_fb_ms = device_ms(lambda: attend().backward(torch.ones_like(q)), 3)[0]
    del q, k, v
    check(not launched(), "the breakdown launched a kernel")
    state_bytes = {key: sum(t.numel() * t.element_size() for t in leaves(state[key]))
                   for key in ("params", "opt")}
    part_b = {"arch": cfg_b.name, "dtype": cfg_b.dtype, "remat": cfg_b.remat,
              "batch": B, "tokens": L, "steps": n_steps, "params": n_params,
              "losses": losses, "first_loss": losses[0], "ln_vocab": math.log(cfg_b.vocab),
              "grad_norms": gnorms, "step_s": step_s, "loop_s": loop_s,
              "median_step_ms_2_to_last": step_ms,
              "tokens_per_s": B * L / (step_ms / 1e3),
              "step_flops": flops["step"], "remat_recompute_flops": flops["remat_recompute"],
              "model_flops_6nd": 6 * n_params * B * L,
              "bound_ms": flops["step"] / BF16_FLOP_PER_S * 1e3,
              "model_flops_utilization": flops["step"] / (step_ms / 1e3) / BF16_FLOP_PER_S,
              "peak_memory_bytes": peak, "state_bytes": state_bytes,
              "profiled_step_device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / step_ms,
              "profiled_step_device_kernels": n_kernels,
              "device_top_ms_calls": top,
              "optimizer_device_ms": opt_ms,
              "attention_layer_forward_device_ms": attn_fwd_ms,
              "attention_layer_forward_backward_device_ms": attn_fb_ms,
              "attention_step_device_ms": cfg_b.n_layers * (
                  attn_fwd_ms + (attn_fb_ms if cfg_b.remat else attn_fb_ms - attn_fwd_ms)),
              "launches": launches_b}
    del state, step_fn, batch
    torch.cuda.empty_cache()

    # (c) crash and resume against an uninterrupted run
    cfg_c = reduced_config(get_arch(LM_ARCH), **LM_TRAIN_SMALL)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        tmp = pathlib.Path(tmp)
        ref = train_loop(cfg_c, ckpt_dir=str(tmp / "ref"), device="cuda",
                         log_every=100, **LM_TRAIN_RESUME)
        crashy = train_loop(cfg_c, ckpt_dir=str(tmp / "crash"), fail_at=LM_TRAIN_FAIL_AT,
                            device="cuda", log_every=100, **LM_TRAIN_RESUME)
        close = all(torch.allclose(a.float(), b.float(), rtol=LM_TRAIN_RESUME_RTOL,
                                   atol=LM_TRAIN_RESUME_ATOL)
                    for a, b in zip(leaves(ref["params"]), leaves(crashy["params"])))
        check(close and crashy["step"] == ref["step"] == LM_TRAIN_RESUME["steps"],
              f"resumed params differ from the uninterrupted run's beyond rtol "
              f"{LM_TRAIN_RESUME_RTOL} / atol {LM_TRAIN_RESUME_ATOL}")
        shard = next((tmp / "crash" / f"step_{LM_TRAIN_RESUME['steps']:08d}").glob("host_0.*"))
        final = {"params": crashy["params"], "opt": crashy["opt"], "step": crashy["step"]}
        t0 = time.perf_counter()
        CheckpointManager(tmp / "timed", async_save=False).save(1, final)
        save_s = time.perf_counter() - t0
        mgr = CheckpointManager(tmp / "async")
        t0 = time.perf_counter()
        mgr.save(1, final)
        async_return_s = time.perf_counter() - t0
        mgr.wait()
        t0 = time.perf_counter()
        back = mgr.restore(1, final)
        restore_s = time.perf_counter() - t0
        check(_trees_equal(back["params"], final["params"])
              and _trees_equal(back["opt"], final["opt"]),
              "a checkpoint of the card's state did not restore bitwise")
        part_c = {"arch": cfg_c.name, "config": LM_TRAIN_SMALL, "dtype": cfg_c.dtype,
                  "remat": cfg_c.remat, **LM_TRAIN_RESUME, "fail_at": LM_TRAIN_FAIL_AT,
                  "losses": ref["losses"], "replayed_losses": crashy["losses"],
                  "params_bitwise": _trees_equal(ref["params"], crashy["params"]),
                  "opt_bitwise": _trees_equal(ref["opt"], crashy["opt"]),
                  "params_max_abs_err": _max_abs(ref["params"], crashy["params"]),
                  "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
                  "checkpoint_file": shard.name, "checkpoint_bytes": shard.stat().st_size,
                  "state_bytes": sum(t.numel() * t.element_size() for t in
                                     leaves([final["params"], final["opt"]])),
                  "save_s": save_s, "async_save_return_s": async_return_s,
                  "restore_s": restore_s, "launches": launched()}
    check(not part_c["launches"], f"crash and resume launched {part_c['launches']}")
    launches = {name: kern.launches for name, kern in kernels.items()}

    # (d) the CLI, then again with more steps: it resumes
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    cli = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        for steps in (3, 5):
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
                   "--reduced", "--steps", str(steps), "--ckpt-dir", tmp]
            t0 = time.perf_counter()
            out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                                 timeout=LM_TRAIN_CLI_TIMEOUT_S)
            cli.append({"args": cmd[3:], "rc": out.returncode,
                        "seconds": time.perf_counter() - t0,
                        "stdout_tail": out.stdout.strip().splitlines()[-3:]})
            check(out.returncode == 0 and "device=cuda" in out.stdout,
                  f"the train CLI ({steps} steps) exited {out.returncode}:\n"
                  f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
        check("[train] resumed from step 3" in out.stdout,
              "the second CLI run did not resume from step 3")
        cli_files = sorted(p.name for p in pathlib.Path(tmp).glob("step_*/host_0.*"))
    emit("lm_train", a_card_vs_cpu=part_a, b_full_width=part_b, c_crash_resume=part_c,
         d_cli={"runs": cli, "checkpoint_files": cli_files}, device=smi,
         seconds=time.perf_counter() - t_phase)
    return launches, part_b["losses"]


@contextlib.contextmanager
def fed_batches():
    """The shapes of every batch that ``train_loop`` feeds its step
    function, recorded while the context is open."""
    from repro_torch.launch import train as train_mod
    make, shapes = train_mod.make_train_step, []

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def fed(p, o, b):
            shapes.append({k: list(v.shape) for k, v in b.items()})
            return step(p, o, b)
        return fed
    train_mod.make_train_step = recording
    try:
        yield shapes
    finally:
        train_mod.make_train_step = make


def ssd_train_ms(cfg, B: int, L: int, reps: int = 2) -> dict:
    """Host ms of one layer's SSD chunk loop (``_mamba2_ssd_chunked``) at
    (B, L) as a train step with remat runs it: its forward recording
    autograd (the checkpointed forward, whose saved tensors are dropped),
    then forward and backward (the recompute and the backward), each to
    its last kernel's end, on inputs of the model's ranges (ssm_scan_ms's).
    Host ms, not CUDA events: a forward and backward queue more kernels
    than the launch queue holds, so the device waits on the host and an
    event pair would time the host."""
    import torch
    from repro_torch.models import ssm
    g = torch.Generator(device="cuda").manual_seed(1)
    H, P, s = cfg.ssm_heads, cfg.mamba_headdim, cfg.ssm_state

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    delta = torch.nn.functional.softplus(randn(B, L, H))
    args = [t.requires_grad_(True) for t in (
        torch.exp(-delta), randn(B, L, H, P) * delta[..., None], randn(B, L, s),
        randn(B, L, s))]

    def forward():
        return ssm._mamba2_ssd_chunked(*args, cfg.ssm_chunk)

    def wall_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps
    out = {"chunks_per_layer": -(-L // cfg.ssm_chunk), "forward_host_ms": wall_ms(forward),
           "forward_backward_host_ms": wall_ms(lambda: forward().sum().backward())}
    del args
    torch.cuda.empty_cache()
    return out


def family_card_vs_cpu(arch: str, launched) -> dict:
    """lm_train_families (a) for one arch: full width at TRAIN_FAMILIES_LAYERS'
    depth, float32, the card against the CPU with each step's gradients
    compared (``_train_card_vs_cpu`` with ``signs``).  An arch in
    TRAIN_FAMILIES_SIGN_NOISE has its params held at full width where no
    gradient sign flipped, and all of them at the reduced width, at the
    same depth."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch, reduced_config
    from repro_torch.data import TokenStream
    B, L, n_steps = TRAIN_FAMILIES_XCHECK

    def run(cfg_a, hold_all):
        stream = TokenStream(cfg_a.vocab, B, L, seed=0, n_codebooks=cfg_a.n_codebooks)
        part = _train_card_vs_cpu(cfg_a, stream, n_steps, launched, signs=True,
                                  hold_all=hold_all)
        part.update(n_layers=cfg_a.n_layers, d_model=cfg_a.d_model,
                    token_shape=list(stream.batch_at(0)["tokens"].shape),
                    shared_block_uses=(cfg_a.n_layers // cfg_a.attn_every
                                       if cfg_a.attn_every else 0))
        torch.cuda.empty_cache()
        return part

    layers = TRAIN_FAMILIES_LAYERS[arch]
    noisy = arch in TRAIN_FAMILIES_SIGN_NOISE
    part_a = run(dataclasses.replace(get_arch(arch), n_layers=layers, dtype="float32",
                                     remat=False), hold_all=not noisy)
    if noisy:
        part_a["reduced_width"] = run(reduced_config(
            get_arch(arch), n_layers=layers, dtype="float32", remat=False), True)
    return part_a


def family_full_width(arch: str, launched) -> dict:
    """lm_train_families (b) for one arch: full width and depth in bf16
    with remat through ``train_loop``."""
    import dataclasses
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch.train import train_loop
    from repro_torch.train import AdamWConfig, make_train_step
    from repro_torch.tree import leaves
    cfg_b = dataclasses.replace(get_arch(arch), remat=True)
    B, L, n_steps = TRAIN_FAMILIES_FULL
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with fed_batches() as shapes:
        state = train_loop(cfg_b, steps=n_steps, batch=B, seq_len=L, device="cuda",
                           log_every=1)
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, gnorms, step_s = state["losses"], state["grad_norms"], state["step_s"]
    check(len(losses) == n_steps and all(map(math.isfinite, losses + gnorms)),
          f"{arch} at full width: losses {losses}, grad norms {gnorms}")
    grid = [B, L, cfg_b.n_codebooks] if cfg_b.n_codebooks else [B, L]
    check(len(shapes) == n_steps and all(b == {"tokens": grid, "targets": grid}
                                         for b in shapes),
          f"{arch}: train_loop fed {shapes}, not {n_steps} batches of {grid}")
    step_ms = float(np.median(step_s[1:])) * 1e3
    n_params = sum(t.numel() for t in leaves(state["params"]))
    state_bytes = {key: sum(t.numel() * t.element_size() for t in leaves(state[key]))
                   for key in ("params", "opt")}
    step_fn = make_train_step(cfg_b, AdamWConfig(total_steps=n_steps))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in TokenStream(
        cfg_b.vocab, B, L, seed=0, n_codebooks=cfg_b.n_codebooks).batch_at(n_steps).items()}
    t0 = time.perf_counter()
    busy_ms, top, n_kernels = device_busy(
        lambda: step_fn(state["params"], state["opt"], batch), top=12)
    profile_s = time.perf_counter() - t0
    part_b = {"arch": arch, "dtype": cfg_b.dtype, "remat": cfg_b.remat,
              "n_layers": cfg_b.n_layers, "d_model": cfg_b.d_model, "batch": B,
              "tokens": L, "token_shape": grid, "steps": n_steps, "params": n_params,
              "param_count_config": cfg_b.param_count(),
              "losses": losses, "ln_vocab": math.log(cfg_b.vocab), "grad_norms": gnorms,
              "step_s": step_s, "loop_s": loop_s, "median_step_ms_2_to_last": step_ms,
              "tokens_per_s": B * L / (step_ms / 1e3),
              "model_flops_6nd": 6 * n_params * B * L,
              "model_flops_6nd_bound_ms": 6 * n_params * B * L / BF16_FLOP_PER_S * 1e3,
              "peak_memory_bytes": peak, "state_bytes": state_bytes,
              "state_bytes_predicted_16_per_param": 16 * n_params,
              "profiled_step_device_busy_ms": busy_ms,
              "device_busy_share": busy_ms / step_ms,
              "profiled_step_device_kernels": n_kernels, "device_top_ms_calls": top,
              "profile_s": profile_s}
    del state, step_fn, batch
    torch.cuda.empty_cache()
    if cfg_b.family == "hybrid":
        t0 = time.perf_counter()
        ssd = ssd_train_ms(cfg_b, B, L)
        ssd["seconds"] = time.perf_counter() - t0
        per_layer = ssd["forward_host_ms"] + ssd["forward_backward_host_ms"]
        part_b["ssd_loop"] = {**ssd, "layers": cfg_b.n_layers,
                              "step_host_ms": cfg_b.n_layers * per_layer,
                              "step_host_share": cfg_b.n_layers * per_layer / step_ms}
    part_b["launches"] = launched()
    check(not part_b["launches"], f"{arch}: full-width training launched "
                                  f"{part_b['launches']}")
    torch.cuda.empty_cache()
    return part_b


def phase_lm_train_families(kernels, smi) -> dict:
    """Training of the SSM-hybrid and audio families on the card, for each
    of TRAIN_FAMILIES: (a) at full width and a cut depth in float32, three
    steps on the card against the CPU from the same weights and batches,
    and remat on against off; (b) at full width and depth in bf16 with remat
    through train_loop, with its losses, grad norms, fed batches' shapes,
    step ms, tokens/s, peak memory, one step's device busy time and top
    kernels, and for zamba2 the SSD loop's share of a step.  No part may
    launch a kernel (training takes the plain attention: kernel 8 is
    forward only).  Returns every kernel's launches (0)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    launched = lambda: {n: k.launches for n, k in kernels.items() if k.launches}  # noqa: E731
    out = {}
    for arch in TRAIN_FAMILIES:
        t_arch, parts = time.perf_counter(), {}
        for part, run_part in (("a_card_vs_cpu", family_card_vs_cpu),
                               ("b_full_width", family_full_width)):
            for kern in kernels.values():
                kern.launches = 0
            parts[part] = run_part(arch, launched)
        out[arch] = {**parts, "seconds": time.perf_counter() - t_arch}
    emit("lm_train_families", **out, device=smi, seconds=time.perf_counter() - t_phase)
    return {name: kern.launches for name, kern in kernels.items()}


def _pct(xs, q) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def serve_split(answers) -> dict:
    """p50 of each part of the requests' time, in ms, from the server's
    own traces (``repro_torch.obs``): the client's wall clock, the server's
    root span (decode to reply), the query's time from enqueue to answer
    (the batching window and the fused dispatch), and the fused dispatch's
    ``ops.dispatch`` span (upload, kernel, copy back)."""
    import numpy as np
    from repro_torch import obs
    parts = {"wall": [], "server": [], "queued": [], "dispatch": []}
    for _, dt, _, tid in answers:
        doc = obs.TRACER.get(tid, wait_s=1.0)
        if doc is None:
            continue
        spans = doc["spans"] + [sp for t in doc.get("linked_traces", ())
                                for sp in t["spans"]]
        by_name = {sp["name"]: sp["duration_us"] / 1e3 for sp in spans}
        parts["wall"].append(dt * 1e3)
        parts["server"].append(doc["duration_us"] / 1e3)
        parts["queued"].append(by_name.get("query.scheduler_wait", 0.0))
        parts["dispatch"].append(by_name.get("ops.dispatch", 0.0))
    return {k: float(np.median(v)) if v else None
            for k, v in parts.items()} | {"traced": len(parts["wall"])}


def serve_plan():
    """Each of SERVE_CLIENTS clients' requests (SERVE_SINGLES single-tree
    queries with a batch of SERVE_T trees after each half), and the tree
    maker (64 leaves, rng seed 1) that drew them, for further requests."""
    import numpy as np
    from repro_torch.core import random_tree_segmentation
    n, m = SERVE_SIGNAL["n"], SERVE_SIGNAL["m"]
    rng = np.random.default_rng(1)

    def trees(t):
        segs = [random_tree_segmentation(n, m, 64, rng) for _ in range(t)]
        return (np.stack([q.rects for q in segs]),
                np.stack([q.labels for q in segs]))
    plan = [[("single", *[a[0] for a in trees(1)]) for _ in range(SERVE_SINGLES)]
            for _ in range(SERVE_CLIENTS)]
    for c in range(SERVE_CLIENTS):      # a batch after each half of the singles
        for j in range(SERVE_BATCHES):
            at = (j + 1) * (SERVE_SINGLES // SERVE_BATCHES) + j
            plan[c].insert(at, ("batch", *trees(SERVE_T)))
    return plan, trees


def client_traffic(base, plan):
    """One binary SDK client a thread, each sending its part of ``plan``
    to the server at ``base`` for ``slice1`` at (SERVE_K, SERVE_EPS), all
    started together.  Returns each client's (kind, seconds, response,
    trace id) and the traffic's seconds; any failure fails the run."""
    import threading
    from repro_torch.client import CoresetClient
    answers = [[] for _ in plan]
    errors = []
    barrier = threading.Barrier(len(plan))

    def client(c):
        mine = CoresetClient(base, encoding="binary", timeout=600, retries=0)
        try:
            barrier.wait(60)
            for kind, rects, labels in plan[c]:
                t0 = time.perf_counter()
                if kind == "single":
                    r = mine.query_loss("slice1", rects, labels,
                                        k=SERVE_K, eps=SERVE_EPS)
                else:
                    r = mine.query_loss_batch("slice1", rects, labels,
                                              k=SERVE_K, eps=SERVE_EPS)
                answers[c].append((kind, time.perf_counter() - t0, r,
                                   mine.last_trace_id))
        except Exception as exc:  # noqa: BLE001 - reported, then failed
            errors.append(f"client {c}: {type(exc).__name__}: {exc}")
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(plan))]
    t_traffic = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    traffic_s = time.perf_counter() - t_traffic
    check(not errors and all(not t.is_alive() for t in threads),
          f"query traffic failed: {errors}")
    return answers, traffic_s


def latencies(answers) -> dict:
    return {kind: [dt for c in answers for k, dt, _, _ in c if k == kind]
            for kind in ("single", "batch")}


# the numpy oracle's losses by (coreset fingerprint, trees): coreset_cluster
# serves coreset_serve's trees from the same coreset, so it reads them here
_ORACLE: dict = {}


def oracle_losses(cs, fingerprint: str, rects, labels):
    """(T,) numpy-oracle losses of (T, K, 4) trees on ``cs``, whose
    fingerprint is ``fingerprint``, computed once for each set of trees."""
    from repro_torch import ops
    key = (fingerprint, hashlib.sha256(rects.tobytes() + labels.tobytes()).hexdigest())
    if key not in _ORACLE:
        _ORACLE[key] = ops.fitting_loss_batched(cs, rects, labels, backend="numpy")
    return _ORACLE[key]


def served_worst(served, cs, built) -> float:
    """Every served (kind, rects, labels, response) against the numpy
    oracle on the served coreset ``cs``: each from ``built``'s coreset,
    each single scored on the card, every loss finite; the largest
    relative error, which must be within SERVE_TOL."""
    import numpy as np
    worst = 0.0
    for kind, rects, labels, r in served:
        check(r.fingerprint == built.fingerprint and r.eps_eff == built.eps_eff,
              "a query was served from another coreset")
        if kind == "single":
            check(r.backend == "cuda", f"a single query scored on {r.backend}")
            got = np.array([r.loss])
            want = oracle_losses(cs, built.fingerprint, rects[None], labels[None])
        else:
            got = r.losses
            want = oracle_losses(cs, built.fingerprint, rects, labels)
        check(got.shape == want.shape and np.isfinite(got).all(),
              "served losses not finite or of the wrong shape")
        worst = max(worst, float(rel_err(got, want).max()))
    check(worst <= SERVE_TOL, f"served losses vs the numpy oracle: {worst}")
    return worst


def phase_coreset_serve(kernels, smi):
    """The coreset server on the card: ``repro_torch.service`` behind its
    HTTP API, driven only through ``repro_torch.client`` with no backend
    pinned, every kernel's count at 0 just before it.  Every served loss
    against the numpy oracle on the served coreset; ``/v1/stats``'s backend
    counters; the launches of the kernels the path runs; one scoring call a
    fusion; the forest against one fitted on numpy; the streamed coreset
    against StreamingBuilder's over the same frames on numpy.  Returns the
    launches and the build's fingerprint and seconds, for the cluster."""
    import threading
    import numpy as np
    from repro_torch import ops
    from repro_torch.client import CoresetClient
    from repro_torch.core import StreamingBuilder
    from repro_torch.launch.serve_coresets import require_backends
    from repro_torch.service import (CoresetEngine, make_server,
                                     serve_forever_in_thread)
    from repro_torch.trees import RandomForestRegressor
    t_phase = time.perf_counter()
    backends = require_backends()
    check(set(backends.values()) == {"cuda"},
          f"the server would dispatch to {backends}")
    n, m = SERVE_SIGNAL["n"], SERVE_SIGNAL["m"]
    plan, trees = serve_plan()
    probe_single, probe_batch = [a[0] for a in trees(1)], trees(SERVE_T)
    inline = [a[0] for a in trees(1)]
    bands, _ = stream_frames()

    for kern in kernels.values():
        kern.launches = 0
    ops.reset_dispatch_counts()
    engine = CoresetEngine(workers=4)
    srv = make_server(engine)
    try:
        serve_forever_in_thread(srv)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        cl = CoresetClient(base, encoding="binary", timeout=600, retries=0)
        t0 = time.perf_counter()
        cl.register_signal("slice1", synthetic=SERVE_SIGNAL)
        register_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        built = cl.build("slice1", SERVE_K, SERVE_EPS)
        build_s = time.perf_counter() - t0
        check(built.served_from == "built", f"first build {built.served_from}")
        t0 = time.perf_counter()
        dom = cl.build("slice1", *SERVE_DOMINATED)
        dominated_s = time.perf_counter() - t0
        check(dom.served_from == "dominated" and dom.fingerprint == built.fingerprint,
              f"({SERVE_DOMINATED}) served {dom.served_from}")

        answers, traffic_s = client_traffic(base, plan)
        # the same singles from one client, one at a time
        alone_lat = []
        for kind, rects, labels in plan[0]:
            if kind == "single":
                t0 = time.perf_counter()
                cl.query_loss("slice1", rects, labels, k=SERVE_K, eps=SERVE_EPS)
                alone_lat.append(time.perf_counter() - t0)
        split = {kind: serve_split([a for c in answers for a in c if a[0] == kind])
                 for kind in ("single", "batch")}

        # the fusion probe: one single held in a longer window, then a batch
        # that pops its bucket (the bucket is full at max_fuse trees)
        calls0 = engine.metrics.get("loss_scoring_calls")
        engine.queries.window = SERVE_PROBE_S
        held = {}
        probe = threading.Thread(target=lambda: held.update(r=cl.query_loss(
            "slice1", *probe_single, k=SERVE_K, eps=SERVE_EPS)))
        probe.start()
        t_end = time.perf_counter() + SERVE_PROBE_S
        while engine.queries.in_flight() < 1 and time.perf_counter() < t_end:
            time.sleep(0.0005)
        fused = CoresetClient(base, encoding="binary", timeout=600,
                              retries=0).query_loss_batch(
            "slice1", *probe_batch, k=SERVE_K, eps=SERVE_EPS)
        probe.join(60)
        engine.queries.window = 0.002
        check(fused.fused_batch_size == SERVE_T + 1 and
              held["r"].fused_batch_size == SERVE_T + 1,
              f"the probe's batch rode with {fused.fused_batch_size} trees")
        check(engine.metrics.get("loss_scoring_calls") - calls0 == 1,
              "the probe's fusion took more than one scoring call")
        t0 = time.perf_counter()
        alone = cl.query_loss("slice1", *inline, k=SERVE_K, eps=SERVE_EPS,
                              coalesce=False)
        inline_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        fit = cl.fit("slice1", SERVE_K, SERVE_EPS, n_estimators=SERVE_FOREST,
                     predict=[[1, 1], [n // 2, m // 3], [n - 2, m - 2]])
        fit_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for b in bands:
            cl.ingest("stream", band=b)
        ingest_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        streamed = cl.build("stream", STREAM_K, STREAM_EPS)
        stream_build_s = time.perf_counter() - t0
        stats = cl.stats()
        launches = {name: kern.launches for name, kern in kernels.items()}
        dispatches = {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()}
        cs, _, how = engine.get_coreset("slice1", SERVE_K, SERVE_EPS)
        check(how == "exact" and cs.fingerprint() == built.fingerprint,
              "the served coreset left the cache")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()

    # ------------------------------------------------------------- checks
    counters = stats["metrics"]["counters"]
    by_backend = {b: counters.get(f"ops_backend_{b}", 0) for b in ops.BACKENDS}
    check(by_backend["cuda"] > 0 and by_backend["torch"] == 0
          and by_backend["numpy"] == 0, f"loss scoring by backend {by_backend}")
    check(counters["loss_scoring_calls"]
          == counters["query_fused_dispatches"] + 1,
          f"{counters['loss_scoring_calls']} scoring calls for "
          f"{counters['query_fused_dispatches']} fusions and one inline query")
    for name in ("sat_moments_f64", "fitting_loss_batched", "hist_f64_node"):
        check(launches[name] > 0, f"kernel {name} was not launched by the server")
    served = [(kind, rects, labels, r) for c in range(SERVE_CLIENTS)
              for (kind, rects, labels), (_, _, r, _) in zip(plan[c], answers[c])]
    served += [("single", *probe_single, held["r"]),
               ("batch", *probe_batch, fused),
               ("single", *inline, alone)]
    t0 = time.perf_counter()
    worst = served_worst(served, cs, built)
    oracle_s = time.perf_counter() - t0
    check(np.isfinite(fit.predictions).all() and fit.model_cache == "fit",
          "forest predictions not finite")
    X, y, w = cs.as_points()
    forest = RandomForestRegressor(n_estimators=SERVE_FOREST, max_leaves=SERVE_K,
                                   random_state=0, hist_backend="numpy")
    want_pred = forest.fit(X, y, sample_weight=w).predict(
        np.array([[1, 1], [n // 2, m // 3], [n - 2, m - 2]], np.float64))
    check(np.array_equal(fit.predictions, want_pred),
          "the served forest differs from the one fitted on numpy")
    with ops.backend_override("numpy"):
        sb = StreamingBuilder(m=STREAM_M, k=STREAM_K, eps=STREAM_EPS)
        for b in bands:
            sb.insert_band(b)
        one_shot = sb.result()
    check(streamed.served_from == "built"
          and streamed.fingerprint == one_shot.fingerprint(),
          "the streamed coreset differs from StreamingBuilder's on numpy")

    lat = latencies(answers)
    naturally_fused = sum(r.fused_batch_size > SERVE_T for c in answers
                          for kind, _, r, _ in c if kind == "batch")
    emit("coreset_serve", signal=SERVE_SIGNAL, k=SERVE_K, eps=SERVE_EPS,
         blocks=built.blocks, fingerprint=built.fingerprint,
         register_s=register_s, build_s=build_s,
         server_build_seconds=built.build_seconds,
         dominated={"k_eps": list(SERVE_DOMINATED), "ms": dominated_s * 1e3},
         traffic={"clients": SERVE_CLIENTS, "seconds": traffic_s,
                  "single": {"requests": len(lat["single"]),
                             "p50_ms": _pct(lat["single"], 50),
                             "p99_ms": _pct(lat["single"], 99),
                             "max_ms": max(lat["single"]) * 1e3,
                             "split_p50_ms": split["single"]},
                  "batch": {"requests": len(lat["batch"]), "trees": SERVE_T,
                            "p50_ms": _pct(lat["batch"], 50),
                            "p99_ms": _pct(lat["batch"], 99),
                            "max_ms": max(lat["batch"]) * 1e3,
                            "fused_with_singles": naturally_fused,
                            "split_p50_ms": split["batch"]},
                  "single_alone": {"requests": len(alone_lat),
                                   "p50_ms": _pct(alone_lat, 50),
                                   "p99_ms": _pct(alone_lat, 99)}},
         inline_single_ms=inline_s * 1e3,
         probe={"fused_batch_size": fused.fused_batch_size},
         max_rel_err=worst, oracle_s=oracle_s,
         fit={"trees": SERVE_FOREST, "seconds": fit_s,
              "train_size": fit.train_size, "bitwise_numpy": True},
         stream={"frames": len(bands), "ingest_s": ingest_s,
                 "build_s": stream_build_s, "blocks": streamed.blocks,
                 "eps_eff": streamed.eps_eff, "fingerprint": streamed.fingerprint},
         ops_backend=by_backend,
         scoring_calls=counters["loss_scoring_calls"],
         fused_dispatches=counters["query_fused_dispatches"],
         dispatches=dispatches, launches=launches, device=smi,
         seconds=time.perf_counter() - t_phase)
    return launches, {"fingerprint": built.fingerprint, "build_s": build_s,
                      "register_s": register_s,
                      **{kind: {"p50_ms": _pct(lat[kind], 50),
                                "p99_ms": _pct(lat[kind], 99)}
                         for kind in ("single", "batch")}}


class RoleProcess:
    """A ``serve_coresets --role ...`` process in a session of its own,
    with no backend pin in its environment; a thread drains its output and
    reads ``url`` and ``ops`` off its boot line."""

    def __init__(self, args):
        import re
        import threading
        self._boot_re = re.compile(
            r"listening on (http://[\d.]+:\d+).*ops on (\[[^\]]*\])")
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "REPRO_TORCH_OPS_BACKEND")}
        env["PYTHONPATH"] = str(ROOT / "src")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve_coresets", *args],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, bufsize=1,
            start_new_session=True)
        self.lines, self.url, self.ops = [], None, None
        self._booted = threading.Event()
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line)
            m = self._boot_re.search(line)
            if m and self.url is None:
                self.url, self.ops = m.group(1), m.group(2)
                self._booted.set()
        self._booted.set()

    def wait(self, timeout: float) -> str:
        self._booted.wait(timeout)
        check(self.url is not None,
              f"a role process did not boot (exit {self.proc.poll()}):\n"
              + "".join(self.lines[-40:]))
        return self.url

    def stop(self) -> None:
        """SIGTERM to its session, SIGKILL after 10 s."""
        import signal
        for sig in (signal.SIGTERM, signal.SIGKILL):
            if self.proc.poll() is not None:
                break
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, sig)
            with contextlib.suppress(subprocess.TimeoutExpired):
                self.proc.wait(10)
        check(self.proc.poll() is not None, "a role process outlived SIGKILL")


def worker_metrics(url: str) -> dict:
    """A worker's unlabelled series from its ``/v1/metrics``."""
    import urllib.request
    with urllib.request.urlopen(url + "/v1/metrics", timeout=60) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if line and not line.startswith("#") and "{" not in name:
            out[name] = float(value)
    return out


def _hist_sum(metrics, name: str) -> float:
    h = metrics.snapshot()["latency"].get(name)
    return h["count"] * h["mean_s"] if h else 0.0


def phase_coreset_cluster(kernels, smi, serve):
    """The distributed serving plane on the card: CLUSTER_WORKERS worker
    processes (``serve_coresets --role worker``, unpinned, each on an
    ephemeral port) and a ``ClusterEngine`` coordinator in this process
    behind the HTTP API, one band a worker, driven through the binary SDK
    with every kernel's count at 0 just before it.  Slice 1's signal is
    registered as the synthetic spec (the coordinator scatters the bands)
    and built; the coreset must be ``coreset_serve``'s (``serve``: its
    fingerprint, build seconds and latencies).  Then ``coreset_serve``'s
    query traffic and one uncoalesced single, each loss against the numpy
    oracle; a delta across a band boundary, forwarded to the two workers
    it touches, the rebuild equal to single-host ``sharded_coreset`` of the
    patched signal on the card; a worker terminated (the same coreset from
    a degraded build) and restarted empty on its port (the same coreset,
    healed through no_band).  Every role process is stopped in ``finally``.
    Returns the launches in this process (the workers' are in theirs)."""
    import numpy as np
    import torch
    from repro_torch import ops
    from repro_torch.client import CoresetClient
    from repro_torch.cluster import ClusterEngine
    from repro_torch.core import sharded_coreset
    from repro_torch.service import make_server, serve_forever_in_thread
    t_phase = time.perf_counter()
    plan, trees = serve_plan()
    inline = [a[0] for a in trees(1)]
    r0, r1 = CLUSTER_DELTA
    patch = np.random.default_rng(2).normal(size=(r1 - r0, SERVE_SIGNAL["m"]))
    workers, engine, srv = [], None, None
    try:
        t0 = time.perf_counter()
        workers = [RoleProcess(["--role", "worker", "--host", "127.0.0.1",
                                "--port", "0", "--worker-id", f"cw{i}"])
                   for i in range(CLUSTER_WORKERS)]
        peers = [w.wait(600) for w in workers]
        boot_s = time.perf_counter() - t0
        check(all(w.ops == "['cuda']" for w in workers),
              f"the workers dispatch to {[w.ops for w in workers]}")

        for kern in kernels.values():
            kern.launches = 0
        ops.reset_dispatch_counts()
        engine = ClusterEngine(peers, workers=4, reprobe_s=CLUSTER_REPROBE_S,
                               rpc_timeout=600.0)
        check(engine.num_bands == CLUSTER_WORKERS, "not one band a worker")
        probe = engine.probe_workers(timeout=60)
        check(all(h.get("role") == "worker" for h in probe.values()),
              f"worker probe: {probe}")
        srv = make_server(engine)
        serve_forever_in_thread(srv)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        cl = CoresetClient(base, encoding="binary", timeout=600, retries=0)
        met = engine.metrics

        t0 = time.perf_counter()
        cl.register_signal("slice1", synthetic=SERVE_SIGNAL)
        register_s = time.perf_counter() - t0
        check(met.get("cluster_bands_scattered") == CLUSTER_WORKERS,
              f"{met.get('cluster_bands_scattered')} bands scattered")
        t0 = time.perf_counter()
        built = cl.build("slice1", SERVE_K, SERVE_EPS)
        build_s = time.perf_counter() - t0
        gather_s = _hist_sum(met, "cluster_gather")
        check(built.served_from == "built"
              and built.fingerprint == serve["fingerprint"],
              "the cluster's coreset differs from coreset_serve's")
        check(met.get("cluster_gathers") == 1
              and met.get("cluster_degraded_builds") == 0,
              f"gathers {met.get('cluster_gathers')}, degraded "
              f"{met.get('cluster_degraded_builds')}")
        first = [worker_metrics(u) for u in peers]
        check(all(w.get("coreset_worker_band_builds") == 1 for w in first),
              "a worker did not build its band once")

        answers, traffic_s = client_traffic(base, plan)
        t0 = time.perf_counter()
        alone = cl.query_loss("slice1", *inline, k=SERVE_K, eps=SERVE_EPS,
                              coalesce=False)
        inline_s = time.perf_counter() - t0
        cs, _, how = engine.get_coreset("slice1", SERVE_K, SERVE_EPS)
        check(how == "exact" and cs.fingerprint() == built.fingerprint,
              "the served coreset left the cache")
        y = np.array(engine.signal("slice1").dense(), copy=True)

        # the write path: two workers take a band:delta, the re-cache build
        # (the BuildScheduler's) gathers once more
        gathers0 = _hist_sum(met, "cluster_gather")
        t0 = time.perf_counter()
        cl.ingest_delta("slice1", patch, row0=r0)
        delta_s = time.perf_counter() - t0
        t_end = time.perf_counter() + 600
        while engine.scheduler.in_flight():
            check(time.perf_counter() < t_end, "the re-cache build hung")
            time.sleep(0.01)
        recache_s = time.perf_counter() - t0
        recache_gather_s = _hist_sum(met, "cluster_gather") - gathers0
        check(met.get("cluster_deltas_forwarded") == 2,
              f"{met.get('cluster_deltas_forwarded')} deltas forwarded")
        applied = [int(worker_metrics(u).get("coreset_worker_deltas_applied",
                                             0)) for u in peers]
        check(applied == [1, 1, 0, 0], f"worker deltas applied: {applied}")
        check(met.get("cluster_gathers") == 2
              and sum(met.get(f'cluster_band_heals{{code="{c}"}}')
                      for c in ("no_band", "stale_band")) == 0,
              "the re-cache gather did not find every worker current")
        rebuilt = cl.build("slice1", SERVE_K, SERVE_EPS)
        check(rebuilt.served_from == "exact", f"rebuild {rebuilt.served_from}")

        # a worker terminated: its band degrades to a local build
        victim_url = peers[CLUSTER_VICTIM]
        workers[CLUSTER_VICTIM].stop()
        engine.cache.invalidate_signal("slice1", keep_version=None)
        t0 = time.perf_counter()
        degraded = cl.build("slice1", SERVE_K, SERVE_EPS)
        degraded_s = time.perf_counter() - t0
        check(degraded.fingerprint == rebuilt.fingerprint,
              "the degraded build's coreset differs")
        check(met.get("cluster_degraded_builds") == 1
              and met.get_gauge("cluster_worker_up", worker=victim_url) == 0.0,
              "the terminated worker was not degraded around")

        # restarted empty on the same port: the next build after the
        # cooldown heals it through no_band
        fresh = RoleProcess(["--role", "worker", "--host", "127.0.0.1",
                             "--port", victim_url.rsplit(":", 1)[1],
                             "--worker-id", f"cw{CLUSTER_VICTIM}b"])
        workers.append(fresh)
        check(fresh.wait(600) == victim_url and fresh.ops == "['cuda']",
              f"the restarted worker: {fresh.url}, ops on {fresh.ops}")
        time.sleep(CLUSTER_REPROBE_S)
        engine.cache.invalidate_signal("slice1", keep_version=None)
        t0 = time.perf_counter()
        rejoined = cl.build("slice1", SERVE_K, SERVE_EPS)
        rejoin_s = time.perf_counter() - t0
        check(rejoined.fingerprint == rebuilt.fingerprint,
              "the rejoined build's coreset differs")
        check(met.get("cluster_worker_rejoins") == 1
              and met.get('cluster_band_heals{code="no_band"}') == 1
              and met.get("cluster_degraded_builds") == 1
              and met.get_gauge("cluster_worker_up", worker=victim_url) == 1.0,
              "the restarted worker did not rejoin")
        check(worker_metrics(fresh.url).get("coreset_worker_band_builds") == 1,
              "the restarted worker did not build its band")
        launches = {name: kern.launches for name, kern in kernels.items()}
        dispatches = {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()}
        counters = met.snapshot()["counters"]
        stats = cl.stats()["cluster"]
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if engine is not None:
            engine.close()
        for w in workers:
            w.stop()

    by_backend = {b: counters.get(f"ops_backend_{b}", 0) for b in ops.BACKENDS}
    check(by_backend["cuda"] == counters["loss_scoring_calls"] > 0
          and by_backend["torch"] == 0 and by_backend["numpy"] == 0,
          f"{counters['loss_scoring_calls']} scoring calls by backend "
          f"{by_backend}")
    for name in ("sat_moments_f64", "sat_delta_f64", "fitting_loss",
                 "fitting_loss_batched"):
        check(launches[name] > 0, f"kernel {name} was not launched by the "
                                  f"coordinator")
    served = [(kind, rects, labels, r) for c in range(SERVE_CLIENTS)
              for (kind, rects, labels), (_, _, r, _) in zip(plan[c], answers[c])]
    served.append(("single", *inline, alone))
    t0 = time.perf_counter()
    worst = served_worst(served, cs, built)
    oracle_s = time.perf_counter() - t0
    # the patched signal's single-host band-parallel build on the card
    y[r0:r1] = patch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_host = sharded_coreset(y, SERVE_K, SERVE_EPS, num_bands=CLUSTER_WORKERS)
    one_host_s = time.perf_counter() - t0
    check(one_host.fingerprint() == rebuilt.fingerprint,
          "the patched cluster build differs from single-host sharded_coreset")

    lat = latencies(answers)
    emit("coreset_cluster", signal=SERVE_SIGNAL, k=SERVE_K, eps=SERVE_EPS,
         workers=CLUSTER_WORKERS, worker_ops=[w.ops for w in workers],
         worker_boot_s=boot_s, blocks=built.blocks,
         fingerprint=built.fingerprint,
         fingerprint_equals_coreset_serve=True,
         register_s=register_s, build_s=build_s,
         coreset_serve_build_s=serve["build_s"],
         coreset_serve_register_s=serve["register_s"],
         cluster_gather_s=gather_s,
         worker_band_build_s=[w.get("coreset_worker_band_build_seconds_sum")
                              for w in first],
         server_build_seconds=built.build_seconds,
         traffic={"clients": SERVE_CLIENTS, "seconds": traffic_s,
                  **{kind: {"requests": len(lat[kind]),
                            "p50_ms": _pct(lat[kind], 50),
                            "p99_ms": _pct(lat[kind], 99),
                            "max_ms": max(lat[kind]) * 1e3,
                            "coreset_serve_p50_ms": serve[kind]["p50_ms"],
                            "coreset_serve_p99_ms": serve[kind]["p99_ms"]}
                     for kind in ("single", "batch")}},
         inline_single_ms=inline_s * 1e3, max_rel_err=worst, oracle_s=oracle_s,
         delta={"rows": list(CLUSTER_DELTA), "request_s": delta_s,
                "recache_s": recache_s, "recache_gather_s": recache_gather_s,
                "forwarded": counters.get("cluster_deltas_forwarded"),
                "worker_deltas_applied": applied,
                "fingerprint": rebuilt.fingerprint,
                "single_host_sharded_coreset_s": one_host_s,
                "equals_single_host": True},
         degraded={"worker": victim_url, "build_s": degraded_s},
         rejoin={"build_s": rejoin_s, "fingerprint_kept": True},
         cluster_stats=stats,
         counters={k: v for k, v in counters.items()
                   if k.startswith(("cluster_", "loss_scoring", "ops_backend_"))},
         ops_backend=by_backend, dispatches=dispatches, launches=launches,
         device=smi, seconds=time.perf_counter() - t_phase)
    return launches


def rank_kernels() -> dict:
    """The kernels a mesh rank can launch, by their table names."""
    from repro_torch.kernels.fitting_loss import kernel as fk
    from repro_torch.kernels.histsplit import kernel as hk
    from repro_torch.kernels.sat2d import kernel as sk
    return {"sat_moments_f64": sk.SAT_MOMENTS_F64,
            "sat_moments_f32": sk.SAT_MOMENTS_F32,
            "sat_delta_f64": sk.SAT_DELTA_F64, "sat_delta_f32": sk.SAT_DELTA_F32,
            "sat_stack_f64": sk.SAT_STACK_F64, "sat_stack_f32": sk.SAT_STACK_F32,
            "fitting_loss": fk.FITTING_LOSS,
            "fitting_loss_batched": fk.FITTING_LOSS_BATCHED,
            "hist_f64_node": hk.HIST_F64_NODE}


def _sync_ms(fn, reps: int) -> float:
    """Host ms of one call of ``fn`` ending in a synchronise, after one."""
    import torch
    return host_ms(lambda: (fn(), torch.cuda.synchronize()), reps)


def _save_coreset(path, cs) -> None:
    import numpy as np
    d = cs.to_arrays()
    d["bicriteria"] = json.dumps(d["bicriteria"])
    np.savez(path, **d)


def _load_coreset(path):
    import numpy as np
    from repro_torch.core import SignalCoreset
    with np.load(path) as z:
        d = {key: z[key] for key in z.files}
    d["bicriteria"] = json.loads(str(d["bicriteria"]))
    return SignalCoreset.from_arrays(d)


def _batches():
    """coreset_serve's batches: each client's T = SERVE_T trees, in order."""
    plan, _ = serve_plan()
    return [(rects, labels) for c in plan for kind, rects, labels in c
            if kind == "batch"]


def _rank_duplicate(spec) -> dict:
    """Two NCCL ranks on the one card: the first collective must refuse."""
    import torch
    import torch.distributed as dist
    t = torch.ones(4, device="cuda")
    try:
        dist.all_reduce(t)
        torch.cuda.synchronize()
    except dist.DistBackendError as exc:
        return {"refused": True, "error": str(exc).splitlines()[-1]}
    return {"refused": False}


def _rank_one(spec) -> dict:
    """One NCCL rank: CoresetEngine(mesh=make_local_mesh(1)) on
    coreset_serve's signal and batches, then sat_pjit at the signal's size;
    the engine without a mesh on the same cached coreset; times.  Writes
    the coreset for the gloo ranks, and both engines' losses."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import ops
    from repro_torch.core import sat_pjit
    from repro_torch.core.sharded import MESH_BACKEND, fitting_loss_batched
    from repro_torch.data import piecewise_signal
    from repro_torch.kernels.sat2d import kernel as sk
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.service import CoresetEngine
    sig = SERVE_SIGNAL
    y = piecewise_signal(sig["n"], sig["m"], sig["k"], noise=0.15, seed=sig["seed"])
    y32 = y.astype(np.float32)
    batches = _batches()
    mesh = make_local_mesh(1)
    kernels = rank_kernels()
    for kern in kernels.values():
        kern.launches = 0
    engine = CoresetEngine(workers=4, mesh=mesh)
    plain = None
    try:
        t0 = time.perf_counter()
        engine.register_signal("slice1", y)
        cs, _, how = engine.get_coreset("slice1", SERVE_K, SERVE_EPS)
        build_s = time.perf_counter() - t0
        results = [engine.tree_loss_batch("slice1", r, lab, k=SERVE_K, eps=SERVE_EPS)
                   for r, lab in batches]
        images = sat_pjit(y32, mesh=mesh)
        torch.cuda.synchronize()
        launches = {name: kern.launches for name, kern in kernels.items()}
        counters = engine.metrics.snapshot()["counters"]
        _save_coreset(spec["coreset"], cs)

        # the engine without a mesh, on the same cached coreset
        plain = CoresetEngine(workers=4)
        plain.register_signal("slice1", y)
        entry, _ = engine.cache.lookup("slice1", engine.signal("slice1").version,
                                       SERVE_K, SERVE_EPS)
        plain.cache.put(entry)
        unmeshed = [plain.tree_loss_batch("slice1", r, lab, k=SERVE_K, eps=SERVE_EPS)
                    for r, lab in batches]
    finally:
        engine.close()
        if plain is not None:
            plain.close()
    got = np.stack([r["losses"] for r in results]).astype(np.float32)
    want = np.stack([r["losses"] for r in unmeshed]).astype(np.float32)
    np.savez(spec["losses"], mesh=got, one_device=want)
    one_device = sk.sat_moments_cuda(torch.as_tensor(y32, device="cuda"))
    local = images.to_local()
    sat_err = scaled_err(local.cpu().numpy(), one_device.cpu().numpy())
    sat_bitwise = bool(torch.equal(local, one_device))
    del one_device, local, images

    rects, labels = batches[0]
    part = torch.zeros(SERVE_T, device="cuda")
    return {
        "fingerprint": cs.fingerprint(), "how": how, "blocks": int(cs.num_blocks),
        "build_s": build_s, "launches": launches,
        "backends": sorted({r["backend"] for r in results}),
        "unmeshed_backends": sorted({r["backend"] for r in unmeshed}),
        "fused": sorted({r["fused_batch_size"] for r in results}),
        "counters": {k: v for k, v in counters.items()
                     if k.startswith(("loss_scoring", "ops_backend_", "query_fused"))},
        "bitwise_unmeshed": bool(np.array_equal(got, want)),
        "sat_bitwise": sat_bitwise, "sat_scaled_err": sat_err,
        "ms": {
            "scorer_mesh": host_ms(lambda: fitting_loss_batched(
                cs, rects, labels, mesh=mesh), MESH_REPS),
            "scorer_one_device": host_ms(lambda: ops.fitting_loss_batched(
                cs, rects, labels, backend="cuda"), MESH_REPS),
            "all_reduce_T": _sync_ms(lambda: dist.all_reduce(
                part, group=mesh.get_group("data")), 5 * MESH_REPS),
            "sat_pjit_mesh": _sync_ms(lambda: sat_pjit(y32, mesh=mesh), MESH_REPS),
            "sat_pjit_one_device": _sync_ms(lambda: sat_pjit(y32), MESH_REPS)},
        "mesh_backend": MESH_BACKEND, "nccl": torch.cuda.nccl.version()}


def _rank_gloo(spec) -> dict:
    """One of MESH_RANKS gloo ranks on the one card: the sharded scorer on
    coreset_serve's batches and sat_pjit at the signal's size, each rank's
    kernel on the card, then the checks and times; rank 0 writes its
    losses."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.core import sat_pjit
    from repro_torch.core.sharded import fitting_loss_batched
    from repro_torch.data import piecewise_signal
    from repro_torch.kernels.fitting_loss.ops import fitting_loss_batched as kernel
    from repro_torch.kernels.sat2d import kernel as sk
    from repro_torch.launch.mesh import compat_make_mesh
    sig = SERVE_SIGNAL
    n, m = sig["n"], sig["m"]
    y32 = piecewise_signal(n, m, sig["k"], noise=0.15,
                           seed=sig["seed"]).astype(np.float32)
    cs = _load_coreset(spec["coreset"])
    batches = _batches()
    mesh = compat_make_mesh((spec["world"],), ("data",))
    rank = dist.get_rank()
    kernels = rank_kernels()
    for kern in kernels.values():
        kern.launches = 0
    got = np.stack([fitting_loss_batched(cs, r, lab, mesh=mesh) for r, lab in batches])
    images = sat_pjit(y32, mesh=mesh)
    torch.cuda.synchronize()
    launches = {name: kern.launches for name, kern in kernels.items()}

    out = {"rank": rank, "fingerprint": cs.fingerprint(), "launches": launches,
           "local_rows": int(images.to_local().shape[1]),
           "losses_sha": hashlib.sha256(got.tobytes()).hexdigest()}
    # gloo moves host tensors only: gather the bands' host copies over a
    # CPU mesh of the same ranks
    host = DTensor.from_local(images.to_local().cpu(),
                              compat_make_mesh((spec["world"],), ("data",), "cpu"),
                              [Shard(1)], shape=images.shape,
                              stride=(n * m, m, 1)).full_tensor()
    del images
    if rank == 0:
        one_device = sk.sat_moments_cuda(torch.as_tensor(y32, device="cuda")).cpu()
        out["sat_bitwise"] = bool(torch.equal(host, one_device))
        out["sat_scaled_err"] = scaled_err(host.numpy(), one_device.numpy())
        del one_device
        np.save(spec["gloo_losses"], got)
        # a slab of padding blocks alone adds exactly nothing on the card
        zero = torch.zeros((1, 4), device="cuda")
        r, lab = batches[0]
        pad = kernel(zero, zero, zero, torch.as_tensor(r, dtype=torch.float32, device="cuda"),
                     torch.as_tensor(lab, dtype=torch.float32, device="cuda"))
        out["padding_only_zero"] = bool((pad == 0).all().item())
    del host
    dist.barrier()

    rects, labels = batches[0]
    part = torch.zeros(SERVE_T)
    carry = torch.zeros((3, m))
    world = spec["world"]

    def chain():
        if rank > 0:
            dist.recv(carry, src=rank - 1)
        if rank < world - 1:
            dist.send(carry, dst=rank + 1)
    ms = {}
    for key, fn, reps in (
            ("scorer_mesh", lambda: fitting_loss_batched(cs, rects, labels,
                                                         mesh=mesh), MESH_REPS),
            ("all_reduce_T_host", lambda: dist.all_reduce(part), 5 * MESH_REPS),
            ("carry_chain", chain, 5 * MESH_REPS),
            ("sat_pjit_mesh", lambda: sat_pjit(y32, mesh=mesh), MESH_REPS)):
        dist.barrier()
        ms[key] = _sync_ms(fn, reps)
    out["ms"] = ms
    return out


def mesh_rank(spec: dict) -> dict:
    """A rank of the coreset_mesh phase: its process group started from
    ``spec`` (backend, world, rank, store), then ``spec["part"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import transport
    if spec.get("device", "cuda") == "cuda":
        torch.cuda.set_device(0)
    if spec["backend"] == transport.BACKEND:
        transport.start_world("file://" + spec["store"], spec["world"], spec["rank"])
    else:
        dist.init_process_group(spec["backend"], init_method="file://" + spec["store"],
                                world_size=spec["world"], rank=spec["rank"])
    from repro_torch.launch.mesh import destroy_world
    try:
        return {"duplicate": _rank_duplicate, "one": _rank_one,
                "gloo": _rank_gloo, "train_dp": _rank_train_dp,
                "elastic": _rank_elastic, "train_tp": _rank_train_tp,
                "train_tp4": _rank_train_tp,
                "train_tp_cpu": _rank_train_tp}[spec["part"]](spec)
    finally:
        destroy_world()


def start_ranks(part: str, backend: str, world: int, tmp: pathlib.Path,
                env_extra=None, **extra):
    """``world`` processes of this script, each a rank of ``part`` in a
    session of its own, their group's store and their output files under
    ``tmp``, ``env_extra`` added to their environment."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "REPRO_TORCH_OPS_BACKEND")}
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    procs = []
    for r in range(world):
        spec = {"part": part, "backend": backend, "world": world, "rank": r,
                "store": str(tmp / f"{part}.store"), **extra}
        out, err = (tmp / f"{part}.{r}.out"), (tmp / f"{part}.{r}.err")
        with out.open("w") as fo, err.open("w") as fe:
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank",
                 json.dumps(spec)], cwd=ROOT, env=env, stdout=fo, stderr=fe,
                start_new_session=True), out, err))
    return procs


def finish_ranks(procs, what: str, timeout_s: float = MESH_TIMEOUT_S) -> list[dict]:
    """Each rank's result.  A rank that fails, or ranks that run over
    ``timeout_s`` from now, fail the run; every rank's session is killed
    once one has failed or all have ended."""
    import signal
    deadline = time.perf_counter() + timeout_s
    try:
        while any(p.poll() is None for p, _, _ in procs):
            if any(p.poll() not in (None, 0) for p, _, _ in procs):
                break
            check(time.perf_counter() < deadline,
                  f"the {what} ranks ran over {timeout_s} s")
            time.sleep(0.1)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    for r, (p, _, err) in enumerate(procs):
        check(p.returncode == 0, f"{what} rank {r} exited {p.returncode}:\n"
                                 f"{err.read_text()[-4000:]}")
    return [json.loads(out.read_text().strip().splitlines()[-1])
            for _, out, _ in procs]


def _kernel_counters() -> dict:
    """Every kernel wrapper by its name in the kernel table, in this
    process."""
    from repro_torch.kernels.fitting_loss import kernel as fl
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.histsplit import kernel as hk
    from repro_torch.kernels.sat2d import kernel as sk
    return {"sat_moments_f64": sk.SAT_MOMENTS_F64, "sat_moments_f32": sk.SAT_MOMENTS_F32,
            "fitting_loss": fl.FITTING_LOSS, "fitting_loss_batched": fl.FITTING_LOSS_BATCHED,
            "hist_f64": hk.HIST_F64, "hist_f64_node": hk.HIST_F64_NODE,
            "hist_fused_f32": hk.HIST_FUSED, "hist_partials_f32": hk.HIST_PARTIALS,
            "hist_legacy_f32": hk.HIST_LEGACY,
            "sat_delta_f64": sk.SAT_DELTA_F64, "sat_delta_f32": sk.SAT_DELTA_F32,
            "sat_stack_f64": sk.SAT_STACK_F64, "sat_stack_f32": sk.SAT_STACK_F32,
            "flash_attention_bf16": fa.FLASH_ATTENTION_BF16,
            "flash_attention_f32": fa.FLASH_ATTENTION_F32}


def _params_sha256(params) -> str:
    """sha256 of every parameter's bytes, leaf by leaf."""
    import torch
    from repro_torch.tree import leaves
    h = hashlib.sha256()
    for t in leaves(params):
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _save_params(path, params) -> None:
    import numpy as np
    from repro_torch.tree import flatten
    keys, ts = flatten(params)
    np.savez(path, **{k: t.detach().float().cpu().numpy() for k, t in zip(keys, ts)})


@contextlib.contextmanager
def _train_loop_optimizer(**opt):
    """train_loop's optimizer, AdamWConfig(total_steps=steps), replaced by
    AdamWConfig(**opt) while the context is open: lm_train_dp (b) and (c)
    train with LM_TRAIN_OPT, which moves the weights past the bar in
    LM_DP_LOOP's steps."""
    from repro_torch.launch import train as launch_train
    from repro_torch.train import AdamWConfig
    launch_train.AdamWConfig = lambda **_: AdamWConfig(**opt)
    try:
        yield
    finally:
        launch_train.AdamWConfig = AdamWConfig


def _dp_small_cfg():
    import dataclasses
    from repro_torch.configs import get_arch, reduced_config
    return dataclasses.replace(reduced_config(get_arch(LM_ARCH), **LM_DP_SMALL),
                               dtype="float32")


def _rank_train_dp(spec) -> dict:
    """A rank of lm_train_dp (a) and (b): full-width qwen2-0.5b over a
    (world, 1) mesh of gloo ranks on the card, then the reduced float32
    model straight for LM_DP_LOOP and again to LM_DP_SAVE_AT with a
    checkpoint."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.tree import leaves
    counters = _kernel_counters()
    for kern in counters.values():
        kern.launches = 0
    mesh = make_local_mesh(spec["world"], 1, device_type="cpu")
    cfg = get_arch(LM_ARCH)
    B, L, _ = LM_TRAIN_FULL
    torch.cuda.reset_peak_memory_stats()
    full = train_loop(cfg, steps=LM_DP_STEPS, batch=B, seq_len=L, mesh=mesh,
                      device="cuda", log_every=1)
    peak = torch.cuda.max_memory_allocated()
    opt_bytes = sum(t.numel() * t.element_size()
                    for k in ("master", "m", "v") for t in leaves(full["opt"][k]))
    n_params = sum(t.numel() for t in leaves(full["params"]))
    part_a = {"losses": full["losses"], "grad_norms": full["grad_norms"],
              "step_s": full["step_s"], "sync": full["sync"],
              "digest": _params_sha256(full["params"]),
              "peak_memory_bytes": peak, "opt_bytes": opt_bytes, "params": n_params,
              "local_rows": B // spec["world"], "backend": dist.get_backend()}
    del full
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_b = _dp_small_cfg()
    with _train_loop_optimizer(**LM_TRAIN_OPT):
        straight = train_loop(cfg_b, mesh=mesh, device="cuda", log_every=100,
                              **LM_DP_LOOP)
        if dist.get_rank() == 0:
            _save_params(spec["out"] + "/straight.npz", straight["params"])
        saved = train_loop(cfg_b, mesh=mesh, device="cuda", log_every=100,
                           ckpt_dir=spec["ckpt"], save_every=LM_DP_SAVE_AT,
                           **dict(LM_DP_LOOP, steps=LM_DP_SAVE_AT))
    part_b = {"losses": straight["losses"], "grad_norms": straight["grad_norms"],
              "digest": _params_sha256(straight["params"]),
              "saved_losses": saved["losses"], "sync": straight["sync"]}
    return {"full": part_a, "small": part_b, "coord": mesh.get_coordinate(),
            "launches": {n: k.launches for n, k in counters.items()}}


def _rank_elastic(spec) -> dict:
    """lm_train_dp (c), a world of one rank: plan_mesh(1, 1), the
    checkpoint through restore(shardings=) against the whole, and
    train_loop resuming from it to LM_DP_LOOP's last step."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train_loop
    from repro_torch.models import init_params
    from repro_torch.runtime import plan_mesh
    from repro_torch.sharding import state_shardings
    from repro_torch.train import adamw_init
    from repro_torch.tree import flatten
    counters = _kernel_counters()
    for kern in counters.values():
        kern.launches = 0
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dp_small_cfg()
    mesh = plan_mesh(1, 1, device_type="cpu")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    template = {"params": params, "opt": adamw_init(params), "step": 0}
    mgr = CheckpointManager(spec["ckpt"])
    whole = mgr.restore(LM_DP_SAVE_AT, template)
    at = state_shardings(cfg, mesh)
    part = mgr.restore(LM_DP_SAVE_AT, template, shardings=at)
    same = all(torch.equal(p, w if a is None else a.local(w)) if isinstance(p, torch.Tensor)
               else p == w for p, w, a in zip(flatten(part)[1], flatten(whole)[1],
                                              flatten(at)[1]))
    t0 = time.perf_counter()
    with _train_loop_optimizer(**LM_TRAIN_OPT):
        resumed = train_loop(cfg, mesh=mesh, device="cuda", log_every=100,
                             ckpt_dir=spec["ckpt"], save_every=LM_DP_LOOP["steps"],
                             **LM_DP_LOOP)
    _save_params(spec["out"] + "/resumed.npz", resumed["params"])
    return {"mesh": list(mesh.shape), "restore_bitwise": same,
            "restored_step": int(whole["step"]), "losses": resumed["losses"],
            "step": resumed["step"], "seconds": time.perf_counter() - t0,
            "launches": {n: k.launches for n, k in counters.items()}}


def _tp_moe_cfg():
    import dataclasses
    from repro_torch.configs import get_arch, reduced_config
    return dataclasses.replace(reduced_config(get_arch(LM_TP_MOE)), dtype="float32")


@contextlib.contextmanager
def _moe_probes():
    """While open, every MoE layer's routing and dispatch are watched: the
    smallest gap of a token's k-th over its (k+1)-th router probability
    (``margin``) and the picks dropped at capacity (``dropped`` of
    ``picks``)."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import moe
    route, dispatch = moe.route, moe.dispatch
    seen = {"margin": math.inf, "dropped": 0, "picks": 0}

    def routed(p, cfg, xt):
        probs, gates, experts = route(p, cfg, xt)
        loc = probs.to_local() if isinstance(probs, DTensor) else probs
        top = torch.topk(loc.detach(), cfg.moe_top_k + 1, dim=-1).values
        seen["margin"] = min(seen["margin"], float((top[:, -2] - top[:, -1]).min()))
        return probs, gates, experts

    def dispatched(*a, **k):
        h, meta = dispatch(*a, **k)
        keep = meta[3]
        seen["dropped"] += int((~keep).sum())
        seen["picks"] += keep.numel()
        return h, meta
    moe.route, moe.dispatch = routed, dispatched
    try:
        yield seen
    finally:
        moe.route, moe.dispatch = route, dispatch


def _whole_params(cfg, mesh, params):
    """A train_loop result's params, whole (the partitioned step's are
    DTensors: gathered, a collective)."""
    from repro_torch.sharding.dtensor import StateLayout
    from repro_torch.train.partitioned import partitioned
    return StateLayout(cfg, mesh).whole_params(params) if partitioned(cfg, mesh) else params


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import leaves
    return sum(t.to_local().numel() * t.to_local().element_size() if isinstance(t, DTensor)
               else t.numel() * t.element_size() for t in leaves(tree))


def _tp_full_width(spec) -> dict:
    """lm_train_tp (a) and (d) on this rank: qwen2-0.5b over LM_TP_MESH for
    LM_TP_STEPS steps, then a step counted as the dry run counts one."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    from repro_torch.train import AdamWConfig
    from repro_torch.train.partitioned import Partitioned
    from repro_torch.tree import leaves
    mesh = make_local_mesh(*LM_TP_MESH, device_type="cuda")
    cfg = get_arch(LM_ARCH)
    B, L, _ = LM_TRAIN_FULL
    torch.cuda.reset_peak_memory_stats()
    full = train_loop(cfg, steps=LM_TP_STEPS, batch=B, seq_len=L, mesh=mesh,
                      device="cuda", log_every=1)
    train_peak = torch.cuda.max_memory_allocated()
    part = Partitioned(cfg, mesh, "cuda")
    step = part.make_step(AdamWConfig(total_steps=LM_TP_STEPS))
    batch = part.batch(TokenStream(cfg.vocab, B, L, seed=0).batch_at(LM_TP_STEPS))
    args = (full["params"], full["opt"], batch)
    arg_bytes = _local_bytes(args)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() - arg_bytes
    torch.cuda.reset_peak_memory_stats()
    with dryrun.counting() as counter:
        out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    counted = {"argument_bytes": arg_bytes, "flops": float(counter.flops),
               "peak_bytes": peak, "loss": float(out[2]["loss"]),
               "by_kind": part.last_sync["by_kind"],
               "counter_collectives": dict(counter.collectives),
               "counter_calls": dict(counter.calls)}
    res = {"losses": full["losses"], "grad_norms": full["grad_norms"],
           "step_s": full["step_s"], "sync": full["sync"],
           "peak_memory_bytes": train_peak,
           "params_local": sum(t.to_local().numel() for t in leaves(full["params"])),
           "params": sum(t.numel() for t in leaves(full["params"])),
           "transport": part.transport, "counted_step": counted}
    del full, out, args, batch
    torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def _init_from(path):
    """train_loop's init replaced by the params in ``path`` (an npz of
    ``_save_params``) while the context is open: the CPU ranks of
    lm_train_tp (c) start from the card's init for seed 0."""
    import numpy as np
    import torch
    from repro_torch.launch import train as launch_train
    from repro_torch.models.model import param_shapes
    from repro_torch.tree import flatten, unflatten
    init = launch_train.init_params

    def load(cfg, gen):
        npz = np.load(path)
        shapes = param_shapes(cfg)
        keys, metas = flatten(shapes)
        return unflatten(shapes, [torch.as_tensor(npz[k]).to(gen.device, m.dtype)
                                  for k, m in zip(keys, metas)])
    launch_train.init_params = load
    try:
        yield
    finally:
        launch_train.init_params = init


def _tag(shape) -> str:
    return "x".join(map(str, shape))


def _rank_train_tp(spec) -> dict:
    """A rank of lm_train_tp: on the card, (a) and (d) where ``spec["full"]``
    (``_tp_full_width``); (b) the reduced float32 qwen2 over ``spec["small"]``
    straight for LM_DP_LOOP, and again to LM_DP_SAVE_AT with a checkpoint
    where ``spec["ckpt"]``; (c) the reduced float32 qwen3-moe over
    ``spec["moe"]``, on ``spec["device"]`` (the CPU ranks' run (c) only).
    Params of rank 0 written whole to ``spec["out"]``."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import train_loop
    counters = _kernel_counters()
    for kern in counters.values():
        kern.launches = 0
    dev = spec.get("device", "cuda")
    out = {}
    if spec.get("full"):
        t0 = time.perf_counter()
        out["full"] = _tp_full_width(spec)
        out["full"]["seconds"] = time.perf_counter() - t0
        if dist.get_rank() == 0:
            # the other groups may start: (a)'s timed steps are over
            pathlib.Path(spec["full_done"]).touch()
    torch.backends.cuda.matmul.allow_tf32 = False
    if spec.get("small"):
        mesh = make_local_mesh(*spec["small"], device_type=dev)
        cfg = _dp_small_cfg()
        with _train_loop_optimizer(**LM_TRAIN_OPT):
            straight = train_loop(cfg, mesh=mesh, device=dev, log_every=100, **LM_DP_LOOP)
            whole = _whole_params(cfg, mesh, straight["params"])
            if dist.get_rank() == 0:
                _save_params(f"{spec['out']}/small_{_tag(spec['small'])}.npz", whole)
            saved = None
            if spec.get("ckpt"):
                saved = train_loop(cfg, mesh=mesh, device=dev, log_every=100,
                                   ckpt_dir=spec["ckpt"], save_every=LM_DP_SAVE_AT,
                                   **dict(LM_DP_LOOP, steps=LM_DP_SAVE_AT))["losses"]
        out["small"] = {"losses": straight["losses"], "digest": _params_sha256(whole),
                        "saved_losses": saved, "sync": straight["sync"][-1]}
    if spec.get("moe"):
        mesh = make_local_mesh(*spec["moe"], device_type=dev)
        cfg = _tp_moe_cfg()
        with _train_loop_optimizer(**LM_TRAIN_OPT), _moe_probes() as seen, \
                _init_from(spec["moe_init"]):
            run = train_loop(cfg, mesh=mesh, device=dev, log_every=100, **LM_DP_LOOP)
        whole = _whole_params(cfg, mesh, run["params"])
        if dist.get_rank() == 0:
            tag = "cpu" if dev == "cpu" else _tag(spec["moe"])
            _save_params(f"{spec['out']}/moe_{tag}.npz", whole)
        out["moe"] = {"losses": run["losses"], "digest": _params_sha256(whole),
                      "margin": seen["margin"], "dropped": seen["dropped"],
                      "picks": seen["picks"], "sync": run["sync"][-1]}
    out["launches"] = {n: k.launches for n, k in counters.items()}
    return out


_DRYRUN_CELL = r'''
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import compat_make_mesh, fake_world
kind, arch = sys.argv[1], sys.argv[2]
if kind == "predict":
    B, L = int(sys.argv[3]), int(sys.argv[4])
    shape = tuple(int(x) for x in sys.argv[5:7]) if len(sys.argv) > 5 else (1, 1)
    with fake_world(shape[0] * shape[1]):
        mesh = compat_make_mesh(shape, ("data", "model"), device_type="cpu")
        _, low = dryrun.lower_cell(mesh, arch, "train_4k", microbatches=1,
                                   batch_override=(B, L))
    print(json.dumps(dryrun.analyze(low)))
else:
    import pathlib, tempfile
    from repro_torch.configs import get_arch
    period = get_arch(arch).attn_every or 1
    with tempfile.TemporaryDirectory() as tmp:
        rec = dryrun.run_cell(arch, "train_4k", "single", pathlib.Path(tmp),
                              costing=False, n_layers_override=period)
    print(json.dumps({"n_layers": period, **rec["full"],
                      "compile_seconds": rec["compile_seconds"]}))
'''


def _dryrun_child(*args):
    """A child process of the dry run (a fake world, CPU tensors only): the
    Popen, its JSON read by ``_dryrun_result``."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.Popen([sys.executable, "-c", _DRYRUN_CELL, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _dryrun_result(proc, what: str) -> dict:
    try:
        out, err = proc.communicate(timeout=LM_DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    check(proc.returncode == 0, f"the dry run's {what} exited {proc.returncode}:\n"
          f"{err[-3000:]}")
    return json.loads(out.strip().splitlines()[-1])


def _dryrun_cells() -> dict:
    """lm_dryrun (b)'s cells, one child process an arch, started."""
    return {a: _dryrun_child("cell", a) for a in LM_DRYRUN_CELLS}


def phase_lm_dryrun(kernels, smi, cells=None):
    """The dry run on the card's host: (a) its prediction of lm_train's step
    (qwen2-0.5b at full width, the 4 x 2048 batch in one microbatch,
    attn_impl="torch", remat as configured) on a (1, 1) fake mesh, held to
    the same step on the card: the argument bytes to the real state's and
    batch's exactly, the FLOPs to FlopCounterMode's over the real step
    exactly, the peak within LM_DRYRUN_PEAK_TOL of max_memory_allocated
    (less what was allocated before the state); (b) one train_4k cell a
    family on the 16 x 16 mesh of a fake world of 256 ranks, at its
    period's layers, each a process (``cells``: already started, else
    started here), its OK line with its per-rank peak.  No kernel may
    launch; every child is stopped on the way out."""
    t_phase = time.perf_counter()
    for kern in kernels.values():
        kern.launches = 0
    cells = cells or _dryrun_cells()
    try:
        _lm_dryrun(kernels, smi, cells, t_phase)
    finally:
        for proc in cells.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()


def _lm_dryrun(kernels, smi, cells, t_phase):
    """``phase_lm_dryrun``'s body, the cells' processes started."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from repro_torch.tree import leaves
    B, L, _ = LM_TRAIN_FULL
    predict = _dryrun_result(_dryrun_child("predict", LM_ARCH, str(B), str(L)),
                             "prediction")

    # (a) the same step on the card
    cfg = get_arch(LM_ARCH)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt = adamw_init(params)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (B, L), generator=gen, device="cuda",
                              dtype=torch.int32) for k in ("tokens", "targets")}
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves([params, opt, batch]))
    step = make_train_step(cfg, AdamWConfig())
    with FlopCounterMode(display=False) as fc:
        out = step(params, opt, batch)
    flops = fc.get_total_flops()
    del out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = step(params, opt, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(out[2]["loss"])
    del out, params, opt, batch
    torch.cuda.empty_cache()
    mem = predict["memory"]
    peak_rel = abs(mem["peak_hbm_estimate"] - peak) / peak
    print(f"lm_dryrun (a): argument bytes predicted {mem['argument_bytes']} card "
          f"{arg_bytes}; FLOPs predicted {predict['flops']:.6e} card {float(flops):.6e}; "
          f"peak predicted {mem['peak_hbm_estimate']} card {peak} "
          f"({peak_rel * 100:.2f} %)", flush=True)
    check(mem["argument_bytes"] == arg_bytes,
          f"predicted argument bytes {mem['argument_bytes']} != the card's {arg_bytes}")
    check(predict["flops"] == float(flops),
          f"predicted FLOPs {predict['flops']} != FlopCounterMode's {flops}")
    check(peak_rel <= LM_DRYRUN_PEAK_TOL,
          f"predicted peak {mem['peak_hbm_estimate']} vs the card's {peak}")
    check(math.isfinite(loss), f"the card's step gave the loss {loss}")
    part_a = {"arch": cfg.name, "batch": B, "tokens": L, "microbatches": 1,
              "remat": cfg.remat, "attn_impl": "torch",
              "predicted": {"argument_bytes": mem["argument_bytes"],
                            "flops": predict["flops"],
                            "peak_bytes": mem["peak_hbm_estimate"],
                            "temp_bytes": mem["temp_bytes"],
                            "output_bytes": mem["output_bytes"],
                            "seconds": predict["seconds"]},
              "card": {"argument_bytes": arg_bytes, "flops": float(flops),
                       "peak_bytes": peak, "step_s": step_s, "loss": loss},
              "peak_rel_err": peak_rel}

    # (b) one cell a family on the 16 x 16 mesh
    part_b = {}
    for arch, proc in cells.items():
        rec = _dryrun_result(proc, arch)
        gib = rec["memory"]["peak_hbm_estimate"] / 2**30
        print(f"OK   {arch} x train_4k x single (layers {rec['n_layers']}): peak/dev "
              f"~{gib:.2f} GiB, colls {rec['collectives']['total'] / 2**20:.1f} MiB, "
              f"{rec['compile_seconds']:.0f}s", flush=True)
        check(rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0,
              f"the dry run of {arch} counted nothing")
        part_b[arch] = {"n_layers": rec["n_layers"], "peak_gib": gib,
                        "flops": rec["flops"], "collectives": rec["collectives"],
                        "seconds": rec["compile_seconds"]}
    launches = {n: k.launches for n, k in kernels.items() if k.launches}
    check(not launches, f"the dry run's phase launched {launches}")
    seconds = time.perf_counter() - t_phase
    print(f"lm_dryrun: {seconds:.1f} s", flush=True)
    emit("lm_dryrun", a_prediction=part_a, b_cells=part_b, device=smi, seconds=seconds)


def phase_lm_train_dp(kernels, smi, one_rank_losses):
    """LM training over LM_DP_RANKS gloo ranks sharing the card (each a
    process of this script; this process starts no group): (a) full-width
    qwen2-0.5b, ZeRO-1; (b) the reduced float32 model against one rank on
    the card, and its checkpoint; (c) that checkpoint on a world of one
    rank.  Returns every kernel's launches over the ranks' paths (none)."""
    import math
    import numpy as np
    import torch
    from repro_torch.launch.train import train_loop
    from repro_torch.tree import flatten
    t_phase = time.perf_counter()
    check(set(_kernel_counters()) == set(kernels),
          f"the ranks count other kernels than the table's: {sorted(kernels)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        tmp = pathlib.Path(tmp)
        ranks = finish_ranks(
            start_ranks("train_dp", "gloo", LM_DP_RANKS, tmp, out=str(tmp),
                        ckpt=str(tmp / "ckpt")), "lm_train_dp", LM_DP_TIMEOUT_S)
        # (a) full width
        fulls = [r["full"] for r in ranks]
        a0 = fulls[0]
        for r in fulls[1:]:
            check(r["losses"] == a0["losses"] and r["grad_norms"] == a0["grad_norms"],
                  f"the ranks' losses or grad norms differ: {[f['losses'] for f in fulls]}")
            check(r["digest"] == a0["digest"],
                  "the ranks' gathered params differ after the last step")
        check(len(a0["losses"]) == LM_DP_STEPS
              and all(map(math.isfinite, a0["losses"] + a0["grad_norms"])),
              f"full-width losses {a0['losses']}, grad norms {a0['grad_norms']}")
        one_rank_opt = 12 * a0["params"] + 4
        for r in fulls:
            share = r["opt_bytes"] / (one_rank_opt / LM_DP_RANKS)
            check(abs(share - 1) <= LM_DP_OPT_SHARE_TOL,
                  f"a rank holds {r['opt_bytes']} optimizer bytes of {one_rank_opt}")
        B, L, _ = LM_TRAIN_FULL
        step_ms = float(np.median(a0["step_s"][1:])) * 1e3
        sync = [s for r in fulls for s in r["sync"][1:]]
        part_a = {
            "arch": LM_ARCH, "ranks": LM_DP_RANKS, "mesh": [LM_DP_RANKS, 1],
            "backend": a0["backend"], "transport": a0["sync"][0]["transport"],
            "batch": B, "tokens": L, "rows_per_rank": a0["local_rows"],
            "steps": LM_DP_STEPS, "params": a0["params"],
            "losses": a0["losses"], "one_rank_losses": one_rank_losses[:LM_DP_STEPS],
            "loss_rel_to_one_rank": [abs(a - b) / abs(b) for a, b in
                                     zip(a0["losses"], one_rank_losses)],
            "grad_norms": a0["grad_norms"], "step_s": [r["step_s"] for r in fulls],
            "median_step_ms_2_to_last": step_ms, "tokens_per_s": B * L / (step_ms / 1e3),
            "median_sync_ms": float(np.median([s["sync_s"] for s in sync])) * 1e3,
            "median_gather_ms": float(np.median([s["gather_s"] for s in sync])) * 1e3,
            "median_sync_stage_ms": {
                k: float(np.median([s[k] for s in sync])) * 1e3
                for k in ("to_mesh_s", "collective_s", "back_s")},
            "sync_bytes": a0["sync"][0]["sync_bytes"],
            "gather_bytes": a0["sync"][0]["gather_bytes"],
            "sync_dtype": "float32",
            "sync_collective": "all_reduce of every data rank's row, each rank "
                               "keeping its own; all_reduce of (loss, ce, aux) "
                               "and of the squared norm",
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in fulls],
            "opt_bytes": [r["opt_bytes"] for r in fulls],
            "one_rank_opt_bytes": one_rank_opt,
            "params_sha256_bitwise_across_ranks": True}
        # (b) the reduced float32 model against one rank on the card
        cfg = _dp_small_cfg()
        with _train_loop_optimizer(**LM_TRAIN_OPT):
            one = train_loop(cfg, device="cuda", log_every=100, **LM_DP_LOOP)
        smalls = [r["small"] for r in ranks]
        b0 = smalls[0]
        for r in smalls[1:]:
            check(r["losses"] == b0["losses"] and r["digest"] == b0["digest"],
                  "the ranks' reduced-model losses or params differ")
        check(all(r["saved_losses"] == b0["losses"][:LM_DP_SAVE_AT] for r in smalls),
              "the checkpointed run's losses are not the straight run's")
        straight = np.load(tmp / "straight.npz")
        keys, ones = flatten(one["params"])
        init = _dp_init_params(cfg)
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(b0["losses"], one["losses"]))
        w_abs = max(float(np.abs(straight[k] - t.float().cpu().numpy()).max())
                    for k, t in zip(keys, ones))
        moved = max(float(np.abs(straight[k] - t.float().cpu().numpy()).max())
                    for k, t in zip(keys, flatten(init)[1]))
        check(loss_rel <= LM_DP_LOSS_RTOL and w_abs <= LM_TRAIN_TOL
              and moved > 10 * LM_TRAIN_TOL,
              f"two ranks against one: losses {b0['losses']} vs {one['losses']}, "
              f"weights {w_abs} (moved {moved})")
        part_b = {"config": LM_DP_SMALL, "dtype": "float32", **LM_DP_LOOP,
                  "optimizer": LM_TRAIN_OPT, "losses": b0["losses"],
                  "one_rank_losses": one["losses"], "max_loss_rel_err": loss_rel,
                  "params_max_abs_err": w_abs, "params_moved": moved,
                  "sync_bytes": b0["sync"][0]["sync_bytes"]}
        # (c) the checkpoint of step LM_DP_SAVE_AT onto one rank
        el = finish_ranks(start_ranks("elastic", "gloo", 1, tmp, out=str(tmp),
                                      ckpt=str(tmp / "ckpt")),
                          "lm_train_dp elastic", LM_DP_TIMEOUT_S)[0]
        resumed = np.load(tmp / "resumed.npz")
        c_loss = abs(el["losses"][0] - b0["losses"][-1]) / abs(b0["losses"][-1])
        c_abs = max(float(np.abs(resumed[k] - straight[k]).max()) for k in keys)
        check(el["restore_bitwise"] and el["restored_step"] == LM_DP_SAVE_AT
              and el["step"] == LM_DP_LOOP["steps"] and len(el["losses"]) == 1
              and c_loss <= LM_DP_LOSS_RTOL and c_abs <= LM_TRAIN_TOL,
              f"the checkpoint restored onto one rank: {el} (loss rel {c_loss}, "
              f"weights {c_abs})")
        part_c = {"mesh": el["mesh"], "restore_bitwise": el["restore_bitwise"],
                  "restored_step": el["restored_step"], "step_3_loss": el["losses"][0],
                  "two_rank_step_3_loss": b0["losses"][-1], "loss_rel_err": c_loss,
                  "params_max_abs_err": c_abs, "seconds": el["seconds"]}
    launches = {name: sum(r["launches"][name] for r in ranks) + el["launches"][name]
                for name in kernels}
    check(not any(launches.values()),
          f"training over ranks launched {[n for n, c in launches.items() if c]}")
    emit("lm_train_dp", a_full_width=part_a, b_two_vs_one_rank=part_b,
         c_elastic=part_c, device=smi, seconds=time.perf_counter() - t_phase)
    return launches


def _stage_ms(syncs) -> dict:
    """Kind -> the median over ``syncs`` (steps' ``by_kind``) of its calls,
    bytes and host-copy / collective / copy-back ms."""
    import numpy as np
    kinds = sorted({k for s in syncs for k in s})
    return {k: {"calls": int(np.median([s.get(k, {}).get("calls", 0) for s in syncs])),
                "bytes": int(np.median([s.get(k, {}).get("bytes", 0) for s in syncs])),
                **{st[:-2] + "_ms": float(np.median([s.get(k, {}).get(st, 0.0)
                                                     for s in syncs])) * 1e3
                   for st in ("to_host_s", "collective_s", "back_s")}}
            for k in kinds}


def _close_params(path_a, path_b) -> float:
    """max |a - b| over every leaf of two params npz files."""
    import numpy as np
    a, b = np.load(path_a), np.load(path_b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in b.files)


def phase_lm_train_tp(kernels, smi, on_full_done=None):
    """The partitioned step over gloo ranks sharing the card (processes of
    this script on launch.transport's backend; this process starts no
    group): (a) full-width qwen2-0.5b over (1, 2); (b) the reduced float32
    qwen2 over (1, 2) and (2, 2) against one rank, and the (1, 2) checkpoint
    on one rank; (c) the reduced float32 qwen3-moe over (2, 1) and (2, 2)
    against (2, 1) on CPU ranks; (d) the dry run's prediction of (a)'s step
    against one counted on the ranks.  ``on_full_done()`` is called once
    (a)'s timed steps and (d)'s counted one are over.  Returns every
    kernel's launches over the ranks' paths (none)."""
    t_phase = time.perf_counter()
    check(set(_kernel_counters()) == set(kernels),
          f"the ranks count other kernels than the table's: {sorted(kernels)}")
    B, L, _ = LM_TRAIN_FULL
    predict = _dryrun_child("predict", LM_ARCH, str(B), str(L), *map(str, LM_TP_MESH))
    groups = []
    try:
        return _lm_train_tp(kernels, smi, predict, groups, t_phase, on_full_done)
    finally:
        for proc in [predict] + [p for procs in groups for p, _, _ in procs]:
            if proc.poll() is None:
                with contextlib.suppress(ProcessLookupError):
                    os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


def _wait_for(path: pathlib.Path, procs, what: str, timeout_s: float) -> None:
    """Until ``path`` exists; a rank of ``procs`` that fails first fails
    the run (``finish_ranks`` stops them all and reports it)."""
    deadline = time.perf_counter() + timeout_s
    while not path.exists():
        if any(p.poll() not in (None, 0) for p, _, _ in procs):
            finish_ranks(procs, what, timeout_s)
        check(time.perf_counter() < deadline, f"the {what} ranks ran over {timeout_s} s")
        time.sleep(0.1)


def _lm_train_tp(kernels, smi, predict, groups, t_phase, on_full_done):
    """``phase_lm_train_tp``'s body, the prediction's process started; the
    groups of rank processes it starts are appended to ``groups``."""
    import numpy as np
    from repro_torch.launch import transport
    from repro_torch.launch.train import train_loop
    B, L, _ = LM_TRAIN_FULL
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        tmp = pathlib.Path(tmp)
        be = transport.BACKEND
        # (c)'s every run from the card's init for seed 0 (train_loop's own)
        moe_init = str(tmp / "moe_init.npz")
        _save_params(moe_init, _dp_init_params(_tp_moe_cfg()))
        t0 = time.perf_counter()
        two = start_ranks("train_tp", be, 2, tmp, out=str(tmp), full=True,
                          full_done=str(tmp / "full_done"),
                          small=list(LM_TP_MESH), ckpt=str(tmp / "ckpt"),
                          moe=list(LM_TP_MOE_MESHES[0]), moe_init=moe_init)
        groups.append(two)
        # the other ranks start once (a)'s timed steps are over, beside the
        # two ranks' (b) and (c)
        _wait_for(tmp / "full_done", two, "lm_train_tp", LM_TP_TIMEOUT_S)
        t_full = time.perf_counter() - t0
        if on_full_done is not None:
            on_full_done()
        cpu = start_ranks("train_tp_cpu", be, 2, tmp, env_extra={"CUDA_VISIBLE_DEVICES": ""},
                          device="cpu", out=str(tmp), moe=[2, 1], moe_init=moe_init)
        groups.append(cpu)
        four = start_ranks("train_tp4", be, 4, tmp, out=str(tmp), moe_init=moe_init,
                           small=list(LM_TP_MESH4), moe=list(LM_TP_MOE_MESHES[1]))
        groups.append(four)
        ranks2 = finish_ranks(two, "lm_train_tp", LM_TP_TIMEOUT_S)
        ranks4 = finish_ranks(four, "lm_train_tp 4 ranks", LM_TP_TIMEOUT_S)
        ranks_cpu = finish_ranks(cpu, "lm_train_tp CPU", LM_TP_TIMEOUT_S)
        t_ranks = time.perf_counter() - t0

        # (a) full width
        fulls = [r["full"] for r in ranks2]
        a0 = fulls[0]
        for r in fulls[1:]:
            check(r["losses"] == a0["losses"] and r["grad_norms"] == a0["grad_norms"],
                  f"the ranks' losses or grad norms differ: {[f['losses'] for f in fulls]}")
        check(len(a0["losses"]) == LM_TP_STEPS
              and all(map(math.isfinite, a0["losses"] + a0["grad_norms"])),
              f"full-width losses {a0['losses']}, grad norms {a0['grad_norms']}")
        for r in fulls:
            share = r["params_local"] / r["params"]
            check(0.4 < share < 0.6, f"a rank holds {r['params_local']} of "
                                     f"{r['params']} parameters")
        step_ms = float(np.median(a0["step_s"][1:])) * 1e3
        syncs = [s["by_kind"] for r in fulls for s in r["sync"][1:]]
        part_a = {
            "arch": LM_ARCH, "mesh": list(LM_TP_MESH), "layout": "tp",
            "transport": a0["transport"], "batch": B, "tokens": L,
            "steps": LM_TP_STEPS, "losses": a0["losses"], "grad_norms": a0["grad_norms"],
            "step_s": [r["step_s"] for r in fulls],
            "median_step_ms_2_to_last": step_ms, "tokens_per_s": B * L / (step_ms / 1e3),
            "collectives_by_kind": _stage_ms(syncs),
            "collective_ms": sum(v[k] for v in _stage_ms(syncs).values()
                                 for k in ("to_host_ms", "collective_ms", "back_ms")),
            "collective_bytes": sum(v["bytes"] for v in _stage_ms(syncs).values()),
            "peak_memory_bytes": [r["peak_memory_bytes"] for r in fulls],
            "params_per_rank": [r["params_local"] for r in fulls],
            "params": a0["params"], "losses_bitwise_across_ranks": True,
            "ranks_seconds": a0["seconds"], "until_done_seconds": t_full}
        print(f"lm_train_tp (a): {step_ms:.1f} ms a step, "
              f"{part_a['tokens_per_s']:.0f} tokens/s, collectives "
              f"{part_a['collective_ms']:.1f} ms / {part_a['collective_bytes']} B, "
              f"peak {part_a['peak_memory_bytes']} B a rank", flush=True)

        # (b) the reduced float32 model against one rank on the card
        cfg = _dp_small_cfg()
        with _train_loop_optimizer(**LM_TRAIN_OPT):
            one = train_loop(cfg, device="cuda", log_every=100, **LM_DP_LOOP)
        _save_params(tmp / "small_one.npz", one["params"])
        init = tmp / "small_init.npz"
        _save_params(init, _dp_init_params(cfg))
        part_b = {"config": LM_DP_SMALL, "dtype": "float32", **LM_DP_LOOP,
                  "optimizer": LM_TRAIN_OPT, "one_rank_losses": one["losses"]}
        for tag, ranks in (("1x2", ranks2), ("2x2", ranks4)):
            smalls = [r["small"] for r in ranks]
            b0 = smalls[0]
            check(all(r["losses"] == b0["losses"] and r["digest"] == b0["digest"]
                      for r in smalls), f"the {tag} ranks' reduced-model runs differ")
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(b0["losses"], one["losses"]))
            w_abs = _close_params(tmp / f"small_{tag}.npz", tmp / "small_one.npz")
            moved = _close_params(tmp / f"small_{tag}.npz", init)
            check(loss_rel <= LM_DP_LOSS_RTOL and w_abs <= LM_TRAIN_TOL
                  and moved > 10 * LM_TRAIN_TOL,
                  f"{tag} against one rank: losses {b0['losses']} vs {one['losses']}, "
                  f"weights {w_abs} (moved {moved})")
            part_b[tag] = {"losses": b0["losses"], "max_loss_rel_err": loss_rel,
                           "params_max_abs_err": w_abs, "params_moved": moved,
                           "collectives": b0["sync"]["by_kind"]}
        b12 = ranks2[0]["small"]
        check(b12["saved_losses"] == b12["losses"][:LM_DP_SAVE_AT],
              "the checkpointed run's losses are not the straight run's")
        with _train_loop_optimizer(**LM_TRAIN_OPT):
            resumed = train_loop(cfg, device="cuda", log_every=100,
                                 ckpt_dir=str(tmp / "ckpt"),
                                 save_every=LM_DP_LOOP["steps"], **LM_DP_LOOP)
        _save_params(tmp / "small_resumed.npz", resumed["params"])
        r_loss = abs(resumed["losses"][0] - b12["losses"][-1]) / abs(b12["losses"][-1])
        r_abs = _close_params(tmp / "small_resumed.npz", tmp / "small_1x2.npz")
        check(len(resumed["losses"]) == LM_DP_LOOP["steps"] - LM_DP_SAVE_AT
              and r_loss <= LM_DP_LOSS_RTOL and r_abs <= LM_TRAIN_TOL,
              f"the (1, 2) checkpoint on one rank: {resumed['losses']} "
              f"(loss rel {r_loss}, weights {r_abs})")
        part_b["resume_1x2_on_one_rank"] = {
            "restored_step": LM_DP_SAVE_AT, "loss_rel_err": r_loss,
            "params_max_abs_err": r_abs}

        # (c) MoE over data ranks against two CPU ranks
        c_ref = ranks_cpu[0]["moe"]
        check(all(r["moe"]["losses"] == c_ref["losses"] for r in ranks_cpu),
              "the CPU ranks' MoE runs differ")
        part_c = {"arch": LM_TP_MOE, "dtype": "float32", **LM_DP_LOOP,
                  "cpu_2x1_losses": c_ref["losses"]}
        for tag, ranks in (("2x1", ranks2), ("2x2", ranks4)):
            moes = [r["moe"] for r in ranks]
            m0 = moes[0]
            check(all(m["losses"] == m0["losses"] and m["digest"] == m0["digest"]
                      for m in moes), f"the {tag} ranks' MoE runs differ")
            margin = min(m["margin"] for m in moes + [c_ref])
            check(margin > LM_TP_ROUTER_MARGIN,
                  f"a near-tie in the routing ({[m['margin'] for m in moes + [c_ref]]}): "
                  "a pick may flip")
            loss_rel = max(abs(a - b) / abs(b) for a, b in zip(m0["losses"], c_ref["losses"]))
            w_abs = _close_params(tmp / f"moe_{tag}.npz", tmp / "moe_cpu.npz")
            check(loss_rel <= LM_TP_MOE_RTOL and w_abs <= LM_TRAIN_TOL,
                  f"MoE {tag} on the card against (2, 1) on the CPU: losses "
                  f"{m0['losses']} vs {c_ref['losses']}, weights {w_abs}")
            dropped = sum(m["dropped"] for m in moes) / sum(m["picks"] for m in moes)
            print(f"lm_train_tp (c) {tag}: dropped at capacity {dropped:.4f}", flush=True)
            part_c[tag] = {"losses": m0["losses"], "max_loss_rel_err": loss_rel,
                           "params_max_abs_err": w_abs, "router_margin": margin,
                           "dropped_share": dropped,
                           "collectives": m0["sync"]["by_kind"]}

    # (d) the dry run's prediction of (a)'s step
    pred = _dryrun_result(predict, "(1, 2) prediction")
    got = a0["counted_step"]
    for r in fulls[1:]:
        c = r["counted_step"]
        check(c["argument_bytes"] == got["argument_bytes"] and c["flops"] == got["flops"]
              and {k: v["calls"] for k, v in c["by_kind"].items()}
              == {k: v["calls"] for k, v in got["by_kind"].items()},
              "the ranks counted different steps")
    want_kinds = {k: {"calls": pred["collective_calls"].get(k, 0),
                      "bytes": pred["collectives"].get(k, 0)}
                  for k in set(pred["collective_calls"]) | set(got["by_kind"])}
    got_kinds = {k: {"calls": got["by_kind"].get(k, {}).get("calls", 0),
                     "bytes": got["by_kind"].get(k, {}).get("bytes", 0)}
                 for k in want_kinds}
    mem = pred["memory"]
    peak_rel = abs(mem["peak_hbm_estimate"] - got["peak_bytes"]) / got["peak_bytes"]
    print(f"lm_train_tp (d): argument bytes predicted {mem['argument_bytes']} ranks "
          f"{got['argument_bytes']}; FLOPs predicted {pred['flops']:.6e} ranks "
          f"{got['flops']:.6e}; collectives predicted {want_kinds} ranks {got_kinds}; "
          f"peak predicted {mem['peak_hbm_estimate']} ranks {got['peak_bytes']} "
          f"({peak_rel * 100:.2f} %)", flush=True)
    part_d = {"mesh": list(LM_TP_MESH),
              "predicted": {"argument_bytes": mem["argument_bytes"], "flops": pred["flops"],
                            "collectives": want_kinds, "peak_bytes": mem["peak_hbm_estimate"],
                            "seconds": pred["seconds"]},
              "ranks": {"argument_bytes": got["argument_bytes"], "flops": got["flops"],
                        "collectives": got_kinds, "peak_bytes": got["peak_bytes"]},
              "peak_rel_err": peak_rel}
    check(mem["argument_bytes"] == got["argument_bytes"],
          f"predicted argument bytes {mem['argument_bytes']} != the ranks' "
          f"{got['argument_bytes']}")
    check(pred["flops"] == got["flops"],
          f"predicted FLOPs {pred['flops']} != the ranks' {got['flops']}")
    check(want_kinds == got_kinds,
          f"predicted collectives {want_kinds} != the ranks' {got_kinds}")
    check(peak_rel <= LM_DRYRUN_PEAK_TOL,
          f"predicted peak {mem['peak_hbm_estimate']} vs the ranks' {got['peak_bytes']}")

    launches = {name: sum(r["launches"][name] for r in ranks2 + ranks4 + ranks_cpu)
                for name in kernels}
    check(not any(launches.values()),
          f"the partitioned step launched {[n for n, c in launches.items() if c]}")
    seconds = time.perf_counter() - t_phase
    print(f"lm_train_tp: {seconds:.1f} s", flush=True)
    emit("lm_train_tp", a_full_width=part_a, b_reduced=part_b, c_moe=part_c,
         d_prediction=part_d, device=smi, ranks_seconds=t_ranks, seconds=seconds)
    return launches


def _dp_init_params(cfg):
    import torch
    from repro_torch.models import init_params
    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0))


def phase_coreset_mesh(smi, serve, sat_f32_ms):
    """The mesh half on the card, every rank a process of this script (this
    process starts no group): (a) one NCCL rank, CoresetEngine(mesh=
    make_local_mesh(1)) on coreset_serve's signal and its eight T = 256
    batches, then sat_pjit at 4096 x 4096 float32; beside it two NCCL ranks
    on the one card, which NCCL must refuse; (b) MESH_RANKS gloo ranks on the
    one card, fitting_loss_batched(mesh=) on (a)'s coreset (handed over in
    a .npz, its fingerprint checked) and the same batches, then sat_pjit.
    Each rank zeroes its kernels' counts just before its path and reads them
    just after; the phase sums them.  Returns the launches by kernel."""
    import numpy as np
    from repro_torch import ops
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        coreset = str(tmp / "coreset.npz")
        dup = start_ranks("duplicate", "nccl", 2, tmp)
        losses = str(tmp / "losses.npz")
        one = start_ranks("one", "nccl", 1, tmp, coreset=coreset, losses=losses)
        try:
            dup = finish_ranks(dup, "duplicate-GPU")
        finally:
            (one,) = finish_ranks(one, "NCCL")
        t0 = time.perf_counter()
        gloo = start_ranks("gloo", "gloo", MESH_RANKS, tmp, coreset=coreset,
                           gloo_losses=str(tmp / "gloo_losses.npy"))
        try:        # the oracle while the gloo ranks run
            cs = _load_coreset(coreset)
            oracle = np.stack([ops.fitting_loss_batched(cs, r, lab, backend="numpy")
                               for r, lab in _batches()])
        finally:
            gloo = finish_ranks(gloo, "gloo")
        gloo_s = time.perf_counter() - t0
        with np.load(losses) as z:
            meshed, one_device = z["mesh"], z["one_device"]
        sharded = np.load(tmp / "gloo_losses.npy")
    one_oracle = float(rel_err(meshed, oracle).max())
    gloo_kernel = float(rel_err(sharded, one_device).max())
    gloo_oracle = float(rel_err(sharded, oracle).max())

    check(all(d["refused"] and "Duplicate GPU" in d["error"] for d in dup),
          f"two NCCL ranks on one card were not refused: {dup}")
    # (a) one NCCL rank
    check(one["fingerprint"] == serve["fingerprint"] and one["how"] == "built",
          f"the mesh engine's coreset {one['fingerprint']} is not coreset_serve's")
    check(one["bitwise_unmeshed"],
          "the one-rank mesh engine's losses differ from the engine without a mesh")
    check(one_oracle <= MESH_ENGINE_TOL,
          f"the mesh engine vs the numpy oracle: {one_oracle}")
    batches = 2 * SERVE_CLIENTS
    check(one["backends"] == [one["mesh_backend"]] == ["cuda+all_reduce"]
          and one["unmeshed_backends"] == ["cuda"] and one["fused"] == [SERVE_T],
          f"backends {one['backends']} / {one['unmeshed_backends']}, fused {one['fused']}")
    check(one["counters"] == {"loss_scoring_calls": batches,
                              "ops_backend_cuda+all_reduce": batches},
          f"the mesh engine's counters {one['counters']}")
    check(one["sat_bitwise"] or one["sat_scaled_err"] <= SAT_F32_TOL,
          f"one-rank sat_pjit vs sat_moments: {one['sat_scaled_err']}")
    check(one["launches"]["fitting_loss_batched"] == batches
          and one["launches"]["sat_delta_f32"] == 1,
          f"one-rank launches {one['launches']}")
    # (b) MESH_RANKS gloo ranks on the one card
    lead = gloo[0]
    rows = -(-SERVE_SIGNAL["n"] // MESH_RANKS)
    check(all(g["fingerprint"] == serve["fingerprint"] for g in gloo),
          "a gloo rank loaded another coreset")
    check(len({g["losses_sha"] for g in gloo}) == 1,
          "the gloo ranks returned different losses")
    check(gloo_kernel <= MESH_KERNEL_RTOL,
          f"the sharded scorer vs the one-device kernel: {gloo_kernel}")
    check(np.allclose(sharded, oracle, rtol=MESH_ORACLE_RTOL, atol=MESH_ORACLE_ATOL),
          f"the sharded scorer vs the oracle: {gloo_oracle}")
    check(lead["padding_only_zero"], "a padding-only slab scored non-zero")
    check(lead["sat_bitwise"] or lead["sat_scaled_err"] <= SAT_F32_TOL,
          f"{MESH_RANKS}-rank sat_pjit vs sat_moments: {lead['sat_scaled_err']}")
    for g in gloo:
        check(g["local_rows"] == rows
              and g["launches"]["fitting_loss_batched"] == batches
              and g["launches"]["sat_delta_f32"] == 1,
              f"gloo rank {g['rank']}: {g['local_rows']} rows, launches {g['launches']}")

    launches = {name: one["launches"][name] + sum(g["launches"][name] for g in gloo)
                for name in one["launches"]}
    per_rank = {key: [g["ms"][key] for g in gloo] for key in gloo[0]["ms"]}
    emit("coreset_mesh", signal=SERVE_SIGNAL, k=SERVE_K, eps=SERVE_EPS,
         blocks=one["blocks"], fingerprint=one["fingerprint"],
         duplicate_gpu={"nccl_ranks": 2, "refused": dup[0]["error"]},
         one_rank={"backend": "nccl", "nccl": one["nccl"],
                   "mesh": "make_local_mesh(1): (data 1, model 1)",
                   "engine_build_s": one["build_s"], "batches": batches,
                   "bitwise_unmeshed": True,
                   "max_rel_err_oracle": one_oracle,
                   "counters": one["counters"], "sat_bitwise": one["sat_bitwise"],
                   "sat_scaled_err": one["sat_scaled_err"],
                   "launches": one["launches"], "ms": one["ms"]},
         gloo_ranks={"ranks": MESH_RANKS, "backend": "gloo", "card": "one, shared",
                     "collectives_through_host": True,
                     "mesh": f"compat_make_mesh(({MESH_RANKS},), ('data',))",
                     "rows_a_rank": rows, "blocks_padded": -(-one["blocks"] // MESH_RANKS)
                     * MESH_RANKS, "seconds": gloo_s,
                     "max_rel_err_kernel": gloo_kernel,
                     "max_rel_err_oracle": gloo_oracle,
                     "padding_only_slab_zero": True,
                     "sat_bitwise": lead["sat_bitwise"],
                     "sat_scaled_err": lead["sat_scaled_err"],
                     "launches": [g["launches"] for g in gloo],
                     "ms_by_rank": per_rank},
         kernel1_sat_moments_f32_device_ms=sat_f32_ms,
         launches=launches, device=smi, seconds=time.perf_counter() - t_phase)
    return launches


# seconds and speed-ups in the examples' stdout, which differ from run to run
_TIMING_FIELDS = (
    (r"\b\d+\.\d+s\b", "<s>"),               # "built in 1.27s", "took 1.38s"
    (r"\bx\d+\.\d+\b", "x<speedup>"),        # automl_tuning's speed-up
    # automl_tuning's table: its last column is the method's seconds
    (r"^((?:full|coreset|uniform) +\d+ +\d+ +-?\d+\.\d) +\d+\.\d+$", r"\1 <s>"),
)


def mask_timings(text: str) -> str:
    """An example's stdout with its seconds and speed-ups masked."""
    import re
    for pattern, mask in _TIMING_FIELDS:
        text = re.sub(pattern, mask, text, flags=re.M)
    return text


def compare_example(name: str, card: str, plain: str) -> dict:
    """An example's masked stdout on the card against its run pinned on
    numpy: every line equal, but for the lines of EXAMPLE_SERVED_LINES,
    whose words must be equal and whose numbers within SERVE_TOL (relative)
    plus one unit of their last printed digit.  Returns the served lines
    held so and every difference found (``errors``)."""
    import re
    number = re.compile(r"-?\d+(?:\.(\d+))?")
    a, b = mask_timings(card).splitlines(), mask_timings(plain).splitlines()
    errors = [] if len(a) == len(b) and a else [
        f"{len(a)} lines on the card, {len(b)} on numpy"]
    held = []
    for x, y in zip(a, b):
        if x == y:
            continue
        if not (x.startswith(EXAMPLE_SERVED_LINES.get(name, ()))
                and number.sub("#", x) == number.sub("#", y)):
            errors.append(f"{x!r} on the card, {y!r} on numpy")
            continue
        for gx, gy in zip(number.finditer(x), number.finditer(y)):
            got, want = float(gx.group()), float(gy.group())
            unit = 10.0 ** -len(gy.group(1) or "")
            if abs(got - want) > SERVE_TOL * abs(want) + unit:
                errors.append(f"{got} on the card, {want} on numpy, in {x!r}")
        held.append({"card": x, "numpy": y})
    return {"lines": len(a), "equal": a == b, "served_lines_held": held,
            "errors": errors}


# each gate's figures: (pattern, conversion) on its stdout
_GATE_FIGURES = {
    "coalesce_gate_torch": {
        "scoring_dispatches": (r"-> (\d+) scoring dispatches", int),
        "coalesced": (r"query_coalesced_total \+= (\d+)", int),
        "fused_batch_size": (r"fused_batch_size: (\[[^\]]*\])", json.loads),
        "loss_parity_rel": (r"loss parity rel=(\S+)", float)},
    "trace_gate_torch": {
        "coverage_pct": (r"coverage ([\d.]+)%", float),
        "fan_in_best": (r"\(best (\d+),", int),
        "chrome_events": (r"chrome export: (\d+) events", int)},
    "stream_gate_torch": {
        "fingerprint": (r"fingerprint (\w+) ==", str),
        "compress_mb": (r"(\d+) MB compress", int),
        "chunks": (r"in (\d+) chunks", int)},
    "overload_gate_torch": {
        "capacity_rps": (r"capacity=(\d+) rps", int),
        "baseline_p95_ms": (r"baseline: .*p95=([\d.]+) ms", float),
        "offered_rps": (r"offered=(\d+) rps", int),
        "admitted_rate_rps": (r"admitted rate (\d+)", int)},
}
_TENANT = (r"\] +(\w+): ok=(\d+) rejected=(\d+) expired_504=(\d+) errors=(\d+) "
           r"p95=([\d.]+) ms")


def gate_figures(name: str, out: str) -> dict:
    """The figures a gate printed, parsed from its stdout (None where a
    line is missing); the overload gate's each tenant's too."""
    import re
    figures = {}
    for key, (pattern, conv) in _GATE_FIGURES[name].items():
        m = re.search(pattern, out)
        figures[key] = None if m is None else conv(m.group(1))
    tenants = {t: dict(zip(("ok", "rejected", "expired_504", "errors"),
                           map(int, rest[:4])), p95_ms=float(rest[4]))
               for t, *rest in re.findall(_TENANT, out)}
    return figures | ({"tenants": tenants} if tenants else {})


def _captured(fn):
    """``fn()`` with this process's stdout captured: its return code (a
    SystemExit's too, whose message is kept) and the text."""
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = fn()
    except SystemExit as exc:
        rc = exc.code if isinstance(exc.code, int) else 1
        if isinstance(exc.code, str):
            buf.write(exc.code + "\n")
    return rc, buf.getvalue()


def _counted(kernels, fn) -> dict:
    """``_captured(fn)`` with every kernel's count and the dispatch counts
    at 0 just before it, read just after.  The garbage the script's earlier
    phases left is collected first, so that no full collection of it lands
    in a timed window; the Python threads alive then are counted."""
    import gc
    import threading
    from repro_torch import ops
    gc.collect()
    threads = threading.active_count()
    for kern in kernels.values():
        kern.launches = 0
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    rc, out = _captured(fn)
    return {"seconds": time.perf_counter() - t0, "rc": rc, "stdout": out,
            "threads_before": threads,
            "dispatches": {f"{o}/{b}": c for (o, b), c in ops.dispatch_counts().items()},
            "launches": {name: k.launches for name, k in kernels.items()}}


def _run_example(path: str) -> int:
    import runpy
    runpy.run_path(path, run_name="__main__")
    return 0


def _load_gate(name: str):
    """A gate script imported as a module of its name, from ``scripts/``
    on the path, so that the processes it spawns (the overload gate's
    tenants) import it too."""
    import importlib
    scripts = str(ROOT / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module(name)


def phase_coreset_gates(kernels, smi):
    """The server's four gates and the paper's four examples on the card,
    each unpinned in this process (a gate's ``main(argv)``, an example's
    ``__main__`` by runpy) with its stdout captured and every count at 0
    just before it; each example's masked stdout against its run pinned on
    numpy in a child process (started once the timed overload gate is over).
    Every gate's and example's figures are emitted before the checks.
    Returns the launches summed over all eight."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT / "src"), REPRO_TORCH_OPS_BACKEND="numpy")
    gates, twins, examples, plain = {}, {}, {}, {}
    try:
        for name, argv in GATES:
            mod = _load_gate(name)
            gates[name] = {"argv": argv,
                           **_counted(kernels, lambda: mod.main(list(argv)))}
            gates[name]["figures"] = gate_figures(name, gates[name]["stdout"])
            if name == TWINS_AFTER:
                twins = {ex: subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / f"{ex}.py")], cwd=ROOT,
                    env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True, start_new_session=True) for ex in EXAMPLES}
        for name in EXAMPLES:
            path = str(ROOT / "examples" / f"{name}.py")
            examples[name] = _counted(kernels, lambda: _run_example(path))
        for name, proc in twins.items():
            out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT_S)
            plain[name] = (proc.returncode, out, err)
    finally:
        for proc in twins.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()

    launches = {name: sum(r["launches"][name] for r in (*gates.values(), *examples.values()))
                for name in kernels}
    compared = {name: compare_example(name, r["stdout"], plain[name][1])
                for name, r in examples.items()}
    emit("coreset_gates",
         gates={name: {key: r[key] for key in ("argv", "seconds", "rc", "dispatches",
                                               "figures", "threads_before")}
                | {"launches": {k: c for k, c in r["launches"].items() if c},
                   "stdout": r["stdout"].splitlines()} for name, r in gates.items()},
         examples={name: {"seconds": r["seconds"], "rc": r["rc"],
                          "dispatches": r["dispatches"],
                          "launches": {k: c for k, c in r["launches"].items() if c},
                          "numpy_rc": plain[name][0], **compared[name],
                          "stdout": r["stdout"].splitlines(),
                          "numpy_stdout": plain[name][1].splitlines()}
                   for name, r in examples.items()},
         launches=launches, device=smi, seconds=time.perf_counter() - t_phase)

    for name, r in gates.items():
        last = r["stdout"].strip().splitlines()[-1:] or [""]
        check(r["rc"] == 0 and last[0] == f"[{name}] PASS",
              f"{name} exited {r['rc']}, its last line {last[0]!r}")
    for name, r in (*gates.items(), *examples.items()):
        check(r["dispatches"] and all(k.endswith("/cuda") for k in r["dispatches"]),
              f"{name} dispatched {r['dispatches']}")
    for name, r in examples.items():
        rc, _, err = plain[name]
        check(r["rc"] == 0 and rc == 0, f"{name} exited {r['rc']} on the card, "
                                        f"{rc} on numpy: {err[-2000:]}")
        check(not compared[name]["errors"],
              f"{name} on the card against numpy: {compared[name]['errors']}")
    for name in GATES_LAUNCHED:
        check(launches[name] > 0, f"kernel {name} was not launched by the gates")
    for name in GATES_NOT_LAUNCHED:
        check(launches[name] == 0, f"the gates launched {name} {launches[name]} times")
    return launches


def _file_state(path: pathlib.Path):
    st = path.stat() if path.exists() else None
    return None if st is None else (st.st_size, st.st_mtime_ns)


@contextlib.contextmanager
def cold_tuning_cache():
    """Point the autotune cache at a file in a fresh temporary directory
    (absent, so every dispatch sees a cold cache until the autotune phase
    tunes into it), with the precision and disable variables unset; restore
    all three and remove the directory afterwards.  Yields the default
    cache path and its state, which must not change."""
    from repro_torch.ops import autotune
    names = (autotune.CACHE_ENV_VAR, autotune.PRECISION_ENV_VAR,
             autotune.DISABLE_ENV_VAR)
    saved = {v: os.environ.pop(v, None) for v in names}
    default = autotune.cache_path()
    before = _file_state(default)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_autotune_")
    os.environ[autotune.CACHE_ENV_VAR] = str(pathlib.Path(tmp) / "autotune.json")
    autotune.reset_cache()
    try:
        yield default, before
    finally:
        for v, val in saved.items():
            os.environ.pop(v, None)
            if val is not None:
                os.environ[v] = val
        autotune.reset_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# the kernel each op's cuda config launches
def _planned_kernel(op: str, cfg: dict) -> str:
    if op == "hist_split":
        return {"f64": "hist_f64", "fused": "hist_fused_f32",
                "partials": "hist_partials_f32",
                "legacy": "hist_legacy_f32"}[cfg.get("variant", "f64")]
    if op == "fitting_loss_batched":
        return "fitting_loss_batched"
    t = "f32" if cfg.get("dtype") == "float32" else "f64"
    return {"sat_moments": f"sat_moments_{t}", "delta_sat": f"sat_delta_{t}"}[op]


def _consults(autotune) -> int:
    """Plans served or held: a backend that found its cache entry."""
    c = autotune.counters_snapshot()
    return c["cache_hit"] + c["pin_held"]


def phase_autotune(kernels, default_cache):
    """The tuner on the card at the reference's LARGE_SHAPES into the
    temporary cache (``cold_tuning_cache``), then dispatch through the warm
    cache, which must keep every op on the card."""
    import numpy as np
    from repro_torch import ops
    from repro_torch.ops import autotune
    path, state = default_cache
    check(autotune.cache_path() != path, "the autotune phase would use the default cache")
    t0 = time.perf_counter()
    results = autotune.tune_all(budget="full")
    tune_s = time.perf_counter() - t0
    sizes = {}
    for op, per in results.items():
        for backend, e in per.items():
            emit("autotune", op=op, backend=backend,
                 **{k: e.get(k) for k in ("config", "us", "numpy_us", "rel_err",
                                          "size", "bucket", "launch",
                                          "candidates", "failed", "skipped")})
            check("skipped" not in e, f"{op}/{backend} skipped: {e.get('skipped')}")
            check(not e["failed"], f"{op}/{backend} candidates failed: {e['failed']}")
            check("config" in e, f"{op}/{backend}: no candidate ran")
            sizes[op] = e["size"]
            for c in e["candidates"]:
                cfg = c["config"]
                if backend == "cuda" and (cfg.get("dtype") == "float64"
                                          or cfg.get("variant") == "f64"):
                    check(c["rel_err"] == 0.0,
                          f"{op}/cuda {cfg}: float64 rel_err {c['rel_err']}")
                if cfg.get("compensated"):
                    check(c["rel_err"] <= autotune.PARITY_RTOL,
                          f"{op}/{backend} {cfg}: certificate {c['rel_err']}")
    cache = autotune.get_cache()
    saved = json.loads(json.dumps(cache.entries))
    doc = json.loads(cache.path.read_text())
    autotune.reset_cache()
    cache = autotune.get_cache()
    check(cache.loaded_from_disk and cache.entries == saved
          and doc["fingerprint"] == autotune.kernel_fingerprint()
          and len(saved) == 2 * len(results),
          "the saved tuning cache did not reload with its entries")
    picks = {}
    for mode in ("f64", "compensated", "fast"):
        os.environ[autotune.PRECISION_ENV_VAR] = mode
        picks[mode] = {op: autotune.tuned_backend(op, size) for op, size in sizes.items()}
    os.environ.pop(autotune.PRECISION_ENV_VAR)
    for op in sizes:
        if op in ops.PINNED_OPS:
            check(picks["f64"][op] is None, f"f64 mode lifted the pin of {op}")
        for mode in picks:
            check(picks[mode][op] in (None, "cuda"),
                  f"{mode} mode sends {op} off the card to {picks[mode][op]}")
    emit("autotune_picks", seconds=tune_s, cache=str(cache.path), entries=len(saved),
         fingerprint=doc["fingerprint"], device=autotune.device_kind(),
         tuned_backend=picks)
    # warm-cache dispatch: no backend and no config, at each tuned size
    dispatched = {}
    for op in sizes:
        call_of, size, _ = autotune._problem(op, np.random.default_rng(0), False)
        check(size == sizes[op], f"{op}: tuned at {sizes[op]}, dispatched at {size}")
        selected = ops.select_backend(op, size)
        check(selected == "cuda", f"{op}: the warm cache selects {selected}, not the card")
        planned = autotune.plan(op, selected, size)
        consults = _consults(autotune)
        ops.reset_dispatch_counts()
        launched = {name: k.launches for name, k in kernels.items()}
        call_of(None, None)()
        launched = {name: k.launches - launched[name] for name, k in kernels.items()
                    if k.launches != launched[name]}
        check(set(launched) == {_planned_kernel(op, planned)}
              and ops.dispatch_counts() == {(op, selected): 1},
              f"{op}: dispatch took {ops.dispatch_counts()} and launched {launched}; "
              f"the cache selects {selected} with config {planned}")
        check(_consults(autotune) == consults + 1,
              f"{op}: the {selected} backend did not consult its plan once")
        dispatched[op] = {"size": size, "selected": selected, "config": planned,
                          "launched": launched}
    emit("autotune_dispatch", dispatched=dispatched,
         counters=autotune.counters_snapshot(), ops_snapshot=ops.snapshot())
    check(_file_state(path) == state, f"the default cache {path} changed")


def main() -> int:
    import torch
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-rank":
        print(json.dumps(mesh_rank(json.loads(sys.argv[2]))), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    with cold_tuning_cache() as default_cache:
        return run(default_cache)


def run(default_cache) -> int:
    import numpy as np
    import torch

    from repro_torch import ops
    from repro_torch.configs import CONFIG
    from repro_torch.core import (PrefixStats, fitting_loss,
                                  random_tree_segmentation, signal_coreset)
    from repro_torch.data import patch_mask, piecewise_signal, sensor_matrix
    from repro_torch.kernels.sat2d import kernel as sat_kernel
    from repro_torch.trees import best_segmentation

    # the wall seconds of each part of the run, emitted before the kernel table
    marks = [("start", time.perf_counter())]

    def mark(name):
        marks.append((name, time.perf_counter()))

    smi = phase_device()
    ptxas = phase_build()
    mark("build")

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
    mark("kernels")

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
    s32 = ops.sat_moments(y, config={"dtype": "float32"})
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
    mark("build_path")

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
    mark("hist_kernels")
    del roots["raster_2^24"]
    rows += hist_rows

    kernels = {r["name"]: r["kernel"] for r in rows}
    tuning_counts = phase_tuning(ys, train, test, kernels)
    mark("tuning")
    counts.update({name: c for name, c in tuning_counts.items()
                   if name.startswith("hist_")})
    variant_counts = phase_variants(roots["coreset_root"], kernels)
    mark("variants")
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
    mark("write_path")
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
    d32 = ops.delta_sat(carry, tail, config={"dtype": "float32"})
    d64 = ops.delta_sat(carry, tail)
    own3["sat_delta_f32"] = kern.launches
    d32_err = float((np.abs(d32 - d64) / np.abs(d64).max(axis=(1, 2), keepdims=True)).max())
    check(d32_err <= SAT_F32_TOL, f"float32 delta_sat vs float64: {d32_err}")
    kern = kernels["sat_stack_f32"]
    kern.launches = 0
    rc32 = ops.streaming_compress(level1, config={"dtype": "float32"})
    own3["sat_stack_f32"] = kern.launches
    for a, b in zip(rc32, level1):
        check(np.isclose(a.total_mass(), b.total_mass()),
              "float32 streaming_compress lost mass")
    del d32, d64, rc32
    emit("write_counts", launches=path3, outside_main_path=own3,
         float32_delta_scaled_err=d32_err)
    mark("stream")
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
    mark("lm_kernels")
    rows += fa_rows
    kernels = {r["name"]: r["kernel"] for r in rows}
    lm_counts = phase_lm_serve(kernels, {r["name"]: r for r in fa_rows})
    mark("lm_serve")
    counts.update(lm_counts)
    ssm_counts = phase_lm_serve_ssm(kernels)
    mark("lm_serve_ssm")
    moe_counts = phase_lm_serve_moe(kernels)
    mark("lm_serve_moe")
    frontend_counts = phase_lm_serve_frontends(kernels)
    mark("lm_serve_frontends")

    # ---------------------------------------------------- LM training
    train_counts, full_losses = phase_lm_train(kernels, smi)
    mark("lm_train")
    train_families_counts = phase_lm_train_families(kernels, smi)
    mark("lm_train_families")
    train_dp_counts = phase_lm_train_dp(kernels, smi, full_losses)
    mark("lm_train_dp")
    # lm_dryrun (b)'s cells (CPU only) run beside lm_train_tp's untimed
    # part, once its full-width steps are over
    cells = {}
    try:
        train_tp_counts = phase_lm_train_tp(
            kernels, smi, on_full_done=lambda: cells.update(_dryrun_cells()))
        phase_lm_dryrun(kernels, smi, cells)
    finally:
        for proc in cells.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.communicate()
    mark("lm_train_tp+lm_dryrun")

    # ------------------------------------------------- the coreset server
    serve_counts, serve = phase_coreset_serve(kernels, smi)
    mark("coreset_serve")

    # ------------------------------------- the distributed serving plane
    cluster_counts = phase_coreset_cluster(kernels, smi, serve)
    mark("coreset_cluster")

    # ------------------------------------------------------------ the mesh
    mesh_counts = phase_coreset_mesh(
        smi, serve, next(r["ms"] for r in rows if r["name"] == "sat_moments_f32"))
    mark("coreset_mesh")

    # ---------------------------------- the server's gates and the examples
    gates_counts = phase_coreset_gates(kernels, smi)
    mark("coreset_gates")

    # ------------------------------------ the op layer's tuning contract
    phase_autotune(kernels, default_cache)
    mark("autotune")

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
                      "serving_launches": serve_counts[r["name"]],
                      "cluster_launches": cluster_counts[r["name"]],
                      "mesh_launches": mesh_counts.get(r["name"], 0),
                      "gates_launches": gates_counts[r["name"]],
                      "train_launches": train_counts[r["name"]],
                      "train_families_launches": train_families_counts[r["name"]],
                      "train_dp_launches": train_dp_counts[r["name"]],
                      "train_tp_launches": train_tp_counts[r["name"]],
                      "ssm_launches": ssm_counts[r["name"]],
                      "moe_launches": moe_counts[r["name"]],
                      "frontend_launches": frontend_counts[r["name"]],
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
    emit("timeline", seconds={name: t - marks[i][1]
                              for i, (name, t) in enumerate(marks[1:])},
         total=marks[-1][1] - marks[0][1])
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
