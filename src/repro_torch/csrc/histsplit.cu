// histsplit: the CART split histograms, per-(feature, bin) sums of the value
// channels (w, w*y, w*y^2) of P points with uint8 bin codes.
//
// Replaces src/repro/kernels/histsplit/kernel.py::histograms_kernel_call in
// all three of its variants:
//   variant="fused"    (body _hist_kernel)          -> hist_fused_f32
//   variant="partials" (body _hist_kernel_partials) -> hist_partials_f32
//   variant="legacy"   (body _hist_kernel_legacy)   -> hist_legacy_f32
// and adds hist_f64, the float64 variant the trees use, which equals numpy's
// np.bincount(codes[rows, f], weights=...[rows], minlength=n_bins) bitwise
// over a node's ascending rows, and hist_f64_node, one tree node's round
// trip (its rows in, its sums out) in one call.
//
// The float32 variants' contract: each (P-tile, feature, bin, channel) sum
// is one chain of __fadd_rn adds from +0.0 over the tile's points with that
// code in ascending point order, with no atomics.  The Pallas fused and
// legacy kernels accumulate in place over the P tiles, which is sound only
// on the TPU's sequential grid.  Here fused and legacy end with a second
// kernel (reduce_ring_kernel) that sums each output element's tile partials
// in tile order, so their result does not change from run to run and
// legacy's equals fused's bitwise; partials returns the per-tile partials
// and the host sums them in float64.
//
// fused, partials, legacy: a stable counting sort inside each tile
// (hist_sort_kernel).  A CTA of 256 threads takes one P-tile and a range of
// features (hist_f32_launch_shape).  Legacy keeps the Pallas legacy
// kernel's (F, P/TP) grid at every size, one CTA a (P-tile, feature): the
// reference keeps that grid so its autotuner can measure it against fused.
// Fused and partials take one CTA a tile once the tiles fill the card, else
// a CTA a (tile, feature group).  A CTA takes the tile in sub-chunks of
// SUB = 2048 points (tile_p is the caller's, up to 2^31):
//   1. stage   the sub-chunk's values (SUB x S floats, contiguous) go to
//              shared memory by 16-byte cp.async, which runs while the CTA
//              ranks; once for all the CTA's features when the tile is one
//              sub-chunk, else once a (feature, sub-chunk): F reads of the
//              values for tiles past SUB points, and in legacy's grid,
//              where each CTA stages its own, at every tile size;
//   2. rank    each warp takes a run of consecutive points, 32 at a time,
//              and ranks each among the points of its code in point order
//              (__match_any_sync and the __popc of the lower lanes), keeping
//              the warp's count of each bin in shared memory;
//   3. place   a bin's start (an exclusive scan over the bins of their
//              counts) plus the counts of its code in lower warps plus the
//              rank is the point's place; each point copies its S values
//              there, in a second (SUB, S) buffer;
//   4. sums    one lane a (bin, channel) walks its channel of the bin's
//              segment: one chain, loaded a batch of 16 ahead of the adds
//              (the S lanes of a bin read neighbouring words: no bank
//              conflict).  A tile of several sub-chunks carries each
//              chain in its partial, which the lane writes and reads back.
// Integer counts are exact in any order and no place comes from an atomic,
// so every chain is the contract's, the same at every sub-chunk size and
// launch shape.  The work is O(P x F).  A tile whose points share one bin
// is S chains of tile_p adds (the contract's order, on S lanes): then the
// adds' latency, ~4 cycles a point, sets the tile's time.
// The tile sum (fused's and legacy's, reduce_ring_kernel): a CTA a 32
// outputs keeps RING_STAGES - 1 stages of 128 tiles in flight by cp.async
// while warp 0's lanes run the 32 chains: at 2^24 points (8,192 tiles,
// 1,536 outputs) that is 48 CTAs of 32 chains.
// Bound.  Each point's codes (F bytes) and values (S x 4 bytes) read once,
// the (tiles, F, n_bins, S) partials written once (fused reads them back).
// Legacy's grid reads the values once a (tile, feature): F x S x 4 bytes a
// point.
//
// hist_f64: a stable counting sort, then ordered segment sums.
// Its contract is numpy's: each (feature, bin, channel) sum is one chain of
// __dadd_rn adds from +0.0 over the node's points in ascending row order.
// A tree reduction or a float atomic would change the rounding, so the
// design moves the points instead of splitting the chains:
//   1. count   one CTA per (chunk of rows, feature) counts the points of
//              each bin in shared memory (integer atomics, exact in any
//              order; a warp's equal codes are added once, by their
//              leader, through __match_any_sync);
//   2. scan    an exclusive scan over (bin, chunk) per feature gives each
//              chunk its start inside each bin's segment;
//   3. scatter each chunk ranks its points among those of the same code in
//              row order (within a warp __match_any_sync and __popc of the
//              lower lanes, across warps in warp order, across steps of
//              the chunk in step order) and writes their values to that
//              place in the feature's sorted buffer.  No rank comes from an
//              atomic, so the buffer is the same from run to run;
//   4. sums    one warp per (feature, bin) walks its contiguous segment:
//              the lanes stage it in shared memory a tile at a time,
//              coalesced, and load the next tile while lane 0 runs the
//              three interleaved chains over the staged one (shuffling
//              each value to every lane cost ~45 cycles a point: the
//              shuffle's latency sat on the chain).
// A node of at most SMALL_ROWS points runs all four passes in one CTA per
// feature, in shared memory, in one launch (every node of the tuning
// path's coreset and uniform-sample trees: their roots hold 2,112 points).
// Bound.  A node reads its rows (4 bytes), the codes of one row (F bytes)
// and its values (24 bytes) once and writes F x n_bins x 24 bytes.  The
// chains set a floor beside it: the longest segment is that many dependent
// float64 adds.  When every point lies in one bin that chain is n adds
// long; that is numpy's own order and it cannot be split.
#include <algorithm>
#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int MAX_BINS = 1024;  // the bins one CTA holds (MAX_BINS in kernel.py)

// ------------------------------------------------------------------ hist_f64
constexpr int ROWS_THREADS = 256;                    // 8 warps a CTA
constexpr int ROWS_WARPS = ROWS_THREADS / 32;
constexpr int BIN_SLOTS = MAX_BINS / ROWS_THREADS;  // bins a thread owns
constexpr int SMALL_ROWS = 4096;   // nodes up to this run in one CTA a feature
constexpr int MIN_CHUNK = 1024;    // rows a CTA takes in passes 1 and 3
constexpr int MAX_CHUNKS = 2048;   // chunks per node at most
constexpr int SEG_WARPS = 4;       // pass 4: warps a CTA, one (feature, bin) each
constexpr int SEG_TILE = 256;      // pass 4: points a warp stages at a time
constexpr int SEG_REGS = SEG_TILE * 3 / 32;  // doubles a lane loads a tile

__host__ __device__ inline long long chunk_rows(long long n) {
  long long c = (n + MAX_CHUNKS - 1) / MAX_CHUNKS;
  c = (c + ROWS_THREADS - 1) / ROWS_THREADS * ROWS_THREADS;
  return c < MIN_CHUNK ? MIN_CHUNK : c;
}

inline long long align16(long long b) { return (b + 15) / 16 * 16; }

// Scratch of a node of n rows: counts (F, n_bins, C) and totals (F, n_bins)
// int32, then the sorted values (F, n, 3) float64.  Sized with the largest
// chunk count of any node up to n rows, so one buffer serves every node of a
// resident set.
long long scratch_bytes(long long n, int F, int n_bins) {
  const long long C =
      std::min((n + MIN_CHUNK - 1) / MIN_CHUNK, static_cast<long long>(MAX_CHUNKS));
  return align16(static_cast<long long>(F) * n_bins * (C + 1) * 4) +
         static_cast<long long>(F) * n * 24;
}

__device__ __forceinline__ long long row_at(const int* rows, long long i) {
  return rows ? static_cast<long long>(rows[i]) : i;
}

// In-place exclusive scan of v[0, n) in shared memory, n <= MAX_BINS;
// tmp holds ROWS_THREADS ints.  Integer adds: exact in any order.  Every
// thread of the CTA calls it.
__device__ void scan_bins(int* v, int n, int* tmp) {
  const int t = threadIdx.x;
  int loc[BIN_SLOTS], sum = 0;
#pragma unroll
  for (int k = 0; k < BIN_SLOTS; ++k) {
    const int b = t * BIN_SLOTS + k;
    loc[k] = b < n ? v[b] : 0;
    sum += loc[k];
  }
  tmp[t] = sum;
  __syncthreads();
  for (int off = 1; off < ROWS_THREADS; off <<= 1) {
    const int x = t >= off ? tmp[t - off] : 0;
    __syncthreads();
    tmp[t] += x;
    __syncthreads();
  }
  int run = tmp[t] - sum;
#pragma unroll
  for (int k = 0; k < BIN_SLOTS; ++k) {
    const int b = t * BIN_SLOTS + k;
    if (b < n) v[b] = run;
    run += loc[k];
  }
  __syncthreads();
}

// Count one chunk's codes of feature f into cnt[n_bins] (shared, zeroed);
// thread t of each step holds row i0 + step + t.
__device__ void count_codes(const uint8_t* __restrict__ codes, const int* __restrict__ rows,
                            long long i0, long long i1, int F, int f, int* cnt,
                            uint8_t* keep) {
  for (long long base = i0; base < i1; base += ROWS_THREADS) {
    const long long i = base + threadIdx.x;
    const int code = i < i1 ? codes[row_at(rows, i) * F + f] : -1;
    if (keep && code >= 0) keep[i - i0] = static_cast<uint8_t>(code);
    const unsigned peers = __match_any_sync(0xffffffffu, code);
    if (code >= 0 && (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0)
      atomicAdd(&cnt[code], __popc(peers));
  }
}

// Stable places of one step of up to ROWS_THREADS points, one a thread in
// row order (code -1: no point).  A point's place is run[code] plus the
// points of its code in lower lanes of its warp and in lower warps; run then
// moves past the step's points.  wcount (ROWS_WARPS, n_bins) is zero on
// entry and on exit.  Every thread of the CTA calls it.
__device__ int stable_place(int code, int n_bins, int* run, int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned peers = __match_any_sync(0xffffffffu, code);
  const unsigned lower = peers & ((1u << lane) - 1u);
  const bool leader = code >= 0 && lower == 0;
  if (leader) wcount[warp * n_bins + code] = __popc(peers);
  __syncthreads();
  int place = 0;
  if (code >= 0) {
    place = run[code] + __popc(lower);
    for (int w = 0; w < warp; ++w) place += wcount[w * n_bins + code];
  }
  int tot[BIN_SLOTS];
#pragma unroll
  for (int k = 0; k < BIN_SLOTS; ++k) {
    const int b = threadIdx.x + k * ROWS_THREADS;
    tot[k] = 0;
    if (b < n_bins)
      for (int w = 0; w < ROWS_WARPS; ++w) tot[k] += wcount[w * n_bins + b];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < BIN_SLOTS; ++k) {
    const int b = threadIdx.x + k * ROWS_THREADS;
    if (b < n_bins) run[b] += tot[k];
  }
  if (leader) wcount[warp * n_bins + code] = 0;
  __syncthreads();
  return place;
}

// Pass 1: counts[f][b][c] of chunk c = blockIdx.x, feature f = blockIdx.y.
__global__ void __launch_bounds__(ROWS_THREADS)
rows_count_kernel(const uint8_t* __restrict__ codes, const int* __restrict__ rows, long long n,
                  int F, int n_bins, long long chunk, int C, int* __restrict__ counts) {
  __shared__ int cnt[MAX_BINS];
  const int f = blockIdx.y, c = blockIdx.x;
  for (int b = threadIdx.x; b < n_bins; b += ROWS_THREADS) cnt[b] = 0;
  __syncthreads();
  const long long i0 = c * chunk, i1 = min(n, i0 + chunk);
  count_codes(codes, rows, i0, i1, F, f, cnt, nullptr);
  __syncthreads();
  for (int b = threadIdx.x; b < n_bins; b += ROWS_THREADS)
    counts[(static_cast<long long>(f) * n_bins + b) * C + c] = cnt[b];
}

// Pass 2: counts[f][b][:] to exclusive offsets over the chunks, in place,
// and totals[f][b]; CTA (b, f).
__global__ void __launch_bounds__(ROWS_THREADS)
rows_scan_kernel(int* __restrict__ counts, int* __restrict__ totals, int n_bins, int C) {
  __shared__ int tmp[ROWS_THREADS];
  const long long seg = static_cast<long long>(blockIdx.y) * n_bins + blockIdx.x;
  int* p = counts + seg * C;
  const int t = threadIdx.x, per = (C + ROWS_THREADS - 1) / ROWS_THREADS;
  const int j0 = min(C, t * per), j1 = min(C, j0 + per);
  int sum = 0;
  for (int j = j0; j < j1; ++j) sum += p[j];
  tmp[t] = sum;
  __syncthreads();
  for (int off = 1; off < ROWS_THREADS; off <<= 1) {
    const int x = t >= off ? tmp[t - off] : 0;
    __syncthreads();
    tmp[t] += x;
    __syncthreads();
  }
  int run = tmp[t] - sum;
  for (int j = j0; j < j1; ++j) {
    const int x = p[j];
    p[j] = run;
    run += x;
  }
  if (t == ROWS_THREADS - 1) totals[seg] = tmp[ROWS_THREADS - 1];
}

// Pass 3: chunk c = blockIdx.x of feature f = blockIdx.y places its points'
// values in sorted (F, n, 3): the bin's start (a scan of the totals), the
// chunk's offset in the bin, then the stable rank.
__global__ void __launch_bounds__(ROWS_THREADS)
rows_scatter_kernel(const uint8_t* __restrict__ codes, const double* __restrict__ vals,
                    const int* __restrict__ rows, long long n, int F, int n_bins,
                    long long chunk, int C, const int* __restrict__ offsets,
                    const int* __restrict__ totals, double* __restrict__ sorted) {
  __shared__ int run[MAX_BINS];
  __shared__ int wcount[ROWS_WARPS * MAX_BINS];
  __shared__ int tmp[ROWS_THREADS];
  const int f = blockIdx.y, c = blockIdx.x;
  for (int b = threadIdx.x; b < n_bins; b += ROWS_THREADS) {
    run[b] = totals[static_cast<long long>(f) * n_bins + b];
    for (int w = 0; w < ROWS_WARPS; ++w) wcount[w * n_bins + b] = 0;
  }
  __syncthreads();
  scan_bins(run, n_bins, tmp);
  for (int b = threadIdx.x; b < n_bins; b += ROWS_THREADS)
    run[b] += offsets[(static_cast<long long>(f) * n_bins + b) * C + c];
  __syncthreads();
  double* out = sorted + static_cast<long long>(f) * n * 3;
  const long long i0 = c * chunk, i1 = min(n, i0 + chunk);
  for (long long base = i0; base < i1; base += ROWS_THREADS) {
    const long long i = base + threadIdx.x;
    const long long r = i < i1 ? row_at(rows, i) : 0;
    const int code = i < i1 ? codes[r * F + f] : -1;
    const int place = stable_place(code, n_bins, run, wcount);
    if (code >= 0)
      for (int s = 0; s < 3; ++s) out[static_cast<long long>(place) * 3 + s] = vals[r * 3 + s];
  }
}

// Pass 4: warp g = (f, b) sums its segment of sorted in order.  The lanes
// stage SEG_TILE points at a time in shared memory (coalesced loads, each
// lane SEG_REGS doubles) and load the next tile into registers while lane 0
// runs the three chains over the staged one, eight points of loads ahead of
// their adds.
__global__ void __launch_bounds__(SEG_WARPS * 32)
rows_sum_kernel(const double* __restrict__ sorted, const int* __restrict__ totals, long long n,
                int F, int n_bins, double* __restrict__ out) {
  __shared__ __align__(16) double tile[SEG_WARPS][SEG_TILE * 3];
  const int lane = threadIdx.x & 31;
  const long long g = static_cast<long long>(blockIdx.x) * SEG_WARPS + (threadIdx.x >> 5);
  if (g >= static_cast<long long>(F) * n_bins) return;
  const int f = static_cast<int>(g / n_bins), b = static_cast<int>(g % n_bins);
  const int* tot = totals + static_cast<long long>(f) * n_bins;
  long long start = 0;
  for (int j = lane; j < b; j += 32) start += tot[j];
  for (int off = 16; off > 0; off >>= 1) start += __shfl_xor_sync(0xffffffffu, start, off);
  const long long len = tot[b];
  const double* seg = sorted + (static_cast<long long>(f) * n + start) * 3;
  double* buf = tile[threadIdx.x >> 5];
  double reg[SEG_REGS];
#pragma unroll
  for (int q = 0; q < SEG_REGS; ++q) {
    const long long e = q * 32 + lane;
    reg[q] = e < len * 3 ? seg[e] : 0.0;
  }
  double a0 = 0.0, a1 = 0.0, a2 = 0.0;
  for (long long t0 = 0; t0 < len; t0 += SEG_TILE) {
#pragma unroll
    for (int q = 0; q < SEG_REGS; ++q) buf[q * 32 + lane] = reg[q];
    __syncwarp();
    const long long t1 = t0 + SEG_TILE;
#pragma unroll
    for (int q = 0; q < SEG_REGS; ++q) {  // the next tile, in flight
      const long long e = t1 * 3 + q * 32 + lane;
      reg[q] = e < len * 3 ? seg[e] : 0.0;
    }
    if (lane == 0) {
      const int m = static_cast<int>(min(static_cast<long long>(SEG_TILE), len - t0));
      int j = 0;
      for (; j + 8 <= m; j += 8) {  // eight points' loads, then their adds
        const double2* p = reinterpret_cast<const double2*>(buf + j * 3);
        double2 v[12];
#pragma unroll
        for (int q = 0; q < 12; ++q) v[q] = p[q];
#pragma unroll
        for (int i = 0; i < 24; i += 6) {  // two points a double2 triple
          a0 = add_rn(a0, v[i / 2].x);
          a1 = add_rn(a1, v[i / 2].y);
          a2 = add_rn(a2, v[i / 2 + 1].x);
          a0 = add_rn(a0, v[i / 2 + 1].y);
          a1 = add_rn(a1, v[i / 2 + 2].x);
          a2 = add_rn(a2, v[i / 2 + 2].y);
        }
      }
      for (; j < m; ++j) {
        a0 = add_rn(a0, buf[j * 3]);
        a1 = add_rn(a1, buf[j * 3 + 1]);
        a2 = add_rn(a2, buf[j * 3 + 2]);
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    double* o = out + g * 3;
    o[0] = a0;
    o[1] = a1;
    o[2] = a2;
  }
}

// All four passes for a node of n <= SMALL_ROWS points, one CTA a feature,
// in dynamic shared memory: the sorted values (n, 3), the codes (n), run and
// wcount.
__global__ void __launch_bounds__(ROWS_THREADS)
rows_small_kernel(const uint8_t* __restrict__ codes, const double* __restrict__ vals,
                  const int* __restrict__ rows, int n, int F, int n_bins,
                  double* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_sorted = reinterpret_cast<double*>(smem);
  int* run = reinterpret_cast<int*>(s_sorted + 3 * n);
  int* wcount = run + n_bins;
  int* tmp = wcount + ROWS_WARPS * n_bins;
  uint8_t* s_code = reinterpret_cast<uint8_t*>(tmp + ROWS_THREADS);
  const int f = blockIdx.x;
  for (int b = threadIdx.x; b < n_bins; b += ROWS_THREADS) {
    run[b] = 0;
    for (int w = 0; w < ROWS_WARPS; ++w) wcount[w * n_bins + b] = 0;
  }
  __syncthreads();
  count_codes(codes, rows, 0, n, F, f, run, s_code);                 // 1
  __syncthreads();
  scan_bins(run, n_bins, tmp);                                       // 2
  for (int base = 0; base < n; base += ROWS_THREADS) {               // 3
    const int i = base + threadIdx.x;
    const int code = i < n ? s_code[i] : -1;
    const int place = stable_place(code, n_bins, run, wcount);
    if (code >= 0) {
      const long long r = row_at(rows, i);
      for (int s = 0; s < 3; ++s) s_sorted[place * 3 + s] = vals[r * 3 + s];
    }
  }
  __syncthreads();  // the last step's values are in place
  // 4: run[b] is now the end of bin b's segment, run[b - 1] its start
  for (int b = threadIdx.x; b < n_bins; b += ROWS_THREADS) {
    const int j0 = b ? run[b - 1] : 0, j1 = run[b];
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      a0 = add_rn(a0, s_sorted[j * 3]);
      a1 = add_rn(a1, s_sorted[j * 3 + 1]);
      a2 = add_rn(a2, s_sorted[j * 3 + 2]);
    }
    double* o = out + (static_cast<long long>(f) * n_bins + b) * 3;
    o[0] = a0;
    o[1] = a1;
    o[2] = a2;
  }
}

size_t small_smem(int n, int n_bins) {
  return static_cast<size_t>(n) * 24 + static_cast<size_t>(n_bins) * 4 * (1 + ROWS_WARPS) +
         ROWS_THREADS * 4 + n;
}

int launch_rows(const uint8_t* codes, const double* vals, const int* rows, long long n,
                void* scratch, double* out, int F, int n_bins, cudaStream_t s) {
  if (n == 0) {
    const cudaError_t e =
        cudaMemsetAsync(out, 0, static_cast<size_t>(F) * n_bins * 3 * sizeof(double), s);
    return e != cudaSuccess ? e : cudaGetLastError();
  }
  if (n <= SMALL_ROWS) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        rows_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(small_smem(SMALL_ROWS, MAX_BINS)));
    if (attr != cudaSuccess) return attr;
    rows_small_kernel<<<F, ROWS_THREADS, small_smem(static_cast<int>(n), n_bins), s>>>(
        codes, vals, rows, static_cast<int>(n), F, n_bins, out);
    return cudaGetLastError();
  }
  const long long chunk = chunk_rows(n);
  const int C = static_cast<int>((n + chunk - 1) / chunk);
  int* counts = static_cast<int*>(scratch);
  int* totals = counts + static_cast<long long>(F) * n_bins * C;
  double* sorted = reinterpret_cast<double*>(
      static_cast<char*>(scratch) + align16(static_cast<long long>(F) * n_bins * (C + 1) * 4));
  rows_count_kernel<<<dim3(C, F), ROWS_THREADS, 0, s>>>(codes, rows, n, F, n_bins, chunk, C,
                                                        counts);
  rows_scan_kernel<<<dim3(n_bins, F), ROWS_THREADS, 0, s>>>(counts, totals, n_bins, C);
  rows_scatter_kernel<<<dim3(C, F), ROWS_THREADS, 0, s>>>(codes, vals, rows, n, F, n_bins, chunk,
                                                          C, counts, totals, sorted);
  const long long warps = static_cast<long long>(F) * n_bins;
  rows_sum_kernel<<<static_cast<unsigned>((warps + SEG_WARPS - 1) / SEG_WARPS), SEG_WARPS * 32, 0,
                    s>>>(sorted, totals, n, F, n_bins, out);
  return cudaGetLastError();
}

// ------------------------------------------------------- fused and partials
constexpr int SORT_THREADS = 256;                   // 8 warps a CTA
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_PPL = 8;                         // points a lane ranks
constexpr int SUB = SORT_THREADS * SORT_PPL;        // points a sub-chunk
constexpr int SORT_SLOTS = MAX_BINS / SORT_THREADS;  // bins a thread scans
constexpr int CHAIN_U = 16;                         // a chain's loads run a batch ahead
constexpr int RING_ROWS = 128;                      // tile partials a ring stage
constexpr int RING_STAGES = 4;
constexpr unsigned FULL = 0xffffffffu;

// Shared memory of hist_sort_kernel: the staged values (SUB x S floats and
// 4 of slack, so the copy can take the global address's alignment), the
// sorted values (SUB x S), the warps' counts (SORT_WARPS, n_bins;
// 16 bits: a warp ranks SORT_PPL x 32 points), the bins' starts (n_bins +
// 1) and the scan's warp sums.
__host__ __device__ constexpr long long sort_vals_bytes(int S) { return (SUB * S + 4) * 4LL; }

__host__ __device__ inline long long sort_smem(int S, int n_bins) {
  return 2 * sort_vals_bytes(S) + (n_bins + 1 + SORT_WARPS) * 4LL + SORT_WARPS * 2LL * n_bins;
}

// The launch: tiles; feature groups (CTAs a tile); features a CTA; CTAs.
// Legacy (one_feature) takes F groups of one feature at every size; fused
// and partials 1 group once the tiles fill the SMs, else enough to fill
// them, at most F.
struct SortShape {
  long long tiles, groups, per_cta, ctas;
};

SortShape sort_shape(long long P, int F, int tile_p, int sms, bool one_feature) {
  SortShape sh;
  sh.tiles = (P + tile_p - 1) / tile_p;
  long long g = one_feature ? F : 1;
  if (!one_feature && sh.tiles < sms)
    g = std::min<long long>(F, (sms + sh.tiles - 1) / sh.tiles);
  sh.per_cta = (F + g - 1) / g;
  sh.groups = (F + sh.per_cta - 1) / sh.per_cta;
  sh.ctas = sh.tiles * sh.groups;
  return sh;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of the values of points [q0, q0 + cnt) to shared memory by
// 16-byte cp.async, which holds no registers and runs while the CTA ranks:
// the copy starts as far into s_raw (16-byte aligned) as the first value
// lies past a 16-byte boundary, so the middle moves 16 bytes at a time and
// at most 3 floats at each end one by one.  Returns the first value's
// place.  Every thread of the CTA calls it; each waits for its own copies
// (cp_async_wait<0>) before the barrier ahead of the first read.
template <int S>
__device__ const float* stage_vals(const float* __restrict__ vals, long long q0, int cnt,
                                   float* s_raw) {
  const int t = threadIdx.x;
  const float* g = vals + q0 * S;
  const int n = cnt * S;
  const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  float* s = s_raw + mis;
  const int head = min(n, (4 - mis) & 3);
  const int nv = (n - head) >> 2;
  for (int v = t; v < nv; v += SORT_THREADS) cp_async16(s + head + 4 * v, g + head + 4 * v);
  cp_async_commit();
  const int tail = head + nv * 4;
  if (t < head) s[t] = g[t];
  if (t < n - tail) s[tail + t] = g[tail + t];
  return s;
}

// In-place exclusive scan of v[0, n) in shared memory, n <= MAX_BINS,
// SORT_SLOTS consecutive entries a thread; wsum holds SORT_WARPS ints.
// Integer adds: exact in any order.  Every thread of the CTA calls it.
__device__ void scan_counts(int* v, int n, int* wsum) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int loc[SORT_SLOTS], sum = 0;
#pragma unroll
  for (int k = 0; k < SORT_SLOTS; ++k) {
    const int b = t * SORT_SLOTS + k;
    loc[k] = b < n ? v[b] : 0;
    sum += loc[k];
  }
  int inc = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += x;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int run = inc - sum;
  for (int w = 0; w < warp; ++w) run += wsum[w];
#pragma unroll
  for (int k = 0; k < SORT_SLOTS; ++k) {
    const int b = t * SORT_SLOTS + k;
    if (b < n) v[b] = run;
    run += loc[k];
  }
  __syncthreads();
}

// acc + x[0] + x[STRIDE] + ... + x[(n - 1) * STRIDE], one __fadd_rn at a
// time in that order, x in shared memory.  The adds are the chain; two
// batches of CHAIN_U values take turns, one loading while the other is
// added, so the chain waits on the adds' latency and not on the loads'.
template <int STRIDE>
__device__ __forceinline__ float chain(const float* x, int n, float acc) {
  float a[CHAIN_U], b[CHAIN_U];
  int k = 0;
  if (n >= CHAIN_U) {
#pragma unroll
    for (int u = 0; u < CHAIN_U; ++u) a[u] = x[u * STRIDE];
    for (k = CHAIN_U;; ) {
      if (k + CHAIN_U > n) {
#pragma unroll
        for (int u = 0; u < CHAIN_U; ++u) acc = add_rn(acc, a[u]);
        break;
      }
#pragma unroll
      for (int u = 0; u < CHAIN_U; ++u) b[u] = x[(k + u) * STRIDE];
#pragma unroll
      for (int u = 0; u < CHAIN_U; ++u) acc = add_rn(acc, a[u]);
      k += CHAIN_U;
      if (k + CHAIN_U > n) {
#pragma unroll
        for (int u = 0; u < CHAIN_U; ++u) acc = add_rn(acc, b[u]);
        break;
      }
#pragma unroll
      for (int u = 0; u < CHAIN_U; ++u) a[u] = x[(k + u) * STRIDE];
#pragma unroll
      for (int u = 0; u < CHAIN_U; ++u) acc = add_rn(acc, b[u]);
      k += CHAIN_U;
    }
  }
  for (; k < n; ++k) acc = add_rn(acc, x[k * STRIDE]);
  return acc;
}

// partial (C, F, n_bins, S): CTA x = P-tile c, CTA y = the group of
// per_cta features it bins.  Each (bin, channel) chain is one lane's; a
// tile of several sub-chunks carries it in the partial, which the lane
// reads back (its own write) at the next sub-chunk.
template <int S>
__global__ void __launch_bounds__(SORT_THREADS)
hist_sort_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ vals,
                 float* __restrict__ partial, long long P, int F, int n_bins, int tile_p,
                 int per_cta) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_raw = reinterpret_cast<float*>(smem);
  float* sorted = reinterpret_cast<float*>(smem + sort_vals_bytes(S));
  int* start = reinterpret_cast<int*>(smem + 2 * sort_vals_bytes(S));
  int* wsum = start + n_bins + 1;
  uint16_t* wcnt = reinterpret_cast<uint16_t*>(wsum + SORT_WARPS);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long c = blockIdx.x;
  const long long p0 = c * tile_p, p1 = min(P, p0 + tile_p);
  const int f0 = static_cast<int>(blockIdx.y) * per_cta, f1 = min(F, f0 + per_cta);
  const bool once = p1 - p0 <= SUB;   // one sub-chunk: its values serve every feature
  uint16_t* wc = wcnt + warp * n_bins;
  for (int e = t; e < SORT_WARPS * n_bins; e += SORT_THREADS) wcnt[e] = 0;
  const float* sv = once ? stage_vals<S>(vals, p0, static_cast<int>(p1 - p0), s_raw) : nullptr;
  for (int f = f0; f < f1; ++f) {
    float* o = partial + (c * F + f) * n_bins * S;
    for (long long q0 = p0; q0 < p1; q0 += SUB) {
      const int cnt = static_cast<int>(min(static_cast<long long>(SUB), p1 - q0));
      __syncthreads();  // the last chains have read the sorted values
      if (!once) sv = stage_vals<S>(vals, q0, cnt, s_raw);
      // 2. rank: warp w takes groups [w * gpw, (w + 1) * gpw) of 32 points
      const int gpw = ((cnt + 31) / 32 + SORT_WARPS - 1) / SORT_WARPS;
      const uint8_t* cf = codes + q0 * F + f;
      int code[SORT_PPL], rank[SORT_PPL];
#pragma unroll
      for (int g = 0; g < SORT_PPL; ++g) {
        const int j = (warp * gpw + g) * 32 + lane;
        code[g] = g < gpw && j < cnt ? cf[static_cast<long long>(j) * F] : -1;
      }
#pragma unroll
      for (int g = 0; g < SORT_PPL; ++g) {
        rank[g] = 0;
        if (g < gpw) {
          const unsigned peers = __match_any_sync(FULL, code[g]);
          const int before = code[g] >= 0 ? wc[code[g]] : 0;
          __syncwarp();
          if (code[g] >= 0 && (peers & below) == 0)
            wc[code[g]] = static_cast<uint16_t>(before + __popc(peers));
          __syncwarp();
          rank[g] = before + __popc(peers & below);
        }
      }
      __syncthreads();
      // 3. place: each bin's counts to exclusive offsets over the warps, its
      // total to start, then the scan of the totals
#pragma unroll
      for (int k = 0; k < SORT_SLOTS; ++k) {
        const int b = t + k * SORT_THREADS;
        if (b < n_bins) {
          int run = 0;
          for (int w = 0; w < SORT_WARPS; ++w) {
            const int x = wcnt[w * n_bins + b];
            wcnt[w * n_bins + b] = static_cast<uint16_t>(run);
            run += x;
          }
          start[b] = run;
        }
      }
      if (t == 0) start[n_bins] = cnt;
      cp_async_wait<0>();
      __syncthreads();
      scan_counts(start, n_bins, wsum);
#pragma unroll
      for (int g = 0; g < SORT_PPL; ++g)
        if (g < gpw && code[g] >= 0) {
          const int place = start[code[g]] + wc[code[g]] + rank[g];
          const float* v = sv + ((warp * gpw + g) * 32 + lane) * S;
#pragma unroll
          for (int s = 0; s < S; ++s) sorted[place * S + s] = v[s];
        }
      __syncthreads();
      // 4. sums: chain (b, s) over bin b's segment [start[b], start[b + 1])
      for (int b = t; b < n_bins; b += SORT_THREADS)
        for (int w = 0; w < SORT_WARPS; ++w) wcnt[w * n_bins + b] = 0;
      for (int q = t; q < n_bins * S; q += SORT_THREADS) {
        const int b = q / S, i0 = start[b];
        o[q] = chain<S>(sorted + i0 * S + q - b * S, start[b + 1] - i0,
                        q0 == p0 ? 0.f : o[q]);
      }
    }
  }
}

// The tile sum of fused and legacy: out[e] = partial[0][e] + partial[1][e]
// + ... in tile order, for 32 consecutive e a CTA.
// All 8 warps keep RING_STAGES - 1 stages of RING_ROWS tiles' 32 values
// (128 bytes a tile, by 4-byte cp.async) in flight while warp 0's lanes, one
// an element, add the stage that has landed: the chains are the same, the
// loads no longer wait one by one.
__global__ void __launch_bounds__(SORT_THREADS)
reduce_ring_kernel(const float* __restrict__ partial, float* __restrict__ out, int C,
                   long long n) {
  extern __shared__ __align__(16) float ring[];   // (RING_STAGES, RING_ROWS, 32)
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long e = static_cast<long long>(blockIdx.x) * 32 + lane;
  const int stages = (C + RING_ROWS - 1) / RING_ROWS;
  auto load = [&](int i) {
    if (i < stages && e < n) {
      float* r = ring + (i % RING_STAGES) * RING_ROWS * 32 + lane;
      const int c0 = i * RING_ROWS, m = min(RING_ROWS, C - c0);
      for (int k = warp; k < m; k += SORT_WARPS)
        cp_async4(r + k * 32, partial + static_cast<long long>(c0 + k) * n + e);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < RING_STAGES - 1; ++i) load(i);
  float acc = 0.f;
  for (int i = 0; i < stages; ++i) {
    load(i + RING_STAGES - 1);
    cp_async_wait<RING_STAGES - 1>();   // stage i has landed
    __syncthreads();
    if (warp == 0 && e < n) {
      const float* r = ring + (i % RING_STAGES) * RING_ROWS * 32 + lane;
      const int m = min(RING_ROWS, C - i * RING_ROWS);
      acc = i ? chain<32>(r, m, acc) : chain<32>(r + 32, m - 1, r[0]);
    }
    __syncthreads();   // stage i is read before it is loaded again
  }
  if (warp == 0 && e < n) out[e] = acc;
}

constexpr int RING_SMEM = RING_STAGES * RING_ROWS * 32 * 4;

int tiles(long long P, int tile_p) { return static_cast<int>((P + tile_p - 1) / tile_p); }

template <int S>
int launch_sort(const uint8_t* codes, const float* vals, float* partial, long long P, int F,
                int n_bins, int tile_p, bool one_feature, cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  static const cudaError_t attr =
      cudaFuncSetAttribute(hist_sort_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(sort_smem(S, MAX_BINS)));
  if (attr != cudaSuccess) return attr;
  const SortShape sh = sort_shape(P, F, tile_p, sms, one_feature);
  hist_sort_kernel<S><<<dim3(static_cast<unsigned>(sh.tiles), static_cast<unsigned>(sh.groups)),
                        SORT_THREADS, sort_smem(S, n_bins), s>>>(
      codes, vals, partial, P, F, n_bins, tile_p, static_cast<int>(sh.per_cta));
  return cudaGetLastError();
}

int launch_ring(const float* partial, float* out, int C, long long n, cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      reduce_ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, RING_SMEM);
  if (attr != cudaSuccess) return attr;
  reduce_ring_kernel<<<static_cast<unsigned>((n + 31) / 32), SORT_THREADS, RING_SMEM, s>>>(
      partial, out, C, n);
  return cudaGetLastError();
}

}  // namespace

// Common arguments: codes (P, F) uint8 row-major, every code < n_bins;
// P >= 1, 1 <= F <= 65535, 1 <= n_bins <= 1024, tile_p >= 1.

// hist_f64: vals (P, 3) float64; rows (n,) int32 ascending in [0, P), or
// null for all P rows (n = P); scratch of hist_f64_scratch_bytes(n, F,
// n_bins) bytes on the device; out (F, n_bins, 3) float64.  n < 2^31.
extern "C" long long hist_f64_scratch_bytes(long long n, int F, int n_bins) {
  return scratch_bytes(n, F, n_bins);
}

extern "C" int hist_f64(const uint8_t* codes, const double* vals, const int* rows, long long n,
                        void* scratch, double* out, int F, int n_bins, void* stream) {
  return launch_rows(codes, vals, rows, n, scratch, out, F, n_bins,
                     static_cast<cudaStream_t>(stream));
}

// One tree node on the stream: the n rows from rows_host (pinned) to
// rows_dev, hist_f64, out_dev to out_host (pinned), then wait for the
// stream.
extern "C" int hist_f64_node(const uint8_t* codes, const double* vals, const int* rows_host,
                             int* rows_dev, long long n, void* scratch, double* out_dev,
                             double* out_host, int F, int n_bins, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemcpyAsync(rows_dev, rows_host, static_cast<size_t>(n) * sizeof(int),
                                  cudaMemcpyHostToDevice, s);
  if (e != cudaSuccess) return e;
  const int rc = launch_rows(codes, vals, rows_dev, n, scratch, out_dev, F, n_bins, s);
  if (rc != cudaSuccess) return rc;
  e = cudaMemcpyAsync(out_host, out_dev, static_cast<size_t>(F) * n_bins * 3 * sizeof(double),
                      cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return e;
  e = cudaStreamSynchronize(s);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The launch of hist_<variant>_f32, variant "fused", "partials" or
// "legacy", on a card of sms SMs: shape = {P-tiles, feature groups (CTAs a
// tile), features a CTA, CTAs, threads a CTA, shared bytes a CTA, points a
// sub-chunk, sub-chunks of a full tile}.  P, F, tile_p, sms >= 1.  Returns
// 0, or 1 for another variant (shape untouched).
extern "C" int hist_f32_launch_shape(const char* variant, long long P, int F, int n_bins,
                                     int tile_p, int sms, long long* shape) {
  const bool partials = !std::strcmp(variant, "partials");
  const bool legacy = !std::strcmp(variant, "legacy");
  if (!partials && !legacy && std::strcmp(variant, "fused")) return 1;
  const SortShape sh = sort_shape(P, F, tile_p, sms, legacy);
  shape[0] = sh.tiles;
  shape[1] = sh.groups;
  shape[2] = sh.per_cta;
  shape[3] = sh.ctas;
  shape[4] = SORT_THREADS;
  shape[5] = sort_smem(partials ? 6 : 3, n_bins);
  shape[6] = SUB;
  shape[7] = (tile_p + SUB - 1LL) / SUB;
  return 0;
}

// vals (P, 3) float32; partial (ceil(P / tile_p), F, n_bins, 3) scratch;
// out (F, n_bins, 3) float32.
extern "C" int hist_fused_f32(const uint8_t* codes, const float* vals, float* partial, float* out,
                              long long P, int F, int n_bins, int tile_p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_sort<3>(codes, vals, partial, P, F, n_bins, tile_p, false, s);
  if (e != cudaSuccess) return e;
  return launch_ring(partial, out, tiles(P, tile_p), static_cast<long long>(F) * n_bins * 3, s);
}

// As hist_fused_f32, on the (tile, feature) grid: the same bits.
extern "C" int hist_legacy_f32(const uint8_t* codes, const float* vals, float* partial,
                               float* out, long long P, int F, int n_bins, int tile_p,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e = launch_sort<3>(codes, vals, partial, P, F, n_bins, tile_p, true, s);
  if (e != cudaSuccess) return e;
  return launch_ring(partial, out, tiles(P, tile_p), static_cast<long long>(F) * n_bins * 3, s);
}

// vals (P, 6) float32 (the hi and lo halves of the three channels);
// partial (ceil(P / tile_p), F, n_bins, 6) float32 is the output.
extern "C" int hist_partials_f32(const uint8_t* codes, const float* vals, float* partial,
                                 long long P, int F, int n_bins, int tile_p, void* stream) {
  return launch_sort<6>(codes, vals, partial, P, F, n_bins, tile_p, false,
                        static_cast<cudaStream_t>(stream));
}
