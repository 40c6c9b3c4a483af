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
// The float32 variants share one histogram body.  A CTA has one thread per
// bin; it stages STAGE points of codes and values in shared memory at a
// time (every thread reads each staged code: a broadcast), and the thread
// whose bin a point's code names adds that point's channels into registers.
// So each (feature, bin, channel) sum of a CTA is one chain of adds in
// ascending point order, each add rounded on its own, with no atomics.
// Launch shapes:
//   fused, partials: one CTA per P-tile of tile_p points, looping over the
//                  features inside the CTA as the Pallas kernel's body does;
//                  each CTA writes its tile's histogram as a partial.
//   legacy:        one CTA per (P-tile, feature), the Pallas kernel's
//                  (F, P/TP) grid.
// The Pallas fused and legacy kernels accumulate in place over the P tiles,
// which is sound only on the TPU's sequential grid.  Here fused and legacy
// end with a second kernel that sums each output element's tile partials in
// tile order, so their result does not change from run to run; partials
// returns the per-tile partials and the host sums them in float64.  They
// compare every point with every bin, P x F x n_bins compares, far above
// their bytes bound; they are off the trees' path.
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

#include "common.cuh"

namespace {

constexpr int STAGE = 512;       // points staged in shared memory at a time
constexpr int MAX_THREADS = 1024;  // one thread per bin; MAX_BINS in kernel.py

// Channel sums of the points [p0, p1) whose feature-f code is `bin`.  Every
// thread of the CTA must call it (it synchronises); threads with a bin past
// the last one help stage and find no points.
template <typename T, int S>
__device__ void bin_sums(const uint8_t* __restrict__ codes, const T* __restrict__ vals, int F,
                         int f, long long p0, long long p1, int bin, uint8_t* s_codes, T* s_vals,
                         T (&acc)[S]) {
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = T(0);
  for (long long q0 = p0; q0 < p1; q0 += STAGE) {
    const int cnt = static_cast<int>(min(static_cast<long long>(STAGE), p1 - q0));
    __syncthreads();  // the previous stage has been read
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) s_codes[j] = codes[(q0 + j) * F + f];
    for (int e = threadIdx.x; e < cnt * S; e += blockDim.x) s_vals[e] = vals[q0 * S + e];
    __syncthreads();
    for (int j = 0; j < cnt; ++j) {
      if (s_codes[j] == bin) {
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = add_rn(acc[s], s_vals[j * S + s]);
      }
    }
  }
}

// partial (C, F, n_bins, S): CTA x = P-tile c; with per_feature, CTA y is the
// one feature it bins, else it loops over all F.
template <int S>
__global__ void __launch_bounds__(MAX_THREADS)
hist_tiles_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ vals,
                  float* __restrict__ partial, long long P, int F, int n_bins, int tile_p,
                  int per_feature) {
  __shared__ uint8_t s_codes[STAGE];
  __shared__ float s_vals[STAGE * S];
  const long long c = blockIdx.x;
  const long long p0 = c * tile_p, p1 = min(P, p0 + tile_p);
  const int f0 = per_feature ? static_cast<int>(blockIdx.y) : 0;
  const int f1 = per_feature ? f0 + 1 : F;
  const int bin = threadIdx.x;
  for (int f = f0; f < f1; ++f) {
    float acc[S];
    bin_sums<float, S>(codes, vals, F, f, p0, p1, bin, s_codes, s_vals, acc);
    if (bin < n_bins) {
      float* o = partial + ((c * F + f) * n_bins + bin) * S;
      for (int s = 0; s < S; ++s) o[s] = acc[s];
    }
  }
}

constexpr int REDUCE_THREADS = 128;
constexpr int REDUCE_UNROLL = 16;

// out[i] = partial[0][i] + partial[1][i] + ... in tile order, i < n.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_tiles_kernel(const float* __restrict__ partial, float* __restrict__ out, int C,
                    long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * REDUCE_THREADS + threadIdx.x;
  if (i >= n) return;
  const float* p = partial + i;
  float acc = p[0];
  int c = 1;
  for (; c + REDUCE_UNROLL <= C; c += REDUCE_UNROLL) {
    float v[REDUCE_UNROLL];
#pragma unroll
    for (int u = 0; u < REDUCE_UNROLL; ++u) v[u] = p[(c + u) * n];
#pragma unroll
    for (int u = 0; u < REDUCE_UNROLL; ++u) acc = add_rn(acc, v[u]);
  }
  for (; c < C; ++c) acc = add_rn(acc, p[c * n]);
  out[i] = acc;
}

int threads_for(int n_bins) { return (n_bins + 31) / 32 * 32; }

int tiles(long long P, int tile_p) { return static_cast<int>((P + tile_p - 1) / tile_p); }

template <int S>
int launch_tiles(const uint8_t* codes, const float* vals, float* partial, long long P, int F,
                 int n_bins, int tile_p, bool per_feature, cudaStream_t s) {
  const dim3 grid(tiles(P, tile_p), per_feature ? F : 1);
  hist_tiles_kernel<S><<<grid, threads_for(n_bins), 0, s>>>(codes, vals, partial, P, F, n_bins,
                                                            tile_p, per_feature ? 1 : 0);
  return cudaGetLastError();
}

int launch_reduce(const float* partial, float* out, int C, long long n, cudaStream_t s) {
  reduce_tiles_kernel<<<static_cast<unsigned>((n + REDUCE_THREADS - 1) / REDUCE_THREADS),
                        REDUCE_THREADS, 0, s>>>(partial, out, C, n);
  return cudaGetLastError();
}

int fused_or_legacy(const uint8_t* codes, const float* vals, float* partial, float* out,
                    long long P, int F, int n_bins, int tile_p, bool per_feature, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = launch_tiles<3>(codes, vals, partial, P, F, n_bins, tile_p, per_feature, s);
  if (e != cudaSuccess) return e;
  return launch_reduce(partial, out, tiles(P, tile_p), static_cast<long long>(F) * n_bins * 3, s);
}

// ------------------------------------------------------------------ hist_f64
constexpr int ROWS_THREADS = 256;                    // 8 warps a CTA
constexpr int ROWS_WARPS = ROWS_THREADS / 32;
constexpr int BIN_SLOTS = MAX_THREADS / ROWS_THREADS;  // bins a thread owns
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

// In-place exclusive scan of v[0, n) in shared memory, n <= MAX_THREADS;
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
  __shared__ int cnt[MAX_THREADS];
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
  __shared__ int run[MAX_THREADS];
  __shared__ int wcount[ROWS_WARPS * MAX_THREADS];
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
        static_cast<int>(small_smem(SMALL_ROWS, MAX_THREADS)));
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

// vals (P, 3) float32; partial (ceil(P / tile_p), F, n_bins, 3) scratch;
// out (F, n_bins, 3) float32.
extern "C" int hist_fused_f32(const uint8_t* codes, const float* vals, float* partial, float* out,
                              long long P, int F, int n_bins, int tile_p, void* stream) {
  return fused_or_legacy(codes, vals, partial, out, P, F, n_bins, tile_p, false, stream);
}

extern "C" int hist_legacy_f32(const uint8_t* codes, const float* vals, float* partial,
                               float* out, long long P, int F, int n_bins, int tile_p,
                               void* stream) {
  return fused_or_legacy(codes, vals, partial, out, P, F, n_bins, tile_p, true, stream);
}

// vals (P, 6) float32 (the hi and lo halves of the three channels);
// partial (ceil(P / tile_p), F, n_bins, 6) float32 is the output.
extern "C" int hist_partials_f32(const uint8_t* codes, const float* vals, float* partial,
                                 long long P, int F, int n_bins, int tile_p, void* stream) {
  return launch_tiles<6>(codes, vals, partial, P, F, n_bins, tile_p, false,
                         static_cast<cudaStream_t>(stream));
}
