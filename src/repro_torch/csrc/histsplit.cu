// histsplit: the CART split histograms, per-(feature, bin) sums of the value
// channels (w, w*y, w*y^2) of P points with uint8 bin codes.
//
// Replaces src/repro/kernels/histsplit/kernel.py::histograms_kernel_call in
// all three of its variants:
//   variant="fused"    (body _hist_kernel)          -> hist_fused_f32
//   variant="partials" (body _hist_kernel_partials) -> hist_partials_f32
//   variant="legacy"   (body _hist_kernel_legacy)   -> hist_legacy_f32
// and adds hist_f64, the float64 variant the trees use, which equals numpy's
// np.bincount(codes[:, f], weights=..., minlength=n_bins) bitwise.
//
// One histogram body serves all four.  A CTA has one thread per bin; it
// stages STAGE points of codes and values in shared memory at a time (every
// thread reads each staged code: a broadcast), and the thread whose bin a
// point's code names adds that point's channels into registers.  So each
// (feature, bin, channel) sum of a CTA is one chain of adds in ascending
// point order, starting from +0.0, each add rounded on its own: exactly the
// loop numpy's bincount runs.  There are no atomics, so nothing depends on
// the order in which threads or CTAs run.
//
// Launch shapes.
//   hist_f64:      one CTA per feature over all P points; the sums are the
//                  output.  This is the variant that must equal numpy, so
//                  its chains cannot be split across CTAs.
//   fused, partials: one CTA per P-tile of tile_p points, looping over the
//                  features inside the CTA as the Pallas kernel's body does;
//                  each CTA writes its tile's histogram as a partial.
//   legacy:        one CTA per (P-tile, feature), the Pallas kernel's
//                  (F, P/TP) grid.
// The Pallas fused and legacy kernels accumulate in place over the P tiles,
// which is sound only on the TPU's sequential grid.  Here fused and legacy
// end with a second kernel that sums each output element's tile partials in
// tile order, so their result does not change from run to run; partials
// returns the per-tile partials and the host sums them in float64.
//
// Bound.  The bytes are the codes and values read once and the output
// written once, 26 bytes a point in float64 with two features; the adds are
// 3 per (point, feature).  Both are far below what this design spends: it
// compares every point with every bin, P x F x n_bins compares, and a
// float64 CTA's chain runs through all P points on one SM.  A stable
// counting sort by code followed by per-bin segment sums in point order is
// the redesign that keeps numpy's order at the bytes bound.
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

__global__ void __launch_bounds__(MAX_THREADS)
hist_f64_kernel(const uint8_t* __restrict__ codes, const double* __restrict__ vals,
                double* __restrict__ out, long long P, int F, int n_bins) {
  __shared__ uint8_t s_codes[STAGE];
  __shared__ double s_vals[STAGE * 3];
  const int f = blockIdx.x, bin = threadIdx.x;
  double acc[3];
  bin_sums<double, 3>(codes, vals, F, f, 0, P, bin, s_codes, s_vals, acc);
  if (bin < n_bins) {
    double* o = out + (static_cast<long long>(f) * n_bins + bin) * 3;
    for (int s = 0; s < 3; ++s) o[s] = acc[s];
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

}  // namespace

// Common arguments: codes (P, F) uint8 row-major, every code < n_bins;
// P >= 1, 1 <= F <= 65535, 1 <= n_bins <= 1024, tile_p >= 1.

// vals (P, 3) float64; out (F, n_bins, 3) float64.
extern "C" int hist_f64(const uint8_t* codes, const double* vals, double* out, long long P, int F,
                        int n_bins, void* stream) {
  hist_f64_kernel<<<F, threads_for(n_bins), 0, static_cast<cudaStream_t>(stream)>>>(
      codes, vals, out, P, F, n_bins);
  return cudaGetLastError();
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
