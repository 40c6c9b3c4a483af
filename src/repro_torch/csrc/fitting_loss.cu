// fitting_loss_batched: the Algorithm-5 smoothed loss of T K-leaf trees
// against B coreset blocks, (T,) float32.  fitting_loss is the same launch
// with T = 1.
//
// Replaces src/repro/kernels/fitting_loss/kernel.py::fitting_loss_batched_call
// (body _fl_batched_kernel) and ::fitting_loss_call (body _fl_kernel).
//
// Per (block, leaf): the rectangle overlap z, Z the running sum of z over the
// leaves in leaf order, and for each of the block's 4 points the overlap of
// [Z - z, Z) with [U - w, U) (U the running sum of the point weights), times
// (leaf label - point label)^2.  The arithmetic follows
// fitting_loss/kernel.py::_smoothed_loss_terms term by term.
//
// Reduction.  The Pallas kernel sums over B tiles in place, relying on the
// TPU's sequential grid; CUDA blocks run in parallel and atomics would make
// the sum vary from run to run.  Here one CTA owns (tree, chunk of THREADS
// blocks), each thread scores one coreset block against the tree's leaves
// (staged in shared memory, KTILE at a time) in leaf order, the CTA reduces
// its threads in a fixed tree order into partial[t, chunk], and a second
// kernel sums each tree's chunks in order.  A tree's loss therefore depends
// only on the coreset and that tree: not on T, not on its batch-mates, and
// zero-area padding leaves add exact zeros.
//
// Bound.  Operations: about 40 float32 operations per (tree, block, leaf)
// against 67 TFLOP/s; the inputs are a few hundred kilobytes, so at the
// serving shapes (T = 256, K = 64, B ~ 2000) the bound is ~20 us and launch
// latency is of the same order.  The design keeps every operand in
// registers or shared memory; it does not yet tile several trees per CTA.
#include "common.cuh"

namespace {

// coreset blocks per CTA, one per thread; CHUNK in kernels/fitting_loss/kernel.py
constexpr int THREADS = 256;
constexpr int KTILE = 256;    // leaves staged in shared memory at a time

__global__ void __launch_bounds__(THREADS)
fl_partials(const float* __restrict__ blk, const float* __restrict__ seg,
            float* __restrict__ partial, int B, int K, int nchunks) {
  __shared__ float sseg[KTILE][5];
  __shared__ float red[THREADS];
  const int t = blockIdx.x;
  const int chunk = blockIdx.y;
  const int b = chunk * THREADS + threadIdx.x;
  const bool live = b < B;

  float r0 = 0.f, r1 = 0.f, c0 = 0.f, c1 = 0.f;
  float lab[4] = {0.f, 0.f, 0.f, 0.f}, U[4] = {0.f, 0.f, 0.f, 0.f}, Up[4];
  if (live) {
    const float* p = blk + static_cast<long long>(b) * 16;
    r0 = p[0]; r1 = p[1]; c0 = p[2]; c1 = p[3];
    float run = 0.f;
    for (int i = 0; i < 4; ++i) {
      lab[i] = p[4 + i];
      const float w = p[8 + i];
      run = i == 0 ? w : add_rn(run, w);
      U[i] = run;
      Up[i] = U[i] - w;
    }
  } else {
    for (int i = 0; i < 4; ++i) Up[i] = 0.f;
  }

  float Z = 0.f, acc = 0.f;
  const float* tree = seg + static_cast<long long>(t) * K * 8;
  for (int k0 = 0; k0 < K; k0 += KTILE) {
    const int kn = min(KTILE, K - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kn * 5; e += THREADS) {
      const int kk = e / 5, f = e % 5;
      sseg[kk][f] = tree[static_cast<long long>(k0 + kk) * 8 + f];
    }
    __syncthreads();
    if (live) {
      for (int kk = 0; kk < kn; ++kk) {
        const float zr = fmaxf(fminf(r1, sseg[kk][1]) - fmaxf(r0, sseg[kk][0]), 0.f);
        const float zc = fmaxf(fminf(c1, sseg[kk][3]) - fmaxf(c0, sseg[kk][2]), 0.f);
        const float z = mul_rn(zr, zc);
        Z = add_rn(Z, z);
        const float Zp = Z - z;
        const float label = sseg[kk][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float consumed = fmaxf(fminf(Z, U[i]) - fmaxf(Zp, Up[i]), 0.f);
          const float d = label - lab[i];
          acc = add_rn(acc, mul_rn(mul_rn(consumed, d), d));
        }
      }
    }
  }

  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = add_rn(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  if (threadIdx.x == 0) partial[static_cast<long long>(t) * nchunks + chunk] = red[0];
}

__global__ void fl_reduce(const float* __restrict__ partial, float* __restrict__ out, int T,
                          int nchunks) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const float* p = partial + static_cast<long long>(t) * nchunks;
  float s = p[0];
  for (int c = 1; c < nchunks; ++c) s = add_rn(s, p[c]);
  out[t] = s;
}

}  // namespace

// blk (B, 16): rects | labels | weights | unused; seg (T, K, 8): rect | label
// | unused; partial (T, ceil(B / THREADS)) scratch; out (T,).  B, T, K >= 1,
// T <= 2^31 - 1, ceil(B / THREADS) <= 65535.
extern "C" int fitting_loss_batched(const float* blk, const float* seg, float* partial, float* out,
                                    int B, int T, int K, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (B + THREADS - 1) / THREADS;
  fl_partials<<<dim3(T, nchunks), THREADS, 0, s>>>(blk, seg, partial, B, K, nchunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fl_reduce<<<(T + 127) / 128, 128, 0, s>>>(partial, out, T, nchunks);
  return cudaGetLastError();
}
