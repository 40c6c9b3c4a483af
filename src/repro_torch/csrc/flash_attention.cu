// flash_attention_bf16 / flash_attention_f32: causal (or full) GQA attention
// with an online softmax over key tiles.  q (B, Hq, Lq, D), k and v
// (B, Hkv, Lk, D), contiguous, in one dtype; o (B, Hq, Lq, D) in q's dtype.
// Query head h reads KV head h / (Hq / Hkv); no repeated K/V in memory.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_call
// (body _fa_kernel).  It computes what _fa_kernel computes:
//   s = (q . k) accumulated in float32, times scale; masked entries -1e30
//   (keys past Lk, and causal keys past i + Lk - Lq);
//   m_new = max(m, rowmax s); p = exp(s - m_new); corr = exp(m - m_new);
//   l = l * corr + rowsum p (float32 p);
//   acc = acc * corr + round_to_v_dtype(p) . v (float32 accumulate);
//   out = acc / max(l, 1e-30), cast to q's dtype.
// The Pallas grid walks key tiles in order per query tile and carries
// (m, l, acc) in VMEM scratch from one grid step to the next.  CUDA blocks
// run in no order, so here one CTA owns (batch x head, query tile) and keeps
// (m, l, acc) in registers and shared memory for its whole key loop; nothing
// passes between CTAs.  Ragged Lq and Lk are masked here, not padded on the
// host: rows past Lq load zeros and are not stored, keys past Lk are staged
// as zeros and masked.
//
// Skipped tiles.  With causal and Lq <= Lk every row sees key 0, so a key
// tile wholly above the CTA's last row adds exactly 0 (p underflows to 0,
// corr is 1) and is skipped.  With Lq > Lk some rows see no key; they keep
// m = -1e30, so every key slot gives p = 1 and acc becomes the sum of V.
// The Pallas kernel divides that sum by its padded key count (whole tiles
// of min(256, Lk) keys); the launcher passes that count as empty_den and
// such rows divide by it.  No tile is skipped then.
//
// bfloat16: mma.sync.m16n8k16 bf16 -> f32 on the tensor cores (the
// reference's preferred_element_type=f32).  A CTA is 4 warps x 16 query
// rows; Q stays in registers as A fragments, K and V tiles of 64 keys are
// staged in shared memory (rows padded by 8 elements, so the fragment loads
// of a warp hit 32 banks), S = Q K^T and O += P V are register-fragment
// products, and P goes from the S accumulators to bf16 A fragments without
// a trip through memory.  l is summed per thread and over the 4 threads of
// a row at the end.
//
// float32: scalar fused multiply-adds (no TF32, which would keep only ten
// mantissa bits of q and k).  256 threads over a 64 x 64 tile, each owning
// a 4 x 4 block of S and a 4 x D/16 block of acc; Q, K, V, S in shared
// memory.
//
// Bound.  Work: 4 x B x Hq x D flops per visible (query, key) pair, about
// half of Lq x Lk with causal; bytes: q, k, v read and o written once.
// At the model's prefill (B 4, Hq 14, L 2048, D 64) that is 30 GFLOP against
// 59 MB, so the bf16 tensor-core peak, not memory, bounds it.  This design
// stages tiles with plain loads (no TMA or cp.async pipeline, no wgmma, no
// warp specialisation) and so stays well under that peak; those are later
// work.
#include "common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// key tiles the CTA of query rows [q0, q0 + bq) visits
__device__ __forceinline__ int key_tiles(int q0, int bq, int bk, int Lq, int Lk, int causal) {
  const int nk = (Lk + bk - 1) / bk;
  const int off = Lk - Lq;
  if (!causal || off < 0) return nk;
  const int last_key = min(q0 + bq, Lq) - 1 + off;
  return min(nk, last_key / bk + 1);
}

__device__ __forceinline__ bool visible(int key, int row, int Lk, int off, int causal) {
  return key < Lk && (!causal || key <= row + off);
}

// ------------------------------------------------------------------ bf16
constexpr int TC_BQ = 64;       // query rows per CTA: 4 warps x 16
constexpr int TC_BK = 64;       // keys per staged tile
constexpr int TC_THREADS = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS)
fa_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
        int Lq, int Lk, int causal, float scale, float empty_den) {
  constexpr int LD = D + 8;     // padded shared row, a multiple of 16 bytes
  __shared__ __align__(16) __nv_bfloat16 ks[TC_BK * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[TC_BK * LD];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;   // the longest key loops first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;                  // fragment row group, column pair
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;          // this thread's two query rows
  const long long qbase = static_cast<long long>(bh) * Lq * D;
  const long long kvbase = (static_cast<long long>(b) * Hkv + kvh) * Lk * D;
  const int off = Lk - Lq;

  // Q as A fragments of the D/16 column slices, for the whole key loop
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int col = c * 16 + 2 * t;
    const __nv_bfloat16* p0 = q + qbase + static_cast<long long>(r0) * D + col;
    const __nv_bfloat16* p1 = q + qbase + static_cast<long long>(r1) * D + col;
    qa[c][0] = r0 < Lq ? ld_pair(p0) : 0u;
    qa[c][1] = r1 < Lq ? ld_pair(p1) : 0u;
    qa[c][2] = r0 < Lq ? ld_pair(p0 + 8) : 0u;
    qa[c][3] = r1 < Lq ? ld_pair(p1 + 8) : 0u;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int d = 0; d < D / 8; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

  const int ntiles = key_tiles(q0, TC_BQ, TC_BK, Lq, Lk, causal);
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * TC_BK;
    __syncthreads();   // every warp is done with the previous tile
    constexpr int CHUNKS = TC_BK * D / 8;   // 16-byte pieces of one tile
    for (int c = threadIdx.x; c < CHUNKS; c += TC_THREADS) {
      const int row = c / (D / 8), col = (c % (D / 8)) * 8;
      uint4 kc = make_uint4(0u, 0u, 0u, 0u), vc = kc;
      if (k0 + row < Lk) {
        const long long at = kvbase + static_cast<long long>(k0 + row) * D + col;
        kc = *reinterpret_cast<const uint4*>(k + at);
        vc = *reinterpret_cast<const uint4*>(v + at);
      }
      *reinterpret_cast<uint4*>(ks + row * LD + col) = kc;
      *reinterpret_cast<uint4*>(vs + row * LD + col) = vc;
    }
    __syncthreads();

    // S = Q K^T over TC_BK / 8 tiles of 8 keys; K^T's column n is K's row
    float s[TC_BK / 8][4];
#pragma unroll
    for (int n = 0; n < TC_BK / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = ks + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint32_t bf[2] = {ld_pair(kr + c * 16), ld_pair(kr + c * 16 + 8)};
        mma_bf16(s[n], qa[c], bf);
      }
    }

    // scale, mask, the rows' maxima over the 4 threads of each row
    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < TC_BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int row = e < 2 ? r0 : r1;
        const float x = visible(key, row, Lk, off, causal) ? s[n][e] * scale : NEG;
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < TC_BK / 8; ++n) {
      s[n][0] = __expf(s[n][0] - mn0);
      s[n][1] = __expf(s[n][1] - mn0);
      s[n][2] = __expf(s[n][2] - mn1);
      s[n][3] = __expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= c0;
      acc[d][1] *= c0;
      acc[d][2] *= c1;
      acc[d][3] *= c1;
    }

    // O += P V: P (rounded to bf16) from the S accumulators as A fragments of
    // 16 keys; V's B fragment pairs two rows of one column
    const uint16_t* vbits = reinterpret_cast<const uint16_t*>(vs);
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const uint16_t* vr = vbits + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        const uint16_t* vc = vr + d * 8;
        const uint32_t bf[2] = {
            static_cast<uint32_t>(vc[0]) | (static_cast<uint32_t>(vc[LD]) << 16),
            static_cast<uint32_t>(vc[8 * LD]) | (static_cast<uint32_t>(vc[9 * LD]) << 16)};
        mma_bf16(acc[d], pa, bf);
      }
    }
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const float den0 = fmaxf(m0 == NEG ? empty_den : l0, 1e-30f);
  const float den1 = fmaxf(m1 == NEG ? empty_den : l1, 1e-30f);
#pragma unroll
  for (int d = 0; d < D / 8; ++d) {
    const int col = d * 8 + 2 * t;
    if (r0 < Lq)
      *reinterpret_cast<uint32_t*>(o + qbase + static_cast<long long>(r0) * D + col) =
          pack_bf16(acc[d][0] / den0, acc[d][1] / den0);
    if (r1 < Lq)
      *reinterpret_cast<uint32_t*>(o + qbase + static_cast<long long>(r1) * D + col) =
          pack_bf16(acc[d][2] / den1, acc[d][3] / den1);
  }
}

// --------------------------------------------------------------- float32
constexpr int S_BQ = 64;        // query rows per CTA
constexpr int S_BK = 64;        // keys per staged tile
constexpr int S_THREADS = 256;  // 16 x 16: thread (ty, tx) owns rows ty + 16 i

template <int D>
constexpr int f32_smem_floats() {
  return 2 * S_BQ * (D + 1) + S_BK * D + S_BQ * (S_BK + 1) + 3 * S_BQ;
}

template <int D>
__global__ void __launch_bounds__(S_THREADS)
fa_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ o, int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
       float empty_den) {
  constexpr int LQ = D + 1;          // padded rows: a walk along d hits 32 banks
  constexpr int LS = S_BK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                  // [S_BQ][LQ]
  float* ks = qs + S_BQ * LQ;        // [S_BK][LQ]
  float* vs = ks + S_BK * LQ;        // [S_BK][D]
  float* ss = vs + S_BK * D;         // [S_BQ][LS]: scores, then P
  float* row_m = ss + S_BQ * LS;
  float* row_l = row_m + S_BQ;
  float* row_c = row_l + S_BQ;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * S_BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long qbase = static_cast<long long>(bh) * Lq * D;
  const long long kvbase = (static_cast<long long>(b) * Hkv + kvh) * Lk * D;
  const int off = Lk - Lq;

  for (int e = threadIdx.x; e < S_BQ * D; e += S_THREADS) {
    const int r = e / D, c = e % D;
    qs[r * LQ + c] = q0 + r < Lq ? q[qbase + static_cast<long long>(q0 + r) * D + c] : 0.f;
  }
  if (threadIdx.x < S_BQ) {
    row_m[threadIdx.x] = NEG;
    row_l[threadIdx.x] = 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) acc[i][jj] = 0.f;

  const int ntiles = key_tiles(q0, S_BQ, S_BK, Lq, Lk, causal);
  for (int j = 0; j < ntiles; ++j) {
    const int k0 = j * S_BK;
    __syncthreads();
    for (int e = threadIdx.x; e < S_BK * D; e += S_THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Lk;
      const long long at = kvbase + static_cast<long long>(k0 + r) * D + c;
      ks[r * LQ + c] = in ? k[at] : 0.f;
      vs[r * D + c] = in ? v[at] : 0.f;
    }
    __syncthreads();

    // S block: rows ty + 16 i, keys tx + 16 jj
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[i][jj] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LQ + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb[jj] = ks[(tx + 16 * jj) * LQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sc[i][jj] = __fmaf_rn(a[i], kb[jj], sc[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) ss[(ty + 16 * i) * LS + tx + 16 * jj] = sc[i][jj];
    __syncthreads();

    // online softmax: 4 neighbouring lanes per row, 16 keys each
    {
      const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
      float* sr = ss + r * LS + part * 16;
      float x[16];
      float mx = NEG;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int key = k0 + part * 16 + e;
        x[e] = visible(key, q0 + r, Lk, off, causal) ? sr[e] * scale : NEG;
        mx = fmaxf(mx, x[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float p = expf(x[e] - m_new);
        sr[e] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(FULL, sum, 1);
      sum += __shfl_xor_sync(FULL, sum, 2);
      if (part == 0) {
        const float c = expf(m_old - m_new);
        row_c[r] = c;
        row_l[r] = row_l[r] * c + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc rows ty + 16 i, columns tx + 16 jj
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = row_c[ty + 16 * i];
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) acc[i][jj] *= c;
    }
    for (int kk = 0; kk < S_BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * LS + kk];
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        const float vv = vs[kk * D + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = __fmaf_rn(p[i], vv, acc[i][jj]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Lq) continue;
    const float den = fmaxf(row_m[r] == NEG ? empty_den : row_l[r], 1e-30f);
    float* out = o + qbase + static_cast<long long>(q0 + r) * D;
#pragma unroll
    for (int jj = 0; jj < D / 16; ++jj) out[tx + 16 * jj] = acc[i][jj] / den;
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                int Lq, int Lk, int causal, float scale, float empty_den, cudaStream_t s) {
  const dim3 grid((Lq + TC_BQ - 1) / TC_BQ, B * Hq);
  fa_bf16<D><<<grid, TC_THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, Lq, Lk,
      causal, scale, empty_den);
  return cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
               int Lq, int Lk, int causal, float scale, float empty_den, cudaStream_t s) {
  constexpr int bytes = f32_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(fa_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Lq + S_BQ - 1) / S_BQ, B * Hq);
  fa_f32<D><<<grid, S_THREADS, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, Lq, Lk, causal, scale, empty_den);
  return cudaGetLastError();
}

}  // namespace

// q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D), o (B, Hq, Lq, D), contiguous and
// 16-byte aligned; D in {32, 64, 128}; Hq a multiple of Hkv; B * Hq <= 65535;
// Lq, Lk >= 1.  empty_den: the divisor of a row that sees no key.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                    int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                                    float scale, float empty_den, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_bf16<32>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, scale, empty_den, s);
    case 64: return launch_bf16<64>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, scale, empty_den, s);
    case 128: return launch_bf16<128>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, scale, empty_den, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* o, int B,
                                   int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                                   float scale, float empty_den, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_f32<32>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, scale, empty_den, s);
    case 64: return launch_f32<64>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, scale, empty_den, s);
    case 128: return launch_f32<128>(q, k, v, o, B, Hq, Hkv, Lq, Lk, causal, scale, empty_den, s);
    default: return cudaErrorInvalidValue;
  }
}
