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
// (m, l, acc) on chip for its whole key loop; nothing passes between CTAs,
// so the output is the same from run to run.  Ragged Lq and Lk are masked
// here, not padded on the host: rows past Lq are not stored, keys past Lk
// arrive as zeros and are masked.
//
// Skipped tiles.  With causal and Lq <= Lk every row sees key 0, so a key
// tile wholly above the CTA's last row adds exactly 0 (p underflows to 0,
// corr is 1) and is skipped.  With Lq > Lk some rows see no key; they keep
// m = -1e30, so every key slot gives p = 1 and acc becomes the sum of V.
// The Pallas kernel divides that sum by its padded key count (whole tiles
// of min(256, Lk) keys); the launcher passes that count as empty_den and
// such rows divide by it.  No tile is skipped then.
//
// bfloat16, for Hopper (sm_90a).  A CTA of three warpgroups owns 128 query
// rows: two consumer warpgroups of 64 rows each and one producer warp.
//   - Loads: the producer's one elected thread issues TMA copies through
//     3-D tensor maps (D, L, B x H), built by the launcher on each call:
//     Q once, then K and V tiles of 128 keys into a ring of 3 stages in
//     shared memory (225 KB at D = 128).  Each stage has a "full" mbarrier
//     (the copies' bytes) and an "empty" one that every consumer thread
//     arrives on once its products have read the stage.  A tile past Lk or
//     Lq is zero-filled per head, never the next head's rows.  Rows are
//     stored as the tensor cores read them: 64-column chunks in TMA's
//     128-byte swizzle (two chunks at D = 128), 32 columns in the 64-byte
//     swizzle at D = 32.
//   - S = Q K^T: one chain of D/16 wgmma.m64n128k16 per consumer, both
//     operands from shared memory (K's [key][d] tile is the K-major B).
//   - The online softmax runs on the accumulators in registers, in the
//     log2 domain (exp2 of s * scale * log2(e) - m, one explicit fused
//     multiply-add, since the library is built with -fmad=false); row
//     maxima over the 4 threads of a row; l sums the float32 P.  Only the
//     tiles that cross the causal diagonal or the Lk edge are masked.
//   - O += P V: BK/16 wgmma.m64n{D}k16 with P as the A operand from
//     registers (the S accumulators rounded to bf16 in place: their layout
//     is the A fragment's) and V's [key][d] tile as the B operand with the
//     transpose bit.
//   - Overlap: a consumer issues S_j = Q K_j^T and then P_{j-1} V_{j-1},
//     runs the softmax of S_j while the second product is in flight, and
//     releases stage j - 1 once it has retired.  The two consumers take
//     turns to issue (two named barriers), so one's softmax runs while the
//     other's products hold the tensor cores.
//   - Registers: setmaxnreg gives the producer 40 and each consumer 232.
//   - Epilogue: l summed over the row's 4 threads, acc divided, bf16 rows
//     below Lq stored with plain stores.
// Query tiles are launched longest key loop first.
//
// float32: scalar fused multiply-adds (no TF32, which would keep only ten
// mantissa bits of q and k).  256 threads over a 64 x 64 tile, each owning
// a 4 x 4 block of S and a 4 x D/16 block of acc; Q, K, V, S in shared
// memory.
//
// Bound.  Work: 4 x B x Hq x D flops per visible (query, key) pair, about
// half of Lq x Lk with causal; bytes: q, k, v read and o written once.
// At the model's prefill (B 4, Hq 14, L 2048, D 64) that is 30 GFLOP against
// 59 MB, so the bf16 tensor-core peak, not memory, bounds it: the design
// keeps the tensor cores fed by wgmma from shared memory with the loads
// off the consumers' path (TMA, a producer warp, a stage ring), and leaves
// them the softmax, which it overlaps with the products.  At D = 64 the
// exp2 units take about as long as the products.  What it does not do yet:
// a persistent grid, so each CTA's prologue (barriers, the first Q and K/V
// loads) and epilogue are exposed once per 128 query rows.
#include "common.cuh"

#include <cuda.h>
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
constexpr int BQ = 128;                 // query rows per CTA
constexpr int BK = 128;                 // keys per K/V tile
constexpr int WG = 128;                 // threads of a warpgroup
constexpr int CONSUMERS = 2;            // warpgroups of 64 query rows
constexpr int TC_THREADS = (CONSUMERS + 1) * WG;   // and the producer's
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;      // 128 x 40 + 256 x 232 <= 65,536
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tiles {
  static constexpr int CW = D < 64 ? D : 64;          // columns of one swizzled chunk
  static constexpr int ROW = CW * 2;                  // its row's bytes: the swizzle span
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;         // one K or V tile
  static constexpr int BARS = Q_BYTES + STAGES * 2 * KV_BYTES;
  // tiles, 2 x STAGES + 1 mbarriers, and room to align the base to 1024
  static constexpr int SMEM = BARS + 8 * (2 * STAGES + 1) + 1024;
  static constexpr uint64_t LAYOUT = CW == 64 ? 1 : 2;   // descriptor: 128B or 64B swizzle
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one TMA box of a 3-D tensor map, {column, row, plane}, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barriers 1 and 2 of the two consumer warpgroups (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(2 * 128) : "memory");
}
// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S += Q K^T over one k16 step: A and B from shared memory, both K-major;
// scale_d = 0 overwrites the accumulators
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// The online softmax over one S tile held as wgmma accumulators: this
// thread's rows r0 and r0 + 8, keys k0 + 8n + 2t (+1) in s[4n..4n+3].  On
// return s holds P (float32), (m, l) are updated and c0, c1 are the rows'
// corrections.  MASK: the tile crosses the causal diagonal or the Lk edge.
// Each row's maximum and sum run as CH independent chains, so that their
// latencies overlap.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], float& m0, float& m1,
                                               float& l0, float& l1, float& c0, float& c1,
                                               float scale_log2, int k0, int r0, int t, int Lk,
                                               int off, int causal) {
  constexpr int CH = 4;
  float mx0[CH], mx1[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) mx0[i] = mx1[i] = NEG;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e];
      if (MASK) {
        const int key = k0 + 8 * n + 2 * t + (e & 1);
        x = visible(key, e < 2 ? r0 : r0 + 8, Lk, off, causal) ? x * scale_log2 : NEG;
        s[4 * n + e] = x;
      }
      if (e < 2) mx0[n % CH] = fmaxf(mx0[n % CH], x); else mx1[n % CH] = fmaxf(mx1[n % CH], x);
    }
  }
#pragma unroll
  for (int i = 1; i < CH; ++i) {
    mx0[0] = fmaxf(mx0[0], mx0[i]);
    mx1[0] = fmaxf(mx1[0], mx1[i]);
  }
  if (!MASK) {            // a positive scale keeps the maximum's place
    mx0[0] *= scale_log2;
    mx1[0] *= scale_log2;
  }
  mx0[0] = fmaxf(mx0[0], __shfl_xor_sync(FULL, mx0[0], 1));
  mx0[0] = fmaxf(mx0[0], __shfl_xor_sync(FULL, mx0[0], 2));
  mx1[0] = fmaxf(mx1[0], __shfl_xor_sync(FULL, mx1[0], 1));
  mx1[0] = fmaxf(mx1[0], __shfl_xor_sync(FULL, mx1[0], 2));
  const float mn0 = fmaxf(m0, mx0[0]), mn1 = fmaxf(m1, mx1[0]);
  c0 = ex2(m0 - mn0);
  c1 = ex2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0[CH], ps1[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) ps0[i] = ps1[i] = 0.f;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float mn = e < 2 ? mn0 : mn1;
      const float p = MASK ? ex2(s[4 * n + e] - mn) : ex2(__fmaf_rn(s[4 * n + e], scale_log2, -mn));
      s[4 * n + e] = p;
      if (e < 2) ps0[n % CH] += p; else ps1[n % CH] += p;
    }
  }
#pragma unroll
  for (int i = 1; i < CH; ++i) {
    ps0[0] += ps0[i];
    ps1[0] += ps1[i];
  }
  l0 = l0 * c0 + ps0[0];
  l1 = l1 * c1 + ps1[0];
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
fa_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
        const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
        int Lq, int Lk, int causal, float scale_log2, float empty_den) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + T::Q_BYTES;     // stage i: K at kv_s + 2i KV_BYTES, then V
  const uint32_t full = q_s + T::BARS;        // full[i] = full + 8i
  const uint32_t empty = full + 8 * T::STAGES;
  const uint32_t q_full = empty + 8 * T::STAGES;

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kv_plane = b * Hkv + h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // the longest key loops first
  const int ntiles = key_tiles(q0, BQ, BK, Lq, Lk, causal);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == CONSUMERS * WG) {     // the producer's thread
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tq)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tk)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tv)) : "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < T::STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * WG);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * WG) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / T::CW; ++c)
        tma_load(q_s + c * BQ * T::ROW, &tq, q_full, c * T::CW, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % T::STAGES;
        // the first pass over the ring finds every stage free
        mbar_wait(empty + 8 * st, ((j / T::STAGES) & 1) ^ 1);
        const uint32_t ks = kv_s + st * 2 * T::KV_BYTES, vs = ks + T::KV_BYTES;
        mbar_expect_tx(full + 8 * st, 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / T::CW; ++c) {
          tma_load(ks + c * BK * T::ROW, &tk, full + 8 * st, c * T::CW, j * BK, kv_plane);
          tma_load(vs + c * BK * T::ROW, &tv, full + 8 * st, c * T::CW, j * BK, kv_plane);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;                   // accumulator row, column pair
    const int r0 = q0 + wg * 64 + warp * 16 + g;           // this thread's rows r0, r0 + 8
    const int off = Lk - Lq;
    const uint32_t q_rows = q_s + wg * 64 * T::ROW;        // this warpgroup's rows of a chunk

    // S = Q K^T: k16 steps along D, 32 bytes apart inside a swizzled row
    auto issue_s = [&](float(&s)[BK / 2], uint32_t ks) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / (T::CW / 16);
        const uint32_t at = (kk % (T::CW / 16)) * 32;
        wgmma_ss(s, gmma_desc(q_rows + c * BQ * T::ROW + at, 16, 8 * T::ROW, T::LAYOUT),
                 gmma_desc(ks + c * BK * T::ROW + at, 16, 8 * T::ROW, T::LAYOUT), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: V's [key][d] tile is the MN-major B; k16 steps are 16 rows
    auto issue_pv = [&](float(&acc)[D / 2], const uint32_t(&pa)[BK / 16][4], uint32_t vs) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs(acc, pa[kk],
                 gmma_desc(vs + kk * 16 * T::ROW, BK * T::ROW, 8 * T::ROW, T::LAYOUT));
      wgmma_commit();
    };
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, c0, c1;
    auto softmax = [&](float(&s)[BK / 2], int j) {
      const int k0 = j * BK;
      if (k0 + BK > Lk || (causal && k0 + BK - 1 > q0 + off))
        online_softmax<true>(s, m0, m1, l0, l1, c0, c1, scale_log2, k0, r0, t, Lk, off, causal);
      else
        online_softmax<false>(s, m0, m1, l0, l1, c0, c1, scale_log2, k0, r0, t, Lk, off, causal);
    };
    // P as A fragments of 16 keys: accumulator blocks 2kk and 2kk + 1
    uint32_t pa[BK / 16][4];
    auto pack_p = [&](const float(&s)[BK / 2]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto stage = [&](int j) { return kv_s + (j % T::STAGES) * 2 * T::KV_BYTES; };

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    // Turns: turn j issues S_j and P_{j-1} V_{j-1}, between a sync on this
    // consumer's named barrier and an arrive on the other's, so that one
    // consumer's softmax runs while the other's products do.  Consumer 0
    // goes first; consumer 1 skips the arrive after its last turn.
    const int mine = 1 + wg, theirs = 2 - wg;
    if (wg == 1) bar_arrive(theirs);
    mbar_wait(q_full, 0);
    {
      float s[BK / 2];
      mbar_wait(full, 0);
      bar_sync(mine);
      fence_regs(s);
      wgmma_fence();
      issue_s(s, stage(0));
      bar_arrive(theirs);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(s, 0);
      pack_p(s);
    }
    for (int j = 1; j < ntiles; ++j) {
      float s[BK / 2];
      mbar_wait(full + 8 * (j % T::STAGES), (j / T::STAGES) & 1);
      bar_sync(mine);
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_s(s, stage(j));
      issue_pv(acc, pa, stage(j - 1) + T::KV_BYTES);
      bar_arrive(theirs);
      wgmma_wait<1>();
      fence_regs(s);
      softmax(s, j);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(empty + 8 * ((j - 1) % T::STAGES));   // tile j - 1 is read
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= c0;
        acc[4 * i + 1] *= c0;
        acc[4 * i + 2] *= c1;
        acc[4 * i + 3] *= c1;
      }
      pack_p(s);
    }
    bar_sync(mine);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(acc, pa, stage(ntiles - 1) + T::KV_BYTES);
    if (wg == 0) bar_arrive(theirs);
    wgmma_wait<0>();
    fence_regs(acc);

    l0 += __shfl_xor_sync(FULL, l0, 1);
    l0 += __shfl_xor_sync(FULL, l0, 2);
    l1 += __shfl_xor_sync(FULL, l1, 1);
    l1 += __shfl_xor_sync(FULL, l1, 2);
    const float den0 = fmaxf(m0 == NEG ? empty_den : l0, 1e-30f);
    const float den1 = fmaxf(m1 == NEG ? empty_den : l1, 1e-30f);
    const long long row0 = static_cast<long long>(bh) * Lq + r0;
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      const int col = d * 8 + 2 * t;
      if (r0 < Lq)
        *reinterpret_cast<uint32_t*>(o + row0 * D + col) =
            pack_bf16(acc[4 * d] / den0, acc[4 * d + 1] / den0);
      if (r0 + 8 < Lq)
        *reinterpret_cast<uint32_t*>(o + (row0 + 8) * D + col) =
            pack_bf16(acc[4 * d + 2] / den1, acc[4 * d + 3] / den1);
    }
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

// cuTensorMapEncodeTiled, from the driver through the runtime, so the
// library links the runtime only
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled found = nullptr;
  if (found == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &status);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e != cudaSuccess) return e;
    if (status != cudaDriverEntryPointSuccess || p == nullptr) return KERNEL_ERR_NO_ENTRY_POINT;
    found = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = found;
  return 0;
}

// (planes, rows, D) bf16 as a 3-D tensor map with boxes of 128 rows by
// cw columns in the matching swizzle.  Strides: D x 2 and rows x D x 2
// bytes, multiples of 16 for D in {32, 64, 128}.
int tensor_map(EncodeTiled fn, CUtensorMap* map, const void* base, int D, int rows, int planes,
               int cw) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(planes)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(rows) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cw), 128u, 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : tensor_map_error(static_cast<int>(r));
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv,
                int Lq, int Lk, int causal, float scale, float empty_den, cudaStream_t s) {
  using T = Tiles<D>;
  static_assert(BQ == 128 && BK == 128, "tensor_map's boxes are 128 rows");
  EncodeTiled fn;
  int e = encode_tiled(&fn);
  if (e != 0) return e;
  CUtensorMap tq, tk, tv;
  if ((e = tensor_map(fn, &tq, q, D, Lq, B * Hq, T::CW)) != 0) return e;
  if ((e = tensor_map(fn, &tk, k, D, Lk, B * Hkv, T::CW)) != 0) return e;
  if ((e = tensor_map(fn, &tv, v, D, Lk, B * Hkv, T::CW)) != 0) return e;
  e = cudaFuncSetAttribute(fa_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((Lq + BQ - 1) / BQ, B * Hq);
  fa_bf16<D><<<grid, TC_THREADS, T::SMEM, s>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq,
                                               Hkv, Lq, Lk, causal, scale * LOG2E, empty_den);
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
