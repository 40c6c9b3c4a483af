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
// float32, for Hopper (sm_90a).  A CTA owns 16 query rows and has four
// warps; each warp takes a quarter of every key tile (16 keys, 8 at
// D = 128) with its own online softmax, and the four (m, l, acc) are merged
// in a fixed order at the end.  So the float32 cross-check's 4 x 14 heads
// of 64 rows make 224 CTAs, and a warp's chain of products is a quarter of
// the tile's.
//   - Products on the tensor cores at float32 accuracy: 3xTF32 on
//     mma.sync.m16n8k8.  Each operand x is split into hi = tf32(x) and
//     lo = tf32(x - hi) (x - hi is exact), and a.b is summed as
//     lo_a.hi_b + hi_a.lo_b + hi_a.hi_b in float32; the dropped lo.lo term
//     is below float32's last bit.  Plain TF32 would keep ten mantissa bits.
//   - Loads: K and V tiles of 64 keys (32 at D = 128) by 16-byte cp.async
//     into a two-stage ring, the next tile in flight while this one is
//     used; rows padded by 4 floats, so every fragment load hits 32 banks.
//     Keys past Lk are zero-filled.  The CTA's Q rows come the same way,
//     once, and each product reads its A fragments from there.
//   - S's accumulators have the bf16 kernel's layout, so the same online
//     softmax runs on them (exp2, log2(e) folded into the scale); P is
//     split in registers as the A fragment of P V, its columns taken in the
//     order (2t, 2t + 1) and V's rows in the same order.
//   - The merge: a slice that saw no key of a row weighs exactly 0 once
//     another slice did; a row that no slice saw keeps the sum of V over
//     every slot and divides by empty_den, as the single softmax would.
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
// loads) and epilogue are exposed once per 128 query rows.  In float32, at
// the cross-check's 4 x 14 x 64 x 64, the work is 30 MFLOP (x3 for the
// split, at the TF32 peak) on 2 MB: both bounds are below a microsecond and the time is
// latency, so the design fills the card with small CTAs, splits each tile's
// products over four warps and overlaps each tile's load with the previous
// tile's products.
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


// The online softmax over one S tile of N / 4 blocks of 8 keys held as
// wgmma or mma.sync accumulators (the same layout): this thread's rows r0
// and r0 + 8, keys k0 + 8n + 2t (+1) in s[4n..4n+3].  On
// return s holds P (float32), (m, l) are updated and c0, c1 are the rows'
// corrections.  MASK: the tile crosses the causal diagonal or the Lk edge.
// Each row's maximum and sum run as CH independent chains, so that their
// latencies overlap.
template <bool MASK, int N>
__device__ __forceinline__ void online_softmax(float (&s)[N], float& m0, float& m1,
                                               float& l0, float& l1, float& c0, float& c1,
                                               float scale_log2, int k0, int r0, int t, int Lk,
                                               int off, int causal) {
  constexpr int CH = 4;
  float mx0[CH], mx1[CH];
#pragma unroll
  for (int i = 0; i < CH; ++i) mx0[i] = mx1[i] = NEG;
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
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
  for (int n = 0; n < N / 4; ++n) {
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
constexpr int F_ROWS = 16;      // query rows a CTA
constexpr int F_SLICES = 4;     // warps a CTA: each takes a quarter of every key tile

template <int D>
struct F32Tiles {
  static constexpr int BK = D == 128 ? 32 : 64;   // keys a K/V tile
  static constexpr int SK = BK / F_SLICES;         // keys a warp's slice of it
  static constexpr int LD = D + 4;                 // padded row: fragment loads hit 32 banks
  static constexpr int STAGE = 2 * BK * LD;        // floats: K tile, then V tile
  // two stages, then the CTA's query rows; the stages hold the slices'
  // (m, l, acc) for the merge at the end
  static constexpr int SMEM = (2 * STAGE + F_ROWS * LD) * static_cast<int>(sizeof(float));
  static_assert(F_SLICES * F_ROWS * (2 + LD) <= 2 * STAGE, "merge buffer");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x as a pair of tf32 values, hi + lo; x - hi is exact
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32, the small terms first; a and b as (hi, lo) halves
__device__ __forceinline__ void mma_3xtf32(float* d, const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// rows r0 .. r0 + n - 1 of a head's (L, D) matrix x into padded rows of dst
// (and of y into dst + n LD), by 16-byte copies; rows past L are zero-filled
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* x, const float* y,
                                          long long base, int r0, int n, int L) {
  constexpr int CH = D / 4, LD = F32Tiles<D>::LD;   // 16-byte chunks a row
  for (int e = threadIdx.x; e < n * CH; e += blockDim.x) {
    const int r = e / CH, c = e % CH;
    const bool in = r0 + r < L;
    const long long at = base + static_cast<long long>(in ? r0 + r : 0) * D + 4 * c;
    cp_async16(dst + r * LD + 4 * c, x + at, in);
    if (y != nullptr) cp_async16(dst + n * LD + r * LD + 4 * c, y + at, in);
  }
}

template <int D>
__global__ void __launch_bounds__(F_SLICES * 32)
fa_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ o, int Hq, int Hkv, int Lq, int Lk, int causal, float scale_log2,
       float empty_den) {
  using T = F32Tiles<D>;
  constexpr int BK = T::BK, SK = T::SK, LD = T::LD;
  extern __shared__ __align__(16) float fsm[];

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * F_ROWS;   // the longest key loops first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;   // warp: the key slice
  const int g = lane / 4, t = lane % 4;                // fragment row, column
  const int r0 = q0 + g;                               // this thread's rows r0, r0 + 8
  const int off = Lk - Lq;
  const long long qbase = static_cast<long long>(bh) * Lq * D;
  const long long kvbase = (static_cast<long long>(b) * Hkv + kvh) * Lk * D;
  const int ntiles = key_tiles(q0, F_ROWS, BK, Lq, Lk, causal);

  float* qs = fsm + 2 * T::STAGE;
  load_rows<D>(qs, q, nullptr, qbase, q0, F_ROWS, Lq);
  load_rows<D>(fsm, k, v, kvbase, 0, BK, Lk);
  cp_async_commit();
  // A fragments of Q: rows g, g + 8 by columns 8kk + t, + 4
  const float* qw = qs + g * LD + t;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f, c0 = 1.f, c1 = 1.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_rows<D>(fsm + ((j + 1) & 1) * T::STAGE, k, v, kvbase, (j + 1) * BK, BK, Lk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // this warp's slice: keys k0 .. k0 + SK - 1
    const float* ks = fsm + (j & 1) * T::STAGE + warp * SK * LD;
    const float* vs = ks + BK * LD;
    const int k0 = j * BK + warp * SK;
    // S = Q K^T: B fragment of key block n is K[8n + g][8kk + t (+ 4)]
    float s[SK / 2];
#pragma unroll
    for (int i = 0; i < SK / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_tf32(qw[8 * (e & 1) * LD + 8 * kk + 4 * (e >> 1)], ah[e], al[e]);
#pragma unroll
      for (int n = 0; n < SK / 8; ++n) {
        const float* kr = ks + (8 * n + g) * LD + 8 * kk + t;
        uint32_t kh[2], kl[2];
        split_tf32(kr[0], kh[0], kl[0]);
        split_tf32(kr[4], kh[1], kl[1]);
        mma_3xtf32(s + 4 * n, ah, al, kh, kl);
      }
    }
    if (k0 + SK > Lk || (causal && k0 + SK - 1 > q0 + off))
      online_softmax<true>(s, m0, m1, l0, l1, c0, c1, scale_log2, k0, r0, t, Lk, off, causal);
    else
      online_softmax<false>(s, m0, m1, l0, l1, c0, c1, scale_log2, k0, r0, t, Lk, off, causal);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[4 * i] *= c0;
      acc[4 * i + 1] *= c0;
      acc[4 * i + 2] *= c1;
      acc[4 * i + 3] *= c1;
    }
    // O += P V over key blocks kk: the accumulator holds keys 2t, 2t + 1 of
    // rows r0, r0 + 8, so fragment column t is key 2t and t + 4 is key
    // 2t + 1; V's B fragment takes its rows in the same order
#pragma unroll
    for (int kk = 0; kk < SK / 8; ++kk) {
      uint32_t ph[4], pl[4];
      split_tf32(s[4 * kk], ph[0], pl[0]);
      split_tf32(s[4 * kk + 2], ph[1], pl[1]);
      split_tf32(s[4 * kk + 1], ph[2], pl[2]);
      split_tf32(s[4 * kk + 3], ph[3], pl[3]);
      const float* vr = vs + (8 * kk + 2 * t) * LD + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t vh[2], vl[2];
        split_tf32(vr[8 * n], vh[0], vl[0]);
        split_tf32(vr[LD + 8 * n], vh[1], vl[1]);
        mma_3xtf32(acc + 4 * n, ph, pl, vh, vl);
      }
    }
    __syncthreads();      // every warp is done with the stage the next load fills
  }

  // Merge the slices in slice order: each warp's (m, l, acc) into the
  // stages, then M = max m, L = sum l 2^(m - M), O = sum acc 2^(m - M).  A
  // slice that saw no key of a row (m = NEG) weighs 0 once another did; a
  // row no slice saw keeps every slot's V and divides by empty_den.
  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  float* mm = fsm;                              // [slice][row]
  float* ll = mm + F_SLICES * F_ROWS;           // [slice][row]
  float* aa = ll + F_SLICES * F_ROWS;           // [slice][row][LD]
  if (t == 0) {
    mm[warp * F_ROWS + g] = m0;
    mm[warp * F_ROWS + g + 8] = m1;
    ll[warp * F_ROWS + g] = l0;
    ll[warp * F_ROWS + g + 8] = l1;
  }
  float* aw = aa + (warp * F_ROWS + g) * LD + 2 * t;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(aw + 8 * n) = make_float2(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<float2*>(aw + 8 * LD + 8 * n) = make_float2(acc[4 * n + 2], acc[4 * n + 3]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < F_ROWS * D / 2; e += blockDim.x) {
    const int row = e / (D / 2), col = 2 * (e % (D / 2));
    if (q0 + row >= Lq) continue;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < F_SLICES; ++w) M = fmaxf(M, mm[w * F_ROWS + row]);
    float L = 0.f, ox = 0.f, oy = 0.f;
#pragma unroll
    for (int w = 0; w < F_SLICES; ++w) {
      const float f = ex2(mm[w * F_ROWS + row] - M);
      const float2 a = *reinterpret_cast<const float2*>(aa + (w * F_ROWS + row) * LD + col);
      L += ll[w * F_ROWS + row] * f;
      ox += a.x * f;
      oy += a.y * f;
    }
    const float den = fmaxf(M == NEG ? empty_den : L, 1e-30f);
    *reinterpret_cast<float2*>(o + qbase + static_cast<long long>(q0 + row) * D + col) =
        make_float2(ox / den, oy / den);
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
  constexpr int bytes = F32Tiles<D>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(fa_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((Lq + F_ROWS - 1) / F_ROWS, B * Hq);
  fa_f32<D><<<grid, F_SLICES * 32, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Hq, Hkv, Lq, Lk, causal, scale * LOG2E, empty_den);
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
