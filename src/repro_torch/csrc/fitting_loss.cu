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
// Sparsity.  A tree's leaves tile the signal and a block is a small
// rectangle of it, so only a few leaves overlap any one block (at the
// serving shapes 2.4 % of the (block, leaf) pairs, chip_smoke.py's
// overlap_share).  A pair with z = 0 leaves Z as it was and adds an exact
// zero to the loss (for finite labels), so skipping it changes no bit.  A
// warp scores 32 consecutive blocks, one a lane, and holds their bounding
// box.  The lanes test 32 leaves at once against the box, one a lane, and a
// ballot gives the leaves that can overlap any of the blocks; only those,
// in leaf order, have every lane compute z and, where z > 0, the four
// points' terms.  So a chunk's chain is as long as the leaves its box
// meets, not K.  The result does not depend on the block order; the speed
// does: the coreset's blocks come band by band, left to right within a
// band (core/balanced.py, core/slice_partition.py), so 32 consecutive
// blocks lie in one or two row bands and their box meets few leaves (at the
// serving shapes 16-21 % of the (chunk, leaf) pairs).
//
// One tree a CTA.  The CTA stages its tree's leaves in shared memory
// (16-byte rectangles, then labels), and its warps take the CTA's chunks in
// rounds, each fetching its next chunk's blocks while it scores this one.
// Staging several trees a CTA, so that a block's registers serve them all,
// was slower at every shape timed (scripts/fitting_loss_turns.py): a
// block's loads are a small part of a chunk's work, and fewer CTAs hide
// less latency.
//
// Reduction.  The Pallas kernel sums over B tiles in place, relying on the
// TPU's sequential grid; CUDA blocks run in parallel and atomics would make
// the sum vary from run to run.  Here a warp's 32 lanes are summed in a
// fixed butterfly into partial[t, chunk] (chunk = 32 consecutive blocks), and
// each tree's chunks are summed in chunk order by one warp (tree_sum): in
// the tree's CTA when it covers every chunk, else in the tree's last CTA to
// finish, which a count of finished CTAs names (a fixed-order sum of what
// the others left in L2, so the order in which CTAs run changes nothing).
// The chunks and the order depend on B alone, so a tree's loss depends only
// on the coreset and that tree: not on T, on its batch-mates or on the
// launch shape, and zero-area padding leaves (never overlapping) change
// nothing.
//
// Launch shape (fl_launch_shape chooses it from B, T and the card's SMs;
// kernels/fitting_loss/kernel.py::launch_shape asks it): grid (T, splits),
// each CTA up to 16 warps.  Many trees: one CTA a tree over all its chunks.
// Few trees (a single query): the chunks are split over CTAs until the card
// is filled.  One launch either way.
//
// Bound.  Operations at the float32 issue rate (33.5 T/s on an H100; the
// loss body has no fused multiply-add), counted as these inputs need them
// in this design (chip_smoke.py's fl_work): a box test of every (tree,
// chunk, leaf), the 32 lanes' overlaps of each (tree, chunk, leaf) in which
// some block overlaps the leaf, and the loss body of each (tree, block,
// leaf) with z > 0.  At the serving shapes (T = 256, K = 64, B ~ 2,100)
// that is ~3 us; T = 1 is bound by latency instead: the loads, a chunk's
// chain of leaves and the final sum.  The design spends a 32-wide box test
// per 32 leaves instead of 32 x 32 overlaps, keeps the chains to the leaves
// that meet a box, and fills the card at T = 1.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int LANES = 32;        // coreset blocks per chunk: one warp
constexpr int KTILE = 256;       // leaves staged at a time
constexpr int MAX_WARPS = 16;
constexpr unsigned FULL = 0xffffffffu;

// A tree's chunk partials summed in chunk order by one warp, the one order
// both final sums use: the lanes load 128 partials at a time from L2 (the
// last CTA reads other CTAs' partials) and every lane adds them in order
// from the shuffles, so only one load in 128 waits.
__device__ __forceinline__ float tree_sum(const float* p, int nchunks, int lane) {
  float s = 0.f;
  for (int c0 = 0; c0 < nchunks; c0 += 4 * LANES) {
    float v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int c = c0 + h * LANES + lane;
      v[h] = c < nchunks ? __ldcg(p + c) : 0.f;
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int base = c0 + h * LANES, n = min(LANES, nchunks - base);
      if (n == LANES) {
#pragma unroll
        for (int i = 0; i < LANES; ++i) {
          const float x = __shfl_sync(FULL, v[h], i);
          s = base + i == 0 ? x : add_rn(s, x);
        }
      } else {
        for (int i = 0; i < n; ++i) {
          const float x = __shfl_sync(FULL, v[h], i);
          s = base + i == 0 ? x : add_rn(s, x);
        }
      }
    }
  }
  return s;
}

// block b's rectangle, labels and weights; a lane past B (or off the CTA's
// chunks) gets an empty rectangle and zero weights: it meets no leaf,
// widens no box and adds exact zeros
struct Block {
  float4 rect, lab, w;
};

__device__ __forceinline__ Block load_block(const float4* blk, long long b, bool live) {
  const float inf = __int_as_float(0x7f800000);
  Block k = {make_float4(inf, -inf, inf, -inf), make_float4(0.f, 0.f, 0.f, 0.f),
             make_float4(0.f, 0.f, 0.f, 0.f)};
  if (live) {
    k.rect = blk[4 * b];
    k.lab = blk[4 * b + 1];
    k.w = blk[4 * b + 2];
  }
  return k;
}

__global__ void __launch_bounds__(MAX_WARPS * LANES)
fl_score(const float4* __restrict__ blk, const float4* __restrict__ seg,
         float* __restrict__ partial, unsigned* __restrict__ done, float* __restrict__ out,
         int B, int K, int nchunks, int chunks_per_cta) {
  extern __shared__ float4 sm[];
  __shared__ bool last;
  const int kcap = min(K, KTILE);
  float4* srect = sm;                                          // [kcap]
  float* slab = reinterpret_cast<float*>(sm + kcap);           // [kcap]

  const int t = blockIdx.x;
  const int warps = blockDim.x / LANES, warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int c_begin = blockIdx.y * chunks_per_cta;
  const int c_end = min(c_begin + chunks_per_cta, nchunks);
  const int rounds = (chunks_per_cta + warps - 1) / warps;
  const int ktiles = (K + KTILE - 1) / KTILE;
  const float4* tree = seg + 2 * static_cast<long long>(t) * K;

  auto chunk_of = [&](int r) { return c_begin + r * warps + warp; };
  auto fetch = [&](int r) {
    const int b = chunk_of(r) * LANES + lane;
    return load_block(blk, b, r < rounds && chunk_of(r) < c_end && b < B);
  };
  Block next = fetch(0);
  for (int r = 0; r < rounds; ++r) {
    const int chunk = chunk_of(r);
    const bool live_chunk = chunk < c_end;
    const Block cur = next;
    next = fetch(r + 1);              // in flight while this chunk is scored
    const float r0 = cur.rect.x, r1 = cur.rect.y, c0 = cur.rect.z, c1 = cur.rect.w;
    const float lab[4] = {cur.lab.x, cur.lab.y, cur.lab.z, cur.lab.w};
    const float wv[4] = {cur.w.x, cur.w.y, cur.w.z, cur.w.w};
    float U[4], Up[4];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      run = i == 0 ? wv[0] : add_rn(run, wv[i]);
      U[i] = run;
      Up[i] = U[i] - wv[i];
    }
    float R0 = r0, R1 = r1, C0 = c0, C1 = c1;     // the chunk's bounding box
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      R0 = fminf(R0, __shfl_xor_sync(FULL, R0, s));
      R1 = fmaxf(R1, __shfl_xor_sync(FULL, R1, s));
      C0 = fminf(C0, __shfl_xor_sync(FULL, C0, s));
      C1 = fmaxf(C1, __shfl_xor_sync(FULL, C1, s));
    }

    float Z = 0.f, acc = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int k0 = kt * KTILE, kn = min(KTILE, K - k0);
      if (ktiles > 1 || r == 0) {       // uniform over the CTA
        __syncthreads();
        for (int kk = threadIdx.x; kk < kn; kk += blockDim.x) {
          srect[kk] = tree[2 * (k0 + kk)];
          slab[kk] = tree[2 * (k0 + kk) + 1].x;
        }
        __syncthreads();
      }
      if (!live_chunk) continue;
      for (int k1 = 0; k1 < kn; k1 += LANES) {
        // the box test of 32 leaves at once, one a lane
        bool meets = false;
        if (k1 + lane < kn) {
          const float4 l = srect[k1 + lane];
          // min(R1, l1) > max(R0, l0) fails => every lane's row overlap is 0
          meets = fminf(R1, l.y) > fmaxf(R0, l.x) && fminf(C1, l.w) > fmaxf(C0, l.z);
        }
        // then the leaves that meet the box, in leaf order
        for (unsigned left = __ballot_sync(FULL, meets); left != 0; left &= left - 1) {
          const int kk = k1 + __ffs(left) - 1;
          const float4 l = srect[kk];
          const float zr = fmaxf(fminf(r1, l.y) - fmaxf(r0, l.x), 0.f);
          const float zc = fmaxf(fminf(c1, l.w) - fmaxf(c0, l.z), 0.f);
          const float z = mul_rn(zr, zc);
          if (!(z > 0.f)) continue;
          Z = add_rn(Z, z);
          const float Zp = Z - z;
          const float label = slab[kk];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float consumed = fmaxf(fminf(Z, U[i]) - fmaxf(Zp, Up[i]), 0.f);
            const float d = label - lab[i];
            acc = add_rn(acc, mul_rn(mul_rn(consumed, d), d));
          }
        }
      }
    }
    if (live_chunk) {
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) acc = add_rn(acc, __shfl_xor_sync(FULL, acc, s));
      if (lane == 0) partial[static_cast<long long>(t) * nchunks + chunk] = acc;
    }
  }

  // The last CTA of a tree to finish sums it: the partials of the tree's
  // other CTAs are in L2 once their counts have landed.  It leaves the
  // tree's count at 0 for the next launch.
  __syncthreads();
  if (gridDim.y > 1) {
    if (threadIdx.x == 0) {
      __threadfence();
      last = atomicAdd(done + t, 1u) == gridDim.y - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  }
  if (warp == 0) {
    const float sum = tree_sum(partial + static_cast<long long>(t) * nchunks, nchunks, lane);
    if (lane == 0) {
      out[t] = sum;
      if (gridDim.y > 1) done[t] = 0;
    }
  }
}

}  // namespace

// The launch of T trees against B blocks on a card of `sms` SMs, the one
// place its numbers live: shape = {chunk (blocks a warp scores), chunks
// (the partials a tree), splits (CTAs a tree), chunks a CTA, warps a CTA,
// rounds, CTAs, warps a CTA at most}.  One CTA a tree over all its chunks
// once the trees fill half the SMs, else a tree's chunks split over CTAs
// until the card is filled.  B, T, sms >= 1.
extern "C" void fl_launch_shape(int B, int T, int sms, long long* shape) {
  const long long nchunks = (static_cast<long long>(B) + LANES - 1) / LANES;
  long long splits = 1;
  if (T < sms / 2) splits = std::min({nchunks, (sms + T - 1LL) / T, 65535LL});
  const long long per_cta = (nchunks + splits - 1) / splits;
  splits = (nchunks + per_cta - 1) / per_cta;
  const long long warps = std::min<long long>(per_cta, MAX_WARPS);
  shape[0] = LANES;
  shape[1] = nchunks;
  shape[2] = splits;
  shape[3] = per_cta;
  shape[4] = warps;
  shape[5] = (per_cta + warps - 1) / warps;
  shape[6] = static_cast<long long>(T) * splits;
  shape[7] = MAX_WARPS;
}

// blk (B, 16): rects | labels | weights | unused; seg (T, K, 8): rect | label
// | unused; both 16-byte aligned.  partial (T, chunks) scratch; done (T,)
// counts, zero on entry and left zero; out (T,).  The launch shape: warps
// in [1, 16], splits in [1, min(65535, chunks)] (fl_launch_shape gives
// chunks and the default).  B, T, K >= 1, T <= 2^31 - 1.
extern "C" int fitting_loss_batched(const float* blk, const float* seg, float* partial,
                                    unsigned* done, float* out, int B, int T, int K, int warps,
                                    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (B + LANES - 1) / LANES;
  if (B < 1 || T < 1 || K < 1 || warps < 1 || warps > MAX_WARPS || splits < 1 ||
      splits > 65535 || splits > nchunks)
    return cudaErrorInvalidValue;
  const int per_cta = (nchunks + splits - 1) / splits;
  const size_t smem = static_cast<size_t>(K < KTILE ? K : KTILE) * (sizeof(float4) + sizeof(float));
  fl_score<<<dim3(T, splits), warps * LANES, smem, s>>>(
      reinterpret_cast<const float4*>(blk), reinterpret_cast<const float4*>(seg), partial, done,
      out, B, K, nchunks, per_cta);
  return cudaGetLastError();
}
