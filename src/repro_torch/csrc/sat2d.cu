// sat2d: the integral-image kernels of the coreset's prefix statistics.
//
//   sat_moments_f64/f32  the (3, n, m) inclusive integral images of
//                        (1, y, y^2): the build (PrefixStats.build) and the
//                        stream's frames and bands.
//   sat_delta_f64/f32    the (3, b, m) rows of those images that change when
//                        the rows from r0 on are replaced or appended,
//                        continued from the stored integral row above them:
//                        the write path (PrefixStats.patch_rows).
//   sat_stack_f64/f32    the integral images of every (n, m) plane of a
//                        (B, n, m) stack in one launch: the moment rasters of
//                        all buckets of one merge-reduce level
//                        (ops.streaming_compress).
//
// Replaces src/repro/kernels/sat2d/kernel.py::scan_rows: its init=None form
// (body _row_scan_kernel) as sat2d/ops.py::sat_moments and ::sat_stack run
// it, and its init=... form (body _row_scan_seeded_kernel) as
// sat2d/ops.py::delta_sat_moments runs it, after the unseeded within-row
// pass.
//
// Two kernels carry all three ops, each in two modes:
//   row_scan  integral rows.  "Moments" mode (sat_moments, sat_delta): a
//             row's y and y^2 chains from one input row, into planes 1 and 2
//             of the output; channel 0 is never scanned.  "Plain" mode
//             (sat_stack): one chain a row, src to dst, src may equal dst.
//   col_scan  integral columns, one chain a lane.  "Seeded" from a carry row
//             (sat_delta) or from -0.0 (sat_moments, sat_stack).  In moments
//             mode plane 0 reads nothing and adds its ones' prefix; planes 1
//             and 2 continue row_scan's inner rows in place.
// sat_moments and sat_delta are row_scan then col_scan in moments mode;
// sat_stack_f64 is col_scan then row_scan in plain mode, sat_stack_f32 the
// other way round.
//
// Order.  The float64 variants equal numpy bitwise, every add and the
// product y*y rounded on its own (add_rn/mul_rn, and the build passes
// -fmad=false):
//   sat_moments  np.cumsum(np.cumsum(stk, axis=2), axis=1): each row scanned
//                left to right, then each column top to bottom.  Every chain
//                starts from -0.0: -0.0 + x == x for every x under
//                round-to-nearest, -0.0 included, so the first add yields
//                numpy's first element itself, signed zeros too (+0.0 would
//                turn a -0.0 into +0.0).  sat_moments is sat_delta with a
//                carry row of -0.0;
//   sat_delta    the numpy delta_sat oracle: the within-row scans of the b
//                tail rows, then a column scan seeded from the carry row, so
//                output row 0 is carry + inner[0] (an add: at r0 = 0 the
//                carry is +0.0 and a -0.0 cell comes out +0.0, as in the
//                oracle) and row i is row i-1 + inner[i];
//   sat_stack    PrefixStats.build_moments, the numpy streaming_compress
//                oracle: the columns first, then the rows.
// The float32 variants run the same code in float32, the TPU kernel's type,
// except that sat_stack_f32 scans the rows first, the order of the
// reference's Pallas sat_stack.  Padding a bucket's planes below and to the
// right (ops/backends.py _stack_rasters) leaves its top-left region
// unchanged in either order.  Channel 0's inner row is the sequential sum of
// ones, exactly j + 1 in float64 (m < 2^31) and min(j + 1, 2^24) in float32
// (2^24 + 1 rounds to the even 2^24, and the sum stays there); down the
// columns it is summed like any other plane, so float32 keeps the
// sequential sum's rounding past 2^24, not the product (i + 1)(j + 1).
//
// Carry.  The Pallas kernel carries a row's running sum from one column tile
// to the next in VMEM, which is valid only because a TPU grid runs its steps
// in order.  CUDA blocks run in no order, so nothing passes between blocks
// here: every scan line lies inside one thread, and no chain is split (a
// parallel prefix would reassociate the sums).
//
// Bound.  sat_moments moves y once and the images once, 4 values a cell:
// 0.160 ms at 4096 x 4096 in float64 at 3.35 TB/s; sat_delta the tail and
// the carry once and the output once; sat_stack 2 values a cell.  The two
// passes move 8 values a moments cell (row_scan reads y and writes planes 1
// and 2, col_scan reads them back and writes all three) and 4 a stack cell.
// Where the card has rows and columns to spare the passes are bytes-bound;
// a short tail or a narrow band is bound by its chains instead: a row's
// chain is m dependent adds long, a column's n.  The design spreads the
// chains over the card and keeps memory off their path:
//   row_scan  one warp a CTA, R rows: in moments mode lane r < R runs row
//     r's y chain and lane R + r its y^2 chain, in plain mode lane r < R row
//     r's chain; the other lanes repeat them and store nothing.  The rows'
//     (R, TILE) column tiles reach shared memory through a STAGES-deep
//     cp.async ring, STAGES - 1 tiles ahead of the chain.  A full tile is
//     scanned from registers loaded up front (16-byte shared loads),
//     unrolled over the compile-time TILE; the ragged last tile takes a loop
//     of its own.  Results go to shared memory, and the tile before is
//     stored from there along the rows, one store between a few adds of the
//     chain.  Every row the warp loads or stores has its own pointer,
//     advanced a tile at a time: recomputing a row's address for each store
//     made the warp wait on its address registers, and that, not the chain,
//     set the pass's time.  In place, the warp stores only tiles whose loads
//     it has waited for, and loads only tiles to their right.
//   col_scan  CW warps a CTA, one (plane, 32-column strip) a warp, one
//     column a lane, down the n rows through a C_STAGES-deep cp.async ring
//     of C_ROWS rows a stage, loads and stores through pointers that step
//     down a row at a time.  In place, a row is stored only after it was
//     read.
// Launch shapes (launch_of, sat_launch_shape) were chosen by timing
// candidates in turns on the card (scripts/sat_delta_turns.py).
#include "common.cuh"

namespace {

// row_scan in moments mode (sat_moments, sat_delta): columns a ring stage,
// ring depth, and the rows a CTA: 4 where that still gives MR_CTAS CTAs
// (two an SM), else 1.  Timed in turns on the card, the pass at 4 rows a
// CTA beat 2 by up to 8 % in float64 at 2048 and 4096 rows (fewer, longer
// CTAs move a tall image's bytes faster) and stayed within 3 % of it in
// float32; at 1 row it beat 2 by 6-8 % at 256 rows (a short tail or a
// band is bound by its chains: each row gets a warp of its own)
constexpr int MR_TILE = 64;
constexpr int MR_STAGES = 8;
constexpr int MR_CTAS = 264;
// row_scan in plain mode (sat_stack): rows a CTA, columns a ring stage,
// ring depth (in turns at 12 x 512 x 1024 in float64 the pass took 0.030 ms
// at 8 rows and 3 stages, 0.036 at 8 stages, 0.038 at 4 rows and 4 stages:
// a shallow ring leaves room for more CTAs an SM)
constexpr int PR_ROWS = 8;
constexpr int PR_TILE = 64;
constexpr int PR_STAGES = 3;
// col_scan: columns a warp (one a lane), rows a ring stage, ring depth
constexpr int C_STRIP = 32;
constexpr int C_ROWS = 16;
constexpr int C_STAGES = 8;
// the moments column pass takes a strip's three planes in one CTA of three
// warps (plane 0 reads nothing, planes 1 and 2 share the SM) where there are
// more warps than SMs (the H100 has 132), 5-7 % faster than one warp a CTA
// at 4096 columns; at or below it one warp a CTA spreads them over the SMs,
// 13-24 % faster at the stream's 1024 columns
constexpr int C_SPREAD = 132;

// ceil(a / d) for a < 2^31 without overflow
__host__ __device__ __forceinline__ int blocks_of(int a, int d) {
  return static_cast<int>((static_cast<long long>(a) + d - 1) / d);
}

// One element global -> shared, asynchronously; where !valid nothing is
// read and the element is zero-filled.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src, bool valid) {
  constexpr int kBytes = sizeof(T);
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
               "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Channel 0's inner row at column j: the sequential sum of j + 1 ones.
__device__ __forceinline__ double ones_prefix(double, long long j) {
  return static_cast<double>(j + 1);
}
__device__ __forceinline__ float ones_prefix(float, long long j) {
  return static_cast<float>(j + 1 < (1LL << 24) ? j + 1 : (1LL << 24));
}

// 16 bytes of T: the width of one shared-memory vector access, and the pad
// that keeps the rows of a staged tile on distinct banks and 16-byte aligned
template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  typedef double2 type;
};
template <>
struct Vec16<float> {
  typedef float4 type;
};

template <typename T>
__host__ __device__ constexpr int vec_n() {
  return 16 / static_cast<int>(sizeof(T));
}

// row_scan's shared memory: the ring, STAGES tiles of (R, TILE + N) inputs,
// then two tiles of results, (chains, TILE + N)
template <typename T, bool SQ, int R, int TILE, int STAGES>
constexpr int row_smem() {
  return static_cast<int>(sizeof(T)) * (STAGES * R + 2 * (SQ ? 2 * R : R)) *
         (TILE + vec_n<T>());
}

// Integral rows of input rows [R blockIdx.x, +R) of src (rows, m).  SQ
// (moments mode): lane r < R scans row r's y chain into dst, lane R + r its
// y^2 chain into dst + plane; plain mode: lane r < R scans row r into dst.
// The lanes above the chains repeat them and store nothing.  The pad of 16
// bytes keeps rows 16-byte aligned and on distinct banks.  Lane l moves
// columns l, l + 32, ... of a tile.  src may equal dst (plain mode).
template <typename T, bool SQ, int R, int TILE, int STAGES>
__global__ void __launch_bounds__(32)
row_scan(const T* src0, T* dst0, long long nrows, int m, long long plane) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef typename Vec16<T>::type V;
  constexpr int N = vec_n<T>();
  constexpr int CG = TILE / 32;            // columns of a tile a lane moves
  constexpr int OUT = SQ ? 2 * R : R;      // chains, each stored: y, then y^2
  constexpr int EVERY = 32 / OUT;          // chain steps between two stores
  static_assert(TILE % 32 == 0 && 32 % OUT == 0,
                "a full tile's chain stores the tile before it, one value every few steps");
  typedef T InTile[R][TILE + N];
  typedef T OutTile[OUT][TILE + N];
  InTile* ring = reinterpret_cast<InTile*>(smem);
  OutTile* res = reinterpret_cast<OutTile*>(smem + sizeof(InTile) * STAGES);
  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), nrows - row0));
  const int ntiles = blocks_of(m, TILE);
  const T* src[R];
  T* dst[OUT];
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    const long long i = row0 + min(k % R, rows - 1);
    if (k < R) src[k] = src0 + i * m + lane;
    dst[k] = dst0 + (k / R) * plane + i * m + lane;
  }

  int loaded = 0;
  auto load = [&]() {
    InTile& x = ring[loaded % STAGES];
    const long long c0 = static_cast<long long>(loaded) * TILE + lane;
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const bool ok = c0 + 32 * h < m && r < rows;
        cp_async_elem(&x[r][lane + 32 * h], ok ? src[r] + 32 * h : src0, ok);
      }
      src[r] += TILE;
    }
    ++loaded;
  };
  // tile t's results from o, the columns below m, then on to tile t + 1
  auto store_tile = [&](const OutTile& o, int t) {
    const long long c0 = static_cast<long long>(t) * TILE + lane;
#pragma unroll
    for (int k = 0; k < OUT; ++k) {
#pragma unroll
      for (int h = 0; h < CG; ++h)
        if (k % R < rows && c0 + 32 * h < m) dst[k][32 * h] = o[k][lane + 32 * h];
      dst[k] += TILE;
    }
  };

  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load();
    cp_async_commit();
  }
  const int r = lane % R;
  const bool sq = SQ && (lane / R) % 2 == 1;
  const bool keep = lane < OUT;  // a lane whose chain is stored
  // -0 + x == x for every x, so the first add yields the first element
  // itself, where numpy's scan starts
  T acc = T(-0.0);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncwarp();
    if (loaded < ntiles) load();
    cp_async_commit();
    const InTile& x = ring[t % STAGES];
    const OutTile& prev = res[(t + 1) & 1];
    T* o = res[t & 1][keep ? lane : 0];
    if (static_cast<long long>(t) * TILE + TILE <= m) {
      // tile t - 1 is full (none at t = 0): one of its values is stored
      // every EVERY steps of the chain
      alignas(16) T v[TILE];
      alignas(16) T w[TILE];
      T d[OUT * CG];
#pragma unroll
      for (int jj = 0; jj < TILE; jj += N)
        *reinterpret_cast<V*>(&v[jj]) = *reinterpret_cast<const V*>(&x[r][jj]);
#pragma unroll
      for (int k = 0; k < OUT; ++k)
#pragma unroll
        for (int h = 0; h < CG; ++h) d[k * CG + h] = prev[k][lane + 32 * h];
#pragma unroll
      for (int jj = 0; jj < TILE; ++jj) {
        T u = v[jj];
        if (sq) u = mul_rn(u, u);
        acc = add_rn(acc, u);
        w[jj] = acc;
        if (jj % N == N - 1 && keep)
          *reinterpret_cast<V*>(&o[jj + 1 - N]) = *reinterpret_cast<const V*>(&w[jj + 1 - N]);
        if (jj % EVERY == 0) {
          const int k = jj / EVERY / CG, h = jj / EVERY % CG;
          if (t > 0 && k % R < rows) dst[k][32 * h] = d[k * CG + h];
          if (t > 0 && h == CG - 1) dst[k] += TILE;
        }
      }
    } else {
      if (t > 0) store_tile(prev, t - 1);
      const int width = static_cast<int>(m - static_cast<long long>(t) * TILE);
      for (int jj = 0; jj < width; ++jj) {
        T u = x[r][jj];
        if (sq) u = mul_rn(u, u);
        acc = add_rn(acc, u);
        if (keep) o[jj] = acc;
      }
    }
    __syncwarp();
  }
  store_tile(res[(ntiles - 1) & 1], ntiles - 1);
}

// col_scan's ring slots: one a warp that reads, each C_STAGES stages of
// (C_ROWS, C_STRIP); a moments CTA of three warps has two (plane 0 reads
// nothing)
template <typename T>
constexpr int col_smem(int warps, bool ones0) {
  return static_cast<int>(sizeof(T)) * C_STAGES * C_ROWS * C_STRIP *
         (ones0 && warps == 3 ? 2 : warps);
}

// Integral columns of `planes` (n, m) row-major planes, src to dst (src may
// equal dst).  Warp w of CTA blockIdx.x takes unit g = CW blockIdx.x + w,
// plane p = g % planes, strip s = g / planes: lane l walks column 32 s + l
// of plane p down the n rows, seeded from carry[p] where carry is given and
// from -0.0 where it is null.  ones0 (moments mode): plane 0 reads nothing
// and adds its ones' prefix at each row.
template <typename T, int CW>
__global__ void __launch_bounds__(CW * 32)
col_scan(const T* src, T* dst, const T* __restrict__ carry, long long planes, int n, int m,
         bool ones0) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef T Stage[C_ROWS][C_STRIP];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long g = static_cast<long long>(blockIdx.x) * CW + w;
  const long long p = g % planes;
  const long long j = (g / planes) * C_STRIP + lane;
  const bool col_ok = j < m;
  const long long mm = m;
  const long long off = p * n * mm + j;  // row 0 of the column
  T* q = dst + off;
  T acc = !col_ok ? T(0) : carry != nullptr ? carry[p * mm + j] : T(-0.0);
  if (ones0 && p == 0) {
    if (!col_ok) return;
    const T x = ones_prefix(T(0), j);
#pragma unroll 16
    for (int i = 0; i < n; ++i) {
      acc = add_rn(acc, x);
      *q = acc;
      q += mm;
    }
    return;
  }
  Stage* ring = reinterpret_cast<Stage*>(smem) + (ones0 && CW == 3 ? w - 1 : w) * C_STAGES;
  const int nstages = blocks_of(n, C_ROWS);
  const T* next = src + off;  // the next row to load
  int loaded = 0;
  auto load = [&]() {
    Stage& st = ring[loaded % C_STAGES];
    const int left = n - loaded * C_ROWS;
#pragma unroll
    for (int r = 0; r < C_ROWS; ++r) {
      const bool ok = col_ok && r < left;
      cp_async_elem(&st[r][lane], ok ? next : src, ok);
      next += mm;
    }
    ++loaded;
  };
  for (int s = 0; s < C_STAGES - 1; ++s) {
    if (s < nstages) load();
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<C_STAGES - 2>();
    __syncwarp();
    if (loaded < nstages) load();
    cp_async_commit();
    const Stage& st = ring[s % C_STAGES];
    T v[C_ROWS];
#pragma unroll
    for (int r = 0; r < C_ROWS; ++r) v[r] = st[r][lane];
    const int left = n - s * C_ROWS;
#pragma unroll
    for (int r = 0; r < C_ROWS; ++r) {
      acc = add_rn(acc, v[r]);
      if (col_ok && r < left) *q = acc;
      q += mm;
    }
  }
}

// Both passes' launch at (planes, n, m): moments mode for sat_moments and
// sat_delta (planes = 3), plain mode for sat_stack.
struct Launch {
  long long row_ctas;
  int row_rows, row_stages, row_tile;
  long long col_ctas;
  int col_warps;
};

Launch launch_of(bool moments, long long planes, int n, int m) {
  Launch L;
  L.row_rows = !moments ? PR_ROWS : n >= 4 * MR_CTAS ? 4 : 1;
  L.row_stages = moments ? MR_STAGES : PR_STAGES;
  L.row_tile = moments ? MR_TILE : PR_TILE;
  L.row_ctas = ((moments ? n : planes * n) + L.row_rows - 1) / L.row_rows;
  const long long units = planes * blocks_of(m, C_STRIP);
  L.col_warps = moments && units > C_SPREAD ? 3 : 1;
  L.col_ctas = units / L.col_warps;  // 3 divides a moments launch's units
  return L;
}

template <typename T, bool SQ, int R, int TILE, int STAGES>
int launch_rows(const Launch& L, const T* src, T* dst, long long nrows, int m, long long plane,
                cudaStream_t s) {
  constexpr int bytes = row_smem<T, SQ, R, TILE, STAGES>();
  cudaError_t e = cudaFuncSetAttribute(row_scan<T, SQ, R, TILE, STAGES>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  row_scan<T, SQ, R, TILE, STAGES>
      <<<static_cast<unsigned>(L.row_ctas), 32, bytes, s>>>(src, dst, nrows, m, plane);
  return cudaGetLastError();
}

template <typename T>
int launch_cols(const Launch& L, const T* src, T* dst, const T* carry, long long planes, int n,
                int m, bool ones0, cudaStream_t s) {
  const int bytes = col_smem<T>(L.col_warps, ones0);
  const unsigned ctas = static_cast<unsigned>(L.col_ctas);
  cudaError_t e;
  if (L.col_warps == 3) {
    e = cudaFuncSetAttribute(col_scan<T, 3>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    col_scan<T, 3><<<ctas, 3 * 32, bytes, s>>>(src, dst, carry, planes, n, m, ones0);
  } else {
    e = cudaFuncSetAttribute(col_scan<T, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    col_scan<T, 1><<<ctas, 32, bytes, s>>>(src, dst, carry, planes, n, m, ones0);
  }
  return cudaGetLastError();
}

// sat_moments (carry null) and sat_delta: the y and y^2 inner rows into
// planes 1 and 2 of out, then the columns of all three planes in place
template <typename T>
int launch_moments(const T* carry, const T* y, T* out, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch L = launch_of(true, 3, n, m);
  const long long plane = static_cast<long long>(n) * m;
  int e = L.row_rows == 4
              ? launch_rows<T, true, 4, MR_TILE, MR_STAGES>(L, y, out + plane, n, m, plane, s)
              : launch_rows<T, true, 1, MR_TILE, MR_STAGES>(L, y, out + plane, n, m, plane, s);
  if (e != cudaSuccess) return e;
  return launch_cols<T>(L, out, out, carry, 3, n, m, true, s);
}

template <typename T>
int launch_stack(const T* stk, T* out, long long planes, int n, int m, bool cols_first,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Launch L = launch_of(false, planes, n, m);
  const long long rows = planes * n;
  int e = cols_first
              ? launch_cols<T>(L, stk, out, nullptr, planes, n, m, false, s)
              : launch_rows<T, false, PR_ROWS, PR_TILE, PR_STAGES>(L, stk, out, rows, m, 0, s);
  if (e != cudaSuccess) return e;
  return cols_first
             ? launch_rows<T, false, PR_ROWS, PR_TILE, PR_STAGES>(L, out, out, rows, m, 0, s)
             : launch_cols<T>(L, out, out, nullptr, planes, n, m, false, s);
}

}  // namespace

// y (n, m) row-major; out (3, n, m) row-major; n, m >= 1.
extern "C" int sat_moments_f64(const double* y, double* out, int n, int m, void* stream) {
  return launch_moments<double>(nullptr, y, out, n, m, stream);
}

extern "C" int sat_moments_f32(const float* y, float* out, int n, int m, void* stream) {
  return launch_moments<float>(nullptr, y, out, n, m, stream);
}

// carry (3, m), tail (b, m), out (3, b, m), all row-major and distinct; b, m >= 1.
extern "C" int sat_delta_f64(const double* carry, const double* tail, double* out, int b, int m,
                             void* stream) {
  return launch_moments<double>(carry, tail, out, b, m, stream);
}

extern "C" int sat_delta_f32(const float* carry, const float* tail, float* out, int b, int m,
                             void* stream) {
  return launch_moments<float>(carry, tail, out, b, m, stream);
}

// stk and out (planes, n, m) row-major, distinct buffers; planes, n, m >= 1.
extern "C" int sat_stack_f64(const double* stk, double* out, long long planes, int n, int m,
                             void* stream) {
  return launch_stack<double>(stk, out, planes, n, m, true, stream);
}

extern "C" int sat_stack_f32(const float* stk, float* out, long long planes, int n, int m,
                             void* stream) {
  return launch_stack<float>(stk, out, planes, n, m, false, stream);
}

// The launch of `stack` ? sat_stack at (planes, n, m) : sat_moments or
// sat_delta at (n, m), either type: row_scan's CTAs, rows a CTA, ring depth
// in tiles and a tile's columns; col_scan's CTAs, warps a CTA, ring depth in
// stages, a stage's rows and a warp's columns.
extern "C" void sat_launch_shape(int stack, long long planes, int n, int m, long long* shape) {
  const Launch L = launch_of(!stack, stack ? planes : 3, n, m);
  shape[0] = L.row_ctas;
  shape[1] = L.row_rows;
  shape[2] = L.row_stages;
  shape[3] = L.row_tile;
  shape[4] = L.col_ctas;
  shape[5] = L.col_warps;
  shape[6] = C_STAGES;
  shape[7] = C_ROWS;
  shape[8] = C_STRIP;
}
