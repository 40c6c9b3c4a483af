// sat2d: the integral-image kernels of the coreset's prefix statistics.
//
//   sat_moments_f64/f32  the (3, n, m) inclusive integral images of
//                        (1, y, y^2): the build (PrefixStats.build).
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
// Order.  The float64 variants equal numpy bitwise, every add and the
// product y*y rounded on its own (add_rn/mul_rn, and the build passes
// -fmad=false):
//   sat_moments  np.cumsum(np.cumsum(stk, axis=2), axis=1): each row scanned
//                left to right by one thread, then each column top to bottom
//                by one thread;
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
// unchanged in either order.
//
// Carry.  The Pallas kernel carries a row's running sum from one column tile
// to the next in VMEM, which is valid only because a TPU grid runs its steps
// in order.  CUDA blocks run in no order, so nothing passes between blocks
// here: every scan line lies inside one thread.  A row-pass block owns whole
// rows and walks their column tiles in a loop, keeping each row's carry in a
// register; a column-pass thread walks one whole column.
//
// Bound of sat_moments and sat_stack.  Their two passes move the input once
// and the output three times (written by the first pass, read and rewritten
// in place by the second): at 4096 x 4096 in float64, 1.34 GB for
// sat_moments against the 0.54 GB (read y, write the images once) of the
// least time on the card; sat_stack 4 against 2 bytes per element.  Both are
// bytes-bound.  The design buys coalescing, not fewer bytes: a row pass
// stages (ROWS, TILE) tiles through shared memory so that global loads and
// stores run along rows, and the column pass is coalesced by construction
// (neighbouring threads own neighbouring columns) and keeps COL_UNROLL loads
// in flight per thread because its adds form one dependent chain per column.
//
// sat_delta.  A tail has 2b row chains (the y and y^2 scans of each row, m
// dependent adds each) and 3m column chains (b dependent adds each); no
// chain may be split, since a parallel prefix would reassociate the sums.
// Its bound moves the tail and the carry once and the output once, 4 values
// a tail cell: 0.080 ms for a 2048 x 4096 tail in float64 at 3.35 TB/s,
// 0.010 ms for 256 rows.  A short tail is not bytes-bound but bound by its
// row chains: only 2b of them, each 4096 dependent adds long at m = 4096.
// The design spreads them over the card and keeps memory off their path:
//   sat_delta_rows  one warp a CTA, DR_ROWS (2) tail rows: lane r runs row
//     r's y chain, lane DR_ROWS + r its y^2 chain (the other lanes repeat
//     them and store nothing), so a 256-row tail takes 128 SMs.  The tail's
//     (DR_ROWS, DR_TILE) column tiles reach shared memory through a
//     DR_STAGES-deep cp.async ring, DR_STAGES - 1 tiles ahead of the chain.
//     A full tile is scanned from registers loaded up front (16-byte shared
//     loads), unrolled over the compile-time DR_TILE; the ragged last tile
//     takes a loop of its own.  Results go to shared memory, and the tile
//     before is stored from there along the rows, one store between a few
//     adds of the chain.  Every row the warp loads or stores has its own
//     pointer, advanced a tile at a time: recomputing a row's address for
//     each store made the warp wait on its address registers, and that, not
//     the chain, set the pass's time.  It writes the y and y^2 inner rows to
//     output planes 1 and 2.  Channel 0 is never scanned: its inner row is
//     the sequential sum of ones, exactly j + 1 in float64 (m < 2^31) and
//     min(j + 1, 2^24) in float32 (2^24 + 1 rounds to the even 2^24, and
//     the sum stays there).
//   sat_delta_cols  three warps a CTA, DC_STRIP (32) columns: warp p walks
//     plane p down the b rows, one column a lane, seeded from carry[p];
//     plane 0 adds the ones' prefix, planes 1 and 2 read their inner rows
//     back through a DC_STAGES-deep cp.async ring of DC_ROWS rows a stage
//     and overwrite them in place, loads and stores through pointers that
//     step down a row at a time.
// The two passes move the tail once, planes 1 and 2 twice and the output
// once: 8 values a tail cell against the bound's 4.  One pass would move 4,
// but it would hand each row group's bottom row to the next group, a serial
// chain of b / DR_ROWS handoffs through global memory.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;         // rows per block: one lane of each warp
constexpr int TILE = 32;         // columns per shared-memory tile
constexpr int ROW_THREADS = 96;  // three warps, warp c scans channel c
constexpr int COL_THREADS = 64;
constexpr int COL_UNROLL = 32;
constexpr int STACK_WARPS = 4;   // warps per stack_row_pass block, 32 rows each

// sat_delta's shapes, chosen by timing candidates in turns on the card
constexpr int DR_ROWS = 2;       // tail rows per sat_delta_rows CTA (one warp)
constexpr int DR_TILE = 64;      // columns per ring stage
constexpr int DR_STAGES = 8;
constexpr int DC_STRIP = 32;     // columns per sat_delta_cols CTA (three warps)
constexpr int DC_ROWS = 16;      // tail rows per ring stage
constexpr int DC_STAGES = 8;
static_assert(DR_TILE % 32 == 0 && 32 % (2 * DR_ROWS) == 0,
              "a full tile's chain stores the tile before it, one value every few steps");

// ceil(a / d) for a < 2^31 without overflow
__host__ __device__ __forceinline__ int blocks_of(int a, int d) {
  return static_cast<int>((static_cast<long long>(a) + d - 1) / d);
}

template <typename T>
__global__ void __launch_bounds__(ROW_THREADS)
row_pass(const T* __restrict__ y, T* __restrict__ out, int n, int m) {
  __shared__ T sy[ROWS][TILE + 1];
  __shared__ T so[3][ROWS][TILE + 1];
  const int lane = threadIdx.x & 31;
  const int ch = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const long long plane = static_cast<long long>(n) * m;
  T acc = T(0);
  for (int c0 = 0; c0 < m; c0 += TILE) {
    const int j = c0 + lane;
    for (int r = ch; r < ROWS; r += 3) {
      const long long i = row0 + r;
      sy[r][lane] = (i < n && j < m) ? y[i * m + j] : T(0);
    }
    __syncthreads();
    const int width = min(TILE, m - c0);
    for (int jj = 0; jj < width; ++jj) {
      const T v = sy[lane][jj];
      const T x = ch == 0 ? T(1) : (ch == 1 ? v : mul_rn(v, v));
      // numpy's first element is the input itself, not 0 + input (which
      // would turn -0.0 into +0.0)
      acc = (c0 == 0 && jj == 0) ? x : add_rn(acc, x);
      so[ch][lane][jj] = acc;
    }
    __syncthreads();
    for (int r = 0; r < ROWS; ++r) {
      const long long i = row0 + r;
      if (i < n && j < m) out[ch * plane + i * m + j] = so[ch][r][lane];
    }
    __syncthreads();
  }
}

// Integral rows of a (rows, m) row-major array, src to dst (src may equal
// dst): each warp owns ROWS whole rows, stages (ROWS, TILE) tiles in its own
// shared memory and scans its rows in them, one lane a row.  Warps share
// nothing, so they synchronise only among their own lanes.
template <typename T>
__global__ void __launch_bounds__(32 * STACK_WARPS)
stack_row_pass(const T* src, T* dst, long long rows, int m) {
  __shared__ T tile[STACK_WARPS][ROWS][TILE + 1];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long row0 = (static_cast<long long>(blockIdx.x) * STACK_WARPS + w) * ROWS;
  if (row0 >= rows) return;  // the whole warp leaves together
  T(*t)[TILE + 1] = tile[w];
  T acc = T(0);
  for (int c0 = 0; c0 < m; c0 += TILE) {
    const int j = c0 + lane;
    for (int r = 0; r < ROWS; ++r) {
      const long long i = row0 + r;
      t[r][lane] = (i < rows && j < m) ? src[i * m + j] : T(0);
    }
    __syncwarp();
    const int width = min(TILE, m - c0);
    for (int jj = 0; jj < width; ++jj) {
      const T x = t[lane][jj];
      acc = (c0 == 0 && jj == 0) ? x : add_rn(acc, x);
      t[lane][jj] = acc;
    }
    __syncwarp();
    for (int r = 0; r < ROWS; ++r) {
      const long long i = row0 + r;
      if (i < rows && j < m) dst[i * m + j] = t[r][lane];
    }
    __syncwarp();
  }
}

// Integral columns of `planes` (n, m) row-major planes, src to dst (src may
// equal dst): one thread per (plane, column) walks down the n rows with the
// carry in a register; the first element is the input itself, as in numpy.
template <typename T>
__global__ void __launch_bounds__(COL_THREADS)
col_pass(const T* src, T* dst, long long planes, int n, int m) {
  const long long idx = static_cast<long long>(blockIdx.x) * COL_THREADS + threadIdx.x;
  if (idx >= planes * m) return;
  const long long c = idx / m, j = idx % m;
  const long long off = c * static_cast<long long>(n) * m + j;
  const T* p = src + off;
  T* q = dst + off;
  T acc = p[0];
  q[0] = acc;
  int i = 1;
  for (; i + COL_UNROLL <= n; i += COL_UNROLL) {
    T v[COL_UNROLL];
#pragma unroll
    for (int u = 0; u < COL_UNROLL; ++u) v[u] = p[static_cast<long long>(i + u) * m];
#pragma unroll
    for (int u = 0; u < COL_UNROLL; ++u) {
      acc = add_rn(acc, v[u]);
      q[static_cast<long long>(i + u) * m] = acc;
    }
  }
  for (; i < n; ++i) {
    acc = add_rn(acc, p[static_cast<long long>(i) * m]);
    q[static_cast<long long>(i) * m] = acc;
  }
}

unsigned col_blocks(long long planes, int m) {
  return static_cast<unsigned>((planes * m + COL_THREADS - 1) / COL_THREADS);
}

template <typename T>
int launch_moments(const T* y, T* out, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_pass<T><<<(n + ROWS - 1) / ROWS, ROW_THREADS, 0, s>>>(y, out, n, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  col_pass<T><<<col_blocks(3, m), COL_THREADS, 0, s>>>(out, out, 3, n, m);
  return cudaGetLastError();
}

template <typename T>
int launch_stack(const T* stk, T* out, long long planes, int n, int m, bool cols_first,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rows = planes * n;
  const long long per_block = static_cast<long long>(STACK_WARPS) * ROWS;
  const unsigned row_blocks = static_cast<unsigned>((rows + per_block - 1) / per_block);
  if (cols_first) {
    col_pass<T><<<col_blocks(planes, m), COL_THREADS, 0, s>>>(stk, out, planes, n, m);
  } else {
    stack_row_pass<T><<<row_blocks, 32 * STACK_WARPS, 0, s>>>(stk, out, rows, m);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (cols_first) {
    stack_row_pass<T><<<row_blocks, 32 * STACK_WARPS, 0, s>>>(out, out, rows, m);
  } else {
    col_pass<T><<<col_blocks(planes, m), COL_THREADS, 0, s>>>(out, out, planes, n, m);
  }
  return cudaGetLastError();
}

// ------------------------------------------------------------- sat_delta

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

template <typename T>
constexpr int delta_rows_smem() {
  return static_cast<int>(sizeof(T)) * (DR_STAGES + 2 * 2) * DR_ROWS * (DR_TILE + vec_n<T>());
}

template <typename T>
constexpr int delta_cols_smem() {
  return static_cast<int>(sizeof(T)) * 2 * DC_STAGES * DC_ROWS * DC_STRIP;
}

// The y and y^2 inner rows of tail rows [DR_ROWS blockIdx.x, +DR_ROWS) into
// planes 1 and 2 of out (3, b, m).  Lane r < DR_ROWS scans row r's y chain,
// lane DR_ROWS + r its y^2 chain; the lanes above 2 DR_ROWS repeat them and
// store nothing.  Shared memory: the ring, DR_STAGES tiles of (DR_ROWS,
// DR_TILE + N) inputs, then two tiles of results, (2 DR_ROWS, DR_TILE + N);
// the pad of 16 bytes keeps rows 16-byte aligned and on distinct banks.
// Lane l moves columns l, l + 32, ... of a tile.
template <typename T>
__global__ void __launch_bounds__(32)
sat_delta_rows(const T* __restrict__ tail, T* __restrict__ out, int b, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef typename Vec16<T>::type V;
  constexpr int N = vec_n<T>();
  constexpr int CG = DR_TILE / 32;               // columns of a tile a lane moves
  constexpr int OUT_ROWS = 2 * DR_ROWS;          // results stored: y, then y^2
  constexpr int EVERY = 32 / OUT_ROWS;           // chain steps between two stores
  typedef T InTile[DR_ROWS][DR_TILE + N];
  typedef T OutTile[OUT_ROWS][DR_TILE + N];
  InTile* ring = reinterpret_cast<InTile*>(smem);
  OutTile* res = reinterpret_cast<OutTile*>(smem + sizeof(InTile) * DR_STAGES);
  const int lane = threadIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.x) * DR_ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(DR_ROWS), b - row0));
  const long long plane = static_cast<long long>(b) * m;
  const int ntiles = blocks_of(m, DR_TILE);
  const T* src[DR_ROWS];
  T* dst[OUT_ROWS];
#pragma unroll
  for (int r = 0; r < DR_ROWS; ++r) {
    const long long i = row0 + min(r, rows - 1);
    src[r] = tail + i * m + lane;
    dst[r] = out + plane + i * m + lane;
    dst[DR_ROWS + r] = out + 2 * plane + i * m + lane;
  }

  int loaded = 0;
  auto load = [&]() {
    InTile& x = ring[loaded % DR_STAGES];
    const long long c0 = static_cast<long long>(loaded) * DR_TILE + lane;
#pragma unroll
    for (int r = 0; r < DR_ROWS; ++r) {
#pragma unroll
      for (int h = 0; h < CG; ++h) {
        const bool ok = c0 + 32 * h < m && r < rows;
        cp_async_elem(&x[r][lane + 32 * h], ok ? src[r] + 32 * h : tail, ok);
      }
      src[r] += DR_TILE;
    }
    ++loaded;
  };
  // tile t's results from o, the columns below m, then on to tile t + 1
  auto store_tile = [&](const OutTile& o, int t) {
    const long long c0 = static_cast<long long>(t) * DR_TILE + lane;
#pragma unroll
    for (int k = 0; k < OUT_ROWS; ++k) {
#pragma unroll
      for (int h = 0; h < CG; ++h)
        if (k % DR_ROWS < rows && c0 + 32 * h < m) dst[k][32 * h] = o[k][lane + 32 * h];
      dst[k] += DR_TILE;
    }
  };

  for (int t = 0; t < DR_STAGES - 1; ++t) {
    if (t < ntiles) load();
    cp_async_commit();
  }
  const int r = lane % DR_ROWS;
  const bool sq = (lane / DR_ROWS) % 2 == 1;
  const bool keep = lane < OUT_ROWS;  // a lane whose chain is stored
  // -0 + x == x for every x, so the first add yields the first element
  // itself, where numpy's scan starts
  T acc = T(-0.0);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<DR_STAGES - 2>();
    __syncwarp();
    if (loaded < ntiles) load();
    cp_async_commit();
    const InTile& x = ring[t % DR_STAGES];
    const OutTile& prev = res[(t + 1) & 1];
    T* o = res[t & 1][keep ? lane : 0];
    if (static_cast<long long>(t) * DR_TILE + DR_TILE <= m) {
      // tile t - 1 is full (none at t = 0): one of its values is stored
      // every EVERY steps of the chain
      alignas(16) T v[DR_TILE];
      alignas(16) T w[DR_TILE];
      T d[OUT_ROWS * CG];
#pragma unroll
      for (int jj = 0; jj < DR_TILE; jj += N)
        *reinterpret_cast<V*>(&v[jj]) = *reinterpret_cast<const V*>(&x[r][jj]);
#pragma unroll
      for (int k = 0; k < OUT_ROWS; ++k)
#pragma unroll
        for (int h = 0; h < CG; ++h) d[k * CG + h] = prev[k][lane + 32 * h];
#pragma unroll
      for (int jj = 0; jj < DR_TILE; ++jj) {
        T u = v[jj];
        if (sq) u = mul_rn(u, u);
        acc = add_rn(acc, u);
        w[jj] = acc;
        if (jj % N == N - 1 && keep)
          *reinterpret_cast<V*>(&o[jj + 1 - N]) = *reinterpret_cast<const V*>(&w[jj + 1 - N]);
        if (jj % EVERY == 0) {
          const int k = jj / EVERY / CG, h = jj / EVERY % CG;
          if (t > 0 && k % DR_ROWS < rows) dst[k][32 * h] = d[k * CG + h];
          if (t > 0 && h == CG - 1) dst[k] += DR_TILE;
        }
      }
    } else {
      if (t > 0) store_tile(prev, t - 1);
      const int width = static_cast<int>(m - static_cast<long long>(t) * DR_TILE);
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

// Output rows of the tail (3, b, m) in place: warp p walks plane p of
// columns [32 blockIdx.x, +32) down the b rows, seeded from carry[p]; plane
// 0 adds its ones' prefix, planes 1 and 2 their inner rows (sat_delta_rows'
// output), each through its own DC_STAGES-deep ring of (DC_ROWS, DC_STRIP).
template <typename T>
__global__ void __launch_bounds__(3 * 32)
sat_delta_cols(const T* __restrict__ carry, T* out, int b, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  typedef T Stage[DC_ROWS][DC_STRIP];
  const int lane = threadIdx.x & 31;
  const int p = threadIdx.x >> 5;
  const long long j = static_cast<long long>(blockIdx.x) * DC_STRIP + lane;
  const bool col_ok = j < m;
  const long long mm = m;
  T* q = out + p * static_cast<long long>(b) * m + j;  // row 0 of the column
  T acc = col_ok ? carry[p * mm + j] : T(0);
  if (p == 0) {
    if (!col_ok) return;
    const T x = ones_prefix(T(0), j);
#pragma unroll 16
    for (int i = 0; i < b; ++i) {
      acc = add_rn(acc, x);
      *q = acc;
      q += mm;
    }
    return;
  }
  Stage* ring = reinterpret_cast<Stage*>(smem) + (p - 1) * DC_STAGES;
  const int nstages = blocks_of(b, DC_ROWS);
  const T* next = q;  // the next row to load
  int loaded = 0;
  auto load = [&]() {
    Stage& st = ring[loaded % DC_STAGES];
    const int left = b - loaded * DC_ROWS;
#pragma unroll
    for (int r = 0; r < DC_ROWS; ++r) {
      const bool ok = col_ok && r < left;
      cp_async_elem(&st[r][lane], ok ? next : out, ok);
      next += mm;
    }
    ++loaded;
  };
  for (int s = 0; s < DC_STAGES - 1; ++s) {
    if (s < nstages) load();
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<DC_STAGES - 2>();
    __syncwarp();
    if (loaded < nstages) load();
    cp_async_commit();
    const Stage& st = ring[s % DC_STAGES];
    T v[DC_ROWS];
#pragma unroll
    for (int r = 0; r < DC_ROWS; ++r) v[r] = st[r][lane];
    const int left = b - s * DC_ROWS;
#pragma unroll
    for (int r = 0; r < DC_ROWS; ++r) {
      acc = add_rn(acc, v[r]);
      if (col_ok && r < left) *q = acc;
      q += mm;
    }
  }
}

template <typename T>
int launch_delta(const T* carry, const T* tail, T* out, int b, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(sat_delta_rows<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       delta_rows_smem<T>());
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(sat_delta_cols<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           delta_cols_smem<T>());
  if (e != cudaSuccess) return e;
  sat_delta_rows<T><<<blocks_of(b, DR_ROWS), 32, delta_rows_smem<T>(), s>>>(tail, out, b, m);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  sat_delta_cols<T><<<blocks_of(m, DC_STRIP), 3 * 32, delta_cols_smem<T>(), s>>>(
      carry, out, b, m);
  return cudaGetLastError();
}

}  // namespace

// y (n, m) row-major; out (3, n, m) row-major; n, m >= 1.
extern "C" int sat_moments_f64(const double* y, double* out, int n, int m, void* stream) {
  return launch_moments<double>(y, out, n, m, stream);
}

extern "C" int sat_moments_f32(const float* y, float* out, int n, int m, void* stream) {
  return launch_moments<float>(y, out, n, m, stream);
}

// carry (3, m), tail (b, m), out (3, b, m), all row-major and distinct; b, m >= 1.
extern "C" int sat_delta_f64(const double* carry, const double* tail, double* out, int b, int m,
                             void* stream) {
  return launch_delta<double>(carry, tail, out, b, m, stream);
}

extern "C" int sat_delta_f32(const float* carry, const float* tail, float* out, int b, int m,
                             void* stream) {
  return launch_delta<float>(carry, tail, out, b, m, stream);
}

// The sat_delta launch at a (b, m) tail: sat_delta_rows' CTAs, its ring
// depth in tiles and a tile's columns; sat_delta_cols' CTAs, its ring depth
// in stages and a stage's rows.
extern "C" void sat_delta_shape(int b, int m, int* shape) {
  shape[0] = blocks_of(b, DR_ROWS);
  shape[1] = DR_STAGES;
  shape[2] = DR_TILE;
  shape[3] = blocks_of(m, DC_STRIP);
  shape[4] = DC_STAGES;
  shape[5] = DC_ROWS;
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
