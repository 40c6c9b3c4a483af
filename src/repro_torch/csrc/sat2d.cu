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
//   sat_delta    the numpy delta_sat oracle: the same row pass over the b
//                tail rows, then a column pass seeded from the carry row, so
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
// Bound.  The two passes move the input once and the output three times
// (written by the first pass, read and rewritten in place by the second):
// at 4096 x 4096 in float64, 1.34 GB for sat_moments against the 0.54 GB
// (read y, write the images once) of the least time on the card; sat_delta
// moves the same per tail row, sat_stack 4 against 2 bytes per element.  All
// are bytes-bound.  The design buys coalescing, not fewer bytes: a row pass
// stages (ROWS, TILE) tiles through shared memory so that global loads and
// stores run along rows, and the column pass is coalesced by construction
// (neighbouring threads own neighbouring columns) and keeps COL_UNROLL loads
// in flight per thread because its adds form one dependent chain per column.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;         // rows per block: one lane of each warp
constexpr int TILE = 32;         // columns per shared-memory tile
constexpr int ROW_THREADS = 96;  // three warps, warp c scans channel c
constexpr int COL_THREADS = 64;
constexpr int COL_UNROLL = 32;
constexpr int STACK_WARPS = 4;   // warps per stack_row_pass block, 32 rows each

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
// carry in a register.  Unseeded (init == nullptr) the first element is the
// input itself, as in numpy; seeded, the walk starts from init[plane * m +
// column] and every output row is an add.
template <typename T>
__global__ void __launch_bounds__(COL_THREADS)
col_pass(const T* src, T* dst, const T* __restrict__ init, long long planes, int n, int m) {
  const long long idx = static_cast<long long>(blockIdx.x) * COL_THREADS + threadIdx.x;
  if (idx >= planes * m) return;
  const long long c = idx / m, j = idx % m;
  const long long off = c * static_cast<long long>(n) * m + j;
  const T* p = src + off;
  T* q = dst + off;
  T acc;
  int i;
  if (init != nullptr) {
    acc = init[idx];
    i = 0;
  } else {
    acc = p[0];
    q[0] = acc;
    i = 1;
  }
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

// sat_moments (carry == nullptr) and sat_delta (carry (3, m)): the moment
// row pass over the n rows of y, then the column pass, seeded or not.
template <typename T>
int launch_moments(const T* y, const T* carry, T* out, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_pass<T><<<(n + ROWS - 1) / ROWS, ROW_THREADS, 0, s>>>(y, out, n, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  col_pass<T><<<col_blocks(3, m), COL_THREADS, 0, s>>>(out, out, carry, 3, n, m);
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
    col_pass<T><<<col_blocks(planes, m), COL_THREADS, 0, s>>>(stk, out, nullptr, planes, n, m);
  } else {
    stack_row_pass<T><<<row_blocks, 32 * STACK_WARPS, 0, s>>>(stk, out, rows, m);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  if (cols_first) {
    stack_row_pass<T><<<row_blocks, 32 * STACK_WARPS, 0, s>>>(out, out, rows, m);
  } else {
    col_pass<T><<<col_blocks(planes, m), COL_THREADS, 0, s>>>(out, out, nullptr, planes, n, m);
  }
  return cudaGetLastError();
}

}  // namespace

// y (n, m) row-major; out (3, n, m) row-major; n, m >= 1.
extern "C" int sat_moments_f64(const double* y, double* out, int n, int m, void* stream) {
  return launch_moments<double>(y, nullptr, out, n, m, stream);
}

extern "C" int sat_moments_f32(const float* y, float* out, int n, int m, void* stream) {
  return launch_moments<float>(y, nullptr, out, n, m, stream);
}

// carry (3, m), tail (b, m), out (3, b, m), all row-major; b, m >= 1.
extern "C" int sat_delta_f64(const double* carry, const double* tail, double* out, int b, int m,
                             void* stream) {
  return launch_moments<double>(tail, carry, out, b, m, stream);
}

extern "C" int sat_delta_f32(const float* carry, const float* tail, float* out, int b, int m,
                             void* stream) {
  return launch_moments<float>(tail, carry, out, b, m, stream);
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
