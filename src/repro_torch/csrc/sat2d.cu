// sat_moments: the (3, n, m) inclusive integral images of (1, y, y^2).
//
// Replaces src/repro/kernels/sat2d/kernel.py::scan_rows (body
// _row_scan_kernel, init=None), which sat2d/ops.py::sat_moments runs twice:
// over the rows of the (1, y, y^2) stack, then over its transpose.
//
// Order.  The float64 variant equals numpy bitwise (np.cumsum(np.cumsum(stk,
// axis=2), axis=1)): each row is scanned left to right by one thread, then
// each column top to bottom by one thread, every add and the product y*y
// rounded on its own (add_rn/mul_rn, and the build passes -fmad=false).
// The float32 variant runs the same code in float32, the TPU kernel's type.
//
// Carry.  The Pallas kernel carries a row's running sum from one column tile
// to the next in VMEM, which is valid only because a TPU grid runs its steps
// in order.  CUDA blocks run in no order, so nothing passes between blocks
// here: a block owns ROWS whole rows and walks their column tiles in a loop,
// keeping each row's carry in a register.
//
// Bound.  The two passes move y once and the (3, n, m) images three times
// (written by the row pass, read and rewritten in place by the column pass):
// at 4096 x 4096 in float64, 1.34 GB, against the 0.54 GB (read y, write
// the images once) of the least time on the card; both are bytes-bound.  The
// design buys coalescing, not fewer bytes: the row pass stages (ROWS, TILE)
// tiles through shared memory so that global loads and stores run along
// rows, and the column pass is coalesced by construction (neighbouring
// threads own neighbouring columns) and keeps COL_UNROLL loads in flight per
// thread because its adds form one dependent chain per column.
#include "common.cuh"

namespace {

constexpr int ROWS = 32;         // rows per block: one lane of each warp
constexpr int TILE = 32;         // columns per shared-memory tile
constexpr int ROW_THREADS = 96;  // three warps, warp c scans channel c
constexpr int COL_THREADS = 64;
constexpr int COL_UNROLL = 32;

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

template <typename T>
__global__ void __launch_bounds__(COL_THREADS)
col_pass(T* __restrict__ out, int n, int m) {
  const long long idx = static_cast<long long>(blockIdx.x) * COL_THREADS + threadIdx.x;
  if (idx >= 3LL * m) return;
  const long long c = idx / m, j = idx % m;
  T* p = out + c * static_cast<long long>(n) * m + j;
  T acc = p[0];
  int i = 1;
  for (; i + COL_UNROLL <= n; i += COL_UNROLL) {
    T v[COL_UNROLL];
#pragma unroll
    for (int u = 0; u < COL_UNROLL; ++u) v[u] = p[static_cast<long long>(i + u) * m];
#pragma unroll
    for (int u = 0; u < COL_UNROLL; ++u) {
      acc = add_rn(acc, v[u]);
      p[static_cast<long long>(i + u) * m] = acc;
    }
  }
  for (; i < n; ++i) {
    acc = add_rn(acc, p[static_cast<long long>(i) * m]);
    p[static_cast<long long>(i) * m] = acc;
  }
}

template <typename T>
int launch(const T* y, T* out, int n, int m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  row_pass<T><<<(n + ROWS - 1) / ROWS, ROW_THREADS, 0, s>>>(y, out, n, m);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long cols = 3LL * m;
  col_pass<T><<<static_cast<unsigned>((cols + COL_THREADS - 1) / COL_THREADS), COL_THREADS, 0, s>>>(
      out, n, m);
  return cudaGetLastError();
}

}  // namespace

// y (n, m) row-major; out (3, n, m) row-major; n, m >= 1.
extern "C" int sat_moments_f64(const double* y, double* out, int n, int m, void* stream) {
  return launch<double>(y, out, n, m, stream);
}

extern "C" int sat_moments_f32(const float* y, float* out, int n, int m, void* stream) {
  return launch<float>(y, out, n, m, stream);
}
