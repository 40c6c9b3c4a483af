// Shared by every kernel library: a plain C interface, loaded with ctypes.
// Each exported launcher returns cudaGetLastError() after its launches, and
// the Python side turns a non-zero code into an exception through
// kernel_error_string.
#pragma once
#include <cuda_runtime.h>
#include <stdio.h>

// Failures that are not a cudaError_t (a driver entry point not found, a
// CUresult of the driver API) come back as negative codes, which no
// cudaError_t takes.
constexpr int KERNEL_ERR_NO_ENTRY_POINT = -1;
constexpr int KERNEL_ERR_TENSOR_MAP = -1000;   // minus the CUresult

inline int tensor_map_error(int curesult) { return KERNEL_ERR_TENSOR_MAP - curesult; }

extern "C" const char* kernel_error_string(int code) {
  if (code >= 0) return cudaGetErrorString(static_cast<cudaError_t>(code));
  if (code == KERNEL_ERR_NO_ENTRY_POINT)
    return "cuTensorMapEncodeTiled was not found through cudaGetDriverEntryPoint";
  static thread_local char msg[80];
  snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the tensor map: CUresult %d",
           KERNEL_ERR_TENSOR_MAP - code);
  return msg;
}

// Additions and products rounded once each, never contracted into an FMA:
// the float64 scans must reproduce numpy's y*y followed by an add bitwise.
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
