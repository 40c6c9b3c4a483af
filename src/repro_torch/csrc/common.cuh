// Shared by every kernel library: a plain C interface, loaded with ctypes.
// Each exported launcher returns cudaGetLastError() after its launches, and
// the Python side turns a non-zero code into an exception through
// kernel_error_string.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Additions and products rounded once each, never contracted into an FMA:
// the float64 scans must reproduce numpy's y*y followed by an add bitwise.
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
