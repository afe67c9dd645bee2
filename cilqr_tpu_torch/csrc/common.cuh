// Helpers shared by the solver's CUDA kernels (sweep.cu, coststack.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace cilqr {

constexpr int kBlock = 128;  // threads per block, one lane (or knot-lane) each

// Angle wrap in the Pallas sweep kernel's floor form
// x - 2pi*floor((x + pi) / 2pi) (cilqr_tpu/pallas/sweep.py:_normalize_angle).
// The constants are rounded to T first, as JAX rounds its weak-typed ones.
template <typename T>
__device__ __forceinline__ T wrap_angle(T x) {
  const T pi = T(3.14159265358979323846);
  const T two_pi = T(6.28318530717958647692);
  return x - two_pi * floor((x + pi) / two_pi);
}

// Arithmetic that the compiler may not contract into an FMA, so that a
// result equals, bit for bit, the same sequence of separately rounded
// PyTorch operations.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }

template <typename T>
__device__ __forceinline__ T infinity();
template <>
__device__ __forceinline__ float infinity<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double infinity<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

}  // namespace cilqr
