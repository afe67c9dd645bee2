// Helpers shared by the solver's CUDA kernels (sweep.cu, coststack.cu,
// megasolve.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

// Phase clocks for tools/profile_blast_kernels.py: compiled with
// -DCILQR_PROFILE, CILQR_CLK(...) keeps its code (clock64() reads summed in
// registers, stored by thread 0 of the first CTA at the kernel's end);
// compiled without, as the library is, it is empty.
#ifdef CILQR_PROFILE
#define CILQR_CLK(...) __VA_ARGS__
#else
#define CILQR_CLK(...)
#endif

namespace cilqr {

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

// A value whose arithmetic is rounded after every operation: written as
// ordinary expressions, each operator is one separately rounded operation,
// evaluated left to right as PyTorch evaluates the same expression.
template <typename T>
struct Rn {
  T v;
  __device__ __forceinline__ Rn() {}
  __device__ __forceinline__ Rn(T x) : v(x) {}
};

template <typename T>
__device__ __forceinline__ Rn<T> operator+(Rn<T> a, Rn<T> b) { return add_rn(a.v, b.v); }
template <typename T>
__device__ __forceinline__ Rn<T> operator-(Rn<T> a, Rn<T> b) { return sub_rn(a.v, b.v); }
template <typename T>
__device__ __forceinline__ Rn<T> operator*(Rn<T> a, Rn<T> b) { return mul_rn(a.v, b.v); }
template <typename T>
__device__ __forceinline__ Rn<T> operator/(Rn<T> a, Rn<T> b) { return div_rn(a.v, b.v); }
template <typename T>
__device__ __forceinline__ Rn<T> operator-(Rn<T> a) { return Rn<T>(-a.v); }
template <typename T>
__device__ __forceinline__ bool operator<(Rn<T> a, Rn<T> b) { return a.v < b.v; }
template <typename T>
__device__ __forceinline__ bool operator>(Rn<T> a, Rn<T> b) { return a.v > b.v; }

template <typename T>
__device__ __forceinline__ Rn<T> r_min(Rn<T> a, Rn<T> b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ Rn<T> r_max(Rn<T> a, Rn<T> b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ Rn<T> r_abs(Rn<T> a) { return Rn<T>(fabs(a.v)); }
template <typename T>
__device__ __forceinline__ Rn<T> r_sqrt(Rn<T> a) { return Rn<T>(sqrt_rn(a.v)); }
template <typename T>
__device__ __forceinline__ Rn<T> r_floor(Rn<T> a) { return Rn<T>(floor(a.v)); }
template <typename T>
__device__ __forceinline__ Rn<T> r_cos(Rn<T> a) { return Rn<T>(cos(a.v)); }
template <typename T>
__device__ __forceinline__ Rn<T> r_sin(Rn<T> a) { return Rn<T>(sin(a.v)); }
template <typename T>
__device__ __forceinline__ Rn<T> r_tan(Rn<T> a) { return Rn<T>(tan(a.v)); }
template <typename T>
__device__ __forceinline__ Rn<T> r_log(Rn<T> a) { return Rn<T>(log(a.v)); }

// Angle wrap in floor form, x - 2pi floor((x + pi) / 2pi), the division
// taken as a multiplication by 1/(2pi): PyTorch on the card divides a
// tensor by a Python scalar that way, so the plain versions
// (kernels/megasolve.py: _wrap) can only match a kernel that does too. The
// constants are the Python doubles pi, 1/(2pi) and 2pi rounded to T.
template <typename T>
__device__ __forceinline__ Rn<T> wrap(Rn<T> x, Rn<T> pi, Rn<T> inv_two_pi,
                                      Rn<T> two_pi) {
  return x - r_floor((x + pi) * inv_two_pi) * two_pi;
}

}  // namespace cilqr
