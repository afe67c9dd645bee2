// Fused Riccati backward pass + KA line-search forward rollouts.
//
// Replaces the Pallas TPU kernel cilqr_tpu/pallas/sweep.py::riccati_sweep
// (_sweep_kernel). Semantics, order of operations and the floor-form angle
// wrap follow that kernel (sweep.py:88-165); the plain PyTorch version is
// cilqr_tpu_torch/kernels/sweep.py::riccati_sweep_ref.
//
// Design: one thread per batch lane. The lane's value-function carry
// (Vx [6], Vxx [6x6]) and all of one step's 6x6 / 2x2 algebra live in
// registers (and, in double, partly in the local-memory spill that backs
// them in L1). The gains K [2x6] and k [2] of every step go to a scratch
// buffer the wrapper allocates in device memory, [T,2,6,B] and [T,2,B]:
// at 128 lanes that is ~573 KB in float, more than the 227 KB of shared
// memory a block can have; at B=1024 ~4.6 MB, which stays resident in the
// 50 MB L2. Every global tensor is batch-last, so the 32 threads of a warp
// read and write 32 consecutive addresses.
//
// What bounds it: the latency of the serial chain, 80 backward steps then
// KA x 80 forward steps, each depending on the last — not bytes (a trip
// reads ~1.1 KB per lane per step) and not FLOPs. At B=1024 the grid is
// only 8 blocks of 128 threads on the H100's 132 SMs, so most of the card
// idles; splitting one lane's 6x6 algebra over several threads (or running
// the KA rollouts on separate threads) is the lever for a later change.

#include "common.cuh"

namespace cilqr {
namespace {

template <typename T>
struct SweepArgs {
  int T_, B, KA;
  T dt, half_dt, L;
  const T *lam, *alpha, *A, *Bm, *Jx, *Ju, *Hx, *Hu, *xs, *us;
  T *nxs, *nus, *Ks, *ks, *dv0, *dv1, *gnorm;
};

// continuous-time bicycle ODE with the kernel's floor-form wraps
template <typename T>
__device__ __forceinline__ void f_cont(const T s[6], T u0, T u1, T L, T out[6]) {
  const T th = wrap_angle(s[2]);
  const T dl = wrap_angle(s[5]);
  out[0] = s[3] * cos(th);
  out[1] = s[3] * sin(th);
  out[2] = s[3] * tan(dl) / L;
  out[3] = s[4];
  out[4] = u0;
  out[5] = u1;
}

template <typename T>
__global__ void __launch_bounds__(kBlock) sweep_kernel(const SweepArgs<T> p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;  // ragged last block
  const int Tn = p.T_;
  const size_t B = p.B;
  // element (i0, i1, ...) of a batch-last tensor with lane b
#define AT(ptr, flat) (ptr)[(size_t)(flat) * B + b]

  const T lam = p.lam[b];
  T Vx[6], Vxx[6][6];
  for (int i = 0; i < 6; ++i) {
    Vx[i] = AT(p.Jx, Tn * 6 + i);
    for (int j = 0; j < 6; ++j) Vxx[i][j] = AT(p.Hx, (Tn * 6 + i) * 6 + j);
  }
  T dV0 = T(0), dV1 = T(0), gacc = T(0);

  // ---- backward Riccati (ilqr_optimizer.cc:334-390)
  for (int step = 0; step < Tn; ++step) {
    const int t = Tn - 1 - step;
    T A[6][6], Bm[6][2];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) A[i][j] = AT(p.A, (t * 6 + i) * 6 + j);
#pragma unroll
      for (int j = 0; j < 2; ++j) Bm[i][j] = AT(p.Bm, (t * 6 + i) * 2 + j);
    }
    // Qx = Jx + A^T Vx ; Qu = Ju + B^T Vx
    T Qx[6], Qu[2];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T acc = A[0][i] * Vx[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + A[k][i] * Vx[k];
      Qx[i] = AT(p.Jx, t * 6 + i) + acc;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T acc = Bm[0][i] * Vx[0];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + Bm[k][i] * Vx[k];
      Qu[i] = AT(p.Ju, t * 2 + i) + acc;
    }
    // BtV = B^T Vxx [2x6]; Quu = Hu + BtV B; Qux = BtV A
    T BtV[2][6];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T acc = Bm[0][i] * Vxx[0][j];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + Bm[k][i] * Vxx[k][j];
        BtV[i][j] = acc;
      }
    T Quu[2][2], Qux[2][6];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        T acc = BtV[i][0] * Bm[0][j];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + BtV[i][k] * Bm[k][j];
        Quu[i][j] = AT(p.Hu, (t * 2 + i) * 2 + j) + acc;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T acc = BtV[i][0] * A[0][j];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + BtV[i][k] * A[k][j];
        Qux[i][j] = acc;
      }
    }
    // Qxx = Hx + (A^T Vxx) A, with A^T Vxx formed row by row
    T Qxx[6][6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T AtV[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T acc = A[0][i] * Vxx[0][j];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + A[k][i] * Vxx[k][j];
        AtV[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        T acc = AtV[0] * A[0][j];
#pragma unroll
        for (int k = 1; k < 6; ++k) acc = acc + AtV[k] * A[k][j];
        Qxx[i][j] = AT(p.Hx, (t * 6 + i) * 6 + j) + acc;
      }
    }
    // closed-form inverse of Quu + lam I
    const T ma = Quu[0][0] + lam, mb = Quu[0][1];
    const T mc = Quu[1][0], md = Quu[1][1] + lam;
    const T inv_det = T(1) / (ma * md - mb * mc);
    const T Qi[2][2] = {{md * inv_det, -mb * inv_det},
                        {-mc * inv_det, ma * inv_det}};
    T K[2][6], k[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        K[i][j] = -(Qi[i][0] * Qux[0][j] + Qi[i][1] * Qux[1][j]);
        AT(p.Ks, (t * 2 + i) * 6 + j) = K[i][j];
      }
      k[i] = -(Qi[i][0] * Qu[0] + Qi[i][1] * Qu[1]);
      AT(p.ks, t * 2 + i) = k[i];
    }
    T Quk[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) Quk[i] = Quu[i][0] * k[0] + Quu[i][1] * k[1];
    // Vx = Qx + K^T Quk + K^T Qu + Qux^T k
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const T t1 = K[0][i] * Quk[0] + K[1][i] * Quk[1];
      const T t2 = K[0][i] * Qu[0] + K[1][i] * Qu[1];
      const T t3 = Qux[0][i] * k[0] + Qux[1][i] * k[1];
      Vx[i] = Qx[i] + t1 + t2 + t3;
    }
    // Vxx = Qxx + K^T (Quu K) + K^T Qux + Qux^T K, then symmetrized
    T QuuK[2][6];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        QuuK[i][j] = Quu[i][0] * K[0][j] + Quu[i][1] * K[1][j];
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const T t1 = K[0][i] * QuuK[0][j] + K[1][i] * QuuK[1][j];
        const T t2 = K[0][i] * Qux[0][j] + K[1][i] * Qux[1][j];
        const T t3 = Qux[0][i] * K[0][j] + Qux[1][i] * K[1][j];
        Qxx[i][j] = Qxx[i][j] + t1 + t2 + t3;
      }
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        Vxx[i][j] = T(0.5) * (Qxx[i][j] + Qxx[j][i]);
    dV0 = dV0 + (k[0] * Qu[0] + k[1] * Qu[1]);
    dV1 = dV1 + T(0.5) * (k[0] * Quk[0] + k[1] * Quk[1]);
    // gnorm accumulator: max over the control dim of |k| / (|u| + 1)
    const T g0 = fabs(k[0]) / (fabs(AT(p.us, t * 2 + 0)) + T(1));
    const T g1 = fabs(k[1]) / (fabs(AT(p.us, t * 2 + 1)) + T(1));
    gacc = gacc + (g0 > g1 ? g0 : g1);
  }
  p.dv0[b] = dV0;
  p.dv1[b] = dV1;
  p.gnorm[b] = gacc / T(Tn);

  // ---- forward rollouts (ilqr_optimizer.cc:392-415), one per alpha, all
  // reusing the gains of the backward pass above
  const size_t nxs_stride = (size_t)(Tn + 1) * 6 * B;
  const size_t nus_stride = (size_t)Tn * 2 * B;
  for (int a = 0; a < p.KA; ++a) {
    const T alpha = AT(p.alpha, a);
    T* nxs = p.nxs + a * nxs_stride;
    T* nus = p.nus + a * nus_stride;
    T x[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      x[i] = AT(p.xs, i);  // the rollout starts at xs[0] (== goals[0])
      AT(nxs, i) = x[i];
    }
    for (int t = 0; t < Tn; ++t) {
      T dx[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) dx[i] = x[i] - AT(p.xs, t * 6 + i);
      T u[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        T acc = AT(p.Ks, (t * 2 + i) * 6 + 0) * dx[0];
#pragma unroll
        for (int j = 1; j < 6; ++j) acc = acc + AT(p.Ks, (t * 2 + i) * 6 + j) * dx[j];
        u[i] = AT(p.us, t * 2 + i) + acc + alpha * AT(p.ks, t * 2 + i);
      }
      u[1] = wrap_angle(u[1]);
      T f[6], mid[6];
      f_cont(x, u[0], u[1], p.L, f);
#pragma unroll
      for (int i = 0; i < 6; ++i) mid[i] = x[i] + p.half_dt * f[i];
      f_cont(mid, u[0], u[1], p.L, f);
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = x[i] + p.dt * f[i];
      x[2] = wrap_angle(x[2]);
      x[5] = wrap_angle(x[5]);
      AT(nus, t * 2 + 0) = u[0];
      AT(nus, t * 2 + 1) = u[1];
#pragma unroll
      for (int i = 0; i < 6; ++i) AT(nxs, (t + 1) * 6 + i) = x[i];
    }
  }
#undef AT
}

template <typename T>
int launch(int T_, int B, int KA, double dt, double L, const void* lam,
           const void* alpha, const void* A, const void* Bm, const void* Jx,
           const void* Ju, const void* Hx, const void* Hu, const void* xs,
           const void* us, void* nxs, void* nus, void* Ks, void* ks,
           void* dv0, void* dv1, void* gnorm, void* stream) {
  SweepArgs<T> p;
  p.T_ = T_;
  p.B = B;
  p.KA = KA;
  p.dt = T(dt);
  p.half_dt = T(0.5 * dt);
  p.L = T(L);
  p.lam = static_cast<const T*>(lam);
  p.alpha = static_cast<const T*>(alpha);
  p.A = static_cast<const T*>(A);
  p.Bm = static_cast<const T*>(Bm);
  p.Jx = static_cast<const T*>(Jx);
  p.Ju = static_cast<const T*>(Ju);
  p.Hx = static_cast<const T*>(Hx);
  p.Hu = static_cast<const T*>(Hu);
  p.xs = static_cast<const T*>(xs);
  p.us = static_cast<const T*>(us);
  p.nxs = static_cast<T*>(nxs);
  p.nus = static_cast<T*>(nus);
  p.Ks = static_cast<T*>(Ks);
  p.ks = static_cast<T*>(ks);
  p.dv0 = static_cast<T*>(dv0);
  p.dv1 = static_cast<T*>(dv1);
  p.gnorm = static_cast<T*>(gnorm);
  const dim3 grid((B + kBlock - 1) / kBlock);
  sweep_kernel<T><<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cilqr

extern "C" {

int riccati_sweep_f32(int T_, int B, int KA, double dt, double L,
                      const void* lam, const void* alpha, const void* A,
                      const void* Bm, const void* Jx, const void* Ju,
                      const void* Hx, const void* Hu, const void* xs,
                      const void* us, void* nxs, void* nus, void* Ks,
                      void* ks, void* dv0, void* dv1, void* gnorm,
                      void* stream) {
  return cilqr::launch<float>(T_, B, KA, dt, L, lam, alpha, A, Bm, Jx, Ju,
                              Hx, Hu, xs, us, nxs, nus, Ks, ks, dv0, dv1,
                              gnorm, stream);
}

int riccati_sweep_f64(int T_, int B, int KA, double dt, double L,
                      const void* lam, const void* alpha, const void* A,
                      const void* Bm, const void* Jx, const void* Ju,
                      const void* Hx, const void* Hu, const void* xs,
                      const void* us, void* nxs, void* nus, void* Ks,
                      void* ks, void* dv0, void* dv1, void* gnorm,
                      void* stream) {
  return cilqr::launch<double>(T_, B, KA, dt, L, lam, alpha, A, Bm, Jx, Ju,
                               Hx, Hu, xs, us, nxs, nus, Ks, ks, dv0, dv1,
                               gnorm, stream);
}

// Text of a cudaError_t, for the Python wrappers' exceptions.
const char* cilqr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
