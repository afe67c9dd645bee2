// Fused Riccati backward pass + KA line-search forward rollouts.
//
// Replaces the Pallas TPU kernel cilqr_tpu/pallas/sweep.py::riccati_sweep
// (_sweep_kernel :75, wrapper :169). What it computes follows that kernel
// (ilqr_optimizer.cc:334-415): a Levenberg-regularized Riccati backward
// pass with the closed-form 2x2 gain solve, the symmetrized Vxx, dV0, dV1
// and gnorm (the mean over t of max over u of |k| / (|u| + 1), against the
// current us); then KA closed-loop RK2 rollouts from xs[0], one per alpha
// row, all reusing the gains. The plain PyTorch version is
// cilqr_tpu_torch/kernels/sweep.py::riccati_sweep_ref, the megakernel's
// plain Riccati pass and rollout step.
//
// Exactness: the kernel is bit-identical to its plain version. Every
// operation is one of common.cuh's separately rounded Rn<T> operations (no
// FMA contraction), in the plain version's order: each product entry sums
// over k in _mm/_mv's order, one thread per entry; Vxx = 0.5 (V + V^T) is
// formed as there (V[i][j] + V[j][i] is exact under exchange, so one thread
// writes both entries); the closed-form inverse takes a correctly rounded
// division; gnorm's division by T is a multiplication by 1/T formed in
// double, and the angle wrap is common.cuh's multiplying floor form, as
// PyTorch on the card divides by a Python scalar; dV0, dV1 and gnorm are
// summed over t in the plain loop's order by one thread each; the
// transcendentals are the accurate ones PyTorch calls (sin and cos of one
// angle from one sincos call, which returns what sin and cos return).
//
// What bounds it: the latency of its serial chains, not bytes or
// operations. A call reads ~45 MB at B=1024 in float (~0.013 ms at the
// card's memory rate) and needs ~0.2 G operations (~0.003 ms), but each
// lane runs 80 Riccati steps that each depend on the last, then rollouts of
// 80 dependent steps.
//
// Design, against that latency:
// - A warp per lane, several lanes per CTA (enough CTAs to cover the SMs:
//   at B=1024 128 CTAs of 8 lanes; at B=128 128 CTAs of one). The warp
//   splits each Riccati step into three phases of independent entries, one
//   entry per thread, with its k-loop in the plain order, exchanged through
//   shared memory with a __syncwarp between phases (shuffles would need
//   each value in the thread that forms the next phase's entries; a phase
//   reads up to 14 values that 14 different threads formed). Phase 1:
//   A^T Vxx, B^T Vxx, Qx, Qu (56 entries, two a thread, computed before
//   either is stored so that their chains overlap); phase 2: Qxx, Qux, Quu
//   (52); phase 3: every thread forms the inverse of Quu + lam I, then the
//   gain columns it needs and one Vxx pair or one Vx entry (27). Qx and Qu
//   sit in a seventh column of Qxx and Qux, so that Vx[i] is phase 3's
//   formula for column 6 (K's seventh column is k): every thread runs the
//   same code and makes the same three stores (idle ones to a spare slot),
//   and the warp does not diverge.
// - The rollouts run at once, one a thread: after the backward pass (a
//   barrier), the CTA's lanes x KA alphas are packed into the fewest warps
//   (at 8 lanes a CTA and KA = 4, one warp), so that the other warps leave
//   the SM's issue slots to them.
// - The gains of all steps stay in shared memory (14 values a step), as do
//   xs and us, which the rollouts read: nothing goes to a scratch buffer.
// - Each step's inputs (A, Bm, Hx, Jx, Ju, Hu: 96 values a lane) are staged
//   ahead of the chain with cp.async into a double-buffered ring of chunks
//   of steps; while the lanes of a CTA run one chunk, the next is in
//   flight, and one __syncthreads at each chunk boundary hands it over. The
//   ring keeps the CTA's lanes side by side, as the batch-last inputs do,
//   so that one copy moves 16 bytes (4 float lanes) of a row where the
//   batch and the CTA's lanes allow; each thread's copies, and their
//   addresses, are fixed at the start.
// - dV0 and dV1 accumulate in the registers of the thread that forms Vx[0],
//   which holds k, Qu and Quu k; gnorm's terms are formed after the pass in
//   parallel and summed in order by one thread.

#include <algorithm>

#include "common.cuh"

namespace cilqr {

CILQR_CLK(__device__ long long sweep_clk[16];)

namespace {

constexpr int kLaneThreads = 32;     // a warp per lane
constexpr int kMaxLanesPerCta = 8;
constexpr int kAccThread = 21;       // phase 3's thread of Vx[0]

// One step's staged inputs (a ring slot, each value for the CTA's lanes
// side by side): A [6][6], Bm [6][2], Hx [6][6], Jx [6], Ju [2], Hu [2][2].
enum StepSlot {
  SS_A = 0, SS_B = 36, SS_HX = 48, SS_JX = 84, SS_JU = 90, SS_HU = 92,
  kStepVals = 96
};

// A lane's Riccati state in shared memory. Qxx is [6][7] and Qux [2][7]:
// their seventh columns hold Qx and Qu.
enum RicSlot {
  RS_VX = 0, RS_VXX = 6, RS_ATV = 42, RS_BTV = 78, RS_QXX = 90,
  RS_QUX = 132, RS_QUU = 146, RS_SPARE = 150, kRicVals = 151
};

template <typename T>
struct SweepArgs {
  int T_, B, KA;
  // lanes per CTA; steps per staged chunk; values of T in shared memory
  // per lane (the ring aside); lanes a staging copy moves
  int lpc, chunk, lane_smem, vec;
  T pi, inv_two_pi, two_pi, dt, hdt, inv_L, inv_T;
  // inputs, batch-last: lam [B]; alpha [KA,B]; A [T,6,6,B]; Bm [T,6,2,B];
  // Jx [N,6,B]; Ju [T,2,B]; Hx [N,6,6,B]; Hu [T,2,2,B]; xs [N,6,B];
  // us [T,2,B]
  const T *lam, *alpha, *A, *Bm, *Jx, *Ju, *Hx, *Hu, *xs, *us;
  // outputs: nxs [KA,N,6,B]; nus [KA,T,2,B]; dv0, dv1, gnorm [B]
  T *nxs, *nus, *dv0, *dv1, *gnorm;
};

// A lane's shared memory: gains [T][14] (K [2][6], then k [2]), the
// Riccati state, xs [N][6] then us [T][2] and gnorm's terms [T]. After the
// lanes' comes the CTA's ring, [2][chunk][kStepVals][lanes per CTA].
template <typename T>
struct LaneMem {
  T *gains, *rs, *traj, *gterm;
  __device__ __forceinline__ LaneMem(const SweepArgs<T>& p, T* smem, int l) {
    const int Tn = p.T_;
    gains = smem + (size_t)l * p.lane_smem;
    rs = gains + Tn * 14;
    traj = rs + kRicVals;
    gterm = traj + (Tn + 1) * 6 + Tn * 2;
  }
};

// values a lane, rounded up to 4 so that the ring is 16-byte aligned
int lane_smem(int Tn) {
  return (Tn * 14 + kRicVals + (Tn + 1) * 6 + Tn * 2 + Tn + 3) / 4 * 4;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(sizeof(T)));
}

// cp.async of BYTES (4, 8 or 16; both addresses aligned to it)
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A copy a thread makes of every staged step: `vec` neighbouring lanes
// of one element of a step's inputs (16 bytes where the lanes per CTA and
// the batch allow). The CTA's threads take the (element, lane group) units
// of a step in turn, lane groups fastest, so that neighbouring threads read
// neighbouring addresses of one batch-last row; a thread's units, and
// their addresses, are fixed at the start (at most 3: a step has 96
// elements and a CTA 32 threads a lane).
template <typename T>
struct StepCopy {
  const T* src;      // the element's lanes at step 0 (knot T - 1)
  long long stride;  // the pointer's change from one step to the next
  int dst;           // offset in a ring slot
  bool on;
};

template <typename T>
__device__ __forceinline__ StepCopy<T> step_copy(const SweepArgs<T>& p, int u,
                                                 int b0) {
  const int groups = p.lpc / p.vec;
  const int e = u / groups, lg = (u % groups) * p.vec;
  // the input array of slot e, its first slot and its values a step
  const T* base = e < SS_B ? p.A : e < SS_HX ? p.Bm : e < SS_JX ? p.Hx
                : e < SS_JU ? p.Jx : e < SS_HU ? p.Ju : p.Hu;
  const int first = e < SS_B ? SS_A : e < SS_HX ? SS_B : e < SS_JX ? SS_HX
                  : e < SS_JU ? SS_JX : e < SS_HU ? SS_JU : SS_HU;
  const int per = e < SS_B ? 36 : e < SS_HX ? 12 : e < SS_JX ? 36
                : e < SS_JU ? 6 : e < SS_HU ? 2 : 4;
  const long long B = p.B;
  StepCopy<T> c;
  c.on = u < kStepVals * groups && b0 + lg < p.B;
  c.src = base + ((long long)(p.T_ - 1) * per + (e - first)) * B + b0 + lg;
  c.stride = per * B;
  c.dst = e * p.lpc + lg;
  return c;
}

// Copy xs and us of the CTA's lanes into their shared memory (one
// cp.async group).
template <typename T>
__device__ void stage_traj(const SweepArgs<T>& p, const LaneMem<T>& m,
                           size_t b, bool active) {
  const int Tn = p.T_, nx = (Tn + 1) * 6, n = nx + Tn * 2;
  const size_t B = p.B;
  if (active)
    for (int e = threadIdx.x / p.lpc; e < n; e += kLaneThreads)
      cp_async(m.traj + e, e < nx ? p.xs + (size_t)e * B + b
                                  : p.us + (size_t)(e - nx) * B + b);
  cp_async_commit();
}

// Copy this thread's units of chunk c of the backward steps (step s runs
// knot t = T-1-s) into ring buffer c % 2 (one cp.async group), BYTES a
// copy.
template <int BYTES, typename T>
__device__ void stage_chunk(const SweepArgs<T>& p, T* ring,
                            const StepCopy<T> (&cp)[3], int c) {
  const int CH = p.chunk;
  const int steps = min(CH, p.T_ - c * CH);
  for (int si = 0; si < steps; ++si) {
    T* slot = ring + (size_t)((c & 1) * CH + si) * kStepVals * p.lpc;
    const long long s = c * CH + si;
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (cp[j].on)
        cp_async_bytes<BYTES>(slot + cp[j].dst, cp[j].src - s * cp[j].stride);
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ void stage_chunk(const SweepArgs<T>& p, T* ring,
                                            const StepCopy<T> (&cp)[3],
                                            int c) {
  const int bytes = p.vec * (int)sizeof(T);
  if (bytes == 16)
    stage_chunk<16>(p, ring, cp, c);
  else if (bytes == 8)
    stage_chunk<8>(p, ring, cp, c);
  else
    stage_chunk<4>(p, ring, cp, c);
}

// sum over k of x[k * xs] * y[k * ys], k = 0..5 in order (_mm, _mv)
template <typename T>
__device__ __forceinline__ Rn<T> dot6(const T* x, int xs, const T* y, int ys) {
  using R = Rn<T>;
  R a = R(x[0]) * R(y[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) a = a + R(x[k * xs]) * R(y[k * ys]);
  return a;
}

// An entry of phase 1 or 2: base + dot6(x, xs, y, ys) (base may be absent)
// into rs[dst]; offsets are into the lane's state rs, or into its step
// slot `in` (the lane's value of input element e at in[e * lanes per CTA]).
struct Entry {
  int x, xs, y, ys, base, dst;
  bool x_in, y_in, has_base, base_in;
};

template <typename T>
__device__ __forceinline__ Rn<T> entry_value(const Entry& en, const T* in,
                                             const T* rs) {
  using R = Rn<T>;
  const R a = dot6((en.x_in ? in : rs) + en.x, en.xs,
                   (en.y_in ? in : rs) + en.y, en.ys);
  const R with = R((en.base_in ? in : rs)[en.base]) + a;
  return en.has_base ? with : a;
}

// phase 1, e < 56: A^T Vxx (0-35), B^T Vxx (36-47), Qx (48-53), Qu (54-55)
__device__ __forceinline__ Entry phase1(int e) {
  Entry en;
  if (e < 36) {
    en = {SS_A + e / 6, 6, RS_VXX + e % 6, 6, 0, RS_ATV + e,
          true, false, false, true};
  } else if (e < 48) {
    const int f = e - 36;
    en = {SS_B + f / 6, 2, RS_VXX + f % 6, 6, 0, RS_BTV + f,
          true, false, false, true};
  } else if (e < 54) {
    const int f = e - 48;
    en = {SS_A + f, 6, RS_VX, 1, SS_JX + f, RS_QXX + f * 7 + 6,
          true, false, true, true};
  } else {
    const int f = e - 54;
    en = {SS_B + f, 2, RS_VX, 1, SS_JU + f, RS_QUX + f * 7 + 6,
          true, false, true, true};
  }
  return en;
}

// phase 2, e < 52: Qxx = Hx + (A^T Vxx) A (0-35), Qux = (B^T Vxx) A
// (36-47), Quu = Hu + (B^T Vxx) B (48-51)
__device__ __forceinline__ Entry phase2(int e) {
  Entry en;
  if (e < 36) {
    const int i = e / 6, j = e % 6;
    en = {RS_ATV + i * 6, 1, SS_A + j, 6, SS_HX + e, RS_QXX + i * 7 + j,
          false, true, true, true};
  } else if (e < 48) {
    const int i = (e - 36) / 6, j = (e - 36) % 6;
    en = {RS_BTV + i * 6, 1, SS_A + j, 6, 0, RS_QUX + i * 7 + j,
          false, true, false, true};
  } else {
    const int i = (e - 48) / 2, j = (e - 48) % 2;
    en = {RS_BTV + i * 6, 1, SS_B + j, 2, SS_HU + i * 2 + j,
          RS_QUU + i * 2 + j, false, true, true, true};
  }
  return en;
}

// An entry's offsets and strides into the step slot, for L lanes a CTA
__device__ __forceinline__ Entry lanes(Entry en, int L) {
  if (en.x_in) {
    en.x *= L;
    en.xs *= L;
  }
  if (en.y_in) {
    en.y *= L;
    en.ys *= L;
  }
  if (en.base_in) en.base *= L;
  return en;
}

// Phase P (1 or 2): entries tid and tid + 32 (of n), both computed before
// either is stored; threads past n recompute entry n - 1 and store nothing.
template <typename T, int P>
__device__ __forceinline__ void run_phase(int tid, int n, int L, const T* in,
                                          T* rs) {
  const int e0 = tid < n ? tid : n - 1;
  const int e1 = tid + kLaneThreads < n ? tid + kLaneThreads : n - 1;
  const Entry a = lanes(P == 1 ? phase1(e0) : phase2(e0), L);
  const Entry b = lanes(P == 1 ? phase1(e1) : phase2(e1), L);
  const Rn<T> va = entry_value(a, in, rs);
  const Rn<T> vb = entry_value(b, in, rs);
  if (tid < n) rs[a.dst] = va.v;
  if (tid + kLaneThreads < n) rs[b.dst] = vb.v;
}

// One Riccati step at knot t (ilqr_optimizer.cc:334-390) over the warp,
// from the step's staged inputs `in` and the lane's state rs (Vx, Vxx in,
// out): stores the gains K, k of step t; on the thread kAccThread, dV0 and
// dV1 take this step's terms. (r0, c0) is the thread's entry of phase 3.
template <typename T>
__device__ __forceinline__ void riccati_step(int tid, int r0, int c0, int t,
                                             int L, const T* in, T* rs,
                                             T* gains, Rn<T> lam, Rn<T>& dV0,
                                             Rn<T>& dV1
                                             CILQR_CLK(, long long* ph)) {
  using R = Rn<T>;
  CILQR_CLK(const long long q0 = clock64();)
  run_phase<T, 1>(tid, 56, L, in, rs);
  __syncwarp();
  CILQR_CLK(const long long q1 = clock64(); ph[0] += q1 - q0;)
  run_phase<T, 2>(tid, 52, L, in, rs);
  __syncwarp();
  CILQR_CLK(const long long q2 = clock64(); ph[1] += q2 - q1;)

  // phase 3: the closed-form inverse of Quu + lam I on every thread; then
  // V[r][c] = Qxx[r][c] + K^T (Quu K) + K^T Qux + Qux^T K at (r0, c0) and
  // (c0, r0) (for Vx, c0 == 6, both are (r0, 6)), with the gain columns
  // it needs, K[.][c] = -(Qi Qux[.][c]) (column 6 is k). Every thread runs
  // the same code and makes three stores, so the warp does not diverge.
  const T* Quu = rs + RS_QUU;
  const T* Qux = rs + RS_QUX;
  const T* Qxx = rs + RS_QXX;
  const R one(T(1));
  const R ma = R(Quu[0]) + lam, mb = Quu[1];
  const R mc = Quu[2], md = R(Quu[3]) + lam;
  const R inv_det = one / (ma * md - mb * mc);
  const R q00 = md * inv_det, q01 = -mb * inv_det;
  const R q10 = -mc * inv_det, q11 = ma * inv_det;
  const bool pair = c0 < 6;
  const int rc[2][2] = {{r0, c0}, {pair ? c0 : r0, pair ? r0 : c0}};
  R v[2], kr[2][2], kc[2][2], quuk[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rc[h][0], c = rc[h][1];
    kr[h][0] = -(q00 * R(Qux[r]) + q01 * R(Qux[7 + r]));
    kr[h][1] = -(q10 * R(Qux[r]) + q11 * R(Qux[7 + r]));
    kc[h][0] = -(q00 * R(Qux[c]) + q01 * R(Qux[7 + c]));
    kc[h][1] = -(q10 * R(Qux[c]) + q11 * R(Qux[7 + c]));
    quuk[h][0] = R(Quu[0]) * kc[h][0] + R(Quu[1]) * kc[h][1];
    quuk[h][1] = R(Quu[2]) * kc[h][0] + R(Quu[3]) * kc[h][1];
    const R t1 = kr[h][0] * quuk[h][0] + kr[h][1] * quuk[h][1];
    const R t2 = kr[h][0] * R(Qux[c]) + kr[h][1] * R(Qux[7 + c]);
    const R t3 = R(Qux[r]) * kc[h][0] + R(Qux[7 + r]) * kc[h][1];
    v[h] = R(Qxx[r * 7 + c]) + t1 + t2 + t3;
  }
  // dV0 += k Qu, dV1 += 0.5 k Quu k: meaningful on kAccThread (Vx[0]),
  // whose column 6 is k, Qu = Qux[.][6] and Quk = Quu k
  dV0 = dV0 + (kc[0][0] * R(Qux[6]) + kc[0][1] * R(Qux[13]));
  dV1 = dV1 + R(T(0.5)) * (kc[0][0] * quuk[0][0] + kc[0][1] * quuk[0][1]);
  // the stores: a Vxx pair twice; or Vx[r0] and gain column r0; or, on
  // threads 27 and 28, k; the rest write a spare slot. Phase 3 reads only
  // Qxx, Qux and Quu.
  const R sym = R(T(0.5)) * (v[0] + v[1]);
  T* gk = gains + t * 14;
  T* spare = rs + RS_SPARE;
  const bool vx = !pair && tid < 27;
  T* a = pair ? rs + RS_VXX + r0 * 6 + c0 : vx ? rs + RS_VX + r0
       : tid < 29 ? gk + 12 + (tid - 27) : spare;
  T* bp = pair ? rs + RS_VXX + c0 * 6 + r0 : vx ? gk + r0 : spare;
  T* cpt = vx ? gk + 6 + r0 : spare;
  *a = (pair ? sym : vx ? v[0] : tid == 27 ? kc[0][0] : kc[0][1]).v;
  *bp = (pair ? sym : kr[0][0]).v;
  *cpt = kr[0][1].v;
  __syncwarp();
  CILQR_CLK(ph[2] += clock64() - q2;)
}

__device__ __forceinline__ void sin_cos(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sin_cos(double x, double* s, double* c) {
  sincos(x, s, c);
}

// continuous-time bicycle ODE with the floor-form wraps (the plain
// version's _f_cont). sin and cos of the heading come from one sincos
// call, which shares their argument reduction and returns what sin and cos
// return.
template <typename T>
__device__ __forceinline__ void f_cont(const SweepArgs<T>& p, const Rn<T>* s,
                                       Rn<T> u0, Rn<T> u1, Rn<T>* out) {
  using R = Rn<T>;
  const R th = wrap(s[2], R(p.pi), R(p.inv_two_pi), R(p.two_pi));
  const R dl = wrap(s[5], R(p.pi), R(p.inv_two_pi), R(p.two_pi));
  T sn, cs;
  sin_cos(th.v, &sn, &cs);
  out[0] = s[3] * R(cs);
  out[1] = s[3] * R(sn);
  out[2] = s[3] * r_tan(dl) * R(p.inv_L);
  out[3] = s[4];
  out[4] = u0;
  out[5] = u1;
}

// The closed-loop RK2 rollout of lane b at alpha (one thread), from the
// staged xs, us and gains (the plain version's _forward_step, step by
// step); writes nxs, nus (batch-last, lane b).
template <typename T>
__device__ void rollout(const SweepArgs<T>& p, const T* traj, const T* gains,
                        Rn<T> alpha, T* nxs, T* nus) {
  using R = Rn<T>;
  const int Tn = p.T_, N = Tn + 1;
  const size_t B = p.B;
  const R pi(p.pi), inv_two_pi(p.inv_two_pi), two_pi(p.two_pi);
  const T* us = traj + N * 6;
  R x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    x[i] = traj[i];   // the rollout starts at xs[0]
    nxs[i * B] = x[i].v;
  }
  for (int t = 0; t < Tn; ++t) {
    const T* xt = traj + t * 6;
    const T* gk = gains + t * 14;
    R u[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* Kr = gk + i * 6;
      R dot = R(Kr[0]) * (x[0] - R(xt[0]));
#pragma unroll
      for (int j = 1; j < 6; ++j) dot = dot + R(Kr[j]) * (x[j] - R(xt[j]));
      u[i] = R(us[t * 2 + i]) + dot + alpha * R(gk[12 + i]);
    }
    u[1] = wrap(u[1], pi, inv_two_pi, two_pi);
    R f[6], mid[6];
    f_cont(p, x, u[0], u[1], f);
#pragma unroll
    for (int i = 0; i < 6; ++i) mid[i] = x[i] + R(p.hdt) * f[i];
    f_cont(p, mid, u[0], u[1], f);
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = x[i] + R(p.dt) * f[i];
    x[2] = wrap(x[2], pi, inv_two_pi, two_pi);
    x[5] = wrap(x[5], pi, inv_two_pi, two_pi);
    nus[(t * 2 + 0) * B] = u[0].v;
    nus[(t * 2 + 1) * B] = u[1].v;
#pragma unroll
    for (int i = 0; i < 6; ++i) nxs[((t + 1) * 6 + i) * B] = x[i].v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxLanesPerCta * kLaneThreads)
    sweep_kernel(const SweepArgs<T> p) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int Tn = p.T_, N = Tn + 1, CH = p.chunk;
  const int l = threadIdx.x / kLaneThreads, tid = threadIdx.x % kLaneThreads;
  const int b0 = blockIdx.x * p.lpc;
  const bool active = b0 + l < p.B;   // the ragged last CTA
  const size_t B = p.B, b = b0 + l;
  const LaneMem<T> m(p, smem, l);
  CILQR_CLK(long long k0 = clock64(), k1 = 0, ph[3] = {0, 0, 0}, wt = 0,
            st = 0;)
  T* ring = smem + (size_t)p.lpc * p.lane_smem;
  // this thread's copies: of xs and us, for lane cl (not its own); of the
  // steps' inputs, its units
  const int cl = threadIdx.x % p.lpc;
  StepCopy<T> cp[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    cp[j] = step_copy(p, threadIdx.x + blockDim.x * j, b0);

  stage_traj(p, LaneMem<T>(p, smem, cl), b0 + cl, b0 + cl < p.B);
  stage_chunk(p, ring, cp, 0);
  // phase 3's entry of this thread: the pair (r0, c0), r0 <= c0, for
  // thread tid < 21, Vx[r0] (c0 = 6) for 21 <= tid < 27; the others form
  // Vx[0]'s values again (27 and 28 store k)
  int r0 = 0, c0 = 6;
  if (tid < 21) {
    int j = tid;
    while (j >= 6 - r0) {
      j -= 6 - r0;
      ++r0;
    }
    c0 = r0 + j;
  } else if (tid < 27) {
    r0 = tid - 21;
  }
  R lam(T(0));
  if (active) {   // the terminal knot starts the value function
    lam = p.lam[b];
    for (int e = tid; e < 42; e += kLaneThreads)
      m.rs[RS_VX + e] = e < 6 ? p.Jx[(size_t)(Tn * 6 + e) * B + b]
                              : p.Hx[(size_t)(Tn * 36 + e - 6) * B + b];
  }

  // ---- backward Riccati, chunk by chunk: chunk c + 1 is in flight while
  // the lanes run chunk c
  R dV0(T(0)), dV1(T(0));
  const int n_chunks = (Tn + CH - 1) / CH;
  for (int c = 0; c < n_chunks; ++c) {
    CILQR_CLK(long long w0 = clock64();)
    cp_async_wait_all();
    __syncthreads();   // chunk c has landed; every lane is done with c - 1
    CILQR_CLK(if (c == 0) k1 = clock64(); wt += clock64() - w0;
              w0 = clock64();)
    if (c + 1 < n_chunks) stage_chunk(p, ring, cp, c + 1);
    CILQR_CLK(st += clock64() - w0;)
    if (!active) continue;
    const int steps = min(CH, Tn - c * CH);
    for (int si = 0; si < steps; ++si)
      riccati_step(tid, r0, c0, Tn - 1 - (c * CH + si), p.lpc,
                   ring + (size_t)((c & 1) * CH + si) * kStepVals * p.lpc + l,
                   m.rs, m.gains, lam, dV0, dV1 CILQR_CLK(, ph));
  }
  CILQR_CLK(const long long k2 = clock64();)
  if (active) {
    if (tid == kAccThread) {
      p.dv0[b] = dV0.v;
      p.dv1[b] = dV1.v;
    }
    // ---- gnorm's terms in parallel, max over u of |k| / (|u| + 1)
    const T* us = m.traj + N * 6;
    const R one(T(1));
    for (int t = tid; t < Tn; t += kLaneThreads) {
      const R g0 =
          r_abs(R(m.gains[t * 14 + 12])) / (r_abs(R(us[t * 2])) + one);
      const R g1 =
          r_abs(R(m.gains[t * 14 + 13])) / (r_abs(R(us[t * 2 + 1])) + one);
      m.gterm[t] = r_max(g0, g1).v;
    }
    __syncwarp();
    // ... summed over t = T-1 .. 0 by the last thread
    if (tid == kLaneThreads - 1) {
      R gacc(T(0));
      for (int t = Tn - 1; t >= 0; --t) gacc = gacc + R(m.gterm[t]);
      p.gnorm[b] = (gacc * R(p.inv_T)).v;
    }
  }
  __syncthreads();   // every lane's gains are in shared memory
  CILQR_CLK(const long long k3 = clock64();)

  // ---- forward rollouts (ilqr_optimizer.cc:392-415): the CTA's lanes x
  // KA alphas, one a thread, packed into the fewest warps (at 8 lanes and
  // KA = 4, one warp runs them all, and the others leave the SM's issue
  // slots to it)
  for (int r = threadIdx.x; r < p.lpc * p.KA; r += blockDim.x) {
    const int rl = r / p.KA, a = r % p.KA;
    const size_t rb = b0 + rl;
    if (rb >= B) continue;
    const LaneMem<T> rm(p, smem, rl);
    rollout(p, rm.traj, rm.gains, R(p.alpha[(size_t)a * B + rb]),
            p.nxs + (size_t)a * N * 6 * B + rb,
            p.nus + (size_t)a * Tn * 2 * B + rb);
  }
  CILQR_CLK(if (blockIdx.x == 0 && threadIdx.x == 0) {
    const long long v[9] = {k1 - k0, k2 - k1, ph[0], ph[1], ph[2], wt, st,
                            k3 - k2, clock64() - k3};
    for (int i = 0; i < 9; ++i) sweep_clk[i] = v[i];
  })
}

template <typename T>
int launch(int T_, int B, int KA, double dt, double L, const void* lam,
           const void* alpha, const void* A, const void* Bm, const void* Jx,
           const void* Ju, const void* Hx, const void* Hu, const void* xs,
           const void* us, void* nxs, void* nus, void* dv0, void* dv1,
           void* gnorm, void* stream) {
  if (T_ < 1 || B < 1 || KA < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  SweepArgs<T> p;
  p.T_ = T_;
  p.B = B;
  p.KA = KA;
  // constants as the plain version forms them from Python floats
  // (kernels/megasolve.py: _step_constants), rounded to T
  const double pi = 3.14159265358979323846;
  p.pi = T(pi);
  p.inv_two_pi = T(1.0 / (2.0 * pi));
  p.two_pi = T(2.0 * pi);
  p.dt = T(dt);
  p.hdt = T(0.5 * dt);
  p.inv_L = T(1.0 / L);
  p.inv_T = T(1.0 / T_);
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
  p.dv0 = static_cast<T*>(dv0);
  p.dv1 = static_cast<T*>(dv1);
  p.gnorm = static_cast<T*>(gnorm);

  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // enough CTAs to cover the SMs, at most kMaxLanesPerCta lanes each
  p.lpc = std::min(kMaxLanesPerCta, std::max(1, (B + sms - 1) / sms));
  p.chunk = sizeof(T) == 4 ? 8 : 4;
  p.lane_smem = lane_smem(T_);
  // lanes a staging copy moves: up to 16 bytes, aligned in the batch-last
  // rows (which holds when they divide both the batch and the CTA's lanes)
  const size_t addr = reinterpret_cast<size_t>(A) |
                      reinterpret_cast<size_t>(Bm) |
                      reinterpret_cast<size_t>(Jx) |
                      reinterpret_cast<size_t>(Ju) |
                      reinterpret_cast<size_t>(Hx) |
                      reinterpret_cast<size_t>(Hu);
  p.vec = 16 / (int)sizeof(T);
  while (p.vec > 1 && (B % p.vec || p.lpc % p.vec ||
                       addr % (p.vec * sizeof(T))))
    p.vec /= 2;
  const size_t smem = ((size_t)p.lpc * p.lane_smem +
                       (size_t)2 * p.chunk * kStepVals * p.lpc) * sizeof(T);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sweep_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((B + p.lpc - 1) / p.lpc);
  sweep_kernel<T><<<grid, p.lpc * kLaneThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace cilqr

extern "C" {

#ifdef CILQR_PROFILE
int sweep_read_clk(long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, cilqr::sweep_clk,
                                               sizeof(cilqr::sweep_clk)));
}
#endif

int riccati_sweep_f32(int T_, int B, int KA, double dt, double L,
                      const void* lam, const void* alpha, const void* A,
                      const void* Bm, const void* Jx, const void* Ju,
                      const void* Hx, const void* Hu, const void* xs,
                      const void* us, void* nxs, void* nus, void* dv0,
                      void* dv1, void* gnorm, void* stream) {
  return cilqr::launch<float>(T_, B, KA, dt, L, lam, alpha, A, Bm, Jx, Ju,
                              Hx, Hu, xs, us, nxs, nus, dv0, dv1, gnorm,
                              stream);
}

int riccati_sweep_f64(int T_, int B, int KA, double dt, double L,
                      const void* lam, const void* alpha, const void* A,
                      const void* Bm, const void* Jx, const void* Ju,
                      const void* Hx, const void* Hu, const void* xs,
                      const void* us, void* nxs, void* nus, void* dv0,
                      void* dv1, void* gnorm, void* stream) {
  return cilqr::launch<double>(T_, B, KA, dt, L, lam, alpha, A, Bm, Jx, Ju,
                               Hx, Hu, xs, us, nxs, nus, dv0, dv1, gnorm,
                               stream);
}

// Text of a cudaError_t, for the Python wrappers' exceptions.
const char* cilqr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
