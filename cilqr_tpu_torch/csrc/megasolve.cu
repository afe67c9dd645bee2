// Full-solve megakernel: the whole serial-line-search CILQR loop of a block
// of lanes in one launch.
//
// Replaces the Pallas TPU kernel
// cilqr_tpu/pallas/megasolve.py::solve_batch_mega (kernel _mega_kernel,
// :123). What it computes follows that kernel: the initial cost; then trips
// of analytic midpoint Jacobians, cost derivatives, a regularized Riccati
// backward pass, one closed-loop RK2 rollout at the lane's current alpha,
// the candidate's cost over a full scan of the lane segments (first index
// wins ties), and the accept, lambda and status rules with
// dcost = cost_old - cost_new; RUNNING becomes MAX_ITER at the end. The loop
// exits per block of block_nb lanes: a block runs while any of its lanes is
// RUNNING below max_iter, and every RUNNING lane of a running block takes
// the trip, so a lane can overrun the cap as it does in the Pallas kernel.
// The plain PyTorch version is
// cilqr_tpu_torch/kernels/megasolve.py::solve_batch_mega_ref.
//
// Exactness: every arithmetic operation goes through Rn<T>, whose operators
// are the explicitly rounded intrinsics (no FMA contraction), in the order of
// the plain version's separately rounded PyTorch operations; sums run in one
// fixed order (knots, then planes x discs, then discs x sides); divisions by
// a constant are multiplications by a reciprocal formed in double precision
// (PyTorch on the card divides a tensor by a Python scalar that way, so the
// plain version can only match a kernel that does too: hence common.cuh's
// `wrap`, shared with sweep.cu); the transcendentals are the accurate
// ones PyTorch calls. Threads split a lane's work only across values that
// are independent, and each value is computed by one thread with the same
// sequence of operations as in a serial loop; each nearest-segment scan is a
// strict running minimum seeded with segment 0 inside one thread. So the
// kernel and its plain version take the same accept decisions, which are
// chaotic at their thresholds, instead of drifting apart by round-off.
//
// What bounds it: operations, and the serial chains among them. A trip that
// retries at the next alpha has the xs, us and lam of the trip before, so
// the kernel relinearizes (Jacobians, cost derivatives, backward pass) only
// on a lane's first trip and on the trip after each concluded one
// (aidx == 0), keeps the gains, dV0, dV1 and gnorm across retries, and
// skips the rollout of a trip that ends the lane on a small gradient. The
// derivatives reuse the lane selection that the cost of the same trajectory
// made (stored per knot, side and disc), so each trip scans the lane
// segments once, in the candidate's cost. What remains per trip is the
// candidate's cost (about 70% of it the lane scans, a division and a square
// root per segment and disc) and, on a relinearizing trip, the 80-step
// Riccati recursion, whose steps are serial. A block takes each trip at the
// pace of its slowest lane, and at one warp per lane an SM holds 8 warps, too
// few to hide the latency of each thread's dependent chains (the IEEE
// division and square root of every segment, the Riccati products): the
// kernel is latency-bound, far above its operations bound.
//
// Design: a group of G threads per lane (G = 32, a warp, for block_nb <=
// 128; G = 16 above, so that 16 lanes fit a CTA of 256 threads). The group
// computes the per-knot Jacobians and cost derivatives in parallel over
// knots, G knots at a time into shared memory, and runs the Riccati
// recursion over them with each 6x6 and 2x6 product spread over the group,
// one output entry per thread; one thread runs the rollout; the candidate's
// cost runs in parallel over (knot, side) lane scans and knots, and one
// thread per component sums it in knot order. The lane tables and the
// Riccati state live in shared memory; the trajectories (current and
// candidate, swapped on accept), the gains, the lane selections and the
// candidate's lane barrier values live in lane-major scratch in device
// memory (resident in L2). One exit block of block_nb lanes is one
// thread-block cluster of up to 16 CTAs (8 lanes a CTA at G = 32), so at
// B=1024 eight clusters of 16 CTAs, one CTA an SM, ask for 128 of the H100's
// 132 SMs (an H100 80GB HBM3 holds 7 such clusters at once, by
// cudaOccupancyMaxActiveClusters: the eighth starts when one ends); each
// trip's exit vote is an OR over the cluster: every CTA ORs its lanes
// (__syncthreads_or), writes the result into its own shared memory,
// double-buffered by trip parity, and after one cluster barrier reads its
// peers' votes through distributed shared memory. Groups of a CTA beyond
// block_nb compute nothing and take part in every barrier.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace cilqr {
namespace {

constexpr int kMaxBlock = 256;   // kernels/megasolve.py: MAX_BLOCK
constexpr int kMaxDiscs = 8;     // kernels/megasolve.py: MAX_DISCS
constexpr int kMaxAlphas = 16;   // kernels/megasolve.py: MAX_ALPHAS
constexpr int kPtrs = 17;        // device pointers handed over by the wrapper
constexpr int kCtaThreads = 256;  // threads of a CTA, at most
constexpr int kMaxCluster = 16;   // CTAs of a cluster, at most (non-portable)

// Scalar constants, in the order of kernels/megasolve.py: CONSTANTS.
enum Const {
  C_PI, C_TWO_PI, C_INV_TWO_PI,
  C_DT, C_HDT, C_HDT2, C_NEG_DT, C_INV_L,
  C_WX, C_WY, C_WTH, C_WJ, C_WDR,
  C_WX2, C_WY2, C_WTH2, C_WV2, C_WA2, C_WD2, C_WJ2, C_WDR2,
  C_VMAX, C_AMAX, C_AMIN, C_DMAX, C_DMIN, C_JMAX, C_JMIN, C_DRMAX,
  C_DRMIN,
  C_NEG_EPS, C_TWO_EPS, C_INV_EPS, C_RT, C_NEG_RT, C_HALF_RT,
  C_RT_LOG_EPS, C_RT_INV_EPS2,
  C_BETA_MIN, C_BETA_MAX, C_ABS_TOL, C_REL_TOL,
  C_LAMBDA_INIT, C_RATIO, C_INV_RATIO, C_LAMBDA_MIN, C_LAMBDA_MAX,
  C_GNORM_MIN, C_GNORM_LAM, C_INV_T,
  kNumConst
};

// solver status codes (types.SolverStatus)
constexpr int kRunning = 0, kGnorm = 1, kAbsCost = 2, kRelCost = 3,
              kLambdaMax = 4, kMaxIter = 5;

// What the backward pass keeps of one knot (a slot of the shared-memory
// chunk): cost Jacobian Jx, the Hessian's nine structural entries, Ju, the
// control Hessian's diagonal Hu, the controls u, the 11 computed entries of
// A (rows 0-1 columns 2-5, row 2 columns 3-5) and B[2][1].
enum KnotSlot {
  KS_JX = 0, KS_HC = 6, KS_JU = 15, KS_HU = 17, KS_U = 19, KS_A = 21,
  KS_B21 = 32, kKnotVals = 33
};

// A lane's Riccati state in shared memory, and BC, the values one thread
// hands to its group (cost sums, dV0, dV1, gnorm).
enum RicSlot {
  RS_VX = 0, RS_VXX = 6, RS_QX = 42, RS_QU = 48, RS_ATV = 50, RS_BTV = 86,
  RS_QXX = 98, RS_QUU = 134, RS_QUX = 138, RS_KG = 150, RS_KK = 162,
  RS_BC = 164, kRicVals = 172
};

template <typename T>
struct MegaArgs {
  int N, B, KC, S, D, n_alpha, max_iter;
  // lanes of an exit block; threads per lane (G); lanes per CTA; CTAs per
  // cluster; values of T in shared memory per lane
  int block_nb, G, lpc, csize, lane_smem;
  T c[kNumConst];
  T offs[kMaxDiscs];
  T alphas[kMaxAlphas];
  // inputs, batch-last: goals, xs0 [N,6,B]; us0 [T,2,B]; ca, cb, cc
  // [N,KC,B]; laneL, laneR [7,S,B] (rows a, b, c, x1, y1, x2, y2)
  const T *goals, *xs0, *us0, *ca, *cb, *cc, *laneL, *laneR;
  // outputs: xs [N,6,B]; us [T,2,B]; fs [6,B] (cost rows, lam); is [4,B]
  // (status, iterations, RUNNING trips, relinearizations); block_trips
  // [B/block_nb]
  T *xs, *us, *fs;
  int *is, *block_trips;
  // scratch, lane-major: traj [B][2][N*6 + T*2] (two trajectories, xs then
  // us); gains [B][T*14] (Ks [T][2][6], then ks [T][2]); lv [B][N][2][D]
  // (the candidate's lane barrier values); sel [B][2][N][2][D] (the lane
  // selection of each trajectory)
  T *traj, *gains, *lv;
  int* sel;
};

// The threads of one lane: G consecutive threads of a warp.
struct Group {
  int tid, G;
  unsigned mask;
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

// element (i0, i1, ...) of a batch-last tensor, lane b
#define AT(ptr, flat) (ptr)[(size_t)(flat) * B + b]
#define K(name) R(p.c[C_##name])

template <typename T>
__device__ __forceinline__ Rn<T> wrap(Rn<T> x, const MegaArgs<T>& p) {
  using R = Rn<T>;
  return cilqr::wrap(x, K(PI), K(INV_TWO_PI), K(TWO_PI));
}

template <typename T>
__device__ __forceinline__ Rn<T> bar_value(Rn<T> g, const MegaArgs<T>& p) {
  using R = Rn<T>;
  const R safe = r_min(g, K(NEG_EPS));
  const R logb = r_log(-safe) * K(NEG_RT);
  const R q = (-g - K(TWO_EPS)) * K(INV_EPS);
  const R quadb = (q * q - R(T(1))) * K(HALF_RT) - K(RT_LOG_EPS);
  return g < K(NEG_EPS) ? logb : quadb;
}

template <typename T>
__device__ __forceinline__ void bar_derivs(Rn<T> g, const MegaArgs<T>& p,
                                           Rn<T>& gf, Rn<T>& hf, Rn<T>& hd) {
  using R = Rn<T>;
  const R safe = r_min(g, K(NEG_EPS));
  const bool in_log = g < K(NEG_EPS);
  const R quad = (g + K(TWO_EPS)) * K(RT_INV_EPS2);
  const R ddx_log = R(T(1)) / safe * K(NEG_RT);
  gf = in_log ? ddx_log : quad;
  hf = in_log ? R(T(1)) / (safe * safe) * K(RT) : quad;
  hd = in_log ? ddx_log : R(T(0));
}

// Nearest segment of one lane side (shared memory, rows [7][S]) for the D
// disc centres: a full scan with a strict running minimum seeded with
// segment 0 (the first index wins ties, and a NaN distance at segment 0
// keeps it, as in the Pallas kernel).
template <typename T>
__device__ void select_lane(const MegaArgs<T>& p, const T* lane,
                            const Rn<T>* cx, const Rn<T>* cy, int* idx) {
  using R = Rn<T>;
  const int S = p.S;
  const R zero(T(0)), one(T(1));
  R best[kMaxDiscs];
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d) {
    best[d] = R(infinity<T>());
    idx[d] = 0;
  }
  for (int s = 0; s < S; ++s) {
    const R x1 = lane[3 * S + s], y1 = lane[4 * S + s];
    const R x2 = lane[5 * S + s], y2 = lane[6 * S + s];
    const R abx = x2 - x1;
    const R aby = y2 - y1;
    const R ab2 = abx * abx + aby * aby;
#pragma unroll
    for (int d = 0; d < kMaxDiscs; ++d) {
      if (d < p.D) {
        const R apx = cx[d] - x1;
        const R apy = cy[d] - y1;
        const R num = apx * abx + apy * aby;
        R tt = ab2 > zero ? num / ab2 : zero;
        tt = r_min(r_max(tt, zero), one);
        const R dx = cx[d] - (x1 + tt * abx);
        const R dy = cy[d] - (y1 + tt * aby);
        const R dist = r_sqrt(dx * dx + dy * dy);
        if (s == 0 || dist < best[d]) {
          best[d] = dist;
          idx[d] = s;
        }
      }
    }
  }
}

// disc centres of a knot: offsets along the heading
template <typename T>
__device__ __forceinline__ void discs(const MegaArgs<T>& p, const Rn<T>* x,
                                      Rn<T>* lc, Rn<T>* ls, Rn<T>* cx,
                                      Rn<T>* cy) {
  using R = Rn<T>;
  const R ct = r_cos(x[2]);
  const R st = r_sin(x[2]);
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d) {
    if (d < p.D) {
      lc[d] = R(p.offs[d]) * ct;
      ls[d] = R(p.offs[d]) * st;
      cx[d] = x[0] + lc[d];
      cy[d] = x[1] + ls[d];
    }
  }
}

// Target, dynamic and corridor cost components of knot n.
template <typename T>
__device__ void knot_value(const MegaArgs<T>& p, size_t b, int n,
                           const Rn<T>* x, bool has_u, Rn<T> u0, Rn<T> u1,
                           Rn<T>& tk_out, Rn<T>& dk_out, Rn<T>& ck_out) {
  using R = Rn<T>;
  const size_t B = p.B;
  const R dx = x[0] - R(AT(p.goals, n * 6 + 0));
  const R dy = x[1] - R(AT(p.goals, n * 6 + 1));
  const R dth = x[2] - R(AT(p.goals, n * 6 + 2));
  R tk = K(WX) * dx * dx + K(WY) * dy * dy + K(WTH) * dth * dth;
  if (has_u) tk = tk + (K(WJ) * u0 * u0 + K(WDR) * u1 * u1);

  R dk = bar_value(-x[3], p);
  dk = dk + bar_value(x[3] - K(VMAX), p);
  dk = dk + bar_value(x[4] - K(AMAX), p);
  dk = dk + bar_value(K(AMIN) - x[4], p);
  dk = dk + bar_value(x[5] - K(DMAX), p);
  dk = dk + bar_value(K(DMIN) - x[5], p);
  if (has_u) {
    dk = dk + bar_value(u0 - K(JMAX), p);
    dk = dk + bar_value(K(JMIN) - u0, p);
    dk = dk + bar_value(u1 - K(DRMAX), p);
    dk = dk + bar_value(K(DRMIN) - u1, p);
  }

  R lc[kMaxDiscs], ls[kMaxDiscs], cx[kMaxDiscs], cy[kMaxDiscs];
  discs(p, x, lc, ls, cx, cy);
  R ck(T(0));
  for (int k = 0; k < p.KC; ++k) {
    const R pa = AT(p.ca, n * p.KC + k);
    const R pb = AT(p.cb, n * p.KC + k);
    const R pc = AT(p.cc, n * p.KC + k);
#pragma unroll
    for (int d = 0; d < kMaxDiscs; ++d)
      if (d < p.D) ck = ck + bar_value(pa * cx[d] + pb * cy[d] - pc, p);
  }
  tk_out = tk;
  dk_out = dk;
  ck_out = ck;
}

// Cost Jacobian and Hessian of knot n: Jx[6]; the Hessian's nine structural
// entries hc = (h00, h01, h02, h11, h12, h22, h33, h44, h55); with has_u,
// Ju[2] and the control Hessian's diagonal Hu[2]. The lane planes are the
// ones `sel` ([2][D]) selected for this knot's disc centres.
template <typename T>
__device__ void knot_derivs(const MegaArgs<T>& p, const T* tab,
                            const int* sel, size_t b, int n, const Rn<T>* x,
                            bool has_u, Rn<T> u0, Rn<T> u1, Rn<T>* Jx,
                            Rn<T>* hc, Rn<T>* Ju, Rn<T>* Hu) {
  using R = Rn<T>;
  const size_t B = p.B;
  const int S = p.S;
  const R zero(T(0)), pos(T(1)), neg(T(-1));
  const R dx = x[0] - R(AT(p.goals, n * 6 + 0));
  const R dy = x[1] - R(AT(p.goals, n * 6 + 1));
  const R dth = x[2] - R(AT(p.goals, n * 6 + 2));
  R gf, hf, hd;

  // state limits: rows 3 (v), 4 (a), 5 (delta)
  R j3 = zero, j4 = zero, j5 = zero;
  R h33 = zero + K(WV2), h44 = zero + K(WA2), h55 = zero + K(WD2);
  bar_derivs(-x[3], p, gf, hf, hd);
  j3 = j3 + gf * neg; h33 = h33 + hf;
  bar_derivs(x[3] - K(VMAX), p, gf, hf, hd);
  j3 = j3 + gf * pos; h33 = h33 + hf;
  bar_derivs(x[4] - K(AMAX), p, gf, hf, hd);
  j4 = j4 + gf * pos; h44 = h44 + hf;
  bar_derivs(K(AMIN) - x[4], p, gf, hf, hd);
  j4 = j4 + gf * neg; h44 = h44 + hf;
  bar_derivs(x[5] - K(DMAX), p, gf, hf, hd);
  j5 = j5 + gf * pos; h55 = h55 + hf;
  bar_derivs(K(DMIN) - x[5], p, gf, hf, hd);
  j5 = j5 + gf * neg; h55 = h55 + hf;
  if (has_u) {
    R ju0 = K(WJ2) * u0, ju1 = K(WDR2) * u1;
    R hu0 = zero + K(WJ2), hu1 = zero + K(WDR2);
    bar_derivs(u0 - K(JMAX), p, gf, hf, hd);
    ju0 = ju0 + gf * pos; hu0 = hu0 + hf;
    bar_derivs(K(JMIN) - u0, p, gf, hf, hd);
    ju0 = ju0 + gf * neg; hu0 = hu0 + hf;
    bar_derivs(u1 - K(DRMAX), p, gf, hf, hd);
    ju1 = ju1 + gf * pos; hu1 = hu1 + hf;
    bar_derivs(K(DRMIN) - u1, p, gf, hf, hd);
    ju1 = ju1 + gf * neg; hu1 = hu1 + hf;
    Ju[0] = ju0; Ju[1] = ju1;
    Hu[0] = hu0; Hu[1] = hu1;
  }

  R j0 = K(WX2) * dx, j1 = K(WY2) * dy, j2 = K(WTH2) * dth;
  R h00 = zero + K(WX2), h01 = zero, h02 = zero, h11 = zero + K(WY2);
  R h12 = zero, h22 = zero + K(WTH2);
  R lc[kMaxDiscs], ls[kMaxDiscs], cx[kMaxDiscs], cy[kMaxDiscs];
  discs(p, x, lc, ls, cx, cy);
  for (int k = 0; k < p.KC; ++k) {
    const R pa = AT(p.ca, n * p.KC + k);
    const R pb = AT(p.cb, n * p.KC + k);
    const R pc = AT(p.cc, n * p.KC + k);
#pragma unroll
    for (int d = 0; d < kMaxDiscs; ++d) {
      if (d < p.D) {
        const R g = pa * cx[d] + pb * cy[d] - pc;
        const R dthk = -pa * ls[d] + pb * lc[d];
        bar_derivs(g, p, gf, hf, hd);
        const R ddx22 = -pa * lc[d] - pb * ls[d];
        j0 = j0 + gf * pa;
        j1 = j1 + gf * pb;
        j2 = j2 + gf * dthk;
        h00 = h00 + hf * pa * pa;
        h01 = h01 + hf * pa * pb;
        h02 = h02 + hf * pa * dthk;
        h11 = h11 + hf * pb * pb;
        h12 = h12 + hf * pb * dthk;
        h22 = h22 + (hf * dthk * dthk + hd * ddx22);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d) {
    if (d < p.D) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const T* lane = tab + s * 7 * S;
        const int i = sel[s * p.D + d];
        const R la = lane[i], lb = lane[S + i];
        const R lg = la * cx[d] + lb * cy[d] - R(lane[2 * S + i]);
        const R ldth = -la * ls[d] + lb * lc[d];
        bar_derivs(lg, p, gf, hf, hd);
        const R lddx22 = -la * lc[d] - lb * ls[d];
        j0 = j0 + gf * la;
        j1 = j1 + gf * lb;
        j2 = j2 + gf * ldth;
        h00 = h00 + hf * la * la;
        h01 = h01 + hf * la * lb;
        h02 = h02 + hf * la * ldth;
        h11 = h11 + hf * lb * lb;
        h12 = h12 + hf * lb * ldth;
        h22 = h22 + hf * ldth * ldth;
        h22 = h22 + hd * lddx22;
      }
    }
  }
  Jx[0] = j0; Jx[1] = j1; Jx[2] = j2; Jx[3] = j3; Jx[4] = j4; Jx[5] = j5;
  hc[0] = h00; hc[1] = h01; hc[2] = h02; hc[3] = h11; hc[4] = h12;
  hc[5] = h22; hc[6] = h33; hc[7] = h44; hc[8] = h55;
}

// Analytic midpoint Jacobians of one step (vehicle_model.cc:44-86, with its
// v-vs-v_mid quirk) at state x and steering rate dr: the 11 entries of A
// that are neither 0 nor 1 nor dt (rows 0-1 columns 2-5, row 2 columns 3-5)
// and B[2][1].
template <typename T>
__device__ __forceinline__ void jacobian(const MegaArgs<T>& p, const Rn<T>* x,
                                         Rn<T> dr, Rn<T>* a, Rn<T>& b21) {
  using R = Rn<T>;
  const R one(T(1));
  const R v = x[3];
  const R theta = wrap(x[2], p);
  const R delta = wrap(x[5], p);
  const R acc = x[4];
  const R tan_delta = r_tan(delta);
  const R theta_mid = theta + K(HDT) * v * tan_delta * K(INV_L);
  const R tan_dr = r_tan(delta + K(HDT) * dr);
  const R cos_tm = r_cos(theta_mid);
  const R sin_tm = r_sin(theta_mid);
  const R td2 = tan_delta * tan_delta;
  const R tdr2 = tan_dr * tan_dr;
  const R v_mid = R(T(0.5)) * acc * K(DT) + v;
  a[0] = K(NEG_DT) * v_mid * sin_tm;
  a[1] = K(DT) * cos_tm - K(HDT2) * v_mid * sin_tm * tan_delta * K(INV_L);
  a[2] = K(HDT2) * cos_tm;
  a[3] = -K(HDT2) * v * v_mid * (td2 + one) * sin_tm * K(INV_L);
  a[4] = K(DT) * v_mid * cos_tm;
  a[5] = K(DT) * sin_tm + K(HDT2) * v_mid * cos_tm * tan_delta * K(INV_L);
  a[6] = K(HDT2) * sin_tm;
  a[7] = K(HDT2) * v * v_mid * (td2 + one) * cos_tm * K(INV_L);
  a[8] = K(DT) * tan_dr * K(INV_L);
  a[9] = K(HDT2) * tan_dr * K(INV_L);
  a[10] = K(DT) * v * (tdr2 + one) * K(INV_L);
  b21 = K(HDT2) * v * (tdr2 + one) * K(INV_L);
}

// entry A[k][i] of a step's Jacobian from its chunk slot s
template <typename T>
__device__ __forceinline__ Rn<T> a_at(const MegaArgs<T>& p, const T* s, int k,
                                      int i) {
  using R = Rn<T>;
  if (k == i) return R(T(1));
  if (k <= 1 && i >= 2) return R(s[KS_A + k * 4 + i - 2]);
  if (k == 2 && i >= 3) return R(s[KS_A + 8 + i - 3]);
  if (k == 3 && i == 4) return K(DT);
  return R(T(0));
}

// entry B[k][i] of a step's control Jacobian from its chunk slot s
template <typename T>
__device__ __forceinline__ Rn<T> b_at(const MegaArgs<T>& p, const T* s, int k,
                                      int i) {
  using R = Rn<T>;
  if (k == 2 && i == 1) return R(s[KS_B21]);
  if (k == 3 && i == 0) return K(HDT2);
  if ((k == 4 && i == 0) || (k == 5 && i == 1)) return K(DT);
  return R(T(0));
}

// entry (i, j) of the 6x6 state Hessian from its structural entries
template <typename T>
__device__ __forceinline__ Rn<T> hx_at(const T* hc, int i, int j) {
  if (i > j) { const int t = i; i = j; j = t; }
  if (i == 0) return j == 0 ? hc[0] : j == 1 ? hc[1] : j == 2 ? hc[2] : T(0);
  if (i == 1) return j == 1 ? hc[3] : j == 2 ? hc[4] : T(0);
  if (i == 2) return j == 2 ? hc[5] : T(0);
  return i == j ? hc[3 + i] : T(0);
}

// continuous-time bicycle ODE with the floor-form wraps
template <typename T>
__device__ __forceinline__ void f_cont(const MegaArgs<T>& p, const Rn<T>* s,
                                       Rn<T> u0, Rn<T> u1, Rn<T>* out) {
  using R = Rn<T>;
  const R th = wrap(s[2], p);
  const R dl = wrap(s[5], p);
  out[0] = s[3] * r_cos(th);
  out[1] = s[3] * r_sin(th);
  out[2] = s[3] * r_tan(dl) * K(INV_L);
  out[3] = s[4];
  out[4] = u0;
  out[5] = u1;
}

// Cost of trajectory tr (lane-major: xs [N][6], then us [T][2]) of one lane:
// the lane scans of every (knot, side) and the other components of every
// knot in parallel over the group, the lane components, then each component
// summed in knot order by one thread. Stores the lane selection in sel_out
// ([N][2][D]); returns the sums (target, dynamic, corridor, lane) in acc.
template <typename T>
__device__ void cost_eval(const MegaArgs<T>& p, const Group& g, size_t b,
                          const T* tr, const T* tab, T* kc, T* bc, T* lv,
                          int* sel_out, Rn<T>* acc) {
  using R = Rn<T>;
  const int N = p.N, Tn = N - 1, D = p.D, S = p.S;
  const R zero(T(0));
  for (int e = g.tid; e < 3 * N; e += g.G) {
    if (e < 2 * N) {
      const int n = e >> 1, s = e & 1;
      R x[3], lc[kMaxDiscs], ls[kMaxDiscs], cx[kMaxDiscs], cy[kMaxDiscs];
#pragma unroll
      for (int i = 0; i < 3; ++i) x[i] = tr[n * 6 + i];
      discs(p, x, lc, ls, cx, cy);
      const T* lane = tab + s * 7 * S;
      int idx[kMaxDiscs];
      select_lane(p, lane, cx, cy, idx);
#pragma unroll
      for (int d = 0; d < kMaxDiscs; ++d) {
        if (d < D) {
          const int i = idx[d];
          const R sa = lane[i], sb = lane[S + i], sc = lane[2 * S + i];
          sel_out[(n * 2 + s) * D + d] = i;
          lv[(n * 2 + s) * D + d] = bar_value(sa * cx[d] + sb * cy[d] - sc, p).v;
        }
      }
    } else {
      const int n = e - 2 * N;
      R x[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = tr[n * 6 + i];
      const bool has_u = n < Tn;
      const R u0 = has_u ? R(tr[N * 6 + n * 2 + 0]) : zero;
      const R u1 = has_u ? R(tr[N * 6 + n * 2 + 1]) : zero;
      R tk, dk, ck;
      knot_value(p, b, n, x, has_u, u0, u1, tk, dk, ck);
      kc[n * 4 + 0] = tk.v;
      kc[n * 4 + 1] = dk.v;
      kc[n * 4 + 2] = ck.v;
    }
  }
  g.sync();
  for (int n = g.tid; n < N; n += g.G) {
    R lk(T(0));
    for (int d = 0; d < D; ++d)
#pragma unroll
      for (int s = 0; s < 2; ++s) lk = lk + R(lv[(n * 2 + s) * D + d]);
    kc[n * 4 + 3] = lk.v;
  }
  g.sync();
  if (g.tid < 4) {
    R a = zero;
    for (int n = 0; n < N; ++n) a = a + R(kc[n * 4 + g.tid]);
    bc[g.tid] = a.v;
  }
  g.sync();
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = bc[i];
}

// One Riccati step at knot t (ilqr_optimizer.cc:334-390) over the group,
// from the knot's chunk slot s and the lane's state rs (Vx, Vxx in, out):
// stores the gains K, k of step t; thread `acc` adds to the dV and gnorm
// accumulators.
template <typename T>
__device__ void riccati_step(const MegaArgs<T>& p, const Group& g, int t,
                             const T* s, T* rs, T* gains, Rn<T> lam, bool acc,
                             Rn<T>& dV0, Rn<T>& dV1, Rn<T>& gacc) {
  using R = Rn<T>;
  const int Tn = p.N - 1;
  const R zero(T(0)), one(T(1));
  T* Vx = rs + RS_VX;
  T* Vxx = rs + RS_VXX;
  T* Qx = rs + RS_QX;
  T* Qu = rs + RS_QU;
  T* AtV = rs + RS_ATV;
  T* BtV = rs + RS_BTV;
  T* Qxx = rs + RS_QXX;
  T* Quu = rs + RS_QUU;
  T* Qux = rs + RS_QUX;
  T* Kg = rs + RS_KG;
  T* kg = rs + RS_KK;

  // A^T Vxx, B^T Vxx, Qx = Jx + A^T Vx, Qu = Ju + B^T Vx
  for (int e = g.tid; e < 56; e += g.G) {
    if (e < 36) {
      const int i = e / 6, j = e % 6;
      R a = a_at(p, s, 0, i) * R(Vxx[j]);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + a_at(p, s, k, i) * R(Vxx[k * 6 + j]);
      AtV[e] = a.v;
    } else if (e < 48) {
      const int i = (e - 36) / 6, j = (e - 36) % 6;
      R a = b_at(p, s, 0, i) * R(Vxx[j]);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + b_at(p, s, k, i) * R(Vxx[k * 6 + j]);
      BtV[e - 36] = a.v;
    } else if (e < 54) {
      const int i = e - 48;
      R a = a_at(p, s, 0, i) * R(Vx[0]);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + a_at(p, s, k, i) * R(Vx[k]);
      Qx[i] = (R(s[KS_JX + i]) + a).v;
    } else {
      const int i = e - 54;
      R a = b_at(p, s, 0, i) * R(Vx[0]);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + b_at(p, s, k, i) * R(Vx[k]);
      Qu[i] = (R(s[KS_JU + i]) + a).v;
    }
  }
  g.sync();
  // Qxx = Hx + (A^T Vxx) A; Qux = (B^T Vxx) A; Quu = Hu + (B^T Vxx) B
  for (int e = g.tid; e < 52; e += g.G) {
    if (e < 36) {
      const int i = e / 6, j = e % 6;
      R a = R(AtV[i * 6]) * a_at(p, s, 0, j);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + R(AtV[i * 6 + k]) * a_at(p, s, k, j);
      Qxx[e] = (hx_at(s + KS_HC, i, j) + a).v;
    } else if (e < 48) {
      const int i = (e - 36) / 6, j = (e - 36) % 6;
      R a = R(BtV[i * 6]) * a_at(p, s, 0, j);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + R(BtV[i * 6 + k]) * a_at(p, s, k, j);
      Qux[e - 36] = a.v;
    } else {
      const int i = (e - 48) / 2, j = (e - 48) % 2;
      R a = R(BtV[i * 6]) * b_at(p, s, 0, j);
#pragma unroll
      for (int k = 1; k < 6; ++k) a = a + R(BtV[i * 6 + k]) * b_at(p, s, k, j);
      Quu[e - 48] = ((i == j ? R(s[KS_HU + i]) : zero) + a).v;
    }
  }
  g.sync();
  // gains from the closed-form inverse of Quu + lam I
  for (int e = g.tid; e < 14; e += g.G) {
    const R ma = R(Quu[0]) + lam, mb = Quu[1];
    const R mc = Quu[2], md = R(Quu[3]) + lam;
    const R inv_det = one / (ma * md - mb * mc);
    const R Qi[2][2] = {{md * inv_det, -mb * inv_det},
                        {-mc * inv_det, ma * inv_det}};
    if (e < 12) {
      const int i = e / 6, j = e % 6;
      const R v = -(Qi[i][0] * R(Qux[j]) + Qi[i][1] * R(Qux[6 + j]));
      Kg[e] = v.v;
      gains[t * 12 + e] = v.v;
    } else {
      const int i = e - 12;
      const R v = -(Qi[i][0] * R(Qu[0]) + Qi[i][1] * R(Qu[1]));
      kg[i] = v.v;
      gains[Tn * 12 + t * 2 + i] = v.v;
    }
  }
  g.sync();
  // Vx = Qx + K^T Quk + K^T Qu + Qux^T k; Vxx = sym(Qxx + K^T (Quu K) +
  // K^T Qux + Qux^T K), each thread forming both (i, j) and (j, i)
  const R k0 = kg[0], k1 = kg[1];
  const R quk0 = R(Quu[0]) * k0 + R(Quu[1]) * k1;
  const R quk1 = R(Quu[2]) * k0 + R(Quu[3]) * k1;
  for (int e = g.tid; e < 42; e += g.G) {
    if (e < 36) {
      const int i = e / 6, j = e % 6;
      R q[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? j : i, c = h ? i : j;
        const R quuk0 = R(Quu[0]) * R(Kg[c]) + R(Quu[1]) * R(Kg[6 + c]);
        const R quuk1 = R(Quu[2]) * R(Kg[c]) + R(Quu[3]) * R(Kg[6 + c]);
        const R t1 = R(Kg[r]) * quuk0 + R(Kg[6 + r]) * quuk1;
        const R t2 = R(Kg[r]) * R(Qux[c]) + R(Kg[6 + r]) * R(Qux[6 + c]);
        const R t3 = R(Qux[r]) * R(Kg[c]) + R(Qux[6 + r]) * R(Kg[6 + c]);
        q[h] = R(Qxx[r * 6 + c]) + t1 + t2 + t3;
      }
      Vxx[e] = (R(T(0.5)) * (q[0] + q[1])).v;
    } else {
      const int i = e - 36;
      const R t1 = R(Kg[i]) * quk0 + R(Kg[6 + i]) * quk1;
      const R t2 = R(Kg[i]) * R(Qu[0]) + R(Kg[6 + i]) * R(Qu[1]);
      const R t3 = R(Qux[i]) * k0 + R(Qux[6 + i]) * k1;
      Vx[i] = (R(Qx[i]) + t1 + t2 + t3).v;
    }
  }
  if (acc) {
    dV0 = dV0 + (k0 * R(Qu[0]) + k1 * R(Qu[1]));
    dV1 = dV1 + R(T(0.5)) * (k0 * quk0 + k1 * quk1);
    // gnorm accumulator: max over the controls of |k| / (|u| + 1)
    const R g0 = r_abs(k0) / (r_abs(R(s[KS_U + 0])) + one);
    const R g1 = r_abs(k1) / (r_abs(R(s[KS_U + 1])) + one);
    gacc = gacc + r_max(g0, g1);
  }
  g.sync();
}

// The backward pass of trajectory tr over the group: the knots' Jacobians
// and cost derivatives G at a time (one knot a thread) into chunk, then the
// Riccati steps over them. Writes the gains; returns dV0, dV1 and gnorm to
// every thread of the group.
template <typename T>
__device__ void backward(const MegaArgs<T>& p, const Group& g, size_t b,
                         const T* tr, const T* tab, const int* sel, T* rs,
                         T* chunk, T* gains, Rn<T> lam, Rn<T>& dV0,
                         Rn<T>& dV1, Rn<T>& gnorm) {
  using R = Rn<T>;
  const int N = p.N, Tn = N - 1;
  const R zero(T(0));
  const bool acc = g.tid == g.G - 1;   // a thread with few Riccati entries
  R a0 = zero, a1 = zero, ga = zero;
  for (int hi = Tn; hi >= 0; hi -= g.G) {
    const int lo = max(0, hi - g.G + 1);
    const int t = hi - g.tid;
    if (t >= lo) {
      T* s = chunk + g.tid * kKnotVals;
      R x[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = tr[t * 6 + i];
      const bool has_u = t < Tn;
      const R u0 = has_u ? R(tr[N * 6 + t * 2 + 0]) : zero;
      const R u1 = has_u ? R(tr[N * 6 + t * 2 + 1]) : zero;
      R Jx[6], hc[9], Ju[2], Hu[2];
      knot_derivs(p, tab, sel + t * 2 * p.D, b, t, x, has_u, u0, u1, Jx, hc,
                  Ju, Hu);
#pragma unroll
      for (int i = 0; i < 6; ++i) s[KS_JX + i] = Jx[i].v;
#pragma unroll
      for (int i = 0; i < 9; ++i) s[KS_HC + i] = hc[i].v;
      if (has_u) {
        R a[11], b21;
        jacobian(p, x, u1, a, b21);
#pragma unroll
        for (int i = 0; i < 11; ++i) s[KS_A + i] = a[i].v;
        s[KS_B21] = b21.v;
        s[KS_JU + 0] = Ju[0].v;
        s[KS_JU + 1] = Ju[1].v;
        s[KS_HU + 0] = Hu[0].v;
        s[KS_HU + 1] = Hu[1].v;
        s[KS_U + 0] = u0.v;
        s[KS_U + 1] = u1.v;
      }
    }
    g.sync();
    for (int t2 = hi; t2 >= lo; --t2) {
      const T* s = chunk + (hi - t2) * kKnotVals;
      if (t2 == Tn) {   // the terminal knot starts the value function
        for (int e = g.tid; e < 42; e += g.G) {
          if (e < 36)
            rs[RS_VXX + e] = hx_at(s + KS_HC, e / 6, e % 6).v;
          else
            rs[RS_VX + e - 36] = s[KS_JX + e - 36];
        }
        g.sync();
      } else {
        riccati_step(p, g, t2, s, rs, gains, lam, acc, a0, a1, ga);
      }
    }
  }
  if (acc) {
    rs[RS_BC + 4] = a0.v;
    rs[RS_BC + 5] = a1.v;
    rs[RS_BC + 6] = (ga * K(INV_T)).v;
  }
  g.sync();
  dV0 = rs[RS_BC + 4];
  dV1 = rs[RS_BC + 5];
  gnorm = rs[RS_BC + 6];
}

// The closed-loop RK2 rollout (one thread) from trajectory tr at alpha,
// with the gains: writes the candidate trajectory cand.
template <typename T>
__device__ void rollout(const MegaArgs<T>& p, const T* tr, const T* gains,
                        T* cand, Rn<T> alpha) {
  using R = Rn<T>;
  const int N = p.N, Tn = N - 1;
  R x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) x[i] = tr[i];
  for (int t = 0; t < Tn; ++t) {
    R u[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const T* Kr = gains + (t * 2 + i) * 6;
      R dot = R(Kr[0]) * (x[0] - R(tr[t * 6 + 0]));
#pragma unroll
      for (int j = 1; j < 6; ++j) dot = dot + R(Kr[j]) * (x[j] - R(tr[t * 6 + j]));
      u[i] = R(tr[N * 6 + t * 2 + i]) + dot +
             alpha * R(gains[Tn * 12 + t * 2 + i]);
    }
    u[1] = wrap(u[1], p);
#pragma unroll
    for (int i = 0; i < 6; ++i) cand[t * 6 + i] = x[i].v;
    cand[N * 6 + t * 2 + 0] = u[0].v;
    cand[N * 6 + t * 2 + 1] = u[1].v;
    R f[6], mid[6];
    f_cont(p, x, u[0], u[1], f);
#pragma unroll
    for (int i = 0; i < 6; ++i) mid[i] = x[i] + K(HDT) * f[i];
    f_cont(p, mid, u[0], u[1], f);
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = x[i] + K(DT) * f[i];
    x[2] = wrap(x[2], p);
    x[5] = wrap(x[5], p);
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) cand[Tn * 6 + i] = x[i].v;
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads, 1) mega_kernel(const MegaArgs<T> p) {
  using R = Rn<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int vote[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int blk = blockIdx.x / p.csize;
  const int slot = threadIdx.x / p.G;
  Group g;
  g.G = p.G;
  g.tid = threadIdx.x % p.G;
  g.mask = p.G == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  const int lane_in_block = rank * p.lpc + slot;
  const bool active = lane_in_block < p.block_nb;
  const size_t B = p.B;
  const size_t b = (size_t)blk * p.block_nb + lane_in_block;
  const int N = p.N, Tn = p.N - 1, S = p.S;
  const int TR = N * 6 + Tn * 2, NSD = N * 2 * p.D;
  const R zero(T(0)), one(T(1));

  T* tab = reinterpret_cast<T*>(smem_raw) + (size_t)slot * p.lane_smem;
  T* rs = tab + 14 * S;
  T* un = rs + kRicVals;   // the backward pass's chunk, or the knot costs
  T* traj = p.traj + b * 2 * TR;
  T* gains = p.gains + b * Tn * 14;
  T* lv = p.lv + b * NSD;
  int* sel = p.sel + b * 2 * NSD;

  R cost[5];
  if (active) {
    for (int i = g.tid; i < 14 * S; i += g.G)
      tab[i] = i < 7 * S ? AT(p.laneL, i) : AT(p.laneR, i - 7 * S);
    for (int i = g.tid; i < N * 6; i += g.G) traj[i] = AT(p.xs0, i);
    for (int i = g.tid; i < Tn * 2; i += g.G) traj[N * 6 + i] = AT(p.us0, i);
    g.sync();
    R acc[4];
    cost_eval(p, g, b, traj, tab, un, rs + RS_BC, lv, sel, acc);
    cost[0] = acc[0] + acc[1] + acc[2] + acc[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) cost[i + 1] = acc[i];
  }
  R lam = K(LAMBDA_INIT), dlam = one, dV0 = zero, dV1 = zero;
  bool gnorm_done = false;
  int status = kRunning, it = 0, aidx = 0, lane_trips = 0, relins = 0;
  int cur = 0, trips = 0;

  for (;;) {
    if (active && status == kRunning) {
      ++lane_trips;
      const T* tr = traj + cur * TR;
      T* cand = traj + (1 - cur) * TR;
      // ---- relinearize and run the backward pass, unless this trip
      // retries the last one's at the next alpha
      if (aidx == 0) {
        ++relins;
        R gnorm;
        backward(p, g, b, tr, tab, sel + cur * NSD, rs, un, gains, lam, dV0,
                 dV1, gnorm);
        gnorm_done = gnorm < K(GNORM_MIN) && lam < K(GNORM_LAM);
      }
      if (gnorm_done) {
        status = kGnorm;
        ++it;
        aidx = 0;
      } else {
        // ---- rollout at this trip's alpha, and the candidate's cost
        const R alpha = p.alphas[aidx];
        if (g.tid == 0) rollout(p, tr, gains, cand, alpha);
        g.sync();
        R acc[4];
        cost_eval(p, g, b, cand, tab, un, rs + RS_BC, lv,
                  sel + (1 - cur) * NSD, acc);
        const R ntot = acc[0] + acc[1] + acc[2] + acc[3];

        // ---- accept, lambda and status rules (ilqr_optimizer.cc:201-309)
        const R cost_old = cost[0];
        const R dcost = cost_old - ntot;
        const R expected = -alpha * (dV0 + alpha * dV1);
        const R z = dcost / expected;
        const bool accept = z > K(BETA_MIN) && z < K(BETA_MAX) && dcost > zero;
        const bool full_reject = !accept && aidx == p.n_alpha - 1;
        if (accept) {
          cur = 1 - cur;
          cost[0] = ntot;
#pragma unroll
          for (int i = 0; i < 4; ++i) cost[i + 1] = acc[i];
          const R dlam_acc = r_min(dlam * K(INV_RATIO), K(INV_RATIO));
          lam = lam * dlam_acc * (lam > K(LAMBDA_MIN) ? one : zero);
          dlam = dlam_acc;
          status = dcost < K(ABS_TOL) ? kAbsCost
                   : dcost / cost_old < K(REL_TOL) ? kRelCost : kRunning;
        } else if (full_reject) {
          const R dlam_rej = r_max(dlam * K(RATIO), K(RATIO));
          lam = r_max(lam * dlam_rej, K(LAMBDA_MIN));
          dlam = dlam_rej;
          status = lam > K(LAMBDA_MAX) ? kLambdaMax : kRunning;
        }
        if (accept || full_reject) {
          ++it;
          aidx = 0;
        } else {
          ++aidx;
        }
      }
    }
    // ---- exit vote over the cluster: the block runs on while any lane is
    // RUNNING below the cap
    ++trips;
    const bool still = active && status == kRunning && it < p.max_iter;
    const int cta_any = __syncthreads_or(still);
    if (threadIdx.x == 0) vote[trips & 1] = cta_any;
    cluster.sync();
    const bool any = __syncthreads_or(
        threadIdx.x < p.csize &&
        *cluster.map_shared_rank(&vote[trips & 1], threadIdx.x) != 0);
    if (!any) break;
  }
  cluster.sync();   // no CTA leaves while a peer may still read its votes

  if (active) {
    const T* tr = traj + cur * TR;
    for (int i = g.tid; i < N * 6; i += g.G) AT(p.xs, i) = tr[i];
    for (int i = g.tid; i < Tn * 2; i += g.G) AT(p.us, i) = tr[N * 6 + i];
    if (g.tid == 0) {
#pragma unroll
      for (int i = 0; i < 5; ++i) AT(p.fs, i) = cost[i].v;
      AT(p.fs, 5) = lam.v;
      AT(p.is, 0) = status == kRunning ? kMaxIter : status;
      AT(p.is, 1) = it;
      AT(p.is, 2) = lane_trips;
      AT(p.is, 3) = relins;
    }
  }
  if (rank == 0 && threadIdx.x == 0) p.block_trips[blk] = trips;
}

#undef K
#undef AT

// The launch shape of an exit block of block_nb lanes: threads per lane,
// lanes per CTA, CTAs per cluster, and shared memory per lane (values).
template <typename T>
void shape(int N, int S, int block_nb, MegaArgs<T>& p) {
  p.G = block_nb <= 128 ? 32 : 16;
  p.lpc = std::min(block_nb, kCtaThreads / p.G);
  p.csize = (block_nb + p.lpc - 1) / p.lpc;
  p.lane_smem = 14 * S + kRicVals + std::max(p.G * kKnotVals, 4 * N);
}

// The launch configuration of p (cluster dimension attribute in attr), with
// the kernel's attributes set; returns a CUDA error code.
template <typename T>
int configure(const MegaArgs<T>& p, int n_blocks, cudaStream_t stream,
              cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  const size_t smem = (size_t)p.lpc * p.lane_smem * sizeof(T);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaFuncSetAttribute(mega_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err == cudaSuccess && p.csize > 8)
    err = cudaFuncSetAttribute(mega_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(n_blocks * p.csize);
  cfg.blockDim = dim3(p.lpc * p.G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return 0;
}

template <typename T>
int launch(int N, int B, int KC, int S, int D, int n_alpha, int max_iter,
           int block_nb, const double* cst, const double* offs,
           const double* alphas, void* const* ptrs, void* stream) {
  if (block_nb < 1 || block_nb > kMaxBlock || B % block_nb != 0 || D < 1 ||
      D > kMaxDiscs || n_alpha < 1 || n_alpha > kMaxAlphas || N < 2 ||
      S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MegaArgs<T> p;
  p.N = N;
  p.B = B;
  p.KC = KC;
  p.S = S;
  p.D = D;
  p.n_alpha = n_alpha;
  p.max_iter = max_iter;
  p.block_nb = block_nb;
  shape(N, S, block_nb, p);
  for (int i = 0; i < kNumConst; ++i) p.c[i] = T(cst[i]);
  for (int i = 0; i < kMaxDiscs; ++i) p.offs[i] = T(i < D ? offs[i] : 0.0);
  for (int i = 0; i < kMaxAlphas; ++i)
    p.alphas[i] = T(i < n_alpha ? alphas[i] : 0.0);
  const T* const* in = reinterpret_cast<const T* const*>(ptrs);
  p.goals = in[0];
  p.xs0 = in[1];
  p.us0 = in[2];
  p.ca = in[3];
  p.cb = in[4];
  p.cc = in[5];
  p.laneL = in[6];
  p.laneR = in[7];
  p.xs = static_cast<T*>(ptrs[8]);
  p.us = static_cast<T*>(ptrs[9]);
  p.fs = static_cast<T*>(ptrs[10]);
  p.is = static_cast<int*>(ptrs[11]);
  p.block_trips = static_cast<int*>(ptrs[12]);
  p.traj = static_cast<T*>(ptrs[13]);
  p.gains = static_cast<T*>(ptrs[14]);
  p.lv = static_cast<T*>(ptrs[15]);
  p.sel = static_cast<int*>(ptrs[16]);
  static_assert(kPtrs == 17, "pointer count");
  static_assert(kMaxBlock <= kMaxCluster * kCtaThreads / 16, "block fits");
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int err = configure(p, B / block_nb, static_cast<cudaStream_t>(stream), cfg,
                      attr);
  if (err) return err;
  // a cluster that cannot be scheduled is an error, not a slower fallback
  int clusters = 0;
  err = static_cast<int>(
      cudaOccupancyMaxActiveClusters(&clusters, mega_kernel<T>, &cfg));
  if (err) return err;
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, mega_kernel<T>, p));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of block_nb lanes the card runs at once, into *out.
template <typename T>
int active_clusters(int N, int S, int block_nb, int* out) {
  if (block_nb < 1 || block_nb > kMaxBlock || N < 2 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  MegaArgs<T> p;
  p.N = N;
  p.S = S;
  p.block_nb = block_nb;
  shape(N, S, block_nb, p);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const int err = configure(p, 1, nullptr, cfg, attr);
  if (err) return err;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, mega_kernel<T>, &cfg));
}

}  // namespace
}  // namespace cilqr

extern "C" {

int solve_batch_mega_f32(int N, int B, int KC, int S, int D, int n_alpha,
                         int max_iter, int block_nb, const double* cst,
                         const double* offs, const double* alphas,
                         void* const* ptrs, void* stream) {
  return cilqr::launch<float>(N, B, KC, S, D, n_alpha, max_iter, block_nb,
                              cst, offs, alphas, ptrs, stream);
}

int solve_batch_mega_f64(int N, int B, int KC, int S, int D, int n_alpha,
                         int max_iter, int block_nb, const double* cst,
                         const double* offs, const double* alphas,
                         void* const* ptrs, void* stream) {
  return cilqr::launch<double>(N, B, KC, S, D, n_alpha, max_iter, block_nb,
                               cst, offs, alphas, ptrs, stream);
}

int mega_active_clusters_f32(int N, int S, int block_nb, int* out) {
  return cilqr::active_clusters<float>(N, S, block_nb, out);
}

int mega_active_clusters_f64(int N, int S, int block_nb, int* out) {
  return cilqr::active_clusters<double>(N, S, block_nb, out);
}

}  // extern "C"
