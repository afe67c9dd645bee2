// Full-solve megakernel: the whole serial-line-search CILQR loop of a block
// of lanes in one launch.
//
// Replaces the Pallas TPU kernel
// cilqr_tpu/pallas/megasolve.py::solve_batch_mega (_mega_kernel). What it
// computes follows that kernel: the initial cost; then trips of analytic
// midpoint Jacobians, cost derivatives over a full scan of the lane
// segments (first index wins ties), a regularized Riccati backward pass, one
// closed-loop RK2 rollout at the lane's current alpha, the candidate's cost,
// and the accept, lambda and status rules with dcost = cost_old - cost_new;
// RUNNING becomes MAX_ITER at the end. The loop exits per block: a block
// runs while any of its lanes is RUNNING below max_iter, and every RUNNING
// lane of a running block takes the trip (__syncthreads_or), so a lane can
// overrun the cap as it does in the Pallas kernel. The plain PyTorch version
// is cilqr_tpu_torch/kernels/megasolve.py::solve_batch_mega_ref.
//
// Exactness: every arithmetic operation goes through Rn<T>, whose operators
// are the explicitly rounded intrinsics (no FMA contraction), in the order of
// the plain version's separately rounded PyTorch operations; sums run in one
// fixed order (knots, then planes x discs, then discs x sides); divisions by
// a constant are multiplications by a reciprocal formed in double precision
// (PyTorch on the card divides a tensor by a Python scalar that way, so the
// plain version can only match a kernel that does too: hence `wrap` here
// rather than common.cuh's wrap_angle); the transcendentals are the accurate
// ones PyTorch calls. So the kernel and its plain version take the same
// accept decisions, which are chaotic at their thresholds, instead of
// drifting apart by round-off.
//
// Design: one thread per lane, block_nb lanes a block. Per-lane state (lam,
// dlam, status, iterations, alpha index, the five cost rows) and all of one
// knot's algebra (Vx, Vxx, the 6x6 Jacobian, the Q blocks) live in
// registers. The Jacobians and cost derivatives of knot t are computed where
// the backward pass reaches t, and the candidate's cost where the rollout
// reaches t, so only the gains Ks, ks and the candidate trajectory go to
// scratch in device memory (~1.8k values a lane, lane-minor so that a warp
// reads 32 adjacent addresses; 7 MB at B=1024 in float, resident in L2).
//
// What bounds it: operations. A lane-trip here is ~2.25 M operations, 69%
// of them the nearest-segment scans (81 knots x 2 sides x S segments x D
// discs, twice a trip), against ~25 KB a lane of inputs and outputs read and
// written once. Not all of that is needed: a trip that retries at the next
// alpha has the same xs, us and lam as the trip before, yet relinearizes and
// runs the backward pass again, and the derivatives' lane scan repeats the
// selection the cost of the same trajectory made. The work these inputs
// need (counted in chip_smoke.py) is the rollout and candidate cost, ~0.93 M
// operations, on every trip and the rest only once per concluded trip;
// caching the gains across retries is a lever. The grid is B / block_nb blocks
// of one thread per lane: 8 blocks of 128 at B=1024 fill 8 of the H100's
// 132 SMs. Splitting a lane's scans over a warp is the lever for a later
// change; smaller blocks are not, since the exit per block makes block_nb
// part of the result.

#include "common.cuh"

namespace cilqr {
namespace {

constexpr int kMaxBlock = 256;   // kernels/megasolve.py: MAX_BLOCK
constexpr int kMaxDiscs = 8;     // kernels/megasolve.py: MAX_DISCS
constexpr int kMaxAlphas = 16;   // kernels/megasolve.py: MAX_ALPHAS
constexpr int kPtrs = 17;        // device pointers handed over by the wrapper

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

// A value whose arithmetic is rounded after every operation.
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

template <typename T>
struct MegaArgs {
  int N, B, KC, S, D, n_alpha, max_iter;
  T c[kNumConst];
  T offs[kMaxDiscs];
  T alphas[kMaxAlphas];
  // inputs, batch-last: goals, xs0 [N,6,B]; us0 [T,2,B]; ca, cb, cc
  // [N,KC,B]; laneL, laneR [7,S,B] (rows a, b, c, x1, y1, x2, y2)
  const T *goals, *xs0, *us0, *ca, *cb, *cc, *laneL, *laneR;
  // outputs: xs [N,6,B]; us [T,2,B]; fs [6,B] (cost rows, lam); is [3,B]
  // (status, iterations, RUNNING trips); block_trips [B/block_nb]
  T *xs, *us, *fs;
  int *is, *block_trips;
  // scratch: Ks [T,2,6,B]; ks [T,2,B]; candidate cxs [N,6,B], cus [T,2,B]
  T *Ks, *ks, *cxs, *cus;
};

// element (i0, i1, ...) of a batch-last tensor, lane b
#define AT(ptr, flat) (ptr)[(size_t)(flat) * B + b]
#define K(name) R(p.c[C_##name])

template <typename T>
__device__ __forceinline__ Rn<T> wrap(Rn<T> x, const MegaArgs<T>& p) {
  using R = Rn<T>;
  return x - r_floor((x + K(PI)) * K(INV_TWO_PI)) * K(TWO_PI);
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

// Nearest segment of one lane side for the D disc centres: a full scan with
// a strict running minimum seeded with segment 0 (the first index wins ties,
// and a NaN distance at segment 0 keeps it, as in the Pallas kernel); writes
// the selected planes (a, b, c).
template <typename T>
__device__ void select_lane(const MegaArgs<T>& p, const T* lane, size_t b,
                            const Rn<T>* cx, const Rn<T>* cy, Rn<T>* sa,
                            Rn<T>* sb, Rn<T>* sc) {
  using R = Rn<T>;
  const size_t B = p.B;
  const int S = p.S;
  const R zero(T(0)), one(T(1));
  R best[kMaxDiscs];
  int idx[kMaxDiscs];
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d) {
    best[d] = R(infinity<T>());
    idx[d] = 0;
  }
  for (int s = 0; s < S; ++s) {
    const R x1 = AT(lane, 3 * S + s), y1 = AT(lane, 4 * S + s);
    const R x2 = AT(lane, 5 * S + s), y2 = AT(lane, 6 * S + s);
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
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d) {
    if (d < p.D) {
      sa[d] = R(AT(lane, 0 * S + idx[d]));
      sb[d] = R(AT(lane, 1 * S + idx[d]));
      sc[d] = R(AT(lane, 2 * S + idx[d]));
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

// Cost components of knot n (target, dynamic, corridor, lane) added to acc.
template <typename T>
__device__ void knot_value(const MegaArgs<T>& p, size_t b, int n,
                           const Rn<T>* x, bool has_u, Rn<T> u0, Rn<T> u1,
                           Rn<T>* acc) {
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
  R sa[2][kMaxDiscs], sb[2][kMaxDiscs], sc[2][kMaxDiscs];
  select_lane(p, p.laneL, b, cx, cy, sa[0], sb[0], sc[0]);
  select_lane(p, p.laneR, b, cx, cy, sa[1], sb[1], sc[1]);
  R lk(T(0));
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d)
    if (d < p.D)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        lk = lk + bar_value(sa[s][d] * cx[d] + sb[s][d] * cy[d] - sc[s][d], p);
  acc[0] = acc[0] + tk;
  acc[1] = acc[1] + dk;
  acc[2] = acc[2] + ck;
  acc[3] = acc[3] + lk;
}

// Cost Jacobian and Hessian of knot n: Jx[6]; the Hessian's nine structural
// entries hc = (h00, h01, h02, h11, h12, h22, h33, h44, h55); with has_u,
// Ju[2] and the control Hessian's diagonal Hu[2].
template <typename T>
__device__ void knot_derivs(const MegaArgs<T>& p, size_t b, int n,
                            const Rn<T>* x, bool has_u, Rn<T> u0, Rn<T> u1,
                            Rn<T>* Jx, Rn<T>* hc, Rn<T>* Ju, Rn<T>* Hu) {
  using R = Rn<T>;
  const size_t B = p.B;
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
  R sa[2][kMaxDiscs], sb[2][kMaxDiscs], sc[2][kMaxDiscs];
  select_lane(p, p.laneL, b, cx, cy, sa[0], sb[0], sc[0]);
  select_lane(p, p.laneR, b, cx, cy, sa[1], sb[1], sc[1]);
#pragma unroll
  for (int d = 0; d < kMaxDiscs; ++d) {
    if (d < p.D) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const R la = sa[s][d], lb = sb[s][d];
        const R lg = la * cx[d] + lb * cy[d] - sc[s][d];
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

// entry (i, j) of the 6x6 state Hessian from its structural entries
template <typename T>
__device__ __forceinline__ Rn<T> hx_at(const Rn<T>* hc, int i, int j) {
  if (i > j) { const int t = i; i = j; j = t; }
  if (i == 0) return j == 0 ? hc[0] : j == 1 ? hc[1] : j == 2 ? hc[2] : Rn<T>(T(0));
  if (i == 1) return j == 1 ? hc[3] : j == 2 ? hc[4] : Rn<T>(T(0));
  if (i == 2) return j == 2 ? hc[5] : Rn<T>(T(0));
  return i == j ? hc[3 + i] : Rn<T>(T(0));
}

// Analytic midpoint Jacobians of one step (vehicle_model.cc:44-86, with its
// v-vs-v_mid quirk) at state x and steering rate dr.
template <typename T>
__device__ __forceinline__ void jacobian(const MegaArgs<T>& p, const Rn<T>* x,
                                         Rn<T> dr, Rn<T> (&A)[6][6],
                                         Rn<T> (&Bm)[6][2]) {
  using R = Rn<T>;
  const R zero(T(0)), one(T(1));
  const R v = x[3];
  const R theta = wrap(x[2], p);
  const R delta = wrap(x[5], p);
  const R a = x[4];
  const R tan_delta = r_tan(delta);
  const R theta_mid = theta + K(HDT) * v * tan_delta * K(INV_L);
  const R tan_dr = r_tan(delta + K(HDT) * dr);
  const R cos_tm = r_cos(theta_mid);
  const R sin_tm = r_sin(theta_mid);
  const R td2 = tan_delta * tan_delta;
  const R tdr2 = tan_dr * tan_dr;
  const R v_mid = R(T(0.5)) * a * K(DT) + v;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = i == j ? one : zero;
    Bm[i][0] = zero;
    Bm[i][1] = zero;
  }
  A[0][2] = K(NEG_DT) * v_mid * sin_tm;
  A[0][3] = K(DT) * cos_tm - K(HDT2) * v_mid * sin_tm * tan_delta * K(INV_L);
  A[0][4] = K(HDT2) * cos_tm;
  A[0][5] = -K(HDT2) * v * v_mid * (td2 + one) * sin_tm * K(INV_L);
  A[1][2] = K(DT) * v_mid * cos_tm;
  A[1][3] = K(DT) * sin_tm + K(HDT2) * v_mid * cos_tm * tan_delta * K(INV_L);
  A[1][4] = K(HDT2) * sin_tm;
  A[1][5] = K(HDT2) * v * v_mid * (td2 + one) * cos_tm * K(INV_L);
  A[2][3] = K(DT) * tan_dr * K(INV_L);
  A[2][4] = K(HDT2) * tan_dr * K(INV_L);
  A[2][5] = K(DT) * v * (tdr2 + one) * K(INV_L);
  A[3][4] = K(DT);
  Bm[2][1] = K(HDT2) * v * (tdr2 + one) * K(INV_L);
  Bm[3][0] = K(HDT2);
  Bm[4][0] = K(DT);
  Bm[5][1] = K(DT);
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

// One Riccati step at knot t (ilqr_optimizer.cc:334-390): updates Vx, Vxx
// and the dV / gnorm accumulators, and stores the gains K, k of step t.
template <typename T>
__device__ void riccati_step(const MegaArgs<T>& p, size_t b, int t,
                             const Rn<T>* x, const Rn<T>* u, Rn<T> lam,
                             Rn<T> (&Vx)[6], Rn<T> (&Vxx)[6][6], Rn<T>& dV0,
                             Rn<T>& dV1, Rn<T>& gacc) {
  using R = Rn<T>;
  const size_t B = p.B;
  const R zero(T(0)), one(T(1));
  R Jx[6], hc[9], Ju[2], Hu[2];
  knot_derivs(p, b, t, x, true, u[0], u[1], Jx, hc, Ju, Hu);
  R A[6][6], Bm[6][2];
  jacobian(p, x, u[1], A, Bm);

  R Qx[6], Qu[2];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    R acc = A[0][i] * Vx[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = acc + A[k][i] * Vx[k];
    Qx[i] = Jx[i] + acc;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    R acc = Bm[0][i] * Vx[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc = acc + Bm[k][i] * Vx[k];
    Qu[i] = Ju[i] + acc;
  }
  // Qxx = Hx + (A^T Vxx) A, A^T Vxx formed row by row
  R Qxx[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    R AtV[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      R acc = A[0][i] * Vxx[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + A[k][i] * Vxx[k][j];
      AtV[j] = acc;
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      R acc = AtV[0] * A[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + AtV[k] * A[k][j];
      Qxx[i][j] = hx_at(hc, i, j) + acc;
    }
  }
  // BtV = B^T Vxx; Quu = Hu + BtV B; Qux = BtV A
  R BtV[2][6];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      R acc = Bm[0][i] * Vxx[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + Bm[k][i] * Vxx[k][j];
      BtV[i][j] = acc;
    }
  R Quu[2][2], Qux[2][6];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      R acc = BtV[i][0] * Bm[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + BtV[i][k] * Bm[k][j];
      Quu[i][j] = (i == j ? Hu[i] : zero) + acc;
    }
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      R acc = BtV[i][0] * A[0][j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc = acc + BtV[i][k] * A[k][j];
      Qux[i][j] = acc;
    }
  }
  // closed-form inverse of Quu + lam I
  const R ma = Quu[0][0] + lam, mb = Quu[0][1];
  const R mc = Quu[1][0], md = Quu[1][1] + lam;
  const R inv_det = one / (ma * md - mb * mc);
  const R Qi[2][2] = {{md * inv_det, -mb * inv_det},
                      {-mc * inv_det, ma * inv_det}};
  R Kg[2][6], kg[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Kg[i][j] = -(Qi[i][0] * Qux[0][j] + Qi[i][1] * Qux[1][j]);
      AT(p.Ks, (t * 2 + i) * 6 + j) = Kg[i][j].v;
    }
    kg[i] = -(Qi[i][0] * Qu[0] + Qi[i][1] * Qu[1]);
    AT(p.ks, t * 2 + i) = kg[i].v;
  }
  R Quk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) Quk[i] = Quu[i][0] * kg[0] + Quu[i][1] * kg[1];
  // Vx = Qx + K^T Quk + K^T Qu + Qux^T k
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const R t1 = Kg[0][i] * Quk[0] + Kg[1][i] * Quk[1];
    const R t2 = Kg[0][i] * Qu[0] + Kg[1][i] * Qu[1];
    const R t3 = Qux[0][i] * kg[0] + Qux[1][i] * kg[1];
    Vx[i] = Qx[i] + t1 + t2 + t3;
  }
  // Vxx = Qxx + K^T (Quu K) + K^T Qux + Qux^T K, then symmetrized
  R QuuK[2][6];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      QuuK[i][j] = Quu[i][0] * Kg[0][j] + Quu[i][1] * Kg[1][j];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const R t1 = Kg[0][i] * QuuK[0][j] + Kg[1][i] * QuuK[1][j];
      const R t2 = Kg[0][i] * Qux[0][j] + Kg[1][i] * Qux[1][j];
      const R t3 = Qux[0][i] * Kg[0][j] + Qux[1][i] * Kg[1][j];
      Qxx[i][j] = Qxx[i][j] + t1 + t2 + t3;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Vxx[i][j] = R(T(0.5)) * (Qxx[i][j] + Qxx[j][i]);
  dV0 = dV0 + (kg[0] * Qu[0] + kg[1] * Qu[1]);
  dV1 = dV1 + R(T(0.5)) * (kg[0] * Quk[0] + kg[1] * Quk[1]);
  // gnorm accumulator: max over the controls of |k| / (|u| + 1)
  const R g0 = r_abs(kg[0]) / (r_abs(u[0]) + one);
  const R g1 = r_abs(kg[1]) / (r_abs(u[1]) + one);
  gacc = gacc + r_max(g0, g1);
}

template <typename T>
__global__ void __launch_bounds__(kMaxBlock) mega_kernel(const MegaArgs<T> p) {
  using R = Rn<T>;
  const size_t B = p.B;
  const size_t b = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int N = p.N, Tn = p.N - 1;
  const R zero(T(0)), one(T(1));

  for (int i = 0; i < N * 6; ++i) AT(p.xs, i) = AT(p.xs0, i);
  for (int i = 0; i < Tn * 2; ++i) AT(p.us, i) = AT(p.us0, i);

  // initial cost, knot by knot
  R cost[5];
  {
    R acc[4] = {zero, zero, zero, zero};
    for (int t = 0; t < N; ++t) {
      R x[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = AT(p.xs, t * 6 + i);
      const bool has_u = t < Tn;
      const R u0 = has_u ? R(AT(p.us, t * 2 + 0)) : zero;
      const R u1 = has_u ? R(AT(p.us, t * 2 + 1)) : zero;
      knot_value(p, b, t, x, has_u, u0, u1, acc);
    }
    cost[0] = acc[0] + acc[1] + acc[2] + acc[3];
#pragma unroll
    for (int i = 0; i < 4; ++i) cost[i + 1] = acc[i];
  }
  R lam = K(LAMBDA_INIT), dlam = one;
  int status = kRunning, it = 0, aidx = 0, lane_trips = 0, trips = 0;

  for (;;) {
    if (status == kRunning) {
      ++lane_trips;
      // ---- backward pass, relinearizing knot by knot
      R Vx[6], Vxx[6][6];
      {
        R x[6], hc[9], Ju[2], Hu[2];
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = AT(p.xs, Tn * 6 + i);
        knot_derivs(p, b, Tn, x, false, zero, zero, Vx, hc, Ju, Hu);
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = 0; j < 6; ++j) Vxx[i][j] = hx_at(hc, i, j);
      }
      R dV0 = zero, dV1 = zero, gacc = zero;
      for (int t = Tn - 1; t >= 0; --t) {
        R x[6], u[2];
#pragma unroll
        for (int i = 0; i < 6; ++i) x[i] = AT(p.xs, t * 6 + i);
        u[0] = AT(p.us, t * 2 + 0);
        u[1] = AT(p.us, t * 2 + 1);
        riccati_step(p, b, t, x, u, lam, Vx, Vxx, dV0, dV1, gacc);
      }
      const R gnorm = gacc * K(INV_T);
      const bool gnorm_done = gnorm < K(GNORM_MIN) && lam < K(GNORM_LAM);

      // ---- rollout at this trip's alpha, with the candidate's cost
      const R alpha = p.alphas[aidx];
      R acc[4] = {zero, zero, zero, zero};
      R x[6];
#pragma unroll
      for (int i = 0; i < 6; ++i) x[i] = AT(p.xs, i);
      for (int t = 0; t < Tn; ++t) {
        R u[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          R dot = R(AT(p.Ks, (t * 2 + i) * 6 + 0)) * (x[0] - R(AT(p.xs, t * 6 + 0)));
#pragma unroll
          for (int j = 1; j < 6; ++j)
            dot = dot + R(AT(p.Ks, (t * 2 + i) * 6 + j)) * (x[j] - R(AT(p.xs, t * 6 + j)));
          u[i] = R(AT(p.us, t * 2 + i)) + dot + alpha * R(AT(p.ks, t * 2 + i));
        }
        u[1] = wrap(u[1], p);
#pragma unroll
        for (int i = 0; i < 6; ++i) AT(p.cxs, t * 6 + i) = x[i].v;
        AT(p.cus, t * 2 + 0) = u[0].v;
        AT(p.cus, t * 2 + 1) = u[1].v;
        knot_value(p, b, t, x, true, u[0], u[1], acc);
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
      for (int i = 0; i < 6; ++i) AT(p.cxs, Tn * 6 + i) = x[i].v;
      knot_value(p, b, Tn, x, false, zero, zero, acc);
      const R ntot = acc[0] + acc[1] + acc[2] + acc[3];

      // ---- accept, lambda and status rules (ilqr_optimizer.cc:201-309)
      const R cost_old = cost[0];
      const R dcost = cost_old - ntot;
      const R expected = -alpha * (dV0 + alpha * dV1);
      const R z = dcost / expected;
      const bool accept = z > K(BETA_MIN) && z < K(BETA_MAX) && dcost > zero;
      const bool full_reject = !accept && aidx == p.n_alpha - 1;
      if (gnorm_done) {
        status = kGnorm;
      } else if (accept) {
        for (int i = 0; i < N * 6; ++i) AT(p.xs, i) = AT(p.cxs, i);
        for (int i = 0; i < Tn * 2; ++i) AT(p.us, i) = AT(p.cus, i);
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
      if (gnorm_done || accept || full_reject) {
        ++it;
        aidx = 0;
      } else {
        ++aidx;
      }
    }
    ++trips;
    const bool still = status == kRunning && it < p.max_iter;
    if (!__syncthreads_or(still)) break;
  }

  AT(p.fs, 0) = cost[0].v;
  AT(p.fs, 1) = cost[1].v;
  AT(p.fs, 2) = cost[2].v;
  AT(p.fs, 3) = cost[3].v;
  AT(p.fs, 4) = cost[4].v;
  AT(p.fs, 5) = lam.v;
  AT(p.is, 0) = status == kRunning ? kMaxIter : status;
  AT(p.is, 1) = it;
  AT(p.is, 2) = lane_trips;
  if (threadIdx.x == 0) p.block_trips[blockIdx.x] = trips;
}

#undef K
#undef AT

template <typename T>
int launch(int N, int B, int KC, int S, int D, int n_alpha, int max_iter,
           int block_nb, const double* cst, const double* offs,
           const double* alphas, void* const* ptrs, void* stream) {
  if (block_nb < 1 || block_nb > kMaxBlock || B % block_nb != 0 || D < 1 ||
      D > kMaxDiscs || n_alpha < 1 || n_alpha > kMaxAlphas || N < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  MegaArgs<T> p;
  p.N = N;
  p.B = B;
  p.KC = KC;
  p.S = S;
  p.D = D;
  p.n_alpha = n_alpha;
  p.max_iter = max_iter;
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
  p.Ks = static_cast<T*>(ptrs[13]);
  p.ks = static_cast<T*>(ptrs[14]);
  p.cxs = static_cast<T*>(ptrs[15]);
  p.cus = static_cast<T*>(ptrs[16]);
  static_assert(kPtrs == 17, "pointer count");
  mega_kernel<T><<<B / block_nb, block_nb, 0,
                   static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
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

}  // extern "C"
