// The DP coarse search's layer sweep (DpPlanner::Plan, dp_planner.cpp:
// 135-206): for every scenario of a batch, the first layer from the start
// pseudo-cell and the NT-1 non-Markov transitions, each child's cost and
// its argmin over parents. The traceback and the 81-knot profile stay in
// PyTorch (dp.py: _trace_back).
//
// Replaces no TPU kernel: the JAX package's DP (cilqr_tpu/dp.py) is plain
// XLA, and so is the port's plain path (dp.py: _plan_chunk), which stays
// the CPU path. On the card that path evaluates each transition as
// broadcast tensors, 70 parents x 70 children x 16 points with trailing
// obstacle and road axes, in chunks of scenarios: each step of the probe
// round-trips through device memory, and each chunk repeats the host work.
// This kernel takes the two road tests the replans run: frenet mode with a
// RoadSpec (the finite per-segment test, world.barrier_hit_road_spec) and
// grid mode with the BarrierGrid's dilated table for the probe's half
// (world.barrier_box_hit_dilated). Its station lookup is the plain path's:
// the RoadSpec's closed-form rows wherever a spec is given, grid mode
// included, else the scenario's packed centerline rows. Where each
// scenario is on a road of its own (world.LaneGrid), its CTA reads its own
// road's table out of one pool, by the scenario's offset, H, W and origin,
// and its own count of centerline rows (a shorter road's rows are padded).
//
// Exactness: bit-identical to the plain path on the card. Every operation
// is one of common.cuh's separately rounded ones, in the plain path's
// order, and the transcendentals are the accurate ones PyTorch calls
// (atan, sin, cos; the angle wrap's fmod, as torch.remainder takes it). A
// division by a Python scalar is, as PyTorch on the card computes it, a
// multiplication by the reciprocal formed in the working type (1/unit_time,
// 1/16, 1/17, 1/(NL-2), 1/(rows-1)); a comparison with a Python float
// compares with the float rounded to the working type; the closed-form
// road's one-hot sum over segments is its one term plus zero. The argmin
// over parents scans them in ascending order with a strict <, NaN first:
// torch.argmin's first-index rule. The road test's per-segment constants
// come from the host in float64, computed as barrier_hit_road_spec
// computes them (kernels/dpsweep.py: _spec_barrier).
//
// What bounds it: operations. A full sweep at B=1024 has ~3.2e8
// interpolated points (4 transitions x 4,900 segments x 16 points a
// scenario, and the first layer's), each a station lookup, a heading
// (atan, sin, cos) and two disc probes against the obstacles' slabs and
// the road. The early exit visits ~2.0e8 of them at the pedestrian_test
// replans' inputs, with ~3.8e8 disc probes and, on the RoadSpec, ~2.6e9
// road-segment tests: counted at ~87 / 56 operations a point, ~70 / 82 a
// disc and 10 a segment, ~7.0e10 operations a replan with the RoadSpec
// and ~4.2e10 with the grid, 1.05 / 0.63 ms at the card's 67 TFLOP/s
// (PERF.md §6 has the measured time). Its bytes are small: the inputs
// (~40 MB of dilated slabs at B=1024) are read once into shared memory.
//
// Design:
// - One CTA per scenario, all layers inside it, a barrier between phases.
//   The stored parent indices of the previous layer (the non-Markov
//   grandparent lookups) stay in shared memory, and a scenario's result
//   does not depend on the batch it sits in.
// - A thread per (parent group, child) item: the group's parents in
//   ascending order, each segment's 16 points and two discs stopping at
//   the first hit (an any() does not depend on order), the group's first
//   least total kept; then a thread per child takes the groups in
//   ascending order by the same rule. A group is one parent where the
//   [parents x children] minima fit the CTA's shared memory, as at the
//   default 70 x 70 grid; larger grids take fewer groups of more parents.
// - The static slabs, the current layer's dynamic slabs at its 16 (first
//   layer 17) probe times, the layer's costs, stations and parents, and
//   the groups' minima sit in shared memory; the station table's packed
//   rows and the grid's int8 table are read from global memory through
//   L1/L2. Obstacles too many for a CTA's shared memory fail the launch.
// - A scenario's road (its rows, its table and the table's geometry) is
//   resolved once, at the CTA's start, into registers (Table); a batch on
//   one road and a batch on many take the same instructions after that.

#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace cilqr {
namespace {

// a dilated slab: nx0 nx1 ny0 ny1 lo0 lo1 hi0 hi1 minx miny maxx maxy valid
constexpr int kSlab = 13;
// a packed station row: s x y theta kappa lb rb pad
constexpr int kRow = 8;
// a spec segment's row recipe: xc yc radius ang0 dang yaw0 yaw_inc kappa
// x0 y0 stepx stepy; its integers: row_start count is_arc and the two
// sides' ring-only flags; its road-test constants (kernels/dpsweep.py:
// _spec_barrier)
constexpr int kSegF = 12;
constexpr int kSegI = 5;
constexpr int kBar = 16;
// points of the first layer and of the later ones (dp_planner.cpp:288-296)
constexpr int kNseg0 = 17;
constexpr int kNseg = 16;
constexpr int kThreads = 256;

// station lookup and road test: RoadSpec rows and test; packed rows and
// the grid; RoadSpec rows and the grid
enum Mode { kSpec = 0, kGrid = 1, kGridSpec = 2 };

template <typename T>
struct DpArgs {
  int B, NT, NS, NL, KS, KD, TK;
  int K, Q;                       // parent groups, parents a group
  int n_rows, G;                  // station rows; spec segments
  int span, Hp, Wp, grid_wide;    // grid: span, padded table, wide cells
  // Python floats rounded to T; reciprocals of Python-scalar divisors
  T inv_ut, inv16, inv17, inv_frac, inv_nm1;
  T safe_margin, eps, half, r2x, f2x;
  T w_obs, w_lat, w_lc, w_lvc, w_lvb, w_lvch, nominal;
  T pi, neg_pi, two_pi, tiny;
  T h, lb, rb, kappa0;            // spec
  T cell_t;                       // grid cell in T
  double cell_d;                  // grid cell in double (wide cells)
  // inputs
  const T *s0, *l0, *station;     // [B], [B], [NS]
  const T *sslab, *dslab;         // [B, KS, kSlab], [B, TK, KD, kSlab]
  const T *rows;                  // [B, n_rows, kRow] (packed rows)
  const T *seg_f, *bar;           // [G, kSegF], [G, kBar] (RoadSpec)
  const int *seg_i;               // [G, kSegI]
  const signed char *grid;        // [4, Hp, Wp], or every road's (pool)
  const void *origin;             // [2] or [B, 2] (pool), T or double
  // a road per scenario (null for one road): table offset, H and W
  const long long *lane_off, *lane_hw;   // [B], [B, 2]
  const long long *lane_rows;     // [B] centerline rows (null: n_rows)
  // outputs, [NT, B, NS * NL]
  T *cost, *curs;
  long long *psind, *plind;
};

template <typename T>
struct Ref {
  T x, y, theta, kappa, lb, rb;
};

template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v != v ? v : (v > lo ? v : lo);
}

template <typename T>
__device__ __forceinline__ T clamp_max(T v, T hi) {
  return v != v ? v : (v < hi ? v : hi);
}

__device__ __forceinline__ long long clamp_ll(long long v, long long lo,
                                              long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// geometry.normalize_angle: remainder(x + pi, 2pi) - pi, remainder as
// PyTorch forms it (fmod, then + b where the signs differ)
template <typename T>
__device__ __forceinline__ T norm_angle(const DpArgs<T>& a, T x) {
  T m = fmod(add_rn(x, a.pi), a.two_pi);
  if (m != T(0) && ((a.two_pi < T(0)) != (m < T(0)))) m = add_rn(m, a.two_pi);
  return sub_rn(m, a.pi);
}

// geometry.slerp
template <typename T>
__device__ T slerp(const DpArgs<T>& a, T a0, T t0, T a1, T t1, T t) {
  const T a0n = norm_angle(a, a0);
  const T a1n = norm_angle(a, a1);
  T d = sub_rn(a1n, a0n);
  if (d > a.pi) d = sub_rn(d, a.two_pi);
  if (d < a.neg_pi) d = add_rn(d, a.two_pi);
  const T denom = sub_rn(t1, t0);
  const T r = fabs(denom) <= a.tiny
                  ? T(0)
                  : div_rn(sub_rn(t, t0), denom == T(0) ? T(1) : denom);
  return norm_angle(a, add_rn(a0n, mul_rn(d, r)));
}

// The lerp/slerp between two station rows (reference_line.
// evaluate_station_fields and its closed-form twin); FULL: all six fields,
// else the bounds alone.
template <typename T, bool FULL>
__device__ __forceinline__ Ref<T> between(const DpArgs<T>& a, const Ref<T>& r0,
                                          const Ref<T>& r1, T k0, T k1, T s) {
  const T denom = sub_rn(k1, k0);
  const bool near = fabs(denom) < a.tiny;
  const T w = near ? T(0) : div_rn(sub_rn(s, k0), denom);
  const T omw = sub_rn(T(1), w);
  Ref<T> o;
  o.lb = add_rn(mul_rn(omw, r0.lb), mul_rn(w, r1.lb));
  o.rb = add_rn(mul_rn(omw, r0.rb), mul_rn(w, r1.rb));
  if (FULL) {
    o.x = add_rn(mul_rn(omw, r0.x), mul_rn(w, r1.x));
    o.y = add_rn(mul_rn(omw, r0.y), mul_rn(w, r1.y));
    o.kappa = add_rn(mul_rn(omw, r0.kappa), mul_rn(w, r1.kappa));
    o.theta = slerp(a, r0.theta, k0, r1.theta, k1, near ? k0 : s);
  }
  return o;
}

// The road of a scenario: its station table (no RoadSpec:
// uniform_station_index, then the two packed rows; n its own rows) and its
// dilated grid table (the table, its padded size and its origin).
template <typename T>
struct Table {
  const T* rows;
  T s0, h;
  long long n;
  const signed char* grid;
  long long Hp, Wp;
  const void* origin;
};

template <typename T>
__device__ __forceinline__ Ref<T> table_row(const T* r) {
  Ref<T> o;
  o.x = __ldg(r + 1);
  o.y = __ldg(r + 2);
  o.theta = __ldg(r + 3);
  o.kappa = __ldg(r + 4);
  o.lb = __ldg(r + 5);
  o.rb = __ldg(r + 6);
  return o;
}

template <typename T, bool FULL>
__device__ Ref<T> eval_table(const DpArgs<T>& a, const Table<T>& tb, T s) {
  long long idx = (long long)ceil(div_rn(sub_rn(s, tb.s0), tb.h));
  idx = clamp_ll(idx, 1, tb.n - 1);
  const T* r0 = tb.rows + (idx - 1) * kRow;
  const T* r1 = r0 + kRow;
  return between<T, FULL>(a, table_row(r0), table_row(r1), __ldg(r0),
                          __ldg(r1), s);
}

// reference_line._analytic_row_fields: row i of the closed-form table
template <typename T, bool FULL>
__device__ Ref<T> spec_row(const DpArgs<T>& a, long long i) {
  Ref<T> o;
  o.lb = a.lb;
  o.rb = a.rb;
  if (!FULL) return o;
  o.x = o.y = o.theta = o.kappa = T(0);
  for (int g = 0; g < a.G; ++g) {
    const int* si = a.seg_i + g * kSegI;
    const long long start = __ldg(si);
    if (i < start || i >= start + __ldg(si + 1)) continue;
    const T* f = a.seg_f + g * kSegF;
    const T j = T(i - start + 1);
    T x, y;
    if (__ldg(si + 2)) {
      const T ang = add_rn(__ldg(f + 3), mul_rn(sub_rn(j, T(1)), __ldg(f + 4)));
      x = add_rn(__ldg(f + 0), mul_rn(__ldg(f + 2), T(cos(ang))));
      y = add_rn(__ldg(f + 1), mul_rn(__ldg(f + 2), T(sin(ang))));
    } else {
      x = add_rn(__ldg(f + 8), mul_rn(j, __ldg(f + 10)));
      y = add_rn(__ldg(f + 9), mul_rn(j, __ldg(f + 11)));
    }
    // the one-hot sum: the segment's term plus zeros
    o.x = add_rn(x, T(0));
    o.y = add_rn(y, T(0));
    o.theta = add_rn(add_rn(__ldg(f + 5), mul_rn(j, __ldg(f + 6))), T(0));
    o.kappa = add_rn(__ldg(f + 7), T(0));
    break;
  }
  if (i == 0) {
    o.x = o.y = o.theta = T(0);
    o.kappa = a.kappa0;
  }
  return o;
}

template <typename T, bool FULL>
__device__ Ref<T> eval_spec(const DpArgs<T>& a, T s) {
  long long idx = (long long)ceil(div_rn(s, a.h));
  idx = clamp_ll(idx, 1, a.n_rows - 1);
  return between<T, FULL>(a, spec_row<T, FULL>(a, idx - 1),
                          spec_row<T, FULL>(a, idx), mul_rn(T(idx - 1), a.h),
                          mul_rn(T(idx), a.h), s);
}

template <typename T, bool SROWS, bool FULL>
__device__ __forceinline__ Ref<T> eval(const DpArgs<T>& a, const Table<T>& tb,
                                       T s) {
  if (SROWS) return eval_spec<T, FULL>(a, s);
  return eval_table<T, FULL>(a, tb, s);
}

// GetLateralOffset from the bounds at the station (dp.py: lat_off)
template <typename T>
__device__ __forceinline__ T lat_off(const DpArgs<T>& a, const Ref<T>& f,
                                     int li) {
  const T lb = add_rn(-f.rb, a.safe_margin);
  const T ub = sub_rn(f.lb, a.safe_margin);
  const T frac = mul_rn(T(li), a.inv_frac);
  const T off = add_rn(lb, mul_rn(sub_rn(ub, lb), frac));
  return li == a.NL - 1 ? T(0) : off;
}

// world.point_hits_dilated for one slab
template <typename T>
__device__ __forceinline__ bool slab_hit(const T* d, T cx, T cy) {
  if (d[12] == T(0)) return false;
  const T t0 = add_rn(mul_rn(cx, d[0]), mul_rn(cy, d[2]));
  const T t1 = add_rn(mul_rn(cx, d[1]), mul_rn(cy, d[3]));
  return t0 >= d[4] && t0 <= d[6] && t1 >= d[5] && t1 <= d[7] &&
         cx >= d[8] && cx <= d[10] && cy >= d[9] && cy <= d[11];
}

// world.barrier_hit_road_spec for one box centre
template <typename T>
__device__ bool road_spec_hit(const DpArgs<T>& a, T cx, T cy) {
  for (int g = 0; g < a.G; ++g) {
    const T* c = a.bar + g * kBar;
    const int* si = a.seg_i + g * kSegI;
    if (!__ldg(si + 2)) {
      for (int u = 0; u < 2; ++u) {
        const T* q = c + 8 * u;
        if (cx >= __ldg(q) && cx <= __ldg(q + 1) && cy >= __ldg(q + 2) &&
            cy <= __ldg(q + 3)) {
          const T sv = sub_rn(add_rn(mul_rn(cx, __ldg(q + 4)),
                                     mul_rn(cy, __ldg(q + 5))),
                              __ldg(q + 6));
          if (fabs(sv) <= __ldg(q + 7)) return true;
        }
      }
    } else {
      const T hp = __ldg(c + 2);
      const T adx = sub_rn(cx, __ldg(c));
      const T ady = sub_rn(cy, __ldg(c + 1));
      const T addx = fabs(adx);
      const T addy = fabs(ady);
      const T pdx = clamp_min(sub_rn(addx, hp), T(0));
      const T pdy = clamp_min(sub_rn(addy, hp), T(0));
      const T dmin2 = add_rn(mul_rn(pdx, pdx), mul_rn(pdy, pdy));
      const T sdx = add_rn(addx, hp);
      const T sdy = add_rn(addy, hp);
      const T dmax2 = add_rn(mul_rn(sdx, sdx), mul_rn(sdy, sdy));
      for (int u = 0; u < 2; ++u) {
        const T* q = c + 3 + 4 * u;
        const T rbsq = __ldg(q);
        if (!(dmin2 <= rbsq && rbsq <= dmax2)) continue;
        if (__ldg(si + 3 + u)) return true;
        const T ang =
            add_rn(mul_rn(adx, __ldg(q + 1)), mul_rn(ady, __ldg(q + 2)));
        if (ang >= __ldg(q + 3)) return true;
      }
    }
  }
  return false;
}

// world._cell_index in the type W
template <typename W>
__device__ __forceinline__ long long cell_index(W v, W o, W c) {
  return (long long)floor(div_rn(sub_rn(v, o), c));
}

// world.barrier_box_hit_dilated for the box of half-size a.half at (cx, cy)
template <typename T>
__device__ bool grid_hit(const DpArgs<T>& a, const Table<T>& tb, T cx,
                         T cy) {
  const T minx = sub_rn(cx, a.half);
  const T maxx = add_rn(cx, a.half);
  const T miny = sub_rn(cy, a.half);
  const T maxy = add_rn(cy, a.half);
  long long iy, jx, iy1, jx1;
  if (a.grid_wide) {
    const double* o = static_cast<const double*>(tb.origin);
    iy = cell_index<double>(miny, __ldg(o + 1), a.cell_d);
    jx = cell_index<double>(minx, __ldg(o), a.cell_d);
    iy1 = cell_index<double>(maxy, __ldg(o + 1), a.cell_d);
    jx1 = cell_index<double>(maxx, __ldg(o), a.cell_d);
  } else {
    const T* o = static_cast<const T*>(tb.origin);
    iy = cell_index<T>(miny, __ldg(o + 1), a.cell_t);
    jx = cell_index<T>(minx, __ldg(o), a.cell_t);
    iy1 = cell_index<T>(maxy, __ldg(o + 1), a.cell_t);
    jx1 = cell_index<T>(maxx, __ldg(o), a.cell_t);
  }
  const int off = a.span + 2;
  const long long ga = clamp_ll(iy1 - iy - a.span, 0, 1);
  const long long gb = clamp_ll(jx1 - jx - a.span, 0, 1);
  const long long iyc = clamp_ll(iy + off, 0, tb.Hp - 1);
  const long long jxc = clamp_ll(jx + off, 0, tb.Wp - 1);
  return __ldg(tb.grid + ((ga * 2 + gb) * tb.Hp + iyc) * tb.Wp + jxc) > 0;
}

// One disc's box against the static slabs, the road and the dynamic slabs
// at the point's probe time (world.check_optimization_collision: box_hit)
template <typename T, bool SROAD>
__device__ __forceinline__ bool box_hit(const DpArgs<T>& a,
                                        const Table<T>& tb, const T* sst,
                                        const T* sdyn, T cx, T cy) {
  for (int k = 0; k < a.KS; ++k)
    if (slab_hit(sst + k * kSlab, cx, cy)) return true;
  if (SROAD ? road_spec_hit(a, cx, cy) : grid_hit(a, tb, cx, cy))
    return true;
  for (int k = 0; k < a.KD; ++k)
    if (slab_hit(sdyn + k * kSlab, cx, cy)) return true;
  return false;
}

// One interpolated point against the bounds and the two discs
// (dp.py: _segment_cost, world.check_optimization_collision)
template <typename T, bool SROWS, bool SROAD>
__device__ bool point_bad(const DpArgs<T>& a, const Table<T>& tb,
                          const T* sst, const T* sdyn, T s, T l, T ps, T pl) {
  const Ref<T> f = eval<T, SROWS, true>(a, tb, s);
  const T lb = clamp_max(add_rn(-f.rb, a.safe_margin), T(0));
  const T ub = clamp_min(sub_rn(f.lb, a.safe_margin), T(0));
  if (l < sub_rn(lb, a.eps) || l > add_rn(ub, a.eps)) return true;
  const T cx = sub_rn(f.x, mul_rn(l, T(sin(f.theta))));
  const T cy = add_rn(f.y, mul_rn(l, T(cos(f.theta))));
  const T dl = sub_rn(l, pl);
  const T ds = clamp_min(sub_rn(s, ps), a.eps);
  const T heading = add_rn(
      f.theta,
      T(atan(div_rn(div_rn(dl, ds), sub_rn(T(1), mul_rn(f.kappa, l))))));
  const T ct = T(cos(heading));
  const T st = T(sin(heading));
  if (box_hit<T, SROAD>(a, tb, sst, sdyn, add_rn(cx, mul_rn(ct, a.f2x)),
                       add_rn(cy, mul_rn(st, a.f2x))))
    return true;
  return box_hit<T, SROAD>(a, tb, sst, sdyn, add_rn(cx, mul_rn(ct, a.r2x)),
                          add_rn(cy, mul_rn(st, a.r2x)));
}

// The segment from the parent (p_s, p_l) to a child at lateral cur_l, nseg
// points (the child excluded; dp.py: _interp_sl), the point before the
// first at (last_s, last_l): any point off the road or in collision.
template <typename T, bool SROWS, bool SROAD>
__device__ bool segment_bad(const DpArgs<T>& a, const Table<T>& tb,
                            const T* sst, const T* sdyn, T p_s, T p_l,
                            T last_s, T last_l, T st, T cur_l, int nseg,
                            T inv_n) {
  const T s_step = mul_rn(st, inv_n);
  const T l_step = mul_rn(sub_rn(cur_l, p_l), inv_n);
  T ps = last_s, pl = last_l;
  for (int k = 0; k < nseg; ++k) {
    const T kk = T(k);
    const T s = add_rn(p_s, mul_rn(kk, s_step));
    const T l = add_rn(p_l, mul_rn(kk, l_step));
    if (point_bad<T, SROWS, SROAD>(a, tb, sst, sdyn + k * a.KD * kSlab, s, l,
                                   ps, pl))
      return true;
    ps = s;
    pl = l;
  }
  return false;
}

template <typename T>
__device__ __forceinline__ T weighted(const DpArgs<T>& a, T c_lat, T c_lc,
                                      T c_lct, T c_v, T c_vc, bool bad) {
  const T delta = add_rn(add_rn(add_rn(add_rn(mul_rn(c_lat, a.w_lat),
                                              mul_rn(c_lc, a.w_lc)),
                                       mul_rn(c_lct, a.w_lvc)),
                                mul_rn(c_v, a.w_lvb)),
                         mul_rn(c_vc, a.w_lvch));
  const T obst = bad ? a.w_obs : T(0);
  return obst >= a.w_obs ? a.w_obs : delta;
}

template <typename T>
__device__ __forceinline__ void copy_in(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

// argmin's rule (torch.argmin: the first index, NaN first): does v, at a
// later index, take the place of the best so far, bv?
template <typename T>
__device__ __forceinline__ bool takes_over(T v, T bv) {
  return bv == bv && (v != v || v < bv);
}

template <typename T, bool SROWS, bool SROAD>
__global__ void __launch_bounds__(kThreads)
dp_sweep_kernel(const DpArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int NT = a.NT, NS = a.NS, NL = a.NL, P = NS * NL, C = P;
  const int K = a.K, Q = a.Q;
  const int dyn_n = kNseg0 * a.KD * kSlab;
  T* sst = reinterpret_cast<T*>(smem_raw);   // [KS][kSlab]
  T* sdyn = sst + a.KS * kSlab;              // [17][KD][kSlab]
  T* scost = sdyn + dyn_n;                   // [NT][P]
  T* scurs = scost + NT * P;                 // [NT][P]
  T* spl = scurs + NT * P;                   // [P] each
  T* sgps = spl + P;
  T* sgpl = sgps + P;
  T* slast_s = sgpl + P;
  T* slast_l = slast_s + P;
  T* sbv = slast_l + P;                      // [K][C] a group's least total
  int* sbi = reinterpret_cast<int*>(sbv + K * C);   // [K][C] its parent
  int* spar = sbi + K * C;                   // [NT][P]

  const T s0 = a.s0[b];
  const T l0 = a.l0[b];
  Table<T> tb;
  tb.rows = nullptr;
  tb.s0 = tb.h = T(0);
  tb.n = a.n_rows;
  tb.grid = a.grid;
  tb.Hp = a.Hp;
  tb.Wp = a.Wp;
  tb.origin = a.origin;
  if (a.lane_off != nullptr) {
    // this scenario's road out of the pool (world.lane_grid)
    const long long off = a.span + 2;
    tb.grid = a.grid + __ldg(a.lane_off + b);
    tb.Hp = __ldg(a.lane_hw + 2 * b) + 2 * off;
    tb.Wp = __ldg(a.lane_hw + 2 * b + 1) + 2 * off;
    tb.origin = a.grid_wide
                    ? static_cast<const void*>(
                          static_cast<const double*>(a.origin) + 2 * b)
                    : static_cast<const void*>(
                          static_cast<const T*>(a.origin) + 2 * b);
  }
  if (!SROWS) {
    // its own rows of a padded table: h by the reciprocal of its count,
    // formed in T, as PyTorch divides by a host scalar on the card
    // (reference_line._div_rows)
    T inv_nm1 = a.inv_nm1;
    if (a.lane_rows != nullptr) {
      tb.n = __ldg(a.lane_rows + b);
      inv_nm1 = div_rn(T(1), T(tb.n - 1));
    }
    tb.rows = a.rows + (size_t)b * a.n_rows * kRow;
    tb.s0 = __ldg(tb.rows);
    tb.h = mul_rn(sub_rn(__ldg(tb.rows + (size_t)(tb.n - 1) * kRow), tb.s0),
                  inv_nm1);
  }
  const T* dslab = a.dslab + (size_t)b * a.TK * a.KD * kSlab;
  copy_in(sst, a.sslab + (size_t)b * a.KS * kSlab, a.KS * kSlab);
  copy_in(sdyn, dslab, kNseg0 * a.KD * kSlab);
  __syncthreads();

  // first layer (dp_planner.cpp:153-159): the parent is the start
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int l = c % NL;
    const T st = __ldg(a.station + c / NL);
    const T cur_s = add_rn(s0, st);
    const T cur_l = lat_off(a, eval<T, SROWS, false>(a, tb, cur_s), l);
    const bool bad = segment_bad<T, SROWS, SROAD>(
        a, tb, sst, sdyn, s0, l0, s0, l0, st, cur_l, kNseg0, a.inv17);
    const T dl1 = sub_rn(cur_l, l0);
    const T c_lat = fabs(cur_l);
    const T c_lc = div_rn(fabs(sub_rn(l0, cur_l)), add_rn(st, a.eps));
    const T c_lct = mul_rn(fabs(sub_rn(dl1, T(0))), a.inv_ut);
    const T c_v = fabs(sub_rn(mul_rn(st, a.inv_ut), a.nominal));
    const T c_vc = mul_rn(fabs(sub_rn(st, T(0))), a.inv_ut);
    scost[c] = weighted(a, c_lat, c_lc, c_lct, c_v, c_vc, bad);
    scurs[c] = cur_s;
    spar[c] = -1;
  }
  __syncthreads();

  for (int t = 0; t + 1 < NT; ++t) {
    const T* pcost = scost + t * P;
    const T* pcurs = scurs + t * P;
    // this layer's dynamic slabs, and each parent's lateral, grandparent
    // and the last point of its own segment (dp_planner.cpp:42-53)
    copy_in(sdyn, dslab + (size_t)(kNseg0 + kNseg * t) * a.KD * kSlab,
            kNseg * a.KD * kSlab);
    for (int p = threadIdx.x; p < P; p += blockDim.x) {
      const T p_s = pcurs[p];
      const T p_l = lat_off(a, eval<T, SROWS, false>(a, tb, p_s), p % NL);
      T gp_s = s0, gp_l = l0;
      if (t > 0) {
        const int g = spar[t * P + p];
        gp_s = scurs[(t - 1) * P + g];
        gp_l = lat_off(a, eval<T, SROWS, false>(a, tb, gp_s), g % NL);
      }
      const int nprev = t == 0 ? kNseg0 : kNseg;
      const T inv = t == 0 ? a.inv17 : a.inv16;
      const T st = __ldg(a.station + p / NL);
      const T last = T(nprev - 1);
      spl[p] = p_l;
      sgps[p] = gp_s;
      sgpl[p] = gp_l;
      slast_s[p] = add_rn(gp_s, mul_rn(last, mul_rn(st, inv)));
      slast_l[p] = add_rn(gp_l, mul_rn(last, mul_rn(sub_rn(p_l, gp_l), inv)));
    }
    __syncthreads();

    // each (group, child) item: the totals of the group's parents in
    // ascending order (dp_planner.cpp:87-131), and the least of them
    for (int it = threadIdx.x; it < K * C; it += blockDim.x) {
      const int g = it / C;
      const int c = it - g * C;
      const int l = c % NL;
      const T st = __ldg(a.station + c / NL);
      const int p_end = min(P, (g + 1) * Q);
      int best = -1;
      T bv = T(0);
      for (int p = g * Q; p < p_end; ++p) {
        const T p_s = pcurs[p];
        const T p_l = spl[p];
        const T gp_s = sgps[p];
        const T gp_l = sgpl[p];
        const T cur_s = add_rn(p_s, st);
        const T cur_l = lat_off(a, eval<T, SROWS, false>(a, tb, cur_s), l);
        const bool bad = segment_bad<T, SROWS, SROAD>(
            a, tb, sst, sdyn, p_s, p_l, slast_s[p], slast_l[p], st, cur_l,
            kNseg, a.inv16);
        const T dl1 = sub_rn(cur_l, p_l);
        const T ds0 = sub_rn(p_s, gp_s);
        const T dl0 = sub_rn(p_l, gp_l);
        const T c_lat = fabs(cur_l);
        const T c_lc = div_rn(fabs(sub_rn(p_l, cur_l)), add_rn(st, a.eps));
        const T c_lct = mul_rn(fabs(sub_rn(dl1, dl0)), a.inv_ut);
        const T c_v = fabs(sub_rn(mul_rn(st, a.inv_ut), a.nominal));
        const T c_vc = fabs(mul_rn(sub_rn(st, ds0), a.inv_ut));
        const T v = add_rn(pcost[p],
                           weighted(a, c_lat, c_lc, c_lct, c_v, c_vc, bad));
        if (best < 0 || takes_over(v, bv)) {
          best = p;
          bv = v;
        }
      }
      sbv[it] = bv;
      sbi[it] = best;
    }
    __syncthreads();

    // each child's argmin over the groups, in ascending order
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      int best = sbi[c];
      T bv = sbv[c];
      for (int g = 1; g < K; ++g) {
        const T v = sbv[g * C + c];
        if (takes_over(v, bv)) {
          best = sbi[g * C + c];
          bv = v;
        }
      }
      scost[(t + 1) * P + c] = bv;
      scurs[(t + 1) * P + c] = add_rn(pcurs[best], __ldg(a.station + c / NL));
      spar[(t + 1) * P + c] = best;
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < NT * P; i += blockDim.x) {
    const int t = i / P;
    const size_t o = ((size_t)t * a.B + b) * P + (i - t * P);
    const int par = spar[i];
    a.cost[o] = scost[i];
    a.curs[o] = scurs[i];
    a.psind[o] = par < 0 ? -1 : par / NL;
    a.plind[o] = par < 0 ? -1 : par % NL;
  }
}

// Launch one instantiation with smem bytes of shared memory.
template <typename T, bool SROWS, bool SROAD>
int start_kernel(const DpArgs<T>& a, size_t smem, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      dp_sweep_kernel<T, SROWS, SROAD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dp_sweep_kernel<T, SROWS, SROAD><<<a.B, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dims: B NT NS NL KS KD TK mode n_rows G span Hp Wp grid_wide (Hp, Wp
//       unused with a road per scenario)
// consts: unit_time safe_margin eps half r2x f2x w_obs w_lat w_lc w_lvc
//         w_lvb w_lvch nominal h lb rb kappa0 cell
// ptrs: s0 l0 station sslab dslab rows seg_f seg_i bar grid origin
//       cost curs psind plind lane_off lane_hw lane_rows (the last three
//       null for one road and unpadded rows)
template <typename T>
int launch(const int* dims, const double* consts, void* const* ptrs,
           void* stream) {
  DpArgs<T> a;
  a.B = dims[0];
  a.NT = dims[1];
  a.NS = dims[2];
  a.NL = dims[3];
  a.KS = dims[4];
  a.KD = dims[5];
  a.TK = dims[6];
  const int mode = dims[7];
  a.n_rows = dims[8];
  a.G = dims[9];
  a.span = dims[10];
  a.Hp = dims[11];
  a.Wp = dims[12];
  a.grid_wide = dims[13];
  if (a.B < 1 || a.NT < 2 || a.NS < 1 || a.NL < 1 || a.n_rows < 2 ||
      a.TK != kNseg0 + kNseg * (a.NT - 1) ||
      (mode != kSpec && mode != kGrid && mode != kGridSpec))
    return static_cast<int>(cudaErrorInvalidValue);
  // Python floats as PyTorch rounds them to T; a Python-scalar divisor's
  // reciprocal formed in T
  const T unit_time = T(consts[0]);
  a.inv_ut = T(1) / unit_time;
  a.inv16 = T(1) / T(kNseg);
  a.inv17 = T(1) / T(kNseg0);
  a.inv_frac = T(1) / T(a.NL - 2);
  a.inv_nm1 = T(1) / T(a.n_rows - 1);
  a.safe_margin = T(consts[1]);
  a.eps = T(consts[2]);
  a.half = T(consts[3]);
  a.r2x = T(consts[4]);
  a.f2x = T(consts[5]);
  a.w_obs = T(consts[6]);
  a.w_lat = T(consts[7]);
  a.w_lc = T(consts[8]);
  a.w_lvc = T(consts[9]);
  a.w_lvb = T(consts[10]);
  a.w_lvch = T(consts[11]);
  a.nominal = T(consts[12]);
  a.h = T(consts[13]);
  a.lb = T(consts[14]);
  a.rb = T(consts[15]);
  a.kappa0 = T(consts[16]);
  a.cell_d = consts[17];
  a.cell_t = T(consts[17]);
  const double pi = 3.14159265358979323846;
  a.pi = T(pi);
  a.neg_pi = T(-pi);
  a.two_pi = T(2.0 * pi);
  a.tiny = T(1e-10);
  a.s0 = static_cast<const T*>(ptrs[0]);
  a.l0 = static_cast<const T*>(ptrs[1]);
  a.station = static_cast<const T*>(ptrs[2]);
  a.sslab = static_cast<const T*>(ptrs[3]);
  a.dslab = static_cast<const T*>(ptrs[4]);
  a.rows = static_cast<const T*>(ptrs[5]);
  a.seg_f = static_cast<const T*>(ptrs[6]);
  a.seg_i = static_cast<const int*>(ptrs[7]);
  a.bar = static_cast<const T*>(ptrs[8]);
  a.grid = static_cast<const signed char*>(ptrs[9]);
  a.origin = ptrs[10];
  a.cost = static_cast<T*>(ptrs[11]);
  a.curs = static_cast<T*>(ptrs[12]);
  a.psind = static_cast<long long*>(ptrs[13]);
  a.plind = static_cast<long long*>(ptrs[14]);
  a.lane_off = static_cast<const long long*>(ptrs[15]);
  a.lane_hw = static_cast<const long long*>(ptrs[16]);
  a.lane_rows = static_cast<const long long*>(ptrs[17]);

  // shared memory: the slabs and the layers' state, then the parent
  // groups' minima, as many groups (at most one a parent) as the card's
  // opt-in limit holds
  const size_t P = (size_t)a.NS * a.NL;
  const size_t fixed = sizeof(T) * ((size_t)a.KS * kSlab +
                                    (size_t)kNseg0 * a.KD * kSlab +
                                    2 * (size_t)a.NT * P + 5 * P) +
                       sizeof(int) * (size_t)a.NT * P;
  const size_t per_group = P * (sizeof(T) + sizeof(int));
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fixed + per_group > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t k_max = (static_cast<size_t>(optin) - fixed) / per_group;
  a.Q = static_cast<int>((P + std::min(P, k_max) - 1) / std::min(P, k_max));
  a.K = static_cast<int>((P + a.Q - 1) / a.Q);
  const size_t smem = fixed + a.K * per_group;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kSpec) return start_kernel<T, true, true>(a, smem, st);
  if (mode == kGrid) return start_kernel<T, false, false>(a, smem, st);
  return start_kernel<T, true, false>(a, smem, st);
}

}  // namespace
}  // namespace cilqr

extern "C" {

int dp_sweep_f32(const int* dims, const double* consts, void* const* ptrs,
                 void* stream) {
  return cilqr::launch<float>(dims, consts, ptrs, stream);
}

int dp_sweep_f64(const int* dims, const double* consts, void* const* ptrs,
                 void* stream) {
  return cilqr::launch<double>(dims, consts, ptrs, stream);
}

}  // extern "C"
