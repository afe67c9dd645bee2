"""Batch-last CILQR solver (PyTorch counterpart of cilqr_tpu/solver_blast.py).

The same serial-line-search solver (reference semantics,
ilqr_optimizer.cc:154-320) with the batch axis LAST on every internal
tensor — [6, N, B], [T, 6, 6, B], [N, KC, B] — the layout the CUDA kernels
read coalesced, neighbouring threads on neighbouring lanes. Public
functions keep the JAX package's batch-first layout ([B, N, 6]).

Two hand-written CUDA kernels carry each solver trip: the fused Riccati
sweep (kernels/sweep.py) and the corridor+lane cost stack
(kernels/coststack.py). ``_backward_bl``/``_forward_bl`` and the plain
branch of ``_cost_stack_bl`` are their twins, used on the CPU and when a
config asks for ``"xla"``.

The JAX ``lax.while_loop`` becomes a host loop: one ``.any()`` device sync
per trip decides whether to run the next.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .barriers import make_barrier
from .config import IlqrConfig, VehicleParam
from .costs import ConstraintSet
from .geometry import normalize_angle, point_segment_distance
from .kernels.coststack import StackOperands, gather_windows
from .profiling import host, span, tally
from .solver import iqr_init, transform_goals
from .types import CostBreakdown, SolveResult, SolverStatus

# cascade floor: one 128-lane block, the width of a TPU sweep block, so
# that compaction schedules rounds as the reference run does
NB = 128

# ---------------------------------------------------------------------------
# batch-last helpers
# ---------------------------------------------------------------------------


def mm(X, Y):
    """[m, k, B] @ [k, n, B] -> [m, n, B]."""
    return (X[:, :, None, :] * Y[None]).sum(1)


def mv(X, y):
    """[m, k, B] @ [k, B] -> [m, B]."""
    return (X * y[None]).sum(1)


def _inv22_bl(M):
    """Closed-form 2x2 inverse, [2, 2, B]."""
    a, b = M[0, 0], M[0, 1]
    c, d = M[1, 0], M[1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([torch.stack([d, -b]), torch.stack([-c, a])]) * inv_det


def _rk2_bl(x, u, dt, L):
    """Midpoint step on component-rows: x [6, B], u [2, B]
    (vehicle_model.cc:107-121)."""

    def f(s):
        th = normalize_angle(s[2])
        dl = normalize_angle(s[5])
        return torch.stack([s[3] * torch.cos(th), s[3] * torch.sin(th),
                            s[3] * torch.tan(dl) / L, s[4], u[0], u[1]])

    mid = x + 0.5 * dt * f(x)
    nxt = x + dt * f(mid)
    return torch.stack([nxt[0], nxt[1], normalize_angle(nxt[2]), nxt[3],
                        nxt[4], normalize_angle(nxt[5])])


def _jacobians_bl(xs, us, dt, L):
    """Analytic midpoint Jacobians on [6, T, B]/[2, T, B] components
    (vehicle_model.cc:44-86 incl. the v-vs-v_mid quirk; see model.py).
    Returns (A [T, 6, 6, B], Bm [T, 6, 2, B])."""
    v = xs[3]
    theta = normalize_angle(xs[2])
    delta = normalize_angle(xs[5])
    a = xs[4]
    delta_rate = us[1]

    theta_mid = theta + 0.5 * dt * v * torch.tan(delta) / L
    tan_delta = torch.tan(delta)
    tan_delta_rate = torch.tan(delta + 0.5 * dt * delta_rate)
    cos_tm = torch.cos(theta_mid)
    sin_tm = torch.sin(theta_mid)
    td2 = tan_delta * tan_delta
    tdr2 = tan_delta_rate * tan_delta_rate
    v_mid = 0.5 * a * dt + v

    z = torch.zeros_like(v)
    o = torch.ones_like(v)
    A = torch.stack([
        torch.stack([o, z, -dt * v_mid * sin_tm,
                     dt * cos_tm - 0.5 * dt * dt * v_mid * sin_tm * tan_delta / L,
                     0.5 * dt * dt * cos_tm,
                     -0.5 * dt * dt * v * v_mid * (td2 + 1.0) * sin_tm / L]),
        torch.stack([z, o, dt * v_mid * cos_tm,
                     dt * sin_tm + 0.5 * dt * dt * v_mid * cos_tm * tan_delta / L,
                     0.5 * dt * dt * sin_tm,
                     0.5 * dt * dt * v * v_mid * (td2 + 1.0) * cos_tm / L]),
        torch.stack([z, z, o, dt * tan_delta_rate / L,
                     0.5 * dt * dt * tan_delta_rate / L,
                     dt * v * (tdr2 + 1.0) / L]),
        torch.stack([z, z, z, o, dt * o, z]),
        torch.stack([z, z, z, z, o, z]),
        torch.stack([z, z, z, z, z, o]),
    ])                                              # [6, 6, T, B]
    Bm = torch.stack([
        torch.stack([z, z]),
        torch.stack([z, z]),
        torch.stack([z, 0.5 * dt * dt * v * (tdr2 + 1.0) / L]),
        torch.stack([0.5 * dt * dt * o, z]),
        torch.stack([dt * o, z]),
        torch.stack([z, dt * o]),
    ])                                              # [6, 2, T, B]
    return A.movedim(2, 0).contiguous(), Bm.movedim(2, 0).contiguous()


# ---------------------------------------------------------------------------
# constraints in batch-last layout
# ---------------------------------------------------------------------------


class ConsBL(NamedTuple):
    """ConstraintSet transposed to batch-last component tensors."""

    ca: torch.Tensor     # corridor a [N, KC, B]
    cb: torch.Tensor
    cc: torch.Tensor
    cm: torch.Tensor     # corridor mask [N, KC, B] (bool)
    lanes: tuple         # per side: (a, b, c, x1, y1, x2, y2, m, lo, hi) —
                         # each [S, B] (shared full scan; lo=hi=None) or
                         # [N, W, B] (per-knot window; lo/hi [N, B] flag
                         # that segments exist beyond that window edge)
    stack: StackOperands | None = None   # the cost-stack kernel's operands
                                         # (lane windows on either side)


def _last(v):
    """[B, ...] -> [..., B], contiguous."""
    return v.movedim(0, -1).contiguous()


def cons_to_bl(cons: ConstraintSet, goals_bl=None, lane_window: int = 0
               ) -> ConsBL:
    """[B, ...] ConstraintSet -> batch-last components. With
    0 < lane_window < S and goals given (batch-last [6, N, B]), lane
    constraints become per-knot windows [N, W, B] of W segments around the
    segment nearest each knot's GOAL position.

    The window start is quantized to a grid of stride W/4, exactly as in
    the JAX package, so every knot sees the same W segments; the JAX
    package selects its variant by one-hot ``where`` (gather-free for the
    TPU), here it is one direct gather.

    With windows on either side, ``stack`` holds the cost-stack kernel's
    operands (kernels/coststack.StackOperands): the corridor rows, each
    side's segment rows once and each knot's window start, in the working
    type; ca, cb and cc are views of its corridor rows. Both sides' rows
    are padded with masked segments to the longer side's S: a windowed
    side's windows stay within its own segments, and a side of S <= W
    segments (a full scan) reads the window at start 0, whose masked tail
    no selection takes (clip flags 0)."""
    W = lane_window
    dtype = cons.corridor_planes.dtype

    def side(planes, segs, mask):
        """(lanes as ConsBL holds them, the [S, B] rows, window starts
        [N, B] or None)."""
        a, b, c = (_last(planes[..., i]) for i in range(3))   # [S, B]
        x1, y1 = _last(segs[..., 0, 0]), _last(segs[..., 0, 1])
        x2, y2 = _last(segs[..., 1, 0]), _last(segs[..., 1, 1])
        m = _last(mask)
        rows = (a, b, c, x1, y1, x2, y2, m)
        S = a.shape[0]
        if goals_bl is None or not (0 < W < S):
            return rows + (None, None), rows, None
        d = point_segment_distance(goals_bl[0][:, None, :],
                                   goals_bl[1][:, None, :],
                                   x1[None], y1[None], x2[None], y2[None])
        d = torch.where(m[None], d, torch.full_like(d, float("inf")))
        w0 = torch.clamp(torch.argmin(d, dim=1) - W // 2, 0, S - W)  # [N, B]

        q = max(1, W // 4)
        ks = list(range(0, S - W + 1, q))
        if ks[-1] != S - W:
            ks.append(S - W)
        # nearest variant start per knot (strictly-less keeps the first)
        best = torch.zeros_like(w0)
        bestd = (w0 - ks[0]).abs()
        for i, k in enumerate(ks[1:], 1):
            dk = (w0 - k).abs()
            upd = dk < bestd
            bestd = torch.where(upd, dk, bestd)
            best = torch.where(upd, torch.full_like(best, i), best)
        start = torch.tensor(ks, device=a.device)[best]          # [N, B]
        n_valid = m.sum(dim=0)                                   # [B]
        lo = start > 0
        hi = start + W < n_valid[None, :]
        return (tuple(gather_windows(v, start, W) for v in rows) + (lo, hi),
                rows, start)

    planes = [_last(cons.corridor_planes[..., i]) for i in range(3)]
    cm = _last(cons.corridor_mask)
    sides = (side(cons.left_planes, cons.left_segs, cons.left_mask),
             side(cons.right_planes, cons.right_segs, cons.right_mask))
    stack = None
    if any(start is not None for _, _, start in sides):
        N, B = goals_bl.shape[1], goals_bl.shape[2]
        S = max(rows[0].shape[0] for _, rows, _ in sides)
        segs = torch.zeros((2, 8, S, B), dtype=dtype, device=cm.device)
        starts = torch.zeros((2, N, B), dtype=torch.int32, device=cm.device)
        edge = torch.zeros((2, 2, N, B), dtype=dtype, device=cm.device)
        for i, (lanes, rows, start) in enumerate(sides):
            segs[i, :, :rows[0].shape[0]] = torch.stack(
                rows[:7] + (rows[7].to(dtype),))
            if start is not None:
                starts[i] = start
                edge[i] = torch.stack(lanes[8:]).to(dtype)
        corr = torch.stack(planes + [cm.to(dtype)])
        planes = list(corr[:3])
        stack = StackOperands(corr=corr, segs=segs, start=starts, edge=edge,
                              W=W)
    return ConsBL(ca=planes[0], cb=planes[1], cc=planes[2], cm=cm,
                  lanes=tuple(lanes for lanes, _, _ in sides), stack=stack)


def _disc_offsets(cfg: IlqrConfig, veh: VehicleParam, dtype, device):
    D = cfg.num_of_disc
    L = veh.length / D
    return L * (torch.arange(D, dtype=dtype, device=device) - 0.5) \
        - veh.rear_hang_length


def kernel_disc_offsets(cfg: IlqrConfig, veh: VehicleParam) -> tuple:
    """The disc offsets as the cost-stack kernel takes them: Python floats,
    formed in double precision as the JAX package forms them for its
    Pallas kernel."""
    Lv = veh.length / cfg.num_of_disc
    return tuple(Lv * (i - 0.5) - veh.rear_hang_length
                 for i in range(cfg.num_of_disc))


def _nearest_lane_sel_discs(cx, cy, lane):
    """Nearest lane segment + plane selection for all D disc centres at
    once: cx, cy [D, N, B] -> (a, b, c [D, N, B], edge [D, N, B] | None).
    Lane tensors are [S, B] (shared across knots; edge=None) or [N, W, B]
    (per-knot windows; edge flags an argmin on a clipped window edge).

    ``torch.argmin`` returns the first index on ties, which is the order
    both of the JAX package's ``lane_search`` methods ('reduce' and
    'onehot') implement, so one implementation serves both."""
    a, b, c, x1, y1, x2, y2, m, lo, hi = lane
    if a.dim() == 2:   # shared [S, B] -> [1, 1, S, B]
        a, b, c, x1, y1, x2, y2, m = (
            v[None, None] for v in (a, b, c, x1, y1, x2, y2, m))
    else:              # windowed [N, W, B] -> [1, N, W, B]
        a, b, c, x1, y1, x2, y2, m = (
            v[None] for v in (a, b, c, x1, y1, x2, y2, m))
    d = point_segment_distance(cx[:, :, None, :], cy[:, :, None, :],
                               x1, y1, x2, y2)          # [D, N, S, B]
    d = torch.where(m, d, torch.full_like(d, float("inf")))
    S = d.shape[2]
    idx = torch.argmin(d, dim=2)                        # [D, N, B]
    sel = idx[:, :, None, :]

    def pick(p):
        return torch.gather(p.expand(d.shape), 2, sel)[:, :, 0]

    edge = None
    if lo is not None:
        edge = ((idx == 0) & lo[None]) | ((idx == S - 1) & hi[None])
    return pick(a), pick(b), pick(c), edge


def _cost_stack_bl(xs, us, goals, cbl: ConsBL, cfg, veh, want_derivs):
    """Cost components [B] plus PER-KNOT totals pk [N, B] and the lane
    window-clip flag clip [B] (+ optionally Jx [N,6,B], Ju [T,2,B],
    Hx [N,6,6,B], Hu [T,2,2,B]) — TotalCost / CostJacbian / CostHessian
    (ilqr_optimizer.cc:417-769) in batch-last form.

    pk lets the outer loop compute dcost = sum_k(pk_old - pk_new) rather
    than total_old - total_new, which cancels catastrophically in f32
    (see the JAX package's docstring)."""
    bar = make_barrier(cfg.barrier)
    w = cfg.weights
    dtype, device = xs.dtype, xs.device
    N = xs.shape[1]
    T = us.shape[1]
    B = xs.shape[2]

    dx = xs[0] - goals[0]
    dy = xs[1] - goals[1]
    dth = xs[2] - goals[2]
    jk_x = (w.x_target * dx * dx + w.y_target * dy * dy
            + w.theta * dth * dth)                      # [N, B]
    jk_u = w.jerk * us[0] ** 2 + w.delta_rate * us[1] ** 2   # [T, B]
    j_cost = jk_x.sum(0) + jk_u.sum(0)

    # state/control limit constraint values g <= 0 (order as costs.py)
    gx = [(-xs[3], 3, -1.0), (xs[3] - veh.max_velocity, 3, 1.0),
          (xs[4] - veh.max_acceleration, 4, 1.0),
          (veh.min_acceleration - xs[4], 4, -1.0),
          (xs[5] - veh.delta_max, 5, 1.0), (veh.delta_min - xs[5], 5, -1.0)]
    gu = [(us[0] - veh.jerk_max, 0, 1.0), (veh.jerk_min - us[0], 0, -1.0),
          (us[1] - veh.delta_rate_max, 1, 1.0),
          (veh.delta_rate_min - us[1], 1, -1.0)]
    dynk_x = sum(bar.value(g) for g, _, _ in gx)        # [N, B]
    dynk_u = sum(bar.value(g) for g, _, _ in gu)        # [T, B]
    dyn_cost = dynk_x.sum(0) + dynk_u.sum(0)

    kw = dict(dtype=dtype, device=device)
    corrk = torch.zeros((N, B), **kw)
    lanek = torch.zeros((N, B), **kw)
    clip = torch.zeros((B,), dtype=torch.bool, device=device)

    jx = hx = hu = ju0 = ju1 = None
    if want_derivs:
        jx = [torch.zeros((N, B), **kw) for _ in range(6)]
        hx = {}

        def hadd(i, j, v):
            hx[(i, j)] = hx.get((i, j), 0.0) + v

        jx[0] = 2.0 * w.x_target * dx
        jx[1] = 2.0 * w.y_target * dy
        jx[2] = 2.0 * w.theta * dth
        ju0 = 2.0 * w.jerk * us[0]
        ju1 = 2.0 * w.delta_rate * us[1]
        hadd(0, 0, torch.full((N, B), 2.0 * w.x_target, **kw))
        hadd(1, 1, torch.full((N, B), 2.0 * w.y_target, **kw))
        hadd(2, 2, torch.full((N, B), 2.0 * w.theta, **kw))
        hadd(3, 3, torch.full((N, B), 2.0 * w.v, **kw))
        hadd(4, 4, torch.full((N, B), 2.0 * w.a, **kw))
        hadd(5, 5, torch.full((N, B), 2.0 * w.delta, **kw))
        hu = {(0, 0): torch.full((T, B), 2.0 * w.jerk, **kw),
              (1, 1): torch.full((T, B), 2.0 * w.delta_rate, **kw)}

        for g, i, s in gx:
            jx[i] = jx[i] + bar.grad_factor(g) * s
            hadd(i, i, bar.hess_factors(g)[0])
        for g, i, s in gu:
            if i == 0:
                ju0 = ju0 + bar.grad_factor(g) * s
            else:
                ju1 = ju1 + bar.grad_factor(g) * s
            hu[(i, i)] = hu[(i, i)] + bar.hess_factors(g)[0]

    if _use_coststack_kernel(cfg, cbl, xs):
        # fused corridor+lane stack (kernels/coststack.py) on the operands
        # cons_to_bl built: it replaces the disc loop below, same math
        from .kernels.coststack import corridor_lane_stack

        res = corridor_lane_stack(
            xs, cbl.stack, kernel_disc_offsets(cfg, veh), cfg.barrier.t,
            cfg.barrier.epsilon, want_derivs=want_derivs)
        corrk = res[0]
        lanek = res[1]
        clip = (res[2] > 0.5).any(dim=0)
        if want_derivs:
            jx0k, jx1k, jx2k, h00, h01, h02, h11, h12, h22 = res[3:]
            jx[0] = jx[0] + jx0k
            jx[1] = jx[1] + jx1k
            jx[2] = jx[2] + jx2k
            hadd(0, 0, h00)
            hadd(0, 1, h01)
            hadd(0, 2, h02)
            hadd(1, 1, h11)
            hadd(1, 2, h12)
            hadd(2, 2, h22)
        return _combine_cost_stack(xs, us, want_derivs, j_cost, dyn_cost,
                                   jk_x, jk_u, dynk_x, dynk_u, corrk, lanek,
                                   clip, jx, hx, (ju0, ju1), hu)

    offs = _disc_offsets(cfg, veh, dtype, device)
    D = int(offs.shape[0])
    ct = torch.cos(xs[2])
    st = torch.sin(xs[2])
    # all-disc centres [D, N, B]; the lane searches run once over the
    # stacked disc axis, then the accumulation keeps the per-disc order
    lcs = offs[:, None, None] * ct[None]
    lss = offs[:, None, None] * st[None]
    cxds = xs[0][None] + lcs
    cyds = xs[1][None] + lss
    lane_sels = []
    for lane in cbl.lanes:
        sla, slb, slc, sedge = _nearest_lane_sel_discs(cxds, cyds, lane)
        if sedge is not None:
            clip = clip | sedge.any(dim=0).any(dim=0)
        lane_sels.append((sla, slb, slc))

    fz = torch.zeros((), **kw)
    for d in range(D):
        lc, ls = lcs[d], lss[d]                        # [N, B]
        cxd, cyd = cxds[d], cyds[d]

        # corridor barriers over [N, KC, B]
        g = cbl.ca * cxd[:, None] + cbl.cb * cyd[:, None] - cbl.cc
        corrk = corrk + torch.where(cbl.cm, bar.value(g), fz).sum(1)
        if want_derivs:
            dthk = -cbl.ca * ls[:, None] + cbl.cb * lc[:, None]
            gf = torch.where(cbl.cm, bar.grad_factor(g), fz)
            hf, hddx = bar.hess_factors(g)
            hf = torch.where(cbl.cm, hf, fz)
            hddx = torch.where(cbl.cm, hddx, fz)
            ddx22 = -cbl.ca * lc[:, None] - cbl.cb * ls[:, None]
            jx[0] = jx[0] + (gf * cbl.ca).sum(1)
            jx[1] = jx[1] + (gf * cbl.cb).sum(1)
            jx[2] = jx[2] + (gf * dthk).sum(1)
            comps = (cbl.ca, cbl.cb, dthk)
            for i in range(3):
                for j in range(i, 3):
                    hadd(i, j, (hf * comps[i] * comps[j]).sum(1))
            hadd(2, 2, (hddx * ddx22).sum(1))

        # lane barriers (nearest segment, selected above)
        for sla, slb, slc in lane_sels:
            la, lb, lcc = sla[d], slb[d], slc[d]
            lg = la * cxd + lb * cyd - lcc
            lanek = lanek + bar.value(lg)
            if want_derivs:
                ldth = -la * ls + lb * lc
                lgf = bar.grad_factor(lg)
                lhf, lhd = bar.hess_factors(lg)
                lddx22 = -la * lc - lb * ls
                jx[0] = jx[0] + lgf * la
                jx[1] = jx[1] + lgf * lb
                jx[2] = jx[2] + lgf * ldth
                lcmp = (la, lb, ldth)
                for i in range(3):
                    for j in range(i, 3):
                        hadd(i, j, lhf * lcmp[i] * lcmp[j])
                hadd(2, 2, lhd * lddx22)

    return _combine_cost_stack(xs, us, want_derivs, j_cost, dyn_cost, jk_x,
                               jk_u, dynk_x, dynk_u, corrk, lanek, clip, jx,
                               hx, (ju0, ju1), hu)


def _use_coststack_kernel(cfg, cbl: ConsBL, xs) -> bool:
    """Eligibility for the fused corridor+lane kernel
    (IlqrConfig.cost_stack_backend): relax barrier and a lane window on
    either side, for which cons_to_bl always builds the kernel's operands
    (with no window both sides are full scans, and the disc loop runs, as
    in the JAX package). 'pallas' takes the kernel's wrapper on any device (its plain version
    on the CPU); 'auto' takes it for CUDA tensors only, as the JAX package
    takes the Pallas kernel only off the CPU."""
    mode = cfg.cost_stack_backend
    if mode == "xla" or cfg.barrier.kind != "relax":
        return False
    eligible = cbl.stack is not None
    if mode == "pallas":
        return eligible
    return eligible and xs.device.type == "cuda"


def _combine_cost_stack(xs, us, want_derivs, j_cost, dyn_cost, jk_x, jk_u,
                        dynk_x, dynk_u, corrk, lanek, clip, jx, hx, ju, hu):
    """Assemble _cost_stack_bl's outputs from the tracking/limit terms
    plus the corridor/lane accumulations (plain or kernel path)."""
    T = us.shape[1]
    corr_cost = corrk.sum(0)
    lane_cost = lanek.sum(0)
    cost = CostBreakdown(total=j_cost + dyn_cost + corr_cost + lane_cost,
                         target=j_cost, dynamic=dyn_cost,
                         corridor=corr_cost, lane=lane_cost)
    pk = jk_x + dynk_x + corrk + lanek
    pk = torch.cat([pk[:T] + (jk_u + dynk_u), pk[T:]])
    if not want_derivs:
        return cost, pk, clip

    ju0, ju1 = ju
    zeros_nb = torch.zeros_like(corrk)
    Jx = torch.stack(jx, dim=1)                          # [N, 6, B]
    Hx = torch.stack([
        torch.stack([hx.get((min(i, j), max(i, j)), zeros_nb)
                     for j in range(6)], dim=1)
        for i in range(6)], dim=1)                       # [N, 6, 6, B]
    zeros_tb = torch.zeros_like(ju0)
    Ju = torch.stack([ju0, ju1], dim=1)                  # [T, 2, B]
    Hu = torch.stack([
        torch.stack([hu.get((min(i, j), max(i, j)), zeros_tb)
                     for j in range(2)], dim=1)
        for i in range(2)], dim=1)                       # [T, 2, 2, B]
    return cost, pk, clip, Jx, Ju, Hx, Hu


# ---------------------------------------------------------------------------
# Riccati backward / forward (batch-last): the twins of kernels/sweep.py
# ---------------------------------------------------------------------------


def _backward_bl(lam, A, Bm, Jx, Ju, Hx, Hu):
    """Riccati sweep (ilqr_optimizer.cc:334-390). lam [B];
    A [T,6,6,B], Bm [T,6,2,B], Jx [N,6,B], Ju [T,2,B], Hx [N,6,6,B],
    Hu [T,2,2,B] -> (Ks [T,2,6,B], ks [T,2,B], dV0 [B], dV1 [B])."""
    T = A.shape[0]
    eye2 = torch.eye(2, dtype=A.dtype, device=A.device)[..., None]
    Vx, Vxx = Jx[-1], Hx[-1]
    dV0 = torch.zeros_like(lam)
    dV1 = torch.zeros_like(lam)
    Ks = [None] * T
    ks = [None] * T
    for t in range(T - 1, -1, -1):
        Ai, Bi = A[t], Bm[t]
        At, Bt = Ai.transpose(0, 1), Bi.transpose(0, 1)
        Qx = Jx[t] + mv(At, Vx)
        Qu = Ju[t] + mv(Bt, Vx)
        AtV = mm(At, Vxx)
        Qxx = Hx[t] + mm(AtV, Ai)
        BtV = mm(Bt, Vxx)
        Quu = Hu[t] + mm(BtV, Bi)
        Qux = mm(BtV, Ai)
        Quu_inv = _inv22_bl(Quu + lam * eye2)
        K = -mm(Quu_inv, Qux)
        k = -mv(Quu_inv, Qu)
        Kt = K.transpose(0, 1)
        Quxt = Qux.transpose(0, 1)
        Quk = mv(Quu, k)
        Vx = Qx + mv(Kt, Quk) + mv(Kt, Qu) + mv(Quxt, k)
        Vxx = Qxx + mm(Kt, mm(Quu, K)) + mm(Kt, Qux) + mm(Quxt, K)
        Vxx = 0.5 * (Vxx + Vxx.transpose(0, 1))
        dV0 = dV0 + (k * Qu).sum(0)
        dV1 = dV1 + 0.5 * (k * Quk).sum(0)
        Ks[t], ks[t] = K, k
    return torch.stack(Ks), torch.stack(ks), dV0, dV1


def _forward_bl(alpha, xs, us, Ks, ks, goals, dt, L):
    """Closed-loop rollout (ilqr_optimizer.cc:392-415) with per-LANE alpha
    [B] (serial mode: lanes sit at different alpha indices). xs [6,N,B],
    us [2,T,B] -> (new xs [6,N,B], new us [2,T,B])."""
    x = goals[:, 0]
    new_xs, new_us = [x], []
    for t in range(us.shape[1]):
        u = us[:, t] + mv(Ks[t], x - xs[:, t]) + alpha * ks[t]
        u = torch.stack([u[0], normalize_angle(u[1])])
        x = _rk2_bl(x, u, dt, L)
        new_xs.append(x)
        new_us.append(u)
    return torch.stack(new_xs, dim=1), torch.stack(new_us, dim=1)


# ---------------------------------------------------------------------------
# outer loop (serial line search, per-lane carries)
# ---------------------------------------------------------------------------


class _CarryBL(NamedTuple):
    xs: torch.Tensor        # [6, N, B]
    us: torch.Tensor        # [2, T, B]
    cost: CostBreakdown     # [B] leaves
    pc: torch.Tensor        # [N, B] per-knot costs of the current iterate
    lam: torch.Tensor       # [B]
    dlam: torch.Tensor
    status: torch.Tensor    # [B] int32
    it: torch.Tensor        # [B] int32
    aidx: torch.Tensor      # [B] int32
    clip: torch.Tensor      # [B] bool: lane-window edge clip seen (monotone)


def _tree_map(fn, first, *rest):
    """Map over the tensor leaves of carries (NamedTuples whose ``cost``
    field is a CostBreakdown)."""
    out = []
    for i, v in enumerate(first):
        if isinstance(v, CostBreakdown):
            out.append(v.map(fn, *(r[i] for r in rest)))
        else:
            out.append(fn(v, *(r[i] for r in rest)))
    return type(first)(*out)


def _any(mask) -> bool:
    """One device-to-host sync (``profiling.host``): is any element of
    ``mask`` set?"""
    return bool(host(mask.any()))


def _make_body(goals, cbl, cfg: IlqrConfig, veh: VehicleParam, dt):
    """One loop trip (ilqr_optimizer.cc:201-309) as a closure over the
    (batch-last) problem tensors. Every operation is per-lane — no
    batch-axis reductions — so a lane's decision/fp trajectory is
    independent of which batch it sits in (the compaction rounds rely on
    this)."""
    reg = cfg.reg
    dtype, device = goals.dtype, goals.device
    alphas = torch.tensor(cfg.line_search.alphas, dtype=dtype, device=device)
    n_alpha = len(cfg.line_search.alphas)
    if cfg.sweep_backend == "auto":
        use_kernel = device.type == "cuda"
    else:
        use_kernel = cfg.sweep_backend == "pallas"
    k_alpha = max(1, cfg.line_search.alphas_per_trip)
    i32 = torch.int32

    def code(ref, status):
        return torch.full_like(ref, int(status), dtype=i32)

    def body(c: _CarryBL) -> _CarryBL:
        A, Bm = _jacobians_bl(c.xs[:, :-1], c.us, dt, veh.wheel_base)
        _, _, clip1, Jx, Ju, Hx, Hu = _cost_stack_bl(
            c.xs, c.us, goals, cbl, cfg, veh, True)
        # K consecutive alphas per trip, all rolled out from this trip's
        # frozen iterate (LineSearchConfig.alphas_per_trip); the serial
        # accept rule is applied to the candidates in order below
        a_k = [alphas[torch.clamp(c.aidx + i, max=n_alpha - 1).long()]
               for i in range(k_alpha)]                   # K x [B]
        if use_kernel:
            from .kernels.sweep import riccati_sweep

            nxs_km, nus_tm, dV0, dV1, gnorm = riccati_sweep(
                c.lam, torch.stack(a_k), A, Bm, Jx, Ju, Hx, Hu,
                c.xs.movedim(0, 1), c.us.movedim(0, 1),
                dt=dt, wheel_base=veh.wheel_base)
            nxs_k = [x.movedim(0, 1) for x in nxs_km]
            nus_k = [u.movedim(0, 1) for u in nus_tm]
        else:
            Ks, ks, dV0, dV1 = _backward_bl(c.lam, A, Bm, Jx, Ju, Hx, Hu)
            gnorm = (ks.abs() / (c.us.movedim(1, 0).abs() + 1.0)
                     ).amax(1).mean(0)
            nxs_k, nus_k = [], []
            for i in range(k_alpha):
                nxs_i, nus_i = _forward_bl(a_k[i], c.xs, c.us, Ks, ks,
                                           goals, dt, veh.wheel_base)
                nxs_k.append(nxs_i)
                nus_k.append(nus_i)
        gnorm_done = (gnorm < reg.gradient_norm_min) & (c.lam < 1e-5)

        # serial accept fold over the K candidates: candidate i is
        # considered only if every previous one was rejected without
        # exhausting the schedule
        cand = []
        for i in range(k_alpha):
            ncost_i, npc_i, clip_i = _cost_stack_bl(
                nxs_k[i], nus_k[i], goals, cbl, cfg, veh, False)
            # dcost as a sum of per-knot differences (see _cost_stack_bl)
            dcost_i = (c.pc - npc_i).sum(0)
            expected_i = -a_k[i] * (dV0 + a_k[i] * dV1)
            z_i = dcost_i / expected_i
            acc_i = ((z_i > cfg.line_search.beta_min)
                     & (z_i < cfg.line_search.beta_max) & (dcost_i > 0.0))
            last_i = (c.aidx + i) == (n_alpha - 1)
            cand.append((nxs_k[i], nus_k[i], ncost_i, npc_i, clip_i,
                         dcost_i, acc_i, last_i))

        nxs, nus, ncost, npc, clip2, dcost, acc0, last0 = cand[0]
        accept = acc0
        full_reject = (~acc0) & last0
        considered = (~acc0) & (~last0)
        for i in range(1, k_alpha):
            nxs_i, nus_i, ncost_i, npc_i, clip_i, dcost_i, acc_i, \
                last_i = cand[i]
            sel_i = considered & acc_i
            nxs = torch.where(sel_i, nxs_i, nxs)
            nus = torch.where(sel_i, nus_i, nus)
            ncost = ncost_i.map(lambda n, o, s=sel_i: torch.where(s, n, o),
                                ncost)
            npc = torch.where(sel_i, npc_i, npc)
            dcost = torch.where(sel_i, dcost_i, dcost)
            # candidate i's cost stack only counts on lanes that reach it
            clip2 = clip2 | (considered & clip_i)
            accept = accept | sel_i
            full_reject = full_reject | (considered & (~acc_i) & last_i)
            considered = considered & (~acc_i) & (~last_i)
        concluded = accept | full_reject

        dlam_acc = torch.clamp(c.dlam / reg.ratio, max=1.0 / reg.ratio)
        lam_acc = c.lam * dlam_acc * (c.lam > reg.lambda_min).to(dtype)
        conv_abs = dcost < cfg.abs_cost_tol
        conv_rel = (dcost / c.cost.total) < cfg.rel_cost_tol
        running_code = code(c.status, SolverStatus.RUNNING)
        status_acc = torch.where(
            conv_abs, code(c.status, SolverStatus.SUCCESS_ABS_COST),
            torch.where(conv_rel, code(c.status, SolverStatus.SUCCESS_REL_COST),
                        running_code))
        dlam_rej = torch.clamp(c.dlam * reg.ratio, min=reg.ratio)
        lam_rej = torch.clamp(c.lam * dlam_rej, min=reg.lambda_min)
        status_rej = torch.where(lam_rej > reg.lambda_max,
                                 code(c.status, SolverStatus.FAIL_LAMBDA_MAX),
                                 running_code)

        def pick3(on_acc, on_rej, on_adv):
            return torch.where(accept, on_acc,
                               torch.where(full_reject, on_rej, on_adv))

        new = _CarryBL(
            xs=torch.where(accept, nxs, c.xs),
            us=torch.where(accept, nus, c.us),
            cost=ncost.map(lambda n, o: torch.where(accept, n, o), c.cost),
            pc=torch.where(accept, npc, c.pc),
            lam=pick3(lam_acc, lam_rej, c.lam),
            dlam=pick3(dlam_acc, dlam_rej, c.dlam),
            status=pick3(status_acc, status_rej, running_code),
            it=c.it + concluded.to(i32),
            aidx=torch.where(concluded, torch.zeros_like(c.aidx),
                             c.aidx + k_alpha),
            clip=c.clip | clip1 | clip2,
        )

        def keep_gnorm(n, o):
            return torch.where(gnorm_done, o, n)

        new = _CarryBL(
            xs=keep_gnorm(new.xs, c.xs),
            us=keep_gnorm(new.us, c.us),
            cost=new.cost.map(keep_gnorm, c.cost),
            pc=keep_gnorm(new.pc, c.pc),
            lam=keep_gnorm(new.lam, c.lam),
            dlam=keep_gnorm(new.dlam, c.dlam),
            status=torch.where(gnorm_done,
                               code(c.status, SolverStatus.SUCCESS_GNORM),
                               new.status),
            it=torch.where(gnorm_done, c.it + 1, new.it),
            aidx=torch.where(gnorm_done, torch.zeros_like(new.aidx),
                             new.aidx),
            clip=new.clip,   # monotone flag: never reverted
        )

        # freeze non-RUNNING lanes
        running = c.status == SolverStatus.RUNNING
        return _tree_map(lambda n, o: torch.where(running, n, o), new, c)

    return body


def _run_carry(carry: _CarryBL, goals, cbl, cfg, veh, dt,
               iter_cap: int, trip_cap: int = 0) -> _CarryBL:
    """Run the outer loop until every lane concludes or reaches iter_cap
    ITERATIONS (statuses stay RUNNING at the cap so a later run resumes).
    trip_cap > 0 additionally bounds the number of loop TRIPS (line-search
    steps), handing stragglers to the compaction cascade; lanes resume
    mid-line-search via the aidx carry, so per-lane decisions are
    unchanged. ``profiling.counters``' ``"blast.trips"`` counts the trips
    run."""
    body = _make_body(goals, cbl, cfg, veh, dt)
    c = carry
    trips = 0
    while not (trip_cap and trips >= trip_cap):
        if not _any((c.status == SolverStatus.RUNNING) & (c.it < iter_cap)):
            break
        c = body(c)
        trips += 1
    tally("blast.trips", trips)
    return c


def _bl(a):
    """[B, N, k] -> [k, N, B]."""
    return a.permute(2, 1, 0).contiguous()


def _bf(a):
    """[k, N, B] -> [B, N, k]."""
    return a.permute(2, 1, 0).contiguous()


def _prep(goals_bf, starts, cons, cfg, veh, dt, warm_start):
    """transform_goals + init guess + batch-last layout + constraint prep
    + initial carry. Returns (goals_first, goals, cbl, init_carry,
    xs0_bf, us0_bf)."""
    dtype, device = goals_bf.dtype, goals_bf.device
    B = goals_bf.shape[0]
    goals_first = transform_goals(goals_bf, starts)
    if warm_start is None:
        with span("solve.guess"):
            xs0_bf, us0_bf = iqr_init(goals_first, cfg, veh, dt)
    else:
        xs0_bf, us0_bf = warm_start
    goals = _bl(goals_first)                               # [6, N, B]
    xs0 = _bl(xs0_bf)
    us0 = _bl(us0_bf)
    cbl = cons_to_bl(cons, goals_bl=goals, lane_window=cfg.lane_window)
    cost0, pc0, clip0 = _cost_stack_bl(xs0, us0, goals, cbl, cfg, veh,
                                       False)
    kw = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    init = _CarryBL(
        xs=xs0, us=us0, cost=cost0, pc=pc0,
        lam=torch.full((B,), cfg.reg.lambda_init, **kw),
        dlam=torch.ones((B,), **kw),
        status=torch.full((B,), int(SolverStatus.RUNNING), **i32),
        it=torch.zeros((B,), **i32),
        aidx=torch.zeros((B,), **i32),
        clip=clip0)
    return goals_first, goals, cbl, init, xs0_bf, us0_bf


def _finalize(final: _CarryBL, xs0_bf, us0_bf) -> SolveResult:
    status = torch.where(final.status == SolverStatus.RUNNING,
                         torch.full_like(final.status,
                                         int(SolverStatus.MAX_ITER)),
                         final.status)
    return SolveResult(xs=_bf(final.xs), us=_bf(final.us), status=status,
                       iters=final.it, cost=final.cost, lam=final.lam,
                       init_xs=xs0_bf, init_us=us0_bf,
                       lane_clipped=final.clip)


def solve_batch_bl(goals_bf, starts, cons: ConstraintSet,
                   cfg: IlqrConfig, veh: VehicleParam, dt,
                   warm_start=None) -> SolveResult:
    """Batched solve, batch-last internals. goals_bf [B, N, 6],
    starts [B, 6], cons leaves [B, ...]. Returns a batch-first SolveResult.

    With cfg.compaction_phase1 > 0, delegates to solve_batch_compact
    (identical per-lane decisions; see there)."""
    if cfg.compaction_phase1 > 0 and goals_bf.shape[0] > 2:
        return solve_batch_compact(goals_bf, starts, cons, cfg, veh, dt,
                                   warm_start=warm_start)
    _, goals, cbl, init, xs0_bf, us0_bf = _prep(
        goals_bf, starts, cons, cfg, veh, dt, warm_start)
    final = _run_carry(init, goals, cbl, cfg, veh, dt, cfg.max_iter_num)
    return _finalize(final, xs0_bf, us0_bf)


class _StateBF(NamedTuple):
    """Full solver carry in batch-first layout (for row gathers)."""

    xs: torch.Tensor        # [B, N, 6]
    us: torch.Tensor        # [B, T, 2]
    cost: CostBreakdown     # [B] leaves
    pc: torch.Tensor        # [B, N]
    lam: torch.Tensor
    dlam: torch.Tensor
    status: torch.Tensor
    it: torch.Tensor
    aidx: torch.Tensor
    clip: torch.Tensor


def _carry_to_bf(c: _CarryBL) -> _StateBF:
    return _StateBF(xs=_bf(c.xs), us=_bf(c.us), cost=c.cost,
                    pc=c.pc.t().contiguous(), lam=c.lam, dlam=c.dlam,
                    status=c.status, it=c.it, aidx=c.aidx, clip=c.clip)


def _carry_from_bf(s: _StateBF) -> _CarryBL:
    return _CarryBL(xs=_bl(s.xs), us=_bl(s.us), cost=s.cost,
                    pc=s.pc.t().contiguous(), lam=s.lam, dlam=s.dlam,
                    status=s.status, it=s.it, aidx=s.aidx, clip=s.clip)


def solve_batch_compact(goals_bf, starts, cons: ConstraintSet,
                        cfg: IlqrConfig, veh: VehicleParam, dt,
                        warm_start=None) -> SolveResult:
    """Two-phase solve with converged-lane compaction.

    Phase 1 runs the full batch to cfg.compaction_phase1 iterations (and
    at most cfg.compaction_phase1_trips trips); the still-running lanes are
    then gathered (complete solver carry) into rounds of halving width and
    run to conclusion. No body operation reduces over the batch axis, so a
    lane's decisions do not depend on its batch position."""
    B = goals_bf.shape[0]
    goals_first, goals, cbl, init, xs0_bf, us0_bf = _prep(
        goals_bf, starts, cons, cfg, veh, dt, warm_start)
    c1 = _run_carry(init, goals, cbl, cfg, veh, dt, cfg.compaction_phase1,
                    trip_cap=cfg.compaction_phase1_trips)
    st = _carry_to_bf(c1)

    def one_round(s: _StateBF, width: int, cap: int) -> _StateBF:
        """Gather `width` lanes (running first), run to `cap` iterations,
        scatter back. Lanes still running at the cap resume later."""
        running = ((s.status == SolverStatus.RUNNING)
                   & (s.it < cfg.max_iter_num))
        # running lanes first; stable, as jnp.argsort is
        idx = torch.argsort((~running).to(torch.int32), stable=True)[:width]
        sub = _tree_map(lambda a: a[idx], s)
        gsub = goals_first[idx]
        csub = cons.map(lambda a: a[idx])
        gl = _bl(gsub)
        cblk = cons_to_bl(csub, goals_bl=gl, lane_window=cfg.lane_window)
        out = _run_carry(_carry_from_bf(sub), gl, cblk, cfg, veh, dt, cap)
        return _tree_map(lambda full, part: full.index_copy(0, idx, part),
                         s, _carry_to_bf(out))

    # cascade: halve the width each stage (doubling the iteration cap);
    # with the kernel sweep active the width floors at one 128-lane block
    floor_w = 1
    if cfg.sweep_backend != "xla" and goals_bf.device.type == "cuda" \
            and B % NB == 0:
        floor_w = min(B, NB)
    width = min(B, max(floor_w, B // max(1, cfg.compaction_factor)))
    cap = cfg.compaction_phase1
    while width > NB:
        cap *= 2
        st = one_round(st, width, cap)
        width //= 2

    # mop-up rounds at the final width until every lane concludes
    while _any((st.status == SolverStatus.RUNNING)
               & (st.it < cfg.max_iter_num)):
        st = one_round(st, width, cfg.max_iter_num)
    return _finalize(_carry_from_bf(st), xs0_bf, us0_bf)
