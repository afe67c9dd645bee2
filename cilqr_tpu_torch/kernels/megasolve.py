"""Full-solve megakernel: the whole serial-line-search CILQR loop in one
launch. The CUDA kernel ``csrc/megasolve.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel
``cilqr_tpu/pallas/megasolve.py::solve_batch_mega`` (``_mega_kernel``).
Semantics follow that kernel (ilqr_optimizer.cc:154-320): the initial cost,
then trips of analytic midpoint Jacobians, cost derivatives over a FULL
lane-segment scan (first index wins ties), a Riccati backward pass, ONE
rollout at the lane's current alpha, the candidate's cost and the accept,
lambda and status rules with dcost = cost_old - cost_new; at the end a lane
still RUNNING becomes MAX_ITER. The loop exits per BLOCK of ``block_nb``
lanes: a block runs while any of its lanes is RUNNING below
``max_iter_num``, and every RUNNING lane of a running block takes the trip,
so a lane can finish with more iterations than the cap (as the Pallas
kernel does). Barrier branches are the kernel's: the quadratic branch's
value carries ``- rt*log(eps)`` and its Hessian drops the ddx term.

The plain version (``solve_batch_mega_ref``) and the kernel perform the same
sequence of separately rounded operations, so that on the card they agree
exactly (chip_smoke.py checks it) and the threshold-chaotic accept tests
decide alike: every sum runs in one fixed order (knots, planes then discs,
segments), divisions by a constant are multiplications by its reciprocal
formed in double precision (as PyTorch on the card divides a tensor by a
Python scalar), and the kernel contracts no multiply-add. Constants are
Python floats that both round to the working type the same way
(``_constants``; the kernel reads them by the index in ``CONSTANTS``).
The Riccati pass and the rollout step here (``_backward``,
``_forward_step``) are also the sweep kernel's plain version.

``solve_batch_mega`` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; ``solve_batch_mega_plain`` runs the plain
version on any device, for comparison.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace

import torch

from .. import profiling
from ..costs import ConstraintSet
from ..solver import iqr_init, transform_goals
from ..types import CostBreakdown, SolveResult, SolverStatus
from . import _build

NB = 128            # lanes per block (the Pallas kernel's NB)
MAX_BLOCK = 256     # csrc/megasolve.cu: kMaxBlock
MAX_DISCS = 8       # csrc/megasolve.cu: kMaxDiscs
MAX_ALPHAS = 16     # csrc/megasolve.cu: kMaxAlphas
FAR = 1.0e7         # invalid lane segments are pushed this far away (m)
RUNNING = int(SolverStatus.RUNNING)

# Scalar constants, in the order of csrc/megasolve.cu's enum Const.
CONSTANTS = (
    "pi", "two_pi", "inv_two_pi",
    "dt", "hdt", "hdt2", "neg_dt", "inv_L",
    "wx", "wy", "wth", "wj", "wdr",
    "wx2", "wy2", "wth2", "wv2", "wa2", "wd2", "wj2", "wdr2",
    "vmax", "amax", "amin", "dmax", "dmin", "jmax", "jmin", "drmax",
    "drmin",
    "neg_eps", "two_eps", "inv_eps", "rt", "neg_rt", "half_rt",
    "rt_log_eps", "rt_inv_eps2",
    "beta_min", "beta_max", "abs_tol", "rel_tol",
    "lambda_init", "ratio", "inv_ratio", "lambda_min", "lambda_max",
    "gnorm_min", "gnorm_lam", "inv_T",
)


def _step_constants(dt, wheel_base) -> SimpleNamespace:
    """The constants of the dynamics (angle wrap, RK2 step, Jacobians) as
    Python floats; the sweep kernel's plain version uses them too."""
    dt = float(dt)
    return SimpleNamespace(
        pi=math.pi, two_pi=2.0 * math.pi, inv_two_pi=1.0 / (2.0 * math.pi),
        dt=dt, hdt=0.5 * dt, hdt2=0.5 * dt * dt, neg_dt=-dt,
        inv_L=1.0 / wheel_base)


def _constants(cfg, veh, dt, T: int) -> SimpleNamespace:
    """The solve's scalar constants as Python floats (double precision),
    each formed as the Pallas kernel forms it from its Python operands."""
    w, lim = cfg.weights, veh
    t, eps = cfg.barrier.t, cfg.barrier.epsilon
    rt = 1.0 / t
    reg = cfg.reg
    c = dict(
        **vars(_step_constants(dt, veh.wheel_base)),
        wx=w.x_target, wy=w.y_target, wth=w.theta, wj=w.jerk,
        wdr=w.delta_rate,
        wx2=2.0 * w.x_target, wy2=2.0 * w.y_target, wth2=2.0 * w.theta,
        wv2=2.0 * w.v, wa2=2.0 * w.a, wd2=2.0 * w.delta, wj2=2.0 * w.jerk,
        wdr2=2.0 * w.delta_rate,
        vmax=lim.max_velocity, amax=lim.max_acceleration,
        amin=lim.min_acceleration, dmax=lim.delta_max, dmin=lim.delta_min,
        jmax=lim.jerk_max, jmin=lim.jerk_min, drmax=lim.delta_rate_max,
        drmin=lim.delta_rate_min,
        neg_eps=-eps, two_eps=2.0 * eps, inv_eps=1.0 / eps, rt=rt,
        neg_rt=-rt, half_rt=0.5 * rt, rt_log_eps=rt * math.log(eps),
        rt_inv_eps2=rt / (eps * eps),
        beta_min=cfg.line_search.beta_min, beta_max=cfg.line_search.beta_max,
        abs_tol=cfg.abs_cost_tol, rel_tol=cfg.rel_cost_tol,
        lambda_init=reg.lambda_init, ratio=reg.ratio,
        inv_ratio=1.0 / reg.ratio, lambda_min=reg.lambda_min,
        lambda_max=reg.lambda_max, gnorm_min=reg.gradient_norm_min,
        gnorm_lam=1e-5, inv_T=1.0 / T,
    )
    assert tuple(c) == CONSTANTS
    seg = veh.length / cfg.num_of_disc
    # disc offsets along the heading (ilqr_optimizer.cc:556-565)
    c["offs"] = tuple(seg * (d - 0.5) - veh.rear_hang_length
                      for d in range(cfg.num_of_disc))
    c["alphas"] = tuple(float(a) for a in cfg.line_search.alphas)
    c["max_iter"] = int(cfg.max_iter_num)
    return SimpleNamespace(**c)


# ---------------------------------------------------------------------------
# per-knot pieces (the kernel's formulas; every tensor batch-last)
# ---------------------------------------------------------------------------


def _wrap(x, c):
    """Angle wrap x - 2pi floor((x + pi) / 2pi), the division taken as a
    multiplication by 1/(2pi)."""
    return x - torch.floor((x + c.pi) * c.inv_two_pi) * c.two_pi


def _bar_value(g, c):
    """Relax barrier value, both branches from min(g, -eps)."""
    safe = torch.clamp(g, max=c.neg_eps)
    logb = torch.log(-safe) * c.neg_rt
    q = (-g - c.two_eps) * c.inv_eps
    quadb = (q * q - 1.0) * c.half_rt - c.rt_log_eps
    return torch.where(g < c.neg_eps, logb, quadb)


def _bar_derivs(g, c):
    """(gradient factor, dxdx factor, ddx factor) of the relax barrier; the
    quadratic branch uses B'(x) as the dxdx factor and drops ddx
    (barrier_function.h:135-139)."""
    safe = torch.clamp(g, max=c.neg_eps)
    in_log = g < c.neg_eps
    quad = (g + c.two_eps) * c.rt_inv_eps2
    ddx_log = torch.reciprocal(safe) * c.neg_rt
    grad = torch.where(in_log, ddx_log, quad)
    hf = torch.where(in_log, torch.reciprocal(safe * safe) * c.rt, quad)
    hd = torch.where(in_log, ddx_log, torch.zeros_like(g))
    return grad, hf, hd


def _discs(xs, c):
    """Disc centres of every knot: (lc, ls, cx, cy), each [D, N, B]."""
    offs = torch.tensor(c.offs, dtype=xs.dtype, device=xs.device)[:, None,
                                                                  None]
    th = xs[:, 2]
    lc = offs * torch.cos(th)[None]
    ls = offs * torch.sin(th)[None]
    return lc, ls, xs[:, 0][None] + lc, xs[:, 1][None] + ls


def _select_lane(cx, cy, lane):
    """Nearest segment of one lane side for every disc centre, by a full
    scan of its S segments; the first index wins ties (a strict running
    minimum from segment 0). cx, cy [D, N, B]; lane [7, S, B] rows
    (a, b, c, x1, y1, x2, y2) -> the selected (a, b, c), each [D, N, B]."""
    x1, y1, x2, y2 = (lane[i] for i in range(3, 7))         # [S, B]
    abx = x2 - x1
    aby = y2 - y1
    ab2 = abx * abx + aby * aby
    px = cx[:, :, None]                                      # [D, N, 1, B]
    py = cy[:, :, None]
    apx = px - x1
    apy = py - y1
    num = apx * abx + apy * aby
    tt = torch.where(ab2 > 0, num / torch.where(ab2 == 0, 1.0, ab2), 0.0)
    tt = torch.clamp(tt, 0.0, 1.0)
    dx = px - (x1 + tt * abx)
    dy = py - (y1 + tt * aby)
    d = torch.sqrt(dx * dx + dy * dy)                        # [D, N, S, B]
    best = d[:, :, 0]
    idx = torch.zeros(best.shape, dtype=torch.long, device=d.device)
    for s in range(1, d.shape[2]):   # a NaN at segment 0 keeps segment 0
        upd = d[:, :, s] < best
        best = torch.where(upd, d[:, :, s], best)
        idx = torch.where(upd, s, idx)
    sel = idx[:, :, None]

    def pick(row):
        return torch.gather(row.expand(d.shape), 2, sel)[:, :, 0]

    return pick(lane[0]), pick(lane[1]), pick(lane[2])


def _knot_costs(xs, us, goals, cons, c):
    """Per-knot cost components [4, N, B]: target, dynamic, corridor, lane.
    xs, goals [N, 6, B]; us [T, 2, B]; cons = (ca, cb, cc [N, KC, B],
    laneL, laneR [7, S, B]) with masks folded."""
    ca, cb, cc, laneL, laneR = cons
    T = us.shape[0]
    x0, x1, th, v, a, de = (xs[:, i] for i in range(6))
    jk, dr = us[:, 0], us[:, 1]
    dx = x0 - goals[:, 0]
    dy = x1 - goals[:, 1]
    dth = th - goals[:, 2]
    tk = c.wx * dx * dx + c.wy * dy * dy + c.wth * dth * dth
    tk = torch.cat([tk[:T] + (c.wj * jk * jk + c.wdr * dr * dr), tk[T:]])

    dk = _bar_value(-v, c)
    for g in (v - c.vmax, a - c.amax, c.amin - a, de - c.dmax, c.dmin - de):
        dk = dk + _bar_value(g, c)
    dku = dk[:T]
    for g in (jk - c.jmax, c.jmin - jk, dr - c.drmax, c.drmin - dr):
        dku = dku + _bar_value(g, c)
    dk = torch.cat([dku, dk[T:]])

    _, _, cx, cy = _discs(xs, c)
    D, KC = cx.shape[0], ca.shape[1]
    g = ca[None] * cx[:, :, None] + cb[None] * cy[:, :, None] - cc[None]
    vals = _bar_value(g, c)                                  # [D, N, KC, B]
    ck = torch.zeros_like(x0)
    for k in range(KC):
        for d in range(D):
            ck = ck + vals[d, :, k]

    sels = [_select_lane(cx, cy, lane) for lane in (laneL, laneR)]
    lvals = torch.stack([_bar_value(sa * cx + sb * cy - sc, c)
                         for sa, sb, sc in sels])            # [2, D, N, B]
    lk = torch.zeros_like(x0)
    for d in range(D):
        for s in range(2):
            lk = lk + lvals[s, d]
    return torch.stack([tk, dk, ck, lk])


def _cost(xs, us, goals, cons, c):
    """Cost rows [5, B] (total, target, dynamic, corridor, lane): per-knot
    components summed knot by knot in order."""
    pk = _knot_costs(xs, us, goals, cons, c)
    acc = torch.zeros_like(pk[:, 0])
    for t in range(pk.shape[1]):
        acc = acc + pk[:, t]
    total = acc[0] + acc[1] + acc[2] + acc[3]
    return torch.cat([total[None], acc])


def _knot_derivs(xs, us, goals, cons, c):
    """Cost Jacobians and Hessians (ilqr_optimizer.cc:620-769), per knot:
    Jx [N, 6, B], Hx [N, 6, 6, B], Ju [T, 2, B], Hu [T, 2, 2, B]."""
    ca, cb, cc, laneL, laneR = cons
    x0, x1, th, v, a, de = (xs[:, i] for i in range(6))
    jk, dr = us[:, 0], us[:, 1]
    dx = x0 - goals[:, 0]
    dy = x1 - goals[:, 1]
    dth = th - goals[:, 2]
    zN = torch.zeros_like(x0)

    jx = [zN, zN, zN]
    h = {3: zN + c.wv2, 4: zN + c.wa2, 5: zN + c.wd2}
    for g, sign, row in ((-v, -1.0, 3), (v - c.vmax, 1.0, 3),
                         (a - c.amax, 1.0, 4), (c.amin - a, -1.0, 4),
                         (de - c.dmax, 1.0, 5), (c.dmin - de, -1.0, 5)):
        gf, hf, _ = _bar_derivs(g, c)
        jx[row - 3] = jx[row - 3] + gf * sign
        h[row] = h[row] + hf
    ju = [c.wj2 * jk, c.wdr2 * dr]
    zT = torch.zeros_like(jk)
    hu = [zT + c.wj2, zT + c.wdr2]
    for g, sign, row in ((jk - c.jmax, 1.0, 0), (c.jmin - jk, -1.0, 0),
                         (dr - c.drmax, 1.0, 1), (c.drmin - dr, -1.0, 1)):
        gf, hf, _ = _bar_derivs(g, c)
        ju[row] = ju[row] + gf * sign
        hu[row] = hu[row] + hf

    # rows jx0, jx1, jx2, h00, h01, h02, h11, h12, h22
    acc = torch.stack([c.wx2 * dx, c.wy2 * dy, c.wth2 * dth, zN + c.wx2,
                       zN, zN, zN + c.wy2, zN, zN + c.wth2])
    lc, ls, cx, cy = _discs(xs, c)
    D, KC = cx.shape[0], ca.shape[1]
    pa, pb = ca[None], cb[None]                              # [1, N, KC, B]
    lc4, ls4 = lc[:, :, None], ls[:, :, None]                # [D, N, 1, B]
    g = pa * cx[:, :, None] + pb * cy[:, :, None] - cc[None]
    dthk = -pa * ls4 + pb * lc4
    gf, hf, hd = _bar_derivs(g, c)
    ddx22 = -pa * lc4 - pb * ls4
    terms = torch.stack([
        gf * pa, gf * pb, gf * dthk, hf * pa * pa, hf * pa * pb,
        hf * pa * dthk, hf * pb * pb, hf * pb * dthk,
        hf * dthk * dthk + hd * ddx22])                      # [9, D, N, KC, B]
    for k in range(KC):
        for d in range(D):
            acc = acc + terms[:, d, :, k]

    rows, extra = [], []
    for lane in (laneL, laneR):
        la, lb, lcc = _select_lane(cx, cy, lane)             # [D, N, B]
        lg = la * cx + lb * cy - lcc
        ldth = -la * ls + lb * lc
        lgf, lhf, lhd = _bar_derivs(lg, c)
        lddx22 = -la * lc - lb * ls
        rows.append(torch.stack([
            lgf * la, lgf * lb, lgf * ldth, lhf * la * la, lhf * la * lb,
            lhf * la * ldth, lhf * lb * lb, lhf * lb * ldth,
            lhf * ldth * ldth]))                             # [9, D, N, B]
        extra.append(lhd * lddx22)
    for d in range(D):
        for s in range(2):
            acc = acc + rows[s][:, d]
            acc[8] = acc[8] + extra[s][d]

    Jx = torch.stack([acc[0], acc[1], acc[2]] + jx, dim=1)
    h00, h01, h02, h11, h12, h22 = acc[3:]
    Hx = torch.stack([
        torch.stack([h00, h01, h02, zN, zN, zN], dim=1),
        torch.stack([h01, h11, h12, zN, zN, zN], dim=1),
        torch.stack([h02, h12, h22, zN, zN, zN], dim=1),
        torch.stack([zN, zN, zN, h[3], zN, zN], dim=1),
        torch.stack([zN, zN, zN, zN, h[4], zN], dim=1),
        torch.stack([zN, zN, zN, zN, zN, h[5]], dim=1)], dim=1)
    Ju = torch.stack(ju, dim=1)
    Hu = torch.stack([torch.stack([hu[0], zT], dim=1),
                      torch.stack([zT, hu[1]], dim=1)], dim=1)
    return Jx, Hx, Ju, Hu


def _jacobians(xs, us, c):
    """Analytic midpoint Jacobians (vehicle_model.cc:44-86, with its
    v-vs-v_mid quirk): A [T, 6, 6, B], Bm [T, 6, 2, B]."""
    T = us.shape[0]
    v = xs[:T, 3]
    theta = _wrap(xs[:T, 2], c)
    delta = _wrap(xs[:T, 5], c)
    a = xs[:T, 4]
    delta_rate = us[:, 1]
    tan_delta = torch.tan(delta)
    theta_mid = theta + c.hdt * v * tan_delta * c.inv_L
    tan_dr = torch.tan(delta + c.hdt * delta_rate)
    cos_tm = torch.cos(theta_mid)
    sin_tm = torch.sin(theta_mid)
    td2 = tan_delta * tan_delta
    tdr2 = tan_dr * tan_dr
    v_mid = 0.5 * a * c.dt + v
    z = torch.zeros_like(v)
    o = torch.ones_like(v)
    A = torch.stack([
        torch.stack([o, z, c.neg_dt * v_mid * sin_tm,
                     c.dt * cos_tm - c.hdt2 * v_mid * sin_tm * tan_delta
                     * c.inv_L,
                     c.hdt2 * cos_tm,
                     -c.hdt2 * v * v_mid * (td2 + 1.0) * sin_tm * c.inv_L]),
        torch.stack([z, o, c.dt * v_mid * cos_tm,
                     c.dt * sin_tm + c.hdt2 * v_mid * cos_tm * tan_delta
                     * c.inv_L,
                     c.hdt2 * sin_tm,
                     c.hdt2 * v * v_mid * (td2 + 1.0) * cos_tm * c.inv_L]),
        torch.stack([z, z, o, c.dt * tan_dr * c.inv_L,
                     c.hdt2 * tan_dr * c.inv_L,
                     c.dt * v * (tdr2 + 1.0) * c.inv_L]),
        torch.stack([z, z, z, o, z + c.dt, z]),
        torch.stack([z, z, z, z, o, z]),
        torch.stack([z, z, z, z, z, o]),
    ])                                                       # [6, 6, T, B]
    Bm = torch.stack([
        torch.stack([z, z]),
        torch.stack([z, z]),
        torch.stack([z, c.hdt2 * v * (tdr2 + 1.0) * c.inv_L]),
        torch.stack([z + c.hdt2, z]),
        torch.stack([z + c.dt, z]),
        torch.stack([z, z + c.dt]),
    ])                                                       # [6, 2, T, B]
    return A.movedim(2, 0), Bm.movedim(2, 0)


def _mm(X, Y):
    """[m, k, B] @ [k, n, B] -> [m, n, B], summed over k in order."""
    acc = X[:, 0, None] * Y[0][None]
    for i in range(1, X.shape[1]):
        acc = acc + X[:, i, None] * Y[i][None]
    return acc


def _mv(X, y):
    """[m, k, B] @ [k, B] -> [m, B], summed over k in order."""
    acc = X[:, 0] * y[0]
    for i in range(1, X.shape[1]):
        acc = acc + X[:, i] * y[i]
    return acc


def _backward(lam, A, Bm, Jx, Hx, Ju, Hu, us):
    """Regularized Riccati backward pass (ilqr_optimizer.cc:334-390):
    (Ks [T, 2, 6, B], ks [T, 2, B], dV0, dV1, gnorm); gnorm is the mean over
    t of max over u of |k| / (|u| + 1), against the current us. The sweep
    kernel's plain version is this pass too."""
    T = us.shape[0]
    Vx, Vxx = Jx[T], Hx[T]
    dV0 = torch.zeros_like(lam)
    dV1 = torch.zeros_like(lam)
    gacc = torch.zeros_like(lam)
    Ks, ks = [None] * T, [None] * T
    for t in range(T - 1, -1, -1):
        Ai, Bi = A[t], Bm[t]
        At, Bt = Ai.transpose(0, 1), Bi.transpose(0, 1)
        Qx = Jx[t] + _mv(At, Vx)
        Qu = Ju[t] + _mv(Bt, Vx)
        Qxx = Hx[t] + _mm(_mm(At, Vxx), Ai)
        BtV = _mm(Bt, Vxx)
        Quu = Hu[t] + _mm(BtV, Bi)
        Qux = _mm(BtV, Ai)
        ma, mb = Quu[0, 0] + lam, Quu[0, 1]
        mc, md = Quu[1, 0], Quu[1, 1] + lam
        inv_det = torch.reciprocal(ma * md - mb * mc)
        Qi = torch.stack([torch.stack([md * inv_det, -mb * inv_det]),
                          torch.stack([-mc * inv_det, ma * inv_det])])
        K = -_mm(Qi, Qux)
        k = -_mv(Qi, Qu)
        Kt, Quxt = K.transpose(0, 1), Qux.transpose(0, 1)
        Quk = _mv(Quu, k)
        Vx = Qx + _mv(Kt, Quk) + _mv(Kt, Qu) + _mv(Quxt, k)
        V = Qxx + _mm(Kt, _mm(Quu, K)) + _mm(Kt, Qux) + _mm(Quxt, K)
        Vxx = 0.5 * (V + V.transpose(0, 1))
        dV0 = dV0 + (k[0] * Qu[0] + k[1] * Qu[1])
        dV1 = dV1 + 0.5 * (k[0] * Quk[0] + k[1] * Quk[1])
        u = us[t]
        gacc = gacc + torch.maximum(k[0].abs() / (u[0].abs() + 1.0),
                                    k[1].abs() / (u[1].abs() + 1.0))
        Ks[t], ks[t] = K, k
    return torch.stack(Ks), torch.stack(ks), dV0, dV1, gacc * (1.0 / T)


def _f_cont(s, u, c):
    th = _wrap(s[2], c)
    dl = _wrap(s[5], c)
    return torch.stack([s[3] * torch.cos(th), s[3] * torch.sin(th),
                        s[3] * torch.tan(dl) * c.inv_L, s[4], u[0], u[1]])


def _forward_step(x, t, alpha, Ks, ks, xs, us, c):
    """One step of the closed-loop RK2 rollout (ilqr_optimizer.cc:392-415)
    from state x [6, B] at per-lane alpha [B]: (u [2, B], next x [6, B]).
    The sweep kernel's plain version takes this step too."""
    u = us[t] + _mv(Ks[t], x - xs[t]) + alpha * ks[t]
    u = torch.stack([u[0], _wrap(u[1], c)])
    mid = x + c.hdt * _f_cont(x, u, c)
    nxt = x + c.dt * _f_cont(mid, u, c)
    return u, torch.stack([nxt[0], nxt[1], _wrap(nxt[2], c), nxt[3],
                           nxt[4], _wrap(nxt[5], c)])


def _forward(alpha, xs, us, Ks, ks, c):
    """The rollout from xs[0]: (xs [N, 6, B], us [T, 2, B])."""
    x = xs[0]
    nxs, nus = [x], []
    for t in range(us.shape[0]):
        u, x = _forward_step(x, t, alpha, Ks, ks, xs, us, c)
        nxs.append(x)
        nus.append(u)
    return torch.stack(nxs), torch.stack(nus)


# ---------------------------------------------------------------------------
# the plain version of the kernel
# ---------------------------------------------------------------------------


def solve_batch_mega_ref(goals, xs0, us0, ca, cb, cc, laneL, laneR, cfg, veh,
                         dt, block_nb: int = NB):
    """Plain PyTorch version of the kernel, batch-last: goals, xs0 [N, 6, B];
    us0 [T, 2, B]; ca, cb, cc [N, KC, B] and laneL, laneR [7, S, B] with the
    masks folded (``_fold_constraints``); B a multiple of block_nb.

    Returns (xs [N, 6, B], us [T, 2, B], fs [6, B] = cost total, target,
    dynamic, corridor, lane and lam; istate [4, B] int32 = status, iters,
    the trips the lane took while RUNNING and the relinearizations among
    them (the trips that did not retry the last one's at the next alpha);
    block_trips [B / block_nb] int32, the trips each block ran)."""
    N, _, B = goals.shape
    T = N - 1
    c = _constants(cfg, veh, dt, T)
    dtype, dev = goals.dtype, goals.device
    cons = (ca, cb, cc, laneL, laneR)
    alphas = torch.tensor(c.alphas, dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    nblk = B // block_nb

    xs, us = xs0.clone(), us0.clone()
    cost = _cost(xs, us, goals, cons, c)                    # [5, B]
    lam = torch.full((B,), c.lambda_init, dtype=dtype, device=dev)
    dlam = torch.ones((B,), dtype=dtype, device=dev)
    status = torch.zeros((B,), **i32)
    it = torch.zeros((B,), **i32)
    aidx = torch.zeros((B,), **i32)
    lane_trips = torch.zeros((B,), **i32)
    relins = torch.zeros((B,), **i32)
    alive = torch.ones((nblk,), dtype=torch.bool, device=dev)
    block_trips = torch.zeros((nblk,), **i32)
    code = {s: torch.full((B,), int(s), **i32) for s in SolverStatus}

    while True:
        running = (status == RUNNING) & alive.repeat_interleave(block_nb)
        block_trips += alive.to(torch.int32)
        lane_trips += running.to(torch.int32)
        relins += (running & (aidx == 0)).to(torch.int32)

        A, Bm = _jacobians(xs, us, c)
        Jx, Hx, Ju, Hu = _knot_derivs(xs, us, goals, cons, c)
        Ks, ks, dV0, dV1, gnorm = _backward(lam, A, Bm, Jx, Hx, Ju, Hu, us)
        gnorm_done = (gnorm < c.gnorm_min) & (lam < c.gnorm_lam)
        alpha = alphas[aidx.long()]
        cxs, cus = _forward(alpha, xs, us, Ks, ks, c)
        ncost = _cost(cxs, cus, goals, cons, c)

        cost_old = cost[0]
        dcost = cost_old - ncost[0]
        expected = -alpha * (dV0 + alpha * dV1)
        z = dcost / expected
        accept = (z > c.beta_min) & (z < c.beta_max) & (dcost > 0.0)
        full_reject = (~accept) & (aidx == len(c.alphas) - 1)
        concluded = accept | full_reject

        dlam_acc = torch.clamp(dlam * c.inv_ratio, max=c.inv_ratio)
        lam_acc = lam * dlam_acc * (lam > c.lambda_min).to(dtype)
        conv_abs = dcost < c.abs_tol
        conv_rel = (dcost / cost_old) < c.rel_tol
        status_acc = torch.where(
            conv_abs, code[SolverStatus.SUCCESS_ABS_COST],
            torch.where(conv_rel, code[SolverStatus.SUCCESS_REL_COST],
                        code[SolverStatus.RUNNING]))
        dlam_rej = torch.clamp(dlam * c.ratio, min=c.ratio)
        lam_rej = torch.clamp(lam * dlam_rej, min=c.lambda_min)
        status_rej = torch.where(lam_rej > c.lambda_max,
                                 code[SolverStatus.FAIL_LAMBDA_MAX],
                                 code[SolverStatus.RUNNING])

        def pick3(on_acc, on_rej, on_adv):
            return torch.where(accept, on_acc,
                               torch.where(full_reject, on_rej, on_adv))

        eff = running & ~gnorm_done
        upd = eff & accept
        xs = torch.where(upd, cxs, xs)
        us = torch.where(upd, cus, us)
        cost = torch.where(upd, ncost, cost)
        lam, dlam = (torch.where(eff, pick3(lam_acc, lam_rej, lam), lam),
                     torch.where(eff, pick3(dlam_acc, dlam_rej, dlam), dlam))
        s_new = pick3(status_acc, status_rej, code[SolverStatus.RUNNING])
        s_new = torch.where(gnorm_done, code[SolverStatus.SUCCESS_GNORM],
                            s_new)
        stepped = concluded | gnorm_done
        status = torch.where(running, s_new, status)
        it = torch.where(running, it + stepped.to(torch.int32), it)
        aidx = torch.where(running, torch.where(stepped, 0, aidx + 1), aidx)

        still = (status == RUNNING) & (it < c.max_iter)
        alive = alive & still.view(nblk, block_nb).any(1)
        if not bool(alive.any()):
            break

    status = torch.where(status == RUNNING, code[SolverStatus.MAX_ITER],
                         status)
    fs = torch.cat([cost, lam[None]])
    istate = torch.stack([status, it, lane_trips, relins])
    return xs, us, fs, istate, block_trips


# ---------------------------------------------------------------------------
# the kernel's launch
# ---------------------------------------------------------------------------


def _launch(goals, xs0, us0, ca, cb, cc, laneL, laneR, cfg, veh, dt,
            block_nb: int = NB):
    """Launch csrc/megasolve.cu on the batch-last operands of
    ``solve_batch_mega_ref``; same results. Scratch is allocated here,
    lane-major: two trajectories a lane (current and candidate), the gains,
    the candidate's lane barrier values and two lane selections."""
    N, _, B = goals.shape
    T = N - 1
    KC, S = ca.shape[1], laneL.shape[1]
    c = _constants(cfg, veh, dt, T)
    D = len(c.offs)
    dtype, dev = goals.dtype, goals.device
    kw = dict(dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    xs = torch.empty((N, 6, B), **kw)
    us = torch.empty((T, 2, B), **kw)
    fs = torch.empty((6, B), **kw)
    istate = torch.empty((4, B), **i32)
    block_trips = torch.empty((B // block_nb,), **i32)
    scratch = [torch.empty((B, 2, N * 6 + T * 2), **kw),
               torch.empty((B, T * 14), **kw),
               torch.empty((B, N * 2 * D), **kw),
               torch.empty((B, 2, N * 2 * D), **i32)]
    ptrs = [goals, xs0, us0, ca, cb, cc, laneL, laneR, xs, us, fs, istate,
            block_trips] + scratch
    cst = [getattr(c, name) for name in CONSTANTS]
    cst_c = (ctypes.c_double * len(cst))(*cst)
    offs_c = (ctypes.c_double * len(c.offs))(*c.offs)
    alphas_c = (ctypes.c_double * len(c.alphas))(*c.alphas)
    ptrs_c = (ctypes.c_void_p * len(ptrs))(*(t.data_ptr() for t in ptrs))
    lib = _build.library()
    fn = lib.solve_batch_mega_f32 if dtype == torch.float32 \
        else lib.solve_batch_mega_f64
    err = fn(N, B, KC, S, D, len(c.alphas), c.max_iter, block_nb,
             ctypes.cast(cst_c, ctypes.c_void_p),
             ctypes.cast(offs_c, ctypes.c_void_p),
             ctypes.cast(alphas_c, ctypes.c_void_p),
             ctypes.cast(ptrs_c, ctypes.c_void_p),
             ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    _build.check(err, "solve_batch_mega")
    profiling.tally("solve_batch_mega.launches")
    return xs, us, fs, istate, block_trips


def active_clusters(N: int, S: int, block_nb: int, dtype) -> int:
    """How many of the kernel's clusters (one exit block of block_nb lanes
    each) the current card runs at once, for N knots and S lane segments a
    side."""
    lib = _build.library()
    fn = lib.mega_active_clusters_f32 if dtype == torch.float32 \
        else lib.mega_active_clusters_f64
    out = ctypes.c_int(0)
    _build.check(fn(N, S, block_nb, ctypes.byref(out)), "solve_batch_mega")
    return out.value


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------


def _fold_constraints(cons: ConstraintSet, dtype):
    """Fold the masks into plane and segment values: an invalid corridor
    plane becomes (a, b, c) = (0, 0, 1), so g = -1 and its barrier value and
    derivatives are exactly 0; an invalid lane segment gets plane (0, 0, 1)
    and end points FAR metres away, so the nearest-segment scan never
    selects it while a valid one exists. Batch-first: returns ca, cb, cc
    [B, N, KC] and laneL, laneR [B, 7, S] (rows a, b, c, x1, y1, x2, y2)."""
    cm = cons.corridor_mask
    planes = cons.corridor_planes
    ca = torch.where(cm, planes[..., 0], 0.0).to(dtype)
    cb = torch.where(cm, planes[..., 1], 0.0).to(dtype)
    cc = torch.where(cm, planes[..., 2], 1.0).to(dtype)

    def lane(planes, segs, m):
        rows = [torch.where(m, planes[..., 0], 0.0),
                torch.where(m, planes[..., 1], 0.0),
                torch.where(m, planes[..., 2], 1.0),
                torch.where(m, segs[..., 0, 0], FAR),
                torch.where(m, segs[..., 0, 1], FAR),
                torch.where(m, segs[..., 1, 0], FAR),
                torch.where(m, segs[..., 1, 1], FAR)]
        return torch.stack(rows, dim=-2).to(dtype)

    return (ca, cb, cc,
            lane(cons.left_planes, cons.left_segs, cons.left_mask),
            lane(cons.right_planes, cons.right_segs, cons.right_mask))


def _check_inputs(goals_bf, starts, cons, cfg, block_nb):
    if cfg.barrier.kind != "relax":
        raise ValueError("the megakernel hardcodes RelaxBarrier semantics; "
                         f"barrier kind {cfg.barrier.kind!r} needs the "
                         "'blast' backend")
    dtype, dev = goals_bf.dtype, goals_bf.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"solve_batch_mega: unsupported dtype {dtype}")
    if goals_bf.dim() != 3 or goals_bf.shape[2] != 6:
        raise ValueError(f"solve_batch_mega: goals has shape "
                         f"{tuple(goals_bf.shape)}, expected (B, N, 6)")
    B, N = goals_bf.shape[:2]
    if tuple(starts.shape[:1]) != (B,) or starts.shape[1] < 4:
        raise ValueError(f"solve_batch_mega: starts has shape "
                         f"{tuple(starts.shape)}, expected ({B}, >= 4)")
    for name, v in zip(("starts",) + ConstraintSet._fields,
                       (starts,) + tuple(cons)):
        if v.device != dev:
            raise ValueError(f"solve_batch_mega: {name} is on {v.device}, "
                             f"goals on {dev}")
        if v.shape[0] != B:
            raise ValueError(f"solve_batch_mega: {name} has batch "
                             f"{v.shape[0]}, goals {B}")
        if v.dtype != torch.bool and v.dtype != dtype:
            raise ValueError(f"solve_batch_mega: {name} is {v.dtype}, "
                             f"goals {dtype}")
    if cons.corridor_planes.shape[1] != N:
        raise ValueError(f"solve_batch_mega: corridor planes have "
                         f"{cons.corridor_planes.shape[1]} knots, goals {N}")
    if not 0 < block_nb <= MAX_BLOCK:
        raise ValueError(f"solve_batch_mega: block_nb {block_nb} not in "
                         f"1..{MAX_BLOCK}")
    if not 0 < cfg.num_of_disc <= MAX_DISCS:
        raise ValueError(f"solve_batch_mega: {cfg.num_of_disc} discs, at "
                         f"most {MAX_DISCS}")
    if not 0 < len(cfg.line_search.alphas) <= MAX_ALPHAS:
        raise ValueError(f"solve_batch_mega: {len(cfg.line_search.alphas)} "
                         f"alphas, at most {MAX_ALPHAS}")


def _operands(goals_bf, starts, cons, cfg, veh, dt, warm_start, block_nb):
    """The kernel's batch-last operands (goals, xs0, us0, ca, cb, cc, laneL,
    laneR), padded to a multiple of block_nb with copies of lane 0; and the
    initial guess (xs0, us0), batch-first and unpadded."""
    with profiling.span("solve.operands"):
        _check_inputs(goals_bf, starts, cons, cfg, block_nb)
        B0 = goals_bf.shape[0]
        goals_first = transform_goals(goals_bf, starts)
    if warm_start is None:
        with profiling.span("solve.guess"):
            xs0_bf, us0_bf = iqr_init(goals_first, cfg, veh, dt)
    else:
        xs0_bf, us0_bf = warm_start
    with profiling.span("solve.operands"):
        gp, xp, up, cp = goals_first, xs0_bf, us0_bf, cons
        pad = (-B0) % block_nb
        if pad:
            def padded(a):
                return torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])

            gp, xp, up = padded(gp), padded(xp), padded(up)
            cp = cons.map(padded)

        def bl(a):                        # batch-first -> batch-last
            return a.movedim(0, -1).contiguous()

        folded = _fold_constraints(cp, goals_bf.dtype)
        ops = tuple(bl(a) for a in (gp, xp, up) + folded)
    return ops, (xs0_bf, us0_bf)


def _solve(run, goals_bf, starts, cons, cfg, veh, dt, warm_start, block_nb):
    """(SolveResult, the trips each block ran) of ``run``, the kernel's
    launch or its plain version."""
    ops, (xs0_bf, us0_bf) = _operands(goals_bf, starts, cons, cfg, veh, dt,
                                      warm_start, block_nb)
    B0 = goals_bf.shape[0]
    with profiling.span("solve.kernel"):
        xs, us, fs, istate, block_trips = run(*ops, cfg, veh, dt, block_nb)
    if profiling.active():
        # the trips of real lanes only: a padding lane's are waste
        profiling.count("mega.launches", 1)
        profiling.count("mega.lane_trips", istate[2, :B0])
        profiling.count("mega.relins", istate[3, :B0])
        profiling.count("mega.block_trips", block_trips)
        profiling.count("mega.block_lanes", block_trips * block_nb)

    def bf(a):                        # batch-last -> batch-first
        return a.movedim(-1, 0)[:B0]

    cost = CostBreakdown(*(fs[i, :B0] for i in range(5)))
    res = SolveResult(
        xs=bf(xs), us=bf(us), status=istate[0, :B0], iters=istate[1, :B0],
        cost=cost, lam=fs[5, :B0], init_xs=xs0_bf, init_us=us0_bf,
        # the full lane-segment scan never clips a window
        lane_clipped=torch.zeros((B0,), dtype=torch.bool,
                                 device=goals_bf.device))
    return res, block_trips


def solve_batch_mega(goals_bf, starts, cons: ConstraintSet, cfg, veh, dt,
                     warm_start=None, block_nb: int = NB) -> SolveResult:
    """Full-solve megakernel over a batch, batch-first like
    ``solver_blast.solve_batch_bl`` (goals [B, N, 6], starts [B, >=4],
    cons leaves [B, ...]). Pads the batch to a multiple of block_nb with
    copies of lane 0 (padding lanes solve and are dropped). CUDA tensors
    launch the kernel, once per call (or raise); CPU tensors take the plain
    version. Each launch adds one to ``profiling.counters``'
    ``"solve_batch_mega.launches"``."""
    run = _launch if goals_bf.device.type == "cuda" else solve_batch_mega_ref
    return _solve(run, goals_bf, starts, cons, cfg, veh, dt, warm_start,
                  block_nb)[0]


def solve_batch_mega_plain(goals_bf, starts, cons: ConstraintSet, cfg, veh,
                           dt, warm_start=None,
                           block_nb: int = NB) -> SolveResult:
    """``solve_batch_mega`` through the plain version on any device: the
    yardstick the kernel is held against on the card."""
    return _solve(solve_batch_mega_ref, goals_bf, starts, cons, cfg, veh, dt,
                  warm_start, block_nb)[0]
