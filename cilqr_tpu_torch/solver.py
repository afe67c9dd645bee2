"""The CILQR core (PyTorch counterpart of cilqr_tpu/solver.py): the goal
transform, the LQR initial guess, the Riccati backward pass, the
line-searched forward rollouts and the regularized outer loop
(IlqrOptimizer, ilqr_optimizer.cc:154-320).

Batch-first: ``solve`` runs B independent problems at once (a leading axis
on every input), each lane frozen once it concludes, as a vmapped
``lax.while_loop`` freezes it; an unbatched problem ([N, 6] goals) is a
batch of one. The JAX ``lax.scan``s over the horizon and the while-loop
are host loops here: one device sync per loop trip decides whether to run
the next. This is the semantic reference of the batch-last solve
(``batch.solve_batch(backend="vmap")``); it has no kernel of its own.

Replicated reference quirks (required for control parity):
  - the backward pass never reports divergence (LLT check commented out,
    :368-377);
  - lambda *= dlambda * (lambda > lambda_min) can zero lambda (:275);
  - delta_rate is angle-normalized in the forward pass (:408);
  - goals[0] is the start state and every rollout starts there
    (:404,:151).
"""

from __future__ import annotations

import dataclasses

import torch

from .config import IlqrConfig, VehicleParam
from .costs import ConstraintSet, cost_derivatives, total_cost
from .geometry import normalize_angle
from .model import dynamics_jacobian, dynamics_rk2
from .profiling import host, span, upload
from .types import CostBreakdown, SolveResult, SolverStatus, _Fields


def transform_goals(coarse_xs, start_state):
    """TransformGoals (ilqr_optimizer.cc:141-152): goals are the coarse
    states, with goal[0] overwritten by the actual start state
    (x, y, theta, v, 0, 0). coarse_xs [B, N, 6], start_state [B, >=4]."""
    g0 = torch.cat([start_state[:, :4],
                    torch.zeros_like(start_state[:, :2])], dim=-1)
    return torch.cat([g0[:, None], coarse_xs[:, 1:]], dim=1)


def _inv22(M):
    """Closed-form 2x2 inverse over leading axes: M [..., 2, 2]."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    inv_det = 1.0 / (a * d - b * c)
    return torch.stack([
        torch.stack([d, -b], dim=-1),
        torch.stack([-c, a], dim=-1),
    ], dim=-2) * inv_det[..., None, None]


def iqr_init(goals, cfg: IlqrConfig, veh: VehicleParam, dt):
    """Time-varying LQR initial guess around the goal trajectory
    (IlqrOptimizer::iqr, ilqr_optimizer.cc:793-842): backward Riccati with
    fixed Q/R, then a clamped closed-loop rollout through the real
    dynamics. goals [B, N, 6] -> (xs [B, N, 6], us [B, N-1, 2])."""
    dtype, device = goals.dtype, goals.device
    B, N = goals.shape[0], goals.shape[1]
    Q = torch.diag(upload([0.001, 0.001, 0.001, 0.001, 0.01, 0.005],
                          dtype=dtype, device=device))
    R = torch.diag(upload([0.2, 0.05], dtype=dtype, device=device))

    zero_u = torch.zeros((B, N - 1, 2), dtype=dtype, device=device)
    A, Bm = dynamics_jacobian(goals[:, :-1], zero_u, dt, veh.wheel_base,
                              cfg.jacobian_mode)        # [B, T, 6, 6/2]

    P = Q.expand(B, 6, 6)
    Ks = [None] * (N - 1)
    for t in range(N - 2, -1, -1):
        Ai, Bi = A[:, t], Bm[:, t]
        BtP = Bi.transpose(1, 2) @ P
        K = _inv22(R + BtP @ Bi) @ (BtP @ Ai)
        P = Q + Ai.transpose(1, 2) @ P @ (Ai - Bi @ K)
        Ks[t] = K

    jlo = upload([veh.jerk_min, veh.delta_rate_min], dtype=dtype,
                 device=device)
    jhi = upload([veh.jerk_max, veh.delta_rate_max], dtype=dtype,
                 device=device)
    x = goals[:, 0]
    xs, us = [x], []
    for t in range(N - 1):
        u = -(Ks[t] @ (x - goals[:, t])[..., None])[..., 0]
        u = torch.minimum(torch.maximum(u, jlo), jhi)
        x = dynamics_rk2(x, u, dt, veh.wheel_base)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def backward_pass(lam, A, B, Jx, Ju, Hx, Hu):
    """Riccati sweep (ilqr_optimizer.cc:334-390), batch-first: lam [B];
    A [B, T, 6, 6], B [B, T, 6, 2]; Jx, Hx [B, N, ...]; Ju, Hu [B, T, ...].
    Returns (Ks [B, T, 2, 6], ks [B, T, 2], dV0 [B], dV1 [B])."""
    T = A.shape[1]
    eye2 = torch.eye(2, dtype=A.dtype, device=A.device)
    lam_i = lam[:, None, None] * eye2
    Vx = Jx[:, -1, :, None]                         # [B, 6, 1]
    Vxx = Hx[:, -1]
    dV0 = torch.zeros_like(lam)
    dV1 = torch.zeros_like(lam)
    Ks = [None] * T
    ks = [None] * T
    for t in range(T - 1, -1, -1):
        Ai, Bi = A[:, t], B[:, t]
        At, Bt = Ai.mT, Bi.mT
        Qx = Jx[:, t, :, None] + At @ Vx
        Qu = Ju[:, t, :, None] + Bt @ Vx
        Qxx = Hx[:, t] + At @ Vxx @ Ai
        Quu = Hu[:, t] + Bt @ Vxx @ Bi
        Qux = Bt @ Vxx @ Ai
        Quu_inv = _inv22(Quu + lam_i)
        K = -Quu_inv @ Qux
        k = -Quu_inv @ Qu                           # [B, 2, 1]
        Kt = K.mT
        Vx = Qx + Kt @ Quu @ k + Kt @ Qu + Qux.mT @ k
        Vxx = Qxx + Kt @ Quu @ K + Kt @ Qux + Qux.mT @ K
        Vxx = 0.5 * (Vxx + Vxx.mT)
        dV0 = dV0 + (k.mT @ Qu)[:, 0, 0]
        dV1 = dV1 + (0.5 * k.mT @ (Quu @ k))[:, 0, 0]
        Ks[t], ks[t] = K, k[..., 0]
    return torch.stack(Ks, dim=1), torch.stack(ks, dim=1), dV0, dV1


def forward_pass(alpha, xs, us, Ks, ks, goals, dt, wheel_base):
    """Closed-loop rollout u' = u + K (x' - x) + alpha k from goals[:, 0]
    (ilqr_optimizer.cc:392-415), with the reference's delta_rate angle
    normalization (:408). alpha [B] (a line-search step per lane);
    xs [B, N, 6], us [B, T, 2], Ks [B, T, 2, 6], ks [B, T, 2]."""
    x = goals[:, 0]
    a = alpha[:, None]
    new_xs, new_us = [x], []
    for t in range(us.shape[1]):
        u = (us[:, t] + (Ks[:, t] @ (x - xs[:, t])[..., None])[..., 0]
             + a * ks[:, t])
        u = torch.stack([u[:, 0], normalize_angle(u[:, 1])], dim=-1)
        x = dynamics_rk2(x, u, dt, wheel_base)
        new_xs.append(x)
        new_us.append(u)
    return torch.stack(new_xs, dim=1), torch.stack(new_us, dim=1)


def gradient_norm(ks, us):
    """CalGradientNorm (ilqr_optimizer.cc:322-332), per lane: ks, us
    [B, T, 2] -> [B]."""
    v = ks.abs() / (us.abs() + 1.0)
    return v.amax(dim=-1).mean(dim=-1)


@dataclasses.dataclass
class _Carry(_Fields):
    xs: torch.Tensor        # [B, N, 6]
    us: torch.Tensor        # [B, T, 2]
    cost: CostBreakdown     # [B] leaves
    lam: torch.Tensor       # [B]
    dlam: torch.Tensor
    status: torch.Tensor    # [B] int32
    it: torch.Tensor        # [B] int32
    aidx: torch.Tensor      # [B] int64: line-search alpha index (serial)


def _where(mask, new, old):
    """Per-lane select of two carries (mask [B])."""
    return new.map(lambda n, o: torch.where(
        mask.reshape(mask.shape + (1,) * (n.dim() - 1)), n, o), old)


def _any(mask) -> bool:
    """One device-to-host sync (``profiling.host``): is any lane of
    ``mask`` set?"""
    return bool(host(mask.any()))


def _batched(coarse_xs, start_state, cons, warm_start):
    """Add a batch axis of one to an unbatched problem."""
    return (coarse_xs[None], start_state[None], cons.map(lambda a: a[None]),
            None if warm_start is None else tuple(w[None]
                                                  for w in warm_start))


def _init(coarse_xs, start_state, cons, cfg: IlqrConfig, veh: VehicleParam,
          dt, warm_start):
    """Goals, the initial trajectory (LQR guess or ``warm_start``) and the
    initial carry."""
    goals = transform_goals(coarse_xs, start_state)
    if warm_start is None:
        with span("solve.guess"):
            xs0, us0 = iqr_init(goals, cfg, veh, dt)
    else:
        xs0, us0 = (w.to(goals.dtype) for w in warm_start)
    B = goals.shape[0]
    dtype, device = goals.dtype, goals.device
    init = _Carry(
        xs=xs0, us=us0,
        cost=total_cost(xs0, us0, goals, cons, cfg, veh),
        lam=torch.full((B,), cfg.reg.lambda_init, dtype=dtype, device=device),
        dlam=torch.ones((B,), dtype=dtype, device=device),
        status=torch.full((B,), int(SolverStatus.RUNNING), dtype=torch.int32,
                          device=device),
        it=torch.zeros((B,), dtype=torch.int32, device=device),
        aidx=torch.zeros((B,), dtype=torch.int64, device=device))
    return goals, init


def _result(final: _Carry, init: _Carry) -> SolveResult:
    status = torch.where(final.status == SolverStatus.RUNNING,
                         torch.full_like(final.status,
                                         int(SolverStatus.MAX_ITER)),
                         final.status)
    return SolveResult(xs=final.xs, us=final.us, status=status,
                       iters=final.it, cost=final.cost, lam=final.lam,
                       init_xs=init.xs, init_us=init.us,
                       # this path always runs the FULL lane-segment scan
                       lane_clipped=torch.zeros_like(final.status,
                                                     dtype=torch.bool))


def _make(cfg: IlqrConfig):
    return _make_body_serial if cfg.line_search.mode == "serial" \
        else _make_body


def solve(coarse_xs, start_state, cons: ConstraintSet, cfg: IlqrConfig,
          veh: VehicleParam, dt, warm_start=None) -> SolveResult:
    """Full CILQR solves (IlqrOptimizer::Optimize,
    ilqr_optimizer.cc:154-320), one per lane.

    coarse_xs: [B, N, 6] coarse trajectory states (goals), or [N, 6] for
    one problem; start_state: [B, 6] (x, y, theta, v, *, *); cons:
    pre-shrunk and normalized constraints (costs.shrink_and_normalize),
    leaves [B, ...]; warm_start: optional (xs [B, N, 6], us [B, T, 2])
    initial trajectory (MPC re-solves) replacing the LQR initial guess.
    A lane updates only while it is RUNNING and under ``max_iter_num``
    iterations."""
    if coarse_xs.dim() == 2:
        g, s, k, w = _batched(coarse_xs, start_state, cons, warm_start)
        return solve(g, s, k, cfg, veh, dt, warm_start=w).map(lambda a: a[0])
    goals, init = _init(coarse_xs, start_state, cons, cfg, veh, dt,
                        warm_start)
    body = _make(cfg)(goals, cons, cfg, veh, dt)
    c = init
    while True:
        active = ((c.status == SolverStatus.RUNNING)
                  & (c.it < cfg.max_iter_num))
        if not _any(active):
            break
        c = _where(active, body(c), c)
    return _result(c, init)


def solve_with_history(coarse_xs, start_state, cons: ConstraintSet,
                       cfg: IlqrConfig, veh: VehicleParam, dt, num_iters=None,
                       record_trajs=False, warm_start=None):
    """Fixed-length variant that records the per-iteration cost breakdown
    (IlqrOptimizer::cost(), ilqr_optimizer.h:50-52, behind the reference's
    cost-vs-iteration figure, figure_plot.h:455-485). Concluded iterations
    repeat the frozen carry, as the reference stops appending.

    warm_start: optional (xs, us) initial trajectory replacing the LQR
    guess; pass what the production call got, so that the history replays
    the solve that ran. Follows cfg.line_search.mode: in "serial" mode each
    recorded step runs the serial body's alpha trials to the iteration's
    conclusion (accept, full reject or gradient stop), so the decisions are
    solve()'s, chunked per iteration; in "parallel" mode a step is one
    parallel-line-search iteration.

    Returns (SolveResult, CostBreakdown history with leaves [B, n+1]), and
    with record_trajs=True also the xs history [B, n+1, N, 6] (the
    reference's per-iteration trajectory overlays, figure_plot.h:267-453);
    unbatched inputs give unbatched outputs."""
    single = coarse_xs.dim() == 2
    if single:
        coarse_xs, start_state, cons, warm_start = _batched(
            coarse_xs, start_state, cons, warm_start)
    n_it = cfg.max_iter_num if num_iters is None else num_iters
    goals, init = _init(coarse_xs, start_state, cons, cfg, veh, dt,
                        warm_start)
    serial = cfg.line_search.mode == "serial"
    body = _make(cfg)(goals, cons, cfg, veh, dt)

    c = init
    costs, trajs = [init.cost], [init.xs]
    for _ in range(n_it):
        active = ((c.status == SolverStatus.RUNNING)
                  & (c.it < cfg.max_iter_num))
        if _any(active):
            if serial:
                # the serial body's alpha trials until this iteration
                # concludes (every conclusion advances c.it)
                it0, cc = c.it, c
                while True:
                    inner = (active & (cc.status == SolverStatus.RUNNING)
                             & (cc.it == it0))
                    if not _any(inner):
                        break
                    cc = _where(inner, body(cc), cc)
                c = cc
            else:
                c = _where(active, body(c), c)
        costs.append(c.cost)
        trajs.append(c.xs)
    res = _result(c, init)
    hist = costs[0].map(lambda *v: torch.stack(v, dim=1), *costs[1:])
    out = (res, hist)
    if record_trajs:
        out = out + (torch.stack(trajs, dim=1),)
    if single:
        out = tuple(o.map(lambda a: a[0]) if isinstance(o, _Fields)
                    else o[0] for o in out)
    return out


def _select_backward(cfg: IlqrConfig):
    """"scan": the reference's sequential recursion (backward_pass);
    "pscan": the horizon-parallel associative-scan form (pscan.py)."""
    if cfg.backward_backend == "pscan":
        from .pscan import backward_pass_pscan

        return backward_pass_pscan
    return backward_pass


def _relinearize(c: _Carry, goals, cons, cfg: IlqrConfig, veh, dt, bp):
    """Jacobians, cost derivatives and the backward pass at the carry's
    iterate; returns (Ks, ks, dV0, dV1, gnorm_done)."""
    A, B = dynamics_jacobian(c.xs[:, :-1], c.us, dt, veh.wheel_base,
                             cfg.jacobian_mode)
    Jx, Ju, Hx, Hu = cost_derivatives(c.xs, c.us, goals, cons, cfg, veh)
    Ks, ks, dV0, dV1 = bp(c.lam, A, B, Jx, Ju, Hx, Hu)
    gnorm = gradient_norm(ks, c.us)
    gnorm_done = (gnorm < cfg.reg.gradient_norm_min) & (c.lam < 1e-5)
    return Ks, ks, dV0, dV1, gnorm_done


def _decide(c: _Carry, nxs, nus, ncost, dcost, accept, full_reject,
            gnorm_done, cfg: IlqrConfig, next_aidx):
    """The accept branch (ilqr_optimizer.cc:272-293), the full-reject
    branch (:297-307) and the small-gradient stop, per lane; a lane that
    neither accepts nor fully rejects moves to its next alpha."""
    reg = cfg.reg
    dtype = c.lam.dtype

    def code(s):
        return torch.full_like(c.status, int(s))

    concluded = accept | full_reject
    dlam_acc = torch.clamp(c.dlam / reg.ratio, max=1.0 / reg.ratio)
    lam_acc = c.lam * dlam_acc * (c.lam > reg.lambda_min).to(dtype)
    conv_abs = dcost < cfg.abs_cost_tol
    conv_rel = (dcost / c.cost.total) < cfg.rel_cost_tol
    status_acc = torch.where(
        conv_abs, code(SolverStatus.SUCCESS_ABS_COST),
        torch.where(conv_rel, code(SolverStatus.SUCCESS_REL_COST),
                    code(SolverStatus.RUNNING)))
    dlam_rej = torch.clamp(c.dlam * reg.ratio, min=reg.ratio)
    lam_rej = torch.clamp(c.lam * dlam_rej, min=reg.lambda_min)
    status_rej = torch.where(lam_rej > reg.lambda_max,
                             code(SolverStatus.FAIL_LAMBDA_MAX),
                             code(SolverStatus.RUNNING))

    def pick3(on_acc, on_rej, on_adv):
        return torch.where(accept, on_acc,
                           torch.where(full_reject, on_rej, on_adv))

    acc3 = accept[:, None, None]
    new = _Carry(
        xs=torch.where(acc3, nxs, c.xs),
        us=torch.where(acc3, nus, c.us),
        cost=ncost.map(lambda n, o: torch.where(accept, n, o), c.cost),
        lam=pick3(lam_acc, lam_rej, c.lam),
        dlam=pick3(dlam_acc, dlam_rej, c.dlam),
        status=pick3(status_acc, status_rej, code(SolverStatus.RUNNING)),
        it=c.it + concluded.to(torch.int32),
        aidx=torch.where(concluded, torch.zeros_like(c.aidx), next_aidx))
    # the small-gradient stop keeps the iterate and counts an iteration
    kept = _where(gnorm_done, c, new)
    kept.status = torch.where(gnorm_done, code(SolverStatus.SUCCESS_GNORM),
                              new.status)
    kept.it = torch.where(gnorm_done, c.it + 1, new.it)
    kept.aidx = torch.where(gnorm_done, torch.zeros_like(new.aidx),
                            new.aidx)
    return kept


def _make_body(goals, cons, cfg: IlqrConfig, veh: VehicleParam, dt):
    """Parallel line-search outer-iteration body: every alpha's rollout and
    cost at once (the JAX package's vmap over alphas; here the alphas are
    stacked on the batch axis), then the first acceptable alpha."""
    alphas = torch.tensor(cfg.line_search.alphas, dtype=goals.dtype,
                          device=goals.device)
    nA = alphas.shape[0]
    bp = _select_backward(cfg)
    ls = cfg.line_search

    def rep(a):
        return a.repeat((nA,) + (1,) * (a.dim() - 1))

    def body(c: _Carry) -> _Carry:
        B = c.xs.shape[0]
        Ks, ks, dV0, dV1, gnorm_done = _relinearize(c, goals, cons, cfg, veh,
                                                     dt, bp)
        nxs_all, nus_all = forward_pass(
            alphas.repeat_interleave(B), rep(c.xs), rep(c.us), rep(Ks),
            rep(ks), rep(goals), dt, veh.wheel_base)
        nc_all = total_cost(nxs_all, nus_all, rep(goals), cons.map(rep),
                            cfg, veh).map(lambda a: a.reshape(nA, B))
        dcost_all = c.cost.total - nc_all.total              # [nA, B]
        expected_all = -alphas[:, None] * (dV0 + alphas[:, None] * dV1)
        z_all = dcost_all / expected_all
        ok_all = ((z_all > ls.beta_min) & (z_all < ls.beta_max)
                  & (dcost_all > 0.0))
        accept = ok_all.any(0)
        pick = torch.argmax(ok_all.to(torch.uint8), dim=0)   # first True
        lanes = torch.arange(B, device=pick.device)
        nxs = nxs_all.reshape((nA, B) + nxs_all.shape[1:])[pick, lanes]
        nus = nus_all.reshape((nA, B) + nus_all.shape[1:])[pick, lanes]
        ncost = nc_all.map(lambda a: a[pick, lanes])
        # every alpha was tried: a lane that accepts none fully rejects
        return _decide(c, nxs, nus, ncost, dcost_all[pick, lanes], accept,
                       ~accept, gnorm_done, cfg, c.aidx)

    return body


def _make_body_serial(goals, cons, cfg: IlqrConfig, veh: VehicleParam, dt):
    """Serial line-search outer-iteration body: one trip evaluates ONE
    alpha per lane (the carried index ``aidx``), the reference's sequential
    early exit (ilqr_optimizer.cc:246-265). On a reject that is not the
    last alpha, (xs, us, lam) are unchanged, so the next trip's
    relinearization and backward pass are identical and the next alpha
    sees the same gains; an iteration is counted when the search concludes
    (accept, or the last alpha rejected). Lanes sit at different alphas:
    the index is a tensor, not host control flow."""
    alphas = torch.tensor(cfg.line_search.alphas, dtype=goals.dtype,
                          device=goals.device)
    n_alpha = alphas.shape[0]
    bp = _select_backward(cfg)
    ls = cfg.line_search

    def body(c: _Carry) -> _Carry:
        Ks, ks, dV0, dV1, gnorm_done = _relinearize(c, goals, cons, cfg, veh,
                                                     dt, bp)
        a = alphas[c.aidx]
        nxs, nus = forward_pass(a, c.xs, c.us, Ks, ks, goals, dt,
                                veh.wheel_base)
        ncost = total_cost(nxs, nus, goals, cons, cfg, veh)
        dcost = c.cost.total - ncost.total
        expected = -a * (dV0 + a * dV1)
        z = dcost / expected
        accept = (z > ls.beta_min) & (z < ls.beta_max) & (dcost > 0.0)
        full_reject = (~accept) & (c.aidx == n_alpha - 1)
        return _decide(c, nxs, nus, ncost, dcost, accept, full_reject,
                       gnorm_done, cfg, c.aidx + 1)

    return body
