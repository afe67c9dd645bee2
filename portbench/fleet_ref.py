"""The plain reference of a fleet whose lanes are each on a road of their
own, and the comparison that decides its ``correct``. It imports nothing
of the program.

For every road of a seeded sample of the batch's roads, the road's lanes
go through the benchmark's frozen single-road reference
(``ref.stages.replan_problem``, ``ref.stages.recheck``) with that road's
own grid, lane constraints and barrier points, the arrays cut back to the
road's own length; the lanes are then put back in the batch's order. The
DP and the corridors are lane-local, so a lane's reference does not depend
on the lanes beside it. The sample (``check_lanes`` lanes drawn from the
seed, every lane of a sampled road with it) bounds the reference's time:
each road is a reference call of its own. Each road's host work (its
arrays on the device, its lane tuple, its grid) runs ahead in ``THREADS``
threads while the calling thread runs the roads' device work in turn
(``replan_problem``'s stages). The re-checks, which test each lane
against its own barrier points, and the comparisons then run once over
every sampled lane.

On the sampled lanes the numbers are the replan cells': ``lanes_off``
(the DP path, corridors, constraints, re-checks and the ladder's
bookkeeping), ``cost_excess`` and ``lanes_stalled`` (the float64 solve of
every sampled lane), ``step_residual``. Constraints are compared at a
common width: a batch trims its padded slots to the widest lane's, a road
to its own, and everything trimmed is masked out.
"""

from __future__ import annotations

import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from portbench import compare, control, fleet, inputs
from portbench.kinds.replan import _np_dtype, _torch_dtype
from portbench.ref import config as ref_config
from portbench.ref import corridor as corridor_mod
from portbench.ref import dp as dp_mod
from portbench.ref import scenario as ref_scenario
from portbench.ref import stages as ref_stages

THREADS = 4      # threads building roads' host work ahead



def sample(cell, seed, roads):
    """(lanes, groups): the sampled lanes of the batch, sorted, and for
    each sampled road the positions of its lanes among them. ``roads``
    [B]: each lane's road index."""
    roads = np.asarray(roads)
    drawn = inputs.sample_lanes(seed, len(roads),
                                cell.traffic["check_lanes"])
    lanes = np.flatnonzero(np.isin(roads, roads[drawn]))
    groups = [np.flatnonzero(roads[lanes] == r)
              for r in np.unique(roads[lanes])]
    return lanes, groups


def road_world(cell, arrays, lanes, device, dtype=None):
    """The reference's view of one road's lanes: config, scenarios (the
    arrays cut back to the road's length) and the road's lane tuple from
    its own per-side polylines."""
    conf = cell.config
    cfg = ref_config.from_dict(inputs.planner(conf))
    a = fleet.lane_arrays(arrays, lanes)
    scns = ref_scenario.scenario_from_arrays(
        a, dtype=dtype or _torch_dtype(conf), device=device)

    def side(k):
        return a[k + "_barrier_xy"][0][a[k + "_barrier_mask"][0]]

    lane = ref_stages.make_lane_tuple(side("left"), side("right"), cfg,
                                      _np_dtype(conf))
    return cfg, scns, lane, a


def take(s: compare.Served, idx) -> compare.Served:
    """A Served of some lanes (an index tensor or array)."""
    idx = torch.as_tensor(idx, device=s.ok.device)

    def t(a):
        return a[idx]

    main = s.main
    call = compare.SolveCall(goals=t(main.goals), starts=t(main.starts),
                             cons=main.cons.map(t), warm=None,
                             res=main.res.map(t))
    return compare.Served(
        main=call, final=s.final.map(t), ok=t(s.ok), hits=t(s.hits),
        pre_dirty=t(s.pre_dirty), repaired=t(s.repaired),
        still_dirty=t(s.still_dirty), coarse=s.coarse.map(t),
        dp_ok=t(s.dp_ok))


def _slots(cons):
    return cons.corridor_mask.shape[-1], max(cons.left_mask.shape[-1],
                                             cons.right_mask.shape[-1])


def widen(cons, kc: int, s: int):
    """Constraints padded with masked-out slots to kc corridor planes and
    s lane segments a side (what a wider batch's trim keeps)."""
    def pad(a, n, axis):
        axis = axis % a.dim()
        extra = n - a.shape[axis]
        if extra <= 0:
            return a
        shape = list(a.shape)
        shape[axis] = extra
        return torch.cat([a, torch.zeros(shape, dtype=a.dtype,
                                          device=a.device)], axis)

    f = cons._asdict()
    f["corridor_planes"] = pad(f["corridor_planes"], kc, -2)
    f["corridor_mask"] = pad(f["corridor_mask"], kc, -1)
    for side in ("left", "right"):
        f[side + "_planes"] = pad(f[side + "_planes"], s, -2)
        f[side + "_segs"] = pad(f[side + "_segs"], s, -3)
        f[side + "_mask"] = pad(f[side + "_mask"], s, -1)
    return type(cons)(**f)


def _cat(parts):
    return type(parts[0])(*(torch.cat(v) for v in zip(*parts)))


def per_road(host, device, groups):
    """[device(pos, *host(pos)) for pos in groups]: each road's host work
    in ``THREADS`` threads ahead of the calling thread, which runs the
    roads' device work one after another (device work from several
    threads at once waits on the interpreter lock)."""
    with ThreadPoolExecutor(max(1, min(THREADS, len(groups)))) as ex:
        ahead = [ex.submit(host, pos) for pos in groups]
        return [device(pos, *f.result()) for pos, f in zip(groups, ahead)]


def road_problem(scns, st, cfg, lane, grid):
    """ref.stages.replan_problem with the road's grid built ahead: DP ->
    corridors -> constraints."""
    d = dp_mod.plan(scns, st[:, 0], st[:, 1], st[:, 2], cfg, grid)
    cors = corridor_mod.plan_corridors(scns, d.traj, cfg.corridor, lane)
    goals = ref_stages.coarse_to_states(d.traj)
    return ref_stages.Problem(
        goals=goals, starts=ref_stages.start_states(st, goals.dtype),
        cons=ref_stages.prep_constraints(cors, cfg), corridors=cors,
        warm=None, t0=None, coarse=d.traj, dp_ok=d.ok)


def problems(cell, arrays, starts, lanes, groups, device):
    """Each sampled road's config and reference problem, in the order of
    ``groups``: [(cfg, problem)]."""
    def host(pos):
        cfg, scns, lane, _ = road_world(cell, arrays, lanes[pos], device)
        return cfg, scns, lane, ref_stages.road_grid(scns.barrier_xy[0], cfg)

    def dev(pos, cfg, scns, lane, grid):
        st = starts[torch.as_tensor(lanes[pos], device=starts.device)]
        return cfg, road_problem(scns, st, cfg, lane, grid)

    return per_road(host, dev, groups)


def combined(probs, kc, s):
    """The sampled roads' problems as one Problem over their lanes in the
    groups' order, the constraints at a common width."""
    ps = [p for _, p in probs]
    cons = _cat([widen(p.cons, kc, s) for p in ps])
    return ref_stages.Problem(
        goals=torch.cat([p.goals for p in ps]),
        starts=torch.cat([p.starts for p in ps]), cons=cons,
        corridors=types.SimpleNamespace(
            ok=torch.cat([p.corridors.ok for p in ps])),
        warm=None, t0=None,
        coarse=ps[0].coarse.map(lambda *v: torch.cat(v),
                                *(p.coarse for p in ps[1:])),
        dp_ok=torch.cat([p.dp_ok for p in ps]))


def _widest(probs, cons=None):
    slots = [_slots(p.cons) for _, p in probs]
    if cons is not None:
        slots.append(_slots(cons))
    return max(k for k, _ in slots), max(s for _, s in slots)


def rechecks(arrays, lanes, dtype, device, cfg, *plans):
    """The reference's re-check of each plan xs [L, N, 6] of ``lanes``
    against each lane's own barrier points (the roads' padding masked)."""
    scns = ref_scenario.scenario_from_arrays(
        fleet.lane_arrays(arrays, lanes), dtype=dtype, device=device)
    return [ref_stages.recheck(scns, xs, cfg, None) for xs in plans]


def check_served(cell, arrays, starts, s: compare.Served, lanes, groups,
                 seed, device, log):
    """The compared numbers of a Served over the sampled lanes (``lanes``
    of the batch, ``groups`` their positions by road)."""
    probs = problems(cell, arrays, starts, lanes, groups, device)
    kc, sl = _widest(probs, s.main.cons)
    order = np.concatenate(groups)
    g = take(s, order)             # the sampled lanes in the groups' order
    g.main.cons = widen(g.main.cons, kc, sl)
    prob = combined(probs, kc, sl)
    cfg = probs[0][0]
    off_dp = compare.path_off(g.coarse, prob.coarse) | (g.dp_ok
                                                         != prob.dp_ok)
    off_cons = compare.constraints_off(g.main, prob)
    off_cons |= g.ok != (prob.dp_ok & prob.corridors.ok.all(-1))
    hits_main, hits_final = rechecks(arrays, lanes[order], starts.dtype,
                                     device, cfg, g.main.res.xs, g.final.xs)
    off_rep = compare.repair_off(g, hits_main, hits_final)
    gaps = [compare.step_residual(r.xs, r.us, prob.starts, cfg.delta_t,
                                  cfg.vehicle.wheel_base)
            for r in (g.main.res, g.final)]
    lc = compare.solve_check(prob, g.main.res, np.arange(len(order)), cfg)
    vals, detail = compare.numbers(off_dp | off_cons | off_rep, gaps, lc,
                                   warm=False)
    detail.update(roads=len(groups), dp_off=int(off_dp.sum()),
                  constraints_off=int(off_cons.sum()),
                  recheck_repair_off=int(off_rep.sum()))
    return vals, detail


class _Plan(types.SimpleNamespace):
    """The control's plans (xs, us, status, iters), lane by lane."""

    def map(self, fn):
        return _Plan(**{k: fn(v) for k, v in vars(self).items()})


def control_served(cell, arrays, starts, lanes, groups, device
                   ) -> compare.Served:
    """The control on the sampled lanes, in the order of ``lanes``: each
    road's reference in bfloat16 (``control``'s rounding: obstacles,
    starts, the coarse trajectory and the constraints held in bfloat16),
    the sampled lanes' solve in bfloat16 in one batch, no ladder."""
    def host(pos):
        cfg, _, lane, a = road_world(cell, arrays, lanes[pos], device,
                                     dtype=starts.dtype)
        scns = ref_scenario.scenario_from_arrays(
            control._rounded_arrays(a), dtype=starts.dtype, device=device)
        return cfg, scns, lane, ref_stages.road_grid(scns.barrier_xy[0], cfg)

    def dev(pos, cfg, scns, lane, grid):
        st = starts[torch.as_tensor(lanes[pos], device=starts.device)]
        return cfg, control._held(road_problem(scns, control._bf(st), cfg,
                                               lane, grid))

    probs = per_road(host, dev, groups)
    kc, sl = _widest(probs)
    prob = combined(probs, kc, sl)
    cfg = probs[0][0]
    res = control._solve_bf16(prob, cfg)
    order = lanes[np.concatenate(groups)]
    hits = rechecks(control._rounded_arrays(arrays), order, starts.dtype,
                    device, cfg, res.xs)[0]
    inv = torch.as_tensor(np.argsort(np.concatenate(groups), kind="stable"),
                          device=device)

    def back(a):
        return a[inv]

    res = _Plan(xs=back(res.xs), us=back(res.us), status=back(res.status),
                iters=back(res.iters))
    hits = back(hits)
    dirty = hits[:, :ref_stages.NEAR_TERM_KNOTS].any(-1)
    call = compare.SolveCall(goals=back(prob.goals),
                             starts=back(prob.starts),
                             cons=prob.cons.map(back), warm=None, res=res)
    dp_ok = back(prob.dp_ok)
    return compare.Served(
        main=call, final=res, ok=dp_ok & back(prob.corridors.ok).all(-1),
        hits=hits, pre_dirty=dirty, repaired=torch.zeros_like(dirty),
        still_dirty=dirty, coarse=prob.coarse.map(back).map(control._bf),
        dp_ok=dp_ok)
