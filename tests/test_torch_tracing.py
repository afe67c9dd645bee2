"""The port's tracer (``cilqr_tpu_torch.profiling``) on the CPU: off, it
creates no CUDA event and opens no profiler range; on, the spans of a
replan and of an MPC cycle nest under one call each; the megakernel's and
the repair ladder's counters equal a recount of what they count; each
known host read counts one ``host_syncs``; and the benchmark's trace
reader drops a program span's mirror on the device's timeline.

Small and cheap: two scenarios, one solver iteration, one repair round
and the blast backend (the megakernel's plain version pads every solve to
128 lanes on the CPU); the megakernel's counters on three fixture
problems in blocks of two.
"""

import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import mpc as TMpc
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import profiling as TPr
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.convert import load_fixture
from cilqr_tpu_torch.costs import trim_constraints
from cilqr_tpu_torch.kernels import megasolve as TM
from cilqr_tpu_torch.reference_line import pack_station_rows
from cilqr_tpu_torch.types import SolverStatus

import torch_shared

F64 = torch.float64
CFG = PlannerConfig()
SMALL = dataclasses.replace(
    CFG, ilqr=dataclasses.replace(CFG.ilqr, max_iter_num=1),
    repair=dataclasses.replace(CFG.repair, margins=(1.0,)))
SEEDS = (0, 156)
ROOTS = ("plan_batch", "mpc_step_batch")
PARENTS = {"dp": ROOTS, "dp.chunk": ("dp",), "dp.layers": ("dp.chunk",),
           "dp.trace_back": ("dp.chunk",), "corridors": ROOTS,
           "corridors.chunk": ("corridors",), "corridors.prep": ROOTS,
           "solve": ROOTS + ("repair.round",), "solve.guess": ("solve",),
           "solve.operands": ("solve",), "solve.kernel": ("solve",),
           "recheck": ROOTS + ("repair.round",), "repair": ROOTS,
           "repair.round": ("repair",)}


def _world():
    scn = TS.make_scenario_batch(SEEDS, dtype=F64, device="cpu")
    lane = TP.make_lane_tuple(scn.left_barrier_xy[0],
                              scn.right_barrier_xy[0], SMALL)
    starts = torch.tensor([0.0, 0.0, 0.0, 10.0], dtype=F64).repeat(
        len(SEEDS), 1)
    return scn, lane, starts, TS.analytic_road_spec(dtype=np.float64)


def _replan_and_cycle():
    scn, lane, starts, spec = _world()
    out = TP.plan_batch(scn, starts, SMALL, None, lane, spec=spec)
    carry = TMpc.MpcCarry(xs=out.solve.xs, us=out.solve.us,
                          cycle_time=torch.zeros(len(SEEDS), dtype=F64))
    TMpc.mpc_step_batch(scn, carry, SMALL, lane, spec=spec)


def _runs():
    """One replan and one cycle with the tracer off, CUDA events and
    profiler ranges made to raise, and the host_syncs counter before and
    after; then both again with the tracer on, collected after each."""
    def refuse(*a, **k):
        raise AssertionError("the tracer is off")

    syncs = TPr.counters["host_syncs"]
    with mock.patch.object(torch.cuda, "Event", refuse), \
            mock.patch.object(torch.profiler, "record_function", refuse):
        _replan_and_cycle()
    off_syncs = TPr.counters["host_syncs"] - syncs
    scn, lane, starts, spec = _world()
    with TPr.tracing():
        out = TP.plan_batch(scn, starts, SMALL, None, lane, spec=spec)
        plan = TPr.collect()
        carry = TMpc.MpcCarry(xs=out.solve.xs, us=out.solve.us,
                              cycle_time=torch.zeros(len(SEEDS), dtype=F64))
        TMpc.mpc_step_batch(scn, carry, SMALL, lane, spec=spec)
    return {"off_syncs": off_syncs, "plan": plan, "both": TPr.collect()}


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    return torch_shared.shared(request, tmp_path_factory, "tracing_runs",
                               _runs)


def test_off_makes_no_event_no_range_and_counts_nothing(runs):
    assert runs["off_syncs"] == 0
    assert not TPr.active()
    assert TPr.span("dp") is TPr.span("solve")


@pytest.mark.parametrize("which", ["plan", "both"])
def test_spans_nest_under_one_call(runs, which):
    """Every span of the last call belongs to it, under the parent its
    layer allows; a span holds its children's time; each name's self time
    is at most its inclusive time."""
    tr = runs[which]
    root = "plan_batch" if which == "plan" else "mpc_step_batch"
    assert tr.calls == (1 if which == "plan" else 2)
    recs = tr.last_call
    assert {r.call for r in recs} == {tr.calls}
    assert [r.name for r in recs if r.parent is None] == [root]
    assert recs[-1].name == root
    assert {r.name for r in recs} <= set(TPr.SPANS)
    for r in recs:
        if r.parent is None:
            continue
        assert r.parent in PARENTS[r.name], (r.name, r.parent)
        holders = [p for p in recs if p.name == r.parent
                   and p.start_ns <= r.start_ns and r.end_ns <= p.end_ns]
        assert len(holders) == 1, r.name
        kids = [c for c in recs if c.parent == r.name
                and r.start_ns <= c.start_ns and c.end_ns <= r.end_ns]
        assert sum(c.end_ns - c.start_ns for c in kids) <= (r.end_ns
                                                            - r.start_ns)
    for name, st in tr.spans.items():
        assert 0 <= st.self_s <= st.inclusive_s, name
        assert st.device_s is None                 # no card here
        assert sum(st.parents.values()) == st.count


def test_replan_spans_and_counters(runs):
    tr = runs["plan"]
    names = {r.name for r in tr.last_call}
    assert names >= {"plan_batch", "dp", "dp.chunk", "dp.layers",
                     "dp.trace_back", "corridors", "corridors.chunk",
                     "corridors.prep", "solve", "solve.guess", "recheck",
                     "repair"}
    assert tr.counters["dp.chunks"] == tr.spans["dp.chunk"].count
    rounds = [r for r in tr.last_call if r.name == "repair.round"]
    assert tr.counters.get("repair.rounds", 0) == len(rounds)
    for r in rounds:
        assert r.attrs["kind"] in ("warm", "cold", "brake")
        assert 0 < r.attrs["n_dirty"] and r.attrs["R"] == len(SEEDS)
    assert tr.counters["host_syncs"] > 0


def test_megakernel_counters_recount(monkeypatch):
    """mega.* of one solve on the plain version equal a recount from the
    istate and block trips the plain version handed back: trips of the
    three real lanes, blocks of two lanes (the fourth lane is padding)."""
    g, s, c = load_fixture(dtype=F64, device="cpu", batch=3)
    ilqr = dataclasses.replace(CFG.ilqr, max_iter_num=2)
    runs, ref = [], TM.solve_batch_mega_ref

    def plain(*a):
        runs.append(ref(*a))
        return runs[-1]

    monkeypatch.setattr(TM, "solve_batch_mega_ref", plain)
    with TPr.tracing():
        TM.solve_batch_mega(g, s, c, ilqr, CFG.vehicle, CFG.delta_t,
                            block_nb=2)
    tr = TPr.collect()
    (_, _, _, istate, trips), = runs
    want = {"mega.launches": 1, "mega.lane_trips": int(istate[2, :3].sum()),
            "mega.relins": int(istate[3, :3].sum()),
            "mega.block_trips": int(trips.sum()),
            "mega.block_lanes": 2 * int(trips.sum())}
    assert {k: tr.counters[k] for k in want} == want
    assert tr.spans["solve.kernel"].count == want["mega.launches"]
    assert want["mega.relins"] <= want["mega.lane_trips"] \
        <= want["mega.block_lanes"]
    assert trips.numel() == 2
    assert tr.counters.get("solve_batch_mega.launches", 0) == 0


def test_ladder_counters_recount(request, tmp_path_factory, monkeypatch):
    """The ladder's counters on a forced-dirty batch (lanes 0 and 2) of the
    shared replan, against a recount of what the solve was handed: the
    warm round's solve fails every lane, the cold round's hands back the
    clean final plans, so both rounds run and the cold one replaces both
    lanes."""
    plan = torch_shared.replan(request, tmp_path_factory)
    scn = TS.make_scenario_batch(torch_shared.SEEDS, dtype=F64, device="cpu")
    B = len(torch_shared.SEEDS)
    goals_b = TP.coarse_to_states(plan.coarse)
    seen = []

    def solve_batch(goals, starts, cons, *a, warm_start=None, **k):
        # the lanes handed over, recovered from their goals
        idx = (goals[:, None] == goals_b[None]).flatten(2).all(-1).int()
        idx = idx.argmax(-1)
        seen.append(len(set(idx.tolist())))
        res = plan.solve.map(lambda x: x[idx].clone())
        ok = warm_start is None
        res.status[:] = int(SolverStatus.SUCCESS_REL_COST if ok
                            else SolverStatus.MAX_ITER)
        return res

    monkeypatch.setattr(TP, "solve_batch", solve_batch)
    hits = torch.zeros_like(plan.pre_hits)
    hits[[0, 2], :5] = True
    starts6 = TP.start_states(torch.tensor([[0.0, 0.0, 0.0, 10.0]] * B,
                                           dtype=F64), F64)
    cons = TP.prep_constraints(plan.corridors, CFG)
    spec = TS.analytic_road_spec(dtype=np.float64)
    with TPr.tracing():
        _, _, repaired, still = TP._repair_batch(
            scn, plan.solve, hits, goals_b, starts6, cons, CFG, spec)
    tr = TPr.collect()
    R = TP.repair_width(B, CFG.repair.max_fraction)
    assert seen == [2, 2]
    assert repaired.tolist() == [True, False, True, False]
    assert not still.any()
    got = {k: tr.counters.get(k, 0) for k in (
        "repair.rounds", "repair.lanes_dirty", "repair.lanes_launched",
        "repair.lanes_replaced")}
    assert got == {"repair.rounds": len(seen),
                   "repair.lanes_dirty": sum(min(n, R) for n in seen),
                   "repair.lanes_launched": R * len(seen),
                   "repair.lanes_replaced": int(repaired.sum())}
    assert got["repair.lanes_dirty"] <= got["repair.lanes_launched"]
    assert [r.attrs["kind"] for r in tr.last_call
            if r.name == "repair.round"] == ["warm", "cold"]
    # one read of the dirty count a round the ladder runs or skips
    assert tr.counters["host_syncs"] == len(CFG.repair.margins)


def _trim_reads():
    mask = torch.zeros(2, 81, 24, dtype=torch.bool)
    mask[0, 3, :5] = True
    z = torch.zeros(2, 81, 24, 3, dtype=F64)
    segs = torch.zeros(2, 81, 24, 2, 2, dtype=F64)
    cons = TP.ConstraintSet(z, mask, z, segs, mask, z, segs, mask)
    assert trim_constraints(cons).corridor_mask.shape[-1] == 8


def _spec_reads():
    scn = TS.make_scenario_batch((0,), dtype=F64, device="cpu")
    cl = scn.centerline
    TD._check_spec(TS.analytic_road_spec(dtype=np.float64), cl,
                   pack_station_rows(cl))


@pytest.mark.parametrize("site, syncs", [(_trim_reads, 3), (_spec_reads, 3)],
                         ids=["trim_constraints", "check_spec"])
def test_host_syncs_count_each_site(site, syncs):
    """Each known read or upload counts once inside tracing() and not
    outside it: a read of each mask's used slots; the spec's two reads and
    its upload of the probe stations (the ladder's read:
    test_ladder_counters_recount)."""
    before = TPr.counters["host_syncs"]
    site()
    assert TPr.counters["host_syncs"] == before
    with TPr.tracing():
        site()
    assert TPr.collect().counters["host_syncs"] == syncs


def test_road_library_spans_and_counters():
    """A road library's build is one ``roads.build`` span and counts its
    resident table bytes; a replan with it opens one ``roads`` span under
    the call (each lane's road operands) and counts the call's roads."""
    other = (33.0, (-90.0, 11.0), 10.0, (180.0, 5.5), 36.0, (-180.0, 12.5),
             50.0)
    rows = [TS.make_scenario_arrays(s, road=r)
            for s, r in ((0, TS.DEFAULT_ROAD), (1, other))]
    scn = TS.scenario_from_arrays(TS.stack_scenario_arrays(rows), F64, "cpu")
    grid_cfg = dataclasses.replace(SMALL, dp=dataclasses.replace(
        SMALL.dp, collision_mode="grid"))
    starts = torch.tensor([0.0, 0.0, 0.0, 10.0], dtype=F64).repeat(2, 1)
    with TPr.tracing():
        lib = TP.road_library(scn, grid_cfg)
        TP.plan_batch(scn, starts, grid_cfg, library=lib)
        tr = TPr.collect()
    assert tr.spans["roads.build"].count == 1
    assert tr.spans["roads.build"].parents == {None: 1}
    assert tr.spans["roads"].parents == {"plan_batch": 1}
    assert tr.counters["roads.table_bytes"] == lib.dilated.numel() > 0
    assert tr.counters["roads.count"] == 2
    assert {"roads", "roads.build"} <= set(TPr.SPANS)


def test_counters_take_host_ints_and_device_sums():
    with TPr.tracing():
        TPr.count("x.ints", 2)
        TPr.count("x.ints", 3)
        TPr.count("x.sum", torch.tensor([True, False, True]))
        TPr.count("x.sum", torch.arange(4, dtype=torch.int32))
        TPr.tally("x.always", 4)
        with pytest.raises(RuntimeError):
            with TPr.tracing():
                pass
    got = TPr.collect().counters
    assert {k: got[k] for k in ("x.ints", "x.sum", "x.always")} == {
        "x.ints": 5, "x.sum": 8, "x.always": 4}
    TPr.count("x.ints", 7)                  # off: nothing
    TPr.tally("x.always", 1)                # always
    assert TPr.counters["x.ints"] == 5 and TPr.counters["x.always"] == 5


def test_events_of_drops_program_spans_on_the_device():
    """The profiler mirrors each range onto the device's timeline; given
    the program's span names, the benchmark's reader drops the mirror
    and keeps the kernel."""
    from portbench import trace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b):
        return SimpleNamespace(name=name, device_type=dev,
                               is_user_annotation=False,
                               time_range=SimpleNamespace(start=a, end=b))

    prof = SimpleNamespace(events=lambda: [
        ev("dp.chunk", cpu, 0, 10), ev("dp.chunk", cuda, 1, 9),
        ev("mega_kernel", cuda, 2, 5)])
    got = trace.events_of(prof, TPr.SPANS)
    assert got == [("dp.chunk", 0, 10, False), ("mega_kernel", 2, 5, True)]
    assert len(trace.events_of(prof)) == 3
