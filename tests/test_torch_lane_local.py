"""The replan's per-lane stages are lane-local: a lane's DP, corridors,
constraints and re-check are the same bit for bit whatever batch the lane
sits in (its width, its position, its neighbours), as the JAX package's
``jax.vmap`` of one scenario's stage makes them. Float64 on the CPU, no
JAX.

The DP and the corridors split their scenarios into chunks by a memory
budget, so one lane runs in batches of different widths: forced small
chunks and a sub-batch of rows must give the full batch's rows. The card
adds a hazard the CPU cannot show: some CUDA operations pick their
algorithm, and so their order of rounding, by the tensor's size (the
cumsum's scan tree, a float reduction's split across threads, cuBLAS's
kernel choice). ``test_stages_use_no_width_dependent_op`` records every
operation the stages run and holds them to operations whose result on the
card does not depend on the tensor's size: no scan, product or
accumulating scatter, stable sorts only, and float sums that add at most
one non-zero term per output (exact in any order).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cilqr_tpu_torch import corridor as TC
from cilqr_tpu_torch import dp as TD
from cilqr_tpu_torch import pipeline as TP
from cilqr_tpu_torch import scenario as TS
from cilqr_tpu_torch.config import PlannerConfig
from cilqr_tpu_torch.reference_line import arc_lengths

F64 = torch.float64
SEEDS = (0, 1, 2, 3, 156)
CFG = PlannerConfig()
PER_SCN = 70 * 70 * 16          # one DP scenario's probes of a layer


@pytest.fixture(scope="module")
def setup():
    scn = TS.make_scenario_batch(SEEDS, dtype=F64, device="cpu")
    lane = TP.make_lane_tuple(scn.left_barrier_xy[0],
                              scn.right_barrier_xy[0], CFG)
    starts = torch.tensor([[0.0, 0.0, 0.0, 10.0]] * len(SEEDS), dtype=F64)
    starts[:, 1] = torch.linspace(-0.2, 0.2, len(SEEDS), dtype=F64)
    return scn, lane, starts, TS.analytic_road_spec(dtype=np.float64)


def _dp(scn, starts, spec):
    return TD.plan(scn, starts[:, 0], starts[:, 1], starts[:, 2], CFG,
                   spec=spec)


@pytest.fixture(scope="module")
def whole(setup):
    scn, lane, starts, spec = setup
    d = _dp(scn, starts, spec)
    return d, TC.plan_corridors(scn, d.traj, CFG.corridor, lane)


def _same(got, want, rows=slice(None)):
    """Every tensor field of got equal to want's rows, bit for bit."""
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(g, w[rows]), f.name


def _same_dp(got, want, rows=slice(None)):
    _same(got.traj, want.traj, rows)
    for f in ("ok", "min_cost", "sel_s", "sel_l"):
        assert torch.equal(getattr(got, f), getattr(want, f)[rows]), f


@pytest.mark.parametrize("per_chunk", [1, 2, 3])
def test_dp_chunks_are_lane_local(setup, whole, monkeypatch, per_chunk):
    """Chunks of 1, 2 and 3 scenarios (3: a ragged last chunk of 2) give
    the unchunked batch's DP bit for bit."""
    scn, _, starts, spec = setup
    monkeypatch.setattr(TD, "PROBES_PER_CHUNK", per_chunk * PER_SCN)
    _same_dp(_dp(scn, starts, spec), whole[0])


def test_dp_and_corridors_of_a_sub_batch(setup, whole):
    """Rows 1..3 alone, at another width and offset, give the full
    batch's rows: DP, then corridors along them."""
    scn, lane, starts, spec = setup
    rows = slice(1, 4)
    sub = scn.map(lambda a: a[rows])
    d = _dp(sub, starts[rows], spec)
    _same_dp(d, whole[0], rows)
    _same(TC.plan_corridors(sub, d.traj, CFG.corridor, lane), whole[1],
          rows)


@pytest.mark.parametrize("per_chunk", [1, 2])
def test_corridor_chunks_are_lane_local(setup, whole, monkeypatch,
                                        per_chunk):
    scn, lane, _, _ = setup
    k1 = CFG.corridor.max_points + 1
    monkeypatch.setattr(TC, "PAIRS_PER_CHUNK", per_chunk * 81 * k1 * k1)
    _same(TC.plan_corridors(scn, whole[0].traj, CFG.corridor, lane),
          whole[1])


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_arc_lengths_is_the_cpu_cumsum(dtype):
    """arc_lengths sums each row in one order (float64, rounded at each
    knot), which is what the CPU's cumsum computes: the port's CPU results
    did not move when the cumsum was replaced. A row's sums do not depend
    on the rows beside it."""
    rng = np.random.default_rng(0)
    seg = torch.tensor(rng.uniform(0.0, 2.0, (5, 80)), dtype=dtype)
    got = arc_lengths(seg)
    want = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg, -1)],
                     dim=-1)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(arc_lengths(seg[2:3]), got[2:3])


# operations whose CUDA algorithm, and so their rounding, can depend on the
# tensor's size, or whose order is unspecified on the card
WIDTH_DEPENDENT = {"cumsum", "cumprod", "logcumsumexp", "mm", "bmm", "addmm",
                   "baddbmm", "addbmm", "matmul", "dot", "mv", "addmv",
                   "mean", "var", "std", "var_mean", "std_mean", "norm",
                   "linalg_vector_norm", "prod", "nansum", "index_add",
                   "scatter_add", "scatter_reduce", "index_reduce",
                   "_index_put_impl_", "embedding_bag", "_linalg_det",
                   "linalg_inv_ex", "linalg_solve_ex", "trace"}


class OpAudit(TorchDispatchMode):
    """Records each operation that could make a lane's result depend on
    its batch on the card."""

    def __init__(self):
        super().__init__()
        self.bad = []
        self.sums = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        out = func(*args, **kwargs)
        if name in WIDTH_DEPENDENT:
            self.bad.append(str(func))
        elif name in ("sort", "argsort") and func._overloadname != "stable":
            self.bad.append(f"{func} (unstable)")
        elif (name == "sum" and args[0].is_floating_point()):
            self.sums += 1
            x = args[0]
            dims = args[1] if len(args) > 1 and args[1] is not None \
                else list(range(x.dim()))
            terms = (x != 0).to(torch.int64).sum(dims)
            if x.dim() and bool((terms > 1).any()):
                self.bad.append(f"{func} of {int(terms.max())} terms")
        return out


def test_stages_use_no_width_dependent_op(setup):
    """The DP, the corridors, the constraint prep and the re-check on two
    scenarios, every operation recorded: none of WIDTH_DEPENDENT, stable
    sorts only, and every float sum (the one-hot selections of the road
    rows and of the hull's edges) adding at most one non-zero term per
    output."""
    scn, lane, starts, spec = setup
    sub = scn.map(lambda a: a[3:5])
    st = starts[3:5]
    with OpAudit() as audit:
        d = _dp(sub, st, spec)
        c = TC.plan_corridors(sub, d.traj, CFG.corridor, lane)
        TP.prep_constraints(c, CFG)
        xs = TP.coarse_to_states(d.traj)
        TP._recheck_solution(sub, xs, CFG, spec)
        TP._recheck_solution(sub, xs, CFG, None)      # every barrier point
    assert not audit.bad, sorted(set(audit.bad))
    assert audit.sums > 0
