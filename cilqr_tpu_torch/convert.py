"""Carry inputs and results across from the JAX package, and load the
solve fixture (``benchdata/problems.npz``).

Nothing here imports JAX: configs cross as ``dataclasses.asdict``
dictionaries, arrays as numpy (a JAX object is read through its field
names and ``numpy.asarray``). Tensors go to the card unless ``device``
says otherwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import PlannerConfig, from_dict
from .costs import ConstraintSet, trim_constraints
from .scenario import RoadSpec, scenario_from_arrays
from .types import CostBreakdown, Scenario, SolveResult, Traj
from .world import BarrierGrid

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchdata", "problems.npz")


def config_from_dict(d: dict) -> PlannerConfig:
    """PlannerConfig from ``dataclasses.asdict`` of either package's
    config (tuples may arrive as lists)."""

    def tuples(v):
        if isinstance(v, dict):
            return {k: tuples(x) for k, x in v.items()}
        if isinstance(v, list):
            return tuple(v)
        return v

    return from_dict(tuples(d))


def constraints_from_numpy(cons, dtype, device) -> ConstraintSet:
    """ConstraintSet from any 8-sequence of arrays in ConstraintSet field
    order (a numpy or JAX ConstraintSet); masks stay bool."""

    def conv(a):
        a = np.array(a)
        if a.dtype == np.bool_:
            return torch.tensor(a, device=device)
        return torch.tensor(a, dtype=dtype, device=device)

    return ConstraintSet(*(conv(a) for a in cons))


def result_to_numpy(res: SolveResult) -> dict:
    """SolveResult -> flat dict of numpy arrays (cost fields as cost_*)."""
    out = {}
    for name in ("xs", "us", "status", "iters", "lam", "init_xs", "init_us",
                 "lane_clipped"):
        v = getattr(res, name)
        if v is not None:
            out[name] = v.detach().cpu().numpy()
    for name in ("total", "target", "dynamic", "corridor", "lane"):
        out[f"cost_{name}"] = getattr(res.cost, name).detach().cpu().numpy()
    return out


def solve_result_from_numpy(res, dtype=torch.float32,
                           device="cuda") -> SolveResult:
    """SolveResult from any object with its fields (a JAX SolveResult,
    batched or not): floats in ``dtype``, status and iters int32,
    lane_clipped bool (or None)."""

    def conv(a):
        a = np.array(a)
        if a.dtype == np.bool_ or a.dtype.kind in "iu":
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    cost = CostBreakdown(*(conv(getattr(res.cost, f))
                           for f in CostBreakdown.__dataclass_fields__))
    return SolveResult(**{f: (cost if f == "cost" else
                              None if getattr(res, f) is None else
                              conv(getattr(res, f)))
                          for f in SolveResult.__dataclass_fields__})


def mpc_carry_from_numpy(carry, dtype=torch.float32, device="cuda"):
    """mpc.MpcCarry from any object with its fields (a JAX MpcCarry):
    xs, us and cycle_time in ``dtype``, no_repair bool (or None)."""
    from .mpc import MpcCarry

    nr = carry.no_repair
    return MpcCarry(
        xs=torch.as_tensor(np.array(carry.xs), dtype=dtype, device=device),
        us=torch.as_tensor(np.array(carry.us), dtype=dtype, device=device),
        cycle_time=torch.as_tensor(np.array(carry.cycle_time), dtype=dtype,
                                   device=device),
        no_repair=None if nr is None else torch.as_tensor(
            np.array(nr, dtype=bool), device=device))


def load_fixture(path: str = FIXTURE, dtype=torch.float32, device="cuda",
                 batch: int | None = None):
    """The solve fixture as (goals [B, N, 6], starts [B, 6], cons), with
    all-invalid padded constraint slots trimmed (exact); with ``batch``,
    the problems are tiled up to that many lanes. On the card unless
    ``device`` says otherwise."""
    d = np.load(path)
    goals = torch.as_tensor(d["goals"], dtype=dtype, device=device)
    starts = torch.as_tensor(d["starts"], dtype=dtype, device=device)
    cons = constraints_from_numpy(
        [d[k] for k in ConstraintSet._fields], dtype, device)
    cons = trim_constraints(cons)
    if batch:
        rep = -(-batch // goals.shape[0])

        def tile(a):
            return torch.cat([a] * rep, dim=0)[:batch]

        goals, starts = tile(goals), tile(starts)
        cons = cons.map(tile)
    return goals, starts, cons


def scenario_from_numpy(scn, dtype=torch.float32, device="cuda") -> Scenario:
    """Scenario from any object with Scenario's fields (a JAX Scenario,
    batched or not, or a port one): floats in ``dtype``, masks bool,
    dyn_len int32."""
    arrays = {f: np.array(getattr(scn, f)) for f in
              Scenario.__dataclass_fields__ if f != "centerline"}
    arrays["centerline"] = {f: np.array(getattr(scn.centerline, f))
                            for f in Traj.__dataclass_fields__}
    return scenario_from_arrays(arrays, dtype, device)


def scenario_to_numpy(scn: Scenario) -> dict:
    """Scenario -> flat dict of numpy arrays (centerline fields as
    centerline_*)."""
    out = {f: getattr(scn, f).detach().cpu().numpy()
           for f in Scenario.__dataclass_fields__ if f != "centerline"}
    for f in Traj.__dataclass_fields__:
        out[f"centerline_{f}"] = getattr(scn.centerline, f).cpu().numpy()
    return out


def lane_from_numpy(lane, dtype=torch.float32, device="cuda") -> tuple:
    """The lane tuple (left planes, segs, mask, right planes, segs, mask)
    as tensors: floats in ``dtype``, masks bool."""

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.as_tensor(a, device=device)
        return torch.as_tensor(a, dtype=dtype, device=device)

    return tuple(conv(a) for a in lane)


def road_spec_from_numpy(spec) -> RoadSpec:
    """RoadSpec from any object with its fields (a JAX RoadSpec): the
    same values, as numpy arrays in their own types."""
    return RoadSpec(**{f: (int(spec.n) if f == "n"
                           else np.asarray(getattr(spec, f)))
                       for f in RoadSpec.__dataclass_fields__
                       if not f.startswith("_")})


def barrier_grid_from_numpy(grid, dtype=None, device="cuda") -> BarrierGrid:
    """world.BarrierGrid from any object with its fields (a JAX
    BarrierGrid): the same tables; the origin in its own type unless
    ``dtype`` is given."""
    def conv(a, dt=None):
        return None if a is None else torch.as_tensor(np.array(a), dtype=dt,
                                                      device=device)

    return BarrierGrid(integral=conv(grid.integral),
                       origin=conv(grid.origin, dtype), cell=float(grid.cell),
                       dilated=conv(grid.dilated),
                       half=None if grid.half is None else float(grid.half),
                       span=None if grid.span is None else int(grid.span))
