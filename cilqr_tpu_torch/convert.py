"""Carry inputs and results across from the JAX package, and load the
solve fixture (``benchdata/problems.npz``).

Nothing here imports JAX: configs cross as ``dataclasses.asdict``
dictionaries, arrays as numpy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .config import PlannerConfig, from_dict
from .costs import ConstraintSet, trim_constraints
from .types import SolveResult

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


def load_fixture(path: str = FIXTURE, dtype=torch.float32, device="cpu",
                 batch: int | None = None):
    """The solve fixture as (goals [B, N, 6], starts [B, 6], cons), with
    all-invalid padded constraint slots trimmed (exact); with ``batch``,
    the problems are tiled up to that many lanes."""
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
