"""The general traffic generator: every input of a run, from ``--seed`` and
the cell's data files alone.

A run's batch holds the pedestrian_test scenarios of seeds
``seed * batch ... seed * batch + batch - 1``, drawn by the benchmark's own
copy of the upstream generator (``ref.scenario``'s numpy core), and each
call's start states: the configuration's start with a fresh uniform
perturbation of +-``perturb_y`` m on y, lane by lane. A mix with
``fixed_scenarios`` poses the same problems for every seed (scenarios 0 ..
batch - 1 and seed 0's perturbations) in an order drawn from the seed. The
same seed gives the same arrays, bit for bit."""

from __future__ import annotations

import numpy as np

from .ref import scenario as scn_core

SEED_MASK = (1 << 64) - 1


def _tuples(v):
    if isinstance(v, dict):
        return {k: _tuples(x) for k, x in v.items()}
    if isinstance(v, list):
        return tuple(_tuples(x) for x in v)
    return v


def planner(config: dict) -> dict:
    """The configuration's planner parameters, as ``from_dict`` of the
    program's and of the reference's config take them (JSON lists as the
    tuples the config holds)."""
    return _tuples(config["planner"])


def lane_order(seed: int, batch: int) -> np.ndarray:
    """A permutation of the batch's lanes drawn from the seed."""
    return np.random.default_rng([int(seed) & SEED_MASK, 4]).permutation(
        batch)


def scenario_seeds(seed: int, batch: int, fixed: bool = False):
    """The scenario seeds of a run's lanes: ``seed * batch + i``, or with
    ``fixed`` the same set 0 .. batch - 1 for every seed, in the seed's
    ``lane_order`` (where the problems set the work, as in the MPC loop,
    whose repair ladder runs only on cycles with a dirty lane)."""
    if fixed:
        return [int(i) for i in lane_order(seed, batch)]
    base = (int(seed) & SEED_MASK) * batch
    return [base + i for i in range(batch)]


def scenario_arrays(config: dict, seed: int, batch: int,
                    fixed: bool = False) -> dict:
    """The stacked float64 arrays of a batch of scenarios (one road shared),
    keyed as ``ref.scenario.make_scenario_arrays`` keys them."""
    sc = config["scenario"]
    road = tuple(tuple(s) if isinstance(s, list) else s for s in sc["road"])
    cl = scn_core.make_centerline(road)
    barriers = scn_core.build_road_barriers(cl)
    rows = [scn_core.make_scenario_arrays(
        s, road=road, n_static=sc["n_static"], n_ped=sc["n_pedestrians"],
        n_dyn_veh=sc["n_dynamic_vehicles"], cl=cl, barriers=barriers)
        for s in scenario_seeds(seed, batch, fixed)]
    arrays = {k: np.stack([r[k] for r in rows]) for k in rows[0]
              if k != "centerline"}
    arrays["centerline"] = {k: np.stack([r["centerline"][k] for r in rows])
                            for k in rows[0]["centerline"]}
    return arrays


def road_arrays(config: dict):
    """(left, right) barrier polylines of the configuration's road, float64
    numpy [NB2, 2]."""
    sc = config["scenario"]
    road = tuple(tuple(s) if isinstance(s, list) else s for s in sc["road"])
    _, left, right = scn_core.build_road_barriers(
        scn_core.make_centerline(road))
    return left, right


def perturbations(seed: int, calls: int, batch: int, amp: float,
                  fixed: bool = False):
    """[calls, batch] float64 offsets on y, uniform in [-amp, amp]: row k is
    call k's. With ``fixed``, the offsets of seed 0 with their lanes in the
    seed's ``lane_order``, so that every seed poses the same problems."""
    if fixed:
        return perturbations(0, calls, batch, amp)[:, lane_order(seed,
                                                                 batch)]
    rng = np.random.default_rng([int(seed) & SEED_MASK, 1])
    return rng.uniform(-amp, amp, size=(calls, batch))


def starts(config: dict, dy) -> np.ndarray:
    """Start states [batch, 4] (x, y, theta, v): the configuration's start
    moved by dy on y."""
    s = np.asarray(config["start"], dtype=np.float64)
    out = np.repeat(s[None], len(dy), axis=0)
    out[:, 1] += dy
    return out


def sample_lanes(seed: int, batch: int, n: int) -> np.ndarray:
    """n distinct lanes of the batch drawn from the seed, sorted."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, 2])
    return np.sort(rng.choice(batch, size=min(n, batch), replace=False))


def sample_index(seed: int, n: int) -> int:
    """One index in [0, n) drawn from the seed."""
    rng = np.random.default_rng([int(seed) & SEED_MASK, 3])
    return int(rng.integers(n))
