"""The fleet's inputs: a road a lane, each drawn from the configuration's
road family, and each lane's scenario on its own road, from ``--seed`` and
the configuration alone.

A road keeps the upstream road's topology (``roads.base``: straights and
arcs in the segment grammar of reference_publisher.py:200-209) with each
length and each radius multiplied by its own factor, drawn uniform in
``roads.factor`` from the seed. Every arc turns the road back east of the
leg before it, and adjacent legs lie at least twice the smallest radius
apart, more than the road's width: no road overlaps itself. Lane i of a
run is on road i and poses scenario ``seed * batch + i`` of
pedestrian_test on it. Roads of unequal length are stacked padded to the
longest: barrier points by their last one, masked out; the centerline by
its last row repeated. The same seed gives the same arrays, bit for bit.
"""

from __future__ import annotations

import numpy as np

from .inputs import SEED_MASK, scenario_seeds
from .ref import scenario as scn_core

# the per-road arrays and their masks padded to the longest road
ROAD_ARRAYS = (("barrier_xy", "barrier_mask"),
               ("left_barrier_xy", "left_barrier_mask"),
               ("right_barrier_xy", "right_barrier_mask"))


def _base(config: dict):
    return [tuple(s) if isinstance(s, list) else s
            for s in config["roads"]["base"]]


def draw_roads(config: dict, seed: int, n: int):
    """n roads of the configuration's family drawn from the seed: each a
    road tuple in the upstream grammar (length, or (degrees, radius))."""
    base = _base(config)
    lo, hi = config["roads"]["factor"]
    f = np.random.default_rng([int(seed) & SEED_MASK, 5]).uniform(
        lo, hi, size=(n, len(base)))
    return [tuple((seg[0], seg[1] * float(f[r, k]))
                  if isinstance(seg, tuple) else seg * float(f[r, k])
                  for k, seg in enumerate(base)) for r in range(n)]


def road_arrays(road):
    """(centerline, (both, left, right)) of one road: the upstream
    generator's centerline and its 0.1 m barrier points, float64."""
    cl = scn_core.make_centerline(road)
    return cl, scn_core.build_road_barriers(cl)


def stack(rows) -> dict:
    """Scenario dicts stacked over a leading axis, padded to the longest
    road (see the module's docstring)."""
    def edge(a, n):
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], n - len(a), axis=0)])

    def pad(arrs, fill=None):
        n = max(len(a) for a in arrs)
        if fill is None:
            return np.stack([edge(a, n) for a in arrs])
        return np.stack([np.concatenate([a, np.full(n - len(a), fill)])
                         for a in arrs])

    road = {k for pair in ROAD_ARRAYS for k in pair}
    out = {k: np.stack([r[k] for r in rows]) for k in rows[0]
           if k != "centerline" and k not in road}
    for pts, mask in ROAD_ARRAYS:
        out[pts] = pad([r[pts] for r in rows])
        out[mask] = pad([r[mask] for r in rows], False)
    out["centerline"] = {k: pad([r["centerline"][k] for r in rows])
                         for k in rows[0]["centerline"]}
    return out


def fleet_arrays(config: dict, seed: int, batch: int):
    """(arrays, roads): the stacked float64 scenario arrays of a run (lane
    i on road i) and the roads drawn."""
    sc = config["scenario"]
    roads = draw_roads(config, seed, batch)
    rows = []
    for s, road in zip(scenario_seeds(seed, batch), roads):
        cl, barriers = road_arrays(road)
        rows.append(scn_core.make_scenario_arrays(
            s, road=road, n_static=sc["n_static"],
            n_ped=sc["n_pedestrians"], n_dyn_veh=sc["n_dynamic_vehicles"],
            cl=cl, barriers=barriers))
    return stack(rows), roads


def lane_arrays(arrays: dict, lanes) -> dict:
    """The arrays of some lanes, unpadded to their own road where they all
    share one (the reference's view of one road's lanes)."""
    def take(a):
        return a[lanes]

    out = {k: take(v) for k, v in arrays.items() if k != "centerline"}
    out["centerline"] = {k: take(v) for k, v in arrays["centerline"].items()}
    n = int(_rows(out["centerline"]["s"]).max())
    out["centerline"] = {k: v[:, :n] for k, v in out["centerline"].items()}
    for pts, mask in ROAD_ARRAYS:
        m = int(out[mask].sum(-1).max())
        out[pts] = out[pts][:, :m]
        out[mask] = out[mask][:, :m]
    return out


def _rows(s):
    """Each padded station table's own row count."""
    return (s < s[..., -1:]).sum(-1) + 1
