"""Scenario and result checkpoints as npz archives (PyTorch counterpart of
cilqr_tpu/checkpoint.py), in the JAX package's layout: one array per
field, named as the JAX package names the leaves of its pytrees
(``scn:centerline/x``, ``scn:dyn_obs``, ``res:cost/total``), so that a
file saved by either package loads in the other. The reference's pickle
fixtures (reference_publisher.py:232-236, pickle_publisher.py:24-40) are
what these replace.

Saving takes tensors on any device; ``load_*`` put the tensors on the
card unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from .types import CostBreakdown, Scenario, SolveResult, Traj

# leaf names of the JAX package's Scenario and SolveResult pytrees, in
# their flattening order
SCENARIO_KEYS = (
    tuple(f"centerline/{f}" for f in Traj.__dataclass_fields__)
    + ("static_obs", "static_mask", "dyn_obs", "dyn_times", "dyn_mask",
       "dyn_len", "barrier_xy", "barrier_mask", "left_barrier_xy",
       "left_barrier_mask", "right_barrier_xy", "right_barrier_mask"))
RESULT_KEYS = ("xs", "us", "status", "iters", "cost/total", "cost/target",
               "cost/dynamic", "cost/corridor", "cost/lane", "lam",
               "init_xs", "init_us", "lane_clipped")


def _leaf(tree, key):
    """The field at a slash-separated path, or None."""
    for name in key.split("/"):
        tree = getattr(tree, name)
    return tree


def _save(path, prefix, tree, keys):
    out = {}
    for k in keys:
        v = _leaf(tree, k)
        if v is not None:          # a None field has no leaf in JAX either
            out[prefix + k] = (v.detach().cpu().numpy()
                               if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    np.savez_compressed(path, **out)


def save_scenario(path, scn: Scenario):
    _save(path, "scn:", scn, SCENARIO_KEYS)


def load_scenario(path, dtype=torch.float32, device="cuda") -> Scenario:
    """Floats in ``dtype``; masks, lengths and indices in their stored
    types."""
    with np.load(path) as data:
        def get(name):
            a = data[f"scn:{name}"]
            if a.dtype.kind == "f":
                return torch.as_tensor(a, dtype=dtype, device=device)
            return torch.as_tensor(a, device=device)

        cl = Traj(**{f: get(f"centerline/{f}")
                     for f in Traj.__dataclass_fields__})
        return Scenario(centerline=cl, **{
            k: get(k) for k in SCENARIO_KEYS if not k.startswith("centerline")})


def save_result(path, res: SolveResult):
    _save(path, "res:", res, RESULT_KEYS)


def load_result(path, device="cuda") -> SolveResult:
    """Every array in its stored type."""
    with np.load(path) as data:
        def get(name):
            key = f"res:{name}"
            return (torch.as_tensor(data[key], device=device)
                    if key in data else None)

        return SolveResult(
            xs=get("xs"), us=get("us"), status=get("status"),
            iters=get("iters"),
            cost=CostBreakdown(**{f: get(f"cost/{f}")
                                  for f in CostBreakdown.__dataclass_fields__}),
            lam=get("lam"), init_xs=get("init_xs"), init_us=get("init_us"),
            lane_clipped=get("lane_clipped"))
