"""Generate the solve fixture (PyTorch counterpart of
cilqr_tpu/bench_prep.py): B pedestrian_test problems (seeds 0..B-1)
taken through the DP (the default configuration's frenet mode without a
RoadSpec: the station-field stand-in; the road's BarrierGrid is passed
and ignored there, as in the JAX package), the corridors and the
constraint prep in float32, saved as an npz in the layout of
``benchdata/problems.npz`` (goals, starts, dp_ok and the eight
ConstraintSet arrays, untrimmed).

Usage: python -m cilqr_tpu_torch.bench_prep --out PATH [--batch 256]
       [--cpu]

The seeds are prepared as one batch (the same computation, scenario by
scenario; the DP bounds its own memory). On the card unless ``--cpu``.
``--out`` has no default, so the committed fixture is replaced only when
named.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from .costs import ConstraintSet

START = (0.0, 0.0, 0.0, 10.0)


def dp_plan(scns, cfg):
    """The fixture's DP of a scenario batch from the fixed start: dp.plan
    with the road's BarrierGrid and no RoadSpec (its winning cells are what
    the fixture's goals and corridors follow)."""
    from . import dp, pipeline

    B = scns.static_obs.shape[0]
    dtype, dev = scns.centerline.x.dtype, scns.centerline.x.device
    st = torch.tensor(START[:3], dtype=dtype, device=dev).expand(B, 3)
    grid = pipeline.road_grid(scns.barrier_xy[0], cfg)
    return dp.plan(scns, st[:, 0], st[:, 1], st[:, 2], cfg, grid)


def prep(scns, cfg):
    """The fixture's problems of a scenario batch: (goals [B, N, 6], the
    untrimmed ConstraintSet, dp_ok [B]), from the fixed start."""
    from . import corridor, costs, pipeline, scenario

    dp_res = dp_plan(scns, cfg)
    # the lane from the road's float64 host polylines, as the JAX package
    # builds it (from the float32 ones a lane plane can change its segment)
    barriers = scenario.build_road_barriers(scenario.make_centerline())
    lane = pipeline.make_lane_tuple(barriers[1], barriers[2], cfg)
    cors = corridor.plan_corridors(scns, dp_res.traj, cfg.corridor, lane)
    cons = costs.shrink_and_normalize(
        cors.planes, cors.plane_mask, cors.left_planes, cors.left_segs,
        cors.left_mask, cors.right_planes, cors.right_segs, cors.right_mask,
        cfg.ilqr, cfg.vehicle)
    return pipeline.coarse_to_states(dp_res.traj), cons, dp_res.ok


def make_fixture(batch: int, device="cuda"):
    """Every array of the fixture for seeds 0..batch-1, as numpy."""
    from . import scenario
    from .config import PlannerConfig

    scns = scenario.make_scenario_batch(range(batch), dtype=torch.float32,
                                        device=device)
    goals, cons, ok = prep(scns, PlannerConfig())
    starts = np.zeros((batch, 6), np.float32)
    starts[:, 3] = START[3]
    return dict(goals=goals.cpu().numpy(), starts=starts,
                dp_ok=ok.cpu().numpy(),
                **{k: c.cpu().numpy()
                   for k, c in zip(ConstraintSet._fields, cons)})


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cilqr_tpu_torch.bench_prep")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    arrays = make_fixture(args.batch, "cpu" if args.cpu else "cuda")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out}: {args.batch} problems, "
          f"dp_ok={np.mean(arrays['dp_ok']):.2%}")
    return 0


if __name__ == "__main__":
    main()
