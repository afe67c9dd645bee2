"""Ranks of tests/test_torch_dist.py: gloo ranks on the CPU, started with
the spawn method by dist.launch_local, meeting through a file store. A
spawned rank imports this module to find its function, so it imports
torch and the port only, never JAX. Each rank saves what the test checks
to ``<out>/rank<r>.pt``."""

import os

import torch


def _join(rank, world, out):
    from cilqr_tpu_torch import dist

    # the six xdist workers' ranks share the machine's cores
    torch.set_num_threads(1)
    dist.init_distributed(f"file://{os.path.join(out, 'store')}", world,
                          rank, backend="gloo")
    return dist


def _leave(out, rank, result):
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def solve_rank(rank, world, out, goals, starts, cons):
    """dist.sharded_solve_step on this rank's block of the numpy problem,
    passed through global_batch; first a global_batch of unequal row
    counts (the last rank one row short), which must raise everywhere."""
    from cilqr_tpu_torch.config import PlannerConfig
    from cilqr_tpu_torch.convert import constraints_from_numpy

    dist = _join(rank, world, out)
    mesh = dist.make_batch_mesh("cpu")
    n = goals.shape[0] // world
    lo, hi = rank * n, (rank + 1) * n
    try:
        dist.global_batch(mesh, torch.zeros(n - (rank == world - 1), 3))
        mismatch = None
    except ValueError as e:
        mismatch = str(e)
    cons = constraints_from_numpy([c[lo:hi] for c in cons], torch.float64,
                                  "cpu")
    local = dist.global_batch(mesh, (goals[lo:hi], starts[lo:hi], cons))
    res, stats = dist.sharded_solve_step(PlannerConfig(), mesh)(*local)
    _leave(out, rank, {"mismatch": mismatch, "us": res.us,
                       "status": res.status, "iters": res.iters,
                       "stats": stats})


def replan_rank(rank, world, out, seeds, cfg, plan_xs, plan_us):
    """dist.sharded_pipeline_step on this rank's rows of the scenarios of
    ``seeds`` (shard_batch of the whole host batch), then one cycle of
    dist.sharded_mpc_step from its rows of the plans ``plan_xs`` /
    ``plan_us`` (the unsharded replan's); float64."""
    import numpy as np

    from cilqr_tpu_torch import mpc, pipeline, scenario

    dist = _join(rank, world, out)
    mesh = dist.make_batch_mesh("cpu")
    f64 = torch.float64
    scns = scenario.make_scenario_batch(seeds, dtype=f64, device="cpu")
    lane = pipeline.make_lane_tuple(scns.left_barrier_xy[0],
                                    scns.right_barrier_xy[0], cfg)
    spec = scenario.analytic_road_spec(dtype=np.float64)
    starts = torch.tensor((0.0, 0.0, 0.0, 10.0), dtype=f64).repeat(
        len(seeds), 1)
    scns, starts = dist.shard_batch(mesh, (scns, starts))
    plan, stats = dist.sharded_pipeline_step(cfg, mesh, None, lane,
                                             road_spec=spec)(scns, starts)
    carry = dist.shard_batch(mesh, mpc.MpcCarry(
        xs=plan_xs, us=plan_us, cycle_time=torch.zeros(len(seeds), dtype=f64)))
    final, mstats = dist.sharded_mpc_step(cfg, mesh, lane, 1,
                                          road_spec=spec)(scns, carry)
    _leave(out, rank, {"status": plan.solve.status,
                       "iters": plan.solve.iters, "us": plan.solve.us,
                       "cost": plan.solve.cost.total,
                       "stats": stats, "mpc_us": final.us,
                       "mpc_xs": final.xs,
                       "mpc_no_repair": final.no_repair,
                       "mpc_stats": mstats})
