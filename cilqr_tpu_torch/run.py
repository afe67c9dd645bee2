"""Command line of the port (PyTorch counterpart of cilqr_tpu/run.py): the
reference's planning_node/main and launch-file analog.

Usage examples:
  python -m cilqr_tpu_torch.run plan --seed 7 --save /tmp/plan.npz
  python -m cilqr_tpu_torch.run plan --seed 7 --cpu --out /tmp/plan.png
  python -m cilqr_tpu_torch.run batch --batch 64 --seed 0
  python -m cilqr_tpu_torch.run mpc --cycles 20
  python -m cilqr_tpu_torch.run scenario --seed 3 --out /tmp/scn.npz
  python -m cilqr_tpu_torch.run plan --config overrides.json

Every command runs on the card unless ``--cpu``; ``--f64`` plans in
double precision. The reference plans from an RViz click with a fixed
start state (planning_node.cc:24-27,82); ``plan`` runs the same fixed
pedestrian_test case headlessly and draws matplotlib figures (``--out``,
``--animate``; matplotlib is imported only then) in place of RViz
markers. ``dist`` (the sharded batch over several processes) is not
ported yet: it raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _load_config(path):
    from .config import PlannerConfig, from_dict

    if not path:
        return PlannerConfig()
    with open(path) as f:
        return from_dict(json.load(f))


def _add_common(p):
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", type=str, default="",
                   help="JSON config override file")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--f64", action="store_true", help="double precision")


def _parser():
    ap = argparse.ArgumentParser(prog="cilqr_tpu_torch.run")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_plan = sub.add_parser("plan", help="single full plan (pedestrian_test)")
    _add_common(p_plan)
    p_plan.add_argument("--out", type=str, default="",
                        help="write scenario+trajectory figure (png)")
    p_plan.add_argument("--save", type=str, default="",
                        help="save result npz")
    p_plan.add_argument("--animate", type=str, default="",
                        help="write animated playback GIF (planning_node.cc"
                             ":82-112 analog)")
    p_plan.add_argument("--animate-every", type=int, default=2,
                        help="animate every k-th knot")

    p_batch = sub.add_parser("batch", help="batched scenario plans")
    _add_common(p_batch)
    p_batch.add_argument("--batch", type=int, default=64)

    p_mpc = sub.add_parser("mpc", help="receding-horizon MPC loop")
    _add_common(p_mpc)
    p_mpc.add_argument("--cycles", type=int, default=20)

    p_scn = sub.add_parser("scenario", help="generate + save a scenario npz")
    _add_common(p_scn)
    p_scn.add_argument("--out", type=str, required=True)

    p_dist = sub.add_parser("dist", help="sharded batch (not ported yet)")
    _add_common(p_dist)
    p_dist.add_argument("--batch", type=int, default=64)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cmd == "dist":
        raise NotImplementedError(
            "run dist, the sharded batch over several processes, is not "
            "ported yet (ROADMAP.md, queue 1: dist.py on torch.distributed, "
            "with run.py dist and its multi-process flags)")

    import numpy as np
    import torch

    from . import pipeline, scenario
    from .profiling import synchronize
    from .types import SolverStatus

    device = "cpu" if args.cpu else "cuda"
    dtype = torch.float64 if args.f64 else torch.float32
    start = (0.0, 0.0, 0.0, 10.0)
    cfg = _load_config(args.config)
    # the CLI always plans on the generated pedestrian_test road, so its
    # closed-form RoadSpec is known: frenet mode takes the finite barrier
    # test and the closed-form station fields (dp.plan)
    spec = (scenario.analytic_road_spec(
        dtype=np.float64 if args.f64 else np.float32)
        if cfg.dp.collision_mode == "frenet" else None)

    if args.cmd == "scenario":
        from . import checkpoint

        scn = scenario.make_scenario(args.seed, dtype=dtype, device=device)
        checkpoint.save_scenario(args.out, scn)
        print(f"scenario seed={args.seed} -> {args.out}")
        return 0

    if args.cmd == "plan":
        scn = scenario.make_scenario(args.seed, dtype=dtype, device=device)
        synchronize(device)
        t0 = time.perf_counter()
        out = pipeline.plan(scn, start, cfg, spec=spec)
        synchronize(device)
        dt_ms = (time.perf_counter() - t0) * 1e3
        hits = out.solve_hits.cpu().numpy()
        print(f"dp_ok={bool(out.dp_ok)} "
              f"corridors_ok={bool(out.corridors.ok.all())} "
              f"status={SolverStatus(int(out.solve.status)).name} "
              f"iters={int(out.solve.iters)} "
              f"cost={float(out.solve.cost.total):.3f} "
              f"recheck: near25={int(hits[:25].sum())} "
              f"tail={int(hits[25:].sum())} colliding knots; "
              f"wall={dt_ms:.1f} ms")
        if args.save:
            from . import checkpoint

            checkpoint.save_result(args.save, out.solve)
        if args.out:
            from . import viz

            fig = viz.plot_scenario(scn, out)
            viz.plot_corridors(out.corridors, fig.axes[0])
            fig.savefig(args.out, dpi=120)
            tr = pipeline.traj_from_solution(out.solve.xs, out.solve.us,
                                             cfg.delta_t,
                                             cfg.vehicle.wheel_base)
            fig2 = viz.plot_states_dashboard(tr, cfg.vehicle)
            fig2.savefig(args.out.replace(".png", "_states.png"), dpi=120)
            print(f"figures -> {args.out}")
        if args.animate:
            from . import viz

            viz.animate_plan(scn, out, cfg, args.animate,
                             every=args.animate_every)
            print(f"animation -> {args.animate}")
        return 0

    if args.cmd == "batch":
        from .batch import BatchMetrics
        from .world import build_barrier_grid

        scns = scenario.make_scenario_batch(
            range(args.seed, args.seed + args.batch), dtype=dtype,
            device=device)
        # every scenario through the whole replan with the single-problem
        # solver, as the JAX package's vmap of pipeline.plan
        grid = None
        if cfg.dp.collision_mode == "grid":
            grid = build_barrier_grid(scns.barrier_xy[0], cfg.dp.grid_cell,
                                      dtype=dtype, device=device)
        lane = pipeline.make_lane_tuple(scns.left_barrier_xy[0].cpu(),
                                        scns.right_barrier_xy[0].cpu(), cfg)
        starts = torch.tensor(start, dtype=dtype, device=device).repeat(
            args.batch, 1)
        synchronize(device)
        t0 = time.perf_counter()
        out = pipeline.plan_batch(scns, starts, cfg, grid, lane,
                                  backend="vmap", spec=spec)
        synchronize(device)
        wall = time.perf_counter() - t0
        m = BatchMetrics.from_result(out.solve)
        print(f"batch={args.batch} wall={wall:.2f}s "
              f"converged={m.converged_fraction:.2%} "
              f"iters mean={m.iters_mean:.1f} p99={m.iters_p99:.0f}")
        print("statuses:", m.status_counts)
        return 0

    if args.cmd == "mpc":
        from .mpc import run_mpc

        scn = scenario.make_scenario(args.seed, dtype=dtype, device=device)
        t0 = time.perf_counter()
        results = run_mpc(scn, start, cfg, args.cycles, spec=spec)
        synchronize(device)
        wall = time.perf_counter() - t0
        statuses = [SolverStatus(int(r.solve.status)).name for r in results]
        iters = [int(r.solve.iters) for r in results]
        cor_ok = sum(bool(r.corridor_ok) for r in results)
        near_dirty = sum(bool(r.near_hits) for r in results)
        print(f"mpc cycles={args.cycles} wall={wall:.2f}s "
              f"iters: first={iters[0]} mean_rest={np.mean(iters[1:]):.1f} "
              f"corridor_ok={cor_ok}/{len(results)} "
              f"executed-horizon dirty={near_dirty}/{len(results)}")
        print("statuses:", {s: statuses.count(s) for s in set(statuses)})
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
