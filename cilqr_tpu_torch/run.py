"""Command line of the port (PyTorch counterpart of cilqr_tpu/run.py): the
reference's planning_node/main and launch-file analog.

Usage examples:
  python -m cilqr_tpu_torch.run plan --seed 7 --save /tmp/plan.npz
  python -m cilqr_tpu_torch.run plan --seed 7 --cpu --out /tmp/plan.png
  python -m cilqr_tpu_torch.run batch --batch 64 --seed 0
  python -m cilqr_tpu_torch.run mpc --cycles 20
  python -m cilqr_tpu_torch.run scenario --seed 3 --out /tmp/scn.npz
  python -m cilqr_tpu_torch.run plan --config overrides.json
  python -m cilqr_tpu_torch.run dist --batch 1024          # every card
  python -m cilqr_tpu_torch.run dist --cpu --devices 2 --batch 4 --f64
  python -m cilqr_tpu_torch.run dist --num-processes 8 --process-id 0 \
      --coordinator host0:29500                            # one rank

Every command runs on the card unless ``--cpu``; ``--f64`` plans in
double precision. The reference plans from an RViz click with a fixed
start state (planning_node.cc:24-27,82); ``plan`` runs the same fixed
pedestrian_test case headlessly and draws matplotlib figures (``--out``,
``--animate``; matplotlib is imported only then) in place of RViz
markers. ``dist`` runs the full replan sharded over ranks
(dist.sharded_pipeline_step): ``--devices N`` starts N ranks on this host,
one a card under NCCL (0 = every card), or N gloo ranks on the CPU with
``--cpu``; with ``--num-processes`` > 1 this invocation is the one rank
``--process-id`` of a group whose rank 0 serves its store at
``--coordinator`` (host:port), and on a host of several cards it takes
card ``LOCAL_RANK`` (the process id if unset).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

START = (0.0, 0.0, 0.0, 10.0)
# seconds the local ranks of ``run dist`` may take, start-up included
DIST_TIMEOUT_S = 3600.0


def _load_config(path):
    from .config import PlannerConfig, from_dict

    if not path:
        return PlannerConfig()
    with open(path) as f:
        return from_dict(json.load(f))


def _settings(args):
    """(dtype, config, RoadSpec or None) of a command's flags."""
    import numpy as np
    import torch

    from . import scenario

    cfg = _load_config(args.config)
    # the CLI always plans on the generated pedestrian_test road, so its
    # closed-form RoadSpec is known: frenet mode takes the finite barrier
    # test and the closed-form station fields (dp.plan)
    spec = (scenario.analytic_road_spec(
        dtype=np.float64 if args.f64 else np.float32)
        if cfg.dp.collision_mode == "frenet" else None)
    return torch.float64 if args.f64 else torch.float32, cfg, spec


def _dist_rank(rank, world, coordinator, args, threads=None):
    """One rank of ``run dist``: join the group (NCCL on the rank's card,
    gloo with --cpu), make the batch of scenarios seed..seed+B on the host,
    take this rank's rows and run the sharded replan on them; rank 0
    prints the summed statistics. ``threads``: the CPU threads of this
    rank (None: PyTorch's default)."""
    import torch

    from . import pipeline, scenario
    from .dist import (init_distributed, make_batch_mesh, shard_batch,
                       sharded_pipeline_step)
    from .profiling import synchronize
    from .world import build_barrier_grid

    if threads:
        torch.set_num_threads(threads)
    init_distributed(coordinator, world, rank,
                     backend="gloo" if args.cpu else None)
    try:
        mesh = make_batch_mesh("cpu" if args.cpu else None)
        dtype, cfg, spec = _settings(args)
        n_dev = mesh.size
        B = args.batch - args.batch % n_dev or n_dev
        scns = scenario.make_scenario_batch(
            range(args.seed, args.seed + B), dtype=dtype, device="cpu")
        grid = (build_barrier_grid(scns.barrier_xy[0], cfg.dp.grid_cell,
                                   dtype=dtype, device=mesh.device)
                if cfg.dp.collision_mode == "grid" else None)
        lane = pipeline.make_lane_tuple(scns.left_barrier_xy[0],
                                        scns.right_barrier_xy[0], cfg)
        starts = torch.tensor(START, dtype=dtype).repeat(B, 1)
        step = sharded_pipeline_step(cfg, mesh, grid, lane, road_spec=spec)
        scns, starts = shard_batch(mesh, (scns, starts))
        synchronize(mesh.device)
        t0 = time.perf_counter()
        _, stats = step(scns, starts)
        synchronize(mesh.device)
        wall = time.perf_counter() - t0
        stats = {k: float(v) for k, v in stats.items()}
        if mesh.rank == 0:
            print(f"mesh={n_dev} batch={B} wall={wall:.2f}s stats={stats}",
                  flush=True)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _dist(args):
    """``run dist``: this process as one rank (--num-processes > 1), or
    --devices ranks started here, which meet through a file store in a
    temporary directory (no port to pick or collide on)."""
    if args.num_processes > 1:
        if not args.coordinator:
            raise SystemExit("run dist: --num-processes > 1 needs "
                             "--coordinator host:port (rank 0's store)")
        _dist_rank(args.process_id, args.num_processes, args.coordinator,
                   args)
        return 0
    import torch

    from .dist import launch_local

    n = args.devices or (1 if args.cpu else
                         max(torch.cuda.device_count(), 1))
    threads = None
    if args.cpu:                        # the ranks share this host's cores
        threads = max(1, (os.cpu_count() or 1) // n)
    else:
        # once here: every rank would otherwise run nvcc itself
        from .kernels import _build

        _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        launch_local(_dist_rank, n,
                     (n, f"file://{os.path.join(tmp, 'store')}", args,
                      threads), timeout=DIST_TIMEOUT_S)
    return 0


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

    p_dist = sub.add_parser(
        "dist", help="sharded full replan over ranks with summed stats")
    _add_common(p_dist)
    p_dist.add_argument("--batch", type=int, default=64)
    p_dist.add_argument("--devices", type=int, default=0,
                        help="ranks on this host (0 = every card; 1 with "
                             "--cpu)")
    p_dist.add_argument("--coordinator", type=str, default="",
                        help="host:port of rank 0's store (multi-process)")
    p_dist.add_argument("--num-processes", type=int, default=1)
    p_dist.add_argument("--process-id", type=int, default=0)
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.cmd == "dist":
        return _dist(args)

    import numpy as np
    import torch

    from . import pipeline, scenario
    from .profiling import synchronize
    from .types import SolverStatus

    device = "cpu" if args.cpu else "cuda"
    dtype, cfg, spec = _settings(args)

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
        out = pipeline.plan(scn, START, cfg, spec=spec)
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
        starts = torch.tensor(START, dtype=dtype, device=device).repeat(
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
        results = run_mpc(scn, START, cfg, args.cycles, spec=spec)
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
