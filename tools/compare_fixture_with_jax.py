#!/usr/bin/env python3
"""Where the port's bench_prep and the committed fixture part ways, and why.

Runs the port's bench_prep (frenet-mode DP without a RoadSpec, float32)
on the CPU for seeds 0..N-1 and compares it with
``benchdata/problems.npz`` seed by seed; for every seed whose goals differ by more than 1e-2 it runs
the JAX package's bench_prep DP on the same seed (float32, without 64-bit
types, as ``python -m cilqr_tpu.bench_prep`` runs it), jitted and op by
op, and prints the winning cells and minimum costs of the three.

Run from the repository root:
  JAX_PLATFORMS=cpu python tools/compare_fixture_with_jax.py [--batch 256]
(several minutes on the CPU; the port's side alone is
``cilqr_tpu_torch.bench_prep.make_fixture``).
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from cilqr_tpu import dp as JD
    from cilqr_tpu import scenario as JS
    from cilqr_tpu.config import PlannerConfig as JPlannerConfig
    from cilqr_tpu.pipeline import coarse_to_states as jax_goals
    from cilqr_tpu.world import build_barrier_grid as jax_grid
    from cilqr_tpu_torch import bench_prep, scenario
    from cilqr_tpu_torch.config import PlannerConfig

    arr = bench_prep.make_fixture(args.batch, "cpu")
    with np.load(os.path.join(ROOT, "benchdata", "problems.npz")) as ref:
        ref = {k: ref[k][:args.batch] for k in arr}
    gd = np.abs(arr["goals"] - ref["goals"]).max(axis=(1, 2))
    bad = np.nonzero(gd > 1e-2)[0].tolist()
    masks = [k for k in arr if k.endswith("_mask")]
    agree = sum(int((arr[k] == ref[k]).sum()) for k in masks) / sum(
        arr[k].size for k in masks)
    print(f"port bench_prep (CPU, float32) against the file, {args.batch} "
          f"seeds: dp_ok {int(arr['dp_ok'].sum())} / {int(ref['dp_ok'].sum())}"
          f"; mask slots agreeing {agree:.5f}; seeds whose goals differ by "
          f"> 1e-2: {bad}", flush=True)

    jcfg = JPlannerConfig()
    cl = JS.make_centerline()
    barriers = JS.build_road_barriers(cl)
    jgrid = jax_grid(barriers[0], jcfg.dp.grid_cell, half=jcfg.vehicle.radius)

    def jax_dp(scn):
        return JD.plan(scn, *map(jnp.asarray, bench_prep.START[:3]), jcfg,
                       jgrid)

    jitted = jax.jit(jax_dp)
    cfg = PlannerConfig()
    from cilqr_tpu_torch.pipeline import coarse_to_states

    for s in bad:
        js = JS.make_scenario(s, cl=cl, barriers=barriers, dtype=jnp.float32)
        rj = jitted(js)
        with jax.disable_jit():
            ro = jax_dp(js)
        scn = scenario.make_scenario_batch([s], dtype=torch.float32,
                                           device="cpu")
        rt = bench_prep.dp_plan(scn, cfg)
        goals_j = np.asarray(jax_goals(rj.traj))
        print(f"seed {s}: |goals| JAX jitted - file "
              f"{np.abs(goals_j - ref['goals'][s]).max():.3g}, port - file "
              f"{gd[s]:.3g}, port - JAX jitted "
              f"{np.abs(coarse_to_states(rt.traj)[0].numpy() - goals_j).max():.3g}"
              f"; cells (s; l) JAX jitted {np.asarray(rj.sel_s).tolist()}; "
              f"{np.asarray(rj.sel_l).tolist()} cost {float(rj.min_cost):.6g}"
              f", JAX op by op {np.asarray(ro.sel_s).tolist()}; "
              f"{np.asarray(ro.sel_l).tolist()} cost {float(ro.min_cost):.6g}"
              f", port {rt.sel_s[0].tolist()}; {rt.sel_l[0].tolist()} cost "
              f"{float(rt.min_cost[0]):.6g}", flush=True)


if __name__ == "__main__":
    main()
