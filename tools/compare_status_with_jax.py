"""Solver status shares of the MPC loop and of the tracker-guess replan:
the PyTorch port against the JAX package, on the CPU in float32.

bench.py's MPC set-up cut to ``--lanes`` lanes: scenarios 0..B-1, start
(0, 0, 0, 10), the analytic RoadSpec, PlannerConfig(), backend "blast". Each
side plans with its own plan_batch, then runs ``--cycles`` cycles of its own
mpc_step_batch from its own carry (the rollout chip_smoke.py times on the
card), then plan_batch with init_guess="tracker". Prints, per cycle, each
side's status counts and mean iterations and the number of lanes whose
status differs, and one JSON line with all of it.

    JAX_PLATFORMS=cpu python tools/compare_status_with_jax.py --lanes 64

Run from the root of the repo. Both sides run their plain CPU paths; the
kernels on the card agree with the port's plain versions (chip_smoke.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cilqr_tpu import mpc as JM  # noqa: E402
from cilqr_tpu import pipeline as JP  # noqa: E402
from cilqr_tpu import scenario as JS  # noqa: E402
from cilqr_tpu.config import PlannerConfig as JPlannerConfig  # noqa: E402
from cilqr_tpu_torch import mpc as TM  # noqa: E402
from cilqr_tpu_torch import pipeline as TP  # noqa: E402
from cilqr_tpu_torch import scenario as TS  # noqa: E402
from cilqr_tpu_torch.config import PlannerConfig  # noqa: E402
from cilqr_tpu_torch.types import SolverStatus  # noqa: E402

START = (0.0, 0.0, 0.0, 10.0)


def counts(status) -> dict:
    n = np.bincount(np.asarray(status).reshape(-1).astype(np.int64),
                    minlength=len(SolverStatus))
    return {SolverStatus(k).name: int(v) for k, v in enumerate(n) if v}


def side_stats(status, iters) -> dict:
    return {"status": counts(status),
            "iters_mean": float(np.asarray(iters, np.float64).mean())}


def tracker_cfg(cfg):
    return dataclasses.replace(cfg, ilqr=dataclasses.replace(
        cfg.ilqr, init_guess="tracker"))


def run_port(B, cycles):
    cfg = PlannerConfig()
    cl = TS.make_centerline()
    barriers = TS.build_road_barriers(cl)
    lane = TP.make_lane_tuple(barriers[1], barriers[2], cfg, np.float32)
    spec = TS.analytic_road_spec(dtype=np.float32)
    scns = TS.make_scenario_batch(range(B), dtype=torch.float32,
                                  device="cpu")
    starts = torch.tensor(START, dtype=torch.float32).repeat(B, 1)
    out = TP.plan_batch(scns, starts, cfg, None, lane, spec=spec)
    res = {"plan": (out.solve.status.numpy(), out.solve.iters.numpy())}
    carry = TM.MpcCarry(xs=out.solve.xs, us=out.solve.us,
                        cycle_time=torch.zeros(B),
                        no_repair=torch.zeros(B, dtype=torch.bool))
    for c in range(cycles):
        carry, o = TM.mpc_step_batch(scns, carry, cfg, lane, spec=spec)
        res[f"cycle {c + 1}"] = (o.solve.status.numpy(),
                                 o.solve.iters.numpy())
    out = TP.plan_batch(scns, starts, tracker_cfg(cfg), None, lane,
                        spec=spec)
    res["tracker plan"] = (out.solve.status.numpy(), out.solve.iters.numpy())
    return res


def run_jax(B, cycles):
    cfg = JPlannerConfig()
    cl = JS.make_centerline()
    barriers = JS.build_road_barriers(cl)
    lane = JP.make_lane_tuple(barriers[1], barriers[2], cfg, np.float32)
    spec = JS.analytic_road_spec(dtype=np.float32)
    scns = JS.make_scenario_batch(range(B), dtype=jnp.float32)
    starts = jnp.tile(jnp.asarray(START, jnp.float32), (B, 1))

    def plan(c):
        return jax.jit(lambda s, st: JP.plan_batch(s, st, c, None, lane,
                                                   spec=spec))(scns, starts)

    out = plan(cfg)
    res = {"plan": (out.solve.status, out.solve.iters)}
    step = jax.jit(lambda c: JM.mpc_step_batch(scns, c, cfg, lane,
                                               spec=spec))
    carry = JM.MpcCarry(xs=out.solve.xs, us=out.solve.us,
                        cycle_time=jnp.zeros(B, jnp.float32),
                        no_repair=jnp.zeros(B, bool))
    for c in range(cycles):
        carry, o = step(carry)
        res[f"cycle {c + 1}"] = (o.solve.status, o.solve.iters)
    out = plan(tracker_cfg(cfg))
    res["tracker plan"] = (out.solve.status, out.solve.iters)
    return {k: tuple(np.asarray(a) for a in v) for k, v in res.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--cycles", type=int, default=8)
    args = ap.parse_args()
    torch.set_num_threads(min(8, torch.get_num_threads()))
    t0 = time.perf_counter()
    port = run_port(args.lanes, args.cycles)
    t1 = time.perf_counter()
    ref = run_jax(args.lanes, args.cycles)
    t2 = time.perf_counter()
    rows = {}
    for k in port:
        (ps, pi), (js, ji) = port[k], ref[k]
        rows[k] = {"port": side_stats(ps, pi), "jax": side_stats(js, ji),
                   "status_differs": int((ps != js).sum())}
        print(f"{k}: port {rows[k]['port']}; jax {rows[k]['jax']}; "
              f"lanes whose status differs {rows[k]['status_differs']}",
              flush=True)
    print(json.dumps({"lanes": args.lanes, "cycles": args.cycles,
                      "dtype": "float32", "port_s": round(t1 - t0, 1),
                      "jax_s": round(t2 - t1, 1), "rows": rows}))


if __name__ == "__main__":
    main()
