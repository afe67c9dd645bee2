"""Results that several of the port's test modules use, computed once per
test run and shared by every pytest-xdist worker.

Under ``--dist load`` the tests of one module land on several workers, and
each worker builds the module's fixtures again; the port's replan on
SEEDS feeds three modules. ``shared`` computes a value once per run
(pytest-xdist's documented pattern: a file in the workers' common
temporary directory, written under a file lock) and every other caller
loads it from there; the value is deterministic, so a loaded copy equals
a computed one. Each caller gets its own copy.
"""

import dataclasses

import filelock
import numpy as np
import torch

SEEDS = (0, 1, 2, 156)
START = (0.0, 0.0, 0.0, 10.0)


def shared(request, tmp_path_factory, name, fn):
    """fn(), once per test run: computed by the first caller, loaded by the
    rest (torch.save / torch.load). Without xdist workers, computed."""
    if not hasattr(request.config, "workerinput"):
        return fn()
    path = tmp_path_factory.getbasetemp().parent / f"{name}.pt"
    with filelock.FileLock(str(path) + ".lock"):
        if path.is_file():
            return torch.load(path, weights_only=False)
        value = fn()
        torch.save(value, path)
        return value


def replan_config():
    """tests/test_torch_replan.py's configuration: the solves without the
    compaction cascade, the repair ladder's first round only."""
    from cilqr_tpu_torch.config import PlannerConfig

    cfg = PlannerConfig()
    return dataclasses.replace(
        cfg, ilqr=dataclasses.replace(cfg.ilqr, compaction_phase1=0),
        repair=dataclasses.replace(cfg.repair,
                                   margins=cfg.repair.margins[:1]))


def replan(request, tmp_path_factory):
    """The port's plan_batch on SEEDS in float64 on the CPU from START,
    with the road's lane constraints and RoadSpec, in replan_config()."""
    def run():
        from cilqr_tpu_torch import pipeline, scenario

        scn = scenario.make_scenario_batch(SEEDS, dtype=torch.float64,
                                           device="cpu")
        cfg = replan_config()
        lane = pipeline.make_lane_tuple(scn.left_barrier_xy[0],
                                        scn.right_barrier_xy[0], cfg)
        starts = torch.tensor(START, dtype=torch.float64).repeat(
            len(SEEDS), 1)
        return pipeline.plan_batch(
            scn, starts, cfg, None, lane,
            spec=scenario.analytic_road_spec(dtype=np.float64))

    return shared(request, tmp_path_factory, "replan_seeds", run)
