"""Multi-card execution: process groups, sharded batches and the sharded
solve, replan and MPC steps (PyTorch counterpart of cilqr_tpu/dist.py).

The JAX package runs one process over a ``Mesh`` of its devices and
``shard_map``s each step, ``psum``-ing the statistics. PyTorch's idiom is
one process per card: a ``torch.distributed`` process group of ranks, each
solving its own rows through the port's local functions (``solve_batch``,
``plan_batch``, ``mpc_scan_batch``, and so through the CUDA kernels), and
one ``all_reduce`` of the statistics. The sums are the same; solves stay
embarrassingly parallel and the statistics are the only traffic.

NCCL is the backend when the batch lives on cards, one card a rank. gloo
serves ranks that were asked for the CPU (the tests), and ranks that share
one card (NCCL refuses two ranks on one GPU); under gloo the statistics
are reduced on the CPU.

Multi-host: call ``init_distributed`` once per process with the
coordinator's address, the number of processes and this process's rank,
then ``make_batch_mesh``; each process passes its own rows through
``global_batch``.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import numpy as np
import torch
import torch.distributed as tdist

from .batch import device_metrics, solve_batch
from .config import PlannerConfig
from .mpc import mpc_scan_batch
from .pipeline import NEAR_TERM_KNOTS, plan_batch
from .types import SolverStatus

# How long a rank waits at a collective for the others. The first
# collective of a step waits for the slowest rank's whole solve (a cold
# repair round at B=1024 takes seconds on a card and minutes on a CPU),
# and the rendezvous for every rank's start-up.
TIMEOUT = datetime.timedelta(minutes=10)


def _init_method(coordinator: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``,
    ``file://``) is taken as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def rank_card(rank: int) -> torch.device:
    """The card of a rank under NCCL, one card a rank: ``cuda:<local
    rank>``, the local rank being ``LOCAL_RANK`` where a launcher set it
    (one process per card on each host) and the rank otherwise. Raises
    when the host has no such card: NCCL never shares a card and never
    falls back to the CPU."""
    local = int(os.environ.get("LOCAL_RANK", rank))
    n = torch.cuda.device_count()
    if local >= n:
        raise RuntimeError(
            f"NCCL takes one card a rank: rank {rank} (local rank {local}) "
            f"has no card, the host has {n}; run fewer ranks, or gloo "
            f"ranks (backend='gloo') on the CPU")
    return torch.device("cuda", local)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None):
    """torch.distributed.init_process_group for this process as rank
    ``process_id`` of ``num_processes`` (no-op for one process, as the
    JAX package's jax.distributed.initialize wrapper). ``coordinator``:
    ``host:port`` of rank 0's store (or an ``init_method`` URL such as
    ``file://...``). backend None = "nccl": the batch lives on cards, and
    this process takes its card (rank_card) before joining; "gloo" when
    the caller asks for the CPU (or for ranks sharing one card)."""
    if num_processes is None or num_processes <= 1:
        return
    backend = backend or "nccl"
    device_id = None
    if backend == "nccl":
        device_id = rank_card(process_id)
        torch.cuda.set_device(device_id)
    tdist.init_process_group(backend, init_method=_init_method(coordinator),
                             world_size=num_processes, rank=process_id,
                             timeout=TIMEOUT, device_id=device_id)


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """The 1-D ``batch`` mesh of this process: its process group (None
    without one: a single rank whose reduce is the identity), its rank and
    the group's size, and the device that holds its rows. A dataclass, not
    ``torch.distributed.device_mesh.DeviceMesh``: a DeviceMesh creates a
    default process group where there is none and ties a device type to
    the backend, while a rank here may hold its rows on a card and reduce
    on the CPU (gloo)."""

    group: object
    rank: int
    size: int
    device: torch.device


def make_batch_mesh(device=None) -> BatchMesh:
    """The mesh over every rank of the initialised process group, or over
    this process alone when none is. ``device``: where this rank's rows
    live; None = its card (under NCCL ``cuda:<local rank>``, otherwise the
    current card). The caller asks for the CPU with ``device="cpu"``;
    NCCL reduces only on cards, so it raises there."""
    if not tdist.is_initialized():
        return BatchMesh(None, 0, 1, torch.device(device or "cuda"))
    group = tdist.group.WORLD
    rank, size = tdist.get_rank(), tdist.get_world_size()
    if tdist.get_backend() == "nccl":
        card = rank_card(rank)
        if device is not None and torch.device(device) != card:
            raise ValueError(f"NCCL rank {rank} holds its rows on {card}, "
                             f"not {device}")
        return BatchMesh(group, rank, size, card)
    return BatchMesh(group, rank, size, torch.device(device or "cuda"))


def _tree_map(fn, tree):
    """fn over the tensors (or numpy arrays) of a tree of the port's
    dataclasses, NamedTuples, tuples and lists; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(tree))
    if hasattr(tree, "map"):                  # _Fields, ConstraintSet
        return tree.map(lambda a: _tree_map(fn, a))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    raise TypeError(f"not a tensor tree: {type(tree).__name__}")


def _rows(tree) -> int:
    """The common leading dimension of a tree's tensors."""
    rows = set()
    _tree_map(lambda a: rows.add(a.shape[0]), tree)
    if len(rows) != 1:
        raise ValueError(f"the tree's tensors have unequal row counts "
                         f"{sorted(rows)}")
    return rows.pop()


def shard_batch(mesh: BatchMesh, tree):
    """This rank's rows of a whole host batch (axis 0 split evenly over the
    mesh, rank r taking the r-th block), on the rank's device. Raises
    ValueError when a batch does not divide by the mesh size."""
    def rows(a):
        if a.shape[0] % mesh.size:
            raise ValueError(f"a batch of {a.shape[0]} rows does not divide "
                             f"over {mesh.size} ranks")
        n = a.shape[0] // mesh.size
        return a[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)

    return _tree_map(rows, tree)


def global_batch(mesh: BatchMesh, tree):
    """This process's own rows of the global batch (the multi-process path),
    on the rank's device. Every rank must pass the same number of rows (a
    global batch sharded evenly, as the JAX package's NamedSharding
    requires): one all_gather of the count, and ValueError on every rank
    when they differ."""
    n = _rows(tree)
    if mesh.group is not None:
        on = mesh.device if tdist.get_backend() == "nccl" else "cpu"
        mine = torch.tensor([n], dtype=torch.int64, device=on)
        counts = [torch.empty_like(mine) for _ in range(mesh.size)]
        tdist.all_gather(counts, mine, group=mesh.group)
        counts = [int(c) for c in counts]
        if len(set(counts)) != 1:
            raise ValueError(f"ranks pass unequal row counts {counts}: a "
                             f"global batch is sharded evenly")
    return _tree_map(lambda a: a.to(mesh.device), tree)


def _all_reduce(mesh: BatchMesh, stats: dict) -> dict:
    """The psum of the JAX package: the statistics stacked in their key
    order (the same on every rank: one code builds the dict) into one f32
    tensor, one all_reduce(SUM) over the mesh, under gloo on the CPU."""
    if mesh.group is None:
        return stats
    keys = list(stats)
    flat = torch.stack([stats[k] for k in keys])
    if tdist.get_backend() != "nccl":
        flat = flat.cpu()
    tdist.all_reduce(flat, op=tdist.ReduceOp.SUM, group=mesh.group)
    return dict(zip(keys, flat.unbind()))


def sharded_solve_step(cfg: PlannerConfig, mesh: BatchMesh,
                       backend: str = "blast"):
    """The sharded batched-solve step: each rank solves its rows
    (batch.solve_batch) and the convergence statistics are summed over the
    mesh.

    Returns fn(goals [b, N, 6], starts [b, 6], cons [b, ...]), the rank's
    rows (shard_batch / global_batch), -> (the rank's SolveResult, global
    stats: n, converged, iters_sum, cost_sum as f32 scalars)."""
    ilqr, veh, dt = cfg.ilqr, cfg.vehicle, cfg.delta_t

    def step(goals, starts, cons):
        res = solve_batch(goals, starts, cons, ilqr, veh, dt,
                          backend=backend)
        return res, _all_reduce(mesh, device_metrics(res))

    return step


def pipeline_stats(out) -> dict:
    """The statistics of a replan's PlanOutput, f32 scalar sums on its
    device: device_metrics' four, dp_ok, ok, and the executed horizon's
    near_hit_lanes (before the repair), repaired_lanes and
    still_dirty_lanes."""
    f32 = torch.float32
    stats = device_metrics(out.solve)
    stats["dp_ok"] = out.dp_ok.sum().to(f32)
    stats["ok"] = out.ok.sum().to(f32)
    stats["near_hit_lanes"] = (
        out.pre_hits[..., :NEAR_TERM_KNOTS].any(-1).sum().to(f32))
    stats["repaired_lanes"] = out.repaired.sum().to(f32)
    stats["still_dirty_lanes"] = out.still_dirty.sum().to(f32)
    return stats


def sharded_pipeline_step(cfg: PlannerConfig, mesh: BatchMesh, grid, lane,
                          backend: str = "blast", road_spec=None):
    """The full replan, sharded: each rank runs pipeline.plan_batch (DP,
    corridors, the batched solve, re-check and repair) on its scenarios;
    grid and lane are the road's, the same on every rank.

    Returns fn(scns [b, ...], starts [b, 4]) -> (the rank's PlanOutput,
    global stats: pipeline_stats summed over the mesh)."""
    def step(scns, starts):
        out = plan_batch(scns, starts, cfg, grid, lane, backend=backend,
                         spec=road_spec)
        return out, _all_reduce(mesh, pipeline_stats(out))

    return step


def mpc_stats(st) -> dict:
    """The statistics of an MPC rollout's MpcScanStats ([C, B] fields), f32
    scalar sums on its device: cycles, converged_cycles,
    lambda_fail_cycles (warm cycles at their optimum that reject every
    alpha until lambda overflows, the reference's kUnsolved exit),
    iters_sum, corridor_ok_cycles, lane_clipped and the near_hit (before
    the repair), repaired and still_dirty cycles."""
    f32 = torch.float32
    succ = ((st.status == SolverStatus.SUCCESS_GNORM)
            | (st.status == SolverStatus.SUCCESS_ABS_COST)
            | (st.status == SolverStatus.SUCCESS_REL_COST))
    return {
        "cycles": torch.tensor(float(st.status.numel()), dtype=f32,
                               device=st.status.device),
        "converged_cycles": succ.sum().to(f32),
        "lambda_fail_cycles": (
            st.status == SolverStatus.FAIL_LAMBDA_MAX).sum().to(f32),
        "iters_sum": st.iters.sum().to(f32),
        "corridor_ok_cycles": st.corridor_ok.sum().to(f32),
        "lane_clipped": st.lane_clipped.sum().to(f32),
        "near_hit_cycles": st.pre_near_hits.sum().to(f32),
        "repaired_cycles": st.repaired.sum().to(f32),
        "still_dirty_cycles": st.still_dirty.sum().to(f32),
    }


def sharded_mpc_step(cfg: PlannerConfig, mesh: BatchMesh, lane,
                     n_cycles: int, backend: str = "blast", road_spec=None):
    """The deployment loop, sharded: each rank runs ``n_cycles`` of
    mpc.mpc_scan_batch (corridors rebuilt at the shifted times, the warm
    solve, the re-check and the repair) on its scenarios and carries; the
    per-(cycle, lane) statistics are summed over the mesh.

    Returns fn(scns [b, ...], carry mpc.MpcCarry [b, ...]) -> (the rank's
    final carry, global stats: mpc_stats summed over the mesh)."""
    def step(scns, carry):
        final, st = mpc_scan_batch(scns, carry, cfg, lane, n_cycles,
                                   backend=backend, spec=road_spec)
        return final, _all_reduce(mesh, mpc_stats(st))

    return step


def launch_local(fn, nprocs: int, args=(), timeout: float = 1800.0):
    """Run fn(rank, *args) in ``nprocs`` processes of this host, started
    with the ``spawn`` method (a process that has touched CUDA cannot be
    forked), and wait at most ``timeout`` seconds for all of them. A rank
    that fails stops the others and raises here
    (torch.multiprocessing's ProcessRaisedException); one still running
    at the deadline is killed, with the rest, and TimeoutError raised."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
