"""Typed configuration tree of the planner: a copy of cilqr_tpu/config.py.

Importing ``cilqr_tpu.config`` imports JAX (through cilqr_tpu/__init__.py),
which the port never does, so the port keeps its own copy. Everything
after this docstring is byte for byte the JAX package's file
(tests/test_torch_config.py holds the two equal); its comments on the TPU,
XLA and Pallas describe the settings of the JAX package, whose names and
values the port keeps.

The reference planner keeps these knobs as compile-time C++ structs
(planner_config.h, vehicle_param.h). Here they are frozen dataclasses,
overridable from YAML/CLI (see ``from_dict``). Default *values* replicate
the reference exactly for parity (including the fields the reference
declares but never reads, which are documented and dropped rather than
carried along).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class VehicleParam:
    """Vehicle geometry and actuator limits.

    Reference: vehicle_param.h:26-74 (limits), :80-85 (derived disc geometry).
    """

    front_hang_length: float = 0.96
    wheel_base: float = 1.0
    rear_hang_length: float = 0.929
    width: float = 1.942

    max_velocity: float = 20.0
    min_acceleration: float = -5.0
    max_acceleration: float = 5.0
    jerk_min: float = -10.0
    jerk_max: float = 10.0
    delta_min: float = -40.0 / 180.0 * math.pi
    delta_max: float = 40.0 / 180.0 * math.pi
    delta_rate_min: float = (-40.0 / 180.0 * math.pi) / 3.0
    delta_rate_max: float = (40.0 / 180.0 * math.pi) / 3.0

    @property
    def length(self) -> float:
        return self.wheel_base + self.rear_hang_length + self.front_hang_length

    @property
    def radius(self) -> float:
        """Two-disc cover radius (vehicle_param.h:82)."""
        return math.hypot(0.25 * self.length, 0.5 * self.width)

    @property
    def r2x(self) -> float:
        return 0.25 * self.length - self.rear_hang_length

    @property
    def f2x(self) -> float:
        return 0.75 * self.length - self.rear_hang_length

    def disc_radius(self, num_of_disc: int) -> float:
        """N-disc cover radius used by the CILQR barriers
        (ilqr_optimizer.cc:97-104)."""
        return math.hypot(self.width / 2.0, self.length / 2.0 / num_of_disc)


@dataclasses.dataclass(frozen=True)
class Weights:
    """Tracking/comfort quadratic weights (planner_config.h:45-55)."""

    jerk: float = 1.0
    delta_rate: float = 1.0
    x_target: float = 0.5
    y_target: float = 0.5
    theta: float = 1e-3
    v: float = 0.0
    a: float = 0.0
    delta: float = 0.0


@dataclasses.dataclass(frozen=True)
class BarrierConfig:
    """Constraint-barrier selection and parameters.

    kind: 'relax' (default — RelaxBarrierFunction, the one the reference
    actually uses, ilqr_optimizer.h:187-188), 'exponential' or 'quadratic'
    (barrier_function.h:37-79 / :149-189 — the reference's commented-out
    switch at ilqr_optimizer.h:181-186, here a config axis; see
    barriers.make_barrier). Non-relax kinds are supported by the XLA cost
    stacks only: the Pallas cost-stack/megasolve kernels hardcode relax
    semantics and are gated off automatically.

    The reference's RelaxBarrierFunction hardcodes t=5.0, eps=0.01
    (barrier_function.h:143-145); the config-level t/t_rate fields are
    declared but unused (planner_config.h:60-61), so they are not carried.
    """

    kind: str = "relax"
    t: float = 5.0
    epsilon: float = 0.01
    # ExponentialBarrier q1*exp(q2*x) defaults (barrier_function.h:143's
    # neighbors declare none; these match the constructor defaults used in
    # the commented-out switch, barrier_function.h:41-44)
    exp_q1: float = 0.5
    exp_q2: float = 2.5
    # QuadraticBarrier penalty weight (barrier_function.h:152)
    quad_param: float = 1000.0


@dataclasses.dataclass(frozen=True)
class LineSearchConfig:
    """Fixed 11-point alpha schedule + acceptance window
    (ilqr_optimizer.cc:188-197)."""

    alphas: Tuple[float, ...] = (
        1.0000, 0.5012, 0.2512, 0.1259, 0.0631,
        0.0316, 0.0158, 0.0079, 0.0040, 0.0020, 0.0010,
    )
    beta_min: float = 1e-4
    beta_max: float = 10.0
    # 'parallel': evaluate all alphas per outer iteration (vmap fan-out) and
    # pick the first acceptable — simple, but rolls out 11 trajectories when
    # the reference's sequential search usually accepts the first.
    # 'serial': one alpha per while_loop trip with a carried alpha index —
    # exact reference early-exit semantics at ~1/4 of the per-iteration
    # flops when the first alpha accepts (docs/PERF.md lever 2).
    mode: str = "serial"
    # Alphas evaluated per while-loop trip in the batch-last serial search
    # (solver_blast._make_body). Every trip pays a relinearization
    # (jacobians + derivative cost stack + backward sweep) computed from
    # the trip's FROZEN iterate (xs, us, lam); a rejected alpha burns all
    # of it to learn one accept bit, and the lockstep batch walks at its
    # most rejection-heavy lane's trip count (profiled round 4: ~32
    # full-width trips to conclude 3 iterations at B=1024). K > 1 rolls
    # out K consecutive alphas from the SAME backward pass (one extra
    # forward rollout + candidate cost stack each) and applies the serial
    # accept rule to them in order — decision-identical to K=1 because
    # every candidate is a deterministic function of the frozen iterate:
    # candidate i computed this trip equals the value trip i would have
    # computed (pinned on the fixture in tests/test_solver_blast.py).
    # Swept on the TPU B=1024 fixture (solves/s, trip cap 24):
    # {1: 9,292, 2: 11,202, 3: 12,493, 4: 13,428, 5: 11,687} — the win
    # grows until the K extra candidate evaluations outweigh the saved
    # relinearizations (K=5 also spills the sweep kernel's per-candidate
    # VMEM rollout buffers); 4 is the measured optimum (docs/PERF.md
    # round 4).
    alphas_per_trip: int = 4


@dataclasses.dataclass(frozen=True)
class RegularizationConfig:
    """Levenberg lambda schedule (ilqr_optimizer.cc:188-193)."""

    ratio: float = 1.6
    lambda_min: float = 1e-8
    lambda_max: float = 1e11
    gradient_norm_min: float = 1e-6
    lambda_init: float = 1.0


@dataclasses.dataclass(frozen=True)
class IlqrConfig:
    """CILQR solver knobs (planner_config.h:57-73 + hardcoded schedule at
    ilqr_optimizer.cc:188-197)."""

    num_of_disc: int = 5
    safe_margin: float = 0.2
    # Extra inward shrink added to BOTH corridor and lane planes on top
    # of the reference's shrink radii (costs.shrink_and_normalize). The
    # reference shrinks lanes by the 5-disc cover radius (1.013 m) and
    # corridors by that + 0.2 (ilqr_optimizer.cc:438-473) — but its own
    # output-collision model (Environment::CheckOptimizationCollision,
    # environment.cpp:92-112) is the TWO-disc cover with radius 1.210 m,
    # whose probe centers sit up to 0.145 m from the nearest 5-disc
    # center: satisfying the reference's shrunk planes guarantees only
    # 1.013 - 0.145 = 0.868 m of boundary clearance where the 2-disc
    # model needs 1.210 — an up-to-0.34 m unsafety the reference never
    # notices because it never re-checks its output. 0.35 covers the
    # deficit in the BASE solve (measured round 5: pre-repair dirty
    # lanes 72/2048 -> a handful, at no solve cost); 0.0 restores the
    # reference's exact shrink semantics (the native-oracle parity tests
    # pin that configuration).
    cover_margin: float = 0.35
    weights: Weights = Weights()
    max_iter_num: int = 200
    abs_cost_tol: float = 1e-2
    rel_cost_tol: float = 1e-2
    barrier: BarrierConfig = BarrierConfig()
    line_search: LineSearchConfig = LineSearchConfig()
    reg: RegularizationConfig = RegularizationConfig()
    # 'analytic' replicates the reference's hand-derived midpoint Jacobians
    # (vehicle_model.cc:44-86, including its v-vs-v_mid quirk); 'autodiff'
    # uses jax.jacfwd of the RK2 step (exact).
    jacobian_mode: str = "analytic"
    # Initial-guess path. The reference switches between the backward-LQR
    # 'iqr' (default, ilqr_optimizer.cc:168-169,793-842) and the Tracker
    # simulation 'tracker' (InitGuess, :107-139) by EDITING THE SOURCE;
    # here it is config. The pipeline reads this (pipeline.plan/plan_batch)
    # and feeds the tracker rollout to the solver as its warm start; the
    # tracker needs the full coarse trajectory (time/s fields), which the
    # bare solve() entry points don't carry.
    init_guess: str = "iqr"
    # lax.scan unroll factor for the backward/forward horizon sweeps. On
    # TPU each XLA loop iteration costs ~tens of us of carry round-trip
    # overhead — 160 sequential steps per solver trip dominate the solve
    # wall time unless unrolled (docs/PERF.md). 0 = auto: full unroll on
    # TPU, no unroll on CPU (where loop overhead is negligible and the
    # unrolled compile is 5x slower).
    scan_unroll: int = 0
    # Per-knot lane-segment window width (batch-last solver only). The
    # reference scans every lane segment per disc per knot
    # (FindNeastLaneSegment, ilqr_optimizer.cc:605-618) — O(N*D*S) distance
    # evaluations per solver trip, the single largest op in the cost stack
    # (docs/PERF.md). A window of W segments centered on the segment
    # nearest each knot's GOAL position is selection-identical as long as
    # the runtime euclidean-nearest segment stays inside the window.
    # Caveat: on tightly curved roads (arc radius comparable to the
    # vehicle's lateral freedom) the euclidean argmin can jump across the
    # curve to a segment far away in index space; a 40 m guaranteed margin
    # (exact W=16) flips one fixture lane's selection, 55+ m margins
    # (exact W=24, quantized W=32) match the full scan on every fixture
    # problem. Window starts are quantized to W/4-strided variants so the
    # construction is gather-free (see solver_blast.cons_to_bl); the
    # guaranteed margin is (W/2 - W/8) segments. 0 = full scan. Windows
    # apply only when W < S.
    lane_window: int = 32
    # Lane-search reduction strategy (solver_blast._nearest_lane_sel_discs):
    # 'reduce' = ONE variadic lax.reduce carrying (distance, index, a, b, c)
    # with a lexicographic (d, idx) key — a true total order, so the result
    # is bitwise-identical to argmin-with-first-index-ties regardless of
    # reduction order, and the distance producer is fused into a single
    # pass; 'onehot' = jnp.argmin + 3 one-hot select sums (4 reductions,
    # each re-fusing the distance producer — measured ~4 iota_reduce
    # kernels x ~33 us per solver trip at B=512, docs/PERF.md round-3
    # kernel profile).
    lane_search: str = "reduce"
    # Converged-lane compaction (solver_blast.solve_batch_compact): the
    # batch otherwise runs in lockstep until its slowest lane concludes,
    # burning full-width trips on a dwindling minority. Phase 1 runs the
    # whole batch to `compaction_phase1` iterations; still-running lanes
    # are then gathered (complete solver carry) into a batch of
    # B/compaction_factor and run to conclusion. No batch-axis reduction
    # exists in the loop body, so per-lane decisions are independent of
    # batch position; controls match the single-phase solve to XLA's
    # width-dependent fusion reassociation (~1e-14 in f64). 0 disables.
    # Swept on the fixture: {2: 3585, 3: 4371, 5: 3956, 8: 3657, 12: 3390,
    # off: 2646} solves/s — shallow phase 1 + repeated compact rounds
    # approximates recursive halving (each round retires a full compact
    # batch of stragglers at half-width trip cost).
    compaction_phase1: int = 3
    compaction_factor: int = 2
    # Trip cap on phase 1 (solver_blast._run_carry): bounds the number of
    # full-width LINE-SEARCH steps before compaction, not just concluded
    # iterations. Profiled round 4 at B=1024: the iteration-only cap let
    # the most rejection-heavy lane hold the whole batch at full width
    # for ~32 trips to conclude 3 iterations; a trip cap hands those
    # stragglers to the half-width cascade. Scheduling-only: lanes resume
    # mid-line-search (aidx carry), per-lane decisions unchanged
    # (tests/test_solver_blast.py pins it). 0 disables. Swept on the TPU
    # fixture at B=1024 (solves/s): {0: 7290, 8: 6843, 12: 6777,
    # 16: 7497, 20: 7536, 24: 7903/7784/7851 (3 runs), 28: 7579,
    # 32: 7306, 48: 7325, 64: 7308} — small caps pay more in extra
    # cascade rounds than they save, the 24-trip cap retires ~all of the
    # batch's accepted work first and hands only the true stragglers down.
    # With the paired line search (alphas_per_trip=4) the cap is nearly
    # flat — {16: 13,430, 24: 13,428, 32: 13,458, 48: 13,411, 64:
    # 13,391} — each trip now covers 4 line-search steps, so far fewer
    # lanes are mid-iteration at any cap boundary; 24 kept.
    compaction_phase1_trips: int = 24
    # Corridor+lane cost-stack implementation (solver_blast._cost_stack_bl):
    # 'pallas' = fused VMEM kernel (pallas/coststack.py) computing
    # distances, nearest-segment selection, barriers, Jacobian rows and
    # (x, y, theta) Hessian entries in one pass per (knot, 128-lane
    # block); 'xla' = the jnp formulation; 'auto' = pallas on TPU when
    # eligible (f32, windowed lanes, B a multiple of 128), else xla.
    # Like the sweep kernel, bitwise-equal to XLA only up to fusion
    # rounding — decision parity is pinned by the fixture gates.
    # Hardware qualification (round 4, B=256 fixture + B=1024 pipeline):
    # 100% convergence, near-term-dirty 72/2048 vs XLA's 71, f64-evaluated
    # quality median |rel| 4e-5 with the documented two-sided chaotic
    # tails (19 lanes >5% worse / 12 better vs the XLA path — the same
    # jitter magnitude batch width alone induces); solve stage 7,851 ->
    # 9,302 solves/s, pipeline 2,544 -> 2,733 replans/s.
    cost_stack_backend: str = "auto"
    # Riccati backward+forward sweep implementation (solver_blast):
    # 'pallas' = fused VMEM-resident kernel (pallas/sweep.py) — the
    # sequential 160-step chain runs at on-chip latency instead of XLA's
    # ~9 us/step HBM carry round-trip; 'xla' = lax.scan sweeps; 'auto' =
    # pallas on TPU when the batch is a multiple of its 128-lane block,
    # else xla.
    sweep_backend: str = "auto"
    # Backward-pass formulation (single-problem solver paths):
    # 'scan' = sequential lax.scan, the reference's exact recursion;
    # 'pscan' = horizon-parallel associative scan (pscan.py, arXiv
    # 1809.06360 / 2104.03186) — O(log T) sequential depth for LONG
    # horizons, with the Woodbury regularization placement (identical
    # gains at λ=0; see pscan.py docstring).
    backward_backend: str = "scan"


@dataclasses.dataclass(frozen=True)
class CorridorConfig:
    """Safe-corridor construction (planner_config.h:75-86)."""

    is_multiple_sample: bool = False
    max_diff_x: float = 25.0
    max_diff_y: float = 25.0
    radius: float = 150.0
    max_axis_x: float = 10.0
    max_axis_y: float = 10.0
    lane_segment_length: float = 5.0
    # Device-side static padding sizes (new; the reference uses dynamic
    # std::vector sizes which cannot exist under XLA).
    max_points: int = 96       # seed points per knot fed to the flip+hull
    max_constraints: int = 24  # half-planes kept per knot
    max_lane_segments: int = 64
    # Width of the compacted hull-1 vertex set fed to hull 2 and the dual
    # hull. convex_hull_masked packs hull vertices into the leading slots,
    # so truncating to hull_max is exact whenever hull 1 has <= hull_max
    # vertices (flagged via ok=False otherwise); it shrinks the two
    # downstream O(K^2) hulls and their per-lane gathers ~9x vs running
    # them at max_points width (measured the corridor stage's dominant
    # cost on TPU).
    hull_max: int = 32


@dataclasses.dataclass(frozen=True)
class DpConfig:
    """Coarse spatio-temporal DP (dp_planner.h:27-29, planner_config.h:100-134)."""

    nt: int = 5
    ns: int = 7
    nl: int = 10
    nominal_velocity: float = 10.0
    w_obstacle: float = 1000.0
    w_lateral: float = 0.1
    w_lateral_change: float = 0.5
    w_lateral_velocity_change: float = 1.0
    w_longitudinal_velocity_bias: float = 10.0
    w_longitudinal_velocity_change: float = 1.0
    # road-barrier membership mode for DP probes: 'frenet' (default —
    # zero-gather closed-form boundary test, ~4x faster DP on TPU since
    # per-probe gathers are latency-bound; with a RoadSpec it uses the
    # finite-extent per-segment test, conservative-complete on every road
    # family — ALWAYS pass dp.plan/pipeline.plan the spec when the road
    # recipe is known, because the spec-less station-field stand-in
    # under-reports on tight-arc roads, see world.barrier_hit_road_spec
    # and tests/test_dp_qualification.py), 'grid' (dilated occupancy
    # table, one gather/probe — conservative on the 0.1 m cell lattice),
    # or 'exact' (brute force over all barrier points; the parity
    # oracle's mode). The default matches the benched configuration.
    collision_mode: str = "frenet"
    grid_cell: float = 0.1
    # parents processed per lax.map step in the transition collision sweep
    # (memory vs parallelism). With the dynamic obstacles hoisted out of
    # the probes and station fields deduplicated, the full 70-parent
    # sweep fits HBM at bench batches and runs fastest (B=32 TPU: 507 ms
    # at 14, 425 ms at 70); lower it if large scenario batches OOM.
    parent_chunk: int = 70


@dataclasses.dataclass(frozen=True)
class RepairConfig:
    """Dirty-lane repair (pipeline._repair_batch / mpc repair): when the
    executed-horizon collision re-check of an optimized plan fires
    (PlanOutput.solve_hits / MpcStepOut.near_hits — the safety lens the
    reference lacks entirely: planning_node.cc:82-112 animates its output
    unchecked), the flagged lanes are gathered, re-solved warm-started
    against constraints TIGHTENED by the escalating margins, re-checked,
    replace the originals only when the repaired plan's near-term horizon
    re-checks clean (and the repair solve converged). The measured dirt
    is shallow rel-cost-stop grazes of 0.007-0.3 m (docs/PERF.md
    "executed-horizon re-check at bench scale"), so a 0.35 m tightening
    strictly covers the characterized population."""

    enabled: bool = True
    # escalating per-round extra margins (metres of inward shrink applied
    # to corridor AND lane planes via costs.tighten_constraints — exact
    # geometric boundary shift, c -= margin * hypot(a, b)). Measured on
    # the characterized dirty population (seeds 145/156/163, docs/
    # PERF.md round 5): 0.35 covers the 2-disc-recheck-vs-5-disc-shrink
    # model deficit (~0.34 m worst case between disc centers) and clears
    # the shallow-graze majority warm-started; the stubborn lanes carry
    # soft-barrier residuals on top and need ~1.0 m, and the
    # basin-trapped ones (seed 163: corridor satisfied by 0.6 m yet
    # colliding — a wrong f32 basin) additionally need the COLD restart
    # of round 1, since a warm start from the bad iterate cannot escape
    # a local method's basin. Swept on the TPU B=1024 pipeline (54
    # pre-dirty/2048; docs/PERF.md round-5 repair frontier): the warm
    # round at the FULL 1.0 margin clears strictly more lanes than at
    # 0.35 for the same (cheap) cost, and the margin ladder's 1.5 round
    # and the brake round clear only subsets of what cold-1.0 clears —
    # (1.0, 1.0) is the measured Pareto ladder.
    margins: Tuple[float, ...] = (1.0, 1.0)
    # rounds >= this index re-solve from the LQR init (iqr_init) instead
    # of warm-starting at the dirty iterate — the basin escape
    cold_restart_from: int = 1
    # abs/rel cost stop tolerance for the COLD rounds: the tightened
    # problem's total cost is barrier-dominated, so the production
    # rel_cost_tol=1e-2 stops while the iterate is still mid-descent
    # (measured: seed 240's repair concluded in 1-8 iterations at every
    # margin and stayed dirty; at 1e-4 it runs ~80 iterations and
    # clears). Warm round 0 keeps the production tolerances — its job is
    # the cheap shallow-graze majority.
    cold_tol: float = 1e-4
    # iteration cap for the cold round: at the tight tolerance the stop
    # can fire very late or never, and the repair sub-batch walks in
    # lockstep at a ~1 ms/trip width-floor (docs/PERF.md round 5), so
    # the cap IS the round's cost. The measured resistant-but-repairable
    # lanes converge in 82-123 iterations; 100 covers the characterized
    # CPU population (zero residual over seeds 0..255, gate G) and buys
    # 36/54 repaired on the TPU B=1024 population at -30% headline
    # (cap 150: 39/54 at -47%; cap 60: 32/54 at -24%).
    cold_max_iter: int = 100
    # final BRAKE round (after the margin rounds, only if lanes remain
    # dirty): re-time the goal profile to brake_factor of its speed
    # along the SAME path (pipeline.brake_goals) and re-solve cold at
    # margins[0]. The measured resistant class cuts road-boundary
    # corners at speed — the reference's one-nearest-segment lane model
    # cannot represent a boundary corner, so no plane margin separates
    # the collision (docs/PERF.md round 5) — while a slower profile
    # takes the corner inside the drivable envelope: the standard
    # speed-reduction fallback. 0 disables the round. DEFAULT OFF: the
    # TPU frontier sweep measured every brake-cleared lane to be a
    # subset of what the cold-1.0 round clears (warm+brake 27/54
    # repaired vs warm+cold 32/54; warm+cold+brake still 32/54), so the
    # round only adds cost in the default ladder — it remains available
    # for deployments that prefer braking to margin escalation.
    brake_factor: float = 0.0
    # static repair sub-batch width as a fraction of B (jit needs static
    # shapes; dirty lanes beyond the width stay still_dirty and are
    # counted). Measured dirty rate is ~3.5%; 1/8 gives 3.5x headroom.
    # On sweep-block-aligned batches the width floors at one 128-lane
    # block so the repair solve keeps the fused Pallas sweep.
    max_fraction: float = 0.125


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """LQR path/speed tracker used by the optional InitGuess path
    (planner_config.h:18-43)."""

    simulation_dt: float = 0.01
    dt: float = 0.1
    tolerance: float = 0.01
    max_num_iteration: int = 150
    lat_weight_l: float = 1e-1
    lat_weight_theta: float = 1e-12
    lat_weight_delta: float = 1e-12
    lat_weight_delta_rate: float = 0.1
    lat_preview_time: float = 0.2
    lon_weight_s: float = 5.0e-1
    lon_weight_v: float = 1e-12
    lon_weight_a: float = 1e-12
    lon_weight_j: float = 0.1


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Top-level pipeline configuration (planner_config.h:88-188)."""

    delta_t: float = 0.1
    tf: float = 8.0
    vehicle: VehicleParam = VehicleParam()
    ilqr: IlqrConfig = IlqrConfig()
    corridor: CorridorConfig = CorridorConfig()
    dp: DpConfig = DpConfig()
    tracker: TrackerConfig = TrackerConfig()
    repair: RepairConfig = RepairConfig()

    @property
    def num_knots(self) -> int:
        """81 for the default horizon (ilqr_optimizer.cc:22)."""
        return int(math.floor(self.tf / self.delta_t + 1))

    def replace(self, **kw) -> "PlannerConfig":
        return _replace(self, **kw)


def from_dict(d: dict[str, Any], base: PlannerConfig | None = None) -> PlannerConfig:
    """Build a PlannerConfig from a (possibly nested) plain dict, e.g. parsed
    from YAML/JSON; unknown keys raise."""
    cfg = base or PlannerConfig()

    def apply(obj, sub: dict[str, Any]):
        kw = {}
        for k, v in sub.items():
            if not hasattr(obj, k):
                raise KeyError(f"unknown config key {k!r} for {type(obj).__name__}")
            cur = getattr(obj, k)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                kw[k] = apply(cur, v)
            else:
                kw[k] = v
        return _replace(obj, **kw)

    return apply(cfg, d)


DEFAULT_CONFIG = PlannerConfig()
