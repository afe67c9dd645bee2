"""Peaks of the card and the least time of the full-solve megakernel, from
the work the algorithm defines for a launch's lanes (not from counts the
kernel keeps, which move with its implementation).

Operations are counted one per arithmetic operation, comparison, select,
square root or transcendental, by the per-item counts of ``OPS``
(csrc/megasolve.cu's arithmetic as the port first wrote it; sweep.cu and
coststack.cu share these formulas). A solve of one lane needs the cost of
its initial trajectory, and for each iteration one relinearisation
(Jacobians, cost derivatives, the backward pass) and one candidate rollout
with its cost: a lower bound, since a line search that retries adds
candidates. Bytes count each input once and each output once.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores and the device memory rate.
PEAK_F32_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12

OPS = dict(
    riccati_step=1941,   # Q blocks, 2x2 solve, gains, V update, dV, gnorm
    jacobian=68,         # analytic midpoint A, B of one step
    rollout_step=113,    # closed-loop control and RK2 step with wraps
    segment=5,           # a lane segment's own terms
    segment_disc=23,     # a disc's distance to a segment, running minimum
    plane_value=18,      # one (plane or lane side, disc) barrier value
    plane_both=64,       # the same with its gradient and Hessian rows
    discs=2,             # cos, sin of a knot (+4 per disc centre)
    knot_value=104,      # targets and state limits of a knot, values
    knot_value_u=66,     # + controls (knots before the last)
    knot_derivs=108,     # targets and state limits, derivatives
    knot_derivs_u=68,    # + controls
)


def lane_scan_ops(S: int, D: int) -> int:
    """One lane side's nearest-segment scan for D discs."""
    return S * (OPS["segment"] + OPS["segment_disc"] * D)


def solve_parts(N: int, KC: int, S: int, D: int):
    """Operations of (the cost of one trajectory, one candidate rollout with
    its cost, one relinearisation) of one lane: N knots, KC corridor planes
    a knot, S lane segments a side, D discs."""
    T = N - 1
    value = (OPS["knot_value"] + OPS["discs"] + 4 * D
             + 2 * lane_scan_ops(S, D) + (KC + 2) * D * OPS["plane_value"])
    derivs = (OPS["knot_derivs"]
              + (KC + 2) * D * (OPS["plane_both"] - OPS["plane_value"]))
    cost = N * value + T * OPS["knot_value_u"]
    candidate = cost + T * OPS["rollout_step"]
    relin = N * derivs + T * (OPS["knot_derivs_u"] + OPS["jacobian"]
                              + OPS["riccati_step"])
    return cost, candidate, relin


def solve_ops(lanes: int, iters_sum: int, N: int, KC: int, S: int,
              D: int) -> int:
    """Operations a solve of ``lanes`` lanes needs whose iterations sum to
    ``iters_sum``."""
    cost, candidate, relin = solve_parts(N, KC, S, D)
    return lanes * cost + iters_sum * (candidate + relin)


def solve_bytes(lanes: int, N: int, KC: int, S: int, itemsize: int) -> int:
    """Bytes of a launch: goals, initial states and controls, three corridor
    plane rows and two lane sides of 7 rows in; states, controls, six cost
    and lambda values and four int32 status words out."""
    T = N - 1
    inputs = lanes * (2 * N * 6 + T * 2 + 3 * N * KC + 2 * 7 * S) * itemsize
    outputs = lanes * ((N * 6 + T * 2 + 6) * itemsize + 4 * 4)
    return inputs + outputs


def least_seconds(ops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the float32 peak and the bytes over the memory rate."""
    return max(ops / PEAK_F32_OPS_PER_S, n_bytes / PEAK_BYTES_PER_S)
