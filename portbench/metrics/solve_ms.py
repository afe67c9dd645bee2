"""The batch solve's time per call (``solve_batch`` outside the repair
ladder), in ms.
A call is one replan or one MPC cycle of the batch; the span is timed
by CUDA events around the calls that no other wrapped call encloses, over
the traced run's window."""

SPAN = "solve"


def read(r):
    if SPAN in r.missing or SPAN not in r.span_s or r.calls == 0:
        return None
    return 1e3 * r.span_s[SPAN] / r.calls
