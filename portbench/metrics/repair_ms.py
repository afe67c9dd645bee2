"""The re-check and repair ladder's time per call
(``pipeline._recheck_solution`` and ``pipeline._repair_batch``, the
ladder's own solves and re-checks included), in ms.
A call is one replan or one MPC cycle of the batch; the span is timed
by CUDA events around the calls that no other wrapped call encloses, over
the traced run's window."""

SPAN = "repair"


def read(r):
    if SPAN in r.missing or SPAN not in r.span_s or r.calls == 0:
        return None
    return 1e3 * r.span_s[SPAN] / r.calls
