"""The road library's time per call (``pipeline.lane_roads``: each lane's
road operands gathered from the library), in ms.
A call is one replan of the batch; the span is timed by CUDA events around
the calls that no other wrapped call encloses, over the traced run's
window. A program without a road library has nothing to read."""

SPAN = "roads"


def read(r):
    if SPAN in r.missing or SPAN not in r.span_s or r.calls == 0:
        return None
    return 1e3 * r.span_s[SPAN] / r.calls
