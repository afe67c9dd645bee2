"""Iterations per lane of the main batch solve (``SolveResult.iters``, the
solve outside the repair ladder), the mean over the traced window's
calls."""


def read(r):
    return r.main_iters
