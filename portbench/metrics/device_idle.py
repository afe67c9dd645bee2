"""The device's idle share of the profiled calls, in %: 100 times one
minus the union of the device's intervals over the traced window."""


def read(r):
    w = r.profile["window_s"]
    if w <= 0:
        return None
    return 100.0 * (1.0 - r.profile["busy_s"] / w)
