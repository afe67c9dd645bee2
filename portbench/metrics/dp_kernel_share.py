"""The DP sweep kernel's share of the device's busy time, in %: 100 times
the profiler's device time of ``dp_sweep_kernel`` over the union of the
device's intervals, both over the profiled calls. A share, not a time a
call: the trace summary does not count the profiled calls."""

KERNEL = "dp_sweep_kernel"


def read(r):
    busy = r.profile["busy_s"]
    device_s = sum(s for name, s in r.profile["kernel_s"].items()
                   if KERNEL in name)
    if busy <= 0 or device_s <= 0:
        return None
    return 100.0 * device_s / busy
