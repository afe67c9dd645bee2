"""The full-solve megakernel's share of its roofline, in %: 100 times its
least time over its device time, both summed over every launch of the
profiled calls. The least time counts the work the algorithm defines for
each launch's lanes (``roofline``); the device time is the profiler's,
by the kernel's name."""

from portbench import roofline

KERNEL = "mega_kernel"


def read(r):
    device_s = sum(s for name, s in r.profile["kernel_s"].items()
                   if KERNEL in name)
    if device_s <= 0 or not r.launches:
        return None
    least = sum(roofline.least_seconds(
        roofline.solve_ops(x["lanes"], int(x["iters"].sum()), x["N"],
                           x["KC"], x["S"], x["D"]),
        roofline.solve_bytes(x["lanes"], x["N"], x["KC"], x["S"],
                             x["itemsize"])) for x in r.launches)
    return 100.0 * least / device_s
