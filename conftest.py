"""Keeps each test process under the kernel's limit on memory maps.

XLA:CPU loads every program it compiles as objects of their own, three
small memory maps per kernel, and JAX's in-process caches keep them loaded
for the life of the process: `tests/test_pipeline_f32_gate.py` alone leaves
about 42,000 maps behind. A pytest-xdist worker that runs the heaviest JAX
tests in turn passes `vm.max_map_count` (65,530 by default) and dies with a
segmentation fault in its next compile or compilation-cache read, taking
whichever test runs then with it. So after each test, a process past half
the limit drops JAX's caches, which unloads those programs; the tests that
follow reload what they need from the persistent compilation cache
(`tests/conftest.py`). No single test adds more than half the limit.
"""

import gc
import sys


def _max_map_count():
    with open("/proc/sys/vm/max_map_count") as f:
        return int(f.read())


def _map_count():
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


def pytest_runtest_teardown(item):
    jax = sys.modules.get("jax")
    if jax is None:
        return
    try:
        over = _map_count() > _max_map_count() // 2
    except OSError:  # no procfs: nothing to measure
        return
    if over:
        jax.clear_caches()
        gc.collect()
