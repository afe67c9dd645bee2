"""The import guard: whole top-level names, so the port passes and the JAX
package does not; the reference imports nothing of the program."""

import subprocess
import sys

from portbench import guard, registry


def test_whole_top_level_names():
    mods = {"cilqr_tpu_torch": 1, "cilqr_tpu_torch.dp": 1, "jaxlib.xla": 1,
            "cilqr_tpu": 1, "cilqr_tpu.pallas": 1, "jaxtyping": 1,
            "flax": 1, "numpy": 1}
    assert guard.loaded_forbidden(mods) == ["cilqr_tpu", "cilqr_tpu.pallas",
                                            "flax", "jaxlib.xla"]
    assert guard.loaded_forbidden(mods, guard.FORBIDDEN_IN_REFERENCE)[:2] \
        == ["cilqr_tpu", "cilqr_tpu.pallas"]


def test_reference_imports_nothing_of_the_program(tmp_path):
    assert guard.reference_violations() == []
    (tmp_path / "bad.py").write_text(
        "import numpy\nfrom cilqr_tpu_torch.dp import plan\n"
        "def f():\n    import jax.numpy\n")
    assert guard.reference_violations(tmp_path) == [
        ("bad.py", "cilqr_tpu_torch.dp"), ("bad.py", "jax.numpy")]


def test_a_run_loads_no_jax():
    code = ("import sys, cilqr_tpu_torch, portbench.run, portbench.control, "
            "portbench.calibrate\n"
            "from portbench import guard\n"
            "from cilqr_tpu_torch import pipeline, mpc, batch\n"
            "from cilqr_tpu_torch.kernels import megasolve\n"
            "print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=registry.ROOT, check=True)
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure: the run exits non-zero and prints no result."""
    import shutil

    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "pedtest_spec.replan", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip().endswith("}")
