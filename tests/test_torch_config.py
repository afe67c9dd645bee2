"""The port's configuration is a copy of the JAX package's, and
the port never imports JAX."""

import dataclasses
import os
import subprocess
import sys

import torch

import cilqr_tpu.config as JC
import cilqr_tpu_torch.config as TC
from cilqr_tpu_torch.convert import config_from_dict

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _after_docstring(pkg):
    """The source of ``pkg/config.py`` after its module docstring."""
    with open(os.path.join(ROOT, pkg, "config.py")) as f:
        src = f.read()
    assert src.startswith('"""')
    return src[src.index('"""', 3) + 3:]


def test_config_file_is_verbatim_copy():
    """Every line of code and comment is the JAX package's, byte for byte;
    only the module docstring says where the copy comes from."""
    jax_src = _after_docstring("cilqr_tpu")
    assert len(jax_src) > 10000
    assert _after_docstring("cilqr_tpu_torch") == jax_src


def test_default_configs_equal():
    assert (dataclasses.asdict(JC.PlannerConfig())
            == dataclasses.asdict(TC.PlannerConfig()))


def test_from_dict_round_trips():
    jcfg = JC.PlannerConfig().replace(ilqr=dataclasses.replace(
        JC.IlqrConfig(), lane_window=16, sweep_backend="xla",
        line_search=dataclasses.replace(JC.LineSearchConfig(),
                                        alphas=(1.0, 0.5, 0.25),
                                        alphas_per_trip=2)))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(tcfg, TC.PlannerConfig)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.ilqr.line_search.alphas == (1.0, 0.5, 0.25)
    assert TC.from_dict(dataclasses.asdict(tcfg)) == tcfg


def test_import_does_not_load_jax():
    code = ("import sys, cilqr_tpu_torch, cilqr_tpu_torch.kernels.sweep, "
            "cilqr_tpu_torch.kernels.coststack, "
            "cilqr_tpu_torch.kernels.megasolve, cilqr_tpu_torch.run, "
            "cilqr_tpu_torch.bench_prep, cilqr_tpu_torch.checkpoint, "
            "cilqr_tpu_torch.profiling, cilqr_tpu_torch.viz, "
            "cilqr_tpu_torch.pscan, cilqr_tpu_torch.dist, chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'flax', 'cilqr_tpu.')) or m == 'cilqr_tpu']\n"
            "assert not bad, bad\n"
            "assert 'matplotlib' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
