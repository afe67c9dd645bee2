"""On the card: one short run of a cell prints a result line of the
contract's shape, correct, named by the card. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import registry


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "pedtest_spec.replan", "--seed", str(2**31 + 99), "--seconds", "3"],
        capture_output=True, text=True, cwd=registry.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert set(r["metrics"]) == {"replans_per_s", "setup_s"}
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
    assert r["device"]["count"] == 1 and r["attempted"] >= 1024
