"""Each cell, run briefly on the card by its own command, is correct and
prints its line.  Skips without a card."""

import json
import subprocess
import sys

import pytest
from helpers import CELLS

from harness import bench


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card_is_correct(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the card only")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        name, "--seed", str(2**31 + 11), "--seconds", "2",
                        "--trace", str(trace)], cwd=bench.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
    if trace:
        assert out["device"]["busy_s"] > 0.0
