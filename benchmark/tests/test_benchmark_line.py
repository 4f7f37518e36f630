"""The result line: its keys at a tiny size through the CPU path, and no
line at all without a card."""

import json
import os
import subprocess
import sys

import pytest
from helpers import CELLS, run_tiny

from harness import bench

ROOT = os.path.dirname(bench.HERE)


@pytest.mark.parametrize("name", CELLS)
def test_untraced_line_has_the_cells_end_to_end_metrics(name):
    out = run_tiny(name)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    cell = bench.load_cell(name)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert "setup_s" in out["metrics"]
    for m in cell.end_to_end:
        got = out["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0.0
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["checks"]) == set(cell.limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_has_device_times_and_a_breakdown(name):
    out = run_tiny(name, trace_on=True)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert out["device"]["window_s"] > 0.0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    cell = bench.load_cell(name)
    names = {m["name"] for m in cell.per_layer}
    # On the CPU no device operation runs: no per-layer metric is read.
    assert set(out["metrics"]) <= names


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cornell.frame", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "cuda" in p.stderr.lower()


def test_run_outside_a_checkout_of_the_port_fails(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has
    no program to measure."""
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cornell.frame", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
