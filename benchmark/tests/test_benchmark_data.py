"""Adding a configuration, a traffic mix and a per-layer metric takes new
files only: in a copy of the benchmark, one of each is added beside the
others, BENCHMARK.json gains their entries, and a tiny run of the new cell
on the CPU reports the new metric."""

import json
import shutil
import subprocess
import sys

from harness import bench

NEW_CONFIG = {
    "source": "test: the Cornell box with a GGX metallic block",
    "scene": {"function": "make_cornell_box",
              "args": {"metallic_tall_block": True, "roughness": 0.3}},
    "camera": {"position": [0.0, 1.0, 3.9], "target": [0.0, 1.0, 0.0],
               "fov_y": 0.95},
    "render": {"width": 512, "height": 512, "spp": 4, "max_bounces": 4},
    "assumed": {}, "reduced": []}
NEW_MIX = {"loop": "frames", "render": {"spp": 1}, "accumulate": False,
           "warm_units": 1, "check_units": 1,
           "profile": {"first": 0, "units": 1}}
NEW_METRIC = '''
def read(readings):
    return readings.spans.get("ingest.scene_s")
'''


def test_a_new_config_mix_and_metric_are_new_files_only(tmp_path):
    root = bench.ROOT
    shutil.copytree(bench.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    b = tmp_path / "benchmark"
    (b / "configs" / "cornell_ggx.json").write_text(json.dumps(NEW_CONFIG))
    (b / "traffic" / "spin.json").write_text(json.dumps(NEW_MIX))
    (b / "metrics" / "ingest.ggx_s.py").write_text(NEW_METRIC)
    (b / "limits" / "cornell_ggx.spin.json").write_text(
        json.dumps({"hdr_off_pct": 1.0, "ldr_off_pct": 1.0}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cornell_ggx", "source": "test",
                            "file": "benchmark/configs/cornell_ggx.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "cornell_ggx.spin",
                              "config": "cornell_ggx", "traffic": "spin",
                              "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "frame_ms":
            m["workloads"].append("cornell_ggx.spin")
    spec["per_layer"].append({
        "name": "ingest.ggx_s", "unit": "s", "better": "lower",
        "source": "host_clock", "layer": "asset ingest", "moves": "setup_s",
        "workloads": ["cornell_ggx.spin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    code = f"""
import sys, time, torch, json
sys.path[0:0] = [{str(b)!r}, {str(root)!r}]
from harness import bench, port, runner, trace
torch.set_num_threads(2)
cell = bench.load_cell("cornell_ggx.spin")
for on in (False, True):
    ctx = runner.Context(cell=cell, seed=9, device=torch.device("cpu"),
                         tracer=trace.Tracer(on, port.counters), spans={{}},
                         scale={{"width": 16, "height": 12}})
    print(json.dumps(runner.execute(ctx, time.perf_counter(), 0.0)))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    plain, traced = (json.loads(x) for x in p.stdout.strip().splitlines())
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"frame_ms", "setup_s"}
    assert traced["metrics"]["ingest.ggx_s"]["value"] > 0.0
