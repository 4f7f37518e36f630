"""BENCHMARK.json keeps the benchmark's rules of form, and every name in
it has its file."""

import json
import re

from harness import bench

SPEC = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_the_spec_has_exactly_its_keys_and_fits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    for word in SPEC["command"]:
        _line(word)


def test_names_units_and_lines():
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for group in (SPEC["configs"], SPEC["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        _line(c["source"])
        _line(c["why"])
        assert (bench.ROOT / c["file"]).is_file()
        assert c["reduced"] == json.loads(
            (bench.ROOT / c["file"]).read_text())["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        _line(w["why"])
        bench.load_cell(w["name"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        _line(m["layer"])
        assert (bench.HERE / "metrics" / f"{m['name']}.py").is_file()
        moves = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in moves or cell in moves["workloads"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in SPEC["workloads"]:
        cell = bench.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
