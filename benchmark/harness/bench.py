"""Cells of BENCHMARK.json and the files each one names.

A cell (`workloads` entry) names a configuration and a traffic mix.  The
configuration's file is `configs/<config>.json`, the mix's
`traffic/<traffic>.json` (its `loop` names `loops/<loop>.py`), the
correctness limits of the cell `limits/<cell>.json`, and each per-layer
metric's reader `metrics/<metric>.py`.  Adding any of these is adding a
file: nothing here lists them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent     # the benchmark's folder
ROOT = HERE.parent                                  # the checkout


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict          # configs/<config>.json, with its "name"
    traffic: dict         # traffic/<traffic>.json, with its "name"
    limits: dict          # limits/<cell>.json: {number: limit}
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its configuration, mix,
    limits and metrics."""
    bench = _load_json(ROOT / "BENCHMARK.json")
    folder = HERE
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (one of "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    config = {"name": w["config"],
              **_load_json(folder / "configs" / f"{w['config']}.json")}
    traffic = {"name": w["traffic"],
               **_load_json(folder / "traffic" / f"{w['traffic']}.json")}
    limits = _load_json(folder / "limits" / f"{name}.json")
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, limits=limits,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def load_module(path: Path, name: str):
    """Import the file at `path` as module `name` (file names may hold dots,
    as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(cell: Cell):
    drv = cell.traffic["loop"]
    return load_module(HERE / "loops" / f"{drv}.py", f"bench_loop_{drv}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       "bench_metric_" + name.replace(".", "_"))
