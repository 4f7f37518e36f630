"""Runs of a cell on the CPU at a tiny size, for the tests."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from harness import bench, port, runner, trace

TINY = {"cornell.frame": {"width": 24, "height": 16, "spp": 2},
        "cornell.fit": {"width": 16, "height": 16, "spp": 2}}
CELLS = tuple(TINY)


def tiny_cell(name: str) -> bench.Cell:
    """The cell with few warm frames and a short traced stretch."""
    cell = bench.load_cell(name)
    mix = dict(cell.traffic)
    if mix["loop"] == "frames":
        mix.update(warm_units=1, profile={"first": 1, "units": 2})
    else:
        mix.update(target_spp=2)
    return dataclasses.replace(cell, traffic=mix)


def run_tiny(name: str, trace_on: bool = False, seed: int = 2**33 + 5,
             program=contextlib.nullcontext, seconds: float = 0.0,
             cell: bench.Cell | None = None) -> dict:
    torch.set_num_threads(2)
    cell = cell or tiny_cell(name)
    ctx = runner.Context(cell=cell, seed=seed, device=torch.device("cpu"),
                         tracer=trace.Tracer(trace_on, port.counters),
                         spans={}, scale=TINY.get(name, TINY[cell.name]))
    return runner.execute(ctx, time.perf_counter(), seconds, program)
