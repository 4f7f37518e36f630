"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the plain reference, and the result line.

The loop named by the cell's mix (`loops/<loop>.py`) provides a
class `Run(ctx)` with:
  setup()        everything before the window (counted in setup_s);
  unit(i)        one closed-loop frame or step of the window;
  e2e(window_s, latencies) -> {end-to-end metric: value};
  min_units      units the window holds at least (a traced stretch);
  release()      drops the program's state before the reference runs;
  check() -> ({number: value}, {work figure: value}, [note lines]).
A traced run's loop brackets its stretch with ctx.tracer.start() and
ctx.tracer.stop(units).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import sys
import time
import traceback

from . import bench, device as device_mod, trace as trace_mod


@dataclasses.dataclass
class Context:
    cell: bench.Cell
    seed: int
    device: object          # torch.device
    tracer: trace_mod.Tracer
    spans: dict             # the benchmark's own spans: name -> seconds
    scale: dict             # size overrides (tests on the CPU only)
    phases: list = dataclasses.field(default_factory=list)

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    def phase(self, name: str) -> None:
        """Mark the end of a set-up phase (reported on an earlier line)."""
        self.phases.append((name, time.perf_counter()))


@dataclasses.dataclass
class Readings:
    """What a per-layer reader reads: the traced stretch, the work the
    reference counted on it, the benchmark's spans."""

    stretch: trace_mod.Stretch | None
    work: dict
    spans: dict


def window(run, seconds: float):
    """Closed loop for `seconds`: units back to back; the window is from
    the first unit's start to the last unit's end.  It runs on past the
    seconds until the loop's `min_units` (a traced stretch) are done."""
    lat = []
    t_start = time.perf_counter()
    end = t_start + seconds
    t = t_start
    while t < end or len(lat) < run.min_units:
        run.unit(len(lat))
        t1 = time.perf_counter()
        lat.append(t1 - t)
        t = t1
    return t - t_start, lat


def execute(ctx: Context, t0: float, seconds: float,
            program=contextlib.nullcontext) -> dict:
    """Run the cell once; the result dict (the line's keys), or raise.
    `program()` is entered around set-up and the window (the control's
    calibration puts the reference in the program's place there)."""
    import torch
    cell = ctx.cell
    ctx.phase("start (python, torch, the card)")
    with program():
        run = bench.loop(cell).Run(ctx)
        run.setup()
        setup_s = time.perf_counter() - t0
        ctx.log("set-up: " + ", ".join(
            f"{name} {t - prev:.3f} s" for (name, t), prev in zip(
                ctx.phases, [t0] + [t for _, t in ctx.phases])))
        window_s, lat = window(run, seconds)
    q = statistics.quantiles(lat, n=4) if len(lat) > 1 else lat * 3
    ctx.log(f"window: {len(lat)} units in {window_s:.3f} s; latency min "
            f"{min(lat):.6f} quartiles {q[0]:.6f} {q[1]:.6f} {q[2]:.6f} max "
            f"{max(lat):.6f} s")
    dev = ctx.device
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    e2e = {"setup_s": setup_s, **run.e2e(window_s, lat)}
    run.release()
    numbers, work, notes = run.check()
    for line in notes:
        ctx.log(line)
    limits = cell.limits
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        checks[name] = {"value": value, "limit": limit}
    stretch = ctx.tracer.stretch
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": len(lat), "failed": 0}
    if ctx.tracer.on:
        if stretch is None:
            raise RuntimeError("the traced run profiled no stretch")
        readings = Readings(stretch=stretch, work=work, spans=ctx.spans)
        metrics = {}
        for m in cell.per_layer:
            value = bench.metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = stretch.busy_s
        device["window_s"] = stretch.window_s
        out["metrics"] = metrics
        out["device"] = device
        out["breakdown"] = {"device_ops": stretch.top_device_ops(),
                            "idle_gaps": stretch.idle_gaps()}
        ctx.log(f"traced stretch: {stretch.units} units, "
                f"{stretch.launches} launches, busy {stretch.busy_s} s of "
                f"{stretch.window_s} s")
        for part, n in sorted(stretch.counters.items()):
            seen = len(stretch.kernels(part))
            if seen != n:
                ctx.log(f"profiler saw {seen} launches of {part}, its "
                        f"counter says {n}")
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = device
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    device_mod.require_cards(cell.chips)
    import torch
    from . import port
    # The host loop is one thread of Python dispatch; torch's own CPU
    # threads would only contend with it.
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    ctx = Context(cell=cell, seed=args.seed, device=dev,
                  tracer=trace_mod.Tracer(bool(args.trace), port.counters),
                  spans={}, scale={})
    ctx.log(f"workload {cell.name}, seed {args.seed}, {args.seconds} s, "
            f"trace {args.trace}")
    try:
        out = execute(ctx, t0, args.seconds)
    except Exception:
        traceback.print_exc()
        return 1
    bad = device_mod.forbidden_modules()
    if bad:
        ctx.log(f"error: the run loaded {', '.join(bad)}")
        return 3
    ctx.log(f"card: {device_mod.power_line()}; memory peak "
            f"{out['device']['memory_peak_bytes']} bytes; correct "
            f"{out['correct']}")
    for name, c in out["checks"].items():
        ctx.log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(out), flush=True)
    return 0
