"""Readings that the correctness limits are set from (limits/<cell>.json).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 [--control]

For each seed, in one process, a run of the cell as benchmark/run.py makes
it (a shorter window, untraced), and one JSON line with the numbers that
the check compared.  With --control the program is replaced, for set-up
and the window, by the control: the plain reference itself computed one
precision below the configuration's float32, every sample's radiance
rounded to bfloat16, the film summed in bfloat16 (the dense path's
`Film.add_samples`; the whole-frame estimator's per-sample sum) and the
tonemapped image in bfloat16.  The
check then compares it with the reference as it compares the program.
With --fault <kind> (faults.py) the program runs with that fault planted.
The control's smallest readings are the limits' upper ends, with those of
a training cell's faults; the program's largest are their lower ends.
Benchmark runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import functools  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[0:0] = [HERE, os.path.dirname(HERE)]

from harness import bench, device as device_mod, port, runner, scenes  # noqa
from harness import trace as trace_mod  # noqa: E402
import faults  # noqa: E402


def _bf16(x):
    import torch
    return x.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def control():
    """The reference in the program's place, its films in bfloat16."""
    film = importlib.import_module(f"{scenes.REFERENCE}.core.film")
    fused = importlib.import_module(f"{scenes.REFERENCE}.ops.fused")
    tonemap = importlib.import_module(f"{scenes.REFERENCE}.ops.tonemap")
    real_add, real_plain = film.Film.add_samples, fused.fused_plain
    real_tonemap = tonemap.tonemap
    saved = port.PACKAGE, port.load_kernels

    def add_samples(self, radiance, n=1.0):
        return film.Film(hdr=_bf16(self.hdr + _bf16(radiance)),
                         spp=self.spp + n)

    def fused_plain(f, on_query=None):
        import torch
        n = f.width * f.height
        dev = f.tri.device
        pid = torch.arange(n, dtype=torch.int64, device=dev)
        py = pid // f.width
        pxf = (pid - py * f.width).to(torch.float32)
        pyf = py.to(torch.float32)
        acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        count = torch.zeros((), dtype=torch.int64, device=dev)
        for s in range(f.spp):
            L, c = fused._sample_frame(f, s, pid, pxf, pyf, *f.seeds,
                                       on_query)
            acc = _bf16(acc + _bf16(torch.stack(L, dim=-1)))
            count = count + c
        return acc.reshape(f.height, f.width, 3), count

    film.Film.add_samples = add_samples
    fused.fused_plain = fused_plain
    tonemap.tonemap = lambda hdr, gamma=2.2: _bf16(real_tonemap(_bf16(hdr),
                                                                gamma))
    port.PACKAGE, port.load_kernels = scenes.REFERENCE, lambda dev: None
    try:
        yield
    finally:
        film.Film.add_samples, fused.fused_plain = real_add, real_plain
        tonemap.tonemap = real_tonemap
        port.PACKAGE, port.load_kernels = saved


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=faults.FAULTS)
    args = p.parse_args(argv)
    cell = bench.load_cell(args.workload)
    device_mod.require_cards(cell.chips)
    import torch
    dev = torch.device("cuda", 0)
    print(f"card: {device_mod.power_line()}", file=sys.stderr)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = runner.Context(cell=cell, seed=seed, device=dev,
                             tracer=trace_mod.Tracer(False), spans={},
                             scale={})
        t0 = time.perf_counter()
        if args.control:
            program = control
        elif args.fault:
            program = functools.partial(faults.planted,
                                        cell.traffic["loop"], args.fault)
        else:
            program = contextlib.nullcontext
        out = runner.execute(ctx, t0, args.seconds, program)
        print(json.dumps({
            "workload": cell.name, "seed": seed, "control": args.control,
            "fault": args.fault,
            "units": out["attempted"],
            "numbers": {k: v["value"] for k, v in out["checks"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
