"""Primitive probes on the card (port of the reference repository's
`tools/probe2.py`): run one probe, check it, time it, print one line.

    python -m physically_based_renderer_tpu_torch.tools.probe2 NAME \
        [--device cuda] [--iters 200]

NAME: scalar_stack | relayout | onehot_mm | gather8 | gather_state |
      gather_rows | gather_lane | gather_tex | all

Each probe builds the reference probe's inputs from the same numpy seeds,
runs its kernel (`ops/probes.py`, `csrc/probes.cu`), holds the result
against the probe's own numpy expectation (the scalar walk, for which the
reference states none, against the plain version) and prints one line with
the times and the card's name and power limit.  Times: `device` is the kernel's
own time per launch under torch.profiler, `wrapper` the time per call of
the Python wrapper called back to back (CUDA events: host dispatch, checks
and the output's allocation included).  Most of these kernels are shorter
than a launch, so the wrapper time is the launch floor and the device time
is the kernel.

`scalar_stack` walks three data sets: the reference probe's own
(`default_rng(1)`), on which the root box fails the slab test and the walk
is one node long; boxes that all pass (2,047 nodes visited, 1,024 leaves);
and a seed on which part of the tree passes.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

N_NODES = 2047
# name -> (rows, lanes, axis) of the gather probes
GATHER_SHAPES = {
    "gather8": (8, 128, 0),
    "gather_state": (1024, 128, 0),
    "gather_rows": (256, 512, 0),
    "gather_lane": (8, 512, 1),
    "gather_tex": (16384, 128, 0),
}
# scalar_stack data sets: name -> (seed, least box width); None = every
# box passes.  "probe" is the reference probe's own data.
STACK_DATA = {"probe": (1, 0.0), "all": None, "partial": (3, 0.6)}
NAMES = ("scalar_stack", "relayout", "onehot_mm", *GATHER_SHAPES)


# ------------------------------------------------------------------ inputs

def scalar_stack_boxes(data: str = "probe") -> np.ndarray:
    """Boxes f32[2047 * 6] of one of STACK_DATA's sets."""
    spec = STACK_DATA[data]
    if spec is None:
        lo = np.full((N_NODES, 3), -1.0, np.float32)
        hi = np.full((N_NODES, 3), 1.0, np.float32)
    else:
        seed, width = spec
        rng = np.random.default_rng(seed)
        lo = rng.uniform(-1, 0.4, (N_NODES, 3)).astype(np.float32)
        hi = lo + rng.uniform(width, width + 1.2,
                              (N_NODES, 3)).astype(np.float32)
    return np.concatenate([lo, hi], 1).reshape(-1)


def relayout_input() -> np.ndarray:
    return np.arange(1024, dtype=np.float32).reshape(8, 128)


def relayout_expected() -> np.ndarray:
    return sum((np.arange(1024) + i) for i in range(10)).reshape(
        8, 128).astype(np.float32)


def onehot_inputs(seed: int = 0):
    """(lane i32[1024, 1], rows f32[32, 512])."""
    rng = np.random.default_rng(seed)
    lane = rng.integers(0, 512, (1024, 1)).astype(np.int32)
    rows = rng.normal(size=(32, 512)).astype(np.float32)
    return lane, rows


def gather_inputs(rows: int, lanes: int, axis: int, seed: int = 0):
    """(x f32[rows, lanes], idx i32[rows, lanes])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, lanes)).astype(np.float32)
    idx = rng.integers(0, rows if axis == 0 else lanes,
                       (rows, lanes)).astype(np.int32)
    return x, idx


# ------------------------------------------------------------------ timing

def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for a
    CPU device."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def wrapper_us(fn, iters: int, device) -> float | None:
    """Microseconds per call of fn called back to back (CUDA events)."""
    import torch
    if device.type != "cuda":
        return None
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) * 1e3 / iters


def device_us(fn, iters: int, kernel: str, device) -> float | None:
    """Microseconds per launch of the kernels named `kernel` on the device
    itself, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if device.type != "cuda":
        return None
    fn()
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize(device)
    own = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.key]
    n = sum(e.count for e in own)
    if n == 0:
        raise RuntimeError(f"the profiler saw no launch of {kernel}")
    return sum(e.self_device_time_total for e in own) / n


def _us(v) -> str:
    return "not measured" if v is None else f"{v:.2f} us"


# ------------------------------------------------------------------ probes

def probe_scalar_stack(device, iters: int) -> dict:
    import torch

    from ..ops import probes
    res = {}
    for data in STACK_DATA:
        boxes = torch.from_numpy(scalar_stack_boxes(data)).to(device)
        out, leaves = probes.scalar_stack(boxes)
        visited, n_leaves = (int(v) for v in out.cpu())
        # the reference probe states no expectation for the walk: the plain
        # version (a Python loop on the host) is the yardstick
        want_out, want_leaves = probes.scalar_stack_plain(boxes.cpu())
        ok = bool(torch.equal(out.cpu(), want_out)
                  and torch.equal(leaves.cpu(), want_leaves))
        call = lambda: probes.scalar_stack(boxes)
        dev_us = device_us(call, iters, "probe_scalar_stack_kernel", device)
        wrap = wrapper_us(call, iters, device)
        per_node = (f" ({dev_us / max(visited, 1) * 1e3:.0f} ns/node)"
                    if dev_us is not None else "")
        print(f"scalar_stack[{data}]: visited={visited} leaves={n_leaves} "
              f"device {_us(dev_us)}{per_node}, wrapper {_us(wrap)} ok={ok} "
              f"[{card_line(device)}]", flush=True)
        res[data] = {"visited": visited, "leaves": n_leaves, "ok": ok,
                     "device_us": dev_us, "wrapper_us": wrap}
    return res


def probe_relayout(device, iters: int) -> dict:
    import torch

    from ..ops import probes
    x = torch.from_numpy(relayout_input()).to(device)
    want = relayout_expected()
    got = probes.relayout(x).cpu().numpy()
    local = probes.relayout(x, exchange=False).cpu().numpy()
    ok = bool((got == want).all() and (local == want).all())
    kern = "probe_relayout_kernel"
    dev_us = device_us(lambda: probes.relayout(x), iters, kern, device)
    # The instantiation without the exchange: what is left of the kernel
    # when no value crosses threads.  A device time equal to it would mean
    # the compiler had removed the moves.
    local_us = device_us(lambda: probes.relayout(x, exchange=False), iters,
                         kern, device)
    wrap = wrapper_us(lambda: probes.relayout(x), iters, device)
    each = (f" ({(dev_us - local_us) / 11 * 1e3:.0f} ns a move over the "
            f"{_us(local_us)} without moves)" if dev_us is not None else "")
    print(f"relayout x11: device {_us(dev_us)}{each}, wrapper {_us(wrap)} "
          f"ok={ok} [{card_line(device)}]", flush=True)
    return {"ok": ok, "device_us": dev_us, "no_exchange_device_us": local_us,
            "wrapper_us": wrap}


def probe_onehot_mm(device, iters: int) -> dict:
    import torch

    from ..ops import probes
    lane_np, rows_np = onehot_inputs()
    lane = torch.from_numpy(lane_np).to(device)
    rows = torch.from_numpy(rows_np).to(device)
    got = probes.onehot_mm(lane, rows).cpu().numpy()
    ok = bool((got == rows_np.T[lane_np[:, 0]]).all())
    call = lambda: probes.onehot_mm(lane, rows)
    dev_us = device_us(call, iters, "probe_onehot_mm_kernel", device)
    wrap = wrapper_us(call, iters, device)
    print(f"onehot_mm [1024,512]x[32,512]: device {_us(dev_us)}, wrapper "
          f"{_us(wrap)} ok={ok} [{card_line(device)}]", flush=True)
    return {"ok": ok, "device_us": dev_us, "wrapper_us": wrap}


def probe_gather(tag: str, device, iters: int) -> dict:
    import torch

    from ..ops import probes
    rows, lanes, axis = GATHER_SHAPES[tag]
    x_np, idx_np = gather_inputs(rows, lanes, axis)
    x = torch.from_numpy(x_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    got = probes.gather(x, idx, axis).cpu().numpy()
    ok = bool((got == np.take_along_axis(x_np, idx_np, axis=axis)).all())
    call = lambda: probes.gather(x, idx, axis)
    dev_us = device_us(call, iters, "probe_gather_kernel", device)
    wrap = wrapper_us(call, iters, device)
    rate = (f" ({rows * lanes / dev_us / 1e3:.2f}G/s)" if dev_us is not None
            else "")
    print(f"{tag} [{rows},{lanes}] axis={axis}: device {_us(dev_us)}{rate}, "
          f"wrapper {_us(wrap)} ok={ok} [{card_line(device)}]", flush=True)
    return {"ok": ok, "device_us": dev_us, "wrapper_us": wrap}


PROBES = {
    "scalar_stack": probe_scalar_stack,
    "relayout": probe_relayout,
    "onehot_mm": probe_onehot_mm,
    **{tag: (lambda device, iters, tag=tag: probe_gather(tag, device, iters))
       for tag in GATHER_SHAPES},
}


def run(name: str, device, iters: int = 200) -> dict:
    """Run one probe (or "all") on `device`; {probe name: its results}."""
    names = NAMES if name == "all" else (name,)
    return {n: PROBES[n](device, iters) for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbr-probe2-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("name", choices=(*NAMES, "all"))
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu: plain versions, "
                        "no times)")
    p.add_argument("--iters", type=int, default=200)
    args = p.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    print(f"--- {args.name} on {card_line(device)}", flush=True)
    results = run(args.name, device, args.iters)
    flat = [r for res in results.values()
            for r in (res.values() if "ok" not in res else (res,))]
    return 0 if all(r["ok"] for r in flat) else 1


if __name__ == "__main__":
    sys.exit(main())
