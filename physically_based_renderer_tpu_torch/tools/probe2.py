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

`scalar_stack` runs on three data sets: the reference probe's own
(`default_rng(1)`), on which the root box fails the slab test and the walk
is one node long; boxes that all pass (2,047 nodes visited, 1,024 leaves);
and a seed on which part of the tree passes.  The kernel finds what the
walk finds without walking (level by level, `csrc/probes.cu`), so its time
is not a time a node.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np

from .timing import device_ms

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


def tree_boxes(n: int, rate: float) -> np.ndarray:
    """Boxes f32[n * 6] of which each but the root passes the slab test
    (max(lo) <= min(hi)) with probability `rate`, independently; the root
    passes, so that the tree is walked.  A failing box has one hi
    coordinate below its largest lo.  Drawn from default_rng(n)."""
    rng = np.random.default_rng(n)
    lo = rng.uniform(-1, 0, (n, 3)).astype(np.float32)
    hi = rng.uniform(0.5, 1.5, (n, 3)).astype(np.float32)
    fail = rng.random(n) >= rate
    fail[0] = False
    hi[fail, rng.integers(0, 3, n)[fail]] = np.float32(-2.0)
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


def onehot_edge_inputs(n: int = 1024, r: int = 32, l: int = 512,
                       seed: int = 0):
    """(win i32[n, 1], rows f32[r, l]) on which the product's arithmetic
    shows: +0.0 and -0.0 (a tenth of the entries each); inf, -inf or NaN at
    one lane of every third row (and a second lane of row 0); win at -1
    (every seventh), at l (every seventh, shifted by 3), at a non-finite
    entry's lane (every seventh, shifted by 5), else in range."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(r, l)).astype(np.float32)
    rows[rng.random((r, l)) < 0.1] = 0.0
    rows[rng.random((r, l)) < 0.1] = -0.0
    bad = [(c, int(rng.integers(0, l))) for c in range(0, r, 3)]
    bad.append((0, int(rng.integers(0, l))))
    for k, (c, lane) in enumerate(bad):
        rows[c, lane] = (np.inf, -np.inf, np.nan)[k % 3]
    win = rng.integers(0, l, (n, 1)).astype(np.int32)
    win[0::7] = -1
    win[3::7] = l
    lanes = np.array([lane for _, lane in bad], np.int32)
    win[5::7, 0] = lanes[np.arange(len(win[5::7])) % len(lanes)]
    return win, rows


def gather_inputs(rows: int, lanes: int, axis: int, seed: int = 0):
    """(x f32[rows, lanes], idx i32[rows, lanes])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, lanes)).astype(np.float32)
    idx = rng.integers(0, rows if axis == 0 else lanes,
                       (rows, lanes)).astype(np.int32)
    return x, idx


def gather_edge_inputs(rows: int, lanes: int, axis: int, seed: int = 0):
    """`gather_inputs` with +0.0 and -0.0 in x (a tenth of the entries
    each) and indices outside the axis, which the kernel clamps: -1 and the
    axis' size (a twentieth each) and the int32 extremes at two places."""
    x, idx = gather_inputs(rows, lanes, axis, seed)
    rng = np.random.default_rng(seed + 1)
    x[rng.random(x.shape) < 0.1] = 0.0
    x[rng.random(x.shape) < 0.1] = -0.0
    u = rng.random(idx.shape)
    idx[u < 0.05] = -1
    idx[u > 0.95] = rows if axis == 0 else lanes
    idx.flat[:2] = (np.iinfo(np.int32).min, np.iinfo(np.int32).max)
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
    itself (tools/timing.py); None on the CPU."""
    if device.type != "cuda":
        return None
    return device_ms(fn, iters, kernel)[0] * 1e3


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
        print(f"scalar_stack[{data}]: visited={visited} leaves={n_leaves} "
              f"device {_us(dev_us)}, wrapper {_us(wrap)} ok={ok} "
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
    moved = probes.relayout(x, "exchange").cpu().numpy()
    ok = bool((got == want).all() and (moved == want).all())
    dev_us = device_us(lambda: probes.relayout(x), iters,
                       "probe_relayout_kernel", device)
    # The route that moves every term across threads: what a real relayout
    # of the tile costs on the card.
    moved_us = device_us(lambda: probes.relayout(x, "exchange"), iters,
                         "probe_relayout_exchange_kernel", device)
    wrap = wrapper_us(lambda: probes.relayout(x), iters, device)
    each = (f" (exchange route {_us(moved_us)}: "
            f"{(moved_us - dev_us) / 11 * 1e3:.0f} ns a move)"
            if dev_us is not None else "")
    print(f"relayout x11: device {_us(dev_us)}{each}, wrapper {_us(wrap)} "
          f"ok={ok} [{card_line(device)}]", flush=True)
    return {"ok": ok, "device_us": dev_us, "exchange_device_us": moved_us,
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
