"""In-kernel gather, scalar walk and chunk arithmetic on the card (port of
the reference repository's `tools/probe_mosaic.py`): P5, P6, P7.

    python -m physically_based_renderer_tpu_torch.tools.probe_mosaic \
        [--device cuda] [--iters 50]

  P5 `gather`: sum over i < reps of take_along_axis(x, (idx + i) % size,
     axis) for the reference probe's ten shapes (x = arange, idx from
     `default_rng(0)`), held exactly to the probe's own numpy check;
  P6 `scalar_stack`: the nodes a walk of an implicit tree of 2,047 boxes
     visits, found level by level, on the probe's own boxes
     (`default_rng(1)`: the root box fails the slab test, so the walk is
     one node long, as for P1) and on the sets of `tools/probe2.py` where
     the tree really is walked, held to the plain version;
  P7 `chunk`: the block tracer's per-chunk arithmetic on 256 rays x 512
     columns x 8 chunks, on the probe's data (all ones: every test fails
     the mask and every output is 1e30), on seeded random data where the
     mask passes and on edge data (dets about +-1e-9, at and above 2^126,
     inf and NaN in t), held bit for bit to the plain version.

Every shape runs; any disagreement or failed launch exits non-zero (the
reference caught compile failures per shape and went on).  Each line gives
the kernel's device time per launch (torch.profiler), the wrapper's time
per call back to back (CUDA events) and the card's name and power limit;
`--device cpu` runs the plain versions and prints no times.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .probe2 import STACK_DATA, card_line, device_us, scalar_stack_boxes, \
    wrapper_us, _us

# (rows, lanes, axis, reps, iters): the reference probe's calls.
GATHER_CASES = (
    (8, 128, 0, 16, 50), (8, 512, 0, 16, 50), (32, 512, 0, 16, 50),
    (256, 512, 0, 16, 50), (1024, 512, 0, 4, 50), (4096, 128, 0, 2, 10),
    (8, 128, 1, 16, 50), (8, 512, 1, 16, 50), (256, 512, 1, 16, 50),
    (8, 4096, 1, 4, 50))
# P5 beyond the reference's calls, (rows, lanes, axis, reps), each on
# random floats with indices in [-3 size, 3 size) (`gather_random_inputs`):
# reps 0 and 1; tables no slab of shared memory holds (the direct route);
# rows and lanes that are not multiples of 4 (4-byte staging, ragged
# slabs; the last two take axis-1 slabs).
GATHER_EXTRA = (
    (1024, 512, 0, 0), (1024, 512, 0, 1), (8, 4096, 1, 0), (8, 4096, 1, 1),
    (16384, 64, 0, 3), (2, 65536, 1, 3),
    (37, 515, 0, 5), (37, 515, 1, 5), (1023, 130, 0, 3), (5, 4097, 1, 4),
    (33, 4097, 1, 8), (16, 16384, 1, 4))
# P7's shape: b rays, w columns, chunks.
CHUNK = (256, 512, 8)
# P7 data: the probe's own (all ones), seeded random data whose tests
# pass the mask, and edge data (`chunk_edge_inputs`): name -> seed (None:
# ones).
CHUNK_DATA = {"probe": None, "random": 7, "edge": 11}


def gather_inputs(rows: int, lanes: int, axis: int):
    """(x = arange f32[rows, lanes], idx i32[rows, lanes]) as the reference
    probe makes them."""
    x = np.arange(rows * lanes, dtype=np.float32).reshape(rows, lanes)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, rows if axis == 0 else lanes,
                       (rows, lanes)).astype(np.int32)
    return x, idx


def gather_random_inputs(rows: int, lanes: int, axis: int, seed: int = 0):
    """(x f32[rows, lanes] from a normal distribution, so that no partial
    sum is exact in another order, idx i32[rows, lanes] in [-3 size,
    3 size)): the floor modulo's negative and wrapped cases."""
    rng = np.random.default_rng(seed)
    size = rows if axis == 0 else lanes
    x = rng.normal(size=(rows, lanes)).astype(np.float32)
    idx = rng.integers(-3 * size, 3 * size, (rows, lanes)).astype(np.int32)
    return x, idx


def gather_expected(x: np.ndarray, idx: np.ndarray, axis: int,
                    reps: int) -> np.ndarray:
    """The reference probe's own check (`probe_mosaic.py:69-73`)."""
    size = x.shape[axis]
    return sum(np.take_along_axis(x, (idx + i) % size, axis=axis)
               for i in range(reps))


def chunk_inputs(data: str):
    """(o f32[8, b], t f32[16, w]) of one of CHUNK_DATA's sets.  Random:
    o in [0.5, 1.5), t row 0 in [0.01, 0.2) and row 1 in [0.5, 5): det =
    px (e1 + 1) stays away from 0, and 38-94% of a chunk's tests pass the
    mask, varying with the chunk."""
    b, w, _ = CHUNK
    seed = CHUNK_DATA[data]
    if seed is None:
        return (np.ones((8, b), np.float32), np.ones((16, w), np.float32))
    if data == "edge":
        return chunk_edge_inputs(seed)
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.5, 1.5, (8, b)).astype(np.float32)
    t = rng.uniform(-1.0, 1.0, (16, w)).astype(np.float32)
    t[0] = rng.uniform(0.01, 0.2, w)
    t[1] = rng.uniform(0.5, 5.0, w)
    return o, t


def chunk_edge_inputs(seed: int):
    """(o f32[8, b], t f32[16, w]): the edges of P7's arithmetic.  o's row
    0 is positive for the first half of the rays, negative for the second
    (and 0, 1e10 and -1e10 at three rays); t's columns come in quarters:
      boundary: det at the last chunk falls from 1e-9 / 0.45 to 1e-9 / 1.55
        along the columns while e1 rises, so each negative ray's least tt
        is the first column whose det lies above 1e-9 (the other rays see
        det near -1e-9);
      huge: e1 from 1e36 to 3.2e38, so |det| reaches 2^126 (where 1 / det
        is subnormal and the branch-free reciprocal is not used) and
        overflows to inf; a positive ray's least tt is one of these;
      non-finite: +inf, -inf and NaN in t's rows 0 and 1;
      the random set's columns."""
    b, w, _ = CHUNK
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.5, 1.5, (8, b)).astype(np.float32)
    o[0, b // 2:] *= -1.0
    o[0, 0], o[0, 1], o[0, b // 2 + 1] = 0.0, 1e10, -1e10
    t = rng.uniform(-1.0, 1.0, (16, w)).astype(np.float32)
    q = w // 4
    t1 = 1e12 * np.geomspace(1.0, 4.0, q)
    t[1, :q] = t1
    t[0, :q] = -np.geomspace(1e-9 / 0.45, 1e-9 / 1.55, q) / (
        64 * 1.0001 ** 2) / t1
    t[0, q:2 * q] = rng.uniform(0.05, 0.15, q)
    t[1, q:2 * q] = 10 ** rng.uniform(36, 37.6, q)
    k = q // 8
    bad = t[:2, 2 * q:3 * q]
    bad[0, :k], bad[0, k:2 * k], bad[1, 2 * k:3 * k] = np.inf, -np.inf, np.nan
    bad[0, 3 * k:4 * k], bad[1, 4 * k:5 * k] = np.nan, np.inf
    bad[1, 5 * k:6 * k] = -np.inf
    t[0, 3 * q:] = rng.uniform(0.01, 0.2, w - 3 * q)
    t[1, 3 * q:] = rng.uniform(0.5, 5.0, w - 3 * q)
    return o, t


def plan_text(rows: int, lanes: int, axis: int, reps: int) -> str:
    """P5's plan at a call's shape, in words."""
    from ..ops import probes
    plan = probes.mosaic_gather_plan(rows, lanes, axis, reps)
    gx, gy = plan.grid(rows, lanes, axis)
    if plan.route == "direct":
        return f"direct, {gx} CTAs of {plan.threads}"
    slab = (f"{plan.tile} columns" if axis == 0 else f"{plan.tile} rows")
    return (f"slab of {slab} ({plan.slab_bytes(rows, lanes, axis)} B), "
            f"{gx} x {gy} CTAs of {plan.threads}, {plan.per} "
            f"{'rows' if axis == 0 else 'columns'} a CTA")


def probe_gather(case, device, iters: int) -> dict:
    import torch

    from ..ops import probes
    rows, lanes, axis, reps, case_iters = case
    x_np, idx_np = gather_inputs(rows, lanes, axis)
    x = torch.from_numpy(x_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    got = probes.mosaic_gather(x, idx, axis, reps).cpu().numpy()
    ok = bool((got == gather_expected(x_np, idx_np, axis, reps)).all())
    n = min(iters, case_iters)
    call = lambda: probes.mosaic_gather(x, idx, axis, reps)
    dev_us = device_us(call, n, "mosaic_gather_kernel", device)
    wrap = wrapper_us(call, n, device)
    rate = (f" ({rows * lanes * reps / dev_us / 1e3:.2f} G gathers/s)"
            if dev_us is not None else "")
    print(f"P5 gather axis={axis} [{rows},{lanes}] x{reps}: device "
          f"{_us(dev_us)}{rate}, wrapper {_us(wrap)} ok={ok} "
          f"({plan_text(rows, lanes, axis, reps)}) [{card_line(device)}]",
          flush=True)
    return {"ok": ok, "device_us": dev_us, "wrapper_us": wrap}


def probe_scalar_stack(device, iters: int) -> dict:
    import torch

    from ..ops import probes
    res = {}
    for data in STACK_DATA:
        boxes = torch.from_numpy(scalar_stack_boxes(data)).to(device)
        got = probes.mosaic_scalar_stack(boxes)
        visited = int(got[0])
        ok = bool(torch.equal(got.cpu(),
                              probes.mosaic_scalar_stack_plain(boxes.cpu())))
        call = lambda: probes.mosaic_scalar_stack(boxes)
        dev_us = device_us(call, iters, "mosaic_scalar_stack_kernel", device)
        wrap = wrapper_us(call, iters, device)
        print(f"P6 scalar_stack[{data}]: visited {visited} nodes, device "
              f"{_us(dev_us)}, wrapper {_us(wrap)} ok={ok} "
              f"[{card_line(device)}]", flush=True)
        res[data] = {"visited": visited, "ok": ok, "device_us": dev_us,
                     "wrapper_us": wrap}
    return res


def probe_chunk(device, iters: int) -> dict:
    import torch

    from ..ops import probes
    b, w, n_chunks = CHUNK
    res = {}
    for data in CHUNK_DATA:
        o_np, t_np = chunk_inputs(data)
        o = torch.from_numpy(o_np).to(device)
        t = torch.from_numpy(t_np).to(device)
        got = probes.chunk(o, t, n_chunks)
        want = probes.chunk_plain(o.cpu(), t.cpu(), n_chunks)
        ok = bool(torch.equal(got.cpu(), want))
        hits = int((want < 1e30).sum())
        call = lambda: probes.chunk(o, t, n_chunks)
        dev_us = device_us(call, iters, "mosaic_chunk_kernel", device)
        wrap = wrapper_us(call, iters, device)
        each = (f" ({dev_us / n_chunks:.3f} us/chunk)"
                if dev_us is not None else "")
        print(f"P7 chunk[{data}] [{b},{w}] x{n_chunks}: {hits} of {b} rays "
              f"hit, device {_us(dev_us)}{each}, wrapper {_us(wrap)} "
              f"ok={ok} [{card_line(device)}]", flush=True)
        res[data] = {"ok": ok, "hits": hits, "device_us": dev_us,
                     "wrapper_us": wrap}
    return res


def run(device, iters: int = 50) -> dict:
    """Every probe of the tool on `device`: {name: results}."""
    out = {f"gather_{r}x{l}_axis{a}": probe_gather(c, device, iters)
           for c in GATHER_CASES for r, l, a in (c[:3],)}
    out["scalar_stack"] = probe_scalar_stack(device, iters)
    out["chunk"] = probe_chunk(device, iters)
    return out


def all_ok(results: dict) -> bool:
    return all(r["ok"] for res in results.values()
               for r in (res.values() if "ok" not in res else (res,)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbr-probe-mosaic-torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu: plain versions, "
                        "no times)")
    p.add_argument("--iters", type=int, default=50)
    args = p.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    print(f"--- probe_mosaic on {card_line(device)}", flush=True)
    return 0 if all_ok(run(device, args.iters)) else 1


if __name__ == "__main__":
    sys.exit(main())
