"""Copies of 2 KB tiles picked by an index list, summed (port of the
reference repository's `tools/exp_subtile_dma.py`): P8.

    python -m physically_based_renderer_tpu_torch.tools.exp_subtile_dma \
        [--device cuda] [--iters 20] [--seed 0]

src f32[4096, 16, 32] and idx i32[1024 x 8 x 4] are drawn from
`np.random.default_rng(seed)`: the reference drew them unseeded, at import.
For each of NB = 1024 blocks and NI = 8 steps, CH = 4 tiles are picked;
the output f32[1024, 1, 128] holds each block's sums over the steps and
the tiles' 16 rows.  The reference copied the tiles into one of two VMEM
slots while the other was summed; the kernel takes
`ops/probes.py::subtile_copy_route`'s route (here each tile's rows summed
once, then gathered; the direct route streams every copy through shared
memory), named on the line.  The result is held to the reference's host
check (`:70-79`, here for every block, not only block 0) within its rtol
of 1e-5, and to the plain version bit for bit.  The line gives the device
time per call over all of its kernels (torch.profiler), the wrapper's time
per call (CUDA events), the rate over all 32,768 copies of 2 KB, and the
card's name and power limit; `--device cpu` runs the plain version and
prints no times.  Nothing runs at import.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .probe2 import card_line, device_us, wrapper_us, _us

C, NB, NI, CH = 4096, 1024, 8, 4
TILE_BYTES = 16 * 32 * 4
REF_RTOL = 1e-5      # the reference's own check


def inputs(seed: int = 0, nb: int = NB):
    """(src f32[C, 16, 32], idx i32[nb * NI * CH]) from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    src = rng.random((C, 16, 32), dtype=np.float32)
    idx = rng.integers(0, C, nb * NI * CH).astype(np.int32)
    return src, idx


def expected(src: np.ndarray, idx: np.ndarray, nb: int) -> np.ndarray:
    """The reference's host check for every block -> f32[nb, CH * 32]."""
    idx_h = idx.reshape(nb, NI, CH)
    out = np.zeros((nb, CH * 32), np.float32)
    for j in range(NI):
        for i in range(CH):
            out[:, i * 32:(i + 1) * 32] += src[idx_h[:, j, i]].sum(axis=1)
    return out


def run(device, iters: int = 20, seed: int = 0, nb: int = NB) -> dict:
    import torch

    from ..ops import probes
    src_np, idx_np = inputs(seed, nb)
    src = torch.from_numpy(src_np).to(device)
    idx = torch.from_numpy(idx_np).to(device)
    got = probes.subtile_copy(src, idx, NI, CH)
    o = got.cpu().numpy()[:, 0, :]
    ok_ref = bool(np.allclose(o, expected(src_np, idx_np, nb),
                              rtol=REF_RTOL))
    plain = probes.subtile_copy_plain(src.cpu(), idx.cpu(), NI, CH)
    same = probes.same_bits(got.cpu(), plain)
    ok = ok_ref and same
    call = lambda: probes.subtile_copy(src, idx, NI, CH)
    dev_us = device_us(call, iters, "subtile_copy_kernel", device)
    wrap = wrapper_us(call, iters, device)
    n_bytes = nb * NI * CH * TILE_BYTES
    rate = (f" ({n_bytes / dev_us / 1e3:.1f} GB/s)" if dev_us is not None
            else "")
    route = probes.subtile_copy_route(C, nb * NI * CH)
    print(f"P8 subtile copy {nb}x{NI}x{CH} copies of 2KB ({route}): device "
          f"{_us(dev_us)}{rate}, wrapper {_us(wrap)}, reference check "
          f"{ok_ref}, bit-equal to plain {same} ok={ok} "
          f"[{card_line(device)}]", flush=True)
    return {"ok": ok, "reference_check": ok_ref, "equal_plain": same,
            "route": route, "device_us": dev_us, "wrapper_us": wrap}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pbr-subtile-dma-torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:1, cpu: plain version, "
                        "no times)")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    print(f"--- exp_subtile_dma on {card_line(device)}", flush=True)
    return 0 if run(device, args.iters, args.seed)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
