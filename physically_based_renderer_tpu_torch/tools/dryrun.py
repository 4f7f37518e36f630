"""Multi-rank dry run of the port (the counterpart of the reference's
`__graft_entry__.py::dryrun_multichip`): one step of each collective path
on tiny shapes, on every rank of a world of n ranks.

    python -m physically_based_renderer_tpu_torch.tools.dryrun --ranks 4 \
        --device cpu
    torchrun --nproc-per-node 4 -m \
        physically_based_renderer_tpu_torch.tools.dryrun --ranks 4

  1. the sharded train step (row bands, the gradient all-reduce, the same
     Adam step on every rank), which must move the parameters;
  2. the 2-D (tiles x spp) sharded render with the spp all-reduce, when n
     is even;
  3. a sharded render through the ring ray exchange on the block tracer.

Run plainly it starts the ranks itself (gloo with `--device cpu`, NCCL
with one GPU a rank on `cuda`; more ranks than GPUs exits 2); rank 0
prints one line.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import torch


def dryrun() -> dict:
    """The three paths on every rank of the initialized world; their
    loss and film means."""
    import torch.distributed as dist

    from ..core import rng
    from ..grad.inverse import TrainableParams, make_train_step, \
        trainable_copy
    from ..integrator.path import RenderConfig
    from ..parallel import distributed
    from ..parallel.sharding import (make_mesh, make_mesh_2d,
                                     render_sample_sharded,
                                     render_sharded_2d, replicate_scene)
    from ..utils import config

    n = dist.get_world_size()
    dev = distributed.rank_device()
    mesh = make_mesh()
    scene, camera = config.build_scene(config.get("cornell").scene, dev)
    scene = replicate_scene(scene, mesh)
    height = 8 * n
    cfg = RenderConfig(width=16, height=height, spp=1, max_bounces=1)

    # 1. the sharded train step
    params = trainable_copy(TrainableParams.from_scene(
        scene, base_color=True, emissive=True))
    opt = torch.optim.Adam(params.leaves(), lr=1e-2)
    target = torch.zeros((height, 16, 3), device=dev)
    step = make_train_step(scene, camera, cfg, opt, mesh=mesh)
    params, _, loss = step(params, None, rng.key(0, dev), target)
    loss = float(loss)
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    moved = float((params.base_color_factor.detach()
                   - scene.materials.base_color_factor).abs().max())
    if not moved > 0.0:
        raise AssertionError("the training step did not move the parameters")

    # 2. the 2-D (tiles x spp) render with the spp all-reduce
    m2 = float("nan")
    if n % 2 == 0:
        cfg2 = RenderConfig(width=16, height=8 * (n // 2), spp=2,
                            max_bounces=1)
        film = render_sharded_2d(scene, camera, rng.key(1, dev), cfg2,
                                 make_mesh_2d(n // 2, 2))
        m2 = float(film.mean().mean())
        if not (math.isfinite(m2) and m2 > 0.0):
            raise AssertionError(f"2-D sharded render: {m2}")

    # 3. the ring ray exchange through the block tracer's dispatch
    cfg3 = dataclasses.replace(cfg, tracer="pallas")
    band = render_sample_sharded(scene, camera, rng.key(2, dev), cfg3, mesh,
                                 exchange=True)
    m3 = float(band.mean())
    if not (math.isfinite(m3) and m3 > 0.0):
        raise AssertionError(f"exchange render: {m3}")
    return {"ranks": n, "loss": loss, "render2d": m2, "exchange": m3}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(prog="pbr-dryrun-torch", description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ranks", type=int, required=True)
    p.add_argument("--device", default="cuda",
                   help="cuda (NCCL, one GPU a rank) or cpu (gloo)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")

    from ..parallel import distributed
    rc = distributed.run_tiles(args.ranks, args.device, __spec__.name, argv)
    if rc is not None:
        return rc
    import torch.distributed as dist
    res = dryrun()
    if dist.get_rank() == 0:
        print(f"dryrun({res['ranks']}): loss={res['loss']:.6f} "
              f"render2d={res['render2d']:.6f} "
              f"exchange={res['exchange']:.6f} ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
