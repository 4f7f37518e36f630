"""CLI renderer (port of `apps/render.py`).

    python -m physically_based_renderer_tpu_torch.apps.render SCENE \
        -o out.png --stats --device cuda

SCENE is a named config (triangle, cornell, cornell_ggx, cornell_tex256,
helmet, helmet_proc) or a path to a .gltf/.glb file, which is read by
scene/gltf.py, gets the cluster grid and renders with the default
`RenderConfig` from the file's camera; a file that cannot be read prints
`error: ...` and returns 2.  The frame is rendered with
`render_with_stats` (on a CUDA device, one launch of the fused kernel K4
for the scenes it takes: `triangle`, `cornell`, `cornell_ggx`), tonemapped
with K3 (`ops/tonemap.py`) and written as a PNG.  `--stats` prints one JSON
line to stderr: ray queries, seconds (host clock around the render,
synchronized), rays/s, and the device it ran on.

`--tiles N` shards the image rows over N ranks, one device a rank
(parallel/sharding.py `render_sharded_with_stats`: the dense estimator,
never K4, as in the reference; the ray count summed over the ranks).
Under `torchrun --nproc-per-node N` each process is a rank; run plainly,
the CLI starts N local ranks itself (gloo with `--device cpu`, NCCL with
one GPU a rank on `cuda`; more ranks than GPUs exits 2).  Rank 0 writes
the outputs.  `--blinn-phong` and `--debug-checks` are not ported yet and
raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbr-render-torch",
        description="PyTorch/CUDA path tracer (headless renderer)")
    p.add_argument("scene", help=".gltf/.glb path or builtin config name")
    p.add_argument("-o", "--output", default="out.png", help="output PNG")
    p.add_argument("--hdr-output", default=None,
                   help="also dump linear HDR radiance as .npy")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--bounces", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--no-mis", action="store_true")
    p.add_argument("--blinn-phong", action="store_true",
                   help="reference-parity headlight shading (not ported)")
    p.add_argument("--debug-checks", action="store_true",
                   help="NaN/Inf/OOB checks (not ported)")
    p.add_argument("--tiles", type=int, default=0,
                   help="shard rows over N ranks, one device a rank")
    p.add_argument("--stats", action="store_true",
                   help="print rays/s JSON to stderr")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (cuda, cuda:1, cpu)")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    for flag, on in (("--blinn-phong", args.blinn_phong),
                     ("--debug-checks", args.debug_checks)):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet")

    import numpy as np
    import torch

    from ..core import film as film_mod
    from ..core import rng
    from ..integrator.path import RenderConfig, render_with_stats
    from ..ops.tonemap import tonemap
    from ..utils import config as config_mod

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    mesh = None
    if args.tiles:
        from ..parallel import distributed, sharding
        rc = distributed.run_tiles(args.tiles, args.device, __spec__.name,
                                   argv)
        if rc is not None:
            return rc
        mesh = sharding.make_mesh(args.tiles)
        device = distributed.rank_device()
    if args.scene in config_mod.CONFIGS:
        bc = config_mod.get(args.scene)
        scene, camera = config_mod.build_scene(bc.scene, device)
        rcfg = bc.render
    else:
        from ..scene.gltf import GltfError
        spec = config_mod.SceneSpec(builder="gltf",
                                    extra={"path": args.scene})
        try:
            scene, camera = config_mod.build_scene(spec, device)
        except GltfError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        rcfg = RenderConfig()

    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["spp"] = args.spp
    if args.bounces is not None:
        overrides["max_bounces"] = args.bounces
    if args.no_nee:
        overrides["nee"] = False
    if args.no_mis:
        overrides["mis"] = False
    rcfg = dataclasses.replace(rcfg, **overrides)
    if mesh is not None:
        scene = sharding.replicate_scene(scene, mesh)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    key = rng.key(args.seed, device)
    if mesh is None:
        film, count = render_with_stats(scene, camera, key, rcfg)
    else:
        film, count = sharding.render_sharded_with_stats(scene, camera, key,
                                                         rcfg, mesh)
    hdr = film.mean()
    sync()
    dt = time.perf_counter() - t0
    rays = int(count)
    if mesh is not None and mesh.get_rank() != 0:
        return 0

    ldr = tonemap(hdr.contiguous())
    film_mod.write_png(args.output, ldr)
    if args.hdr_output:
        np.save(args.hdr_output, hdr.cpu().numpy())
    print(f"wrote {args.output} ({rcfg.width}x{rcfg.height}, "
          f"{rcfg.spp} spp, {dt:.3f}s"
          f"{f', {args.tiles} tiles' if mesh is not None else ''})")
    if args.stats:
        dev_name = (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu")
        print(json.dumps({"rays": rays, "seconds": dt,
                          "rays_per_s": rays / dt, "device": dev_name,
                          "tiles": args.tiles or 1}),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
