"""Inverse-rendering CLI (port of `apps/inverse.py`).

Renders a ground-truth target from a builtin config, perturbs the chosen
parameters and recovers them by pixel-loss gradient descent (Adam), with
periodic checkpoints:

    python -m physically_based_renderer_tpu_torch.apps.inverse \
        --params base_color,emissive --steps 200 --device cuda \
        --checkpoint-dir ckpt --report report.json

Prints a JSON report: the reference's keys plus `seconds_per_step` (host
clock per step after the first, each step ending in a device sync when
its loss is read), `start_step`, and `initial_error_applied` /
`final_error_applied`, the errors of the clamped values the scene renders.
`--scene` also takes a path to a .gltf/.glb file (read by scene/gltf.py,
rendered from the file's camera, no cluster grid, as in the reference).
`--tiles` (sharded steps) is not ported yet and raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import time

log = logging.getLogger(__name__)

# Fields apply_params clips to [0, 1]; the others (but vertices) it bounds
# below by 0.
_CLIPPED = ("base_color_factor", "roughness_factor", "metallic_factor")


def build_parser():
    p = argparse.ArgumentParser(prog="pbr-inverse-torch")
    p.add_argument("--scene", default="cornell",
                   help="builtin config name or .glb path")
    p.add_argument("--params", default="base_color,emissive",
                   help="comma list: base_color,roughness,metallic,"
                        "emissive,textures,env,vertices")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=5e-2)
    p.add_argument("--spp", type=int, default=2)
    p.add_argument("--target-spp", type=int, default=None,
                   help="spp for the ground-truth target (default 8x spp)")
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--bounces", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiles", type=int, default=0,
                   help="shard rows over N devices (not ported)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--report", default=None, help="write JSON report")
    p.add_argument("--perturb-scale", type=float, default=0.5)
    p.add_argument("--edge-gradients", action="store_true",
                   help="add the primary-visibility boundary term via "
                        "silhouette edge sampling (grad/edge.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:1, cpu)")
    return p


def _perturb(true_params, seed: int, scale: float, device):
    """The reference's perturbation, draw for draw: per trained field in
    field order, split the key and scale by (1 + u) plus 0.1 u, with u
    uniform in [-scale, scale), clipped at 0."""
    import torch

    from ..core import rng
    k = rng.key(seed + 1, device)

    def perturb(x):
        nonlocal k
        k, sub = rng.split(k, 2)
        lo = torch.tensor(-scale, dtype=torch.float32)
        hi = torch.tensor(scale, dtype=torch.float32)
        u = rng.uniform(sub, tuple(x.shape))
        noise = torch.maximum(u * (hi - lo) + lo, lo)
        return torch.clamp_min(x * (1.0 + noise) + 0.1 * noise, 0.0)

    return true_params.map(perturb)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tiles:
        raise NotImplementedError("--tiles (the sharded train step) is not "
                                  "ported yet (ROADMAP.md section 1, item 7:"
                                  " parallel/)")

    import numpy as np
    import torch

    from ..core import rng
    from ..grad.inverse import (TrainableParams, make_train_step,
                                trainable_copy)
    from ..integrator.path import RenderConfig, render
    from ..utils import checkpoint as ckpt_mod
    from ..utils import config as config_mod

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: CUDA is not available")
    if args.scene in config_mod.CONFIGS:
        scene, camera = config_mod.build_scene(
            config_mod.get(args.scene).scene, device)
    else:
        from ..scene import gltf as gltf_mod
        from ..scene.types import upload_scene
        scene, _, camera = gltf_mod.load(args.scene)
        scene = upload_scene(scene, device)
        camera = upload_scene(camera, device)
    cfg = RenderConfig(width=args.size, height=args.size, spp=args.spp,
                       max_bounces=args.bounces)

    # Ground truth from the unperturbed scene at 8x spp (at 1-2 spp the
    # pixel loss is dominated by Monte Carlo noise).
    tspp = args.target_spp or max(8, args.spp * 8)
    with torch.no_grad():
        target = render(scene, camera, rng.key(9999, device),
                        dataclasses.replace(cfg, spp=tspp)).mean()
    log.info("target rendered (%dx%d @ %d spp)", args.size, args.size, tspp)

    sel = {k.strip() for k in args.params.split(",") if k.strip()}
    true_params = TrainableParams.from_scene(
        scene,
        base_color="base_color" in sel, roughness="roughness" in sel,
        metallic="metallic" in sel, emissive="emissive" in sel,
        textures="textures" in sel, env="env" in sel,
        vertices="vertices" in sel)
    params = _perturb(true_params, args.seed, args.perturb_scale, device)
    if params.base_color_factor is not None:
        # alpha is unused by the opaque BSDF: keep it fixed (no gradient
        # would ever correct a perturbation there)
        bc = params.base_color_factor.clone()
        bc[..., 3] = true_params.base_color_factor[..., 3]
        params = dataclasses.replace(params, base_color_factor=bc)
    init_params = params.map(lambda x: x.detach().clone())
    params = trainable_copy(params)

    opt = torch.optim.Adam(params.leaves(), lr=args.lr)
    edges = None
    if args.edge_gradients:
        from ..grad.edge import build_edge_table
        edges = build_edge_table(scene.geometry.indices)
        log.info("edge gradients on: %d mesh edges", edges.num_edges)
    step_fn = make_train_step(scene, camera, cfg, opt, edges=edges)

    start, opt_state = 0, None
    if args.resume and args.checkpoint_dir:
        try:
            start, payload = ckpt_mod.restore(args.checkpoint_dir)
        except FileNotFoundError:
            pass
        else:
            with torch.no_grad():
                for name, leaf in params.items():
                    leaf.copy_(payload["params"][name])
            opt_state = payload["opt_state"]
            log.info("resumed from step %d", start)

    key = rng.key(args.seed, device)
    losses, step_seconds = [], []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        ts = time.perf_counter()
        key, sub = rng.split(key, 2)
        params, opt_state, loss = step_fn(params, opt_state, sub, target)
        losses.append(float(loss))              # waits for the device
        step_seconds.append(time.perf_counter() - ts)
        if i % 10 == 0 or i == args.steps - 1:
            log.info("step %d loss %.6f", i, losses[-1])
        if (args.checkpoint_dir and args.checkpoint_every
                and (i + 1) % args.checkpoint_every == 0):
            ckpt_mod.save(args.checkpoint_dir, i + 1, params, opt_state)
    dt = time.perf_counter() - t0

    # Recovery error against the ground truth (mean abs, relative to the
    # field's scale).  Mean, not max: components the image does not
    # constrain (alpha, unseen materials) get no gradient.  `applied`
    # measures the values the scene renders, after apply_params' clamps:
    # Adam carries a parameter past its clamp, where the loss no longer
    # sees it, so the raw error can grow while the rendered one falls.
    def field_errors(p, applied=False):
        errs = {}
        for field, t in true_params.items():
            r = getattr(p, field).detach()
            if applied and field in _CLIPPED:
                r = r.clamp(0.0, 1.0)
            elif applied and field != "vertex_positions":
                r = r.clamp_min(0.0)
            t = t.detach().cpu().numpy()
            r = r.cpu().numpy()
            if field == "base_color_factor":
                t, r = t[..., :3], r[..., :3]  # alpha is unused
            denom = float(np.abs(t).mean()) or 1.0
            errs[field] = float(np.abs(r - t).mean()) / denom
        return errs

    warm = step_seconds[1:] or step_seconds
    report = {"steps": args.steps, "seconds": dt,
              "final_loss": losses[-1] if losses else None,
              "initial_loss": losses[0] if losses else None,
              "initial_error": field_errors(init_params),
              "final_error": field_errors(params),
              "initial_error_applied": field_errors(init_params, True),
              "final_error_applied": field_errors(params, True),
              "seconds_per_step": (sum(warm) / len(warm)) if warm else None,
              "start_step": start,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")}
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump({**report, "losses": losses,
                       "step_seconds": step_seconds}, f)
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    raise SystemExit(main())
