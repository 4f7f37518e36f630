"""Inverse rendering: optimise scene parameters against a target image
(port of `grad/inverse.py`).

`TrainableParams` selects the scene quantities to optimise; `apply_params`
grafts them into a Scene with the reference's physical clamps;
`make_train_step` builds the step: render (the dense estimator of
integrator/path.py, whose sampling decisions are detached) -> pixel loss ->
backward -> an optimizer step.  Vertex optimisation keeps the cluster grid
valid by refitting it every step (`_with_live_accel`).

Every bound on a value that carries gradient splits a tie's gradient in
half, as the reference's `clip`/`maximum` do (`core.math3d`): parameters
often sit exactly on a clamp (a non-emissive material's emission at 0, a
base colour at 1) and black pixels sit on the loss's bound.

Optimizers are `torch.optim` optimizers over the params' leaf tensors; the
step updates those leaves in place, and its `opt_state` slot carries the
optimizer's `state_dict()`.  With `mesh=` (a DeviceMesh with a `tiles`
axis, parallel/sharding.py) the step is `make_train_step_spmd`: one
process per rank, each rendering its row band, then one all-reduce of the
gradients.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d
from ..core import rng as rng_mod
from ..core.camera import Camera
from ..integrator.path import RenderConfig, render, render_band
from ..scene.types import Scene

FIELDS = ("base_color_factor", "roughness_factor", "metallic_factor",
          "emissive_factor", "texture_data", "env_data", "vertex_positions")


@dataclasses.dataclass
class TrainableParams:
    """Optimisable subset of the scene; None = frozen."""

    base_color_factor: torch.Tensor | None = None   # f32[M, 4]
    roughness_factor: torch.Tensor | None = None    # f32[M]
    metallic_factor: torch.Tensor | None = None     # f32[M]
    emissive_factor: torch.Tensor | None = None     # f32[M, 3]
    texture_data: torch.Tensor | None = None        # f32[R, 4] texel arena
    env_data: torch.Tensor | None = None            # f32[EH, EW, 3]
    vertex_positions: torch.Tensor | None = None    # f32[V, 3]

    @classmethod
    def from_scene(cls, scene: Scene, *, base_color=False, roughness=False,
                   metallic=False, emissive=False, textures=False,
                   env=False, vertices=False) -> "TrainableParams":
        m = scene.materials
        return cls(
            base_color_factor=m.base_color_factor if base_color else None,
            roughness_factor=m.roughness_factor if roughness else None,
            metallic_factor=m.metallic_factor if metallic else None,
            emissive_factor=m.emissive_factor if emissive else None,
            texture_data=scene.textures.texels if textures else None,
            env_data=(scene.env.data if (env and scene.env is not None)
                      else None),
            vertex_positions=scene.geometry.positions if vertices else None,
        )

    def items(self):
        """(field name, tensor) of the trained fields, in field order."""
        return [(f, getattr(self, f)) for f in FIELDS
                if getattr(self, f) is not None]

    def leaves(self) -> list[torch.Tensor]:
        return [v for _, v in self.items()]

    def map(self, fn) -> "TrainableParams":
        """A copy with fn applied to every trained field."""
        return dataclasses.replace(self, **{k: fn(v) for k, v in self.items()})


def apply_params(scene: Scene, p: TrainableParams) -> Scene:
    """Graft trainable parameters into the scene (with physical clamps)."""
    mats = {}
    if p.base_color_factor is not None:
        mats["base_color_factor"] = math3d.clip(p.base_color_factor, 0.0, 1.0)
    if p.roughness_factor is not None:
        mats["roughness_factor"] = math3d.clip(p.roughness_factor, 0.0, 1.0)
    if p.metallic_factor is not None:
        mats["metallic_factor"] = math3d.clip(p.metallic_factor, 0.0, 1.0)
    if p.emissive_factor is not None:
        mats["emissive_factor"] = math3d.maximum(p.emissive_factor, 0.0)
    if mats:
        scene = dataclasses.replace(
            scene, materials=dataclasses.replace(scene.materials, **mats))
    if p.texture_data is not None:
        scene = dataclasses.replace(scene, textures=dataclasses.replace(
            scene.textures, texels=math3d.maximum(p.texture_data, 0.0)))
    if p.env_data is not None:
        scene = dataclasses.replace(scene, env=dataclasses.replace(
            scene.env, data=math3d.maximum(p.env_data, 0.0)))
    if p.vertex_positions is not None:
        scene = dataclasses.replace(scene, geometry=dataclasses.replace(
            scene.geometry, positions=p.vertex_positions))
    return scene


def pixel_loss(hdr: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Log-space L2, stable under HDR range and Monte Carlo noise."""
    d = (torch.log1p(math3d.maximum(hdr, 0.0))
         - torch.log1p(math3d.maximum(target, 0.0)))
    return torch.mean(d * d)


def pixel_loss_grad(img: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """d pixel_loss / d img at the detached image (the edge term's dL/dI)."""
    img = img.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(pixel_loss(img, target), img)
    return g


def _with_live_accel(scene: Scene, params: TrainableParams) -> Scene:
    """Keep acceleration structures valid under vertex optimisation: the
    cluster grid refits its boxes and soup from the current (detached)
    positions every step; the BVH is dropped, as the reference drops it
    (its refit is a host loop), so tracing falls to the next tracer of the
    dispatch.  No-op when vertices are frozen."""
    if params.vertex_positions is None:
        return scene
    if scene.clusters is not None:
        from ..accel.clusters import refit_clusters
        scene = dataclasses.replace(
            scene, clusters=refit_clusters(scene.clusters, scene.geometry))
    if scene.bvh is not None:
        scene = dataclasses.replace(scene, bvh=None)
    return scene


def make_train_step(scene: Scene, camera: Camera, cfg: RenderConfig,
                    optimizer: torch.optim.Optimizer, mesh=None, edges=None,
                    edge_samples: int = 1024):
    """step(params, opt_state, key, target) -> (params, opt_state, loss).

    `optimizer` holds the leaf tensors of `params` (`params.leaves()`);
    the step updates them in place and returns the same `params`, the
    optimizer's `state_dict()` and the loss (a 0-dim tensor).  An
    `opt_state` that is not the one the step last returned (a restored
    checkpoint's) is loaded into the optimizer first.

    `edges` (grad.edge.EdgeTable) adds the primary-visibility boundary
    gradient for vertex optimisation (silhouette edge sampling).

    With `mesh`, the step is `make_train_step_spmd`.
    """
    if mesh is not None:
        return make_train_step_spmd(scene, camera, cfg, optimizer, mesh,
                                    edges=edges, edge_samples=edge_samples)
    last = {"state": None}

    def loss_fn(params: TrainableParams, key, target):
        s = _with_live_accel(apply_params(scene, params), params)
        if edges is None:
            return pixel_loss(render(s, camera, key, cfg).mean(), target)
        from .edge import edge_boundary_loss
        k_img, k_edge = rng_mod.split(key, 2)
        img = render(s, camera, k_img, cfg).mean()
        loss = pixel_loss(img, target)
        dl_di = pixel_loss_grad(img, target)
        return loss + edge_boundary_loss(s, camera, cfg, dl_di, k_edge,
                                         edges, n_samples=edge_samples)

    def step(params: TrainableParams, opt_state, key, target):
        if opt_state is not None and opt_state is not last["state"]:
            optimizer.load_state_dict(opt_state)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = loss_fn(params, key, target)
            loss.backward()
        optimizer.step()
        last["state"] = optimizer.state_dict()
        return params, last["state"], loss.detach()

    return step


def make_train_step_spmd(scene: Scene, camera: Camera, cfg: RenderConfig,
                         optimizer: torch.optim.Optimizer, mesh, edges=None,
                         edge_samples: int = 1024):
    """The sharded step over the mesh's `tiles` axis, one process a rank:
    step(params, opt_state, key, target[H, W, 3]) -> (params, opt_state,
    loss), with the contract of `make_train_step`.

    Each rank renders its row band over all spp (the same sample keys as
    the single-device step), takes the pixel loss of its band and runs
    backward.  Then the `.grad` of every trained leaf is all-reduced over
    the axis and divided by n (the global loss is the mean of the band
    losses, the bands being equal), the loss likewise, and every rank
    takes the same optimizer step, so the parameters stay equal.

    With `edges`: each band's dL/dI, divided by n, is all-gathered into
    the full image's; each rank draws max(edge_samples // n, 1) edge
    samples with the key `fold_in(k_edge, rank)`, and the boundary
    gradient rides the same all-reduce.

    The reduce happens once, on the gradients, after backward().  A
    differentiable all-reduce inside the loss
    (`torch.distributed.nn.functional.all_reduce`) would reduce again in
    its backward and scale every gradient by n, the bug the reference's
    implicit psum once had.
    """
    import torch.distributed as dist

    from ..parallel.sharding import (TILE_AXIS, _check_divisible, axis_size,
                                     gather_rows)

    n = axis_size(mesh, TILE_AXIS)
    _check_divisible(cfg.height, n)
    group = mesh.get_group(TILE_AXIS)
    rank = mesh.get_local_rank(TILE_AXIS)
    rows = cfg.height // n
    r0 = rank * rows
    last = {"state": None}

    def band_mean(s, key):
        return render_band(s, camera, rng_mod.split(key.to(s.device),
                                                    cfg.spp), cfg,
                           row_start=r0, n_rows=rows)[0].mean()

    def local_loss(params: TrainableParams, key, target_band):
        s = _with_live_accel(apply_params(scene, params), params)
        if edges is None:
            return pixel_loss(band_mean(s, key), target_band)
        from .edge import edge_boundary_loss
        k_img, k_edge = rng_mod.split(key, 2)
        band = band_mean(s, k_img)
        loss = pixel_loss(band, target_band)
        dl_di = gather_rows(pixel_loss_grad(band, target_band) / n, group)
        k_rank = rng_mod.fold_in(k_edge, rank)
        return loss + edge_boundary_loss(s, camera, cfg, dl_di, k_rank,
                                         edges,
                                         n_samples=max(edge_samples // n, 1))

    def step(params: TrainableParams, opt_state, key, target):
        if opt_state is not None and opt_state is not last["state"]:
            optimizer.load_state_dict(opt_state)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = local_loss(params, key, target[r0:r0 + rows])
            loss.backward()
        loss = loss.detach().clone()
        for leaf in params.leaves():
            if leaf.grad is None:
                leaf.grad = torch.zeros_like(leaf)
            dist.all_reduce(leaf.grad, group=group)
            leaf.grad.div_(n)
        dist.all_reduce(loss, group=group)
        loss.div_(n)
        optimizer.step()
        last["state"] = optimizer.state_dict()
        return params, last["state"], loss

    return step


def trainable_copy(params: TrainableParams) -> TrainableParams:
    """Fresh leaf tensors (decoupled from the scene's own) that require
    grad: what an optimizer takes."""
    return params.map(lambda x: x.detach().clone().requires_grad_(True))


def fit(scene: Scene, camera: Camera, target: torch.Tensor,
        params: TrainableParams, cfg: RenderConfig, *, steps: int = 100,
        lr: float = 5e-2, seed: int = 0, mesh=None, log_every: int = 10,
        callback=None, edges=None):
    """Run inverse rendering with Adam; returns (params, losses).

    `torch.optim.Adam(lr)` makes the update of the reference's
    `optax.adam(lr)`: b1 0.9, b2 0.999, eps 1e-8 added after the
    bias-corrected square root.  With `mesh`, every rank runs it and the
    steps are the sharded ones (make_train_step_spmd).
    """
    params = trainable_copy(params)
    opt = torch.optim.Adam(params.leaves(), lr=lr)
    step = make_train_step(scene, camera, cfg, opt, mesh=mesh, edges=edges)
    key = rng_mod.key(seed, scene.device)
    opt_state = None
    losses = []
    for i in range(steps):
        key, k = rng_mod.split(key, 2)
        params, opt_state, loss = step(params, opt_state, k, target)
        losses.append(float(loss))
        if callback is not None and (i % log_every == 0 or i == steps - 1):
            callback(i, losses[-1], params)
    return params, losses
