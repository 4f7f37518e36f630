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
optimizer's `state_dict()`.  The sharded step (`mesh=`) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d
from ..core import rng as rng_mod
from ..core.camera import Camera
from ..integrator.path import RenderConfig, render
from ..scene.types import Scene

FIELDS = ("base_color_factor", "roughness_factor", "metallic_factor",
          "emissive_factor", "texture_data", "env_data", "vertex_positions")

_SHARDED = ("the sharded train step (mesh=) is not ported yet (ROADMAP.md "
            "section 1, item 7: parallel/)")


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
    """Keep the cluster grid valid under vertex optimisation: refit its
    boxes and soup from the current (detached) positions.  The port's Scene
    carries no BVH, so there is none to drop.  No-op when vertices are
    frozen."""
    if params.vertex_positions is None or scene.clusters is None:
        return scene
    from ..accel.clusters import refit_clusters
    return dataclasses.replace(
        scene, clusters=refit_clusters(scene.clusters, scene.geometry))


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
    """
    if mesh is not None:
        raise NotImplementedError(_SHARDED)
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


def make_train_step_spmd(*args, **kwargs):
    """The explicit-SPMD step of the reference: not ported yet."""
    raise NotImplementedError(_SHARDED)


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
    bias-corrected square root.
    """
    if mesh is not None:
        raise NotImplementedError(_SHARDED)
    params = trainable_copy(params)
    opt = torch.optim.Adam(params.leaves(), lr=lr)
    step = make_train_step(scene, camera, cfg, opt, edges=edges)
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
