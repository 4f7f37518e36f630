"""Headlight Blinn-Phong debug shading (port of `models/blinn_phong.py`).

The reference engine's deferred lighting pass, with the light at the
camera:

    V = L = normalize(camera position - P),  H = normalize(V + L) = V
    out = albedo * max(N.V, 0) + max(N.H, 0) ** 64

`render_blinn_phong` casts one ray through each pixel centre, finds the
closest hit with the brute-force tracer (t_min = 0), shades it with
`shade_surface` (level-0 texture fetches, K5a on the card) and lights it;
misses are black.  The HDR result goes through the usual tonemap.  The
brute-force tracer's temporaries are [rays, chunk, 3]: the chunk is cut so
that a pass holds at most BRUTE_PAIRS ray-triangle pairs.  The winner does
not depend on the chunk (the first of equal t wins within a chunk and
across chunks alike).
"""

from __future__ import annotations

import torch

from ..core import math3d
from ..core.camera import Camera, generate_rays_flat
from ..integrator.shading import shade_surface
from ..ops.intersect import intersect_brute
from ..scene.types import Scene

BRUTE_CHUNK = 1024        # the reference's triangles a brute-force pass
BRUTE_PAIRS = 1 << 26     # ray-triangle pairs a pass (~0.8 GB a temporary)


def blinn_phong_lighting(albedo: torch.Tensor, n: torch.Tensor,
                         v: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """Blinn-Phong with a white light, over [N, 3] rows."""
    ndv = math3d.maximum(torch.sum(n * v, dim=-1, keepdim=True), 0.0)
    h = math3d.normalize(v + l)
    ndh = math3d.maximum(torch.sum(n * h, dim=-1, keepdim=True), 0.0)
    return albedo * ndv + ndh ** 64


def brute_chunk(n_rays: int) -> int:
    """Triangles a brute-force pass over n_rays rays: the reference's 1024,
    cut to keep a pass within BRUTE_PAIRS pairs."""
    return max(1, min(BRUTE_CHUNK, BRUTE_PAIRS // max(n_rays, 1)))


def render_blinn_phong(scene: Scene, camera: Camera, width: int,
                       height: int) -> torch.Tensor:
    """Primary-visibility headlight render -> HDR [H, W, 3] on the scene's
    device."""
    o, d = generate_rays_flat(camera, width, height)
    v0, v1, v2 = scene.geometry.tri_vertices()
    hit = intersect_brute(o, d, v0, v1, v2, t_min=0.0,
                          chunk=brute_chunk(o.shape[0]))
    sp = shade_surface(scene, hit, o, d)
    v = math3d.normalize(camera.position.expand(sp.pos.shape) - sp.pos)
    rgb = blinn_phong_lighting(sp.bsdf.base_color, sp.ns, v, v)
    rgb = torch.where(hit.miss[:, None], 0.0, rgb)
    return rgb.reshape(height, width, 3)
