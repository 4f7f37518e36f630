"""Visibility (boundary) gradients by silhouette edge sampling (port of
`grad/edge.py`).

The detached-sampling estimator (integrator/path.py) differentiates only
the interior of the rendering equation: a silhouette moving across a
pixel changes which surface the pixel sees, a step whose derivative lives
on the edge.  This module adds that boundary term for PRIMARY visibility
by explicit edge sampling (after Li et al. 2018, pinhole and box filter):

  dI_j/dtheta = sum over silhouette edges of the integral along the edge of
                phi_j(s) * (L_minus(s) - L_plus(s)) * d(s . n_hat)/dtheta ds

with s(theta) the screen-space edge point (attached to the vertex positions
through the camera projection), n_hat its screen normal and L_plus/minus
the detached radiance just either side, from two offset probes per sample
(edges hidden behind other geometry self-cancel: both probes see the
occluder).  It is packaged as a zero-valued loss term whose gradient is
the boundary contribution: T - T.detach() with T = sum_k w_k (s_k . n_k).
Secondary (shadow, indirect) silhouettes are not covered, as in the
reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core import rng as rng_mod
from ..core.camera import Camera, generate_rays_at


@dataclasses.dataclass(frozen=True)
class EdgeTable:
    """Mesh edge adjacency (host-built)."""

    verts: torch.Tensor   # i32[E, 2] vertex ids (a < b)
    faces: torch.Tensor   # i32[E, 2] adjacent triangle ids (-1 = boundary)

    @property
    def num_edges(self) -> int:
        return self.verts.shape[0]

    def to(self, device) -> "EdgeTable":
        return EdgeTable(verts=self.verts.to(device),
                         faces=self.faces.to(device))


def build_edge_table(indices) -> EdgeTable:
    """Unique mesh edges and their (up to 2) adjacent triangles (numpy)."""
    if isinstance(indices, torch.Tensor):
        indices = indices.detach().cpu().numpy()
    indices = np.asarray(indices, np.int64)
    t = indices.shape[0]
    ea = indices[:, [0, 1, 2]].reshape(-1)
    eb = indices[:, [1, 2, 0]].reshape(-1)
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    key = lo * (indices.max() + 1) + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    tri_s = np.repeat(np.arange(t), 3)[order]
    uniq, start = np.unique(key_s, return_index=True)
    e = len(uniq)
    verts = np.stack([lo[order][start], hi[order][start]], axis=1)
    faces = np.full((e, 2), -1, np.int64)
    faces[:, 0] = tri_s[start]
    # second adjacent face (manifold edges have exactly two)
    second = np.minimum(start + 1, len(key_s) - 1)
    has2 = (start + 1 < len(key_s)) & (key_s[second] == uniq)
    faces[has2, 1] = tri_s[second[has2]]
    return EdgeTable(verts=torch.from_numpy(verts.astype(np.int32)),
                     faces=torch.from_numpy(faces.astype(np.int32)))


def _project(camera: Camera, x: torch.Tensor, width: int, height: int):
    """World points -> continuous pixel coords (attached) and the forward
    depth (for behind-camera rejection); the inverse of
    core.camera.generate_rays_at's NDC mapping."""
    right, up, fwd = camera.basis()
    v = x - camera.position
    a_f = torch.sum(v * fwd, dim=-1)
    a_r = torch.sum(v * right, dim=-1)
    a_u = torch.sum(v * up, dim=-1)
    aspect = width / height
    tan_half = torch.tan(camera.fov_y / 2.0)
    safe_f = torch.where(a_f.abs() > 1e-8, a_f, 1e-8)
    ndc_x = a_r / safe_f
    ndc_y = a_u / safe_f
    px = (ndc_x / (aspect * tan_half) + 1.0) * (width * 0.5)
    py = (ndc_y / tan_half + 1.0) * (height * 0.5)
    return px, py, a_f


def _detached(obj):
    """A copy of a record tree (Scene and its records) with every tensor
    detached."""
    if isinstance(obj, torch.Tensor):
        return obj.detach()
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _detached(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def edge_boundary_loss(scene, camera: Camera, cfg, dl_di: torch.Tensor,
                       key: torch.Tensor, edges: EdgeTable,
                       n_samples: int = 1024,
                       eps_px: float = 0.5) -> torch.Tensor:
    """Zero-valued loss term carrying the primary-visibility boundary
    gradient into scene.geometry.positions.

    dl_di f32[H, W, 3]: gradient of the pixel loss with respect to the
    rendered mean HDR image, at the detached image.
    """
    from ..integrator.path import trace_radiance

    dev = scene.device
    edges = edges.to(dev)
    g = scene.geometry
    p = g.positions                                   # ATTACHED
    h_img, w_img = cfg.height, cfg.width
    ev = edges.verts.long()
    va = p[ev[:, 0]]                                  # [E, 3]
    vb = p[ev[:, 1]]

    # --- silhouette classification (detached) ---------------------------
    idx = g.indices.long()
    f0 = torch.clamp_min(edges.faces[:, 0], 0).long()
    f1 = torch.clamp_min(edges.faces[:, 1], 0).long()
    p_d = p.detach()

    def face_front(f):
        tri = idx[f]
        a = p_d[tri[:, 0]]
        n = torch.linalg.cross(p_d[tri[:, 1]] - a, p_d[tri[:, 2]] - a,
                               dim=-1)
        to_cam = camera.position - a
        return torch.sum(n * to_cam, dim=-1) > 0.0

    front0 = face_front(f0)
    front1 = face_front(f1)
    boundary = edges.faces[:, 1] < 0
    silhouette = torch.where(boundary, front0, front0 != front1)

    pax, pay, fa = _project(camera, va.detach(), w_img, h_img)
    pbx, pby, fb = _project(camera, vb.detach(), w_img, h_img)
    visible = (fa > camera.znear) & (fb > camera.znear)
    chord = torch.sqrt((pbx - pax) ** 2 + (pby - pay) ** 2)
    weight = torch.where(silhouette & visible, chord, 0.0)      # [E]

    total = torch.sum(weight)
    pdf_e = weight / torch.clamp_min(total, 1e-12)
    cdf = torch.cumsum(pdf_e, dim=0)

    # --- sample edge points --------------------------------------------
    k1, k2, k3 = rng_mod.split(key.to(dev), 3)
    u_e = rng_mod.uniform(k1, (n_samples,))
    u_t = rng_mod.uniform(k2, (n_samples,))
    # O(K log E) pick (a dense [K, E] compare would not fit a large mesh).
    e_idx = torch.searchsorted(cdf, u_e, right=False)
    e_idx = torch.clamp(e_idx, 0, edges.num_edges - 1)

    a = va[e_idx]                                     # [K, 3] attached
    b = vb[e_idx]
    t3 = u_t[:, None]
    x_e = (1.0 - t3) * a + t3 * b                     # attached 3D point
    sx, sy, sf = _project(camera, x_e, w_img, h_img)  # attached screen pt

    # screen tangent ds/dt' (detached): central difference in parameter
    # space of proj((1 - t) a + t b).
    a_d, b_d = a.detach(), b.detach()
    dt = 1e-3
    xp_, yp_, _ = _project(camera, (1 - (u_t + dt))[:, None] * a_d
                           + (u_t + dt)[:, None] * b_d, w_img, h_img)
    xm_, ym_, _ = _project(camera, (1 - (u_t - dt))[:, None] * a_d
                           + (u_t - dt)[:, None] * b_d, w_img, h_img)
    tx = (xp_ - xm_) / (2 * dt)
    ty = (yp_ - ym_) / (2 * dt)
    ds_dt = torch.sqrt(tx * tx + ty * ty)             # [K] px per unit t'
    inv_len = 1.0 / torch.clamp_min(ds_dt, 1e-12)
    nx = -ty * inv_len                                # screen normal (unit)
    ny = tx * inv_len

    # --- radiance probes either side (detached) -------------------------
    sx_d, sy_d = sx.detach(), sy.detach()
    px_p = sx_d + eps_px * nx
    py_p = sy_d + eps_px * ny
    px_m = sx_d - eps_px * nx
    py_m = sy_d - eps_px * ny
    zeros2 = torch.zeros((n_samples, 2), dtype=torch.float32, device=dev)
    o_p, d_p = generate_rays_at(camera, w_img, h_img, px_p, py_p, zeros2)
    o_m, d_m = generate_rays_at(camera, w_img, h_img, px_m, py_m, zeros2)
    probe_keys = rng_mod.ray_keys(
        k3, torch.arange(2 * n_samples, dtype=torch.int64, device=dev))
    with torch.no_grad():
        radiance = trace_radiance(_detached(scene),
                                  torch.cat([o_p, o_m]),
                                  torch.cat([d_p, d_m]), probe_keys, cfg)
    l_plus = radiance[:n_samples]
    l_minus = radiance[n_samples:]

    # --- assemble the gradient-carrying term ----------------------------
    ix = torch.clamp(sx_d.to(torch.int32), 0, w_img - 1).long()
    iy = torch.clamp(sy_d.to(torch.int32), 0, h_img - 1).long()
    dl = dl_di.detach()[iy, ix]                       # [K, 3]
    dl_rgb = torch.sum(dl * (l_minus - l_plus), dim=-1)  # [K]
    # MC weight: edge e picked with pdf_e, t' uniform; measure conversion
    # |ds/dt'| / (chord-based pdf).  The in-pixel box filter is 1 in pixel
    # units (the image is the per-pixel mean).
    pick_chord = torch.clamp_min(chord[e_idx], 1e-12)
    w_mc = dl_rgb * ds_dt * total / (pick_chord * n_samples)
    # Off-screen samples contribute zero: their box filter is zero for
    # every pixel.
    on_screen = ((sx_d >= 0.0) & (sx_d < w_img)
                 & (sy_d >= 0.0) & (sy_d < h_img))
    valid = (weight[e_idx] > 0.0) & (sf.detach() > camera.znear) & on_screen
    w_mc = torch.where(valid, w_mc, 0.0)

    s_n = sx * nx + sy * ny                           # attached normal coord
    term = torch.sum(w_mc.detach() * s_n)
    return term - term.detach()
