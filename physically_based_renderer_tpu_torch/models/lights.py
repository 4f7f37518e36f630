"""Light models + next-event-estimation sampling (port of `models/lights.py`).

Area emitters (emissive triangles), the directional light and the
equirect environment map.  Samplers return solid-angle pdfs so the
integrator can MIS them against BSDF sampling; the caller supplies the
uniforms (core/rng.py keying).  On a scene with emissive textures the
area-light sample carries factor x texture at the sampled point, as the
emitter-hit path sees it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core import math3d
from ..ops.gather import take_rows
from ..ops.intersect import BIG
from ..ops.texture import (build_pyramid, meta_table, sample_env_bilinear,
                           sample_slot)
from ..scene.types import Scene
from ..utils import debug


@dataclasses.dataclass(frozen=True)
class LightSample:
    """One NEE sample per ray."""

    wi: torch.Tensor        # f32[N, 3] unit direction toward the light
    dist: torch.Tensor      # f32[N] distance to the light (BIG if infinite)
    radiance: torch.Tensor  # f32[N, 3] emitted radiance toward the point
    pdf: torch.Tensor       # f32[N] solid-angle pdf (0 => invalid sample)
    valid: torch.Tensor     # bool[N]


def dense_tri_pdf_area(scene: Scene) -> torch.Tensor:
    """Per-triangle area-measure pdf of NEE picking that triangle point:
    P(tri) / area(tri); 0 for non-emitters (MIS of BSDF-sampled hits)."""
    em = scene.emitters
    dense = torch.zeros((scene.geometry.num_tris,), dtype=torch.float32,
                        device=scene.device)
    p = torch.where(em.valid, em.pdf_tri / torch.clamp_min(em.area, 1e-12),
                    0.0)
    tri = debug.check_index("emitter triangles", em.tri_idx,
                            scene.geometry.num_tris)
    return dense.index_add(0, tri.long(), p)


def pack_emitter_attrs(scene: Scene) -> torch.Tensor:
    """Per-emitter sampling table f32[E, 20]: v0 | e1 | e2 | pdf/area |
    emissive radiance (attached to materials) | uv0 | duv1 | duv2 |
    emissive-texture slot id (-1 = untextured)."""
    em = scene.emitters
    g = scene.geometry
    tri = debug.check_index("emitter triangles", em.tri_idx, g.num_tris)
    idx = debug.check_index("vertex ids", g.indices[tri], g.positions.shape[0])
    v0 = g.positions[idx[:, 0]]
    v1 = g.positions[idx[:, 1]]
    v2 = g.positions[idx[:, 2]]
    pdf_a = torch.where(em.valid,
                        em.pdf_tri / torch.clamp_min(em.area, 1e-12), 0.0)
    mat = debug.check_index("material ids", g.tri_material[tri],
                            scene.materials.emissive_factor.shape[0])
    radiance = scene.materials.emissive_factor[mat]
    uv0 = g.uvs[idx[:, 0]]
    duv1 = g.uvs[idx[:, 1]] - uv0
    duv2 = g.uvs[idx[:, 2]] - uv0
    em_tex = scene.materials.emissive_tex[mat].to(torch.float32)
    return torch.cat([v0, v1 - v0, v2 - v0, pdf_a[:, None], radiance,
                      uv0, duv1, duv2, em_tex[:, None]], dim=1)


def sample_area_emitters(scene: Scene, p: torch.Tensor, u1: torch.Tensor,
                         u2: torch.Tensor,
                         emitter_attrs: torch.Tensor | None = None,
                         pyramid: torch.Tensor | None = None) -> LightSample:
    """Sample a point on the emissive triangles from shading points p[N, 3].

    u1[N] picks the emitter (dense CDF compare up to 64 emitters, Walker
    alias table above), u2[N, 2] the point (uniform barycentric).  Emission
    is one-sided: only into the hemisphere of the geometric normal.  When
    the scene has emissive textures (tex_slots[3]) the radiance includes
    the texture at the light point (level-0 fetch: NEE has no ray cone),
    matching the emitter-hit path's factor x texture; pass the frame's
    `pyramid` (ops.texture.build_pyramid) to amortize its build.
    """
    em = scene.emitters
    if emitter_attrs is None:
        emitter_attrs = pack_emitter_attrs(scene)
    m = em.num_emitters
    if m <= 64:
        e_idx = torch.sum((em.cdf[None, :] < u1[:, None]).to(torch.int32),
                          dim=-1)
    else:
        # u1 splits into (slot, accept): slot = floor(u1*E), accept on the
        # fraction; both uniform.
        scaled = u1 * m
        slot = torch.clamp(scaled.to(torch.int32), 0, m - 1)
        frac = scaled - slot.to(torch.float32)
        slot = debug.check_index("emitter alias", slot,
                                 em.alias_prob.shape[0])
        accept = frac < em.alias_prob[slot]
        e_idx = torch.where(accept, slot, em.alias_idx[slot])
    e_idx = torch.clamp(e_idx, 0, m - 1)
    rows = take_rows(emitter_attrs, e_idx)           # [N, 20] ONE fetch
    v0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    pdf_a = rows[:, 9]
    radiance = rows[:, 10:13]

    # Uniform triangle sampling (sqrt trick)
    su = torch.sqrt(torch.clamp(u2[:, 0], 0.0, 1.0))
    b1 = 1.0 - su
    b2 = u2[:, 1] * su
    lp = v0 + b1[:, None] * e1 + b2[:, None] * e2

    if scene.tex_slots[3]:
        if pyramid is None:
            pyramid = build_pyramid(scene.textures)
        uv_l = (rows[:, 13:15] + b1[:, None] * rows[:, 15:17]
                + b2[:, None] * rows[:, 17:19])
        meta_tab = meta_table(scene.textures, rows.device)
        tex_id = rows[:, 19].to(torch.int32)
        meta = torch.where((tex_id >= 0)[:, None],
                           meta_tab[debug.check_index(
                               "texture ids", torch.clamp_min(tex_id, 0),
                               meta_tab.shape[0])], -1.0)
        tex = sample_slot(pyramid, meta, uv_l, None)
        radiance = radiance * tex[:, :3]
    ng = math3d.cross(e1, e2)
    ng2 = torch.clamp_min(torch.sum(ng * ng, dim=-1, keepdim=True), 1e-20)
    ng = ng * torch.rsqrt(ng2)

    to_l = lp - p
    dist2 = torch.clamp_min(torch.sum(to_l * to_l, dim=-1), 1e-12)
    dist = torch.sqrt(dist2)
    wi = to_l / dist[:, None]
    cos_l = torch.sum(ng * (-wi), dim=-1)        # light-side cosine

    pdf_sa = pdf_a * dist2 / torch.clamp_min(cos_l, 1e-6)
    valid = (cos_l > 1e-6) & (pdf_a > 0.0)
    return LightSample(
        wi=wi, dist=dist,
        radiance=torch.where(valid[:, None], radiance, 0.0),
        pdf=torch.where(valid, pdf_sa, 0.0),
        valid=valid)


def sample_directional(scene: Scene, n_rays: int) -> LightSample:
    """Delta directional light: wi = -direction, pdf 1 (never MIS-weighted)."""
    d = scene.directional
    on = torch.sum(d.radiance) > 0.0
    return LightSample(
        wi=(-d.direction).expand(n_rays, 3),
        dist=torch.full((n_rays,), BIG, dtype=torch.float32,
                        device=d.direction.device),
        radiance=d.radiance.expand(n_rays, 3),
        pdf=torch.ones((n_rays,), dtype=torch.float32,
                       device=d.direction.device),
        valid=on.expand(n_rays))


def _env(scene: Scene):
    if scene.env is None:
        raise ValueError("the scene has no environment map")
    return scene.env


def sample_env(scene: Scene, n_rays: int, u2: torch.Tensor) -> LightSample:
    """Importance-sample the environment map through its Walker alias table:
    u2[:, 0] picks the slot, u2[:, 1] accepts it or takes its alias."""
    env = _env(scene)
    h, w = env.data.shape[0], env.data.shape[1]
    m = h * w
    slot = torch.clamp((u2[:, 0] * m).to(torch.int32), 0, m - 1)
    slot = debug.check_index("env alias", slot, env.alias_prob.shape[0])
    accept = u2[:, 1] < env.alias_prob[slot]
    texel = debug.check_index(
        "env alias", torch.where(accept, slot, env.alias_idx[slot]), m)
    row = texel // w
    col = texel - row * w
    theta = (row.to(torch.float32) + 0.5) / h * math.pi
    phi = ((col.to(torch.float32) + 0.5) / w - 0.5) * 2.0 * math.pi
    sin_t = torch.sin(theta)
    wi = torch.stack([sin_t * torch.cos(phi), torch.cos(theta),
                      sin_t * torch.sin(phi)], dim=-1)
    texel = row * w + col
    pdf = env.pdf.reshape(-1)[texel]
    return LightSample(
        wi=wi, dist=torch.full((n_rays,), BIG, dtype=torch.float32,
                               device=u2.device),
        radiance=env.data.reshape(-1, 3)[texel], pdf=pdf, valid=pdf > 0.0)


def env_pdf(scene: Scene, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of env NEE producing direction d[N, 3] (for MIS)."""
    env = _env(scene)
    h, w = env.data.shape[0], env.data.shape[1]
    theta = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0))
    phi = torch.atan2(d[:, 2], d[:, 0])
    row = torch.clamp((theta / math.pi * h).to(torch.int32), 0, h - 1)
    col = torch.clamp(((phi / (2.0 * math.pi) + 0.5) * w).to(torch.int32),
                      0, w - 1)
    return env.pdf.reshape(-1)[row * w + col]


def env_radiance(scene: Scene, d: torch.Tensor) -> torch.Tensor:
    """Environment radiance for escaped rays (bilinear)."""
    return sample_env_bilinear(_env(scene).data, d)
