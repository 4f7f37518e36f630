"""Surface shading points from hit records (port of `integrator/shading.py`).

All per-triangle shading data is packed once per frame into one wide table
f32[T, 86] with the reference's column layout (`pack_tri_attrs`, attached
to the scene tensors so gradients can flow), and each bounce does a single
row gather.  The winner is re-intersected here, attached, so tracers may
return detached hits (ops/resident.py, ops/blocktrace.py).  Texture
slots (base colour, metallic-roughness, normal, emissive) are sampled from
the quad pyramid (ops/texture.py) with ray-cone mip selection; each slot
is skipped when no material uses it (`Scene.tex_slots`).
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import math3d
from ..models.bsdf import BsdfParams
from ..ops.gather import take_rows
from ..ops.intersect import Hit
from ..ops.texture import META_W, build_pyramid, meta_table, sample_slot
from ..scene.types import MIP_LINEAR, Scene
from ..utils import debug

# Column offsets of the packed per-triangle attribute row (pack_tri_attrs).
COL_MAT = 47
COL_PDF_AREA = 48
COL_UV_DENSITY = 49
COL_META = 50          # 4 slots x META_W texture metadata
ATTR_W = COL_META + 4 * META_W


@dataclasses.dataclass(frozen=True)
class ShadingPoint:
    pos: torch.Tensor       # f32[N, 3] world hit position
    ng: torch.Tensor        # f32[N, 3] geometric normal (faces the ray)
    ns: torch.Tensor        # f32[N, 3] shading normal (oriented)
    tang: torch.Tensor      # f32[N, 3] tangent of the shading frame
    bitang: torch.Tensor    # f32[N, 3]
    uv: torch.Tensor        # f32[N, 2]
    bsdf: BsdfParams        # per-hit material parameters
    emissive: torch.Tensor  # f32[N, 3] emitted radiance (front side)
    front: torch.Tensor     # bool[N] ray hit the geometric front face
    mat: torch.Tensor       # i32[N] material id
    pdf_area: torch.Tensor  # f32[N] NEE area-pdf of this triangle (MIS)


def pack_tri_attrs(scene: Scene) -> torch.Tensor:
    """Pack per-triangle shading attributes into one table f32[T, 86].

    Columns: 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:18 corner normals | 18:30 corner
    tangent4s | 30:36 corner uvs | 36:40 base_color_factor | 40 metallic |
    41 roughness | 42:45 emissive | 45 specular | 46 normal_scale |
    47 material id | 48 NEE area pdf | 49 uv density (detached) |
    50.. four texture_meta rows (base_color, metallic_roughness, normal,
    emissive; off0 = -1 marks "no texture").
    """
    from ..models.lights import dense_tri_pdf_area
    g = scene.geometry
    m = scene.materials
    idx = debug.check_index("vertex ids", g.indices, g.positions.shape[0])
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    v0 = g.positions[i0]
    e1 = g.positions[i1] - v0
    e2 = g.positions[i2] - v0
    tm = debug.check_index("material ids", g.tri_material,
                           m.base_color_factor.shape[0])

    uv0, uv1, uv2 = g.uvs[i0], g.uvs[i1], g.uvs[i2]
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    uv_area = 0.5 * torch.abs(duv1[:, 0] * duv2[:, 1]
                              - duv1[:, 1] * duv2[:, 0])
    w_area = 0.5 * torch.linalg.vector_norm(math3d.cross(e1, e2), dim=-1)
    uv_density = torch.sqrt(
        uv_area / torch.clamp_min(w_area, 1e-20)).detach()

    meta_tab = meta_table(scene.textures, scene.device)

    def slot_meta(ids):
        rows = meta_tab[debug.check_index(
            "texture ids", torch.clamp_min(ids, 0), meta_tab.shape[0])]
        return torch.where((ids >= 0)[:, None], rows, -1.0)[tm]

    return torch.cat([
        v0, e1, e2,
        g.normals[i0], g.normals[i1], g.normals[i2],
        g.tangents[i0], g.tangents[i1], g.tangents[i2],
        uv0, uv1, uv2,
        m.base_color_factor[tm],
        m.metallic_factor[tm][:, None],
        m.roughness_factor[tm][:, None],
        m.emissive_factor[tm],
        m.specular_factor[tm][:, None],
        m.normal_scale[tm][:, None],
        tm.to(torch.float32)[:, None],
        dense_tri_pdf_area(scene)[:, None],
        uv_density[:, None],
        slot_meta(m.base_color_tex),
        slot_meta(m.metallic_roughness_tex),
        slot_meta(m.normal_tex),
        slot_meta(m.emissive_tex),
    ], dim=1)


def shade_surface(scene: Scene, hit: Hit, ray_o: torch.Tensor,
                  ray_d: torch.Tensor,
                  tri_attrs: torch.Tensor | None = None,
                  pyramid: torch.Tensor | None = None,
                  cone_width: torch.Tensor | None = None) -> ShadingPoint:
    """Shading points for hits (finite garbage for misses; callers mask by
    hit.miss).  Barycentrics are re-derived attached from (ray_o, ray_d).

    Pass a prebuilt `tri_attrs` (pack_tri_attrs) and `pyramid`
    (ops.texture.build_pyramid) to amortize them over bounces.
    `cone_width` f32[N] is the ray cone's world-space width at the hit;
    None selects level-0 bilinear fetches everywhere.
    """
    tri = torch.clamp_min(hit.tri, 0)
    if tri_attrs is None:
        tri_attrs = pack_tri_attrs(scene)
    rows = take_rows(tri_attrs, tri)                   # [N, 86] ONE fetch

    v0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]

    # Attached re-intersection of the winning triangle.
    pv = math3d.cross(ray_d, e2)
    det = torch.sum(pv * e1, dim=-1)
    inv_det = torch.where(det.abs() > 1e-9, 1.0 / det, 0.0)
    tv = ray_o - v0
    u = (torch.sum(tv * pv, dim=-1) * inv_det)[:, None]
    q = math3d.cross(tv, e1)
    v = (torch.sum(ray_d * q, dim=-1) * inv_det)[:, None]
    w = 1.0 - u - v

    pos = v0 + u * e1 + v * e2
    ns_raw = math3d.normalize(
        w * rows[:, 9:12] + u * rows[:, 12:15] + v * rows[:, 15:18])
    t4 = w * rows[:, 18:22] + u * rows[:, 22:26] + v * rows[:, 26:30]
    uv = w * rows[:, 30:32] + u * rows[:, 32:34] + v * rows[:, 34:36]

    # Geometric normal from the winding (CCW front face).
    ng = math3d.normalize(math3d.cross(e1, e2))
    front = torch.sum(ng * ray_d, dim=-1) < 0.0
    sign = torch.where(front, 1.0, -1.0)[:, None]
    ng_o = ng * sign          # oriented toward the incoming ray
    ns = ns_raw * sign

    mat = rows[:, COL_MAT].to(torch.int32)

    lod, trilinear = None, False
    if scene.has_textures:
        if pyramid is None:
            pyramid = build_pyramid(scene.textures)
        trilinear = any(f[2] == MIP_LINEAR for f in scene.textures.filt)
        if cone_width is not None:
            # Ray-cone LOD (no curvature or BSDF spread): the cone width
            # stretched by 1/|cos| at grazing angles and converted to uv
            # units by the triangle's uv density; sample_slot adds the
            # texture-size term.  A detached sampling decision.
            cosg = torch.abs(torch.sum(ng.detach() * ray_d, dim=-1))
            foot = (cone_width.detach() * rows[:, COL_UV_DENSITY]
                    / torch.clamp_min(cosg, 0.08))
            lod = torch.log2(torch.clamp_min(foot.detach(), 1e-30))

    def meta(slot):
        c = COL_META + slot * META_W
        return rows[:, c:c + META_W]

    def fetch(slot, default=1.0):
        return sample_slot(pyramid, meta(slot), uv, lod, default=default,
                           trilinear=trilinear)

    # TBN frame: tangent orthogonalized against the interpolated normal,
    # bitangent = cross(N, T) * T.w.
    t = t4[:, :3] - torch.sum(t4[:, :3] * ns, dim=-1, keepdim=True) * ns
    t = math3d.normalize(t)
    b = math3d.cross(ns, t) * t4[:, 3:4]

    if scene.tex_slots[2]:
        # Normal mapping: n = tex * 2 - 1 in the TBN frame, glTF
        # normal_scale on the tangential components.
        has_nm = (meta(2)[:, 0] >= 0.0)[:, None]
        nm = fetch(2, default=0.5)[:, :3] * 2.0 - 1.0
        scale = rows[:, 46:47]
        nm = torch.cat([nm[:, :2] * scale, nm[:, 2:3]], dim=-1)
        # Sanitize before normalize: lanes without a normal map carry the
        # zero vector, whose normalize-gradient is NaN.
        nm = torch.where(has_nm, nm,
                         math3d.device_constant((0.0, 0.0, 1.0), nm.device))
        nm = math3d.normalize(nm)
        ns_mapped = math3d.normalize(
            nm[:, 0:1] * t + nm[:, 1:2] * b + nm[:, 2:3] * ns)
        ns = torch.where(has_nm, ns_mapped, ns)

    # Keep the shading normal in the oriented geometric hemisphere.
    flip = torch.sum(ns * ng_o, dim=-1, keepdim=True) < 0.0
    ns = math3d.normalize(torch.where(
        flip, ns - 2.0 * torch.sum(ns * ng_o, dim=-1, keepdim=True) * ng_o,
        ns))

    # Rebuild the tangent frame around the final shading normal.
    t = t - torch.sum(t * ns, dim=-1, keepdim=True) * ns
    t = math3d.normalize(t)
    b = math3d.cross(ns, t) * t4[:, 3:4]

    # Material parameters = factor x texture (glTF: B = metallic,
    # G = roughness).
    base_color = rows[:, 36:39]
    if scene.tex_slots[0]:
        base_color = base_color * fetch(0)[:, :3]
    metallic = rows[:, 40]
    roughness = rows[:, 41]
    if scene.tex_slots[1]:
        mr = fetch(1)
        metallic = metallic * mr[:, 2]
        roughness = roughness * mr[:, 1]
    emissive = rows[:, 42:45]
    if scene.tex_slots[3]:
        emissive = emissive * fetch(3)[:, :3]

    # One-sided emission: only the geometric front face emits.
    emissive = torch.where(front[:, None], emissive, 0.0)

    params = BsdfParams(base_color=base_color, metallic=metallic,
                        roughness=roughness, specular=rows[:, 45])
    return ShadingPoint(pos=pos, ng=ng_o, ns=ns, tang=t, bitang=b, uv=uv,
                        bsdf=params, emissive=emissive, front=front, mat=mat,
                        pdf_area=rows[:, COL_PDF_AREA])
