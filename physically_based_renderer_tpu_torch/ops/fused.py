"""Fused whole-frame megakernel (K4) for small scenes (port of `ops/fused.py`).

One kernel renders the whole frame: jittered camera rays, the full bounce
loop (closest hit -> emitter-hit MIS -> NEE + shadow rays -> BSDF
sampling), the spp sum and the ray-query count, with the scene's tables
resident in fast memory and nothing written between stages.  It is
primal-only: `integrator/path.render_with_stats` takes it on a CUDA scene
that `fused_applicable` accepts; `render()` and the gradient paths keep the
dense integrator.

Random numbers come from a counter-based murmur3 hash (`_uniform`), keyed
by (frame seed, pixel id, sample index, draw site), bit for bit the
reference's; it is a different stream than the dense integrator's threefry
keying, so a fused image agrees with a dense one statistically, and with
the reference's fused image pixel by pixel.  The draw site is counted per
sample: jitter x and y are sites 1 and 2; bounce b then draws
(u_sel, u_a, u_b, u_l, u_1, u_2) at sites 3 + 6b ... 8 + 6b with area
emitters, or (u_l, u_1, u_2) at 3 + 3b ... 5 + 3b without (`rng_site`); the
last bounce draws nothing.

`render_fused_plain` is the estimator in plain torch over all pixels at
once, with vec3s as triples of [N] tensors and every operation in the
reference kernel's order; `render_fused_stats` launches the CUDA kernel
(`csrc/fused.cu`) for a CUDA scene and runs the plain version for a CPU
scene.  Both take 1/sqrt(x) where the reference takes rsqrt: one correctly
rounded sqrt and one correctly rounded division give the same bits in
torch on either device and in the kernel (CUDA's rsqrtf is approximate).
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_lib

BIG = 1e30
INV_PI = 0.31830988618379067
TWO_PI = 6.283185307179586

# Scenes the kernel takes, kept as the reference has them so that the same
# scenes take K4 in both packages.  At the limits the tables take
# 340*(12 + 32) + 32*14 + M*6 + 160*16 floats (the kernel adds a float4
# copy of each triangle's geometry), about 72 KB + 24 B per material of
# shared memory: within the 227 KB a Hopper block can use.
MAX_FUSED_TRIS = 340
MAX_FUSED_EMITTERS = 32
MAX_FUSED_TEX_ROWS = 160   # total texels across all textures (quad rows)

# Tri-table columns.
_TW = 32   # row width
# 0:3 v0 | 3:6 e1 | 6:9 e2 | 9:12 ng (unit) | 12:15 base_color |
# 15 metallic | 16 roughness | 17 specular | 18:21 emissive | 21 pdf_area |
# 22:24 uv0 | 24:26 uv1 | 26:28 uv2 | 28 material id (texture meta key)
_EW = 14   # emitter row: 0:3 v0 | 3:6 e1 | 6:9 e2 | 9 pdf_a | 10:13 rad | 13 cdf
_MW = 6    # per-material texture meta row: bc (off, h, w) | mr (off, h, w)
# Meta of a material id outside the table: no texture in either slot.
_NO_META = (-1.0, 1.0, 1.0, -1.0, 1.0, 1.0)

# Kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0

# Pairwise [rays, tris] elements per chunk of the plain version.
_PLAIN_CHUNK = 1 << 22

_MASK = 0xFFFFFFFF


def _fused_tex_ok(scene) -> bool:
    """Textures the megakernel can keep resident and sample exactly:
    base_color/metallic-roughness slots only, small (total texel rows within
    budget), REPEAT wrap, LINEAR filters, no mip chain (MIP_NONE makes the
    level-0 bilinear fetch the exact sampler semantics)."""
    if not scene.has_textures:
        return True
    from ..scene.types import FILTER_LINEAR, MIP_NONE, WRAP_REPEAT
    st = scene.textures
    if scene.tex_slots[2] or scene.tex_slots[3]:
        return False                       # normal/emissive maps: dense path
    if sum(h * w for h, w in st.shapes) > MAX_FUSED_TEX_ROWS:
        return False
    return all(ws == WRAP_REPEAT and wt == WRAP_REPEAT
               and mag == FILTER_LINEAR and mi == FILTER_LINEAR
               and mm == MIP_NONE
               for (ws, wt), (mag, mi, mm) in zip(st.wrap, st.filt))


def fused_applicable(scene, cfg) -> bool:
    """Static check: can this (scene, config) render via the megakernel?"""
    return (scene.geometry.num_tris <= MAX_FUSED_TRIS
            and scene.emitters.num_emitters <= MAX_FUSED_EMITTERS
            and _fused_tex_ok(scene)
            and scene.flat_normals
            and scene.env is None
            and (scene.has_emitters or scene.has_directional)
            and cfg.nee and cfg.mis
            and cfg.rr_start > cfg.max_bounces)


# ---------------------------------------------------------------------------
# Tables (the reference's column layouts)
# ---------------------------------------------------------------------------

def _pack_tri_table(scene) -> torch.Tensor:
    """Detached tri table f32[T, 32] (layout above)."""
    from ..models.lights import dense_tri_pdf_area
    g, m = scene.geometry, scene.materials
    idx = g.indices.long()
    v0 = g.positions[idx[:, 0]]
    e1 = g.positions[idx[:, 1]] - v0
    e2 = g.positions[idx[:, 2]] - v0
    ng = torch.linalg.cross(e1, e2, dim=-1)
    ng = ng * torch.rsqrt(torch.clamp_min(
        torch.sum(ng * ng, dim=-1, keepdim=True), 1e-20))
    tm = g.tri_material.long()
    t = v0.shape[0]
    return torch.cat([
        v0, e1, e2, ng,
        m.base_color_factor[tm][:, :3],
        m.metallic_factor[tm][:, None],
        m.roughness_factor[tm][:, None],
        m.specular_factor[tm][:, None],
        m.emissive_factor[tm],
        dense_tri_pdf_area(scene)[:, None],
        g.uvs[idx[:, 0]], g.uvs[idx[:, 1]], g.uvs[idx[:, 2]],
        tm.to(torch.float32)[:, None],
        torch.zeros((t, _TW - 29), dtype=torch.float32, device=v0.device),
    ], dim=1).detach().contiguous()


def _pack_tex_tables(scene):
    """Texture tables: per-material meta f32[M, 6] (bc off/h/w, mr off/h/w;
    -1 marks no texture) + level-0 quad rows f32[R, 16] (repeat wrap baked,
    the quad packing of ops/texture.py)."""
    from ..scene.types import WRAP_REPEAT
    from .texture import _quad_pack
    m = scene.materials
    dev = scene.device
    n_mats = m.base_color_factor.shape[0]
    if not scene.has_textures:
        return (torch.full((n_mats, _MW), -1.0, dtype=torch.float32,
                           device=dev),
                torch.zeros((1, 16), dtype=torch.float32, device=dev))
    st = scene.textures
    texels = st.texels.detach()
    pieces, row_off, acc = [], [], 0
    for off, (h, w) in zip(st.offsets, st.shapes):
        img = texels[off:off + h * w].reshape(h, w, 4)
        pieces.append(_quad_pack(img, WRAP_REPEAT, WRAP_REPEAT))
        row_off.append(acc)
        acc += h * w
    quads = torch.cat(pieces, dim=0)
    f32 = dict(dtype=torch.float32, device=dev)
    off_t = torch.tensor(row_off, **f32)
    h_t = torch.tensor([h for h, _ in st.shapes], **f32)
    w_t = torch.tensor([w for _, w in st.shapes], **f32)

    def slot(ids):
        safe = torch.clamp_min(ids, 0).long()
        rows = torch.stack([off_t[safe], h_t[safe], w_t[safe]], dim=1)
        return torch.where((ids >= 0)[:, None], rows, -1.0)

    mtex = torch.cat([slot(m.base_color_tex),
                      slot(m.metallic_roughness_tex)], dim=1)
    return mtex.contiguous(), quads.contiguous()


def _pack_em_table(scene) -> torch.Tensor:
    """Detached emitter table f32[E, 14], the CDF in column 13."""
    from ..models.lights import pack_emitter_attrs
    if not scene.has_emitters:
        return torch.zeros((1, _EW), dtype=torch.float32, device=scene.device)
    # First 13 columns (v0|e1|e2|pdf_a|radiance); the uv/emissive-texture
    # tail is irrelevant here: _fused_tex_ok rejects emissive-textured
    # scenes (they render on the dense path).
    attrs = pack_emitter_attrs(scene)[:, :13]
    cdf = scene.emitters.cdf[:, None]
    return torch.cat([attrs, cdf], dim=1).detach().contiguous()


def _pack_cam(scene, camera, width: int, height: int) -> torch.Tensor:
    """Camera + directional-light scalars f32[18]: eye | right * aspect *
    tan(fov/2) | up * tan(fov/2) | forward | -light direction | radiance."""
    right, up, fwd = camera.basis()
    tan_half = torch.tan(camera.fov_y / 2.0)
    aspect = width / height
    rv = right * (aspect * tan_half)
    uv = up * tan_half
    d = scene.directional
    return torch.cat([camera.position, rv, uv, fwd, -d.direction,
                      d.radiance]).detach().contiguous()


@dataclasses.dataclass(frozen=True)
class FusedFrame:
    """Everything one K4 launch reads: the packed tables on the render
    device and the frame's static settings."""

    cam: torch.Tensor    # f32[18]
    seeds: tuple[int, int]  # the uint32 words of fold_in(key, 0x5EED)
    tri: torch.Tensor    # f32[T, 32]
    em: torch.Tensor     # f32[E, 14]
    mtex: torch.Tensor   # f32[M, 6]
    quads: torch.Tensor  # f32[R, 16]
    width: int
    height: int
    spp: int
    max_bounces: int
    eps: float
    has_em: bool
    has_dir: bool
    textured: bool


def fused_frame(scene, camera, key, cfg) -> FusedFrame:
    """Pack the tables and seeds of one fused frame (`fused_applicable`
    must hold; raises otherwise)."""
    from ..core import rng as rng_mod
    if not fused_applicable(scene, cfg):
        raise ValueError("scene/config not renderable by the fused kernel "
                         "(fused_applicable is False)")
    mtex, quads = _pack_tex_tables(scene)
    return FusedFrame(
        cam=_pack_cam(scene, camera, cfg.width, cfg.height),
        seeds=tuple(rng_mod.fold_in(key, 0x5EED).tolist()),
        tri=_pack_tri_table(scene), em=_pack_em_table(scene), mtex=mtex,
        quads=quads, width=cfg.width, height=cfg.height, spp=cfg.spp,
        max_bounces=cfg.max_bounces, eps=float(cfg.ray_eps),
        has_em=scene.has_emitters, has_dir=scene.has_directional,
        textured=scene.has_textures)


# ---------------------------------------------------------------------------
# murmur3 counter RNG (reference `_fmix32` / `_make_rng`), uint32 words held
# in int64 tensors and masked to 32 bits
# ---------------------------------------------------------------------------

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), c a 32-bit constant, with no
    product beyond 2^49 (int64 never overflows)."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer (full avalanche)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def rng_site(bounce: int, k: int, has_em: bool) -> int:
    """Draw site of the k-th uniform of bounce `bounce` (sites 1, 2 are the
    pixel jitter): with area emitters k = 0..5 is u_sel, u_a, u_b, u_l, u_1,
    u_2; without, k = 0..2 is u_l, u_1, u_2."""
    return 3 + (6 if has_em else 3) * bounce + k


def _uniform(pid: torch.Tensor, seed0: int, seed1: int, s: int,
             site: int) -> torch.Tensor:
    """U[0, 1) keyed by (frame seeds, pixel id int64[N], sample s, site)."""
    h = _mul32(pid & _MASK, 0x9E3779B1) ^ seed0
    h = _fmix32((h + ((site * 0x6C078965) & _MASK)) & _MASK)
    h = h ^ ((s * 0xB5297A4D) & _MASK) ^ seed1
    h = _fmix32(h)
    return (h >> 8).to(torch.float32) * (1.0 / 16777216.0)


# ---------------------------------------------------------------------------
# Plain torch estimator: vec3 = triple of [N] tensors, the kernel's order
# ---------------------------------------------------------------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _rsqrt(x):
    return 1.0 / torch.sqrt(x)


def _normalize(a):
    return _scale(a, _rsqrt(torch.clamp_min(_dot(a, a), 1e-20)))


def _where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def _power_mis(pa, pb):
    a2 = pa * pa
    return torch.where(pa > 0.0, a2 / torch.clamp_min(a2 + pb * pb, 1e-20),
                       0.0)


def _bsdf_consts(bc, met, rgh, spc):
    r = torch.clamp(rgh, 1e-2, 1.0)
    alpha = torch.clamp_min(r * r, 1e-4)
    one_m = 1.0 - met
    f0 = tuple(0.04 * spc * one_m + c * met for c in bc)
    diff = tuple(c * one_m for c in bc)
    lum = (0.2126, 0.7152, 0.0722)
    ls = torch.clamp_min(f0[0] * lum[0] + f0[1] * lum[1] + f0[2] * lum[2],
                         1e-4)
    ld = torch.clamp_min(diff[0] * lum[0] + diff[1] * lum[1]
                         + diff[2] * lum[2], 0.0)
    ps = torch.clamp(ls / (ls + ld), 0.05, 0.99)
    return alpha, f0, diff, ps


def _smith_lambda(alpha, wz):
    c = torch.clamp(torch.abs(wz), 1e-6, 1.0)
    tan2 = torch.clamp_min(1.0 - c * c, 0.0) / (c * c)
    return 0.5 * (torch.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def _eval_bsdf(wo, wi, alpha, f0, diff, ps):
    no, ni = wo[2], wi[2]
    valid = (no > 1e-6) & (ni > 1e-6)
    h = _normalize(_add(wo, wi))
    voh = torch.clamp_min(_dot(wo, h), 0.0)
    m = torch.clamp(1.0 - voh, 0.0, 1.0)
    m5 = (m * m) * (m * m) * m
    fr = tuple(c + (1.0 - c) * m5 for c in f0)
    a2 = alpha * alpha
    nh = torch.clamp_min(h[2], 0.0)
    dd = nh * nh * (a2 - 1.0) + 1.0
    d_ggx = a2 * INV_PI / torch.clamp_min(dd * dd, 1e-12)
    no_ = torch.clamp_min(torch.abs(no), 1e-6)
    ni_ = torch.clamp_min(torch.abs(ni), 1e-6)
    lam_o = _smith_lambda(alpha, no)
    lam_i = _smith_lambda(alpha, ni)
    vis = 1.0 / (4.0 * no_ * ni_ * (1.0 + lam_o + lam_i))
    dv = d_ggx * vis
    val = tuple(torch.where(valid, diff[k] * INV_PI * (1.0 - fr[k])
                            + dv * fr[k], 0.0) for k in range(3))
    pdf_d = torch.clamp_min(ni, 0.0) * INV_PI
    g1_o = 1.0 / (1.0 + lam_o)
    pdf_s = g1_o * d_ggx / (4.0 * no_)
    pdf = torch.where(valid, ps * pdf_s + (1.0 - ps) * pdf_d, 0.0)
    return val, pdf


def _sample_bsdf(wo, u_lobe, u1, u2, alpha, f0, diff, ps):
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    wi_d = (r * cphi, r * sphi, torch.sqrt(torch.clamp_min(1.0 - u1, 0.0)))
    vh = _normalize((alpha * wo[0], alpha * wo[1], wo[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv = _rsqrt(torch.clamp_min(lensq, 1e-12))
    big = lensq > 1e-9
    t1 = (torch.where(big, -vh[1] * inv, 1.0),
          torch.where(big, vh[0] * inv, 0.0),
          torch.zeros_like(inv))
    t2 = _cross(vh, t1)
    p1 = r * cphi
    p2 = r * sphi
    s = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp_min(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp_min(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = _add(_add(_scale(t1, p1), _scale(t2, p2)), _scale(vh, p3))
    h = _normalize((alpha * nh[0], alpha * nh[1],
                    torch.clamp_min(nh[2], 1e-6)))
    wi_s = _sub3(_scale(h, 2.0 * _dot(wo, h)), wo)
    wi = _normalize(_where3(u_lobe < ps, wi_s, wi_d))
    f, pdf = _eval_bsdf(wo, wi, alpha, f0, diff, ps)
    return wi, f, pdf


def _onb(n):
    """Branchless orthonormal basis around unit n (Duff et al. 2017)."""
    s = torch.where(n[2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[2])
    b = n[0] * n[1] * a
    t = (1.0 + s * n[0] * n[0] * a, s * b, -s * n[0])
    bt = (b, s + n[1] * n[1] * a, -n[1])
    return t, bt


def _mt_block(tri, o, d, t_min):
    """Moller-Trumbore of rays [B] (vec3 triples) against every triangle:
    (t, ok, u, v) each [B, T], the reference kernel's `mt` pairwise."""
    col = lambda k: tri[:, k][None, :]
    v0 = (col(0), col(1), col(2))
    e1 = (col(3), col(4), col(5))
    e2 = (col(6), col(7), col(8))
    o = tuple(x[:, None] for x in o)
    d = tuple(x[:, None] for x in d)
    p = _cross(d, e2)
    det = _dot(p, e1)
    nonzero = torch.abs(det) > 1e-9
    inv = torch.where(nonzero, 1.0 / det, 0.0)
    tv = _sub3(o, v0)
    u = _dot(tv, p) * inv
    q = _cross(tv, e1)
    v = _dot(d, q) * inv
    tt = _dot(e2, q) * inv
    ok = nonzero & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (tt > t_min)
    return tt, ok, u, v


def _chunks(n: int, n_tris: int):
    step = max(1, _PLAIN_CHUNK // max(n_tris, 1))
    return [(s, min(n, s + step)) for s in range(0, n, step)]


def _closest(tri, o, d, t_min):
    """Closest hit -> (t f32[N], winner int64[N] (-1 on a miss), u, v).
    A hit replaces the best only at a strictly smaller t, so ties go to the
    lowest triangle index; t stays BIG on a miss."""
    n, n_tris = o[0].shape[0], tri.shape[0]
    rows = torch.arange(n_tris, device=tri.device)
    out = []
    for a, b in _chunks(n, n_tris):
        tt, ok, u, v = _mt_block(tri, tuple(x[a:b] for x in o),
                                 tuple(x[a:b] for x in d), t_min)
        masked = torch.where(ok, tt, BIG)
        tb = masked.min(dim=1, keepdim=True).values
        first = torch.where(ok & (masked == tb), rows, n_tris).min(dim=1)
        hit = tb[:, 0] < BIG
        k = torch.where(hit, first.values, -1)
        kk = torch.clamp_min(k, 0)[:, None]
        zero = torch.zeros_like(tb[:, 0])
        out.append((tb[:, 0], k,
                    torch.where(hit, u.gather(1, kk)[:, 0], zero),
                    torch.where(hit, v.gather(1, kk)[:, 0], zero)))
    return tuple(torch.cat(p) for p in zip(*out))


def _occluded(tri, o, d, t_min, t_max):
    """Any hit with t_min < t < t_max -> bool[N]."""
    n = o[0].shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=tri.device).expand(n)
    out = []
    for a, b in _chunks(n, tri.shape[0]):
        tt, ok, _, _ = _mt_block(tri, tuple(x[a:b] for x in o),
                                 tuple(x[a:b] for x in d), t_min)
        out.append((ok & (tt < t_max[a:b, None])).any(dim=1))
    return torch.cat(out)


def _row_or(table, idx, default):
    """table[idx] where the f32 index names a row exactly, else `default`:
    the reference's select over every row, which matches no row for an
    index outside the table (or NaN, or not an integer)."""
    ok = (idx >= 0.0) & (idx < table.shape[0]) & (idx == torch.floor(idx))
    rows = table[torch.where(ok, idx, 0.0).long()]
    return torch.where(ok[:, None], rows, default)


def _tex_fetch(mtex, quads, matf, uvx, uvy):
    """Base-colour and metallic-roughness texture fetch of the winners:
    (bc rgb, has_bc, mr G, mr B, has_mr); see the reference `_tex_bilerp`."""
    default = torch.tensor(_NO_META, dtype=torch.float32, device=matf.device)
    bco, bch, bcw, mro, mrh, mrw = _row_or(mtex, matf, default).unbind(1)

    def coords(off, h, w):
        x = uvx * w - 0.5
        y = uvy * h - 0.5
        x = x - torch.floor(x / w) * w          # repeat wrap, continuous
        y = y - torch.floor(y / h) * h
        x0 = torch.minimum(torch.floor(x), w - 1.0)
        y0 = torch.minimum(torch.floor(y), h - 1.0)
        fx = torch.clamp(x - x0, 0.0, 1.0)
        fy = torch.clamp(y - y0, 0.0, 1.0)
        return off + y0 * w + x0, fx, fy

    def bilerp(c00, c10, c01, c11, fx, fy):
        top = c00 * (1.0 - fx) + c10 * fx
        bot = c01 * (1.0 - fx) + c11 * fx
        return top * (1.0 - fy) + bot * fy

    idx_b, fxb, fyb = coords(bco, bch, bcw)
    idx_m, fxm, fym = coords(mro, mrh, mrw)
    qb = _row_or(quads, idx_b, 0.0)
    qm = _row_or(quads, idx_m, 0.0)
    bc = tuple(bilerp(qb[:, k], qb[:, 4 + k], qb[:, 8 + k], qb[:, 12 + k],
                      fxb, fyb) for k in range(3))
    mr_g = bilerp(qm[:, 1], qm[:, 5], qm[:, 9], qm[:, 13], fxm, fym)
    mr_b = bilerp(qm[:, 2], qm[:, 6], qm[:, 10], qm[:, 14], fxm, fym)
    return bc, bco >= 0.0, mr_g, mr_b, mro >= 0.0


def _pick_emitter(em, u_sel):
    """Emitter row: the smallest e with cdf[e] >= u (one emitter: row 0);
    a u above every cdf gives a zero row."""
    if em.shape[0] == 1:
        return em[0, :13].expand(u_sel.shape[0], 13)
    pick = torch.sum((em[None, :, 13] < u_sel[:, None]).to(torch.int64),
                     dim=1)
    return _row_or(em[:, :13], pick.to(torch.float32), 0.0)


def _sample_frame(f: FusedFrame, s: int, pid, pxf, pyf, seed0, seed1,
                  on_query=None):
    """Radiance of sample s for every pixel -> (L triple, ray-query count).
    on_query, if given, sees each query as fused_plain says."""
    cam = f.cam
    eye = (cam[0], cam[1], cam[2])
    rv = (cam[3], cam[4], cam[5])
    uv = (cam[6], cam[7], cam[8])
    fv = (cam[9], cam[10], cam[11])
    dir_wi = (cam[12], cam[13], cam[14])
    dir_rad = (cam[15], cam[16], cam[17])
    n_shadow = int(f.has_em) + int(f.has_dir)
    rng = lambda site: _uniform(pid, seed0, seed1, s, site)

    jx, jy = rng(1), rng(2)
    ndx = 2.0 * (pxf + jx) * (1.0 / f.width) - 1.0
    ndy = 2.0 * (pyf + jy) * (1.0 / f.height) - 1.0
    d = _normalize(tuple(ndx * rv[k] + ndy * uv[k] + fv[k] for k in range(3)))
    ones = torch.ones_like(d[0])
    o = tuple(eye[k] * ones for k in range(3))
    lr, lg, lb = (torch.zeros_like(ones) for _ in range(3))
    tp = (ones, ones, ones)
    active = torch.ones_like(ones, dtype=torch.bool)
    prev_pdf = torch.zeros_like(ones)
    cnt = torch.zeros((), dtype=torch.int64, device=ones.device)

    for bounce in range(f.max_bounces + 1):
        cnt = cnt + active.sum()
        t_min = 0.0 if bounce == 0 else f.eps
        if on_query is not None:
            on_query("closest", o, d, t_min, BIG, active)
        tb, win, uw, vw = _closest(f.tri, o, d, t_min)
        rows = torch.where((win >= 0)[:, None], f.tri[torch.clamp_min(win, 0)],
                           0.0)
        attrs = [rows[:, 9 + k] for k in range(20)]
        ng = (attrs[0], attrs[1], attrs[2])
        bc = (attrs[3], attrs[4], attrs[5])
        met, rgh, spc = attrs[6], attrs[7], attrs[8]
        em = (attrs[9], attrs[10], attrs[11])
        pda = attrs[12]
        if f.textured:
            # factor x texture (glTF): albedo rgb from the base-color slot,
            # roughness = G / metallic = B of the metallic-roughness slot.
            wb = 1.0 - uw - vw
            uvx = wb * attrs[13] + uw * attrs[15] + vw * attrs[17]
            uvy = wb * attrs[14] + uw * attrs[16] + vw * attrs[18]
            bct, has_b, mr_g, mr_b, has_m = _tex_fetch(f.mtex, f.quads,
                                                       attrs[19], uvx, uvy)
            bc = _where3(has_b, (bc[0] * bct[0], bc[1] * bct[1],
                                 bc[2] * bct[2]), bc)
            rgh = torch.where(has_m, rgh * mr_g, rgh)
            met = torch.where(has_m, met * mr_b, met)

        active = active & (tb < 0.5 * BIG)
        pos = _add(o, _scale(d, tb))
        dgn = _dot(d, ng)
        front = dgn < 0.0
        sgn = torch.where(front, 1.0, -1.0)
        ngo = _scale(ng, sgn)
        ns = ngo  # flat_normals gate: shading normal = face normal

        if f.has_em:
            cos_l = torch.clamp_min(-sgn * dgn, 0.0)
            tcl = torch.clamp_max(tb, 1e6)
            dist2 = torch.clamp(tcl * tcl, 1e-12, 1e12)
            pdf_hit = pda * dist2 / torch.clamp_min(cos_l, 1e-6)
            if bounce == 0:
                w_em = 1.0
            else:
                w_em = torch.where(prev_pdf > 0.0,
                                   _power_mis(prev_pdf, pdf_hit), 1.0)
            emw = torch.where(active & front, w_em, 0.0)
            lr = lr + tp[0] * em[0] * emw
            lg = lg + tp[1] * em[1] * emw
            lb = lb + tp[2] * em[2] * emw

        if bounce == f.max_bounces:
            break

        t, bt = _onb(ns)
        wo = (-_dot(d, t), -_dot(d, bt), -_dot(d, ns))
        o_next = _add(pos, _scale(ngo, f.eps))
        alpha, f0, diff, psel = _bsdf_consts(bc, met, rgh, spc)

        # --- NEE ----------------------------------------------------------
        cnt = cnt + n_shadow * active.sum()
        if f.has_em:
            u_sel, u_a, u_b = (rng(rng_site(bounce, k, True))
                               for k in range(3))
            erow = _pick_emitter(f.em, u_sel).unbind(1)
            ev0 = (erow[0], erow[1], erow[2])
            ee1 = (erow[3], erow[4], erow[5])
            ee2 = (erow[6], erow[7], erow[8])
            epda = erow[9]
            erad = (erow[10], erow[11], erow[12])

            su = torch.sqrt(torch.clamp(u_a, 0.0, 1.0))
            b1 = 1.0 - su
            b2 = u_b * su
            lp = _add(ev0, _add(_scale(ee1, b1), _scale(ee2, b2)))
            lng = _normalize(_cross(ee1, ee2))
            tol = _sub3(lp, pos)
            dist2 = torch.clamp_min(_dot(tol, tol), 1e-12)
            dist = torch.sqrt(dist2)
            wi_w = _scale(tol, 1.0 / dist)
            cos_le = -_dot(lng, wi_w)
            pdf_sa = epda * dist2 / torch.clamp_min(cos_le, 1e-6)
            lvalid = (cos_le > 1e-6) & (epda > 0.0)

            wi = (_dot(wi_w, t), _dot(wi_w, bt), _dot(wi_w, ns))
            fb, pdf_b = _eval_bsdf(wo, wi, alpha, f0, diff, psel)
            cos_i = torch.clamp_min(wi[2], 0.0)
            cand = active & lvalid & (cos_i > 1e-7) & (pdf_sa > 0.0)
            if on_query is not None:
                on_query("shadow", o_next, wi_w, f.eps, dist * (1.0 - 1e-3),
                         cand)
            occ = _occluded(f.tri, o_next, wi_w, f.eps, dist * (1.0 - 1e-3))
            vis = cand & ~occ
            w = _power_mis(pdf_sa, pdf_b)
            k = torch.where(vis, cos_i * w / torch.clamp_min(pdf_sa, 1e-12),
                            0.0)
            lr = lr + tp[0] * fb[0] * erad[0] * k
            lg = lg + tp[1] * fb[1] * erad[1] * k
            lb = lb + tp[2] * fb[2] * erad[2] * k

        if f.has_dir:
            # Delta light: wi = -direction, radiance const, no MIS.
            wi = (_dot(dir_wi, t), _dot(dir_wi, bt), _dot(dir_wi, ns))
            fd, _ = _eval_bsdf(wo, wi, alpha, f0, diff, psel)
            cos_i = torch.clamp_min(wi[2], 0.0)
            dirs = tuple(x.expand_as(ones) for x in dir_wi)
            if on_query is not None:
                on_query("shadow", o_next, dirs, f.eps, BIG * (1.0 - 1e-3),
                         active & (cos_i > 1e-7))
            occ = _occluded(f.tri, o_next, dirs, f.eps, BIG * (1.0 - 1e-3))
            vis = active & ~occ & (cos_i > 1e-7)
            k = torch.where(vis, cos_i, 0.0)
            lr = lr + tp[0] * fd[0] * dir_rad[0] * k
            lg = lg + tp[1] * fd[1] * dir_rad[1] * k
            lb = lb + tp[2] * fd[2] * dir_rad[2] * k

        # --- BSDF sampling ------------------------------------------------
        base = 3 if f.has_em else 0
        u_l, u_1, u_2 = (rng(rng_site(bounce, base + k, f.has_em))
                         for k in range(3))
        wi, fs, pdf = _sample_bsdf(wo, u_l, u_1, u_2, alpha, f0, diff, psel)
        cos_i = torch.clamp_min(wi[2], 0.0)
        ok = (pdf > 1e-9) & (cos_i > 0.0)
        wgt = torch.where(ok, cos_i / torch.clamp_min(pdf, 1e-20), 0.0)
        tp = (tp[0] * fs[0] * wgt, tp[1] * fs[1] * wgt, tp[2] * fs[2] * wgt)
        tmax_c = torch.maximum(tp[0], torch.maximum(tp[1], tp[2]))
        active = active & ok & (tmax_c > 0.0)

        wd = _normalize(_add(_add(_scale(t, wi[0]), _scale(bt, wi[1])),
                             _scale(ns, wi[2])))
        o = _where3(active, o_next, o)
        d = _where3(active, wd, d)
        prev_pdf = pdf

    return (lr, lg, lb), cnt


def fused_plain(f: FusedFrame, on_query=None):
    """Plain-torch K4 on the frame's device -> (hdr_sum f32[H, W, 3],
    ray-query count int64[]); the sum runs over samples in order.

    on_query(kind, o, d, t_min, t_max, lanes), if given, is called before
    each closest-hit ("closest") and shadow ("shadow") query with its rays
    (vec3 triples of [N] tensors), its bounds (t_max a float or [N]) and
    the lanes that the kernel traces: the active paths, and for a shadow
    ray those of them whose light sample can contribute (the kernel tests
    no triangle for the others).  `tools/work.py` counts K4's work so."""
    dev = f.tri.device
    n = f.width * f.height
    pid = torch.arange(n, dtype=torch.int64, device=dev)
    py = pid // f.width
    pxf = (pid - py * f.width).to(torch.float32)
    pyf = py.to(torch.float32)
    seed0, seed1 = f.seeds
    acc = [torch.zeros((n,), dtype=torch.float32, device=dev)
           for _ in range(3)]
    count = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(f.spp):
        L, c = _sample_frame(f, s, pid, pxf, pyf, seed0, seed1, on_query)
        acc = [a + x for a, x in zip(acc, L)]
        count = count + c
    return torch.stack(acc, dim=-1).reshape(f.height, f.width, 3), count


def render_fused_plain(scene, camera, key, cfg):
    """Plain-torch whole-frame render on the scene's device:
    (hdr_sum f32[H, W, 3], ray-query count int64[]).  hdr_sum is the SUM
    over cfg.spp samples (Film.hdr convention)."""
    return fused_plain(fused_frame(scene, camera, key, cfg))


# ---------------------------------------------------------------------------
# Wrapper
# ---------------------------------------------------------------------------

def _check(f: FusedFrame):
    dev = f.tri.device
    for name, x, width in (("cam", f.cam, None), ("tri", f.tri, _TW),
                           ("em", f.em, _EW), ("mtex", f.mtex, _MW),
                           ("quads", f.quads, 16)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, tri on {dev}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
        if width is not None and (x.dim() != 2 or x.shape[1] != width):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"[*, {width}]")
    if f.cam.shape != (18,):
        raise ValueError(f"cam has shape {tuple(f.cam.shape)}, expected (18,)")
    if (f.tri.shape[0] > MAX_FUSED_TRIS or f.em.shape[0] > MAX_FUSED_EMITTERS
            or f.quads.shape[0] > MAX_FUSED_TEX_ROWS):
        raise ValueError("tables exceed the fused kernel's limits")
    if f.width * f.height >= 1 << 24:
        raise ValueError("too many pixels for exact f32 pixel ids")
    if f.spp < 1:
        raise ValueError(f"spp must be at least 1, got {f.spp}")


def fused_kernel(f: FusedFrame):
    """K4 on the card -> (hdr_sum f32[H, W, 3], ray-query count int64[]).

    The kernel traces each (pixel, sample) path on its own and sums a
    pixel's samples in order at the end; the wrapper allocates its scratch:
    the paths' radiance (12 bytes a path: 12.6 MB at 512x512 x 4 spp), a
    pixel's arrival count and the work counter beside the ray count."""
    global LAUNCHES
    _check(f)
    dev = f.tri.device
    if dev.type != "cuda":
        raise ValueError(f"fused kernel: tables on {dev}, not a CUDA device")
    lib = cuda_lib.library()
    hdr = torch.empty((f.height, f.width, 3), dtype=torch.float32, device=dev)
    count = torch.zeros((2,), dtype=torch.int64, device=dev)
    n_pix = f.width * f.height
    samples = torch.empty((n_pix, f.spp, 3), dtype=torch.float32, device=dev)
    arrivals = torch.zeros((n_pix,), dtype=torch.int32, device=dev)
    seed0, seed1 = f.seeds
    rc = lib.pbr_fused_render(
        f.cam.data_ptr(), f.tri.data_ptr(), f.tri.shape[0], f.em.data_ptr(),
        f.em.shape[0], f.mtex.data_ptr(), f.mtex.shape[0],
        f.quads.data_ptr(), f.quads.shape[0], f.width, f.height, f.spp,
        f.max_bounces, f.eps, 1.0 / f.width, 1.0 / f.height, seed0, seed1,
        int(f.has_em), int(f.has_dir), int(f.textured), hdr.data_ptr(),
        count.data_ptr(), samples.data_ptr(), arrivals.data_ptr(),
        cuda_lib.stream_ptr(dev))
    cuda_lib.check(rc, "pbr_fused_render")
    LAUNCHES += 1
    return hdr, count[0]


def render_fused_stats(scene, camera, key, cfg):
    """Whole-frame fused render: (hdr_sum f32[H, W, 3], ray-query count
    int64[]).  hdr_sum is the SUM over cfg.spp samples (Film.hdr
    convention).  A CUDA scene launches K4; a CPU scene runs the plain
    version; any other device raises.  Requires fused_applicable."""
    dev = scene.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused render: unsupported device {dev}")
    frame = fused_frame(scene, camera, key, cfg)
    if dev.type == "cpu":
        return fused_plain(frame)
    return fused_kernel(frame)
