"""Path-tracing integrator, dense form (port of `integrator/path.py`).

Per bounce, all rays advance in lockstep with masks: closest hit, shade,
emitter MIS, one shadow trace per light family (NEE), BSDF sampling.
Radiometric quantities stay attached; sampling decisions (directions,
pdfs, MIS weights, Russian roulette) are detached, at the same points as
the reference, so `render()`'s gradients are the reference's interior
estimator (grad/inverse.py; held to the reference's jax.grad in the tests).

Tracers: `resident` (K2, ops/resident.py), `pallas` (the block tracer:
phase A in torch + K1, ops/blocktrace.py; the reference's route name, on
the card the CUDA kernel), `block` (the reference's XLA block tracer in
torch ops, ops/blocktrace.py::intersect_blocks), `bvh` (the stack walk of
ops/traverse.py over `scene.bvh`) and `brute` (the oracle).  As in the
reference, `render_with_stats` on a CUDA scene that `fused_applicable`
accepts (tracer `auto` or `fused`) renders the whole frame with the fused
kernel K4 (ops/fused.py) instead; on the CPU it stays dense, and the dense
path takes the name `fused` as the reference's dispatch does, as brute
force.  `render()` never takes K4.  `cfg.batch_spp` renders all samples of
`render_with_stats`'s dense path as one sample-inner ray stream.

Row bands: `_sample_radiance(row_start=, n_rows=)` renders rows
[row_start, row_start + n_rows) with per-ray keys from the GLOBAL pixel
ids, so a band equals the same rows of the full frame bit for bit; the
sharded renders and the sharded train step (parallel/, grad/inverse.py)
stand on it.  `cfg.exchange_axis` routes the block tracer's calls through
the ring ray exchange of parallel/exchange.py, on the mesh that
`render_sample_sharded(exchange=True)` binds.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from ..core import math3d
from ..core import rng as rng_mod
from ..core.camera import Camera, generate_rays_at
from ..core.film import Film
from ..core.morton import morton_pixel_ids
from ..models import lights as lights_mod
from ..models.bsdf import eval_bsdf, sample_bsdf
from ..ops import blocktrace, resident
from ..ops import fused as fused_mod
from ..ops.blocktrace import intersect_blocks, intersect_blocks_pallas
from ..ops.intersect import BIG, Hit, intersect_brute, occluded_brute
from ..ops.texture import build_pyramid
from ..ops.traverse import intersect_bvh
from ..scene.types import Scene
from ..utils.profiling import span
from .shading import pack_tri_attrs, shade_surface


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings; same fields and defaults as the reference."""

    width: int = 256
    height: int = 256
    spp: int = 4
    max_bounces: int = 1          # number of BSDF bounces after the camera hit
    nee: bool = True              # next-event estimation
    mis: bool = True              # MIS between NEE and BSDF sampling
    rr_start: int = 100           # bounce index where Russian roulette starts
    ray_eps: float = 1e-3         # shadow/secondary ray offset
    tri_chunk: int = 2048         # brute-force intersection chunk size
    tracer: str = "auto"          # auto|brute|bvh|resident|block|pallas|fused
    block_size: int = 256         # ray block of the block tracers
    max_u: int = 48               # candidate clusters per block
    chunk: int = 4                # clusters per kernel loop iteration
    resort: bool = True           # in-tracer direction-bin sort
    exchange_axis: str | None = None  # mesh axis of the ring ray exchange
    batch_spp: bool = False       # all spp as one ray stream (primal)


def _power_mis(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Power heuristic (beta=2), detached."""
    pa, pb = pa.detach(), pb.detach()
    a2 = pa * pa
    return torch.where(pa > 0.0, a2 / torch.clamp_min(a2 + pb * pb, 1e-20),
                       0.0)


def _auto_tracer(scene: Scene) -> str:
    """Pick the intersection backend (host decision): the resident tracer
    up to RESIDENT_AUTO_MAX_TRIS triangles, else the block tracer ("pallas",
    K1) when the scene has a cluster grid, else the BVH walk when it has a
    BVH, else brute force."""
    if scene.geometry.num_tris <= resident.RESIDENT_AUTO_MAX_TRIS:
        return "resident"
    if scene.clusters is not None:
        return "pallas"
    if scene.bvh is not None:
        return "bvh"
    return "brute"


TRACERS = ("resident", "brute", "bvh", "block", "pallas")


@dataclasses.dataclass(frozen=True)
class Tracer:
    """A frame's tracer (make_tracer): `closest(o, d, t_min, active=None,
    sort=False)` -> Hit, `occluded(o, d, t_min, t_max)` -> bool[N].  The
    block tracers alone read `active` (dead lanes trace as t_max = 0 rays
    and miss) and `sort`, and take camera rays in band-local `morton` order
    (core/morton.py); `sorts`: the in-tracer sort of bounce and shadow rays."""

    name: str
    closest: Callable[..., Hit]
    occluded: Callable[..., torch.Tensor]
    morton: bool = False
    sorts: bool = False


def make_tracer(scene: Scene, cfg: RenderConfig) -> Tracer:
    """The dense path's tracer for cfg.tracer (auto|resident|pallas|block|
    bvh|brute; `fused` is brute force here, as in the reference's dispatch)
    for the scene's current geometry: the resident soup or the grid's soup
    packed, the ring exchange bound when cfg.exchange_axis is set."""
    name = cfg.tracer if cfg.tracer != "auto" else _auto_tracer(scene)
    if name == "fused":
        name = "brute"
    if name not in TRACERS:
        raise ValueError(f"unknown tracer {name!r} (one of auto, fused, "
                         f"{', '.join(TRACERS)})")
    is_block = name in ("block", "pallas")
    if is_block and scene.clusters is None:
        raise ValueError(f"tracer {name!r} needs a cluster grid "
                         "(scene.types.with_clusters)")
    if name == "bvh" and scene.bvh is None:
        raise ValueError("tracer 'bvh' needs a BVH (scene.types.with_bvh)")
    geom = scene.geometry
    if name == "resident":
        soup = resident.pack_resident_soup(geom)

        def trace(o, d, **kw):
            return resident.intersect_resident(geom, o, d, soup=soup, **kw)
    elif name == "bvh":
        def trace(o, d, **kw):
            return intersect_bvh(scene.bvh, geom, o, d, **kw)
    elif name == "brute":
        def trace(o, d, any_hit=False, **kw):
            return (occluded_brute if any_hit else intersect_brute)(
                o, d, *geom.tri_vertices(), chunk=cfg.tri_chunk, **kw)
    if not is_block:
        return Tracer(name, lambda o, d, t_min, active=None, sort=False:
                      trace(o, d, t_min=t_min),
                      lambda o, d, t_min, t_max:
                      trace(o, d, t_min=t_min, t_max=t_max, any_hit=True))
    if name == "pallas":
        grid = dataclasses.replace(
            scene.clusters, soup=blocktrace._soup(scene.clusters, geom))

        def trace(o, d, t_max, **kw):
            return intersect_blocks_pallas(
                grid, o, d, t_max=t_max, block=cfg.block_size,
                max_u=cfg.max_u, chunk=cfg.chunk, **kw)
    else:
        def trace(o, d, t_max, **kw):
            return intersect_blocks(scene.clusters, geom, o, d, t_max=t_max,
                                    block=cfg.block_size, max_u=cfg.max_u,
                                    **kw)
    if cfg.exchange_axis is not None:
        from ..parallel import exchange
        group, local = exchange.axis_group(cfg.exchange_axis), trace

        def trace(o, d, t_max, **kw):
            t_max = torch.as_tensor(t_max, dtype=torch.float32,
                                    device=o.device).expand(o.shape[0])
            return exchange.with_ring_exchange(
                lambda o_, d_, tm_: local(o_, d_, tm_, **kw), o, d, t_max,
                group)

    def block_closest(o, d, t_min, active=None, sort=False):
        t_max = BIG if active is None else torch.where(active, BIG, 0.0)
        return trace(o, d, t_max, t_min=t_min, sort=sort)

    def block_occluded(o, d, t_min, t_max):
        return trace(o, d, t_max, t_min=t_min, any_hit=True, sort=cfg.resort)

    return Tracer(name, block_closest, block_occluded, morton=True,
                  sorts=cfg.resort)


def closest_hit(scene: Scene, o, d, t_min, cfg: RenderConfig,
                active=None, sort: bool = False) -> Hit:
    """Closest hit through `make_tracer(scene, cfg)`."""
    return make_tracer(scene, cfg).closest(o, d, t_min, active, sort)


def occluded(scene: Scene, o, d, t_min, t_max, cfg: RenderConfig):
    """Any hit (shadow rays) through `make_tracer(scene, cfg)` -> bool[N]."""
    return make_tracer(scene, cfg).occluded(o, d, t_min, t_max)


@dataclasses.dataclass(frozen=True)
class FrameTables:
    """Per-frame derived tables, built once outside the spp loop."""

    tri_attrs: torch.Tensor             # pack_tri_attrs
    emitter_attrs: torch.Tensor | None  # pack_emitter_attrs
    pyramid: torch.Tensor | None        # texture quad pyramid
    tracer: Tracer                      # make_tracer
    pix: torch.Tensor                   # band's pixel ids, tracer's order


def frame_tables(scene: Scene, cfg: RenderConfig, row_start: int = 0,
                 n_rows: int | None = None) -> FrameTables:
    """The tables of the row band [row_start, row_start + n_rows) of a
    frame (all of it by default)."""
    n_rows = cfg.height if n_rows is None else n_rows
    tri_attrs = pack_tri_attrs(scene)
    emitter_attrs = (lights_mod.pack_emitter_attrs(scene)
                     if scene.has_emitters else None)
    pyramid = build_pyramid(scene.textures) if scene.has_textures else None
    tracer = make_tracer(scene, cfg)
    if tracer.morton:
        pix = torch.from_numpy(morton_pixel_ids(
            cfg.height, cfg.width, row_start, n_rows)).to(
                device=scene.device, dtype=torch.int64)
    else:
        first = row_start * cfg.width
        pix = torch.arange(first, first + n_rows * cfg.width,
                           dtype=torch.int64, device=scene.device)
    return FrameTables(tri_attrs, emitter_attrs, pyramid, tracer, pix)


def camera_rays(scene: Scene, camera: Camera, cfg: RenderConfig,
                pix: torch.Tensor, keys: torch.Tensor):
    """Jittered camera rays through the global pixel ids `pix` (int64[N]),
    one per key of `keys` (int64[N, 2]) -> (o, d, cone_angle).
    `cone_angle` is the pixel footprint angle for ray-cone mip selection
    (ops/texture.py), None for a scene without textures."""
    jitter = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_PIXEL_JITTER, 2)
    px = (pix % cfg.width).to(torch.float32)
    py = (pix // cfg.width).to(torch.float32)
    o, d = generate_rays_at(camera, cfg.width, cfg.height, px, py, jitter)
    cone_angle = (2.0 * torch.tan(camera.fov_y * 0.5) / cfg.height
                  if scene.has_textures else None)
    return o, d, cone_angle


def trace_radiance(scene: Scene, o: torch.Tensor, d: torch.Tensor,
                   keys: torch.Tensor, cfg: RenderConfig,
                   return_stats: bool = False, cone_angle=None,
                   tables: FrameTables | None = None):
    """Estimate radiance along rays (o, d) [N, 3] -> L [N, 3].

    One sample per ray; `keys` int64[N, 2] are per-ray keys
    (core.rng.ray_keys).  `cone_angle` (scalar) is the pixel footprint
    angle for ray-cone mip selection (None: level-0 texture fetches).  With
    return_stats=True also returns the int64 count of ray queries made by
    ACTIVE lanes (closest-hit + shadow).
    """
    n = o.shape[0]
    dev = o.device
    ray_count = torch.zeros((), dtype=torch.int64, device=dev)
    has_emitters = scene.has_emitters
    has_env = scene.env is not None
    if tables is None:
        tables = frame_tables(scene, cfg)
    tracer = tables.tracer
    path_dist = torch.zeros((n,), dtype=torch.float32, device=dev)

    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    # pdf of the *previous* BSDF sampling decision, for MIS of emitter hits.
    prev_pdf = torch.zeros((n,), dtype=torch.float32, device=dev)

    for bounce in range(cfg.max_bounces + 1):
        ray_count = ray_count + active.sum()
        # Bounce rays are direction-scattered: the block tracer sorts them
        # by direction bin inside the trace call (only o/d/t_max move).
        hit = tracer.closest(o, d, 0.0 if bounce == 0 else cfg.ray_eps,
                             active=None if bounce == 0 else active,
                             sort=tracer.sorts and bounce > 0)
        miss = hit.miss

        # --- escaped rays: environment ---------------------------------
        if has_env:
            env_l = lights_mod.env_radiance(scene, d)
            if cfg.mis and cfg.nee and bounce > 0:
                w_env = torch.where(
                    prev_pdf > 0.0,
                    _power_mis(prev_pdf, lights_mod.env_pdf(scene, d)), 1.0)
            else:
                w_env = torch.ones((n,), dtype=torch.float32, device=dev)
            L = L + torch.where((active & miss)[:, None],
                                throughput * env_l * w_env[:, None], 0.0)
        active = active & ~miss

        # Ray-cone width at the hit (texture mip selection).
        path_dist = path_dist + torch.clamp_max(hit.t.detach(), 1e6) * (
            ~miss).to(torch.float32)
        cone_w = path_dist * cone_angle if cone_angle is not None else None
        sp = shade_surface(scene, hit, o, d, tri_attrs=tables.tri_attrs,
                           pyramid=tables.pyramid, cone_width=cone_w)

        # --- emitter hit through BSDF sampling (or camera) --------------
        if has_emitters:
            cos_l = torch.sum(sp.ng * (-d), dim=-1)   # ng is oriented: >= 0
            # Clamp t before squaring: misses carry t = 1e30.
            t_clamped = torch.clamp_max(hit.t, 1e6)
            dist2 = torch.clamp(t_clamped * t_clamped, 1e-12, 1e12)
            pdf_nee_hit = (sp.pdf_area * dist2
                           / torch.clamp_min(cos_l, 1e-6))
            if cfg.mis and cfg.nee and bounce > 0:
                w_em = torch.where(prev_pdf > 0.0,
                                   _power_mis(prev_pdf, pdf_nee_hit), 1.0)
            elif cfg.nee and bounce > 0:
                # NEE without MIS: emitter hits already counted by NEE.
                w_em = torch.zeros((n,), dtype=torch.float32, device=dev)
            else:
                w_em = torch.ones((n,), dtype=torch.float32, device=dev)
            L = L + torch.where(active[:, None],
                                throughput * sp.emissive * w_em[:, None],
                                0.0)

        if bounce == cfg.max_bounces:
            break

        # --- local frame -----------------------------------------------
        wo = math3d.to_local(-d, sp.tang, sp.bitang, sp.ns)
        o_next_base = sp.pos + sp.ng * cfg.ray_eps

        # --- NEE: one occluded() call per light family ------------------
        if cfg.nee:
            n_shadow = (int(has_emitters) + int(has_env)
                        + int(scene.has_directional))
            ray_count = ray_count + n_shadow * active.sum()
            u = rng_mod.ray_uniform(keys, bounce, rng_mod.STREAM_LIGHT, 5)
            pending = []
            if has_emitters:
                ls = lights_mod.sample_area_emitters(
                    scene, sp.pos.detach(), u[:, 0], u[:, 1:3],
                    emitter_attrs=tables.emitter_attrs,
                    pyramid=tables.pyramid)
                pending.append(_nee_prepare(sp, wo, ls, throughput, active,
                                            mis=cfg.mis))
            if has_env:
                es = lights_mod.sample_env(scene, n, u[:, 3:5])
                pending.append(_nee_prepare(sp, wo, es, throughput, active,
                                            mis=cfg.mis))
            # Directional (delta) light: always NEE, never MIS.
            if scene.has_directional:
                dl = lights_mod.sample_directional(scene, n)
                pending.append(_nee_prepare(sp, wo, dl, throughput, active,
                                            mis=False, delta=True))
            o_sh = o_next_base.detach()
            for wi_w, t_max_s, contrib in pending:
                occ = tracer.occluded(o_sh, wi_w, cfg.ray_eps, t_max_s)
                L = L + torch.where((~occ)[:, None], contrib, 0.0)

        # --- BSDF sampling ----------------------------------------------
        ub = rng_mod.ray_uniform(keys, bounce, rng_mod.STREAM_BSDF, 3)
        wi, f, pdf = sample_bsdf(sp.bsdf, wo, ub[:, 0], ub[:, 1:3])
        wi = wi.detach()
        pdf_d = pdf.detach()
        cos_i = torch.clamp_min(wi[..., 2], 0.0)
        ok = (pdf_d > 1e-9) & (cos_i > 0.0)
        weight = torch.where(ok[:, None],
                             f * cos_i[:, None] / pdf_d[:, None], 0.0)
        throughput = throughput * weight
        active = (active & ok
                  & (throughput.detach().max(dim=-1).values > 0.0))

        wi_world = math3d.to_world(wi, sp.tang, sp.bitang, sp.ns)
        wi_world = math3d.normalize(wi_world).detach()
        o = torch.where(active[:, None], o_next_base, o)
        d = torch.where(active[:, None], wi_world, d)
        prev_pdf = pdf_d

        # --- Russian roulette ------------------------------------------
        if bounce + 1 >= cfg.rr_start:
            q = torch.clamp(throughput.detach().max(dim=-1).values,
                            0.05, 0.95)
            u_r = rng_mod.ray_uniform(keys, bounce, rng_mod.STREAM_RR,
                                      1)[:, 0]
            throughput = throughput / torch.clamp_min(q, 1e-6)[:, None]
            active = active & (u_r < q)

    if return_stats:
        return L, ray_count
    return L


def _nee_prepare(sp, wo, ls, throughput, active, mis: bool,
                 delta: bool = False):
    """BSDF-weighted NEE contribution for one light sample, WITHOUT the
    occlusion test -> (wi_world, t_max, contrib_if_visible).  Hopeless
    lanes get t_max = 0 (their contribution is already zero)."""
    n = wo.shape[0]
    wi_w = ls.wi.detach()
    wi = math3d.to_local(wi_w, sp.tang, sp.bitang, sp.ns)
    f, pdf_b = eval_bsdf(sp.bsdf, wo, wi)
    cos_i = math3d.maximum(wi[..., 2], 0.0)      # attached: the tie rule
    ls_pdf = ls.pdf.detach()
    cand = active & ls.valid & (cos_i.detach() > 1e-7) & (ls_pdf > 0.0)
    t_max = torch.where(cand, ls.dist.detach() * (1.0 - 1e-3), 0.0)
    w = (_power_mis(ls.pdf, pdf_b) if (mis and not delta)
         else torch.ones((n,), dtype=torch.float32, device=wo.device))
    contrib = (throughput * f * ls.radiance
               * (cos_i * w / torch.clamp_min(ls_pdf, 1e-12))[:, None])
    contrib = torch.where(cand[:, None], contrib, 0.0)
    return wi_w, t_max, contrib


# ---------------------------------------------------------------------------
# Full-frame rendering
# ---------------------------------------------------------------------------

def _sample_radiance(scene: Scene, camera: Camera, key: torch.Tensor,
                     cfg: RenderConfig, row_start: int = 0,
                     n_rows: int | None = None, return_stats: bool = False,
                     tables: FrameTables | None = None):
    """One sample per pixel for a row band -> radiance [n_rows, W, 3].

    Per-ray keys derive from the GLOBAL pixel ids, so a band equals the
    same rows of a full render.  The band's rays go in the tracer's order
    (`tables.pix`: band-local morton order for the block tracers, else
    row-major) and are unscrambled at the end.  `tables` must be the
    band's (frame_tables with the same row_start and n_rows)."""
    n_rows = cfg.height if n_rows is None else n_rows
    if tables is None:
        tables = frame_tables(scene, cfg, row_start, n_rows)
    pix = tables.pix
    keys = rng_mod.ray_keys(key, pix)
    o, d, cone_angle = camera_rays(scene, camera, cfg, pix, keys)
    out = trace_radiance(scene, o, d, keys, cfg, return_stats=return_stats,
                         cone_angle=cone_angle, tables=tables)
    L, count = out if return_stats else (out, None)
    if tables.tracer.morton:
        # Scatter by the band-local index: pix holds global ids.
        L = torch.zeros_like(L).index_put_((pix - row_start * cfg.width,), L)
    img = L.reshape(n_rows, cfg.width, 3)
    return (img, count) if return_stats else img


def render_sample(scene: Scene, camera: Camera, key: torch.Tensor,
                  cfg: RenderConfig, row_start: int = 0,
                  n_rows: int | None = None) -> torch.Tensor:
    """One sample per pixel for a row band -> radiance [n_rows, W, 3]."""
    return _sample_radiance(scene, camera, key.to(scene.device), cfg,
                            row_start, n_rows)


def render(scene: Scene, camera: Camera, key: torch.Tensor,
           cfg: RenderConfig) -> Film:
    """Render cfg.spp samples, differentiable in the scene tensors: the
    dense estimator on any device, one pass per sample (never K4, and never
    batch_spp, as in the reference)."""
    return _render_with_stats_dense(
        scene, camera, key, dataclasses.replace(cfg, batch_spp=False))[0]


def render_image(scene: Scene, camera: Camera, seed: int,
                 cfg: RenderConfig) -> torch.Tensor:
    """Convenience: render -> mean HDR image [H, W, 3]."""
    return render(scene, camera, rng_mod.key(seed, scene.device), cfg).mean()


def _use_fused(scene: Scene, cfg: RenderConfig) -> bool:
    """Dispatch to the whole-frame kernel K4 (ops/fused.py): a CUDA scene
    the kernel takes.  Primal-only paths (render_with_stats, render_fast);
    gradient paths keep the dense integrator."""
    return (cfg.tracer in ("auto", "fused")
            and scene.device.type == "cuda"
            and fused_mod.fused_applicable(scene, cfg))


def render_fast(scene: Scene, camera: Camera, key: torch.Tensor,
                cfg: RenderConfig) -> Film:
    """Fastest primal render: K4 when it applies, else the dense
    integrator.  NOT differentiable: use render() for gradients."""
    film, _ = render_with_stats(scene, camera, key, cfg)
    return film


@torch.no_grad()
def render_with_stats(scene: Scene, camera: Camera, key: torch.Tensor,
                      cfg: RenderConfig):
    """Primal render + exact int64 ray-query count (rays/s benchmarks).

    On a CUDA scene that K4 takes, one K4 launch renders the frame: the
    same estimator with the fused kernel's murmur3 stream, so its image
    agrees with the dense one statistically, not pixel by pixel."""
    with span("pbr.frame"):
        if _use_fused(scene, cfg):
            hdr, count = fused_mod.render_fused_stats(scene, camera, key, cfg)
            return Film(hdr=hdr, spp=float(cfg.spp)), count
        return _render_with_stats_dense(scene, camera, key, cfg)


def _render_with_stats_dense(scene: Scene, camera: Camera, key: torch.Tensor,
                             cfg: RenderConfig):
    """Dense render + ray-query count: one pass per sample, or one stream of
    all samples with cfg.batch_spp."""
    key = key.to(scene.device)
    if cfg.batch_spp:
        return _render_batched_spp(scene, camera, key, cfg)
    return render_band(scene, camera, rng_mod.split(key, cfg.spp), cfg)


def _render_batched_spp(scene: Scene, camera: Camera, key: torch.Tensor,
                        cfg: RenderConfig):
    """All cfg.spp samples as one ray stream, sample-inner: consecutive
    rays are the samples of one pixel (in morton order for the block
    tracers), so a block of B rays covers B / spp pixels.  Each ray's key
    is the loop's (sample key, global pixel id), so the image equals the
    loop's but for the order of the film sums and, under the block
    tracers' max_u truncation, which rays share a block."""
    if cfg.exchange_axis is not None:
        raise ValueError("batch_spp renders on one device: exchange_axis "
                         "must be None")
    dev = scene.device
    tables = frame_tables(scene, cfg)
    n_pix = cfg.height * cfg.width
    spp = cfg.spp
    pix = torch.repeat_interleave(tables.pix, spp)           # sample-inner
    skeys = rng_mod.split(key, spp)
    keys = torch.stack([rng_mod.ray_keys(k, tables.pix) for k in skeys],
                       dim=1).reshape(n_pix * spp, 2)
    o, d, cone_angle = camera_rays(scene, camera, cfg, pix, keys)
    L, count = trace_radiance(scene, o, d, keys, cfg, return_stats=True,
                              cone_angle=cone_angle, tables=tables)
    hdr = torch.zeros((n_pix, 3), dtype=torch.float32,
                      device=dev).index_add_(0, pix, L)
    return Film(hdr=hdr.reshape(cfg.height, cfg.width, 3),
                spp=float(spp)), count


def render_band(scene: Scene, camera: Camera, keys: torch.Tensor,
                cfg: RenderConfig, row_start: int = 0,
                n_rows: int | None = None):
    """(Film of the band's rows summed over one pass per sample key in
    `keys`, int64 ray-query count).  The sharded renders call it with
    their share of the samples (parallel/sharding.py)."""
    n_rows = cfg.height if n_rows is None else n_rows
    film = Film.zeros(n_rows, cfg.width, device=scene.device)
    count = torch.zeros((), dtype=torch.int64, device=scene.device)
    tables = frame_tables(scene, cfg, row_start, n_rows)
    for k in keys:
        radiance, c = _sample_radiance(scene, camera, k, cfg, row_start,
                                       n_rows, return_stats=True,
                                       tables=tables)
        film = film.add_samples(radiance)
        count = count + c
    return film, count
