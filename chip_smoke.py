#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  Phases, each
of which raises on failure (an uncaught exception exits non-zero):

  0. device check: no CUDA -> exit 1; print the card's name and power limit;
  1. build the CUDA kernels from physically_based_renderer_tpu_torch/csrc/;
  2. K2 (resident tracer) against its plain-torch version on the card:
     Cornell soup with 512x512 camera rays and random interior rays, closest
     and any-hit, t_min 0 and 1e-3, per-ray t_max; a random 2048-triangle
     soup (dynamic shared memory above 48 KB); a ragged ray count;
  3. K3 (tonemap) against its plain-torch version: a 512x512 HDR image with
     negatives, zeros and values above 100, and a ragged 37x53 image;
  4. K1 (block-stream tracer) against its plain-torch version on
     `helmet_proc` (100,352 triangles, 1,024 clusters): 512x512 morton
     camera rays, direction-sorted surface bounce rays, env shadow rays
     (any hit, root-culled t_max) and a ragged ray count, through phase A
     as the integrator calls it; kernel and plain times at 262,144 camera
     rays;
  5. K4 (fused whole-frame kernel) against its plain-torch version on the
     same packed tables: `cornell` and `cornell_ggx` at their full configs
     (512x512, 4 spp, 4 bounces), `triangle` at its full config (256x256,
     4 spp, 1 bounce) and a ragged 24x20 cornell frame, images and ray
     counts; kernel and plain times of the cornell frame;
  6. the main paths at full size, launch counts reset just before each:
     the render CLI on `cornell` and on `cornell_ggx`, which K4 renders
     (1 K4, 1 K3, no tracer kernel); the dense cornell path,
     `render_with_stats` with tracer="resident" (36 K2); the render CLI on
     `helmet_proc` (28 K1, 1 K3);
  7. renders on the card against the committed reference goldens: 64x64
     cornell on the dense path (tests/data/cornell_64_golden.npy), 32x32
     helmet_proc (tests/data/helmet_proc_32_golden.npy), 64x64
     cornell_ggx through K4 (tests/data/cornell_ggx_fused_64_golden.npy,
     the reference's fused kernel in interpret mode).

Prints, before the last line, the card, one JSON line with the kernels
({"kernels": [...]}: `launches` is the sum over the main-path runs,
`launches_by_path` the count of each run) and one JSON line with the
measurements; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "cornell_64_golden.npy"
HELMET_GOLDEN = ROOT / "tests" / "data" / "helmet_proc_32_golden.npy"
FUSED_GOLDEN = ROOT / "tests" / "data" / "cornell_ggx_fused_64_golden.npy"

# Full-size film means: the CPU port renders cornell at 0.1577-0.1596 on
# the dense path and 0.15309 / 0.15847 through K4's plain version (64x64 /
# 128x128, 4 spp, 4 bounces), cornell_ggx at 0.13906 / 0.14392 through K4's
# plain version, and helmet_proc at 0.63066 / 0.63147 (4 spp, 3 bounces),
# so a 512x512 frame lies well inside these bands.
FILM_MEAN_BAND = {"cornell": (0.14, 0.18), "cornell_ggx": (0.12, 0.17),
                  "cornell_dense": (0.14, 0.18), "helmet_proc": (0.60, 0.66)}
# The main paths: (label, config, how it is driven: the render CLI, or
# render_with_stats with the named tracer).
MAIN_PATHS = (("cornell", "cornell", "cli"),
              ("cornell_ggx", "cornell_ggx", "cli"),
              ("cornell_dense", "cornell", "resident"),
              ("helmet_proc", "helmet_proc", "cli"))
# Launches per frame.  cornell and cornell_ggx: one K4 launch renders the
# frame.  cornell_dense: 4 spp x (5 closest + 4 shadow) K2 queries and no
# tonemap (it does not go through the CLI).  helmet_proc: no area emitter
# and no directional light, so 4 spp x (4 closest + 3 env shadow) K1
# queries; one K3 for each CLI run.
EXPECTED_LAUNCHES = {
    "cornell": {"fused": 1, "resident": 0, "trace_blocks": 0, "tonemap": 1},
    "cornell_ggx": {"fused": 1, "resident": 0, "trace_blocks": 0,
                    "tonemap": 1},
    "cornell_dense": {"fused": 0, "resident": 36, "trace_blocks": 0,
                      "tonemap": 0},
    "helmet_proc": {"fused": 0, "resident": 0, "trace_blocks": 28,
                    "tonemap": 1},
}
# The goldens: (label, config, file, (size, spp, bounces), how it is
# driven, as in MAIN_PATHS).
GOLDENS = (("cornell", "cornell", GOLDEN, (64, 2, 2), "resident"),
           ("helmet_proc", "helmet_proc", HELMET_GOLDEN, (32, 1, 2), "cli"),
           ("cornell_ggx_fused", "cornell_ggx", FUSED_GOLDEN, (64, 2, 2),
            "cli"))
# Render agreement (same as tests/test_torch_render.py): a pixel agrees
# within atol + rtol*|ref|; at least PIXEL_FRAC of pixels must agree.
ATOL, RTOL, PIXEL_FRAC, MEAN_REL = 1e-4, 1e-3, 0.99, 5e-3
# K4 against its plain version: the same render agreement, and ray counts
# within COUNT_REL (paths may branch apart after a one-ulp difference of
# sin/cos).
COUNT_REL = 5e-3
# Kernel tolerances: K1 and K2 winners may differ only on exact ties
# between triangles that share an edge (at most MAX_MISMATCH_FRAC of the
# rays), with t within T_REL there; where the winners agree, t is equal
# (both kernels are built with -fmad=false); K3 within K3_ATOL.
MAX_MISMATCH_FRAC, T_REL, K3_ATOL = 1e-4, 1e-5, 1e-5
BIG = 1e30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class TraceStats:
    """Agreement of a tracer kernel with its plain version."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.rays = 0
        self.mismatch = 0
        self.max_abs_err = 0.0

    def closest(self, label, kern, plain):
        import torch
        (tk, ik), (tp, ip) = kern, plain
        diff = ik != ip
        n_diff = int(diff.sum())
        if n_diff:
            rel = ((tk[diff] - tp[diff]).abs()
                   / tp[diff].abs().clamp_min(1e-30)).max().item()
            if rel > T_REL:
                raise AssertionError(f"{self.kernel} {label}: {n_diff} winners "
                                     f"differ with t rel diff {rel:.3g}")
        if n_diff > MAX_MISMATCH_FRAC * ik.numel():
            raise AssertionError(f"{self.kernel} {label}: {n_diff}/"
                                 f"{ik.numel()} winners differ")
        hit = (ik >= 0) & (ip >= 0)
        if bool(((ik < 0) != (ip < 0)).any()):
            raise AssertionError(f"{self.kernel} {label}: hit/miss disagrees")
        same = hit & (ik == ip)
        err = ((tk[same] - tp[same]).abs().max().item() if bool(same.any())
               else 0.0)
        if not torch.equal(tk[same], tp[same]):
            raise AssertionError(f"{self.kernel} {label}: hit distances "
                                 "differ where the winners agree "
                                 f"(max |dt| {err:.3g})")
        if not torch.equal(tk[~hit], tp[~hit]):
            raise AssertionError(f"{self.kernel} {label}: miss distances "
                                 "differ")
        self.rays += ik.numel()
        self.mismatch += n_diff
        self.max_abs_err = max(self.max_abs_err, err)
        print(f"{self.kernel} {label}: {ik.numel()} rays, {int(hit.sum())} "
              f"hits, {n_diff} winner mismatches, max |dt| {err:.3g}")

    def any_hit(self, label, kern, plain):
        n_diff = int((kern != plain).sum())
        if n_diff:
            raise AssertionError(f"{self.kernel} {label}: {n_diff} any-hit "
                                 "masks differ")
        self.rays += kern.numel()
        print(f"{self.kernel} {label}: {kern.numel()} rays, "
              f"{int(kern.sum())} occluded, masks equal")


def random_soup(n_tris: int, rng):
    import numpy as np
    centers = rng.uniform(-1.0, 1.0, (n_tris, 3)).astype(np.float32)
    offs = rng.normal(0.0, 0.1, (n_tris, 3, 3)).astype(np.float32)
    v = centers[:, None, :] + offs
    return np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]],
                          axis=1).astype(np.float32)


def random_rays(n: int, rng, lo, hi):
    import numpy as np
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def phase_k2(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.core.camera import (
        Camera, generate_rays_at)
    from physically_based_renderer_tpu_torch.ops import resident
    from physically_based_renderer_tpu_torch.scene.procedural import (
        make_cornell_box)
    from physically_based_renderer_tpu_torch.scene.types import upload_scene

    st = TraceStats("K2")
    rng = np.random.default_rng(0)
    scene = upload_scene(make_cornell_box(), dev)
    soup = resident.pack_resident_soup(scene.geometry)

    # 512x512 jittered camera rays of the cornell config.
    w = h = 512
    cam = Camera.make(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                      fov_y=0.95, device=dev)
    pix = torch.arange(w * h, device=dev)
    keys = rng_mod.ray_keys(rng_mod.key(0, dev), pix)
    jit = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_PIXEL_JITTER, 2)
    o_cam, d_cam = generate_rays_at(cam, w, h, (pix % w).float(),
                                    (pix // w).float(), jit)
    o_cam = o_cam.contiguous()
    # Bounce-like rays: origins inside the box, directions uniform.
    o_np, d_np = random_rays(w * h, rng, (-0.99, 0.01, -0.99),
                             (0.99, 1.99, 0.99))
    o_bnc, d_bnc = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)

    def both(soup, o, d, tm, t_min, any_hit):
        k = resident.trace(soup, o, d, tm, t_min, any_hit)
        p = resident.trace_plain(soup, o, d, tm, t_min, any_hit)
        torch.cuda.synchronize()
        return k, p

    for name, o, d in (("camera", o_cam, d_cam), ("bounce", o_bnc, d_bnc)):
        n = o.shape[0]
        big = torch.full((n,), BIG, device=dev)
        rand_tm = torch.from_numpy(
            rng.uniform(0.05, 4.0, n).astype(np.float32)).to(dev)
        for t_min in (0.0, 1e-3):
            st.closest(f"cornell {name} closest t_min={t_min}",
                       *both(soup, o, d, big, t_min, False))
            st.closest(f"cornell {name} closest t_min={t_min} random t_max",
                       *both(soup, o, d, rand_tm, t_min, False))
            st.any_hit(f"cornell {name} any-hit t_min={t_min}",
                       *both(soup, o, d, rand_tm, t_min, True))
    # Ragged ray count (not a multiple of the block size).
    nr = w * h - 77
    o_r, d_r = o_bnc[:nr].contiguous(), d_bnc[:nr].contiguous()
    tm_r = torch.from_numpy(rng.uniform(0.05, 4.0, nr).astype(np.float32)).to(dev)
    st.closest("cornell ragged closest", *both(soup, o_r, d_r, tm_r, 1e-3, False))
    st.any_hit("cornell ragged any-hit",
               *both(soup, o_r, d_r, tm_r, 1e-3, True))

    # Random 2048-triangle soup: 72 KB of dynamic shared memory per block.
    soup_r = torch.from_numpy(
        random_soup(resident.RESIDENT_MAX_TRIS, rng)).to(dev)
    nr = 100_003
    o_np, d_np = random_rays(nr, rng, -1.2, 1.2)
    o_r, d_r = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    tm_r = torch.from_numpy(rng.uniform(0.05, 3.0, nr).astype(np.float32)).to(dev)
    big = torch.full((nr,), BIG, device=dev)
    st.closest("random2048 closest", *both(soup_r, o_r, d_r, big, 0.0, False))
    st.closest("random2048 closest random t_max",
               *both(soup_r, o_r, d_r, tm_r, 1e-3, False))
    st.any_hit("random2048 any-hit",
               *both(soup_r, o_r, d_r, tm_r, 1e-3, True))

    # Time at the main path's shape: 262,144 camera rays x 32 triangles.
    big = torch.full((w * h,), BIG, device=dev)
    ms = time_ms(lambda: resident.trace(soup, o_cam, d_cam, big, 0.0, False),
                 50)
    plain_ms = time_ms(
        lambda: resident.trace_plain(soup, o_cam, d_cam, big, 0.0, False), 10)
    return st, ms, plain_ms


def phase_k3(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core.tonemap import aces_gamma
    from physically_based_renderer_tpu_torch.ops import tonemap

    rng = np.random.default_rng(1)
    out = {"max_abs_err": 0.0, "max_abs_err_vs_aces_gamma": 0.0,
           "values_compared": 0, "values_over_tol": 0}
    for h, w in ((512, 512), (37, 53)):
        x = rng.lognormal(-1.0, 2.0, (h, w, 3)).astype(np.float32)
        x[rng.random((h, w, 3)) < 0.05] *= -1.0
        x[rng.random((h, w, 3)) < 0.05] = 0.0
        x[rng.random((h, w, 3)) < 0.02] = rng.uniform(100.0, 1e4)
        hdr = torch.from_numpy(x).to(dev)
        k = tonemap.tonemap(hdr)
        p = tonemap.tonemap_plain(hdr)
        ref = aces_gamma(hdr)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"K3 {h}x{w}: non-finite output")
        err = (k - p).abs().max().item()
        n_bad = int(((k - p).abs() > K3_ATOL).sum())
        if n_bad:
            raise AssertionError(f"K3 {h}x{w}: {n_bad} values off by up to "
                                 f"{err:.3g}")
        out["values_compared"] += k.numel()
        out["values_over_tol"] += n_bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_abs_err_vs_aces_gamma"] = max(
            out["max_abs_err_vs_aces_gamma"], (k - ref).abs().max().item())
        print(f"K3 {h}x{w}: max |kernel - plain| {err:.3g}")
    hdr = torch.from_numpy(
        rng.lognormal(-1.0, 2.0, (512, 512, 3)).astype(np.float32)).to(dev)
    ms = time_ms(lambda: tonemap.tonemap(hdr), 200)
    plain_ms = time_ms(lambda: tonemap.tonemap_plain(hdr), 50)
    return out, ms, plain_ms


def phase_k1(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import morton
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.core.camera import (
        generate_rays_at)
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.integrator.shading import (
        shade_surface)
    from physically_based_renderer_tpu_torch.models import lights
    from physically_based_renderer_tpu_torch.ops import blocktrace
    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    from physically_based_renderer_tpu_torch.utils import config

    st = TraceStats("K1")
    rng = np.random.default_rng(2)
    bc = config.get("helmet_proc")
    cfg = bc.render
    scene, cam = config.build_scene(bc.scene, dev)
    grid = scene.clusters
    kw = dict(block=cfg.block_size, max_u=cfg.max_u, chunk=cfg.chunk)

    # 512x512 camera rays in morton order, as _sample_radiance makes them.
    w, h = cfg.width, cfg.height
    pix = torch.from_numpy(morton.morton_pixel_ids(h, w)).to(dev).long()
    keys = rng_mod.ray_keys(rng_mod.key(0, dev), pix)
    jit = rng_mod.ray_uniform(keys, 0, rng_mod.STREAM_PIXEL_JITTER, 2)
    o_cam, d_cam = generate_rays_at(cam, w, h, (pix % w).float(),
                                    (pix // w).float(), jit)
    n = o_cam.shape[0]

    def both(args, n_rays, t_min, any_hit):
        """Kernel and plain outputs over the real (unpadded) lanes."""
        k = tb.trace_blocks(*args, t_min=t_min, any_hit=any_hit,
                            chunk=cfg.chunk)
        p = tb.trace_blocks_plain(*args, t_min=t_min, any_hit=any_hit,
                                  chunk=cfg.chunk)
        torch.cuda.synchronize()
        flat = lambda x: x.reshape(-1)[:n_rays]
        if any_hit:
            return flat(k), flat(p)
        return (flat(k[0]), flat(k[1])), (flat(p[0]), flat(p[1]))

    def compare(label, o, d, t_min, t_max, sort, any_hit):
        args, _ = blocktrace.block_inputs(grid, o, d, t_min, t_max,
                                          sort=sort, **kw)
        nv = args[5].float()
        print(f"K1 {label}: candidates per block mean {nv.mean().item():.2f}"
              f", max {int(nv.max())}")
        (st.any_hit if any_hit else st.closest)(
            label, *both(args, o.shape[0], t_min, any_hit))
        return args

    cam_args = compare("camera closest", o_cam, d_cam, 0.0, 1e30, False,
                       False)
    # Surface bounce rays: from the camera hits, directions about the
    # geometric normal; dead lanes (camera misses) carry t_max = 0.
    hit = path.closest_hit(scene, o_cam, d_cam, 0.0, cfg)
    active = ~hit.miss
    sp = shade_surface(scene, hit, o_cam, d_cam)
    o_b = (sp.pos + sp.ng * cfg.ray_eps).contiguous()
    jitter = torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).to(dev)
    d_b = torch.nn.functional.normalize(
        sp.ng + torch.nn.functional.normalize(jitter, dim=-1), dim=-1)
    alive = torch.where(active, 1e30, 0.0)
    for t_min in (1e-3, 0.0):
        compare(f"bounce closest sorted t_min={t_min}", o_b, d_b, t_min,
                alive, True, False)
    # Interior rays: from just inside the surface, uniform directions (most
    # hit the far side; a harder, direction-scattered stream).
    o_in = (sp.pos - sp.ng * cfg.ray_eps).contiguous()
    d_in = torch.nn.functional.normalize(jitter, dim=-1)
    compare("interior closest sorted", o_in, d_in, cfg.ray_eps, alive, True,
            False)
    # Env shadow rays: environment NEE directions from the same points.
    u2 = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    es = lights.sample_env(scene, n, u2)
    t_sh = torch.where(active & es.valid, es.dist * (1.0 - 1e-3), 0.0)
    compare("env shadow any-hit sorted", o_b, es.wi, cfg.ray_eps, t_sh,
            True, True)
    compare("env shadow any-hit unsorted", o_b, es.wi, cfg.ray_eps, t_sh,
            False, True)
    # Ragged ray count (not a multiple of the block size).
    nr = n - 77
    compare("ragged closest", o_cam[:nr], d_cam[:nr], 0.0, 1e30, False,
            False)
    rand_tm = torch.from_numpy(rng.uniform(0.05, 4.0, nr).astype(
        np.float32)).to(dev)
    compare("ragged any-hit random t_max", o_b[:nr], d_b[:nr], 1e-3,
            rand_tm, True, True)

    # Time at the main path's shape: 262,144 morton camera rays.
    ms = time_ms(lambda: tb.trace_blocks(*cam_args, t_min=0.0,
                                         any_hit=False), 50)
    plain_ms = time_ms(lambda: tb.trace_blocks_plain(
        *cam_args, t_min=0.0, any_hit=False), 5, warmup=1)
    return st, ms, plain_ms


def phase_k4(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.ops import fused
    from physically_based_renderer_tpu_torch.utils import config

    out = {"frames_compared": 0, "pixels_compared": 0, "pixels_differ": 0,
           "max_abs_err": 0.0, "max_mean_rel": 0.0, "max_count_rel": 0.0}
    frames = {}
    for label, name, over in (("cornell", "cornell", {}),
                              ("cornell_ggx", "cornell_ggx", {}),
                              ("triangle", "triangle", {}),
                              ("cornell ragged", "cornell",
                               dict(width=24, height=20))):
        bc = config.get(name)
        scene, cam = config.build_scene(bc.scene, dev)
        cfg = dataclasses.replace(bc.render, **over)
        frame = fused.fused_frame(scene, cam, rng_mod.key(0, dev), cfg)
        hdr, count = fused.fused_kernel(frame)
        plain, count_p = fused.fused_plain(frame)
        torch.cuda.synchronize()
        img = (hdr / cfg.spp).cpu().numpy()
        ref = (plain / cfg.spp).cpu().numpy()
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(
                img).all():
            raise AssertionError(f"K4 {label}: shape {img.shape}, finite "
                                 f"{bool(np.isfinite(img).all())}")
        frac, n_bad = render_agreement(img, ref)
        mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
        count_rel = abs(int(count) / int(count_p) - 1.0)
        err = float(np.abs(img - ref).max())
        print(f"K4 {label} {cfg.width}x{cfg.height} x {cfg.spp} spp x "
              f"{cfg.max_bounces} bounces: {frac:.4%} pixels agree "
              f"({n_bad} differ), max |kernel - plain| {err:.3g}, mean rel "
              f"diff {mean_rel:.3g}, ray queries {int(count)} vs "
              f"{int(count_p)}")
        if frac < PIXEL_FRAC or mean_rel > MEAN_REL or count_rel > COUNT_REL:
            raise AssertionError(f"K4 {label}: kernel disagrees with its "
                                 "plain version")
        out["frames_compared"] += 1
        out["pixels_compared"] += cfg.width * cfg.height
        out["pixels_differ"] += n_bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_mean_rel"] = max(out["max_mean_rel"], mean_rel)
        out["max_count_rel"] = max(out["max_count_rel"], count_rel)
        frames[label] = frame

    # Time at the main path's shape: the whole cornell frame.
    ms = time_ms(lambda: fused.fused_kernel(frames["cornell"]), 20)
    plain_ms = time_ms(lambda: fused.fused_plain(frames["cornell"]), 3,
                       warmup=1)
    return out, ms, plain_ms


def render_direct(name, dev, tracer, **over):
    """render_with_stats on a named config with the given tracer: (mean HDR
    image as numpy, {"seconds", "rays", "rays_per_s"})."""
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.utils import config

    bc = config.get(name)
    scene, cam = config.build_scene(bc.scene, dev)
    cfg = dataclasses.replace(bc.render, tracer=tracer, **over)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, count = path.render_with_stats(scene, cam, rng_mod.key(0, dev), cfg)
    hdr = film.mean()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rays = int(count)
    return hdr.cpu().numpy(), {"seconds": dt, "rays": rays,
                               "rays_per_s": rays / dt}


def run_cli(argv):
    """Run the render CLI; return its --stats JSON (echoing its stderr)."""
    from physically_based_renderer_tpu_torch.apps import render
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = render.main(argv)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise AssertionError(f"render CLI exited {rc}")
    return json.loads(err.getvalue().strip().splitlines()[-1])


def render_agreement(img, ref):
    import numpy as np
    ok = (np.abs(img - ref) <= ATOL + RTOL * np.abs(ref)).all(-1)
    return float(ok.mean()), int((~ok).sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from physically_based_renderer_tpu_torch.ops import (cuda_lib, fused,
                                                         resident, tonemap,
                                                         trace_blocks)

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. build
    cuda_lib.library()
    build_s = cuda_lib.BUILD_SECONDS
    print(f"build: {build_s:.2f} s into {cuda_lib.build_dir()}")

    # 2-3. kernels against their plain versions
    k2, k2_ms, k2_plain_ms = phase_k2(dev)
    k3, k3_ms, k3_plain_ms = phase_k3(dev)
    print(f"K2 262144 rays x 32 tris: kernel {k2_ms:.4f} ms, "
          f"plain {k2_plain_ms:.4f} ms")
    print(f"K3 512x512: kernel {k3_ms:.4f} ms, plain {k3_plain_ms:.4f} ms")

    # 4. K1 against its plain version
    k1, k1_ms, k1_plain_ms = phase_k1(dev)
    print(f"K1 262144 helmet_proc camera rays: kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms")

    # 5. K4 against its plain version
    k4, k4_ms, k4_plain_ms = phase_k4(dev)
    print(f"K4 cornell frame 512x512 x 4 spp x 4 bounces: kernel "
          f"{k4_ms:.4f} ms, plain {k4_plain_ms:.4f} ms")

    counters = {"fused": fused, "resident": resident,
                "trace_blocks": trace_blocks, "tonemap": tonemap}
    launches = {name: {} for name in counters}
    runs, goldens = {}, {}

    def drive(label, name, how, tmp, **over):
        """One run of a path with the counts reset just before it: (mean
        HDR image, its stats, the launches it made)."""
        for mod in counters.values():
            mod.LAUNCHES = 0
        if how == "cli":
            png = Path(tmp) / f"{label}.png"
            hdr_path = Path(tmp) / f"{label}.npy"
            argv = [name, "-o", str(png), "--hdr-output", str(hdr_path),
                    "--stats", "--device", "cuda"]
            for flag, key in (("--width", "width"), ("--height", "height"),
                              ("--spp", "spp"), ("--bounces", "max_bounces")):
                if key in over:
                    argv += [flag, str(over[key])]
            stats = run_cli(argv)
            if png.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("render CLI wrote no PNG")
            img = np.load(hdr_path)
        else:
            img, stats = render_direct(name, dev, how, **over)
        return img, stats, {k: mod.LAUNCHES for k, mod in counters.items()}

    with tempfile.TemporaryDirectory() as tmp:
        # 6. the main paths at full size
        for label, name, how in MAIN_PATHS:
            hdr, stats, got = drive(label, name, how, tmp)
            if hdr.shape != (512, 512, 3) or not np.isfinite(hdr).all():
                raise AssertionError(f"{label} film: shape {hdr.shape}, "
                                     f"finite {bool(np.isfinite(hdr).all())}")
            mean = float(hdr.mean())
            lo, hi = FILM_MEAN_BAND[label]
            if not lo <= mean <= hi:
                raise AssertionError(f"{label} film mean {mean} outside "
                                     f"({lo}, {hi})")
            if got != EXPECTED_LAUNCHES[label]:
                raise AssertionError(f"{label} main-path launches {got}, "
                                     f"expected {EXPECTED_LAUNCHES[label]}")
            for k in launches:
                launches[k][label] = got[k]
            runs[label] = {"seconds": stats["seconds"], "rays": stats["rays"],
                           "rays_per_s": stats["rays_per_s"],
                           "film_mean": mean, "launches": got}
            print(f"{label} 512x512: {stats['seconds']:.3f} s, "
                  f"{stats['rays']} ray queries, "
                  f"{stats['rays_per_s']:.4g} rays/s, film mean {mean:.5f}, "
                  f"launches {got}")

        # 7. goldens from the reference package
        for label, name, golden, (size, spp, bounces), how in GOLDENS:
            img, _, got = drive(f"{label}_golden", name, how, tmp,
                                width=size, height=size, spp=spp,
                                max_bounces=bounces)
            want_k4 = int(label == "cornell_ggx_fused")
            if got["fused"] != want_k4:
                raise AssertionError(f"{label} golden render made "
                                     f"{got['fused']} K4 launches, expected "
                                     f"{want_k4}")
            ref = np.load(golden)
            frac, n_bad = render_agreement(img, ref)
            mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
            print(f"{label} golden {size}x{size}: {frac:.4%} pixels agree "
                  f"({n_bad} differ), mean rel diff {mean_rel:.3g}")
            if frac < PIXEL_FRAC or mean_rel > MEAN_REL:
                raise AssertionError(f"{label} {size}x{size} render "
                                     "disagrees with the golden")
            goldens[label] = {"size": size, "pixel_frac": frac,
                              "pixels_differ": n_bad, "mean_rel": mean_rel,
                              "launches": got}

    print(json.dumps({"kernels": [
        {"name": "resident", "route": "cuda",
         "source": "physically_based_renderer_tpu_torch/csrc/resident.cu",
         "replaces": "physically_based_renderer_tpu/ops/resident.py:54",
         "launches": sum(launches["resident"].values()),
         "launches_by_path": launches["resident"],
         "max_abs_err": k2.max_abs_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
        {"name": "tonemap", "route": "cuda",
         "source": "physically_based_renderer_tpu_torch/csrc/tonemap.cu",
         "replaces": "physically_based_renderer_tpu/ops/tonemap.py:52",
         "launches": sum(launches["tonemap"].values()),
         "launches_by_path": launches["tonemap"],
         "max_abs_err": k3["max_abs_err"],
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "trace_blocks", "route": "cuda",
         "source": "physically_based_renderer_tpu_torch/csrc/trace_blocks.cu",
         "replaces": "physically_based_renderer_tpu/ops/pallas_trace.py:54",
         "launches": sum(launches["trace_blocks"].values()),
         "launches_by_path": launches["trace_blocks"],
         "max_abs_err": k1.max_abs_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fused", "route": "cuda",
         "source": "physically_based_renderer_tpu_torch/csrc/fused.cu",
         "replaces": "physically_based_renderer_tpu/ops/fused.py:402",
         "launches": sum(launches["fused"].values()),
         "launches_by_path": launches["fused"],
         "max_abs_err": k4["max_abs_err"],
         "ms": k4_ms, "plain_ms": k4_plain_ms},
    ]}))
    print(json.dumps({
        "card": card, "build_s": build_s,
        "k2": {"rays_compared": k2.rays, "winner_mismatches": k2.mismatch,
               "max_abs_err_t": k2.max_abs_err, "ms": k2_ms,
               "plain_ms": k2_plain_ms, "shape": "262144 rays x 32 tris"},
        "k3": {**k3, "ms": k3_ms, "plain_ms": k3_plain_ms,
               "shape": "512x512x3"},
        "k1": {"rays_compared": k1.rays, "winner_mismatches": k1.mismatch,
               "max_abs_err_t": k1.max_abs_err, "ms": k1_ms,
               "plain_ms": k1_plain_ms,
               "shape": "262144 helmet_proc camera rays x 1024 clusters"},
        "k4": {**k4, "ms": k4_ms, "plain_ms": k4_plain_ms,
               "shape": "cornell frame 512x512 x 4 spp x 4 bounces"},
        "main_paths": runs, "goldens": goldens,
        "seconds": time.perf_counter() - T0,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
