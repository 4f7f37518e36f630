"""The port's CUDA kernels against their plain-torch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device.  The file
imports neither JAX nor PIL, so it also runs on a machine that has only
torch; there, skip the JAX test harness's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.grad import inverse
from physically_based_renderer_tpu_torch.ops import (blocktrace, fused,
                                                     gather, probes, resident,
                                                     tonemap, trace_blocks,
                                                     traverse)
from physically_based_renderer_tpu_torch.scene import types
from physically_based_renderer_tpu_torch.tools import (exp_subtile_dma,
                                                       probe2, probe_mosaic)
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (COUNT_REL, MEAN_REL, PIXEL_FRAC,  # noqa: F401
                          cuda_device, golden_module, render_agreement)


def _hdr(seed, shape):
    g = np.random.default_rng(seed)
    x = g.lognormal(-1.0, 2.0, shape).astype(np.float32)
    x[g.random(shape) < 0.05] *= -1.0
    x[g.random(shape) < 0.05] = 0.0
    x[g.random(shape) < 0.02] = 250.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 512, 3), (37, 53, 3)])
def test_k3_kernel_matches_plain(cuda_device, shape):
    x = torch.from_numpy(_hdr(7, shape)).to(cuda_device)
    before = tonemap.LAUNCHES
    got = tonemap.tonemap(x)
    torch.cuda.synchronize()
    assert tonemap.LAUNCHES == before + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               tonemap.tonemap_plain(x).cpu().numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tris,n_rays", [(32, 262_144), (2048, 100_003)])
def test_k2_kernel_matches_plain(cuda_device, n_tris, n_rays):
    g = np.random.default_rng(9)
    v = (g.uniform(-1, 1, (n_tris, 1, 3))
         + g.normal(0, 0.1, (n_tris, 3, 3))).astype(np.float32)
    soup = torch.from_numpy(np.concatenate(
        [v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1)).to(cuda_device)
    o = torch.from_numpy(g.uniform(-1.2, 1.2, (n_rays, 3)).astype(
        np.float32)).to(cuda_device)
    d = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(n_rays, 3)).astype(np.float32)), dim=-1).to(cuda_device)
    tm = torch.from_numpy(g.uniform(0.05, 3.0, n_rays).astype(
        np.float32)).to(cuda_device)
    for t_min in (0.0, 1e-3):
        before = resident.LAUNCHES
        t_k, i_k = resident.trace(soup, o, d, tm, t_min, False)
        occ_k = resident.trace(soup, o, d, tm, t_min, True)
        torch.cuda.synchronize()
        assert resident.LAUNCHES == before + 2
        t_p, i_p = resident.trace_plain(soup, o, d, tm, t_min, False)
        occ_p = resident.trace_plain(soup, o, d, tm, t_min, True)
        # built with -fmad=false: exact agreement
        assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p)
        assert torch.equal(occ_k, occ_p)


def _k2_case(case, device):
    """(soup, o, d, t_max) of a K2 card case on the cornell soup or a
    random one; t_max per lane."""
    g = np.random.default_rng(21)
    bc = config.get("cornell")
    scene, _ = config.build_scene(bc.scene, "cpu")
    soup = resident.pack_resident_soup(scene.geometry)
    n = {"odd_rays": 1001, "one_ray": 1}.get(case, 262_143)
    o = g.uniform((-0.99, 0.01, -0.99), (0.99, 1.99, 0.99),
                  (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = g.uniform(0.05, 4.0, n).astype(np.float32)
    if case == "dead_lanes":
        # t_max 0, NaN, equal to t_min, negative among live lanes
        pick = g.integers(0, 5, n)
        for code, value in ((1, 0.0), (2, np.nan), (3, 1e-3), (4, -1.0)):
            tm[pick == code] = value
    elif case == "huge_det":
        # a 1e19 triangle inside a group: |det| >= 2^126 on some rays
        huge = torch.tensor([[-1.0, -1.0, -0.5, 1e19, 0.0, 0.0, 0.0, 1e19,
                              0.0]])
        soup = torch.cat([soup[:13], huge, soup[13:]])
    elif case == "one_tri":
        soup = soup[4:5]
    elif case == "max_tris":
        v = (g.uniform(-1, 1, (resident.RESIDENT_MAX_TRIS, 1, 3))
             + g.normal(0, 0.1, (resident.RESIDENT_MAX_TRIS, 3, 3))).astype(
                 np.float32)
        soup = torch.from_numpy(np.concatenate(
            [v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]], 1))
    return [x.to(device).contiguous() for x in (
        soup, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dead_lanes", "huge_det", "odd_rays",
                                  "one_ray", "one_tri", "max_tris"])
def test_k2_cases_match_plain(cuda_device, case):
    """K2 equals its plain version exactly on what its design special-cases:
    lanes it answers without a test, groups run again with the division,
    a last thread with one ray, one triangle (three zero triangles pad its
    group) and the 2048-triangle cap (96 KB of shared memory)."""
    soup, o, d, tm = _k2_case(case, cuda_device)
    if case == "huge_det":
        det = (torch.linalg.cross(d, soup[13, 6:9].expand_as(d))
               * soup[13, 3:6]).sum(dim=1).abs()
        assert 0 < int((det >= 2.0 ** 126).sum()) < det.numel()
    big = torch.full_like(tm, 1e30)
    for t_min in (0.0, 1e-3):
        before = resident.LAUNCHES
        t_k, i_k = resident.trace(soup, o, d, big, t_min, False)
        t_kt, i_kt = resident.trace(soup, o, d, tm, t_min, False)
        occ_k = resident.trace(soup, o, d, tm, t_min, True)
        torch.cuda.synchronize()
        assert resident.LAUNCHES == before + 3
        t_p, i_p = resident.trace_plain(soup, o, d, big, t_min, False)
        t_pt, i_pt = resident.trace_plain(soup, o, d, tm, t_min, False)
        occ_p = resident.trace_plain(soup, o, d, tm, t_min, True)
        assert torch.equal(i_k, i_p) and torch.equal(t_k, t_p)
        assert torch.equal(i_kt, i_pt) and torch.equal(t_kt, t_pt)
        assert torch.equal(occ_k, occ_p)
    if case == "huge_det":
        assert bool((i_p == 13).any())


@pytest.fixture(scope="module")
def helmet_proc():
    bc = config.get("helmet_proc")
    return bc, config.build_scene(bc.scene, "cpu")


def _sphere_rays(n, seed, device):
    """Rays from a box around the helmet_proc sphere, a third starting
    inside it, with random per-ray t_max."""
    g = np.random.default_rng(seed)
    o = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[: n // 3] *= np.float32(0.5)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = g.uniform(0.05, 3.0, n).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (o, d, tm)]


@pytest.mark.cuda
def test_bvh_walk_on_the_card_matches_the_cpu(cuda_device, helmet_proc):
    """The BVH walk (torch ops) on the card against itself on the CPU, on
    helmet_proc's 100,352 triangles: winners equal but for near-ties
    (torch's CUDA cross product may fuse multiply-adds), on at least 99.9%
    of the rays, t within 1e-5 relative where they agree; any-hit masks on
    at least 99.9% of the rays."""
    _, (scene, _) = helmet_proc
    scene = types.with_bvh(dataclasses.replace(scene, clusters=None))
    cpu = _sphere_rays(65_536, 5, "cpu")
    card = [x.to(cuda_device) for x in cpu]
    gpu_scene = types.upload_scene(scene, cuda_device)
    h_c = traverse.intersect_bvh(scene.bvh, scene.geometry, *cpu[:2])
    h_g = traverse.intersect_bvh(gpu_scene.bvh, gpu_scene.geometry,
                                 *card[:2])
    same = h_g.tri.cpu() == h_c.tri
    assert same.float().mean() >= 0.999 and (h_c.tri >= 0).any()
    np.testing.assert_allclose(h_g.t.cpu()[same].numpy(),
                               h_c.t[same].numpy(), rtol=1e-5)
    occ_c = traverse.intersect_bvh(scene.bvh, scene.geometry, *cpu[:2],
                                   t_max=cpu[2], any_hit=True)
    occ_g = traverse.intersect_bvh(gpu_scene.bvh, gpu_scene.geometry,
                                   *card[:2], t_max=card[2], any_hit=True)
    assert (occ_g.cpu() == occ_c).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("n_rays", [65_536, 100_003])
def test_k1_kernel_matches_plain(cuda_device, helmet_proc, sort, n_rays):
    bc, (scene, _) = helmet_proc
    grid = scene.clusters
    grid = type(grid)(**{f: getattr(grid, f).to(cuda_device)
                         for f in grid.__dataclass_fields__})
    o, d, tm = _sphere_rays(n_rays, 11, cuda_device)
    for t_min in (0.0, 1e-3):
        for any_hit, t_max in ((False, 1e30), (True, tm)):
            args, _ = blocktrace.block_inputs(grid, o, d, t_min, t_max,
                                              sort=sort)
            before = trace_blocks.LAUNCHES
            k = trace_blocks.trace_blocks(*args, t_min=t_min,
                                          any_hit=any_hit)
            torch.cuda.synchronize()
            assert trace_blocks.LAUNCHES == before + 1
            p = trace_blocks.trace_blocks_plain(*args, t_min=t_min,
                                                any_hit=any_hit)
            # built with -fmad=false: exact agreement
            if any_hit:
                assert torch.equal(k, p)
            else:
                assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0])


@pytest.mark.cuda
def test_main_path_matches_golden(cuda_device):
    golden = golden_module()
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, cuda_device)
    # The dense path: under "auto" a CUDA cornell scene takes K4.
    cfg = dataclasses.replace(bc.render, width=golden.SIZE,
                              height=golden.SIZE, spp=golden.SPP,
                              max_bounces=golden.BOUNCES, tracer="resident")
    before = resident.LAUNCHES
    film, _ = path.render_with_stats(scene, cam,
                                     rng.key(golden.SEED, cuda_device), cfg)
    torch.cuda.synchronize()
    # per sample: (bounces + 1) closest queries + bounces shadow queries
    assert resident.LAUNCHES - before == golden.SPP * (2 * golden.BOUNCES + 1)
    img, ref = film.mean().cpu().numpy(), np.load(golden.GOLDEN)
    frac, _ = render_agreement(img, ref)
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL


@pytest.mark.cuda
def test_helmet_proc_path_matches_golden(cuda_device, helmet_proc):
    h = golden_module().HELMET
    bc, _ = helmet_proc
    scene, cam = config.build_scene(bc.scene, cuda_device)
    cfg = dataclasses.replace(bc.render, width=h["size"], height=h["size"],
                              spp=h["spp"], max_bounces=h["bounces"])
    before = (trace_blocks.LAUNCHES, resident.LAUNCHES)
    film, _ = path.render_with_stats(scene, cam,
                                     rng.key(h["seed"], cuda_device), cfg)
    torch.cuda.synchronize()
    # per sample: (bounces + 1) closest queries + bounces env shadow queries
    assert (trace_blocks.LAUNCHES - before[0],
            resident.LAUNCHES - before[1]) == (h["spp"] * (2 * h["bounces"]
                                                           + 1), 0)
    img, ref = film.mean().cpu().numpy(), np.load(h["path"])
    frac, _ = render_agreement(img, ref)
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL


# (config, render settings) of the K4 tests: each config K4 takes, small,
# and a pixel count that fills no whole block.
K4_CASES = {
    "triangle": ("triangle", dict(width=64, height=64, spp=2,
                                  max_bounces=1)),
    "cornell": ("cornell", dict(width=64, height=64, spp=2, max_bounces=3)),
    "cornell_ggx": ("cornell_ggx", dict(width=64, height=64, spp=2,
                                        max_bounces=2)),
    "cornell_ragged": ("cornell", dict(width=24, height=20, spp=2,
                                       max_bounces=2)),
    "cornell_spp1": ("cornell", dict(width=64, height=64, spp=1,
                                     max_bounces=3)),
    "cornell_ggx_spp3": ("cornell_ggx", dict(width=40, height=36, spp=3,
                                             max_bounces=2)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K4_CASES))
def test_k4_kernel_matches_plain(cuda_device, case):
    name, kw = K4_CASES[case]
    bc = config.get(name)
    scene, cam = config.build_scene(bc.scene, cuda_device)
    frame = fused.fused_frame(scene, cam, rng.key(0, cuda_device),
                              dataclasses.replace(bc.render, **kw))
    before = fused.LAUNCHES
    hdr, count = fused.fused_kernel(frame)
    torch.cuda.synchronize()
    assert fused.LAUNCHES == before + 1
    plain, count_p = fused.fused_plain(frame)
    assert hdr.shape == plain.shape == (kw["height"], kw["width"], 3)
    assert bool(torch.isfinite(hdr).all())
    img, ref = hdr.cpu().numpy(), plain.cpu().numpy()
    frac, _ = render_agreement(img, ref)
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL
    assert abs(int(count) / int(count_p) - 1.0) <= COUNT_REL


@pytest.mark.cuda
def test_k4_beyond_the_checked_reciprocal(cuda_device):
    """The triangle config with its one triangle moved half a unit below the
    camera and grown to edges of 1e19: |det| = 1e38 |d.z| lies at or above
    2^126, where the kernel's branch-free reciprocal is not checked, for
    the camera rays with |d.z| > 0.85 and below it for the others.  The
    kernel's groups that meet such a det divide, so the frame equals the
    plain version's, and those rays hit (t = 0.5 / |d.z|; with a flushed
    reciprocal they would miss)."""
    bc = config.get("triangle")
    scene, cam = config.build_scene(bc.scene, cuda_device)
    frame = fused.fused_frame(scene, cam, rng.key(0, cuda_device),
                              dataclasses.replace(bc.render, width=32,
                                                  height=32, spp=1))
    tri = frame.tri.clone()
    tri[0, 0:9] = torch.tensor([-1.0, -1.0, 2.5, 1e19, 0.0, 0.0, 0.0, 1e19,
                                0.0], device=cuda_device)
    frame = dataclasses.replace(frame, tri=tri)
    eye, fv = frame.cam[0:3], frame.cam[9:12]
    assert eye.tolist() == [0.0, 0.0, 3.0] and fv.tolist() == [0.0, 0.0,
                                                              -1.0]
    hdr, count = fused.fused_kernel(frame)
    plain, count_p = fused.fused_plain(frame)
    torch.cuda.synchronize()
    # Every camera ray hits the plane, lit from straight above.
    assert bool((plain > 0.0).all())
    img, ref = hdr.cpu().numpy(), plain.cpu().numpy()
    frac, _ = render_agreement(img, ref)
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL
    assert abs(int(count) / int(count_p) - 1.0) <= COUNT_REL


@pytest.mark.cuda
def test_fused_path_matches_golden(cuda_device):
    f = golden_module().FUSED
    bc = config.get(f["config"])
    scene, cam = config.build_scene(bc.scene, cuda_device)
    cfg = dataclasses.replace(bc.render, width=f["size"], height=f["size"],
                              spp=f["spp"], max_bounces=f["bounces"])
    counters = (fused, resident, trace_blocks)
    before = [m.LAUNCHES for m in counters]
    film, _ = path.render_with_stats(scene, cam,
                                     rng.key(f["seed"], cuda_device), cfg)
    torch.cuda.synchronize()
    # one K4 launch renders the frame; no tracer kernel runs
    assert [m.LAUNCHES - b for m, b in zip(counters, before)] == [1, 0, 0]
    img, ref = film.mean().cpu().numpy(), np.load(f["path"])
    frac, _ = render_agreement(img, ref)
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL


def _k5_indices(pattern, t, n, dtype, g, device):
    """Indices of one K5b case, -1 and T among them: uniform random;
    sorted (long runs of equal indices); alternating 0, 1, ..., T - 1
    (runs of one); runs of 37 rows (runs that cross the 32-row warp batch
    and the 64-row run edges)."""
    if pattern == "alternating":
        idx = torch.arange(n, device=device) % t
    elif pattern == "runs37":
        idx = (torch.arange(n, device=device) // 37) % t
    else:
        idx = torch.randint(-1, t + 1, (n,), device=device, generator=g)
        if pattern == "sorted":
            idx = torch.sort(idx).values
    idx = idx.to(dtype)
    idx[n // 2] = -1
    idx[n // 3] = t
    return idx


# K5b's accumulators (csrc/gather.cu, chosen there from T x W): a table a
# warp (sixteen T x W tables fit the opt-in shared memory: [32, 86], [2,
# 20], [32, 20]), one a block ([600, 86], 206 KB), global atomics
# ([100,352, 86], [174,762, 16]).  N: a multiple of the 64-row run and not.
@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "sorted", "alternating",
                                     "runs37"])
@pytest.mark.parametrize("t,w,n,dtype", [(32, 86, 262_144, torch.int32),
                                         (2, 20, 1_000_003, torch.int64),
                                         (32, 20, 262_147, torch.int32),
                                         (600, 86, 262_147, torch.int64),
                                         (100_352, 86, 262_144, torch.int32),
                                         (174_762, 16, 4_097, torch.int64)])
def test_k5_kernels_match_plain(cuda_device, t, w, n, dtype, pattern):
    """K5a bit-equal to its plain version; K5b equal to its plain version:
    the cotangents are multiples of 2^-10 below 8, whose sums are exact in
    any order (every partial sum stays far below 2^14), so the kernel's
    other order of the sums changes no bit, even where a row takes 500,000
    of them; indices -1 and T included."""
    g = torch.Generator(device=cuda_device).manual_seed(t + w)
    table = torch.randn((t, w), device=cuda_device, generator=g)
    idx = _k5_indices(pattern, t, n, dtype, g, cuda_device)
    ct = torch.round(torch.randn((n, w), device=cuda_device, generator=g)
                     .clamp(-7.9, 7.9) * 1024.0) / 1024.0
    before = (gather.LAUNCHES_FWD, gather.LAUNCHES_BWD)
    tab = table.clone().requires_grad_(True)
    out = gather.take_rows(tab, idx)
    out.backward(ct)
    torch.cuda.synchronize()
    assert (gather.LAUNCHES_FWD, gather.LAUNCHES_BWD) == (before[0] + 1,
                                                          before[1] + 1)
    assert torch.equal(out.detach(), gather.take_rows_plain(table, idx))
    assert torch.equal(tab.grad, gather.take_rows_bwd_plain(idx, ct, t))


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["random", "sorted", "alternating"])
def test_k5b_float_cotangents_match_plain(cuda_device, pattern):
    """K5b on real-valued cotangents at cornell's shape: within K5B_REL =
    1e-5 of max|plain| (the order of the sums differs)."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    t, n, w = 32, 262_147, 86
    idx = _k5_indices(pattern, t, n, torch.int32, g, cuda_device)
    ct = torch.randn((n, w), device=cuda_device, generator=g)
    got = gather.gather_bwd(idx, ct, t)
    plain = gather.take_rows_bwd_plain(idx, ct, t)
    assert (got - plain).abs().max() <= 1e-5 * plain.abs().max()


# K5a's routes (csrc/gather.cu, chosen there from W and the table's
# address): W a multiple of 4 on an aligned table moves float4 quarters of
# rows; anything else float4s of the output gathered across rows.
K5A_WIDTHS = (1, 3, 12, 16, 20, 86)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("w", K5A_WIDTHS)
def test_k5a_routes_match_plain(cuda_device, w, dtype):
    """K5a bit-equal to its plain version on a small and a large table, for
    ragged N (N*W no multiple of 4) and N below one float4, with indices -1
    and T among them; and on a table 4 bytes past a 16-byte boundary,
    which takes the rows route whatever W is."""
    g = torch.Generator(device=cuda_device).manual_seed(w)
    for t in (7, 32, 99_400):
        big = torch.randn(t * w + 1, device=cuda_device, generator=g) * 1e3
        for table in (big[:-1].view(t, w), big[1:].view(t, w)):
            for n in (1, 3, 4_097, 262_147):
                idx = torch.randint(-1, t + 1, (n,), device=cuda_device,
                                    generator=g, dtype=dtype)
                idx[0] = -1 if n < 3 else t
                before = gather.LAUNCHES_FWD
                out = gather.gather_fwd(table, idx)
                torch.cuda.synchronize()
                assert gather.LAUNCHES_FWD == before + 1
                assert torch.equal(out, gather.take_rows_plain(table, idx)), (
                    t, w, n, table.data_ptr() % 16)


@pytest.mark.cuda
def test_k5_rejects_what_it_does_not_take(cuda_device):
    table = torch.ones((4, 3), device=cuda_device)
    idx = torch.zeros(5, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        gather.take_rows(table.double(), idx)
    with pytest.raises(TypeError):
        gather.take_rows(table, idx.short())
    with pytest.raises(ValueError):
        gather.take_rows(table.t(), idx)
    assert torch.equal(gather.take_rows(table, idx),
                       gather.take_rows_plain(table, idx))


@pytest.mark.cuda
def test_gradient_step_on_card_equals_cpu(cuda_device):
    """One render() + pixel_loss gradient on cornell at 32x32: the card's
    (K2, K5a, K5b) against the CPU's plain versions, within 1e-4 *
    max|g|."""
    bc = config.get("cornell")
    cfg = dataclasses.replace(bc.render, width=32, height=32, spp=2,
                              max_bounces=2)
    grads = []
    for dev in ("cpu", cuda_device):
        scene, cam = config.build_scene(bc.scene, dev)
        params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
            scene, base_color=True, roughness=True, metallic=True,
            emissive=True))
        before = gather.LAUNCHES_BWD
        img = path.render(inverse.apply_params(scene, params), cam,
                          rng.key(0, dev), cfg).mean()
        inverse.pixel_loss(img, torch.full_like(img, 0.2)).backward()
        assert (gather.LAUNCHES_BWD > before) == (dev != "cpu")
        grads.append({k: v.grad.cpu().numpy() for k, v in params.items()})
    for k, want in grads[0].items():
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(grads[1][k] - want).max() <= 1e-4 * scale, k


@pytest.fixture(scope="module")
def helmet():
    bc = config.get("helmet")
    return bc, config.build_scene(bc.scene, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_k1_kernel_matches_plain_at_chunk_16(cuda_device, helmet_proc, sort):
    """16 clusters a step: 9 x 16 x 128 x 4 = 72 KB of shared memory, the
    opt-in branch of csrc/trace_blocks.cu."""
    bc, (scene, _) = helmet_proc
    grid = scene.clusters
    grid = type(grid)(**{f: getattr(grid, f).to(cuda_device)
                         for f in grid.__dataclass_fields__})
    o, d, tm = _sphere_rays(100_003, 12, cuda_device)
    for any_hit, t_max in ((False, 1e30), (True, tm)):
        args, _ = blocktrace.block_inputs(grid, o, d, 1e-3, t_max, sort=sort,
                                          chunk=16)
        before = trace_blocks.LAUNCHES
        k = trace_blocks.trace_blocks(*args, t_min=1e-3, any_hit=any_hit,
                                      chunk=16)
        torch.cuda.synchronize()
        assert trace_blocks.LAUNCHES == before + 1
        p = trace_blocks.trace_blocks_plain(*args, t_min=1e-3,
                                            any_hit=any_hit, chunk=16)
        if any_hit:
            assert torch.equal(k, p)
        else:
            assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0])


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_k1_kernel_matches_plain_at_block_512(cuda_device, helmet, sort):
    """K1 at the helmet config's block size (512 rays a CTA, 16 warps in
    the early-exit reduction) on the .glb helmet's clusters."""
    bc, (scene, _) = helmet
    assert bc.render.block_size == 512
    grid = scene.clusters
    grid = type(grid)(**{f: getattr(grid, f).to(cuda_device)
                         for f in grid.__dataclass_fields__})
    o, d, tm = _sphere_rays(100_003, 13, cuda_device)
    for t_min in (0.0, 1e-3):
        for any_hit, t_max in ((False, 1e30), (True, tm)):
            args, _ = blocktrace.block_inputs(
                grid, o, d, t_min, t_max, sort=sort,
                block=bc.render.block_size, max_u=bc.render.max_u,
                chunk=bc.render.chunk)
            assert args[1].shape[1] == 512
            k = trace_blocks.trace_blocks(*args, t_min=t_min, any_hit=any_hit,
                                          chunk=bc.render.chunk)
            torch.cuda.synchronize()
            p = trace_blocks.trace_blocks_plain(*args, t_min=t_min,
                                                any_hit=any_hit,
                                                chunk=bc.render.chunk)
            if any_hit:
                assert torch.equal(k, p)
            else:
                assert torch.equal(k[1], p[1]) and torch.equal(k[0], p[0])


def _assert_closest_agrees(kern, plain):
    """chip_smoke.py's TraceStats: winners equal but for exact ties (at most
    1e-4 of the rays, t within 1e-5 relative there), hit or miss equal, t
    bit-equal where the winners agree and on misses."""
    (tk, ik), (tp, ip) = kern, plain
    assert torch.equal(ik < 0, ip < 0)
    diff = ik != ip
    assert int(diff.sum()) <= 1e-4 * ik.numel()
    if bool(diff.any()):
        rel = (tk[diff] - tp[diff]).abs() / tp[diff].abs().clamp_min(1e-30)
        assert rel.max().item() <= 1e-5
    assert torch.equal(tk[~diff], tp[~diff])


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 4, 16])
@pytest.mark.parametrize("block", [32, 96, 128, 256, 512, 1024])
def test_k1_kernel_matches_plain_at_block_and_chunk(cuda_device, helmet_proc,
                                                    block, chunk):
    """K1 at each rays-a-thread R the kernel picks (B = 32, 96: R = 1;
    128-1024: R = 2) and chunk (1, 4, 16: one to 16 clusters a buffer,
    144 KB of double-buffered shared memory at 16), closest and any hit, on
    a ragged ray count."""
    bc, (scene, _) = helmet_proc
    grid = scene.clusters
    grid = type(grid)(**{f: getattr(grid, f).to(cuda_device)
                         for f in grid.__dataclass_fields__})
    o, d, tm = _sphere_rays(20_011, block + chunk, cuda_device)
    for any_hit, t_max in ((False, 1e30), (True, tm)):
        args, _ = blocktrace.block_inputs(grid, o, d, 1e-3, t_max, sort=True,
                                          block=block, chunk=chunk)
        before = trace_blocks.LAUNCHES
        k = trace_blocks.trace_blocks(*args, t_min=1e-3, any_hit=any_hit,
                                      chunk=chunk)
        torch.cuda.synchronize()
        assert trace_blocks.LAUNCHES == before + 1
        p = trace_blocks.trace_blocks_plain(*args, t_min=1e-3,
                                            any_hit=any_hit, chunk=chunk)
        if any_hit:
            assert torch.equal(k, p)
            assert 0 < int(k.sum()) < k.numel()
        else:
            _assert_closest_agrees(k, p)
            assert 0 < int((k[1] >= 0).sum()) < k[1].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [96, 128])
def test_k1_groups_beyond_the_reciprocal_divide(cuda_device, b):
    """A triangle with edges of 1e19 gives |det| = 1e38 >= 2^126, where the
    kernel's reciprocal is not used: its group is run again with the
    division (whose denormal 1/det the flushed reciprocal would zero, and
    every ray would miss).  Rays along +z from z = -1 hit it at t = 1; a
    block of 96 runs one ray a thread, of 128 two."""
    soup = torch.zeros((2, 9, 128))
    soup[0, :, 0] = torch.tensor([-1e18, -1e18, 0.0, 1e19, 0.0, 0.0,
                                  0.0, 1e19, 0.0])
    g = np.random.default_rng(17)
    o = torch.from_numpy(np.concatenate(
        [g.uniform(-0.5, 0.5, (b, 2)), -np.ones((b, 1))], 1).astype(
            np.float32))[None]
    d = torch.tensor([0.0, 0.0, 1.0]).expand(1, b, 3).contiguous()
    u_idx = torch.tensor([[0, 1, 1, 1]], dtype=torch.int32)
    n_valid = torch.tensor([1], dtype=torch.int32)
    entry = torch.zeros((1, 4))
    for any_hit, t_max in ((False, 1e30), (True, 2.0)):
        args = [x.to(cuda_device).contiguous() for x in (
            u_idx, o, d, torch.full((1, b), t_max), soup, n_valid, entry)]
        k = trace_blocks.trace_blocks(*args, t_min=1e-3, any_hit=any_hit)
        p = trace_blocks.trace_blocks_plain(*args, t_min=1e-3,
                                            any_hit=any_hit)
        if any_hit:
            assert bool(p.all()) and torch.equal(k, p)
        else:
            assert bool((p[1] == 0).all())
            assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])


@pytest.mark.cuda
def test_k1_reciprocal_equals_division(cuda_device):
    """The branch-free reciprocal of K1 and K4 (csrc/rcp.cuh) equals
    1.0f / x on every float with |x| in [1e-9, 2^126), the range it
    serves."""
    assert trace_blocks.rcp_mismatches(cuda_device) == 0


@pytest.mark.cuda
def test_helmet_path_matches_golden(cuda_device, helmet):
    h = golden_module().HELMET_GLB
    bc, _ = helmet
    scene, cam = config.build_scene(bc.scene, cuda_device)
    cfg = dataclasses.replace(bc.render, width=h["size"], height=h["size"],
                              spp=h["spp"], max_bounces=h["bounces"])
    before = (trace_blocks.LAUNCHES, fused.LAUNCHES)
    film, _ = path.render_with_stats(scene, cam,
                                     rng.key(h["seed"], cuda_device), cfg)
    torch.cuda.synchronize()
    # per sample: (bounces + 1) closest queries + bounces x (emitter + env)
    # shadow queries
    assert (trace_blocks.LAUNCHES - before[0], fused.LAUNCHES - before[1]) == (
        h["spp"] * (3 * h["bounces"] + 1), 0)
    img, ref = film.mean().cpu().numpy(), np.load(h["path"])
    frac, _ = render_agreement(img, ref)
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL


@pytest.mark.cuda
@pytest.mark.parametrize("data", sorted(probe2.STACK_DATA))
def test_p1_kernel_matches_plain(cuda_device, data):
    boxes = torch.from_numpy(probe2.scalar_stack_boxes(data))
    before = probes.LAUNCHES["scalar_stack"]
    out, leaves = probes.scalar_stack(boxes.to(cuda_device))
    torch.cuda.synchronize()
    assert probes.LAUNCHES["scalar_stack"] == before + 1
    want_out, want_leaves = probes.scalar_stack_plain(boxes)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(leaves.cpu(), want_leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [1.0, 0.9, 0.7])
@pytest.mark.parametrize("n", [1, 3, 5, 1001, 2047, 5001, 8191])
def test_p1_kernel_matches_plain_on_trees(cuda_device, n, rate):
    """The level-parallel P1 on trees of every depth up to the cap: the
    count, the leaves and their pop order equal the walk's."""
    boxes = torch.from_numpy(probe2.tree_boxes(n, rate))
    out, leaves = probes.scalar_stack(boxes.to(cuda_device))
    want_out, want_leaves = probes.scalar_stack_plain(boxes)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(leaves.cpu(), want_leaves)
    # an unaligned view takes the kernel's scalar loads
    padded = torch.zeros(6 * n + 1)
    padded[1:] = boxes
    view = padded.to(cuda_device)[1:]
    assert view.data_ptr() % 16 != 0
    out, leaves = probes.scalar_stack(view)
    assert torch.equal(out.cpu(), want_out)
    assert torch.equal(leaves.cpu(), want_leaves)


@pytest.mark.cuda
@pytest.mark.parametrize("route", probes.RELAYOUT_ROUTES)
def test_p2_kernel_matches_plain(cuda_device, route):
    """Each route bit-equal to the plain version on the probe's tile and on
    three random ones, one launch a call."""
    tiles = [probe2.relayout_input()] + [
        np.random.default_rng(seed).integers(-500, 500, (8, 128)).astype(
            np.float32) for seed in range(3)]
    for x_np in tiles:
        x = torch.from_numpy(x_np).to(cuda_device)
        before = probes.LAUNCHES["relayout"]
        got = probes.relayout(x, route)
        torch.cuda.synchronize()
        assert probes.LAUNCHES["relayout"] == before + 1
        assert torch.equal(got, probes.relayout_plain(x))
    if route == "elementwise":
        view = torch.zeros(8 * 128 + 1, device=cuda_device)[1:].view(8, 128)
        with pytest.raises(ValueError):
            probes.relayout(view, route)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,l", [(1024, 32, 512), (100, 7, 64),
                                   (33, 32, 1500)])
def test_p3_kernel_matches_plain(cuda_device, n, r, l):
    g = np.random.default_rng(n)
    win = torch.from_numpy(g.integers(0, l, (n, 1)).astype(np.int32)).to(
        cuda_device)
    rows = torch.from_numpy(g.normal(size=(r, l)).astype(np.float32)).to(
        cuda_device)
    before = probes.LAUNCHES["onehot_mm"]
    got = probes.onehot_mm(win, rows)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["onehot_mm"] == before + 1
    assert torch.equal(got, probes.onehot_mm_plain(win, rows))
    assert torch.equal(got, rows.t()[win[:, 0].long()])


@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(probe2.GATHER_SHAPES))
def test_p4_kernel_matches_plain(cuda_device, tag):
    rows, lanes, axis = probe2.GATHER_SHAPES[tag]
    x, idx = (torch.from_numpy(a).to(cuda_device)
              for a in probe2.gather_inputs(rows, lanes, axis, seed=1))
    idx[0, :3] = torch.tensor([-1, rows + lanes, 0])     # clamped
    before = probes.LAUNCHES["gather"]
    got = probes.gather(x, idx, axis)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["gather"] == before + 1
    assert torch.equal(got, probes.gather_plain(x, idx, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,l", [(1024, 32, 512), (100, 7, 64),
                                   (33, 32, 1500)])
def test_p3_kernel_matches_plain_on_non_finite_rows(cuda_device, n, r, l):
    """Rows with +-0.0, inf, -inf and NaN, win at -1, at L, at a non-finite
    lane and in range: NaN where the plain version has NaN, every other
    value bit for bit."""
    win, rows = (torch.from_numpy(a).to(cuda_device)
                 for a in probe2.onehot_edge_inputs(n, r, l))
    before = probes.LAUNCHES["onehot_mm"]
    got = probes.onehot_mm(win, rows)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["onehot_mm"] == before + 1
    assert probes.same_or_both_nan(got, probes.onehot_mm_plain(win, rows))
    assert probes.same_or_both_nan(got, probes.onehot_mm_plain(win.cpu(),
                                                               rows.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("tag", sorted(probe2.GATHER_SHAPES))
def test_p4_kernel_matches_plain_on_edge_data(cuda_device, tag):
    """-0.0 in x comes out as -0.0; indices at -1, past the end and at the
    int32 extremes are clamped; one launch."""
    rows, lanes, axis = probe2.GATHER_SHAPES[tag]
    x, idx = (torch.from_numpy(a).to(cuda_device)
              for a in probe2.gather_edge_inputs(rows, lanes, axis))
    before = probes.LAUNCHES["gather"]
    got = probes.gather(x, idx, axis)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["gather"] == before + 1
    assert probes.same_bits(got, probes.gather_plain(x, idx, axis))


def _two_column_slab(rows, lanes, axis):
    per = -(-rows // 2)
    return probes.GatherPlan("slab", 2, per, min(1024, -(-per * 2 // 32) * 32))


_P4_SHAPES = [*probe2.GATHER_SHAPES.values(), (37, 53, 0), (37, 53, 1),
              (6, 130, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("route,shape", [
    (route, shape) for route in ("direct", "slab", "slab2")
    for shape in _P4_SHAPES if route != "slab2" or shape[2] == 0])
def test_p4_routes_match_plain(cuda_device, monkeypatch, route, shape):
    """Each of P4's routes at every shape of the tool and at ragged ones
    (lanes not a multiple of 4: 4- and 8-byte slab pieces; 2-column slabs
    along axis 0 only), also on a table and indices that do not start on a
    16-byte boundary."""
    rows, lanes, axis = shape
    plans = {"direct": lambda *_: probes.direct_plan(),
             "slab": lambda r, l, a: (probes.slab_plan(r, l, a)
                                      or _two_column_slab(r, l, a)),
             "slab2": _two_column_slab}
    monkeypatch.setattr(probes, "gather_plan", plans[route])
    x_np, idx_np = probe2.gather_edge_inputs(rows, lanes, axis, seed=3)
    for offset in (0, 1):
        x = torch.empty(x_np.size + offset, device=cuda_device)
        x[offset:] = torch.from_numpy(x_np.reshape(-1)).to(cuda_device)
        idx = torch.empty(idx_np.size + offset, dtype=torch.int32,
                          device=cuda_device)
        idx[offset:] = torch.from_numpy(idx_np.reshape(-1)).to(cuda_device)
        x, idx = (t[offset:].view(rows, lanes) for t in (x, idx))
        before = probes.LAUNCHES["gather"]
        got = probes.gather(x, idx, axis)
        torch.cuda.synchronize()
        assert probes.LAUNCHES["gather"] == before + 1
        assert probes.same_bits(got, probes.gather_plain(x, idx, axis))


@pytest.mark.cuda
def test_sector_read_matches_plain(cuda_device):
    g = np.random.default_rng(4)
    table = torch.from_numpy(g.normal(size=(16384, 128)).astype(
        np.float32)).to(cuda_device)
    addr = torch.from_numpy(g.integers(0, table.numel(), 1 << 16).astype(
        np.int32)).to(cuda_device)
    got = probes.sector_read(table, addr)
    torch.cuda.synchronize()
    assert torch.equal(got, probes.sector_read_plain(table, addr))


@pytest.mark.cuda
@pytest.mark.parametrize("case", probe_mosaic.GATHER_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-axis{c[2]}")
def test_p5_kernel_matches_plain(cuda_device, case):
    rows, lanes, axis, reps, _ = case
    x_np, idx_np = probe_mosaic.gather_inputs(rows, lanes, axis)
    idx_np[0, :2] = (-3, 2 * (rows + lanes))       # floor modulo
    x, idx = torch.from_numpy(x_np), torch.from_numpy(idx_np)
    before = probes.LAUNCHES["mosaic_gather"]
    got = probes.mosaic_gather(x.to(cuda_device), idx.to(cuda_device), axis,
                               reps)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["mosaic_gather"] == before + 1
    assert torch.equal(got.cpu(), probes.mosaic_gather_plain(x, idx, axis,
                                                             reps))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case", [c[:4] for c in probe_mosaic.GATHER_CASES]
    + list(probe_mosaic.GATHER_EXTRA),
    ids=lambda c: f"{c[0]}x{c[1]}-axis{c[2]}-x{c[3]}")
def test_p5_kernel_matches_plain_on_random_floats(cuda_device, case):
    """Every slab plan, the direct route, reps 0 and 1 and ragged shapes,
    on floats whose sums round (so only the rep order gives the plain
    version's bits) and indices in [-3 size, 3 size)."""
    rows, lanes, axis, reps = case
    x, idx = (torch.from_numpy(a) for a in
              probe_mosaic.gather_random_inputs(rows, lanes, axis, seed=2))
    before = probes.LAUNCHES["mosaic_gather"]
    got = probes.mosaic_gather(x.to(cuda_device), idx.to(cuda_device), axis,
                               reps)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["mosaic_gather"] == before + 1
    assert torch.equal(got.cpu(), probes.mosaic_gather_plain(x, idx, axis,
                                                             reps))


@pytest.mark.cuda
@pytest.mark.parametrize("data", sorted(probe2.STACK_DATA))
def test_p6_kernel_matches_plain(cuda_device, data):
    boxes = torch.from_numpy(probe2.scalar_stack_boxes(data))
    before = probes.LAUNCHES["mosaic_scalar_stack"]
    got = probes.mosaic_scalar_stack(boxes.to(cuda_device))
    torch.cuda.synchronize()
    assert probes.LAUNCHES["mosaic_scalar_stack"] == before + 1
    assert torch.equal(got.cpu(), probes.mosaic_scalar_stack_plain(boxes))


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [1.0, 0.9, 0.7])
@pytest.mark.parametrize("n", [1, 3, 5, 1001, 2047, 5001, 8191])
def test_p6_kernel_matches_plain_on_trees(cuda_device, n, rate):
    """The level-parallel P6 on trees of every depth up to the cap, and on
    an unaligned view (the scalar loads)."""
    boxes = torch.from_numpy(probe2.tree_boxes(n, rate))
    want = probes.mosaic_scalar_stack_plain(boxes)
    got = probes.mosaic_scalar_stack(boxes.to(cuda_device))
    assert torch.equal(got.cpu(), want)
    padded = torch.zeros(6 * n + 1)
    padded[1:] = boxes
    view = padded.to(cuda_device)[1:]
    assert view.data_ptr() % 16 != 0
    assert torch.equal(probes.mosaic_scalar_stack(view).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("data", sorted(probe_mosaic.CHUNK_DATA))
def test_p7_kernel_matches_plain(cuda_device, data):
    o, t = (torch.from_numpy(a) for a in probe_mosaic.chunk_inputs(data))
    before = probes.LAUNCHES["chunk"]
    got = probes.chunk(o.to(cuda_device), t.to(cuda_device), 8)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["chunk"] == before + 1
    # rcp_rn is 1/det on (1e-9, 2^126), the group divides beyond, and
    # -fmad=false: bit for bit
    assert probes.same_bits(got.cpu(), probes.chunk_plain(o, t, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("b,w,n_chunks", [(1, 512, 8), (257, 513, 5),
                                          (3, 100, 9), (256, 1, 1),
                                          (5, 7, 0)])
def test_p7_kernel_matches_plain_on_other_shapes(cuda_device, b, w,
                                                 n_chunks):
    """Rays that fill no CTA, columns that fill no warp, chunks that fill
    no group of four (the tail's tests masked), no chunk at all."""
    o, t = (torch.from_numpy(a) for a in probe_mosaic.chunk_inputs("random"))
    o = o.repeat(1, 2)[:, :b].contiguous()
    t = t.repeat(1, 2)[:, :w].contiguous()
    got = probes.chunk(o.to(cuda_device), t.to(cuda_device), n_chunks)
    assert probes.same_bits(got.cpu(), probes.chunk_plain(o, t, n_chunks))


def _route(monkeypatch, route):
    """P8 on `route` ("row_sums" or "direct") at every size; None leaves
    the route rule's."""
    if route is not None:
        monkeypatch.setattr(probes, "subtile_copy_route",
                            lambda *_: route)


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "row_sums", "direct"])
@pytest.mark.parametrize("nb", [exp_subtile_dma.NB, 3])
def test_p8_kernel_matches_plain(cuda_device, nb, route, monkeypatch):
    """Both routes (None: the route rule's, row sums at NB, direct at 3)
    do the plain version's additions in its order: bit for bit, indices
    clamped."""
    src_np, idx_np = exp_subtile_dma.inputs(1, nb)
    idx_np[:2] = (-1, exp_subtile_dma.C)
    src, idx = torch.from_numpy(src_np), torch.from_numpy(idx_np)
    _route(monkeypatch, route)
    before = probes.LAUNCHES["subtile_copy"]
    got = probes.subtile_copy(src.to(cuda_device), idx.to(cuda_device),
                              exp_subtile_dma.NI, exp_subtile_dma.CH)
    torch.cuda.synchronize()
    assert probes.LAUNCHES["subtile_copy"] == before + 1
    plain = probes.subtile_copy_plain(src, idx, exp_subtile_dma.NI,
                                      exp_subtile_dma.CH)
    assert probes.same_bits(got.cpu(), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,ni,ch", [(1024, 8, 4), (7, 3, 32), (64, 1, 1)])
def test_p8_routes_match_plain_at_other_shapes(cuda_device, nb, ni, ch,
                                               monkeypatch):
    """Both routes at ch up to a CTA of 1,024 threads and one step."""
    g = np.random.default_rng(nb + ni + ch)
    src = torch.from_numpy(g.normal(size=(300, 16, 32)).astype(np.float32))
    idx = torch.from_numpy(g.integers(-2, 302, nb * ni * ch).astype(
        np.int32))
    plain = probes.subtile_copy_plain(src, idx, ni, ch)
    for route in ("row_sums", "direct"):
        _route(monkeypatch, route)
        got = probes.subtile_copy(src.to(cuda_device), idx.to(cuda_device),
                                  ni, ch)
        assert probes.same_bits(got.cpu(), plain), route


@pytest.mark.cuda
def test_subtile_read_matches_plain(cuda_device):
    src, idx = (torch.from_numpy(a) for a in exp_subtile_dma.inputs(3, 64))
    got = probes.subtile_read(src.to(cuda_device), idx.to(cuda_device),
                              exp_subtile_dma.NI, exp_subtile_dma.CH)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), probes.subtile_read_plain(
        src, idx, exp_subtile_dma.NI, exp_subtile_dma.CH))


@pytest.mark.cuda
def test_sharded_paths_on_one_nccl_rank(cuda_device, tmp_path):
    """parallel/ on a world of one NCCL rank: the sharded render, the 1x1
    2-D render and the ring render equal render() bit for bit, and the
    sharded step's loss equals the plain step's (its gradients differ by
    K5b's atomics at most)."""
    import torch.distributed as dist

    from physically_based_renderer_tpu_torch.parallel import sharding
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, cuda_device)
    cfg = dataclasses.replace(bc.render, width=64, height=64, spp=2,
                              max_bounces=2)
    key = rng.key(0, cuda_device)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1)
        scene = sharding.replicate_scene(scene, mesh)
        want = path.render(scene, cam, key, cfg).mean()
        assert torch.equal(sharding.render_sharded(scene, cam, key, cfg,
                                                   mesh).mean(), want)
        assert torch.equal(sharding.render_sharded_2d(
            scene, cam, key, cfg, sharding.make_mesh_2d(1, 1)).mean(), want)
        pcfg = dataclasses.replace(cfg, tracer="pallas")
        assert torch.equal(
            sharding.render_sample_sharded(scene, cam, key, pcfg, mesh,
                                           exchange=True),
            path.render_sample(scene, cam, key, pcfg))
        losses = []
        for m in (mesh, None):
            params = inverse.trainable_copy(
                inverse.TrainableParams.from_scene(scene, base_color=True))
            opt = torch.optim.SGD(params.leaves(), lr=1e-2)
            step = inverse.make_train_step(scene, cam, cfg, opt, mesh=m)
            losses.append(step(params, None, key, want)[2])
        assert torch.equal(*losses)
    finally:
        dist.destroy_process_group()
