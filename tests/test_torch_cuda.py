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
from physically_based_renderer_tpu_torch.ops import (blocktrace, fused,
                                                     resident, tonemap,
                                                     trace_blocks)
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
