"""K4, the fused whole-frame kernel (ops/fused.py), against the reference.

The murmur3 draws and the packed tables are compared bit for bit; the
plain-torch estimator against the reference's kernel in interpret mode, as
tests/test_fused.py runs it, with the whole-render tolerance of
torch_parity.py; the dispatch of integrator/path.py on its own.  The CUDA
kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.ops import fused as jfused
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu.utils import config as jconfig
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import fused
from physically_based_renderer_tpu_torch.scene import types
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (COUNT_REL, MEAN_REL, PIXEL_FRAC, flat,
                          golden_module, np_, render_agreement, scene_arrays)

torch.set_num_threads(1)

CORNELL_CAM = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                   fov_y=0.95)
TRIANGLE_CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                    fov_y=1.2)
SCENES = {
    "triangle": (jproc.make_triangle_scene, TRIANGLE_CAM),
    "cornell": (jproc.make_cornell_box, CORNELL_CAM),
    "cornell_ggx": (lambda: jproc.make_cornell_box(
        metallic_tall_block=True, roughness=0.25, textured=True),
        CORNELL_CAM),
}


def _both(name):
    """(reference scene, reference camera, port scene, port camera)."""
    build, cam = SCENES[name]
    ref = build()
    jcam = JCamera.make(**cam)
    return (ref, jcam, scene_from_numpy(scene_arrays(ref)),
            camera_from_numpy(flat(jcam)))


def _u32(x: np.ndarray) -> torch.Tensor:
    """uint32 words as the port holds them: int64 in [0, 2^32)."""
    return torch.from_numpy(x.astype(np.int64))


# ---------------------------------------------------------------------------
# murmur3 draws
# ---------------------------------------------------------------------------

def test_fmix32_is_bit_equal():
    g = np.random.default_rng(0)
    x = g.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = (0, 1, 0x7FFFFFFF, 0xFFFFFFFF)
    want = np.asarray(jfused._fmix32(jnp.asarray(x)))
    np.testing.assert_array_equal(np_(fused._fmix32(_u32(x))),
                                  want.astype(np.int64))


@pytest.mark.parametrize("has_em", [True, False])
def test_uniform_is_bit_equal_at_every_site(has_em):
    """The reference counts draw sites at trace time: its n-th draw of a
    sample is site n.  A 4-bounce frame draws the jitter (sites 1, 2), then
    6 (with area emitters) or 3 values in each of bounces 0..3; the port
    names the same sites with rng_site."""
    bounces = 4
    per = 6 if has_em else 3
    sites = [1, 2] + [fused.rng_site(b, k, has_em)
                      for b in range(bounces) for k in range(per)]
    assert sites == list(range(1, 3 + per * bounces))
    g = np.random.default_rng(1)
    pid = g.integers(0, 1 << 24, 2048).astype(np.int32)
    pid[:2] = (0, (1 << 24) - 1)
    seeds = g.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32)
    for s in (0, 3):
        draw = jfused._make_rng(jnp.asarray(seeds.view(np.int32)[0]),
                                jnp.asarray(seeds.view(np.int32)[1]),
                                jnp.asarray(pid))
        for site in sites:
            want = np.asarray(draw(jnp.int32(s)))
            got = fused._uniform(torch.from_numpy(pid.astype(np.int64)),
                                 int(seeds[0]), int(seeds[1]), s, site)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"s={s} site={site}")


@pytest.mark.parametrize("seed", [0, 7, -3])
def test_frame_seeds_match_reference(seed):
    _, _, scene, cam = _both("cornell")
    cfg = path.RenderConfig(width=8, height=8, spp=1)
    got = fused.fused_frame(scene, cam, rng.key(seed), cfg).seeds
    want = np.asarray(jax.random.key_data(
        jax.random.fold_in(jax.random.key(seed), 0x5EED))).reshape(-1)[:2]
    assert got == tuple(int(x) for x in want.view(np.uint32))


# ---------------------------------------------------------------------------
# Packed tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SCENES))
def test_tables_match_reference(name):
    ref, jcam, scene, cam = _both(name)
    tri, want = np_(fused._pack_tri_table(scene)), np.asarray(
        jfused._pack_tri_table(ref))
    assert tri.shape == want.shape == (ref.geometry.num_tris, 32)
    ng = slice(9, 12)
    np.testing.assert_allclose(tri[:, ng], want[:, ng], rtol=1e-6, atol=0)
    tri[:, ng] = want[:, ng]
    np.testing.assert_array_equal(tri, want)
    np.testing.assert_array_equal(np_(fused._pack_em_table(scene)),
                                  np.asarray(jfused._pack_em_table(ref)))
    for got, exp in zip(fused._pack_tex_tables(scene),
                        jfused._pack_tex_tables(ref)):
        np.testing.assert_array_equal(np_(got), np.asarray(exp))
    for w, h in ((32, 32), (24, 20)):
        np.testing.assert_array_equal(
            np_(fused._pack_cam(scene, cam, w, h)),
            np.asarray(jfused._pack_cam(ref, jcam, w, h)))


def test_textured_tables_have_both_slots():
    *_, scene, _ = _both("cornell_ggx")
    mtex, quads = fused._pack_tex_tables(scene)
    assert quads.shape == (sum(h * w for h, w in scene.textures.shapes), 16)
    assert quads.shape[0] <= fused.MAX_FUSED_TEX_ROWS
    assert bool((mtex[:, 0] >= 0).any()) and bool((mtex[:, 3] >= 0).any())
    assert bool((mtex[:, 0] < 0).any())       # untextured materials remain


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["triangle", "cornell", "cornell_ggx",
                                  "cornell_tex256", "helmet_proc",
                                  "inverse"])
def test_fused_applicable_matches_reference_on_configs(name):
    bc, jbc = config.get(name), jconfig.get(name)
    spec = jbc.scene
    if name == "helmet_proc":
        # The gate reads counts, flags and texture metadata only: the
        # cluster grid of the reference's build changes none of them.
        ref = jproc.make_helmet_class_scene(**spec.extra)
    else:
        ref, _ = jconfig.build_scene(spec)
    scene, _ = config.build_scene(bc.scene, "cpu")
    want = jfused.fused_applicable(ref, jbc.render)
    assert fused.fused_applicable(scene, bc.render) == want
    assert fused._fused_tex_ok(scene) == jfused._fused_tex_ok(ref)
    assert want == (name in ("triangle", "cornell", "cornell_ggx",
                             "inverse"))


@pytest.mark.parametrize("change", [dict(rr_start=2), dict(nee=False),
                                    dict(mis=False), dict(rr_start=4),
                                    dict()])
def test_fused_applicable_gates_match_reference(change):
    ref, _, scene, _ = _both("cornell")
    kw = dict(width=32, height=32, spp=2, max_bounces=3, **change)
    want = jfused.fused_applicable(ref, JRenderConfig(**kw))
    assert fused.fused_applicable(scene, path.RenderConfig(**kw)) == want
    assert want == (change in (dict(), dict(rr_start=4)))


def test_texture_gates_match_reference():
    """Trilinear samplers and 256^2 textures keep the dense path."""
    ref = jproc.make_cornell_box(textured=True)
    st = ref.textures
    tril = ref.replace(textures=st.replace(
        filt=((jtypes.FILTER_LINEAR, jtypes.FILTER_LINEAR,
               jtypes.MIP_LINEAR),) * st.num_textures))
    helmet = jproc.make_helmet_class_scene(rings=16, sectors=16)
    for r, want in ((ref, True), (tril, False), (helmet, False)):
        assert jfused._fused_tex_ok(r) == want
        assert fused._fused_tex_ok(scene_from_numpy(scene_arrays(r))) == want


# ---------------------------------------------------------------------------
# The plain estimator against the reference's interpret-mode kernel
# ---------------------------------------------------------------------------

def _reference_fused(ref, jcam, seed, kw):
    hdr, count = jfused.render_fused_stats(
        ref, jcam, jax.random.key(seed), JRenderConfig(**kw), interpret=True)
    return np.asarray(hdr), float(count)


def _assert_render_agrees(img, ref, count, ref_count):
    frac, n_bad = render_agreement(img, ref)
    print(f"{n_bad} of {img.shape[0] * img.shape[1]} pixels outside "
          f"tolerance ({frac:.4%} agree), max |diff| "
          f"{np.abs(img - ref).max():.3g}, count {count} vs {ref_count}")
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL
    assert abs(count / ref_count - 1.0) <= COUNT_REL


# (config, render settings): the three configs K4 takes, one with a pixel
# count that fills no whole warp or block.
PLAIN_CASES = {
    "cornell": ("cornell", dict(width=32, height=32, spp=2, max_bounces=3)),
    "triangle": ("triangle", dict(width=32, height=32, spp=2,
                                  max_bounces=1)),
    "cornell_ragged": ("cornell", dict(width=24, height=20, spp=2,
                                       max_bounces=2)),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_matches_reference_kernel(case):
    name, kw = PLAIN_CASES[case]
    ref, jcam, scene, cam = _both(name)
    want, want_count = _reference_fused(ref, jcam, 0, kw)
    hdr, count = fused.render_fused_plain(scene, cam, rng.key(0),
                                          path.RenderConfig(**kw))
    assert hdr.shape == (kw["height"], kw["width"], 3)
    assert count.dtype == torch.int64
    assert bool(torch.isfinite(hdr).all())
    _assert_render_agrees(hdr.numpy() / kw["spp"], want / kw["spp"],
                          int(count), want_count)


@pytest.fixture(scope="module")
def fused_golden():
    """(golden settings, a fresh reference render of the fused golden)."""
    mod = golden_module()
    return mod.FUSED, mod.render_fused_golden()


def test_fused_golden_matches_fresh_reference_render(fused_golden):
    f, fresh = fused_golden
    np.testing.assert_allclose(fresh, np.load(f["path"]), rtol=1e-5,
                               atol=1e-6)


def test_plain_matches_reference_kernel_cornell_ggx(fused_golden):
    """Textures, GGX, both emitters and MIS: the fused golden's settings
    (64x64, 2 spp, 2 bounces, seed 0), one reference trace for both."""
    f, want = fused_golden
    bc = config.get(f["config"])
    scene, cam = config.build_scene(bc.scene, "cpu")
    cfg = dataclasses.replace(bc.render, width=f["size"], height=f["size"],
                              spp=f["spp"], max_bounces=f["bounces"])
    hdr, count = fused.render_fused_plain(scene, cam, rng.key(f["seed"]), cfg)
    img = hdr.numpy() / f["spp"]
    frac, n_bad = render_agreement(img, want)
    print(f"{n_bad} pixels outside tolerance ({frac:.4%} agree), max |diff| "
          f"{np.abs(img - want).max():.3g}")
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / want.mean() - 1.0) <= MEAN_REL
    assert int(count) > 0


def test_plain_is_deterministic_and_seed_sensitive():
    _, _, scene, cam = _both("cornell")
    cfg = path.RenderConfig(width=16, height=16, spp=2, max_bounces=2)
    a, na = fused.render_fused_plain(scene, cam, rng.key(7), cfg)
    b, nb = fused.render_fused_plain(scene, cam, rng.key(7), cfg)
    c, _ = fused.render_fused_plain(scene, cam, rng.key(8), cfg)
    assert torch.equal(a, b) and int(na) == int(nb)
    assert not torch.equal(a, c)


def test_plain_matches_dense_statistically():
    """Two streams of random numbers, one estimator: image and channel
    means and the ray count agree within Monte Carlo noise (the
    tolerances of tests/test_fused.py)."""
    _, _, scene, cam = _both("cornell")
    cfg = path.RenderConfig(width=32, height=32, spp=32, max_bounces=3)
    hdr, count = fused.render_fused_plain(scene, cam, rng.key(0), cfg)
    film, count_d = path.render_with_stats(scene, cam, rng.key(0), cfg)
    img_f, img_d = hdr.numpy() / cfg.spp, film.mean().numpy()
    assert np.isfinite(img_f).all()
    assert abs(img_f.mean() - img_d.mean()) < 0.01
    np.testing.assert_allclose(img_f.mean(axis=(0, 1)),
                               img_d.mean(axis=(0, 1)), atol=0.02)
    assert abs(int(count) - int(count_d)) / int(count_d) < 0.05


# ---------------------------------------------------------------------------
# Helpers with edges the renders rarely reach
# ---------------------------------------------------------------------------

def test_emitter_pick_takes_smallest_row_with_cdf_at_least_u():
    em = torch.zeros((4, 14))
    em[:, 0] = torch.tensor([10.0, 11.0, 12.0, 13.0])
    em[:, 13] = torch.tensor([0.25, 0.5, 0.5, 1.0])   # row 2 has no power
    u = torch.tensor([0.0, 0.25, 0.3, 0.5, 0.51, 1.0, 1.5])
    rows = fused._pick_emitter(em, u)
    assert rows.shape == (7, 13)
    np.testing.assert_array_equal(rows[:, 0].numpy(),
                                  [10, 10, 11, 11, 13, 13, 0])
    assert bool((rows[-1] == 0).all())          # u above every cdf
    one = fused._pick_emitter(em[:1], u)       # one emitter: row 0 always
    assert bool((one[:, 0] == 10.0).all())


def test_texture_fetch_leaves_untextured_and_unknown_materials():
    *_, scene, _ = _both("cornell_ggx")
    mtex, quads = fused._pack_tex_tables(scene)
    bare = int(torch.nonzero(mtex[:, 0] < 0)[0])
    tex = int(torch.nonzero(mtex[:, 0] >= 0)[0])
    matf = torch.tensor([float(bare), float(mtex.shape[0]), -1.0, 0.5,
                         float(tex)])
    uv = torch.full((5,), 0.3)
    _, has_b, _, _, has_m = fused._tex_fetch(mtex, quads, matf, uv, uv)
    assert has_b.tolist() == [False, False, False, False, True]
    assert has_m.tolist()[:4] == [False] * 4


# ---------------------------------------------------------------------------
# Wrapper and dispatch
# ---------------------------------------------------------------------------

def test_wrapper_runs_plain_on_cpu_and_raises_elsewhere():
    _, _, scene, cam = _both("triangle")
    cfg = path.RenderConfig(width=8, height=6, spp=1, max_bounces=1)
    before = fused.LAUNCHES
    hdr, count = fused.render_fused_stats(scene, cam, rng.key(1), cfg)
    plain, count_p = fused.render_fused_plain(scene, cam, rng.key(1), cfg)
    assert fused.LAUNCHES == before
    assert torch.equal(hdr, plain) and int(count) == int(count_p)
    with pytest.raises(ValueError):
        fused.render_fused_stats(types.upload_scene(scene, "meta"), cam,
                                 rng.key(1), cfg)
    with pytest.raises(ValueError):
        fused.render_fused_stats(scene, cam, rng.key(1),
                                 dataclasses.replace(cfg, nee=False))
    with pytest.raises(ValueError):
        fused.fused_kernel(fused.fused_frame(scene, cam, rng.key(1), cfg))


def test_kernel_wrapper_checks_what_the_kernel_cannot_take():
    """K4's wrapper refuses a frame without samples (the kernel sums a
    pixel's samples when the last one arrives) before anything else, and
    tables on the CPU."""
    _, _, scene, cam = _both("triangle")
    cfg = path.RenderConfig(width=8, height=6, spp=1, max_bounces=1)
    frame = fused.fused_frame(scene, cam, rng.key(1), cfg)
    with pytest.raises(ValueError, match="spp must be at least 1"):
        fused.fused_kernel(dataclasses.replace(frame, spp=0))
    with pytest.raises(ValueError, match="not a CUDA device"):
        fused.fused_kernel(frame)


@pytest.fixture
def on_cuda(monkeypatch):
    """Scenes report a CUDA device, and K4's wrapper records its calls
    instead of launching."""
    calls = []

    def fake(scene, camera, key, cfg):
        calls.append(cfg)
        return (torch.full((cfg.height, cfg.width, 3), float(cfg.spp)),
                torch.tensor(123, dtype=torch.int64))

    monkeypatch.setattr(types.Scene, "device",
                        property(lambda s: torch.device("cuda", 0)))
    monkeypatch.setattr(fused, "render_fused_stats", fake)
    return calls


@pytest.mark.parametrize("tracer,want", [("auto", True), ("fused", True),
                                         ("resident", False),
                                         ("brute", False)])
def test_use_fused_on_cuda(on_cuda, tracer, want):
    _, _, scene, _ = _both("cornell")
    cfg = path.RenderConfig(width=8, height=8, spp=2, max_bounces=2,
                            tracer=tracer)
    assert path._use_fused(scene, cfg) == want
    assert not path._use_fused(scene, dataclasses.replace(cfg, rr_start=1))


def test_render_with_stats_dispatches_to_k4_on_cuda(on_cuda):
    _, _, scene, cam = _both("cornell_ggx")
    cfg = path.RenderConfig(width=8, height=4, spp=3, max_bounces=2)
    film, count = path.render_with_stats(scene, cam, rng.key(0), cfg)
    assert on_cuda == [cfg] and int(count) == 123
    assert film.spp == 3.0 and bool((film.mean() == 1.0).all())
    film = path.render_fast(scene, cam, rng.key(0), cfg)
    assert len(on_cuda) == 2 and film.hdr.shape == (4, 8, 3)


def test_render_with_stats_stays_dense_on_cpu(monkeypatch):
    def no_k4(*args):
        raise AssertionError("K4 dispatched on the CPU")

    monkeypatch.setattr(fused, "render_fused_stats", no_k4)
    _, _, scene, cam = _both("cornell")
    cfg = path.RenderConfig(width=8, height=8, spp=1, max_bounces=2)
    assert not path._use_fused(scene, cfg)
    film, count = path.render_with_stats(scene, cam, rng.key(4), cfg)
    film_d, count_d = path._render_with_stats_dense(scene, cam, rng.key(4),
                                                    cfg)
    assert torch.equal(film.hdr, film_d.hdr) and int(count) == int(count_d)


def test_tracer_fused_on_cpu_renders_dense_like_reference():
    """On the CPU the reference's render_with_stats keeps the dense path
    for tracer="fused", whose tracer dispatch then falls to brute force."""
    ref, jcam, scene, cam = _both("cornell")
    kw = dict(width=16, height=16, spp=2, max_bounces=2, tracer="fused")
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(5),
                                        JRenderConfig(**kw))
    cfg = path.RenderConfig(**kw)
    assert path._tracer(scene, cfg) == "brute"
    film, count = path.render_with_stats(scene, cam, rng.key(5), cfg)
    _assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                          int(count), float(jcount))
