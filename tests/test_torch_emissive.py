"""Textured emitters in area-light NEE: the port's emitter table, samples
and texel gradients against the reference's on the scene of
tests/test_emissive_tex.py, on a smoothly textured panel and on the small
helmet (alias pick over 288 emitters)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.models import lights as jlights
from physically_based_renderer_tpu.scene import helmet_asset as jhelmet
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.models import lights
from physically_based_renderer_tpu_torch.ops.texture import build_pyramid
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from test_emissive_tex import _two_tone_scene
from torch_parity import (MEAN_REL, PIXEL_FRAC, flat, np_, render_agreement,
                          scene_arrays)

torch.set_num_threads(1)


def _smooth_panel():
    """The two-tone scene with a 16x8 random emissive map, bilinear with
    mips and mirror/clamp wrap: every texel matters to some sample."""
    ref = _two_tone_scene()
    tex = np.random.default_rng(3).uniform(0.1, 1.0, (16, 8, 4)).astype(
        np.float32)
    stack = jtypes.TextureStack.from_images(
        [tex], wrap=((jtypes.WRAP_MIRROR, jtypes.WRAP_CLAMP),))
    return jtypes.make_scene(ref.geometry, ref.materials, textures=stack)


SCENES = {"two_tone": _two_tone_scene, "smooth": _smooth_panel}


def _uniforms(n, seed):
    u = np.random.default_rng(seed).random((n, 3)).astype(np.float32)
    p = np.random.default_rng(seed + 1).uniform(
        -1.5, 1.5, (n, 3)).astype(np.float32) * np.float32([1, 0, 1])
    return p, u[:, 0], u[:, 1:]


def _assert_samples_match(ls, jls):
    np.testing.assert_array_equal(np_(ls.valid), np.asarray(jls.valid))
    assert bool(ls.valid.any())
    # pdf = pdf_area * dist^2 / cos: a grazing cosine amplifies the last
    # bits of the direction, so it is held to 1e-4 relative.
    for f, rtol in (("wi", 1e-5), ("dist", 1e-5), ("pdf", 1e-4)):
        np.testing.assert_allclose(np_(getattr(ls, f)),
                                   np.asarray(getattr(jls, f)), rtol=rtol,
                                   atol=1e-6, err_msg=f)
    # 1e-6, absolute up to 1 and relative above it: radiances reach 8,
    # where one float32 ulp is 9.5e-7, and XLA contracts the bilinear
    # blend's multiply-adds that the port rounds twice (a few ulps).
    rad, want = np_(ls.radiance), np.asarray(jls.radiance)
    assert (np.abs(rad - want) <= 1e-6 * np.maximum(np.abs(want), 1.0)
            * 2.0).all(), np.abs(rad - want).max()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_emitter_attrs_carry_uv_and_slot(name):
    ref = SCENES[name]()
    port = scene_from_numpy(scene_arrays(ref))
    attrs = np_(lights.pack_emitter_attrs(port))
    want = np.asarray(jlights.pack_emitter_attrs(ref))
    assert attrs.shape == want.shape == (2, 20)
    np.testing.assert_array_equal(attrs[:, 13:20], want[:, 13:20])
    np.testing.assert_allclose(attrs, want, rtol=0, atol=1e-7)
    assert np.all(attrs[:, 19] == 0.0)


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sample_emitters_matches_reference(name, seed):
    ref = SCENES[name]()
    port = scene_from_numpy(scene_arrays(ref))
    p, u1, u2 = _uniforms(2048, seed)
    jls = jlights.sample_area_emitters(ref, p, u1, u2)
    t = torch.from_numpy
    ls = lights.sample_area_emitters(port, t(p), t(u1), t(u2))
    _assert_samples_match(ls, jls)
    # a prebuilt table and pyramid change nothing
    ls2 = lights.sample_area_emitters(
        port, t(p), t(u1), t(u2),
        emitter_attrs=lights.pack_emitter_attrs(port),
        pyramid=build_pyramid(port.textures))
    np.testing.assert_array_equal(np_(ls2.radiance), np_(ls.radiance))
    if name == "two_tone":
        rad = np_(ls.radiance)[np_(ls.valid)]
        bright = rad[:, 0] > 0.5
        assert 0.2 < bright.mean() < 0.8
        np.testing.assert_allclose(rad[bright], np.broadcast_to(
            np.float32([8.0, 6.0, 4.0]), rad[bright].shape), rtol=1e-6)
        assert not rad[~bright].any()


def test_alias_pick_with_emissive_texture_matches_reference(tmp_path):
    """The small helmet: 288 textured emitters, so the pick goes through
    the alias table (one uniform for slot and accept, as the reference)."""
    from physically_based_renderer_tpu_torch.scene import helmet_asset
    ref = jhelmet.load_helmet_scene(cache_dir=tmp_path / "r", scale_tris=0.02)
    port = helmet_asset.load_helmet_scene(tmp_path / "p", 0.02)
    assert port.emitters.num_emitters == 288 > 64 and port.tex_slots[3]
    p, u1, u2 = _uniforms(4096, 2)
    p = p * np.float32(0.2) + np.float32([0.0, 0.0, 2.5])
    jls = jlights.sample_area_emitters(ref, p, u1, u2)
    t = torch.from_numpy
    ls = lights.sample_area_emitters(port, t(p), t(u1), t(u2))
    _assert_samples_match(ls, jls)
    # the HUD strips: some samples bright, many dark
    lum = np_(ls.radiance).sum(-1)[np_(ls.valid)]
    assert (lum > 0.5).any() and (lum < 1e-3).any()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_texel_gradient_matches_reference(name):
    """d sum(w * radiance) / d texels against jax.grad, to 1e-4 of max|g|;
    the emissive factor's gradient likewise."""
    ref = SCENES[name]()
    port = scene_from_numpy(scene_arrays(ref))
    p, u1, u2 = _uniforms(1024, 7)
    w = np.random.default_rng(8).uniform(0.5, 1.5, (1024, 3)).astype(
        np.float32)

    def jloss(texels, emissive):
        s = ref.replace(
            textures=ref.textures.replace(texels=texels),
            materials=ref.materials.replace(emissive_factor=emissive))
        ls = jlights.sample_area_emitters(s, p, u1, u2)
        return jnp.sum(ls.radiance * w)

    jg_tex, jg_em = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(ref.textures.texels),
        jnp.asarray(ref.materials.emissive_factor))
    texels = port.textures.texels.clone().requires_grad_(True)
    emissive = port.materials.emissive_factor.clone().requires_grad_(True)
    scene = dataclasses.replace(
        port,
        textures=dataclasses.replace(port.textures, texels=texels),
        materials=dataclasses.replace(port.materials,
                                      emissive_factor=emissive))
    t = torch.from_numpy
    ls = lights.sample_area_emitters(scene, t(p), t(u1), t(u2))
    (ls.radiance * t(w)).sum().backward()
    for got, want in ((texels.grad, jg_tex), (emissive.grad, jg_em)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert scale > 0
        err = float(np.abs(np_(got) - want).max())
        print(f"{name}: max|g| {scale:.4g}, err / max|g| {err / scale:.3g}")
        assert err <= 1e-4 * scale


@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_with_textured_emitter_matches_reference(name):
    ref = SCENES[name]()
    port = scene_from_numpy(scene_arrays(ref))
    jcam = JCamera.make(position=(0.0, 0.9, 3.2), target=(0.0, 0.5, 0.0),
                        fov_y=1.0)
    kw = dict(width=24, height=24, spp=2, max_bounces=2, tracer="brute")
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(4),
                                        JRenderConfig(**kw))
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(4), path.RenderConfig(**kw))
    img, want = film.mean().numpy(), np.asarray(jfilm.mean())
    frac, n_bad = render_agreement(img, want)
    assert frac >= PIXEL_FRAC, n_bad
    assert abs(img.mean() / want.mean() - 1.0) <= MEAN_REL
    assert int(count) == int(jcount)
