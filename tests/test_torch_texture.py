"""The port's textures, environment lights and textured shading against the
reference: ops/texture, the env functions of models/lights, the texture
and env builders of scene/, and the texture branches of shade_surface.
Tolerance 1e-6 + 1e-5 |ref| (transcendentals and XLA's fused multiply-adds
round differently from torch's)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator import shading as jshading
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.models import lights as jlights
from physically_based_renderer_tpu.ops import texture as jtex
from physically_based_renderer_tpu.ops.intersect import (
    intersect_brute as j_brute)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng as rng_mod
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path, shading
from physically_based_renderer_tpu_torch.models import lights
from physically_based_renderer_tpu_torch.ops import texture
from physically_based_renderer_tpu_torch.ops.intersect import intersect_brute
from physically_based_renderer_tpu_torch.scene import procedural, types
from torch_parity import (assert_records_equal, assert_render_agrees, flat,
                          np_, scene_arrays)

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
N = 2000
R, C, M = jtypes.WRAP_REPEAT, jtypes.WRAP_CLAMP, jtypes.WRAP_MIRROR
NEAREST, LINEAR = jtypes.FILTER_NEAREST, jtypes.FILTER_LINEAR


def _close(got, want, **kw):
    np.testing.assert_allclose(np_(got), np.asarray(want), **(kw or TOL))


def _images(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.random((h, w, 4)).astype(np.float32) for h, w in shapes]


# Every wrap mode and filter, per texture: (h, w), wrap, (mag, min_inner,
# min_mip).  Mip chains use power-of-two sides: the reference's 2x2 box
# filter fails on odd sides above 1 (ops/texture.py::_downsample), and the
# port keeps that behaviour; an odd texture appears with MIP_NONE only.
STACKS = {
    "trilinear": ([(16, 16), (8, 4), (1, 4), (4, 32)],
                  [(R, R), (C, M), (M, C), (R, C)],
                  [(LINEAR, LINEAR, jtypes.MIP_LINEAR)] * 4),
    "nearest": ([(16, 16), (8, 4), (7, 5), (4, 32)],
                [(C, C), (M, M), (R, R), (M, R)],
                [(NEAREST, NEAREST, jtypes.MIP_NEAREST),
                 (NEAREST, LINEAR, jtypes.MIP_LINEAR),
                 (LINEAR, NEAREST, jtypes.MIP_NONE),
                 (NEAREST, NEAREST, jtypes.MIP_NONE)]),
}


def _stacks(name, seed=0):
    shapes, wrap, filt = STACKS[name]
    ims = _images(seed, shapes)
    return (types.TextureStack.from_images(ims, wrap=wrap, filt=filt),
            jtypes.TextureStack.from_images(ims, wrap=wrap, filt=filt))


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stack_meta_and_pyramid_match_reference(name):
    port, ref = _stacks(name)
    assert_records_equal(port, ref)
    assert port.offsets == ref.offsets
    np.testing.assert_array_equal(texture.texture_meta(port),
                                  jtex.texture_meta(ref))
    quads = texture.build_pyramid(port)
    want = jtex.build_pyramid(ref).quads
    assert tuple(quads.shape) == want.shape
    _close(quads, want)


def test_from_images_defaults_to_trilinear_repeat():
    port = types.TextureStack.from_images(_images(1, [(4, 4), (2, 8)]))
    assert port.wrap == ((R, R),) * 2
    assert port.filt == ((LINEAR, LINEAR, jtypes.MIP_LINEAR),) * 2
    assert types.TextureStack.from_images([]).shapes == ((1, 1),)


@pytest.mark.parametrize("lod", ["none", "random"])
@pytest.mark.parametrize("name", sorted(STACKS))
def test_sample_slot_matches_reference(name, lod):
    port, ref = _stacks(name, seed=2)
    rng = np.random.default_rng(3)
    meta_tab = jtex.texture_meta(ref)
    tex = rng.integers(-1, 4, N)                       # -1: no texture
    meta = np.where((tex >= 0)[:, None], meta_tab[np.maximum(tex, 0)], -1.0)
    meta = meta.astype(np.float32)
    uv = rng.uniform(-2.5, 2.5, (N, 2)).astype(np.float32)
    lod_v = (None if lod == "none"
             else rng.uniform(-9.0, 1.0, N).astype(np.float32))
    for trilinear in (True, False):
        want = jtex.sample_slot(
            jtex.build_pyramid(ref), jnp.asarray(meta), jnp.asarray(uv),
            None if lod_v is None else jnp.asarray(lod_v), default=0.25,
            trilinear=trilinear)
        got = texture.sample_slot(
            texture.build_pyramid(port), torch.from_numpy(meta),
            torch.from_numpy(uv),
            None if lod_v is None else torch.from_numpy(lod_v),
            default=0.25, trilinear=trilinear)
        _close(got, want)
        assert bool((got[tex < 0] == 0.25).all())


@pytest.fixture(scope="module")
def sky():
    ref = jproc.make_gradient_sky()
    return ref, procedural.make_gradient_sky()


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, -1e-7]]  # poles, seam
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_env_tables_match_reference(sky):
    ref, port = sky
    assert_records_equal(port, ref)
    const = types.EnvMap.constant((0.5, 1.0, 2.0))
    assert_records_equal(const, jtypes.EnvMap.constant((0.5, 1.0, 2.0)))


def test_env_lookups_match_reference(sky):
    ref_env, port_env = sky
    ref = jproc.make_furnace_scene().replace(env=ref_env)
    port = dataclasses.replace(procedural.make_furnace_scene(), env=port_env)
    d = _dirs(N, 4)
    _close(texture.sample_env_bilinear(port_env.data, torch.from_numpy(d)),
           jtex.sample_env_bilinear(jnp.asarray(ref_env.data),
                                    jnp.asarray(d)))
    _close(texture.env_quads(port_env.data),
           jtex.env_quads(jnp.asarray(ref_env.data)))
    _close(lights.env_radiance(port, torch.from_numpy(d)),
           jlights.env_radiance(ref, jnp.asarray(d)))
    _close(lights.env_pdf(port, torch.from_numpy(d)),
           jlights.env_pdf(ref, jnp.asarray(d)))
    u2 = np.random.default_rng(5).random((N, 2)).astype(np.float32)
    ls = lights.sample_env(port, N, torch.from_numpy(u2))
    jls = jlights.sample_env(ref, N, jnp.asarray(u2))
    for f in dataclasses.fields(jls):
        if f.name == "valid":
            np.testing.assert_array_equal(np_(ls.valid), np.asarray(jls.valid))
        else:
            _close(getattr(ls, f.name), getattr(jls, f.name))


BUILDERS = {
    "helmet24": (lambda: procedural.make_helmet_class_scene(24, 24),
                 lambda: jproc.make_helmet_class_scene(24, 24)),
    "cornell_ggx": (
        lambda: procedural.make_cornell_box(metallic_tall_block=True,
                                            roughness=0.25, textured=True),
        lambda: jproc.make_cornell_box(metallic_tall_block=True,
                                       roughness=0.25, textured=True)),
    "cornell_tex256": (
        lambda: procedural.make_cornell_box(textured=True, tex_size=256),
        lambda: jproc.make_cornell_box(textured=True, tex_size=256)),
    "furnace": (procedural.make_furnace_scene, jproc.make_furnace_scene),
}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_textured_builders_match_reference(name):
    port_fn, ref_fn = BUILDERS[name]
    port, ref = port_fn(), ref_fn()
    for rec in ("geometry", "materials", "textures", "emitters",
                "directional"):
        assert_records_equal(getattr(port, rec), getattr(ref, rec))
    assert (port.env is None) == (ref.env is None)
    if ref.env is not None:
        assert_records_equal(port.env, ref.env)
    for flag in ("has_emitters", "has_directional", "has_textures",
                 "tex_slots", "flat_normals"):
        assert getattr(port, flag) == getattr(ref, flag), flag


@pytest.mark.parametrize("name", ["helmet24", "cornell_ggx"])
@pytest.mark.parametrize("cone", [False, True])
def test_textured_shade_surface_matches_reference(name, cone):
    ref = BUILDERS[name][1]()
    port = types.scene_from_numpy(scene_arrays(ref))
    rng = np.random.default_rng(7)
    center = (0.0, 0.0, 0.0) if name == "helmet24" else (0.0, 1.0, 0.5)
    o = (rng.uniform(-0.6, 0.6, (N, 3)) + center).astype(np.float32)
    if name == "helmet24":
        o *= 3.0                               # outside the sphere
    d = (np.asarray(center, np.float32) - o
         + rng.normal(0, 0.4, (N, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v0, v1, v2 = ref.geometry.tri_vertices()
    jhit = j_brute(jnp.asarray(o), jnp.asarray(d), v0, v1, v2, t_min=1e-3)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    hit = intersect_brute(o_t, d_t, *port.geometry.tri_vertices(),
                          t_min=1e-3)
    ok = np.asarray(jhit.tri) >= 0
    np.testing.assert_array_equal(np_(hit.tri)[ok], np.asarray(jhit.tri)[ok])
    assert ok.sum() > N // 4
    width = rng.uniform(1e-4, 0.2, N).astype(np.float32) if cone else None
    sp = shading.shade_surface(
        port, hit, o_t, d_t,
        cone_width=None if width is None else torch.from_numpy(width))
    jsp = jshading.shade_surface(
        ref, jhit, jnp.asarray(o), jnp.asarray(d),
        cone_width=None if width is None else jnp.asarray(width))
    tol = dict(rtol=1e-5, atol=1e-5)
    for f in dataclasses.fields(jsp):
        if f.name == "bsdf":
            for g in dataclasses.fields(jsp.bsdf):
                _close(np_(getattr(sp.bsdf, g.name))[ok],
                       np.asarray(getattr(jsp.bsdf, g.name))[ok], **tol)
        elif f.name in ("front", "mat"):
            np.testing.assert_array_equal(np_(getattr(sp, f.name))[ok],
                                          np.asarray(getattr(jsp, f.name))[ok])
        else:
            _close(np_(getattr(sp, f.name))[ok],
                   np.asarray(getattr(jsp, f.name))[ok], **tol)
    # the textures really vary over the hits
    assert float(np_(sp.bsdf.base_color)[ok].std()) > 0.05


def test_cornell_tex256_render_matches_reference():
    """The `cornell_tex256` config's scene (256x256 maps: mip levels past
    3) rendered per pixel against the reference at the same key, 16x16 x 2
    spp x 2 bounces (PIXEL_FRAC within ATOL + RTOL |ref|, mean and ray
    count within 0.5%)."""
    ref = jproc.make_cornell_box(metallic_tall_block=True, roughness=0.25,
                                 textured=True, tex_size=256)
    jcam = JCamera.make(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                        fov_y=0.95)
    small = dict(width=16, height=16, spp=2, max_bounces=2)
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(0),
                                        JRenderConfig(**small,
                                                      tracer="resident"))
    port = types.scene_from_numpy(scene_arrays(ref))
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng_mod.key(0),
                                         path.RenderConfig(**small))
    assert max(max(hw) for hw in port.textures.shapes) == 256
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))
