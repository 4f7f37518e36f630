"""Port models/ (BSDF, lights) and integrator/shading against the reference."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.integrator import shading as jshading
from physically_based_renderer_tpu.models import bsdf as jbsdf
from physically_based_renderer_tpu.models import lights as jlights
from physically_based_renderer_tpu.ops.intersect import (
    intersect_brute as j_brute)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.integrator import shading
from physically_based_renderer_tpu_torch.models import bsdf, lights
from physically_based_renderer_tpu_torch.ops import resident
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from torch_parity import many_emitters_reference, np_, scene_arrays

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-6)
N = 512


def _close(got, want):
    np.testing.assert_allclose(np_(got), np.asarray(want), **TOL)


def _params(seed, n=N, min_roughness=0.2):
    rng = np.random.default_rng(seed)
    cols = dict(
        base_color=rng.random((n, 3)).astype(np.float32),
        metallic=np.where(rng.random(n) < 0.3, 1.0,
                          rng.random(n)).astype(np.float32),
        # Near the GGX peak, D's denominator nh^2 (a^2 - 1) + 1 cancels down
        # to a^2, so one ulp of the half vector moves f by ~ulp / a^2: low
        # roughness is ill-conditioned in f32 whichever framework computes.
        roughness=rng.uniform(min_roughness, 1.0, n).astype(np.float32),
        specular=rng.choice([0.0, 0.5, 1.0], n).astype(np.float32))
    return (bsdf.BsdfParams(**{k: torch.from_numpy(v)
                               for k, v in cols.items()}),
            jbsdf.BsdfParams(**{k: jnp.asarray(v) for k, v in cols.items()}))


def _hemi(seed, n=N, lower=0.02):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:, 2] = np.abs(v[:, 2]) + lower
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


def test_bsdf_eval_and_pdf_match_reference():
    tp, jp = _params(0)
    wo, wi = _hemi(1), _hemi(2)
    wi[:20, 2] *= -1.0                      # some below the horizon
    f, pdf = bsdf.eval_bsdf(tp, torch.from_numpy(wo), torch.from_numpy(wi))
    jf, jpdf = jbsdf.eval_bsdf(jp, jnp.asarray(wo), jnp.asarray(wi))
    _close(f, jf)
    _close(pdf, jpdf)
    _close(bsdf.pdf_bsdf(tp, torch.from_numpy(wo), torch.from_numpy(wi)),
           jbsdf.pdf_bsdf(jp, jnp.asarray(wo), jnp.asarray(wi)))
    _close(tp.alpha, jp.alpha)
    _close(tp.f0, jp.f0)


def test_bsdf_sampling_matches_reference():
    # sampled half vectors sit at the lobe's peak: the worst conditioning
    tp, jp = _params(3, min_roughness=0.5)
    wo = _hemi(4)
    rng = np.random.default_rng(5)
    u_lobe = rng.random(N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    wi, f, pdf = bsdf.sample_bsdf(tp, torch.from_numpy(wo),
                                  torch.from_numpy(u_lobe),
                                  torch.from_numpy(u2))
    jwi, jf, jpdf = jbsdf.sample_bsdf(jp, jnp.asarray(wo), jnp.asarray(u_lobe),
                                      jnp.asarray(u2))
    np.testing.assert_allclose(np_(wi), np.asarray(jwi), rtol=1e-5,
                               atol=1e-5)
    _close(f, jf)
    _close(pdf, jpdf)
    _close(bsdf.sample_cosine_hemisphere(torch.from_numpy(u2)),
           jbsdf.sample_cosine_hemisphere(jnp.asarray(u2)))
    np.testing.assert_allclose(
        np_(bsdf.sample_vndf_ggx(tp.alpha, torch.from_numpy(wo),
                                 torch.from_numpy(u2))),
        np.asarray(jbsdf.sample_vndf_ggx(jp.alpha, jnp.asarray(wo),
                                         jnp.asarray(u2))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["cornell", "many_emitters"])
def test_area_emitter_sampling_matches_reference(which):
    """Dense-CDF pick (Cornell, 2 emitters) and alias pick (80 emitters)."""
    ref = (jproc.make_cornell_box() if which == "cornell"
           else many_emitters_reference())
    port = scene_from_numpy(scene_arrays(ref))
    assert (port.emitters.num_emitters > 64) == (which == "many_emitters")
    rng = np.random.default_rng(6)
    p = rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.5, 0.9], (N, 3)).astype(
        np.float32)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random((N, 2)).astype(np.float32)
    _close(lights.dense_tri_pdf_area(port), jlights.dense_tri_pdf_area(ref))
    _close(lights.pack_emitter_attrs(port), jlights.pack_emitter_attrs(ref))
    ls = lights.sample_area_emitters(port, *(torch.from_numpy(x)
                                             for x in (p, u1, u2)))
    jls = jlights.sample_area_emitters(ref, jnp.asarray(p), jnp.asarray(u1),
                                       jnp.asarray(u2))
    for f in dataclasses.fields(jls):
        if f.name == "valid":
            np.testing.assert_array_equal(np_(ls.valid), np.asarray(jls.valid))
        else:
            _close(getattr(ls, f.name), getattr(jls, f.name))


def test_directional_sampling_matches_reference():
    ref = jproc.make_triangle_scene()
    port = scene_from_numpy(scene_arrays(ref))
    ls, jls = lights.sample_directional(port, 7), jlights.sample_directional(
        ref, 7)
    for f in dataclasses.fields(jls):
        np.testing.assert_array_equal(np_(getattr(ls, f.name)),
                                      np.asarray(getattr(jls, f.name)))


def test_env_functions_raise():
    """Environment lookups on a scene without an environment map raise
    (the functions themselves: tests/test_torch_texture.py)."""
    port = scene_from_numpy(scene_arrays(jproc.make_cornell_box()))
    with pytest.raises(ValueError, match="environment"):
        lights.sample_env(port, 4, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="environment"):
        lights.env_radiance(port, torch.zeros(4, 3))
    with pytest.raises(ValueError, match="environment"):
        lights.env_pdf(port, torch.zeros(4, 3))


@pytest.mark.parametrize("name", ["cornell", "triangle"])
def test_shade_surface_matches_reference(name):
    ref = getattr(jproc, {"cornell": "make_cornell_box",
                          "triangle": "make_triangle_scene"}[name])()
    port = scene_from_numpy(scene_arrays(ref))
    rng = np.random.default_rng(7)
    center = (0.0, 1.0, 1.5) if name == "cornell" else (0.0, 0.0, 2.0)
    o = (rng.uniform(-0.5, 0.5, (N, 3)) + center).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    if name == "triangle":
        d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v0, v1, v2 = ref.geometry.tri_vertices()
    jhit = j_brute(jnp.asarray(o), jnp.asarray(d), v0, v1, v2, t_min=1e-3)
    hit = resident.intersect_resident(port.geometry, torch.from_numpy(o),
                                      torch.from_numpy(d), t_min=1e-3)
    np.testing.assert_array_equal(np_(hit.tri), np.asarray(jhit.tri))
    sp = shading.shade_surface(port, hit, torch.from_numpy(o),
                               torch.from_numpy(d))
    jsp = jshading.shade_surface(ref, jhit, jnp.asarray(o), jnp.asarray(d))
    ok = np.asarray(jhit.tri) >= 0
    assert ok.sum() > N // 8
    for f in dataclasses.fields(jsp):
        if f.name == "bsdf":
            for g in dataclasses.fields(jsp.bsdf):
                _close(np_(getattr(sp.bsdf, g.name))[ok],
                       np.asarray(getattr(jsp.bsdf, g.name))[ok])
        elif f.name in ("front", "mat"):
            np.testing.assert_array_equal(np_(getattr(sp, f.name))[ok],
                                          np.asarray(getattr(jsp, f.name))[ok])
        else:
            np.testing.assert_allclose(
                np_(getattr(sp, f.name))[ok],
                np.asarray(getattr(jsp, f.name))[ok], rtol=1e-5, atol=1e-5)


def test_shade_surface_raises_on_textures():
    """Textured shading is ported (tests/test_torch_texture.py), and so is
    an emissive texture in area-light NEE: nothing raises, and the sample
    carries the reference's factor x texture radiance."""
    ref = jproc.make_cornell_box(textured=True)
    port = scene_from_numpy(scene_arrays(ref))
    assert port.has_textures
    hit = resident.intersect_resident(port.geometry, torch.zeros(2, 3),
                                      torch.ones(2, 3))
    sp = shading.shade_surface(port, hit, torch.zeros(2, 3), torch.ones(2, 3))
    assert bool(torch.isfinite(sp.bsdf.base_color).all())
    em_tex = np.full((5,), -1, np.int32)
    em_tex[3] = 0                                # textured area light
    ref_em = jtypes.make_scene(
        ref.geometry, ref.materials.replace(emissive_tex=em_tex),
        textures=ref.textures)
    port_em = scene_from_numpy(scene_arrays(ref_em))
    assert port_em.tex_slots[3] and port_em.has_emitters
    u = np.random.default_rng(0).random((64, 3)).astype(np.float32)
    p = np.zeros((64, 3), np.float32) + np.float32([0.0, 1.0, 0.0])
    ls = lights.sample_area_emitters(port_em, torch.from_numpy(p),
                                     torch.from_numpy(u[:, 0]),
                                     torch.from_numpy(u[:, 1:]))
    jls = jlights.sample_area_emitters(ref_em, p, u[:, 0], u[:, 1:])
    assert bool(ls.valid.any())
    np.testing.assert_array_equal(np_(ls.valid), np.asarray(jls.valid))
    np.testing.assert_allclose(np_(ls.radiance), np.asarray(jls.radiance),
                               rtol=0, atol=1e-6)
