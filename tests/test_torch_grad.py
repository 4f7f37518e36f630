"""Gradients of the port's render() + pixel_loss against the reference's
jax.grad at the same key, and the cornell gradient golden.

The same scene (carried across as numpy), camera, key, target and
parameters go through both packages; the port's gradient must agree with
the reference's element by element within REL * max|g_ref|.  One
reference gradient per scene and tracer (module-scoped), to keep JAX
compiles few.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.grad import inverse as jinv
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render as j_render)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.grad import inverse as pinv
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from physically_based_renderer_tpu_torch.utils import config
from test_inverse import _ramp_quad_scene, _textured_quad_scene
from torch_parity import (assert_grads_close, flat, golden_module,
                          params_numpy, params_to_port, port_grads,
                          scene_arrays)

torch.set_num_threads(1)

# Element-wise tolerance relative to the largest reference gradient.  Both
# packages draw the same random numbers, so only float rounding differs
# (measured ~1e-6 on cornell).
REL = 1e-4

CORNELL_CAM = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                   fov_y=0.95)
QUAD_CAM = dict(position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0), fov_y=1.0)
CORNELL = dict(width=16, height=16, spp=2, max_bounces=2)
QUAD = dict(width=24, height=24, spp=2, max_bounces=1)   # test_inverse.CFG
LOSS_KEY, TARGET_KEY = 0, 7


def _env_sphere_scene(zenith, horizon):
    """test_inverse.py's env-lit sphere."""
    env = jproc.make_gradient_sky(8, 16, zenith=zenith, horizon=horizon,
                                  sun_radiance=(0.0,) * 3)
    g = jproc.make_uv_sphere(radius=1.0, rings=8, sectors=12)
    return jtypes.make_scene(g, jtypes.Materials.default(1), env=env)


def _ref_loss_and_grad(scene, jcam, jcfg, jparams, target):
    def loss(p):
        img = j_render(jinv.apply_params(scene, p), jcam,
                       jax.random.key(LOSS_KEY), jcfg).mean()
        return jinv.pixel_loss(img, jnp.asarray(target))
    value, grad = jax.value_and_grad(loss)(jparams)
    return float(value), params_numpy(grad)


def _port_loss_and_grad(scene, cam, cfg, params, target):
    img = path.render(pinv.apply_params(scene, params), cam,
                      rng.key(LOSS_KEY), cfg).mean()
    loss = pinv.pixel_loss(img, torch.from_numpy(target))
    loss.backward()
    return float(loss.detach()), port_grads(params)


def _reference(ref_scene, cam_kw, small, tracer, select, target_scene=None):
    """(target, reference params, (loss, grads)) for one scene; the target
    is a reference render (key TARGET_KEY) of target_scene (default: the
    scene itself)."""
    jcam = JCamera.make(**cam_kw)
    jcfg = JRenderConfig(**small, tracer=tracer)
    target = np.array(j_render(target_scene or ref_scene, jcam,
                               jax.random.key(TARGET_KEY), jcfg).mean())
    jparams = jinv.TrainableParams.from_scene(ref_scene, **select)
    return target, jparams, _ref_loss_and_grad(ref_scene, jcam, jcfg,
                                               jparams, target)


def _port(ref_scene, cam_kw, small, tracer, jparams, target):
    return _port_loss_and_grad(scene_from_numpy(scene_arrays(ref_scene)),
                               camera_from_numpy(flat(JCamera.make(**cam_kw))),
                               path.RenderConfig(**small, tracer=tracer),
                               params_to_port(jparams), target)


MATERIALS = dict(base_color=True, roughness=True, metallic=True,
                 emissive=True)


@pytest.fixture(scope="module")
def cornell_reference():
    """The reference's gradient with its resident tracer.  Its brute-force
    tracer finds the same hits and gives the same gradient (checked when
    this test was written: equal loss, the same port errors), so one
    reference compile serves both port tracers."""
    scene = jproc.make_cornell_box()
    return scene, _reference(scene, CORNELL_CAM, CORNELL, "resident",
                             MATERIALS)


@pytest.mark.parametrize("tracer", ["resident", "brute"])
def test_cornell_material_gradients_match_reference(cornell_reference,
                                                    tracer):
    scene, (target, jparams, (ref_loss, ref_g)) = cornell_reference
    loss, g = _port(scene, CORNELL_CAM, CORNELL, tracer, jparams, target)
    assert sorted(g) == ["base_color_factor", "emissive_factor",
                         "metallic_factor", "roughness_factor"]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert_grads_close(g, ref_g, REL)


def _small_cases():
    h = 8
    true_tex = np.zeros((h, h, 3), np.float32)
    true_tex[:, : h // 2] = (0.9, 0.2, 0.2)
    true_tex[:, h // 2:] = (0.2, 0.9, 0.3)
    return {
        # test_inverse.py:58-75: the flat-grey quad against the two-colour
        # texture's render.
        "texture_data": (
            lambda: _textured_quad_scene(np.full((h, h, 3), 0.5, np.float32)),
            lambda: _textured_quad_scene(true_tex), dict(textures=True)),
        # test_inverse.py:77-97: a flat sky against the gradient sky.
        "env_data": (
            lambda: _env_sphere_scene((0.8, 0.8, 0.8), (0.8, 0.8, 0.8)),
            lambda: _env_sphere_scene((2.0, 0.3, 0.3), (0.3, 0.3, 2.0)),
            dict(env=True)),
        # test_inverse.py:100-133: the ramp quad against its shifted copy.
        "vertex_positions": (
            lambda: _ramp_quad_scene(0.0), lambda: _ramp_quad_scene(0.3),
            dict(vertices=True)),
    }


@pytest.mark.parametrize("field", sorted(_small_cases()))
def test_small_scene_gradients_match_reference(field):
    build, build_target, select = _small_cases()[field]
    scene = build()
    target, jparams, (ref_loss, ref_g) = _reference(
        scene, QUAD_CAM, QUAD, "brute", select, target_scene=build_target())
    loss, g = _port(scene, QUAD_CAM, QUAD, "brute", jparams, target)
    assert sorted(g) == [field]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert_grads_close(g, ref_g, REL)


def test_tie_rule_halves_the_gradient_on_the_bound():
    """apply_params' clamps split a tie's gradient in half, as JAX does:
    emission at 0 (every non-emissive cornell material) and a base colour
    at 1 get half the gradient of the unclamped scene value; values inside
    the bounds get all of it."""
    ref = jproc.make_cornell_box()
    port = scene_from_numpy(scene_arrays(ref))
    base = port.materials.base_color_factor.clone()
    base[0, :3] = 1.0                          # one material on the bound
    port = dataclasses.replace(port, materials=dataclasses.replace(
        port.materials, base_color_factor=base))
    cam = camera_from_numpy(flat(JCamera.make(**CORNELL_CAM)))
    cfg = path.RenderConfig(**CORNELL)
    target = torch.full((16, 16, 3), 0.2)

    def grads(through_params):
        em = port.materials.emissive_factor.clone().requires_grad_(True)
        bc = base.clone().requires_grad_(True)
        if through_params:
            scene = pinv.apply_params(port, pinv.TrainableParams(
                base_color_factor=bc, emissive_factor=em))
        else:
            scene = dataclasses.replace(port, materials=dataclasses.replace(
                port.materials, base_color_factor=bc, emissive_factor=em))
        img = path.render(scene, cam, rng.key(LOSS_KEY), cfg).mean()
        pinv.pixel_loss(img, target).backward()
        return em.grad.numpy(), bc.grad.numpy()

    (em_p, bc_p), (em_s, bc_s) = grads(True), grads(False)
    em0 = port.materials.emissive_factor.numpy() == 0.0
    assert em0.any() and (~em0).any()
    assert np.abs(em_s[em0]).max() > 0
    np.testing.assert_allclose(em_p[em0], 0.5 * em_s[em0], rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(em_p[~em0], em_s[~em0], rtol=1e-6, atol=1e-12)
    on = base.numpy()[:, :3] == 1.0
    inside = (base.numpy()[:, :3] > 0.0) & ~on
    assert on.any() and np.abs(bc_s[:, :3][on]).max() > 0
    np.testing.assert_allclose(bc_p[:, :3][on], 0.5 * bc_s[:, :3][on],
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(bc_p[:, :3][inside], bc_s[:, :3][inside],
                               rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("case", ["cornell", "cornell_ggx"])
def test_port_matches_gradient_golden_on_cpu(case):
    """The reference's jax.grad at 64x64 x 2 spp x 2 bounces
    (tests/data/cornell_grad_64_golden.npz, make_torch_golden.py
    cornell_grad): the four material fields on cornell, texture_data on
    cornell_ggx, each within its case's tolerance (the script states why
    cornell_ggx's is wider)."""
    mod = golden_module()
    gold = np.load(mod.GRAD["path"])
    spec = mod.GRAD["cases"][case]
    bc = config.get(spec["config"])
    scene, cam = config.build_scene(bc.scene, "cpu")
    cfg = dataclasses.replace(
        bc.render, width=mod.GRAD["size"], height=mod.GRAD["size"],
        spp=mod.GRAD["spp"], max_bounces=mod.GRAD["bounces"],
        tracer=mod.GRAD["tracer"])
    params = pinv.trainable_copy(
        pinv.TrainableParams.from_scene(scene, **spec["select"]))
    img = path.render(pinv.apply_params(scene, params), cam,
                      rng.key(int(gold["key"])), cfg).mean()
    loss = pinv.pixel_loss(img, torch.from_numpy(gold[f"{case}/target"]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(gold[f"{case}/loss"]),
                               rtol=1e-5)
    prefix = f"{case}/grad/"
    want = {k[len(prefix):]: gold[k] for k in gold.files
            if k.startswith(prefix)}
    assert_grads_close(port_grads(params), want, mod.GRAD["cases"][case]["rel"])
