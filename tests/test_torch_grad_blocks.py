"""Gradients through the block tracer (`tracer="pallas"`: phase A and K1's
plain version in the port, the reference's K1 in interpret mode under
jax.grad) against the reference's, on the 1,152-triangle helmet24 with
textures: render() + pixel_loss at the same key, one module-scoped
reference gradient."""

import jax
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene import types
from test_torch_grad import REL, _port_loss_and_grad, _reference
from torch_parity import assert_grads_close, flat, params_to_port, scene_arrays

torch.set_num_threads(1)

HELMET_CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                  fov_y=1.0)
SMALL = dict(width=8, height=8, spp=1, max_bounces=2)
FIELDS = dict(base_color=True, roughness=True, metallic=True, textures=True)


@pytest.fixture(scope="module")
def reference():
    scene = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24))
    assert jax.default_backend() == "cpu"
    return scene, _reference(scene, HELMET_CAM, SMALL, "pallas", FIELDS)


def test_block_tracer_gradients_match_reference(reference):
    """Loss within 1e-5 relative; every trained field (base colour,
    roughness, metallic, the texel arena) within REL (1e-4) of
    max|g_ref|."""
    scene, (target, jparams, (ref_loss, ref_g)) = reference
    port = types.with_clusters(types.scene_from_numpy(scene_arrays(scene)))
    cfg = path.RenderConfig(**SMALL, tracer="pallas")
    assert port.geometry.num_tris == 1152
    loss, g = _port_loss_and_grad(
        port, camera_from_numpy(flat(JCamera.make(**HELMET_CAM))), cfg,
        params_to_port(jparams), target)
    assert sorted(g) == ["base_color_factor", "metallic_factor",
                         "roughness_factor", "texture_data"]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert_grads_close(g, ref_g, REL)
