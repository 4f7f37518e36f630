"""Port scene/, ops/gather, ops/texture, pack_tri_attrs and utils/config
against the reference: builders and tables must be equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.integrator import path as jpath
from physically_based_renderer_tpu.integrator.shading import (
    pack_tri_attrs as j_pack_tri_attrs)
from physically_based_renderer_tpu.ops.gather import take_rows as j_take_rows
from physically_based_renderer_tpu.ops.texture import (
    texture_meta as j_texture_meta)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu.utils import config as jconfig
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.integrator.shading import (
    ATTR_W, pack_tri_attrs)
from physically_based_renderer_tpu_torch.ops.gather import (take_rows,
                                                            take_values)
from physically_based_renderer_tpu_torch.ops.texture import texture_meta
from physically_based_renderer_tpu_torch.scene import procedural
from physically_based_renderer_tpu_torch.scene import types
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (FLAG_FIELDS, RECORDS, assert_records_equal,
                          many_emitters_reference, np_, scene_arrays)

torch.set_num_threads(1)

BUILDERS = {
    "cornell": (procedural.make_cornell_box, jproc.make_cornell_box),
    "cornell_metal": (
        lambda: procedural.make_cornell_box(metallic_tall_block=True,
                                            roughness=0.3),
        lambda: jproc.make_cornell_box(metallic_tall_block=True,
                                       roughness=0.3)),
    "triangle": (procedural.make_triangle_scene, jproc.make_triangle_scene),
}


def _port_scene(ref):
    return types.scene_from_numpy(scene_arrays(ref))


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builders_match_reference(name):
    port_fn, ref_fn = BUILDERS[name]
    port, ref = port_fn(), ref_fn()
    for rec in RECORDS:
        assert_records_equal(getattr(port, rec), getattr(ref, rec))
    assert port.env is None and ref.env is None
    for flag in FLAG_FIELDS:
        assert getattr(port, flag) == getattr(ref, flag), flag


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_scene_from_numpy_equals_builder(name):
    port_fn, ref_fn = BUILDERS[name]
    carried, built = _port_scene(ref_fn()), port_fn()
    for rec in RECORDS:
        assert_records_equal(getattr(carried, rec), getattr(built, rec))
    for flag in FLAG_FIELDS:
        assert getattr(carried, flag) == getattr(built, flag), flag
    assert carried.geometry.indices.dtype == torch.int32
    assert carried.emitters.valid.dtype == torch.bool


def test_emitter_table_alias_branch_matches_reference():
    ref = many_emitters_reference()
    carried = _port_scene(ref)
    port = types.make_scene(carried.geometry, carried.materials)
    assert port.emitters.num_emitters == 80
    assert_records_equal(port.emitters, ref.emitters)


def test_alias_table_reproduces_distribution():
    p = np.random.default_rng(1).random(37)
    p /= p.sum()
    prob, alias = types._build_alias_table(p)
    recon = prob / p.size
    np.add.at(recon, alias, (1.0 - prob) / p.size)
    np.testing.assert_allclose(recon, p, rtol=1e-5, atol=1e-7)


def test_emitter_table_empty_without_emitters():
    port = procedural.make_triangle_scene()
    assert not port.has_emitters and port.has_directional
    assert_records_equal(port.emitters, jtypes.EmitterTable.empty())


def test_upload_scene_moves_every_tensor():
    scene = types.upload_scene(procedural.make_cornell_box(), "meta")
    assert scene.device.type == "meta"
    assert scene.materials.emissive_factor.device.type == "meta"
    assert scene.emitters.alias_idx.device.type == "meta"
    assert scene.has_emitters and scene.tex_slots == (False,) * 4


@pytest.mark.parametrize("name", ["cornell", "triangle"])
def test_pack_tri_attrs_matches_reference(name):
    port_fn, ref_fn = BUILDERS[name]
    ref = ref_fn()
    got = pack_tri_attrs(port_fn())
    want = np.asarray(j_pack_tri_attrs(ref))
    assert tuple(got.shape) == want.shape == (ref.geometry.num_tris, ATTR_W)
    np.testing.assert_array_equal(got.numpy(), want)


def test_texture_meta_matches_reference():
    stack = types.TextureStack.empty()
    np.testing.assert_array_equal(
        texture_meta(stack), j_texture_meta(jtypes.TextureStack.empty()))


def test_take_rows_matches_reference():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(13, 5)).astype(np.float32)
    idx = rng.integers(-3, 16, 50).astype(np.int32)
    want = np.asarray(j_take_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        take_values(torch.from_numpy(table[:, 0]), torch.from_numpy(idx)),
        want[:, 0])


# Configs of the port's own, which the reference does not have
# (tests/test_torch_spd_tetra.py holds them).
PORT_ONLY_CONFIGS = ("spd_tetra",)


def test_configs_match_reference():
    assert sorted(config.CONFIGS) == sorted(
        [*jconfig.CONFIGS, *PORT_ONLY_CONFIGS])
    for name, bc in config.CONFIGS.items():
        if name in PORT_ONLY_CONFIGS:
            continue
        ref = jconfig.CONFIGS[name]
        assert dataclasses.asdict(bc.render) == dataclasses.asdict(ref.render)
        assert bc.scene.builder == ref.scene.builder
        assert bc.scene.camera_position == ref.scene.camera_position
        assert bc.scene.fov_y == ref.scene.fov_y


def test_render_config_defaults_match_reference():
    assert (dataclasses.asdict(path.RenderConfig())
            == dataclasses.asdict(jpath.RenderConfig()))


@pytest.mark.parametrize("name", ["triangle", "cornell", "cornell_ggx",
                                  "cornell_tex256"])
def test_build_scene_matches_builder(name):
    scene, cam = config.build_scene(config.get(name).scene, "cpu")
    ref, _ = jconfig.build_scene(jconfig.get(name).scene)
    assert scene.geometry.num_tris == ref.geometry.num_tris
    assert scene.textures.shapes == ref.textures.shapes
    np.testing.assert_array_equal(np_(scene.clusters.tri_id),
                                  np.asarray(ref.clusters.tri_id))
    np.testing.assert_array_equal(
        np_(cam.position), np.asarray(config.get(name).scene.camera_position,
                                      np.float32))


@pytest.mark.parametrize("name", ["helmet"])
def test_unported_builders_raise(name, tmp_path):
    """Every builder of the reference is ported: the glTF builders build
    (here the small helmet and a file by path), and only a builder name the
    reference does not know raises."""
    spec = dataclasses.replace(
        config.get(name).scene,
        extra={"cache_dir": tmp_path, "scale_tris": 0.02})
    scene, cam = config.build_scene(spec)
    assert scene.geometry.num_tris == 1880 and scene.clusters is not None
    assert scene.env is not None and scene.device.type == "cpu"
    glb = next(tmp_path.glob("*.glb"))
    by_path, cam2 = config.build_scene(
        config.SceneSpec(builder="gltf", extra={"path": glb}), "cpu")
    assert by_path.geometry.num_tris == 1880 and by_path.env is None
    np.testing.assert_array_equal(np_(cam2.position), [0.0, 0.0, 5.0])
    with pytest.raises(ValueError, match="unknown scene builder"):
        config.build_scene(config.SceneSpec(builder="usd"))
