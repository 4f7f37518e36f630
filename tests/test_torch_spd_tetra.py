"""The `spd_tetra` config, the port's own: Haines' SPD `tetra`
(`scene/procedural.py::make_spd_tetra`) against its definition, against the
benchmark's independent generator (`benchmark/reference/spd_tetra.py`) bit
for bit, and its render through phase A and K1 (`tracer="pallas"`)
against the JAX package's render of the same scene carried across as
numpy (the reference's K1 in interpret mode).  On the CPU, small sizes."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.apps import render as render_app
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import fused
from physically_based_renderer_tpu_torch.scene import procedural, types
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (assert_render_agrees, assert_scene_matches, flat,
                          np_)

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
DEPTHS = range(5)
ROOT = np.asarray(procedural.SPD_TETRA_CORNERS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normals(tris):
    return np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])


@pytest.mark.parametrize("depth", DEPTHS)
def test_triangle_count_is_four_faces_a_leaf(depth):
    tris = procedural.spd_tetra_triangles(depth)
    assert tris.shape == (4 ** depth * 4, 3, 3) and tris.dtype == np.float32
    assert procedural.make_spd_tetra(depth).geometry.num_tris == tris.shape[0]


@pytest.mark.parametrize("depth", DEPTHS)
def test_faces_wind_outward_inside_the_root(depth):
    """Each leaf's four faces (consecutive) face away from the leaf's
    centre, have the leaf's size, and every vertex lies inside the root
    tetrahedron, on its faces' planes at most."""
    tris = procedural.spd_tetra_triangles(depth).astype(np.float64)
    leaves = tris.reshape(-1, 4, 3, 3)
    centre = leaves.reshape(-1, 12, 3).mean(axis=1)          # exact: dyadic
    n = _normals(tris).reshape(-1, 4, 3)
    out = ((leaves[:, :, 0] - centre[:, None]) * n).sum(-1)
    assert (out > 0.0).all()
    edge = 2.0 * np.sqrt(2.0) / 2 ** depth
    lengths = np.linalg.norm(tris - np.roll(tris, 1, axis=1), axis=-1)
    np.testing.assert_allclose(lengths, edge, rtol=1e-12)
    # The root's faces: each plane through three corners, facing away from
    # the fourth.
    v = tris.reshape(-1, 3)
    for i in range(4):
        a, b, c = ROOT[[j for j in range(4) if j != i]]
        m = np.cross(b - a, c - a)
        m = m if np.dot(m, ROOT[i] - a) < 0 else -m
        assert ((v - a) @ m <= 0.0).all(), i


@pytest.mark.parametrize("depth", DEPTHS)
def test_port_generator_equals_the_benchmark_reference(depth, monkeypatch):
    """The port's generator and the benchmark's, written apart, give the same
    float32 faces bit for bit; at depth 4 the two scenes (the port's, and the
    reference's assembled by the frozen `reference/pbr_plain`) hold the same
    arrays."""
    monkeypatch.syspath_prepend(str(BENCH))
    from reference import spd_tetra as ref
    got = procedural.spd_tetra_triangles(depth)
    want = ref.tetra_triangles(depth)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    if depth == 4:
        assert_scene_matches(procedural.make_spd_tetra(),
                             ref.make_spd_tetra(), atol=0.0)


def test_config_takes_the_dense_loop_through_phase_a_and_k1():
    """512x512 x 4 spp x 4 bounces from the stated view; above
    RESIDENT_AUTO_MAX_TRIS, so "auto" picks the block tracer; K4 takes no
    scene with an env map, so a CUDA frame keeps the dense loop."""
    bc = config.get("spd_tetra")
    assert (bc.render.width, bc.render.height, bc.render.spp,
            bc.render.max_bounces) == (512, 512, 4, 4)
    assert bc.render.tracer == "auto"
    assert (bc.scene.camera_position, bc.scene.camera_target,
            bc.scene.fov_y) == ((2.2, 1.6, 3.0), (0.0, 0.0, 0.0), 0.9)
    scene, cam = config.build_scene(bc.scene, "cpu")
    assert scene.geometry.num_tris == 1024 and scene.env is not None
    assert scene.flat_normals and not scene.has_emitters
    assert scene.clusters is not None
    assert path.make_tracer(scene, bc.render).name == "pallas"
    assert not fused.fused_applicable(scene, bc.render)
    m = scene.materials
    np.testing.assert_array_equal(np_(m.base_color_factor),
                                  np.float32([[0.8, 0.8, 0.8, 1.0]]))
    assert (float(m.roughness_factor[0]), float(m.metallic_factor[0]),
            float(m.specular_factor[0])) == (0.5, 0.0, 1.0)


def test_render_cli_renders_the_config(tmp_path, capsys):
    out = tmp_path / "tetra.png"
    assert render_app.main(["spd_tetra", "-o", str(out), "--device", "cpu",
                            "--width", "16", "--height", "12", "--spp", "1",
                            "--bounces", "1", "--stats"]) == 0
    assert out.stat().st_size > 0
    assert '"rays": ' in capsys.readouterr().err


def _jax_scene(port_scene):
    """The port's scene rebuilt by the JAX package from the port's arrays."""
    g, m = port_scene.geometry, port_scene.materials
    geometry = jproc._geometry_from_arrays(np_(g.positions), np_(g.indices),
                                           np_(g.tri_material))
    mats = jtypes.Materials.default(1).replace(
        base_color_factor=np_(m.base_color_factor),
        roughness_factor=np_(m.roughness_factor),
        metallic_factor=np_(m.metallic_factor))
    return jtypes.with_clusters(jtypes.make_scene(
        geometry, mats, env=jproc.make_gradient_sky()))


def test_pallas_render_matches_the_jax_package():
    """Depth 4 at 16x16 x 2 spp x 2 bounces through phase A and K1 against
    the JAX package's `tracer="pallas"` render of the same scene at the same
    key: the scenes equal, the ray counts equal, the film within the
    render-parity tolerances (`torch_parity.assert_render_agrees`)."""
    port = types.with_clusters(procedural.make_spd_tetra(4))
    ref = _jax_scene(port)
    assert_scene_matches(port, ref)
    np.testing.assert_array_equal(np_(port.clusters.tri_id),
                                  np.asarray(ref.clusters.tri_id))
    spec = config.get("spd_tetra").scene
    jcam = JCamera.make(position=spec.camera_position,
                        target=spec.camera_target, fov_y=spec.fov_y)
    kw = dict(width=16, height=16, spp=2, max_bounces=2, tracer="pallas")
    jfilm, jcount = j_render(ref, jcam, jax.random.key(21),
                             JRenderConfig(**kw))
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(21), path.RenderConfig(**kw))
    assert int(count) == int(jcount)
    assert np.asarray(jfilm.mean()).mean() > 0.0
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))
