"""The port's resident tracer (K2): plain version against the reference
kernel in interpret mode and against brute force; the CUDA kernel against
the plain version on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_with_stats as j_render_with_stats)
from physically_based_renderer_tpu.ops.intersect import (
    intersect_brute as j_brute, occluded_brute as j_occluded)
from physically_based_renderer_tpu.ops.resident import (
    intersect_resident as j_resident)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu.scene.procedural import (
    make_cornell_box as j_cornell, make_random_tris as j_random_tris)
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import cuda_lib, resident
from physically_based_renderer_tpu_torch.ops.intersect import (
    BIG, intersect_brute, occluded_brute)
from physically_based_renderer_tpu_torch.scene import types
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from torch_parity import assert_render_agrees, flat, scene_arrays

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def cornell():
    ref = j_cornell()
    return ref, scene_from_numpy(scene_arrays(ref))


def _rays(n, seed, center=(0.0, 1.0, 1.5), spread=0.5):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-spread, spread, (n, 3))
         + np.asarray(center)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _port_of(ref_geometry):
    """Port scene of a reference geometry with one default material."""
    return scene_from_numpy(scene_arrays(
        jtypes.make_scene(ref_geometry, jtypes.Materials.default(1))))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("t_min", [0.0, 1e-3])
def test_plain_closest_matches_reference_kernel(cornell, t_min):
    ref, port = cornell
    o, d = _rays(700, 0)
    want = j_resident(ref.geometry, jnp.asarray(o), jnp.asarray(d),
                      t_min=t_min, interpret=True)
    got = resident.intersect_resident(port.geometry, *_t(o, d), t_min=t_min)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-6)
    assert got.tri.dtype == torch.int32
    np.testing.assert_array_equal(got.u.numpy(), 0.0)


@pytest.mark.parametrize("t_min", [0.0, 1e-3])
def test_plain_any_hit_matches_reference_kernel(cornell, t_min):
    ref, port = cornell
    o, d = _rays(600, 1)
    t_max = np.random.default_rng(3).uniform(0.1, 4.0, 600).astype(np.float32)
    want = j_resident(ref.geometry, jnp.asarray(o), jnp.asarray(d),
                      t_min=t_min, t_max=jnp.asarray(t_max), any_hit=True,
                      interpret=True)
    got = resident.intersect_resident(port.geometry, *_t(o, d), t_min=t_min,
                                      t_max=torch.from_numpy(t_max),
                                      any_hit=True)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_matches_brute_on_random_soup():
    ref_g = j_random_tris(300, seed=4)
    port = _port_of(ref_g)
    o, d = _rays(400, 5, center=(0.0, 0.0, 0.0), spread=1.2)
    v0, v1, v2 = ref_g.tri_vertices()
    want = j_brute(jnp.asarray(o), jnp.asarray(d), v0, v1, v2, t_min=1e-3)
    got = resident.intersect_resident(port.geometry, *_t(o, d), t_min=1e-3)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=1e-5)
    pv = port.geometry.tri_vertices()
    brute = intersect_brute(*_t(o, d), *pv, t_min=1e-3, chunk=64)
    np.testing.assert_array_equal(brute.tri.numpy(), got.tri.numpy())
    occ_want = j_occluded(jnp.asarray(o), jnp.asarray(d), v0, v1, v2,
                          t_min=1e-3, t_max=0.7)
    occ = resident.intersect_resident(port.geometry, *_t(o, d), t_min=1e-3,
                                      t_max=0.7, any_hit=True)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_want))
    np.testing.assert_array_equal(
        occluded_brute(*_t(o, d), *pv, t_min=1e-3, t_max=0.7).numpy(),
        occ.numpy())


def test_tie_goes_to_lowest_triangle(cornell):
    """A ray down onto the floor quad's shared diagonal hits triangles 0 and
    1 at the same t; the winner is the lower index, as in the reference."""
    ref, port = cornell
    o = np.array([[0.0, 1.0, 0.0], [0.5, 1.0, -0.5]], np.float32)
    d = np.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0]], np.float32)
    soup = resident.pack_resident_soup(port.geometry)
    o_t, d_t = _t(o, d)
    per_tri = [resident.trace_plain(soup[k:k + 1], o_t, d_t,
                                    torch.full((2,), BIG), 1e-3, False)
               for k in (0, 1)]
    assert all(bool((tri == 0).all()) for _, tri in per_tri)  # both hit
    np.testing.assert_array_equal(per_tri[0][0].numpy(),
                                  per_tri[1][0].numpy())      # same t
    got = resident.intersect_resident(port.geometry, o_t, d_t, t_min=1e-3)
    want = j_resident(ref.geometry, jnp.asarray(o), jnp.asarray(d),
                      t_min=1e-3, interpret=True)
    np.testing.assert_array_equal(got.tri.numpy(), [0, 0])
    np.testing.assert_array_equal(np.asarray(want.tri), [0, 0])


def test_miss_is_big_and_minus_one(cornell):
    _, port = cornell
    o = torch.tensor([[0.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 1.0, 0.0]])
    hit = resident.intersect_resident(port.geometry, o, d)
    assert int(hit.tri[0]) == -1 and hit.t[0].item() == np.float32(BIG)
    assert bool(hit.miss[0])


@pytest.mark.parametrize("t_min", [0.0, 1e-3])
@pytest.mark.parametrize("geometry", ["cornell", "random", "huge"])
def test_plain_dead_lanes_miss_whatever_the_geometry(cornell, geometry,
                                                     t_min):
    """A lane whose t_max is not above t_min (or NaN) gets (1e30, -1) and
    false from the plain version: t > t_min and t < t_max exclude each
    other.  The kernel writes these answers without a test."""
    _, port = cornell
    soup = resident.pack_resident_soup(port.geometry)
    if geometry == "random":
        soup = resident.pack_resident_soup(
            _port_of(j_random_tris(300, seed=9)).geometry)
    elif geometry == "huge":
        soup = torch.cat([soup, torch.tensor(
            [[-1.0, -1.0, -0.5, 1e19, 0.0, 0.0, 0.0, 1e19, 0.0]])])
    o, d = _t(*_rays(500, 10, center=(0.0, 1.0, 0.0), spread=1.0))
    rng = np.random.default_rng(11)
    dead = torch.from_numpy(rng.choice(
        np.array([0.0, np.nan, t_min, t_min - 1.0, -np.inf, np.nextafter(
            np.float32(t_min), np.float32(-1.0))], np.float32), 500))
    live = torch.from_numpy(rng.uniform(0.5, 4.0, 500).astype(np.float32))
    is_dead = torch.from_numpy(rng.random(500) < 0.5)
    tm = torch.where(is_dead, dead, live)
    t, tri = resident.trace_plain(soup, o, d, tm, t_min, False)
    occ = resident.trace_plain(soup, o, d, tm, t_min, True)
    assert bool((t[is_dead] == np.float32(BIG)).all())
    assert bool((tri[is_dead] == -1).all())
    assert not bool(occ[is_dead].any())
    # the live lanes do hit, so the dead ones would have had something to
    # hit too
    assert bool((tri[~is_dead] >= 0).any()) and bool(occ[~is_dead].any())


def test_plain_chunks_rays(cornell, monkeypatch):
    _, port = cornell
    o, d = _t(*_rays(333, 6))
    full = resident.intersect_resident(port.geometry, o, d, t_min=1e-3)
    monkeypatch.setattr(resident, "_PLAIN_CHUNK", 32 * 7)
    chunked = resident.intersect_resident(port.geometry, o, d, t_min=1e-3)
    np.testing.assert_array_equal(chunked.tri.numpy(), full.tri.numpy())
    np.testing.assert_array_equal(chunked.t.numpy(), full.t.numpy())
    empty = resident.trace_plain(resident.pack_resident_soup(port.geometry),
                                 o[:0], d[:0], torch.zeros(0), 0.0, True)
    assert tuple(empty.shape) == (0,)


def test_wrapper_checks_and_cpu_dispatch(cornell):
    _, port = cornell
    soup = resident.pack_resident_soup(port.geometry)
    assert tuple(soup.shape) == (32, resident.SOUP_W)
    o, d = _t(*_rays(10, 7))
    tm = torch.full((10,), BIG)
    before = resident.LAUNCHES
    resident.trace(soup, o, d, tm, 0.0, False)
    assert resident.LAUNCHES == before       # CPU tensors: plain version
    with pytest.raises(TypeError):
        resident.trace(soup, o.double(), d, tm, 0.0, False)
    with pytest.raises(ValueError):
        resident.trace(soup, o, d, tm[:5], 0.0, False)
    with pytest.raises(ValueError):
        resident.trace(soup, o.t().contiguous().t(), d, tm, 0.0, False)
    with pytest.raises(ValueError):
        big = torch.zeros((resident.RESIDENT_MAX_TRIS + 1, resident.SOUP_W))
        resident.trace(big, o, d, tm, 0.0, False)
    meta = [x.to("meta") for x in (soup, o, d, tm)]
    with pytest.raises(ValueError):
        resident.trace(*meta, 0.0, False)


def test_auto_tracer_dispatch(cornell):
    """Up to 512 triangles the resident tracer; above, without a cluster
    grid, the BVH walk where the scene has a BVH, else brute force (the
    reference's order); a block tracer needs the grid."""
    _, port = cornell
    assert path._auto_tracer(port) == "resident"
    big = _port_of(j_random_tris(resident.RESIDENT_AUTO_MAX_TRIS + 1, seed=8))
    assert path._auto_tracer(big) == "brute"
    assert path._auto_tracer(types.with_bvh(big)) == "bvh"
    for tracer in ("block", "pallas"):
        with pytest.raises(ValueError, match="cluster grid"):
            path.closest_hit(port, torch.zeros(1, 3), torch.ones(1, 3), 0.0,
                             path.RenderConfig(tracer=tracer))
    with pytest.raises(ValueError, match="unknown tracer"):
        path.closest_hit(port, torch.zeros(1, 3), torch.ones(1, 3), 0.0,
                         path.RenderConfig(tracer="bvh2"))


@pytest.mark.parametrize("bvh", [False, True])
def test_scene_above_the_resident_limit_without_a_grid_renders(bvh):
    """A 513-triangle scene without a cluster grid renders through tracer
    "auto" as the reference renders it (its auto tracer: the BVH walk with
    a BVH, else brute force): PIXEL_FRAC of the pixels within ATOL + RTOL
    |ref|, mean and ray count within 0.5%."""
    ref = jtypes.make_scene(
        jproc.make_uv_sphere(radius=1.0, rings=19, sectors=14),
        jtypes.Materials.default(1),
        env=jtypes.EnvMap.constant((0.8, 0.9, 1.0)))
    if bvh:
        ref = jtypes.with_bvh(ref)
    port = types.scene_from_numpy(scene_arrays(ref))
    if bvh:
        port = types.with_bvh(port)
    assert port.geometry.num_tris > resident.RESIDENT_AUTO_MAX_TRIS
    assert path.make_tracer(port, path.RenderConfig()).name == (
        "bvh" if bvh else "brute")
    jcam = JCamera.make(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                        fov_y=1.0)
    small = dict(width=12, height=12, spp=2, max_bounces=2)
    jfilm, jcount = j_render_with_stats(ref, jcam, jax.random.key(4),
                                        JRenderConfig(**small))
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(4),
                                         path.RenderConfig(**small))
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent plain fallback."""
    if cuda_lib.build_dir().joinpath(cuda_lib.LIB_NAME).exists():
        pytest.skip("the kernel library is already built here")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib.build()
    assert not cuda_lib.build_dir().exists()


def test_failed_kernel_build_raises_and_leaves_no_files(monkeypatch,
                                                        tmp_path):
    """A compiler error raises with its output; no object, temporary or
    half-written library is left in the build directory."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text("#!/bin/sh\necho 'error: no card here'\nexit 3\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(cuda_lib, "_PKG", tmp_path / "pkg")
    with pytest.raises(RuntimeError, match="nvcc failed \\(3\\)"):
        cuda_lib.build()
    out_dir = cuda_lib.build_dir()
    assert out_dir.is_relative_to(tmp_path)
    assert list(out_dir.iterdir()) == []
