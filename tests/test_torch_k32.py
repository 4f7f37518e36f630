"""The k = 32 sub-cluster route against the reference: `with_clusters(k=32)`,
`pack_soup32` and its inverse, a reference k = 32 grid carried over by
`scene_from_numpy`, K1's plain version at the reference's k = 32 chunk rule
and candidate padding, the XLA block tracer, `refit_clusters`, a render
through `tracer="pallas"`, `SceneSpec.cluster_k` and the report.

The reference stores a k = 32 soup as four lane-group variants
([(C+1)*4, 16, 128]); the port keeps the compact [C+1, 9, 32] for its
kernel.  Grids, soups and winners are exact; hit distances agree to
T_RTOL (the reference's jitted kernel contracts multiply-adds into FMAs on
the CPU, tests/test_torch_blocktrace.py).  The reference's K1 runs in
interpret mode on at most 256 rays a call, which keeps each test to
seconds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.accel import clusters as jclusters
from physically_based_renderer_tpu.apps import report as jreport
from physically_based_renderer_tpu.ops import blocktrace as jbt
from physically_based_renderer_tpu.ops import intersect as jintersect
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu.utils import config as jconfig
from physically_based_renderer_tpu_torch.accel import clusters
from physically_based_renderer_tpu_torch.apps import report
from physically_based_renderer_tpu_torch.grad import inverse as pinv
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import blocktrace as bt
from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
from physically_based_renderer_tpu_torch.ops.intersect import BIG
from physically_based_renderer_tpu_torch.scene import procedural, types
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import (assert_render_agrees, flat, np_, params_to_port,
                          scene_arrays)

torch.set_num_threads(1)
T_RTOL = 1e-5
GRID_FIELDS = ("aabb_min", "aabb_max", "tri_id", "parent_min", "parent_max")
GEOMETRIES = {
    "sphere20": lambda: jproc.make_uv_sphere(rings=20, sectors=20),
    "random159": lambda: jproc.make_random_tris(159, seed=3),
    "sphere5x6": lambda: jproc.make_uv_sphere(radius=1.0, rings=5,
                                              sectors=6),
}


def _reference(geometry, k=32):
    """The reference's scene of a geometry with its k-cluster grid."""
    return jtypes.with_clusters(
        jtypes.make_scene(geometry, jtypes.Materials.default(1)), k=k)


def _carried(ref):
    """The port's scene of a reference scene, its cluster grid carried."""
    arrays = scene_arrays(ref)
    arrays["clusters"] = flat(ref.clusters)
    return types.scene_from_numpy(arrays)


@pytest.fixture(scope="module")
def sphere20():
    ref = _reference(GEOMETRIES["sphere20"]())
    return ref, _carried(ref)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _assert_grid(grid, ref):
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(np_(getattr(grid, f)),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def test_with_clusters_k32_matches_reference():
    """helmet24 (1,152 triangles): boxes, tri_id and parents exact, the
    soup the reference's variant soup unpacked, and packed again bit for
    bit; the default k stays CLUSTER_K."""
    ref = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24), k=32)
    port = types.with_clusters(procedural.make_helmet_class_scene(24, 24),
                               k=32)
    grid = port.clusters
    assert grid.k == 32 and grid.num_clusters == ref.clusters.num_clusters
    _assert_grid(grid, ref.clusters)
    assert grid.soup.shape == (grid.num_clusters + 1, 9, 32)
    assert grid.soup.is_contiguous()
    want = np.asarray(ref.clusters.soup)
    np.testing.assert_array_equal(np_(grid.soup),
                                  np_(clusters.unpack_soup32(want)))
    assert clusters.pack_soup32(grid.soup[:-1]).numpy().tobytes() == \
        want.tobytes()
    default = types.with_clusters(procedural.make_helmet_class_scene(8, 8))
    assert default.clusters.k == clusters.CLUSTER_K


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_pack_soup32_bit_equal_to_reference(name):
    """random159 fills its 8 sub-clusters partly (159 triangles); the
    60-triangle sphere5x6 has fewer than 4, not a multiple of 4."""
    g = GEOMETRIES[name]()
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    ref_grid = jclusters.build_clusters(pos, idx, k=32)
    comp = jclusters._soup_components(ref_grid, pos, idx, np)
    want = np.asarray(jclusters.pack_soup32(ref_grid, comp, np))
    got = clusters.pack_soup32(torch.from_numpy(comp))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()
    if name == "sphere5x6":
        assert ref_grid.num_clusters % 4 != 0
    if name == "random159":
        assert bool((ref_grid.tri_id < 0).any())
    # the port's own components give the same soup
    grid = clusters.pack_soup_host(clusters.build_clusters(pos, idx, k=32),
                                   pos, idx)
    assert clusters.pack_soup32(grid.soup[:-1]).numpy().tobytes() == \
        want.tobytes()


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_unpack_soup32_inverts_pack_soup32(name):
    g = GEOMETRIES[name]()
    pos, idx = np.asarray(g.positions), np.asarray(g.indices)
    grid = clusters.pack_soup_host(clusters.build_clusters(pos, idx, k=32),
                                   pos, idx)
    variants = clusters.pack_soup32(grid.soup[:-1])
    assert variants.shape == ((grid.num_clusters + 1) * 4, 16, 128)
    assert torch.equal(clusters.unpack_soup32(variants), grid.soup)
    # the four variants of a sub-cluster sum to its rows in their lanes
    summed = variants.reshape(-1, 4, 16, 128).sum(dim=1)
    for p in range(4):
        assert torch.equal(summed[:, :9, 32 * p:32 * p + 32], grid.soup)
    with pytest.raises(ValueError):
        clusters.unpack_soup32(grid.soup)
    with pytest.raises(ValueError):
        clusters.pack_soup32(torch.zeros((2, 9, 128)))


def test_scene_from_numpy_unpacks_a_reference_k32_grid(sphere20):
    """The reference's k = 32 soup reaches the port as [C+1, 9, 32]; before,
    its first 9 variant rows were kept ([(C+1)*4, 9, 128]), and that grid
    is refused before K1."""
    ref, port = sphere20
    grid = port.clusters
    _assert_grid(grid, ref.clusters)
    assert grid.k == 32 and grid.soup.shape == (grid.num_clusters + 1, 9, 32)
    np.testing.assert_array_equal(
        np_(grid.soup), np_(types.with_clusters(port, k=32).clusters.soup))
    bad = dataclasses.replace(grid, soup=torch.from_numpy(np.ascontiguousarray(
        np.asarray(ref.clusters.soup)[:, :9])))
    o, d = (torch.from_numpy(x) for x in _rays(64, 0))
    with pytest.raises(ValueError, match="soup has shape"):
        bt.intersect_blocks_pallas(bad, o, d, block=32, max_u=96)
    k128 = types.with_clusters(port).clusters
    with pytest.raises(ValueError, match="soup has shape"):
        bt.block_inputs(dataclasses.replace(grid, soup=k128.soup), o, d, 1e-4)


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("chunk,max_u", [(4, 96), (16, 96), (4, 6), (16, 6)])
def test_carried_k32_scene_traces_as_reference(sphere20, chunk, max_u,
                                               any_hit):
    """256 random rays, block 128, through the port's plain K1 on the
    carried grid against the reference's k32 tracer in interpret mode (the
    carry-across raised IndexError in the winner decode before).  max_u 6
    selects through the parent boxes (32 sub-clusters > 4 x 6) and
    truncates the candidate lists."""
    ref, port = sphere20
    o, d = _rays(256, 1)
    kw = dict(t_min=1e-4, block=128, max_u=max_u, chunk=chunk)
    if any_hit:
        kw.update(t_max=3.0, any_hit=True, sort=True)
    want = jbt.intersect_blocks_pallas(ref.clusters, ref.geometry,
                                       jnp.asarray(o), jnp.asarray(d),
                                       interpret=True, lean=True, **kw)
    got = bt.intersect_blocks_pallas(port.clusters, torch.from_numpy(o),
                                     torch.from_numpy(d), **kw)
    if any_hit:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < got.numel()
        return
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=T_RTOL)
    assert 0 < int((got.tri >= 0).sum()) < len(o)


@pytest.mark.parametrize("chunk", [4, 16])
def test_k32_partial_final_chunk_and_tiny_scene(chunk):
    """tests/test_bvh.py:196-240 at block 32: (a) 159 random triangles (8
    sub-clusters, partly filled), a ray down onto each, so winners lie in
    partial final chunks beside the sentinel; (b) a 60-triangle sphere of
    fewer than 4 sub-clusters, whose candidate list pads up to a whole
    chunk.  Against the reference's tracer and brute force."""
    ref = _reference(GEOMETRIES["random159"]())
    port = _carried(ref)
    v0, v1, v2 = (np.asarray(v) for v in ref.geometry.tri_vertices())
    o = ((v0 + v1 + v2) / 3.0 + np.array([0, 0, 5.0], np.float32)).astype(
        np.float32)
    d = np.tile(np.array([[0, 0, -1.0]], np.float32), (len(o), 1))
    ref2 = _reference(GEOMETRIES["sphere5x6"]())
    assert ref2.clusters.num_clusters < 4
    o2 = np.array([[0, 0, 3.0]] * 8, np.float32) + np.float32(0.01) * \
        np.random.default_rng(4).normal(size=(8, 3)).astype(np.float32)
    d2 = np.tile(np.array([[0, 0, -1.0]], np.float32), (8, 1))
    for r, p, oo, dd in ((ref, port, o, d), (ref2, _carried(ref2), o2, d2)):
        kw = dict(t_min=1e-4, block=32, max_u=96, chunk=chunk)
        want = jbt.intersect_blocks_pallas(r.clusters, r.geometry,
                                           jnp.asarray(oo), jnp.asarray(dd),
                                           interpret=True, lean=True, **kw)
        got = bt.intersect_blocks_pallas(p.clusters, torch.from_numpy(oo),
                                         torch.from_numpy(dd), **kw)
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        # The reference test's own tolerance for this data (test_bvh.py:
        # 227-229): a ray down onto a random triangle seen nearly edge-on
        # moves t by 1.4e-5 relative under the reference's FMA contraction.
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=1e-4, atol=1e-5)
        brute = jintersect.intersect_brute(
            jnp.asarray(oo), jnp.asarray(dd), *r.geometry.tri_vertices(),
            t_min=1e-4)
        np.testing.assert_allclose(got.t.numpy(), np.asarray(brute.t),
                                   rtol=1e-4)
        assert bool((got.tri >= 0).all())


@pytest.mark.parametrize("chunk", [2, 4, 6, 16])
def test_k32_candidate_list_pads_to_whole_chunks(sphere20, chunk):
    """The candidate list's width at k = 32 is a whole number of chunks of
    max(4, 4 * (chunk // 4)), also where phase A keeps fewer candidates
    than one chunk (the reference's :480-487); K1 takes it at the same
    chunk, and a k = 128 grid keeps min(chunk, n_u)."""
    _, port = sphere20
    o, d = (torch.from_numpy(x) for x in _rays(64, 2))
    ch = max(4, 4 * (chunk // 4))
    for max_u in (2, 3, 10, 96):
        args, _ = bt.block_inputs(port.clusters, o, d, 1e-4, block=32,
                                  max_u=max_u, chunk=chunk)
        n_u = min(max_u, port.clusters.num_clusters)
        assert args[0].shape[1] == -(-n_u // ch) * ch
        assert bool((args[0][:, n_u:] == port.clusters.num_clusters).all())
        assert bool((args[6][:, n_u:] == BIG).all())
        tb.trace_blocks(*args, t_min=1e-4, any_hit=False, chunk=chunk)
        assert tb.chunk_width(chunk, args[0].shape[1], 32) == ch
    big = types.with_clusters(port).clusters
    args, _ = bt.block_inputs(big, o, d, 1e-4, block=32, max_u=96,
                              chunk=chunk)
    n_u = big.num_clusters                                # 8
    ch = min(chunk, n_u)
    assert args[0].shape[1] == -(-n_u // ch) * ch
    assert tb.chunk_width(chunk, n_u, 128) == ch


def test_trace_blocks_k32_chunk_rule():
    """K1 at K = 32 steps over max(4, 4 * (min(chunk, U) // 4)) candidates
    (the reference's trace_blocks_pallas :287-290): a list of 4 runs at
    chunks 1-7, one of 6 is refused."""
    soup = torch.zeros((3, 9, 32))
    o = torch.zeros((1, 32, 3))
    d = torch.tensor([0.0, 0.0, 1.0]).expand(1, 32, 3).contiguous()
    tm = torch.ones((1, 32))
    n_valid = torch.tensor([2], dtype=torch.int32)
    for chunk in range(1, 8):
        u_idx = torch.tensor([[0, 1, 2, 2]], dtype=torch.int32)
        tb.trace_blocks(u_idx, o, d, tm, soup, n_valid, torch.zeros((1, 4)),
                        t_min=0.0, any_hit=True, chunk=chunk)
    u_idx = torch.tensor([[0, 1, 2, 2, 2, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of the chunk 4"):
        tb.trace_blocks(u_idx, o, d, tm, soup, n_valid, torch.zeros((1, 6)),
                        t_min=0.0, any_hit=True, chunk=4)


def test_block_tracer_k32_matches_reference(sphere20):
    """tracer="block" (the XLA block tracer) on the k = 32 grid."""
    ref, port = sphere20
    o, d = _rays(256, 3)
    kw = dict(t_min=1e-4, block=64, max_u=12)
    want = jbt.intersect_blocks(ref.clusters, ref.geometry, jnp.asarray(o),
                                jnp.asarray(d), **kw)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    got = bt.intersect_blocks(port.clusters, port.geometry, o_t, d_t, **kw)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               rtol=T_RTOL)
    occ = bt.intersect_blocks(port.clusters, port.geometry, o_t, d_t,
                              t_max=2.0, any_hit=True, **kw)
    want_occ = jbt.intersect_blocks(ref.clusters, ref.geometry,
                                    jnp.asarray(o), jnp.asarray(d),
                                    t_max=2.0, any_hit=True, **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))


def test_refit_clusters_k32_matches_reference(sphere20):
    """A moved and scaled sphere: boxes and parents exact, the soup the
    reference's refit variant soup unpacked; the vertex-training step's
    `_with_live_accel` refits the k = 32 grid the same way."""
    ref, port = sphere20
    moved = (np.asarray(ref.geometry.positions)
             * np.float32([1.5, 1.0, 0.5]) + np.float32([0.25, -1.0, 2.0]))
    want = jclusters.refit_clusters(ref.clusters, ref.geometry.replace(
        positions=jnp.asarray(moved)))
    geom = dataclasses.replace(port.geometry, positions=torch.from_numpy(
        moved).requires_grad_(True))
    got = clusters.refit_clusters(port.clusters, geom)
    for f in ("aabb_min", "aabb_max", "parent_min", "parent_max"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    assert np.asarray(want.soup).shape[1:] == (16, 128)
    np.testing.assert_array_equal(np_(got.soup),
                                  np_(clusters.unpack_soup32(want.soup)))
    assert got.k == 32 and not got.soup.requires_grad
    live = pinv._with_live_accel(
        dataclasses.replace(port, geometry=geom),
        params_to_port({"vertex_positions": np_(geom.positions)}))
    for f in ("aabb_min", "aabb_max", "soup"):
        assert torch.equal(getattr(live.clusters, f), getattr(got, f))


def test_vertex_training_steps_on_a_k32_grid():
    """Three Adam steps on the vertices of a ramp quad through K1's route
    ("pallas", refit every step): the k = 32 grid (one sub-cluster) gives
    the k = 128 grid's losses and vertices, bit for bit."""
    from physically_based_renderer_tpu_torch.core import rng
    from physically_based_renderer_tpu_torch.core.camera import (
        camera_from_numpy)
    from physically_based_renderer_tpu.core.camera import Camera as JCamera
    from test_inverse import _ramp_quad_scene
    cam = camera_from_numpy(flat(JCamera.make(
        position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0), fov_y=1.0)))
    cfg = path.RenderConfig(width=16, height=16, spp=1, max_bounces=1,
                            tracer="pallas")
    base = types.scene_from_numpy(scene_arrays(_ramp_quad_scene(0.0)))
    target = path.render(types.with_clusters(types.scene_from_numpy(
        scene_arrays(_ramp_quad_scene(0.3)))), cam, rng.key(5),
        cfg).mean().detach()
    out = {}
    for k in (32, 128):
        scene = types.with_clusters(base, k=k)
        assert scene.clusters.k == k
        params = pinv.TrainableParams.from_scene(scene, vertices=True)
        params, losses = pinv.fit(scene, cam, target, params, cfg, steps=3,
                                  lr=2e-2, seed=3)
        out[k] = (losses, np_(params.vertex_positions))
    assert out[32][0] == out[128][0] and np.isfinite(out[32][0]).all()
    np.testing.assert_array_equal(out[32][1], out[128][1])


def test_render_k32_pallas_matches_reference():
    """helmet24 at k = 32 through tracer="pallas", 16x16 x 1 spp x 2
    bounces at the same key as the reference (its k32 K1 in interpret
    mode): pixels, mean and ray counts."""
    from physically_based_renderer_tpu.core.camera import Camera as JCamera
    from physically_based_renderer_tpu.integrator.path import (
        RenderConfig as JRenderConfig, render_with_stats as j_render)
    from physically_based_renderer_tpu_torch.core import rng
    from physically_based_renderer_tpu_torch.core.camera import (
        camera_from_numpy)

    ref = jtypes.with_clusters(jproc.make_helmet_class_scene(24, 24), k=32)
    jcam = JCamera.make(position=(0.0, 0.1, 3.0), target=(0.0, 0.0, 0.0),
                        fov_y=1.0)
    kw = dict(width=16, height=16, spp=1, max_bounces=2, tracer="pallas")
    jfilm, jcount = j_render(ref, jcam, jax.random.key(3),
                             JRenderConfig(**kw))
    port = _carried(ref)
    assert port.clusters.k == 32
    film, count = path.render_with_stats(port, camera_from_numpy(flat(jcam)),
                                         rng.key(3), path.RenderConfig(**kw))
    assert int(count) == int(jcount)
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))


def test_scene_spec_cluster_k_builds_a_k32_grid():
    """SceneSpec.cluster_k reaches with_clusters, as the reference's does,
    for a named builder and for a .glb by path."""
    spec = jconfig.SceneSpec(builder="helmet", cluster_k=32,
                             extra={"rings": 16, "sectors": 16})
    ref, _ = jconfig.build_scene(spec)
    port, _ = config.build_scene(config.SceneSpec(
        builder="helmet", cluster_k=32, extra={"rings": 16, "sectors": 16}))
    assert port.clusters.k == 32
    _assert_grid(port.clusters, ref.clusters)
    np.testing.assert_array_equal(np_(port.clusters.soup),
                                  np_(clusters.unpack_soup32(
                                      ref.clusters.soup)))
    default, _ = config.build_scene(config.SceneSpec(builder="triangle"))
    assert default.clusters.k == clusters.CLUSTER_K
    assert config.SceneSpec(builder="cornell").cluster_k is None


def test_gltf_spec_cluster_k(tmp_path):
    """The "gltf" builder (a .glb by path) takes cluster_k too."""
    from physically_based_renderer_tpu_torch.scene import helmet_asset
    from physically_based_renderer_tpu_torch.scene.export import export_glb
    file = tmp_path / "helmet.glb"
    export_glb(file, *helmet_asset.build_helmet_graph(0.02))
    scene, _ = config.build_scene(config.SceneSpec(
        builder="gltf", cluster_k=32, extra={"path": str(file)}))
    grid = scene.clusters
    assert grid.k == 32
    assert grid.soup.shape == (grid.num_clusters + 1, 9, 32)
    assert bool((grid.tri_id >= 0).sum() == scene.geometry.num_tris)


def test_report_reads_k32():
    """apps/report.py's clusters entry of a k = 32 scene, as the
    reference's report gives it."""
    port = types.with_clusters(procedural.make_helmet_class_scene(16, 16),
                               k=32)
    ref = jtypes.with_clusters(jproc.make_helmet_class_scene(16, 16), k=32)
    got = report._scene_stats(port)["clusters"]
    assert got == jreport._scene_stats(ref)["clusters"]
    assert got["k"] == 32


def test_k64_is_refused_as_by_the_reference():
    """k = 64 is neither 32 nor a multiple of 128: the port refuses it when
    it packs the soup and in the tracer, with the reference's wording; the
    reference's tracer refuses it off interpret mode."""
    scene = procedural.make_helmet_class_scene(8, 8)
    with pytest.raises(ValueError, match="k == 32"):
        types.with_clusters(scene, k=64)
    g = scene.geometry
    grid = clusters.build_clusters(g.positions.numpy(), g.indices.numpy(),
                                   k=64)
    o, d = (torch.from_numpy(x) for x in _rays(32, 5))
    with pytest.raises(ValueError, match="got k=64"):
        bt.intersect_blocks_pallas(grid, o, d, geometry=g)
    with pytest.raises(ValueError, match="got k=64"):
        bt.pack_soup(grid, g)
    ref = jproc.make_helmet_class_scene(8, 8)
    ref_grid = jclusters.build_clusters(np.asarray(ref.geometry.positions),
                                        np.asarray(ref.geometry.indices),
                                        k=64)
    with pytest.raises(ValueError, match="got k=64"):
        jbt.intersect_blocks_pallas(ref_grid, ref.geometry, jnp.asarray(o),
                                    jnp.asarray(d))
