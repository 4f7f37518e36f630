"""The port's block tracer: phase A (ops/blocktrace.py) and K1's plain
version (ops/trace_blocks.py) against the reference's functions, and the
whole tracer against the reference's and against brute force.

Phase A and the candidate lists are exact.  K1's winners and any-hit masks
are exact; its hit distances agree to T_RTOL, because XLA's CPU compiler
contracts multiply-adds into FMAs inside the reference's jitted kernel
(measured here: up to 13 ulps, 1.4e-6 relative), while the plain version
rounds every product and sum, as the CUDA kernel does (-fmad=false)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.accel import clusters as jclusters
from physically_based_renderer_tpu.ops import blocktrace as jbt
from physically_based_renderer_tpu.ops.pallas_trace import (
    trace_blocks_pallas as j_trace_blocks)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import blocktrace as bt
from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
from physically_based_renderer_tpu_torch.ops.intersect import (
    BIG, intersect_brute, occluded_brute)
from physically_based_renderer_tpu_torch.scene import types
from torch_parity import flat, scene_arrays

torch.set_num_threads(1)
T_RTOL = 1e-5


def _scene(rings):
    """(reference scene on device arrays, port scene) of a UV sphere with
    clusters: rings = 48 gives 64 clusters, rings = 20 gives 7."""
    ref = jtypes.upload_scene(jtypes.with_clusters(jtypes.make_scene(
        jproc.make_uv_sphere(rings=rings, sectors=rings),
        jtypes.Materials.default(1))))
    arrays = scene_arrays(ref)
    arrays["clusters"] = flat(ref.clusters)
    return ref, types.scene_from_numpy(arrays)


@pytest.fixture(scope="module")
def sphere48():
    return _scene(48)


def _rays(n, seed, inside_frac=0.25):
    """Rays from a box around the unit sphere, a share of them starting
    inside cluster boxes (entry ties at 0), unit directions, and random
    per-ray t_max."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    inner = rng.random(n) < inside_frac
    o[inner] *= np.float32(0.6)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = rng.uniform(0.05, 3.0, n).astype(np.float32)
    return o, d, tm


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def test_root_cull_matches_reference(sphere48):
    ref, port = sphere48
    o, d, tm = _rays(3000, 0)
    for t_max in (tm, np.full_like(tm, BIG)):
        for t_min in (0.0, 1e-3):
            # op by op (outside jit), as the function is written
            want = jbt._root_cull(ref.clusters, jnp.asarray(o),
                                  jnp.asarray(d), t_min, jnp.asarray(t_max))
            got = bt._root_cull(port.clusters, *_t(o, d), t_min,
                                torch.from_numpy(t_max))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert 0 < int((got == 0).sum()) < len(o)


def test_dir_bin_and_octant_perm_match_reference():
    o, d, tm = _rays(5000, 1)
    d[:7] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1, 0], [-1, -1, -1],
             [0, 1, 1], [0, 0, 0]]            # axis ties and a zero vector
    tm[::5] = 0.0                             # dead lanes sort last
    np.testing.assert_array_equal(bt.dir_bin(torch.from_numpy(d)).numpy(),
                                  np.asarray(jbt.dir_bin(jnp.asarray(d))))
    got = bt._octant_perm(*_t(d, tm))
    want = jbt._octant_perm(jnp.asarray(d), jnp.asarray(tm))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = np.asarray(jbt.dir_bin(jnp.asarray(d)))
    key = np.where(tm > 0, key, 24)
    np.testing.assert_array_equal(
        bt.bucket_sort_perm(torch.from_numpy(key)).numpy(),
        np.asarray(jbt.bucket_sort_perm(jnp.asarray(key), 25)))


def test_interval_slab_matches_reference(sphere48):
    ref, port = sphere48
    rng = np.random.default_rng(2)
    nb = 40
    o_lo = rng.uniform(-2, 1, (nb, 3)).astype(np.float32)
    o_hi = o_lo + rng.uniform(0, 0.5, (nb, 3)).astype(np.float32)
    iv_lo = rng.uniform(-20, 20, (nb, 3)).astype(np.float32)
    iv_hi = iv_lo + rng.uniform(0, 5, (nb, 3)).astype(np.float32)
    tm_hi = rng.uniform(0, 4, nb).astype(np.float32)
    args = (o_lo, o_hi, iv_lo, iv_hi)
    for t_min in (0.0, 1e-3):
        want = jbt._interval_slab(ref.clusters.aabb_min,
                                  ref.clusters.aabb_max,
                                  *map(jnp.asarray, args), t_min,
                                  jnp.asarray(tm_hi))
        got = bt._interval_slab(port.clusters.aabb_min,
                                port.clusters.aabb_max, *_t(*args), t_min,
                                torch.from_numpy(tm_hi))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        boxes = rng.normal(size=(nb, 9, 3)).astype(np.float32)
        want = jbt._interval_slab_local(
            jnp.asarray(boxes), jnp.asarray(boxes + 0.3),
            *map(jnp.asarray, args), t_min, jnp.asarray(tm_hi))
        got = bt._interval_slab_local(*_t(boxes, boxes + 0.3), *_t(*args),
                                      t_min, torch.from_numpy(tm_hi))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _phase_a(port, o, d, tm, block, t_min, max_u):
    """Root cull + pad + port phase A, as intersect_blocks_pallas does."""
    o_t, d_t = _t(o, d)
    tm_c = bt._root_cull(port.clusters, o_t, d_t, t_min,
                         torch.from_numpy(tm))
    nb = len(o) // block
    return tm_c, bt._select_candidates(port.clusters, o_t, d_t, tm_c, nb,
                                       block, t_min, max_u)


@pytest.mark.parametrize("max_u", [8, 48])
def test_select_candidates_matches_reference(sphere48, max_u):
    """max_u = 8 on 64 clusters takes the hierarchical parent->child branch
    (C > 4 max_u); max_u = 48 the flat one."""
    ref, port = sphere48
    o, d, tm = _rays(256 * 12, 3, inside_frac=0.5)
    for t_min in (0.0, 1e-3):
        tm_c, got = _phase_a(port, o, d, tm, 256, t_min, max_u)
        want = jbt._select_candidates(
            ref.clusters, jnp.asarray(o), jnp.asarray(d),
            jnp.asarray(tm_c.numpy()), 12, 256, t_min, max_u)
        for name, a, b in zip(("u_idx", "u_entry", "n_valid", "ob", "db",
                               "tmb"), got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
        u_idx, u_entry, n_valid = got[:3]
        assert u_idx.dtype == torch.int32 and n_valid.dtype == torch.int32
        assert u_idx.shape[1] == max_u
        # entry ties at 0 occur, and some block's demand fills the list
        assert int((u_entry == 0).sum()) > 12
        assert int((n_valid == max_u).sum()) > 0


def _k1_inputs(port, max_u, t_min, seed, random_tmax):
    o, d, tm = _rays(256 * 8, seed, inside_frac=0.4)
    if not random_tmax:
        tm = np.full_like(tm, BIG)
    _, (u_idx, u_entry, n_valid, ob, db, tmb) = _phase_a(
        port, o, d, tm, 256, t_min, max_u)
    return u_idx, ob, db, tmb, n_valid, u_entry


def _pad_chunks(u_idx, u_entry, chunk, sentinel):
    n_u = u_idx.shape[1]
    extra = -(-n_u // chunk) * chunk - n_u
    return (torch.cat([u_idx, u_idx.new_full((len(u_idx), extra), sentinel)],
                      1),
            torch.cat([u_entry, u_entry.new_full((len(u_idx), extra), BIG)],
                      1))


def _reference_k1(ref, u_idx, ob, db, tmb, n_valid, u_entry, t_min,
                  any_hit):
    return j_trace_blocks(
        jnp.asarray(u_idx.numpy()), jnp.asarray(np.moveaxis(ob.numpy(), -1, 0)),
        jnp.asarray(np.moveaxis(db.numpy(), -1, 0)), jnp.asarray(tmb.numpy()),
        jnp.asarray(ref.clusters.soup), None, t_min=t_min, any_hit=any_hit,
        interpret=True, n_valid=jnp.asarray(n_valid.numpy()),
        entry=jnp.asarray(u_entry.numpy()), chunk=4)


@pytest.mark.parametrize("max_u", [6, 48])
@pytest.mark.parametrize("random_tmax", [False, True])
@pytest.mark.parametrize("t_min", [0.0, 1e-3])
def test_trace_blocks_plain_matches_reference_kernel(sphere48, max_u,
                                                     random_tmax, t_min):
    """Closest and any hit on the same candidate lists.  max_u = 6 pads the
    list to 8 with the sentinel (a partial final chunk) and truncates
    blocks whose demand exceeds it."""
    ref, port = sphere48
    u_idx, ob, db, tmb, n_valid, u_entry = _k1_inputs(
        port, max_u, t_min, 4, random_tmax)
    u_idx, u_entry = _pad_chunks(u_idx, u_entry, 4,
                                 port.clusters.num_clusters)
    if max_u == 6:
        assert bool((n_valid % 4 != 0).any()) and bool((n_valid == 6).any())
    args = (u_idx.contiguous(), ob.contiguous(), db.contiguous(),
            tmb.contiguous(), port.clusters.soup, n_valid,
            u_entry.contiguous())
    best_t, best_flat = tb.trace_blocks_plain(*args, t_min=t_min,
                                              any_hit=False)
    want_t, want_flat = _reference_k1(ref, *args[:4], n_valid, args[6],
                                      t_min, False)
    np.testing.assert_array_equal(best_flat.numpy(), np.asarray(want_flat))
    np.testing.assert_allclose(best_t.numpy(), np.asarray(want_t),
                               rtol=T_RTOL)
    assert best_flat.dtype == torch.int32
    assert 0 < int((best_flat >= 0).sum()) < best_flat.numel()
    occ = tb.trace_blocks_plain(*args, t_min=t_min, any_hit=True)
    _, want_occ = _reference_k1(ref, *args[:4], n_valid, args[6], t_min,
                                True)
    assert occ.dtype == torch.bool
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ) > 0)


def test_trace_blocks_early_exit_does_not_change_winners(sphere48,
                                                         monkeypatch):
    """Blocks stop at chunk boundaries; with every entry at 0 no block can
    stop early (no live lane's best is <= 0), and the winners are the same;
    grouping blocks differently changes nothing either."""
    _, port = sphere48
    u_idx, ob, db, tmb, n_valid, u_entry = _k1_inputs(port, 48, 1e-3, 5,
                                                      False)
    args = [u_idx, ob.contiguous(), db.contiguous(), tmb.contiguous(),
            port.clusters.soup, n_valid, u_entry.contiguous()]
    t0, f0 = tb.trace_blocks_plain(*args, t_min=1e-3, any_hit=False)
    args[6] = torch.zeros_like(u_entry)
    t1, f1 = tb.trace_blocks_plain(*args, t_min=1e-3, any_hit=False)
    monkeypatch.setattr(tb, "_PLAIN_CHUNK", 3 * 256 * 512)
    t2, f2 = tb.trace_blocks_plain(*args, t_min=1e-3, any_hit=False)
    for t, f in ((t1, f1), (t2, f2)):
        np.testing.assert_array_equal(f.numpy(), f0.numpy())
        np.testing.assert_array_equal(t.numpy(), t0.numpy())


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("max_u", [8, 48])
def test_intersect_blocks_matches_reference_and_brute(sphere48, sort, max_u):
    ref, port = sphere48
    o, d, tm = _rays(600, 6, inside_frac=0.3)         # ragged: 3 blocks
    o_t, d_t, tm_t = _t(o, d, tm)
    t_min = 1e-3          # t_min = 0 is covered at the kernel level
    want = jbt.intersect_blocks_pallas(
        ref.clusters, ref.geometry, jnp.asarray(o), jnp.asarray(d),
        t_min=t_min, block=256, max_u=max_u, interpret=True, lean=True,
        sort=sort)
    hit = bt.intersect_blocks_pallas(port.clusters, o_t, d_t,
                                     t_min=t_min, block=256,
                                     max_u=max_u, sort=sort)
    np.testing.assert_array_equal(hit.tri.numpy(), np.asarray(want.tri))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(want.t),
                               rtol=T_RTOL)
    np.testing.assert_array_equal(hit.u.numpy(), 0.0)
    occ = bt.intersect_blocks_pallas(port.clusters, o_t, d_t,
                                     t_min=t_min, t_max=tm_t,
                                     any_hit=True, block=256,
                                     max_u=max_u, sort=sort)
    want_occ = jbt.intersect_blocks_pallas(
        ref.clusters, ref.geometry, jnp.asarray(o), jnp.asarray(d),
        t_min=t_min, t_max=jnp.asarray(tm), any_hit=True, block=256,
        max_u=max_u, interpret=True, sort=sort)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want_occ))
    # Brute force as the oracle, where no candidate is dropped: random
    # rays make incoherent blocks whose demand exceeds max_u (the
    # reference's tracer drops the farthest candidates alike), so the
    # oracle run keeps every cluster.
    every = port.clusters.num_clusters
    hit = bt.intersect_blocks_pallas(port.clusters, o_t, d_t,
                                     t_min=t_min, max_u=every, sort=sort)
    occ = bt.intersect_blocks_pallas(port.clusters, o_t, d_t,
                                     t_min=t_min, t_max=tm_t,
                                     any_hit=True, max_u=every,
                                     sort=sort)
    v = port.geometry.tri_vertices()
    brute = intersect_brute(o_t, d_t, *v, t_min=t_min)
    np.testing.assert_array_equal(hit.miss.numpy(), brute.miss.numpy())
    np.testing.assert_allclose(hit.t.numpy(), brute.t.numpy(),
                               rtol=T_RTOL)
    np.testing.assert_array_equal(
        occ.numpy(), occluded_brute(o_t, d_t, *v, t_min=t_min,
                                    t_max=tm_t).numpy())


def test_wrapper_checks_and_cpu_dispatch(sphere48):
    _, port = sphere48
    u_idx, ob, db, tmb, n_valid, u_entry = _k1_inputs(port, 8, 0.0, 7, True)
    args = [u_idx, ob.contiguous(), db.contiguous(), tmb.contiguous(),
            port.clusters.soup, n_valid, u_entry.contiguous()]
    before = tb.LAUNCHES
    tb.trace_blocks(*args, t_min=0.0, any_hit=False)
    assert tb.LAUNCHES == before          # CPU tensors: plain version
    bad = [(0, u_idx.long(), TypeError), (1, ob.double(), TypeError),
           (3, tmb[:, :5].contiguous(), ValueError),
           (6, u_entry[:, :3].contiguous(), ValueError)]
    for i, x, err in bad:
        with pytest.raises(err):
            tb.trace_blocks(*args[:i], x, *args[i + 1:], t_min=0.0,
                            any_hit=False)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tb.trace_blocks(*args, t_min=0.0, any_hit=False, chunk=3)
    with pytest.raises(ValueError, match="t_min"):
        tb.trace_blocks(*args, t_min=-1.0, any_hit=False)
    with pytest.raises(ValueError):
        tb.trace_blocks(*[a.to("meta") for a in args], t_min=0.0,
                        any_hit=False)


def test_auto_tracer_picks_the_block_tracer():
    _, port = _scene(20)                     # 800 triangles, clusters
    assert port.geometry.num_tris > 512
    assert path._auto_tracer(port) == "pallas"
    no_grid = types.scene_from_numpy(scene_arrays(jtypes.make_scene(
        jproc.make_uv_sphere(rings=20, sectors=20),
        jtypes.Materials.default(1))))
    assert path._auto_tracer(no_grid) == "brute"
    assert path._auto_tracer(types.with_bvh(no_grid)) == "bvh"
    with pytest.raises(ValueError, match="cluster grid"):
        path.closest_hit(no_grid, torch.zeros(1, 3), torch.ones(1, 3), 0.0,
                         path.RenderConfig(tracer="pallas"))
    assert jax.default_backend() == "cpu"



# The block tracer's knobs (RenderConfig chunk, block_size, max_u) against
# the reference's tracer (K1 in interpret mode) and, where every candidate
# is kept, brute force.  chunk = 16 stages 72 KB a step on the card, the
# shared-memory opt-in of csrc/trace_blocks.cu (tests/test_torch_cuda.py).
# block 32, 96 and 1024 run one, one and two rays a thread in the kernel
# (two where B % 64 == 0), chunk 1 one cluster a buffer.
KNOBS = {"chunk2": dict(chunk=2), "chunk8": dict(chunk=8),
         "chunk16": dict(chunk=16), "block128": dict(block=128),
         "max_u16": dict(max_u=16), "chunk1": dict(chunk=1),
         "block32": dict(block=32), "block96": dict(block=96),
         "block1024": dict(block=1024)}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_intersect_blocks_knobs_match_reference(sphere48, knob):
    ref, port = sphere48
    o, d, tm = _rays(600, 8, inside_frac=0.3)
    o_t, d_t, tm_t = _t(o, d, tm)
    kw = dict(dict(block=256, max_u=48, chunk=4), **KNOBS[knob])
    for any_hit in (False, True):
        want = jbt.intersect_blocks_pallas(
            ref.clusters, ref.geometry, jnp.asarray(o), jnp.asarray(d),
            t_min=1e-3, t_max=jnp.asarray(tm), any_hit=any_hit,
            interpret=True, lean=True, sort=True, **kw)
        got = bt.intersect_blocks_pallas(port.clusters, o_t, d_t,
                                         t_min=1e-3, t_max=tm_t,
                                         any_hit=any_hit, sort=True, **kw)
        if any_hit:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert 0 < int(got.sum()) < got.numel()
            continue
        np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
        np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                                   rtol=T_RTOL)


@pytest.mark.parametrize("resort", [False, True])
def test_resort_reaches_the_tracer(sphere48, monkeypatch, resort):
    """RenderConfig.resort sets the in-tracer sort of the bounce and the
    shadow calls (the sort itself against the reference:
    test_intersect_blocks_matches_reference_and_brute); camera rays stay
    in morton order."""
    from physically_based_renderer_tpu_torch.core import rng
    from physically_based_renderer_tpu_torch.core.camera import Camera
    _, port = sphere48
    seen = []
    real = path.intersect_blocks_pallas

    def spy(*a, **kw):
        seen.append((kw.get("any_hit", False), kw["sort"]))
        return real(*a, **kw)

    monkeypatch.setattr(path, "intersect_blocks_pallas", spy)
    env = types.scene_from_numpy(scene_arrays(jtypes.make_scene(
        jproc.make_uv_sphere(rings=48, sectors=48),
        jtypes.Materials.default(1),
        env=jtypes.build_env_tables(np.ones((8, 16, 3), np.float32)))))
    scene = dataclasses.replace(env, clusters=port.clusters)
    cam = Camera.make(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0),
                      fov_y=1.0)
    cfg = path.RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                            resort=resort)
    path.render_with_stats(scene, cam, rng.key(0), cfg)
    assert seen == [(False, False), (True, resort), (False, resort),
                    (True, resort), (False, resort)]


@pytest.mark.parametrize("tracer", ["pallas", "block"])
def test_grid_without_packed_soup_renders_as_the_reference(tracer,
                                                           monkeypatch):
    """A cluster grid from build_clusters alone (no pack_soup_host): the
    reference packs the soup inside its trace, so does the port (pack_soup,
    on K1's route), instead of refusing the grid.  helmet24 (1,152
    triangles) at 16x16 x 1 spp x 2 bounces against the reference at the
    same key (its K1 in interpret mode; tracer "block" needs no soup):
    every pixel within ATOL + RTOL |ref| of PIXEL_FRAC, equal ray counts,
    and equal to the packed grid's render bit for bit."""
    from physically_based_renderer_tpu.core.camera import Camera as JCamera
    from physically_based_renderer_tpu.integrator.path import (
        RenderConfig as JRenderConfig, render_with_stats as j_render)
    from physically_based_renderer_tpu_torch.accel.clusters import (
        build_clusters)
    from physically_based_renderer_tpu_torch.core import rng
    from physically_based_renderer_tpu_torch.core.camera import (
        camera_from_numpy)
    from torch_parity import assert_render_agrees

    base = jproc.make_helmet_class_scene(24, 24)
    g = base.geometry
    ref = base.replace(clusters=jclusters.build_clusters(
        np.asarray(g.positions), np.asarray(g.indices)))
    assert ref.clusters.soup is None
    jcam = JCamera.make(position=(0.0, 0.1, 3.0), target=(0.0, 0.0, 0.0),
                        fov_y=1.0)
    kw = dict(width=16, height=16, spp=1, max_bounces=2, tracer=tracer)
    jfilm, jcount = j_render(ref, jcam, jax.random.key(3),
                             JRenderConfig(**kw))

    port = types.scene_from_numpy(scene_arrays(base))
    grid = build_clusters(port.geometry.positions.numpy(),
                          port.geometry.indices.numpy())
    packs = []
    real = bt.pack_soup
    monkeypatch.setattr(bt, "pack_soup", lambda *a: packs.append(1)
                        or real(*a))
    cam = camera_from_numpy(flat(jcam))
    cfg = path.RenderConfig(**kw)
    film, count = path.render_with_stats(
        dataclasses.replace(port, clusters=grid), cam, rng.key(3), cfg)
    # K1's route packs the soup once a frame (make_tracer), not once for
    # each of its 3 closest-hit and 2 env shadow calls.
    assert len(packs) == (1 if tracer == "pallas" else 0)
    assert int(count) == int(jcount)
    assert_render_agrees(film.mean().numpy(), np.asarray(jfilm.mean()),
                         int(count), float(jcount))
    packed, _ = path.render_with_stats(types.with_clusters(port), cam,
                                       rng.key(3), cfg)
    assert torch.equal(film.hdr, packed.hdr)


def test_block_inputs_without_soup_or_geometry_refuses():
    grid = types.with_clusters(types.scene_from_numpy(scene_arrays(
        jproc.make_helmet_class_scene(8, 8)))).clusters
    grid = dataclasses.replace(grid, soup=None)
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3)
    with pytest.raises(ValueError, match="no packed soup"):
        bt.block_inputs(grid, o, d, 1e-4)
