"""Tile and spp sharding, the ring ray exchange and the sharded train step
of the port (parallel/, grad/inverse.py) on gloo worlds of 2 and 4 ranks.

One `torch.multiprocessing.spawn` per world size runs every case of that
world (tests/torch_dist_worker.py, which imports neither JAX nor the
reference); rank 0 writes the results, which the parametrised tests read.
The oracles are the reference's own: tests/test_sharding.py,
tests/test_distributed.py, test_inverse.py's SPMD step,
test_edge_grad.py's SPMD edge step and test_apps.py's sharded inverse CLI.
The reference's renders and steps run meanwhile in this process, over the
conftest's virtual CPU devices.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import torch_dist_worker as worker
from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.grad.edge import build_edge_table
from physically_based_renderer_tpu.grad.inverse import (
    TrainableParams as JParams, make_train_step as j_make_train_step)
from physically_based_renderer_tpu.integrator.path import \
    RenderConfig as JRenderConfig
from physically_based_renderer_tpu.parallel.sharding import (
    make_mesh as j_make_mesh, render_sharded as j_render_sharded,
    replicate_scene as j_replicate_scene)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.parallel import distributed
from physically_based_renderer_tpu_torch.scene.types import scene_from_numpy
from test_edge_grad import OCC_VTX, _scene as edge_scene
from torch_parity import flat, render_agreement, scene_arrays

torch.set_num_threads(1)

WORLDS = {2: ("render", "ring", "render_2d", "errors", "spmd",
              "spmd_edges", "clis", "dryrun"),
          4: ("render", "ring", "render_2d", "errors", "spmd", "clis",
              "dryrun")}
JOIN_SECONDS = 240
CORNELL_CAM = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                   fov_y=0.95)
EDGE_CAM = dict(position=(0.0, 0.0, 3.0), target=(0.0, 0.0, 0.0), fov_y=1.0)


def _join(ctx):
    """Wait for every rank; a rank that raises ends the others (spawn's
    own rule) and re-raises here; past JOIN_SECONDS every rank is killed."""
    deadline = time.monotonic() + JOIN_SECONDS
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after {JOIN_SECONDS} s")


def _reference(cornell, edge, spmd_target, edge_target):
    """The reference's sharded render, SPMD step and SPMD edge step over
    two virtual devices, at the workers' shapes and keys."""
    mesh = j_make_mesh(jax.devices()[:2])
    cam = JCamera.make(**CORNELL_CAM)
    out = {"render": np.asarray(j_render_sharded(
        j_replicate_scene(cornell, mesh), cam, jax.random.key(3),
        JRenderConfig(**worker.RENDER), mesh).mean())}

    params = JParams.from_scene(cornell, base_color=True)
    opt = optax.sgd(1e-2)
    step = j_make_train_step(cornell, cam, JRenderConfig(**worker.SPMD), opt,
                             mesh=mesh)
    p, _, loss = step(params, opt.init(params), jax.random.key(42),
                      jnp.asarray(spmd_target))
    out["spmd_base_color"] = np.asarray(p.base_color_factor)
    out["spmd_loss"] = float(loss)

    edge = edge.replace(geometry=edge.geometry.replace(
        positions=jnp.asarray(edge.geometry.positions)))
    params = JParams(vertex_positions=edge.geometry.positions)
    opt = optax.sgd(1.0)
    step = j_make_train_step(
        j_replicate_scene(edge, mesh), JCamera.make(**EDGE_CAM),
        JRenderConfig(**worker.EDGE), opt, mesh=mesh,
        edges=build_edge_table(edge.geometry.indices),
        edge_samples=worker.EDGE_SAMPLES)
    p, _, loss = step(params, opt.init(params), jax.random.key(3),
                      jnp.asarray(edge_target))
    out["edge_delta"] = (np.asarray(p.vertex_positions)
                         - np.asarray(edge.geometry.positions))
    out["edge_loss"] = float(loss)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({world size: the worker's results}, the reference's results)."""
    cornell, edge = jproc.make_cornell_box(), edge_scene()
    scenes = {"cornell": scene_arrays(cornell), "edge": scene_arrays(edge)}
    cameras = {"cornell": flat(JCamera.make(**CORNELL_CAM)),
               "edge": flat(JCamera.make(**EDGE_CAM))}
    # Targets from the port, handed to both packages.
    cam = camera_from_numpy(cameras["cornell"])
    spmd_target = path.render_image(scene_from_numpy(scenes["cornell"]), cam,
                                    11, path.RenderConfig(**worker.SPMD))
    moved = dict(scenes["edge"])
    moved["geometry"] = dict(moved["geometry"])
    pos = moved["geometry"]["positions"].copy()
    pos[OCC_VTX, 0] += 0.25
    moved["geometry"]["positions"] = pos
    edge_target = path.render(
        scene_from_numpy(moved), camera_from_numpy(cameras["edge"]),
        rng.key(9), path.RenderConfig(**worker.EDGE)).mean()
    common = dict(scenes=scenes, cameras=cameras,
                  spmd_target=spmd_target.numpy(),
                  edge_target=edge_target.numpy())

    ctxs = {}
    for world, cases in WORLDS.items():
        d = tmp_path_factory.mktemp(f"world{world}")
        spec = dict(common, cases=cases, out_dir=str(d))
        ctxs[world] = (d, mp.spawn(worker.run,
                                   args=(world, str(d / "rendezvous"), spec),
                                   nprocs=world, join=False))
    ref = _reference(cornell, edge, common["spmd_target"],
                     common["edge_target"])
    out = {}
    for world, (d, ctx) in ctxs.items():
        _join(ctx)
        with np.load(d / f"world{world}.npz") as z:
            out[world] = dict(z)
    return out, ref


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("route", ["render", "render_pallas"])
def test_sharded_render_matches_single_device(runs, world, route):
    """test_sharding.py:38-47 (atol 1e-6 there): per-ray keys go by global
    pixel id, so the port's 1-D sharded render is the single render bit for
    bit, on the resident and the block-tracer route, ray count included."""
    res = runs[0][world]
    np.testing.assert_array_equal(res[f"{route}_sharded"],
                                  res[f"{route}_single"])
    assert res[f"{route}_count"] == res[f"{route}_single_count"] > 0


def test_sharded_render_matches_reference_sharded(runs):
    """The 2-rank render against the reference's render_sharded over two
    virtual devices, within the render tolerance of test_torch_render.py."""
    frac, _ = render_agreement(runs[0][2]["render_sharded"], runs[1]["render"])
    assert frac == 1.0


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sharded_2d_matches_single_device(runs, world):
    """test_sharding.py:70-78 and test_distributed.py:84-119: the (n/2 x 2)
    mesh and the (hosts, devices) mesh against render(), the spp sum's
    order being the only difference."""
    res = runs[0][world]
    np.testing.assert_allclose(res["render_2d"], res["render_2d_single"],
                               atol=1e-5, rtol=0)
    assert tuple(res["hosts_chips_shape"]) == (1, world)
    np.testing.assert_allclose(res["hosts_chips"], res["hosts_chips_single"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_ring_exchange_matches_no_exchange(runs, world):
    """test_sharding.py:117-142: the ring is invisible in the result
    (atol 1e-5 there)."""
    res = runs[0][world]
    plain, ring = res["ring_False"], res["ring_True"]
    assert np.isfinite(ring).all() and plain.mean() > 0
    diff = float(np.abs(ring - plain).max())
    print(f"ring against no ring on {world} ranks: max |diff| {diff}")
    np.testing.assert_allclose(ring, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("case,match", [
    ("err_height", "divide"), ("err_too_few", "devices"),
    ("err_tiles", "devices"), ("err_spp", "spp"), ("err_step", "divide")])
def test_shapes_that_do_not_fit_raise(runs, world, case, match):
    """test_sharding.py:58-91: ValueError on every rank before any
    collective (the worker would hang otherwise)."""
    assert match in str(runs[0][world][case])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_spmd_step_matches_single_device(runs, world):
    """test_inverse.py:154-188 with the reference's tolerances (band losses
    and their all-reduce sum in another order than the global mean), and
    the update's scale to 3%: an n-fold gradient would fail it."""
    res = runs[0][world]
    np.testing.assert_allclose(res["spmd_loss"], res["single_loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(res["spmd_base_color"],
                               res["single_base_color"], atol=5e-4,
                               rtol=1e-3)
    base = jproc.make_cornell_box().materials.base_color_factor
    d1 = res["single_base_color"] - np.asarray(base)
    dn = res["spmd_base_color"] - np.asarray(base)
    assert np.linalg.norm(d1) > 0.0
    np.testing.assert_allclose(np.linalg.norm(dn), np.linalg.norm(d1),
                               rtol=0.03)


def test_spmd_step_matches_reference_spmd(runs):
    """The 2-rank step against the reference's shard_map step over two
    virtual devices: the same keys, the same bands."""
    res, ref = runs[0][2], runs[1]
    np.testing.assert_allclose(res["spmd_loss"], ref["spmd_loss"], rtol=1e-5)
    np.testing.assert_allclose(res["spmd_base_color"], ref["spmd_base_color"],
                               rtol=0, atol=1e-6)


def test_spmd_edge_gradients_match_reference_spmd(runs):
    """test_edge_grad.py:123-160 allows rtol 0.35 between the sharded and
    the single-device step (their edge samples differ).  Here the port's
    2-rank step, keys folded with the rank as in the reference, against the
    reference's 2-device step: the same samples, so 1e-4 of max|delta|."""
    got, want = runs[0][2]["edge_delta"], runs[1]["edge_delta"]
    scale = float(np.abs(want).max())
    assert scale > 1e-5
    assert float(np.abs(want[4:8, 0]).sum()) > 1e-5   # the occluder moves
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(runs[0][2]["edge_loss"], runs[1]["edge_loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_inverse_sharded_with_checkpoint(runs, world):
    """test_apps.py:87-96: the inverse CLI with --tiles inside the world,
    checkpoints every 3 steps written by rank 0."""
    res = runs[0][world]
    assert res["cli_rc"][1] == 0
    assert res["ckpt_latest"] == 6


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_render_cli_tiles_equals_single_render(runs, world):
    res = runs[0][world]
    assert res["cli_rc"][0] == 0
    np.testing.assert_array_equal(res["cli_hdr"], res["cli_single"])


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_dryrun(runs, world):
    """__graft_entry__.py::dryrun_multichip's three paths on every rank."""
    loss, m2, m3 = runs[0][world]["dryrun"]
    assert np.isfinite(loss) and m2 > 0.0 and m3 > 0.0
    assert tuple(runs[0][world]["global_mesh"]) == (world, 1)


# --- parallel/distributed.py (tests/test_distributed.py) -------------------

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def test_is_multiprocess_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    assert not distributed.is_multiprocess_env()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not distributed.is_multiprocess_env()
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert distributed.is_multiprocess_env()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    assert distributed.is_multiprocess_env()


def test_ensure_initialized_single_process_noop(monkeypatch):
    """A single process must not initialize: it would wait for peers."""
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **kw: called.append((a, kw)))
    assert distributed.ensure_initialized() is False
    assert called == []


def test_ensure_initialized_forwards_explicit_args(monkeypatch):
    called = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *a, **kw: called.append((a, kw)))
    assert distributed.ensure_initialized(
        coordinator_address="10.0.0.1:8476", num_processes=2, process_id=0,
        backend="gloo") is True
    assert called == [(("gloo",), {"init_method": "tcp://10.0.0.1:8476",
                                   "world_size": 2, "rank": 0})]
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    assert distributed.ensure_initialized() is True
    assert len(called) == 1


def test_world_of_one_is_the_plain_path(tmp_path):
    """chip_smoke.py's check on one NCCL rank, here on one gloo rank in
    this process: the sharded render, the 1x1 2-D render and the ring
    render equal render() bit for bit, and the sharded step equals the
    plain step in loss and gradients (the CPU's scatter-adds are
    deterministic)."""
    import torch.distributed as dist

    from physically_based_renderer_tpu_torch.grad import inverse as pinv
    from physically_based_renderer_tpu_torch.parallel import sharding
    from physically_based_renderer_tpu_torch.scene.types import with_clusters
    scene = with_clusters(scene_from_numpy(scene_arrays(
        jproc.make_cornell_box())))
    cam = camera_from_numpy(flat(JCamera.make(**CORNELL_CAM)))
    cfg = path.RenderConfig(width=16, height=16, spp=2, max_bounces=2)
    key = rng.key(2)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1)
        scene = sharding.replicate_scene(scene, mesh)
        want = path.render(scene, cam, key, cfg).mean()
        assert torch.equal(sharding.render_sharded(scene, cam, key, cfg,
                                                   mesh).mean(), want)
        assert torch.equal(sharding.render_sharded_2d(
            scene, cam, key, cfg, sharding.make_mesh_2d(1, 1)).mean(), want)
        pcfg = path.RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                                 tracer="pallas")
        assert torch.equal(
            sharding.render_sample_sharded(scene, cam, key, pcfg, mesh,
                                           exchange=True),
            path.render_sample(scene, cam, key, pcfg))
        res = []
        for m in (mesh, None):
            params = pinv.trainable_copy(pinv.TrainableParams.from_scene(
                scene, base_color=True, emissive=True))
            opt = torch.optim.Adam(params.leaves(), lr=1e-2)
            step = pinv.make_train_step(scene, cam, cfg, opt, mesh=m)
            _, _, loss = step(params, None, key, want.detach())
            res.append([loss] + [v.grad for _, v in params.items()])
        assert all(torch.equal(a, b) for a, b in zip(*res))
    finally:
        dist.destroy_process_group()
