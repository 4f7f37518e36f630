"""Rank worker of tests/test_torch_sharding.py.

`run` is what `torch.multiprocessing.spawn` starts on each rank: it joins a
gloo world through a file, runs the named cases in order and, on rank 0,
writes what the tests read into `<out_dir>/world<n>.npz`.  It imports
neither JAX nor the reference package, so a rank starts in seconds; the
scenes arrive as the numpy mappings `scene_from_numpy` takes.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.grad import inverse as pinv
from physically_based_renderer_tpu_torch.grad.edge import build_edge_table
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.parallel import distributed, sharding
from physically_based_renderer_tpu_torch.scene.types import (scene_from_numpy,
                                                             with_clusters)

TIMEOUT = datetime.timedelta(seconds=120)

# RenderConfig fields of the cases.
RENDER = dict(width=16, height=32, spp=2, max_bounces=2)
RING = dict(width=16, height=32, spp=1, max_bounces=2, tracer="pallas")
RENDER_2D = dict(width=16, height=32, spp=4, max_bounces=2)
SPMD = dict(width=16, height=16, spp=2, max_bounces=1)
EDGE = dict(width=16, height=16, spp=4, max_bounces=0, tracer="brute")
EDGE_SAMPLES = 256


def np_(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _scene(spec, name, clusters=False):
    scene = scene_from_numpy(spec["scenes"][name])
    return with_clusters(scene) if clusters else scene


def _camera(spec, name):
    return camera_from_numpy(spec["cameras"][name])


def _value_error(fn) -> str:
    """The message of the ValueError fn raises (every rank raises it before
    any collective); '' when it raises none."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def case_render(spec, out, n):
    """1-D sharded renders on the resident and the block ('pallas') route
    against the unsharded render, and the summed ray count."""
    cam = _camera(spec, "cornell")
    mesh = sharding.make_mesh()
    for tag, clusters, tracer in (("render", False, "auto"),
                                  ("render_pallas", True, "pallas")):
        scene = sharding.replicate_scene(_scene(spec, "cornell", clusters),
                                         mesh)
        cfg = path.RenderConfig(**RENDER, tracer=tracer)
        film, count = sharding.render_sharded_with_stats(
            scene, cam, rng.key(3), cfg, mesh)
        out[f"{tag}_sharded"] = np_(film.mean())
        out[f"{tag}_count"] = np.int64(int(count))
        if dist.get_rank() == 0:
            single, c1 = path.render_with_stats(scene, cam, rng.key(3), cfg)
            out[f"{tag}_single"] = np_(single.mean())
            out[f"{tag}_single_count"] = np.int64(int(c1))


def case_ring(spec, out, n):
    """render_sample_sharded with and without the ring ray exchange."""
    mesh = sharding.make_mesh()
    scene = sharding.replicate_scene(_scene(spec, "cornell", True), mesh)
    cam = _camera(spec, "cornell")
    cfg = path.RenderConfig(**RING)
    for exchange in (False, True):
        img = sharding.render_sample_sharded(scene, cam, rng.key(11), cfg,
                                             mesh, exchange=exchange)
        out[f"ring_{exchange}"] = np_(img)


def case_render_2d(spec, out, n):
    """(n/2 tiles x 2 spp) and the (hosts, devices) mesh against render()."""
    scene = _scene(spec, "cornell")
    cam = _camera(spec, "cornell")
    cfg = path.RenderConfig(**RENDER_2D)
    mesh = sharding.make_mesh_2d(n // 2, 2)
    out["render_2d"] = np_(sharding.render_sharded_2d(
        scene, cam, rng.key(7), cfg, mesh).mean())
    hc = distributed.hosts_chips_mesh()
    out["hosts_chips_shape"] = np.array(hc.shape)
    cfg_hc = dataclasses.replace(cfg, spp=hc.shape[1], max_bounces=1)
    out["hosts_chips"] = np_(sharding.render_sharded_2d(
        scene, cam, rng.key(0), cfg_hc, hc).mean())
    if dist.get_rank() == 0:
        out["render_2d_single"] = np_(path.render(scene, cam, rng.key(7),
                                                  cfg).mean())
        out["hosts_chips_single"] = np_(path.render(scene, cam, rng.key(0),
                                                    cfg_hc).mean())


def case_errors(spec, out, n):
    """Shapes that do not fit raise ValueError on every rank."""
    scene = _scene(spec, "cornell")
    cam = _camera(spec, "cornell")
    mesh = sharding.make_mesh()
    bad_h = path.RenderConfig(width=16, height=4 * n + 1, spp=1,
                              max_bounces=1)
    out["err_height"] = np.array(_value_error(
        lambda: sharding.render_sharded(scene, cam, rng.key(0), bad_h,
                                        mesh)))
    out["err_too_few"] = np.array(_value_error(
        lambda: sharding.make_mesh_2d(4, 4)))
    out["err_tiles"] = np.array(_value_error(
        lambda: sharding.make_mesh(n + 1)))
    if n % 2 == 0:
        mesh2 = sharding.make_mesh_2d(n // 2, 2)
        bad_spp = path.RenderConfig(width=16, height=32, spp=3,
                                    max_bounces=1)
        out["err_spp"] = np.array(_value_error(
            lambda: sharding.render_sharded_2d(scene, cam, rng.key(0),
                                               bad_spp, mesh2)))
    out["err_step"] = np.array(_value_error(
        lambda: pinv.make_train_step(scene, cam, bad_h, None, mesh=mesh)))
    out["global_mesh"] = np.array([distributed.global_mesh().size(),
                                   len(distributed.global_mesh()
                                       .mesh_dim_names)])


def case_spmd(spec, out, n):
    """One SGD step: the sharded step and the single-device one."""
    scene = _scene(spec, "cornell")
    cam = _camera(spec, "cornell")
    cfg = path.RenderConfig(**SPMD)
    target = torch.from_numpy(spec["spmd_target"])
    mesh = sharding.make_mesh()
    meshes = (("spmd", mesh),) + ((("single", None),)
                                  if dist.get_rank() == 0 else ())
    for tag, m in meshes:
        params = pinv.trainable_copy(pinv.TrainableParams.from_scene(
            scene, base_color=True))
        opt = torch.optim.SGD(params.leaves(), lr=1e-2)
        step = pinv.make_train_step(scene, cam, cfg, opt, mesh=m)
        p1, _, loss = step(params, None, rng.key(42), target)
        out[f"{tag}_base_color"] = np_(p1.base_color_factor)
        out[f"{tag}_loss"] = np_(loss)


def case_spmd_edges(spec, out, n):
    """One SGD(1.0) step of the vertex positions with the boundary term."""
    scene = _scene(spec, "edge")
    cam = _camera(spec, "edge")
    cfg = path.RenderConfig(**EDGE)
    target = torch.from_numpy(spec["edge_target"])
    edges = build_edge_table(scene.geometry.indices)
    params = pinv.trainable_copy(pinv.TrainableParams(
        vertex_positions=scene.geometry.positions))
    opt = torch.optim.SGD(params.leaves(), lr=1.0)
    step = pinv.make_train_step(scene, cam, cfg, opt,
                                mesh=sharding.make_mesh(), edges=edges,
                                edge_samples=EDGE_SAMPLES)
    p1, _, loss = step(params, None, rng.key(3), target)
    out["edge_delta"] = np_(p1.vertex_positions - scene.geometry.positions)
    out["edge_loss"] = np_(loss)


def case_clis(spec, out, n):
    """Both CLIs with --tiles n inside the world (no second spawn)."""
    from physically_based_renderer_tpu_torch.apps import inverse as inv_app
    from physically_based_renderer_tpu_torch.apps import render as ren_app
    from physically_based_renderer_tpu_torch.utils import checkpoint, config

    d = Path(spec["out_dir"])
    hdr = d / f"cli{n}.npy"
    rc = ren_app.main(["cornell", "-o", str(d / f"cli{n}.png"),
                       "--hdr-output", str(hdr), "--width", "16",
                       "--height", "32", "--spp", "2", "--bounces", "2",
                       "--tiles", str(n), "--device", "cpu"])
    ckpt = d / f"ckpt{n}"
    rc_inv = inv_app.main([
        "--scene", "cornell", "--params", "emissive", "--steps", "6",
        "--size", "16", "--spp", "1", "--bounces", "1", "--tiles", str(n),
        "--checkpoint-dir", str(ckpt), "--checkpoint-every", "3",
        "--device", "cpu"])
    dist.barrier()
    out["cli_rc"] = np.array([rc, rc_inv])
    if dist.get_rank() == 0:
        out["cli_hdr"] = np.load(hdr)
        bc = config.get("cornell")
        scene, cam = config.build_scene(bc.scene, "cpu")
        cfg = dataclasses.replace(bc.render, width=16, height=32, spp=2,
                                  max_bounces=2)
        out["cli_single"] = np_(path.render(scene, cam, rng.key(0),
                                            cfg).mean())
        out["ckpt_latest"] = np.int64(checkpoint.latest_step(ckpt))


def case_dryrun(spec, out, n):
    from physically_based_renderer_tpu_torch.tools import dryrun
    res = dryrun.dryrun()
    out["dryrun"] = np.array([res["loss"], res["render2d"],
                              res["exchange"]])


CASES = {f.__name__[5:]: f for f in (
    case_render, case_ring, case_render_2d, case_errors, case_spmd,
    case_spmd_edges, case_clis, case_dryrun)}


def run(rank: int, world: int, init_file: str, spec: dict) -> None:
    torch.set_num_threads(1)
    os.environ.pop("LOCAL_WORLD_SIZE", None)
    distributed.ensure_initialized(f"file://{init_file}", world, rank,
                                   backend="gloo", timeout=TIMEOUT)
    try:
        out = {}
        for name in spec["cases"]:
            CASES[name](spec, out, world)
        if rank == 0:
            np.savez(Path(spec["out_dir"]) / f"world{world}.npz", **out)
    finally:
        dist.destroy_process_group()
