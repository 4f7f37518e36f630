"""The work counters of tools/work.py and the kernel build's hash.

K4's work counter (`fused_work`) against a brute per-ray loop in numpy
float32 over the same queries: every triangle for a closest hit, up to and
including the first occluder for a shadow ray.  The K5b call logger
against the launches a render's backward makes.  The K2 call logger
against a dense frame's calls, and K2's work counter against the same
brute loop.  `cuda_lib.build_dir` against an edit of a header.  All on the
CPU.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.grad import inverse
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import (cuda_lib, fused, gather,
                                                     resident)
from physically_based_renderer_tpu_torch.tools import work
from physically_based_renderer_tpu_torch.utils import config

torch.set_num_threads(1)
CPU = torch.device("cpu")
F = np.float32


def _frame(name):
    bc = config.get(name)
    scene, cam = config.build_scene(bc.scene, CPU)
    cfg = dataclasses.replace(bc.render, width=16, height=16, spp=2,
                              max_bounces=2)
    return fused.fused_frame(scene, cam, rng.key(0, CPU), cfg)


def _hits(tri, o, d, t_min, t_max):
    """One ray against triangle rows in order, in float32 scalars as the
    plain version computes each: a bool per triangle."""
    out = []
    for r in tri:
        v0, e1, e2 = r[0:3], r[3:6], r[6:9]
        p = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
             d[0] * e2[1] - d[1] * e2[0])
        det = p[0] * e1[0] + p[1] * e1[1] + p[2] * e1[2]
        nonzero = abs(det) > F(1e-9)
        inv = F(1.0) / det if nonzero else F(0.0)
        tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
        u = (tv[0] * p[0] + tv[1] * p[1] + tv[2] * p[2]) * inv
        q = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
             tv[0] * e1[1] - tv[1] * e1[0])
        v = (d[0] * q[0] + d[1] * q[1] + d[2] * q[2]) * inv
        t = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv
        out.append(bool(nonzero and u >= 0 and v >= 0 and u + v <= 1
                        and t > F(t_min) and t < t_max))
    return out


@pytest.mark.parametrize("name", ["cornell", "triangle"])
def test_fused_work_matches_a_brute_per_ray_loop(name):
    f = _frame(name)
    tri = f.tri.numpy()
    n_tris = tri.shape[0]
    brute = {"closest_queries": 0, "shadow_queries": 0, "closest_tests": 0,
             "shadow_tests": 0}
    shadow_hits = 0
    lengths = {}   # (sample, pixel) -> closest-hit queries of the path
    n_calls = 0

    def on_query(kind, o, d, t_min, t_max, lanes):
        nonlocal shadow_hits, n_calls
        if kind == "closest":
            s = n_calls // (f.max_bounces + 1)
            n_calls += 1
            for i in np.flatnonzero(lanes.numpy()):
                lengths[s, i] = lengths.get((s, i), 0) + 1
        o = np.stack([x.numpy() for x in o], 1)
        d = np.stack([torch.as_tensor(x).expand(lanes.shape[0]).numpy()
                      for x in d], 1)
        t_max = np.broadcast_to(np.asarray(t_max, F), lanes.shape)
        for i in np.flatnonzero(lanes.numpy()):
            brute[f"{kind}_queries"] += 1
            hits = _hits(tri, o[i], d[i], t_min, t_max[i])
            if kind == "closest":
                brute["closest_tests"] += len(hits)
            elif any(hits):
                shadow_hits += 1
                brute["shadow_tests"] += hits.index(True) + 1
            else:
                brute["shadow_tests"] += n_tris

    _, count = fused.fused_plain(f, on_query=on_query)
    # Lane slots: warps of 32 pixels for each sample, or of 32 (pixel,
    # sample) threads in pixel-major order; a warp runs its longest path.
    n_pix = f.width * f.height
    length = lambda s, i: lengths.get((s, i), 0)
    slots_pixels = sum(32 * max(length(s, i) for i in range(w, w + 32))
                       for s in range(f.spp) for w in range(0, n_pix, 32))
    items = [(i, s) for i in range(n_pix) for s in range(f.spp)]
    slots_samples = sum(32 * max(length(s, i) for i, s in items[w:w + 32])
                        for w in range(0, len(items), 32))
    used = brute["closest_queries"]
    got = work.fused_work(f)
    assert got == {**brute, "tests": brute["closest_tests"]
                   + brute["shadow_tests"], "count": int(count),
                   "lane_use_pixels": used / slots_pixels,
                   "lane_use_samples": used / slots_samples}
    assert 0.0 < got["lane_use_pixels"] <= 1.0
    n_shadow = int(f.has_em) + int(f.has_dir)
    assert got["closest_queries"] <= got["count"]
    assert got["count"] <= got["closest_queries"] * (1 + n_shadow)
    # Some shadow rays stop early and some are traced in full.
    assert 0 < got["shadow_queries"]
    if name == "cornell":
        assert 0 < shadow_hits < got["shadow_queries"]
        assert got["shadow_tests"] < got["shadow_queries"] * n_tris


def test_gather_bwd_calls_logs_every_launch():
    """One gradient step's render() backward at 1 spp and 2 bounces calls
    K5b 1 x (3 closest hits + 2 shadow rays) times, on tri_attrs [32, 86]
    and the emitter table [2, 20]; the logger leaves the gradients as they
    are."""
    calls = work.gradient_step_calls(CPU, size=8, spp=1, bounces=2)
    assert gather.gather_bwd.__name__ == "gather_bwd"
    assert sorted((t, ct.shape[1]) for _, ct, t in calls) == (
        [(2, 20)] * 2 + [(32, 86)] * 3)
    assert all(idx.shape[0] == ct.shape[0] == 64 for idx, ct, _ in calls)
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, CPU)
    cfg = dataclasses.replace(bc.render, width=8, height=8, spp=1,
                              max_bounces=2, tracer="resident")
    target = torch.zeros((8, 8, 3))

    def run():
        params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
            scene, base_color=True, roughness=True, metallic=True,
            emissive=True))
        loss = lambda: inverse.pixel_loss(
            path.render(inverse.apply_params(scene, params), cam,
                        rng.key(3, CPU), cfg).mean(), target)
        return params, loss

    params, loss = run()
    assert len(work.gather_bwd_calls(loss)) == 5
    want, loss_again = run()
    with torch.enable_grad():
        loss_again().backward()
    for (_, a), (_, b) in zip(params.items(), want.items()):
        assert torch.equal(a.grad, b.grad)


def test_dense_frame_calls_log_every_k2_call():
    """One dense cornell frame at 16x16, 2 spp, 2 bounces makes 2 x (3
    closest + 2 shadow) K2 calls, as many as the kernel's counter counts a
    frame on the card; the logger leaves the frame as it is; K2's work
    counter equals a brute per-ray loop: every triangle for a live
    closest-hit lane, up to the first occluder for a live shadow lane,
    nothing for a lane whose t_max is not above t_min."""
    spp, bounces = 2, 2
    calls = work.dense_frame_calls(CPU, size=16, spp=spp, bounces=bounces)
    assert resident.trace.__name__ == "trace"
    assert len(calls) == spp * (2 * bounces + 1)
    assert [(s, b, c[5]) for s, b, c in calls] == [
        (s, b, any_hit) for s in range(spp) for b in range(bounces + 1)
        for any_hit in (False, True) if not (any_hit and b == bounces)]
    soup = resident.pack_resident_soup(config.build_scene(
        config.get("cornell").scene, CPU)[0].geometry)
    dead = 0
    for _, _, (s, o, d, tm, t_min, any_hit) in calls:
        assert torch.equal(s, soup) and o.shape == (256, 3)
        tri, o_np, d_np, tm_np = (x.numpy() for x in (s, o, d, tm))
        brute = 0
        for i in range(o_np.shape[0]):
            if not tm_np[i] > t_min:
                dead += 1
                continue
            hits = _hits(tri, o_np[i], d_np[i], t_min, tm_np[i])
            brute += (len(hits) if not any_hit or not any(hits)
                      else hits.index(True) + 1)
        assert work.resident_work(s, o, d, tm, t_min, any_hit) == brute
    assert dead > 0    # shadow calls carry hopeless lanes (t_max = 0)
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, CPU)
    cfg = dataclasses.replace(bc.render, width=16, height=16, spp=spp,
                              max_bounces=bounces, tracer="resident")
    film, _ = path.render_with_stats(scene, cam, rng.key(0, CPU), cfg)
    frames = []
    logged = work.resident_calls(lambda: frames.append(
        path.render_with_stats(scene, cam, rng.key(0, CPU), cfg)))
    assert len(logged) == len(calls)
    assert torch.equal(frames[0][0].mean(), film.mean())


def test_build_dir_covers_headers(monkeypatch, tmp_path):
    """An edit to a header the sources include (csrc/*.cuh) moves the
    build to another directory, so that the library is built anew."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc)
    monkeypatch.setattr(cuda_lib, "CSRC", csrc)
    assert "rcp.cuh" in cuda_lib.headers()
    before = cuda_lib.build_dir()
    header = csrc / "rcp.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    edited = cuda_lib.build_dir()
    (csrc / "extra.cuh").write_text("#pragma once\n")
    added = cuda_lib.build_dir()
    assert len({before, edited, added}) == 3
    header.write_bytes(header.read_bytes()[:-1])
    (csrc / "extra.cuh").unlink()
    assert cuda_lib.build_dir() == before
