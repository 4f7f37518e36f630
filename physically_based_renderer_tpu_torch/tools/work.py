"""The work a main path's own data asks of three kernels, for their bounds.

`fused_work(frame)` counts the ray-triangle tests K4 (`ops/fused.py`)
needs on one frame, replayed from the plain version's own queries: a
closest-hit query tests every triangle; a shadow query tests the triangles
in index order up to and including its first occluder, or all of them; a
lane the kernel does not trace tests none.  `gather_bwd_calls` logs the
(idx, ct, T) of every K5b launch of one backward pass, and
`gradient_step_calls` those of a gradient step's `render()` backward, so
that K5b is timed on a step's own indices.  `resident_calls` logs the
(soup, o, d, t_max, t_min, any_hit) of every K2 launch, `dense_frame_calls`
those of one dense cornell frame, and `resident_work` counts the tests one
such call needs.  All run on any device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import fused, gather, resident


def first_occluder_tests(tri, o, d, t_min, t_max, lanes) -> torch.Tensor:
    """Tests each lane's any-hit query makes, triangles taken in index
    order: the index of its first occluder plus one, or every triangle;
    0 on a lane outside `lanes`.  int64[N]."""
    n, n_tris = o[0].shape[0], tri.shape[0]
    t_max = torch.as_tensor(t_max, dtype=torch.float32,
                            device=tri.device).expand(n)
    out = torch.zeros(n, dtype=torch.int64, device=tri.device)
    for a, b in fused._chunks(n, n_tris):
        tt, ok, _, _ = fused._mt_block(tri, tuple(x[a:b] for x in o),
                                       tuple(x[a:b] for x in d), t_min)
        hit = ok & (tt < t_max[a:b, None])
        first = torch.argmax(hit.to(torch.int32), dim=1)
        tests = torch.where(hit.any(dim=1), first + 1, n_tris)
        out[a:b] = torch.where(lanes[a:b], tests, 0)
    return out


def warp_slots(lengths: torch.Tensor) -> int:
    """Lane slots that 32-lane warps spend on paths of `lengths` (int64[L],
    one path's closest-hit queries a lane, in lane order), when a warp
    runs until its longest path ends."""
    pad = -lengths.shape[0] % 32
    warps = torch.nn.functional.pad(lengths, (0, pad)).reshape(-1, 32)
    return 32 * int(warps.max(dim=1).values.sum())


def fused_work(frame) -> dict:
    """Queries and ray-triangle tests of K4 on `frame` (a FusedFrame):
    {closest_queries, shadow_queries (those traced), closest_tests,
    shadow_tests, tests, count (the frame's ray-query count),
    lane_use_pixels, lane_use_samples}: the share of the closest-hit
    loop's lane slots that trace (`warp_slots`) with a thread a pixel
    looping over the samples and with a thread a (pixel, sample),
    pixel-major."""
    n_tris = frame.tri.shape[0]
    n_pix = frame.width * frame.height
    lengths = torch.zeros((frame.spp, n_pix), dtype=torch.int64,
                          device=frame.tri.device)
    work = dict.fromkeys(("closest_queries", "shadow_queries",
                          "closest_tests", "shadow_tests"), 0)
    calls = []

    def on_query(kind, o, d, t_min, t_max, lanes):
        n = int(lanes.sum())
        work[f"{kind}_queries"] += n
        if kind == "closest":
            # max_bounces + 1 closest-hit queries a sample, in order.
            lengths[len(calls) // (frame.max_bounces + 1)] += lanes
            calls.append(n)
            work["closest_tests"] += n * n_tris
        else:
            work["shadow_tests"] += int(first_occluder_tests(
                frame.tri, o, d, t_min, t_max, lanes).sum())

    _, count = fused.fused_plain(frame, on_query=on_query)
    work["tests"] = work["closest_tests"] + work["shadow_tests"]
    work["count"] = int(count)
    used = work["closest_queries"]
    # A thread a pixel: its warp waits for the longest path of each sample.
    work["lane_use_pixels"] = used / max(1, sum(warp_slots(row)
                                                for row in lengths))
    work["lane_use_samples"] = used / max(1, warp_slots(
        lengths.t().reshape(-1)))
    return work


def gather_bwd_calls(loss_fn) -> list[tuple]:
    """(idx, ct, T) of every K5b launch while `loss_fn()` is evaluated and
    its loss back-propagated, in launch order: `gather.gather_bwd` is
    wrapped for the call."""
    calls = []
    real = gather.gather_bwd

    def logged(idx, ct, t):
        calls.append((idx, ct, t))
        return real(idx, ct, t)

    gather.gather_bwd = logged
    try:
        with torch.enable_grad():
            loss_fn().backward()
    finally:
        gather.gather_bwd = real
    return calls


def gradient_step_calls(device, size: int = 512, spp: int = 4,
                        bounces: int = 4) -> list[tuple]:
    """`gather_bwd_calls` of one render() backward of the gradient step
    that the inverse CLI takes on cornell (the dense path, the four
    material fields; a black target, which changes no index)."""
    from ..core import rng
    from ..grad import inverse
    from ..integrator import path
    from ..utils import config
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, device)
    cfg = dataclasses.replace(bc.render, width=size, height=size, spp=spp,
                              max_bounces=bounces, tracer="resident")
    params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
        scene, base_color=True, roughness=True, metallic=True,
        emissive=True))
    target = torch.zeros((size, size, 3), device=device)
    return gather_bwd_calls(lambda: inverse.pixel_loss(
        path.render(inverse.apply_params(scene, params), cam,
                    rng.key(0, device), cfg).mean(), target))


def resident_calls(fn) -> list[tuple]:
    """(soup, o, d, t_max, t_min, any_hit) of every K2 call while `fn()`
    runs, in launch order (copies of the tensors): `resident.trace` is
    wrapped for the call."""
    calls = []
    real = resident.trace

    def logged(soup, o, d, t_max, t_min, any_hit):
        calls.append((soup.clone(), o.clone(), d.clone(), t_max.clone(),
                      t_min, any_hit))
        return real(soup, o, d, t_max, t_min, any_hit)

    resident.trace = logged
    try:
        fn()
    finally:
        resident.trace = real
    return calls


def dense_frame_calls(device, size: int = 512, spp: int = 4,
                      bounces: int = 4) -> list[tuple]:
    """`resident_calls` of one cornell frame on the dense path
    (tracer="resident"), each with its sample and bounce: [(sample,
    bounce, (soup, o, d, t_max, t_min, any_hit)), ...].  A sample makes
    bounces + 1 closest-hit calls and one shadow call a bounce (cornell's
    one light family is its area emitters)."""
    from ..core import rng
    from ..integrator import path
    from ..utils import config
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, device)
    cfg = dataclasses.replace(bc.render, width=size, height=size, spp=spp,
                              max_bounces=bounces, tracer="resident")
    calls = resident_calls(lambda: path.render_with_stats(
        scene, cam, rng.key(0, device), cfg))
    seen = {False: 0, True: 0}
    out = []
    for call in calls:
        any_hit = call[5]
        sample, bounce = divmod(seen[any_hit],
                                bounces if any_hit else bounces + 1)
        seen[any_hit] += 1
        out.append((sample, bounce, call))
    return out


def resident_work(soup, o, d, t_max, t_min, any_hit) -> int:
    """Ray-triangle tests one K2 call needs on these inputs: a lane whose
    t_max is not above t_min (or NaN) tests none; a closest-hit lane tests
    every triangle; an any-hit lane the triangles in index order up to and
    including its first occluder, or all of them."""
    live = t_max > t_min
    if not any_hit:
        return int(live.sum()) * soup.shape[0]
    return int(first_occluder_tests(soup, o.unbind(1), d.unbind(1), t_min,
                                    t_max, live).sum())
