# Frozen copy of physically_based_renderer_tpu_torch/tools/work.py
# (first_occluder_tests, warp_slots, fused_work, resident_work) at commit
# d7302a1, fed by the reference: the plain K4 it replays is the
# reference's (reference/pbr_plain/ops/fused.py).
"""The ray-triangle tests K4 needs on one frame and K2 on one call,
replayed from the reference's own queries."""

from __future__ import annotations

import torch

from reference.pbr_plain.ops import fused


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
