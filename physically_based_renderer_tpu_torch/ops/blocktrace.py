"""Block-stream tracers (port of `ops/blocktrace.py`): phase A and the
host side of K1 (`_select_candidates`, `_impl_pallas`,
`intersect_blocks_pallas`: `tracer="pallas"`), and the XLA block tracer
(`_impl`, `intersect_blocks`: `tracer="block"`) with its demand
diagnostic `block_union_counts`.

Rays are processed in blocks of B consecutive rays (morton-ordered camera
rays, or direction-binned rays when `sort`):

  1. `_root_cull`: rays that miss the scene's root box get t_max = 0 (dead
     lanes); the others have t_max clipped to the box exit;
  2. phase A, `_select_candidates`: a conservative interval slab test of
     each block's ray bundle (origin box x inverse-direction box) against
     the cluster boxes, then the U nearest candidates by entry distance,
     through the parent boxes first when the grid has more than 4 U
     clusters;
  3. K1 (ops/trace_blocks.py) streams the candidates' soups per block
     (the grid's packed soup, or one `pack_soup` makes from the current
     geometry when the grid carries none);
  4. the flat winner u * K + k decodes to a triangle id.

Steps 1-2 with the padding to whole blocks and chunks (`block_inputs`) are
the span `pbr.trace.phase_a`, steps 3-4 the span `pbr.trace.k1`, once a
tracer call each (utils/profiling.py).

The search is detached; `integrator/shading.py` re-intersects the winner
attached.  The XLA block tracer is the reference's route off the TPU and a
different algorithm in torch ops: the root cull and the optional sort as
above, one flat interval slab test of each block against every cluster
(padding lanes masked to the block's first lane, dead lanes kept), the
nearest max_u candidates, then dense Moller-Trumbore of every ray of a
block against the candidates' triangles, eight clusters at a time, with a
running minimum; its closest hit re-intersects the winner attached.  Top-k
selections
use a stable descending sort: `jax.lax.top_k` puts the lower index first
among equal scores, and ties are common (entry distance 0 for every box
that holds a block's origins).
"""

from __future__ import annotations

import math

import torch

from ..accel.clusters import (SOUP_ROWS, ClusterGrid, _check_k, _pack_soup,
                              cluster_tri_soup)
from ..utils.profiling import span
from .intersect import BIG, Hit, inv_dir, mt_rows
from .trace_blocks import trace_blocks

# The XLA block tracer's dense tests are made for groups of blocks of at
# most this many (ray, triangle) pairs at a time, which bounds its
# temporaries (~16 floats a pair) without changing a result.
PAIRS_A_GROUP = 1 << 24


def bucket_sort_perm(key: torch.Tensor) -> torch.Tensor:
    """Stable permutation with key[perm] ascending (the reference builds the
    same permutation with a one-hot counting sort)."""
    return torch.sort(key, stable=True).indices


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _root_cull(grid: ClusterGrid, o, d, t_min: float, t_max_arr):
    """Per-ray slab test against the root box (union of cluster boxes):
    t_max = 0 for rays that miss it, else t_max clipped to the inflated box
    exit."""
    lo = grid.aabb_min.min(dim=0).values
    hi = grid.aabb_max.max(dim=0).values
    inv = inv_dir(d)
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    near = torch.minimum(t0, t1).max(dim=-1).values
    far = torch.maximum(t0, t1).min(dim=-1).values
    far_inf = far * 1.0001 + 1e-4          # fp-safety inflation
    hit = (near <= far_inf) & (far_inf >= t_min) & (near <= t_max_arr)
    return torch.where(hit, torch.minimum(t_max_arr, far_inf), 0.0)


def dir_bin(d: torch.Tensor) -> torch.Tensor:
    """Direction bin in [0, 24): octant (3 sign bits) x dominant axis."""
    octant = ((d[:, 0] < 0).to(torch.int32) * 4
              + (d[:, 1] < 0).to(torch.int32) * 2
              + (d[:, 2] < 0).to(torch.int32))
    ad = d.abs()
    dom = torch.where(ad[:, 0] >= torch.maximum(ad[:, 1], ad[:, 2]), 0,
                      torch.where(ad[:, 1] >= ad[:, 2], 1, 2))
    return octant * 3 + dom


def _octant_perm(d: torch.Tensor, t_max_arr: torch.Tensor) -> torch.Tensor:
    """Stable permutation sorting rays by (dead, direction bin): morton order
    survives within a bin, and dead lanes pack into trailing blocks."""
    key = torch.where(t_max_arr > 0.0, dir_bin(d), 24)
    return bucket_sort_perm(key)


def _interval_slab(amin, amax, o_lo, o_hi, iv_lo, iv_hi, t_min, t_max_hi):
    """Conservative bundle-vs-AABB test.  amin/amax [C, 3]; o_lo/o_hi
    [NB, 3] origin bounds; iv_lo/iv_hi [NB, 3] inverse-direction bounds;
    t_max_hi [NB].  Returns (overlap [NB, C], entry [NB, C])."""
    return _interval_slab_local(amin[None], amax[None], o_lo, o_hi, iv_lo,
                                iv_hi, t_min, t_max_hi)


def _interval_slab_local(amin, amax, o_lo, o_hi, iv_lo, iv_hi, t_min,
                         t_max_hi):
    """`_interval_slab` with per-block boxes amin/amax [NB, M, 3] (or a
    shared [1, M, 3])."""
    def prod_bounds(a):  # interval [a] times the inverse-direction interval
        c1 = a * iv_lo[:, None, :]
        c2 = a * iv_hi[:, None, :]
        return torch.minimum(c1, c2), torch.maximum(c1, c2)

    # (amin - o) spans [amin - o_hi, amin - o_lo]; likewise amax - o.
    t0l1, t0h1 = prod_bounds(amin - o_hi[:, None, :])
    t0l2, t0h2 = prod_bounds(amin - o_lo[:, None, :])
    t1l1, t1h1 = prod_bounds(amax - o_hi[:, None, :])
    t1l2, t1h2 = prod_bounds(amax - o_lo[:, None, :])
    t0_lo = torch.minimum(t0l1, t0l2)
    t0_hi = torch.maximum(t0h1, t0h2)
    t1_lo = torch.minimum(t1l1, t1l2)
    t1_hi = torch.maximum(t1h1, t1h2)
    # slab near/far, conservatively widened
    near_lo = torch.minimum(t0_lo, t1_lo).max(dim=-1).values   # [NB, M]
    far_hi = torch.maximum(t0_hi, t1_hi).min(dim=-1).values
    overlap = ((near_lo <= far_hi) & (far_hi >= t_min)
               & (near_lo <= t_max_hi[:, None]))
    return overlap, torch.clamp_min(near_lo, 0.0)


def _top_k(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores per row, lower index first among
    equal scores (`jax.lax.top_k`'s order)."""
    return torch.sort(score, dim=1, descending=True, stable=True).indices[:, :k]


def _select_candidates(grid: ClusterGrid, o_s, d_s, tm, nb: int, b: int,
                       t_min: float, max_u: int):
    """Phase A: per-block interval culling + nearest-first top U.

    Returns (u_idx i32[NB, U] with the sentinel C in invalid slots,
    u_entry f32[NB, U] (BIG for invalid), n_valid i32[NB], and the blocked
    rays ob/db f32[NB, B, 3], tmb f32[NB, B]).  Grids with parent boxes
    and more than 4 * max_u clusters select max(max_u // 2, 8) parents
    first and slab their 4 children each; other grids take the flat top-k
    over all C clusters."""
    c = grid.num_clusters
    ob = o_s.reshape(nb, b, 3)
    db = d_s.reshape(nb, b, 3)
    tmb = tm.reshape(nb, b)
    inv = inv_dir(db)
    lane_valid = (tmb > 0.0)[..., None]
    ob_m = torch.where(lane_valid, ob, ob[:, :1, :])
    inv_m = torch.where(lane_valid, inv, inv[:, :1, :])
    o_lo, o_hi = ob_m.min(dim=1).values, ob_m.max(dim=1).values
    iv_lo, iv_hi = inv_m.min(dim=1).values, inv_m.max(dim=1).values
    tm_hi = tmb.max(dim=1).values
    neg_inf = float("-inf")

    if grid.parent_min is not None and c > 4 * max_u:
        n_par = grid.parent_min.shape[0]
        ov_p, en_p = _interval_slab(grid.parent_min, grid.parent_max, o_lo,
                                    o_hi, iv_lo, iv_hi, t_min, tm_hi)
        n_sel = min(max(max_u // 2, 8), n_par)
        p_idx = _top_k(torch.where(ov_p, -en_p, neg_inf), n_sel)
        p_valid = torch.gather(ov_p, 1, p_idx)                 # [NB, NP]
        child = (p_idx[:, :, None] * 4
                 + torch.arange(4, device=p_idx.device)).reshape(nb, -1)
        c_ok = (child < c) & torch.repeat_interleave(p_valid, 4, dim=1)
        safe = torch.clamp_max(child, c - 1)
        overlap, entry = _interval_slab_local(
            grid.aabb_min[safe], grid.aabb_max[safe], o_lo, o_hi, iv_lo,
            iv_hi, t_min, tm_hi)
        overlap = overlap & c_ok
        s_idx = _top_k(torch.where(overlap, -entry, neg_inf),
                       min(max_u, overlap.shape[1]))
        u_idx = torch.gather(child, 1, s_idx)
    else:
        overlap, entry = _interval_slab(grid.aabb_min, grid.aabb_max, o_lo,
                                        o_hi, iv_lo, iv_hi, t_min, tm_hi)
        s_idx = u_idx = _top_k(torch.where(overlap, -entry, neg_inf),
                               min(max_u, c))
    u_valid = torch.gather(overlap, 1, s_idx)
    u_entry = torch.where(u_valid, torch.gather(entry, 1, s_idx), BIG)
    n_valid = u_valid.sum(dim=1).to(torch.int32)
    u_idx = torch.where(u_valid, u_idx, c).to(torch.int32)
    return u_idx, u_entry, n_valid, ob, db, tmb


def pack_soup(grid: ClusterGrid, geometry) -> torch.Tensor:
    """The detached soup f32[C+1, 9, K] of the current geometry (the
    all-zero sentinel cluster last), for a grid that carries none: K1's
    input packed at trace time, as the reference packs it inside the trace
    (its k = 32 variants are this soup's rows; accel/clusters.py)."""
    _check_k(grid)
    return _pack_soup(*cluster_tri_soup(
        grid.tri_id, geometry.positions.detach(), geometry.indices))


def block_inputs(grid: ClusterGrid, o, d, t_min: float, t_max=BIG,
                 block: int = 256, max_u: int = 48, sort: bool = False,
                 chunk: int = 4, geometry=None):
    """Phase A up to K1's inputs -> (args, perm).

    `args` = (u_idx, o, d, t_max, soup, n_valid, entry) for
    ops.trace_blocks.trace_blocks: root-culled, optionally direction-sorted
    rays padded to whole blocks (padding lanes: origin 3e30, t_max 0), and
    candidate lists padded with the sentinel to whole chunks.  `perm` is
    the sort permutation (None without `sort`).  A grid without a packed
    soup takes one packed from `geometry` (pack_soup).  Cluster sizes other
    than 32 and multiples of 128 are refused, as the reference refuses
    them, and so is a soup whose shape is not the grid's [C+1, 9, k]."""
    _check_k(grid)
    soup = grid.soup
    if soup is None:
        if geometry is None:
            raise ValueError("the cluster grid has no packed soup: pass "
                             "the geometry to pack it from")
        soup = pack_soup(grid, geometry)
    want = (grid.num_clusters + 1, SOUP_ROWS, grid.k)
    if tuple(soup.shape) != want:
        raise ValueError(f"the grid's soup has shape {tuple(soup.shape)}, "
                         f"expected {want} for {grid.num_clusters} clusters "
                         f"of k={grid.k}")
    n = o.shape[0]
    o_s = o.detach().to(torch.float32)
    d_s = d.detach().to(torch.float32)
    tm = torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32,
                                            device=o.device), (n,))
    tm = _root_cull(grid, o_s, d_s, t_min, tm)
    perm = None
    if sort:
        perm = _octant_perm(d_s, tm)
        o_s, d_s, tm = o_s[perm], d_s[perm], tm[perm]
    n_pad = _round_up(n, block)
    pad = n_pad - n
    o_s = torch.cat([o_s, o_s.new_full((pad, 3), 3e30)])
    d_s = torch.cat([d_s, d_s.new_tensor([[1.0, 0.0, 0.0]]).expand(pad, 3)])
    tm = torch.cat([tm, tm.new_zeros((pad,))])
    nb = n_pad // block

    u_idx, u_entry, n_valid, ob, db, tmb = _select_candidates(
        grid, o_s, d_s, tm, nb, block, t_min, max_u)
    # Whole chunks only: pad the candidate list with the sentinel cluster;
    # at k = 32 to whole chunks of 4 * (chunk // 4), at least 4, even where
    # the list is shorter than one chunk (the reference's :480-487).
    n_u = u_idx.shape[1]
    ch = max(4, 4 * (chunk // 4)) if grid.k == 32 else min(chunk, n_u)
    extra = _round_up(n_u, ch) - n_u
    if extra:
        u_idx = torch.cat([u_idx, u_idx.new_full((nb, extra),
                                                 grid.num_clusters)], dim=1)
        u_entry = torch.cat([u_entry, u_entry.new_full((nb, extra), BIG)],
                            dim=1)
    return ((u_idx.contiguous(), ob.contiguous(), db.contiguous(),
             tmb.contiguous(), soup, n_valid, u_entry.contiguous()),
            perm)


def intersect_blocks_pallas(grid: ClusterGrid, o, d, t_min: float = 1e-4,
                            t_max=BIG, any_hit: bool = False,
                            block: int = 256, max_u: int = 48,
                            sort: bool = False, chunk: int = 4,
                            geometry=None):
    """Block tracer through K1 (the reference's route name "pallas"; on the
    card K1 is the CUDA kernel of ops/trace_blocks.py).

    Closest hit -> a detached Hit (kernel t, u = v = 0: the reference's
    `lean` form, since shade_surface re-derives attached barycentrics);
    any_hit -> bool[N].  t_max is a scalar or f32[N].  sort=True
    stable-sorts the rays by (dead, direction bin) before blocking and
    unscrambles the outputs, for direction-scattered streams.  `geometry`
    packs the soup of a grid that carries none."""
    n = o.shape[0]
    with span("pbr.trace.phase_a"):
        args, perm = block_inputs(grid, o, d, t_min, t_max, block, max_u,
                                  sort, chunk, geometry)
    with span("pbr.trace.k1"):
        out = trace_blocks(*args, t_min=t_min, any_hit=any_hit, chunk=chunk)
        if any_hit:
            occ = out.reshape(-1)[:n]
            if sort:
                occ = torch.zeros_like(occ).index_put_((perm,), occ)
            return occ

        # Winner decode through flat 1-D gathers: flat = u * K + k.
        u_idx = args[0]
        nb, n_u = u_idx.shape
        k = grid.k
        best_t, best_flat = out
        found = best_flat >= 0
        flat = torch.clamp_min(best_flat, 0)
        blk = torch.arange(nb, dtype=torch.int32,
                           device=o.device)[:, None]
        cl_win = u_idx.reshape(-1)[(blk * n_u + flat // k).long()]
        cl_win = torch.clamp_max(cl_win, grid.num_clusters - 1)
        tri_win = grid.tri_id.reshape(-1)[(cl_win * k + flat % k).long()]
        tri = torch.where(found, tri_win, -1).reshape(-1)[:n]
        t_k = best_t.reshape(-1)[:n]
        if sort:
            tri = torch.full_like(tri, -1).index_put_((perm,), tri)
            t_k = torch.full_like(t_k, BIG).index_put_((perm,), t_k)
        zeros = torch.zeros((n,), dtype=torch.float32, device=o.device)
        return Hit(t=torch.where(tri >= 0, t_k, BIG), tri=tri, u=zeros,
                   v=zeros)


# ---------------------------------------------------------------------------
# The XLA block tracer (`tracer="block"`)
# ---------------------------------------------------------------------------

def _impl(grid: ClusterGrid, geometry, o, d, t_max_arr, t_min: float,
          any_hit: bool, block: int, max_u: int, sort: bool):
    n = o.shape[0]
    c = grid.num_clusters
    max_u = min(max_u, c)
    k = grid.k
    v0g, e1g, e2g = cluster_tri_soup(grid.tri_id,
                                     geometry.positions.detach(),
                                     geometry.indices)
    b = block
    o_sg, d_sg = o.detach(), d.detach()
    t_max_arr = _root_cull(grid, o_sg, d_sg, t_min, t_max_arr)
    perm = None
    if sort:
        perm = _octant_perm(d_sg, t_max_arr)
        o_sg, d_sg, t_max_arr = o_sg[perm], d_sg[perm], t_max_arr[perm]
    n_pad = _round_up(n, b)
    pad = n_pad - n
    o_s = torch.cat([o_sg, o_sg.new_full((pad, 3), 3e30)])
    d_s = torch.cat([d_sg, d_sg.new_tensor([[1.0, 0.0, 0.0]]).expand(pad, 3)])
    tm = torch.cat([t_max_arr, t_max_arr.new_zeros((pad,))])
    nb = n_pad // b
    ob = o_s.reshape(nb, b, 3)
    db = d_s.reshape(nb, b, 3)
    tmb = tm.reshape(nb, b)

    # Bundle bounds; padding lanes (origin 3e30) take the block's first
    # lane's values.
    inv = inv_dir(db)
    lane_valid = (torch.arange(n_pad, device=o.device) < n).reshape(nb, b, 1)
    ob_m = torch.where(lane_valid, ob, ob[:, :1, :])
    inv_m = torch.where(lane_valid, inv, inv[:, :1, :])
    overlap, entry = _interval_slab(
        grid.aabb_min, grid.aabb_max, ob_m.min(dim=1).values,
        ob_m.max(dim=1).values, inv_m.min(dim=1).values,
        inv_m.max(dim=1).values, t_min, tmb.max(dim=1).values)
    # nearest-first candidates
    u_idx = _top_k(torch.where(overlap, -entry, float("-inf")), max_u)
    u_valid = torch.gather(overlap, 1, u_idx)

    # Candidates in chunks of u_chunk clusters, a running best a ray.
    u_chunk = min(8, max_u)
    n_uc = -(-max_u // u_chunk)
    u_pad = n_uc * u_chunk
    if u_pad > max_u:
        u_idx = torch.cat([u_idx, u_idx.new_zeros((nb, u_pad - max_u))], 1)
        u_valid = torch.cat([u_valid, u_valid.new_zeros((nb, u_pad - max_u))],
                            1)
    best_t = tmb.new_full((nb, b), BIG)
    best_flat = torch.full((nb, b), -1, dtype=torch.int64, device=o.device)
    occ = torch.zeros((nb, b), dtype=torch.bool, device=o.device)
    g = max(1, PAIRS_A_GROUP // (b * u_chunk * k))
    for g0 in range(0, nb, g):
        blk = slice(g0, g0 + g)
        ng = ob[blk].shape[0]
        for uc in range(n_uc):
            sl = u_idx[blk, uc * u_chunk:(uc + 1) * u_chunk]
            vl = u_valid[blk, uc * u_chunk:(uc + 1) * u_chunk]
            t, _, _, ok = mt_rows(
                ob[blk][:, :, None], db[blk][:, :, None],
                *(x[sl].reshape(ng, 1, u_chunk * k, 3)
                  for x in (v0g, e1g, e2g)), t_min, math.inf)
            tri_ok = (grid.tri_id[sl] >= 0) & vl[:, :, None]
            ok = (ok & tri_ok.reshape(ng, 1, u_chunk * k)
                  & (t < tmb[blk][:, :, None]))
            if any_hit:
                occ[blk] |= ok.any(dim=-1)
                continue
            t = torch.where(ok, t, BIG)
            kb = torch.argmin(t, dim=-1)
            tb = torch.gather(t, 2, kb[..., None])[..., 0]
            better = tb < best_t[blk]
            best_t[blk] = torch.where(better, tb, best_t[blk])
            best_flat[blk] = torch.where(better, uc * u_chunk * k + kb,
                                         best_flat[blk])

    if any_hit:
        occ = occ.reshape(n_pad)[:n]
        if sort:
            occ = torch.zeros_like(occ).index_put_((perm,), occ)
        return occ

    # Winner decode: flat = u * K + k within the candidate list.
    found2 = best_flat >= 0
    flat = torch.clamp_min(best_flat, 0)
    cl_win = torch.gather(u_idx, 1, flat // k)
    tri_win = grid.tri_id[cl_win, flat % k]
    tri = torch.where(found2, tri_win, -1).reshape(n_pad)[:n]
    if sort:
        tri = torch.full_like(tri, -1).index_put_((perm,), tri)
    # The winner re-intersected with gradient attached.
    idx = geometry.indices.long()[torch.clamp_min(tri, 0).long()]
    pa = geometry.positions
    w0 = pa[idx[:, 0]]
    t, u, v, _ = mt_rows(o, d, w0, pa[idx[:, 1]] - w0, pa[idx[:, 2]] - w0,
                         t_min, BIG)
    found = tri >= 0
    return Hit(t=torch.where(found, t, BIG), tri=tri.to(torch.int32),
               u=torch.where(found, u, 0.0), v=torch.where(found, v, 0.0))


def intersect_blocks(grid: ClusterGrid, geometry, o, d, t_min: float = 1e-4,
                     t_max=BIG, any_hit: bool = False, block: int = 512,
                     max_u: int = 48, sort: bool = False):
    """Closest hit (an attached Hit) or any hit (bool[N]) through the XLA
    block tracer; t_max is a scalar or f32[N]."""
    n = o.shape[0]
    t_max_arr = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.device), (n,))
    return _impl(grid, geometry, o, d, t_max_arr, float(t_min), any_hit,
                 block, max_u, sort)


def block_union_counts(grid: ClusterGrid, o, d, block: int = 512,
                       t_min: float = 1e-4, t_max=BIG) -> torch.Tensor:
    """Candidate clusters a block's bundle overlaps (int64[NB]): the demand
    that max_u caps.  Padding lanes repeat the last ray; a per-ray t_max
    counts as unbounded."""
    n = o.shape[0]
    n_pad = _round_up(n, block)
    pad = n_pad - n
    o_s = torch.cat([o, o[-1:].expand(pad, 3)])
    d_s = torch.cat([d, d[-1:].expand(pad, 3)])
    nb = n_pad // block
    ob = o_s.reshape(nb, block, 3)
    inv = inv_dir(d_s.reshape(nb, block, 3))
    t_hi = float(t_max) if torch.as_tensor(t_max).dim() == 0 else BIG
    overlap, _ = _interval_slab(
        grid.aabb_min, grid.aabb_max, ob.min(dim=1).values,
        ob.max(dim=1).values, inv.min(dim=1).values, inv.max(dim=1).values,
        t_min, o.new_full((nb,), t_hi))
    return overlap.sum(dim=-1)
