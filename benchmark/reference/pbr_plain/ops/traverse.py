# Frozen copy of physically_based_renderer_tpu_torch/ops/traverse.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""BVH traversal, `tracer="bvh"` (port of `ops/traverse.py`).

A stack walk over ray batches in torch ops.  All rays advance in lockstep;
each owns a stack row of MAX_DEPTH slots.  One step pops one node a ray:
a leaf runs Moller-Trumbore over its (at most LEAF_SIZE, contiguous)
triangles, an inner node slab-tests both child boxes and pushes the hit
ones, the near child last so that it pops first.  The search runs
detached; the winner is re-intersected with gradient attached, so hits
carry gradients to the vertex positions as the reference's do.

The reference runs the walk as one `lax.while_loop`, whose condition costs
the host nothing.  Here a test of "any ray still running" is a copy from
the device, so it is made every CHECK_EVERY steps: a step of a ray whose
stack is empty changes nothing.  At each test the rays that finished leave
the working set, so the walk's tail runs on the few rays still deep in the
tree.  `STEPS` counts the steps run, over all calls, as the kernels count
their launches.
"""

from __future__ import annotations

import torch

from ..accel.bvh import BVH, LEAF_SIZE, MAX_DEPTH
from ..utils import debug
from .intersect import BIG, Hit, inv_dir, mt_rows

CHECK_EVERY = 8   # steps between two tests of the working set
STEPS = 0         # lockstep steps run since the last reset


def _slab(node_min, node_max, o, inv_d, t_min: float, t_max):
    """Ray-box slab test -> (hit bool[N], entry t f32[N]); [N, 3] inputs."""
    t0 = (node_min - o) * inv_d
    t1 = (node_max - o) * inv_d
    tn = torch.minimum(t0, t1).max(dim=-1).values
    tf = torch.maximum(t0, t1).min(dim=-1).values
    hit = (tn <= tf) & (tf >= t_min) & (tn <= t_max)
    return hit, torch.clamp_min(tn, t_min)


def _walk(bvh: BVH, tv0, te1, te2, o, d, t_min: float, t_max,
          any_hit: bool) -> torch.Tensor:
    """The detached search -> the winner's BVH position a ray (int64[N],
    -1 for none)."""
    global STEPS
    n = o.shape[0]
    dev = o.device
    inv_d = inv_dir(d)
    last = tv0.shape[0] - 1
    last_node = bvh.node_left.shape[0] - 1
    leaf_k = torch.arange(LEAF_SIZE, device=dev)
    out_i = torch.full((n,), -1, dtype=torch.int64, device=dev)
    # The working set: its rays' ids, stacks and running bests.
    ids = torch.arange(n, device=dev)
    stack = torch.zeros((n, MAX_DEPTH), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)  # root at slot 0
    best_t, best_i = t_max.clone(), out_i.clone()
    step = 0
    while ids.numel():
        if step and step % CHECK_EVERY == 0:
            live = sp > 0
            if any_hit:
                live &= best_i < 0
            keep = live.nonzero().squeeze(1)
            if keep.numel() < ids.numel():
                out_i[ids] = best_i
                ids, stack, sp = ids[keep], stack[keep], sp[keep]
                best_t, best_i = best_t[keep], best_i[keep]
                o, d, inv_d = o[keep], d[keep], inv_d[keep]
                if not ids.numel():
                    break
        step += 1
        rows = torch.arange(ids.numel(), device=dev)
        running = sp > 0
        if any_hit:
            running &= best_i < 0
        node = debug.check_index("bvh nodes",
                                 stack[rows, torch.clamp_min(sp - 1, 0)],
                                 last_node + 1)
        sp = sp - running.to(torch.int64)
        left = bvh.node_left[node].long()
        right = bvh.node_right[node].long()
        is_leaf = left < 0
        start = -left - 1

        # leaf: its triangles tested together against the running best; the
        # nearest wins, the first of equal ones, as tests in order would
        tidx = torch.clamp(start[:, None] + leaf_k, 0, last)    # [M, LEAF]
        t, _, _, ok = mt_rows(o[:, None], d[:, None], tv0[tidx], te1[tidx],
                              te2[tidx], t_min, best_t[:, None])
        ok &= (running & is_leaf)[:, None] & (leaf_k < right[:, None])
        t = torch.where(ok, t, BIG)
        kb = t.argmin(dim=1, keepdim=True)
        win = ok.gather(1, kb)[:, 0]
        best_t = torch.where(win, t.gather(1, kb)[:, 0], best_t)
        best_i = torch.where(win, tidx.gather(1, kb)[:, 0], best_i)

        # inner node: both children's slabs, the far one pushed first; a
        # leaf's "children" (its start and count) are clamped into the node
        # table, as the reference's gathers clamp, and go unused
        inner = running & ~is_leaf
        kids = debug.check_index("bvh nodes", torch.stack([left, right], 1),
                                 last_node + 1, skip=is_leaf[:, None])
        kids = kids.clamp(0, last_node)
        hit, t_in = _slab(bvh.node_min[kids], bvh.node_max[kids],
                          o[:, None], inv_d[:, None], t_min, best_t[:, None])
        (l_idx, r_idx), (hit_l, hit_r) = kids.unbind(1), hit.unbind(1)
        t_l, t_r = t_in.unbind(1)
        l_first = t_l <= t_r
        first = torch.where(l_first, l_idx, r_idx)
        second = torch.where(l_first, r_idx, l_idx)
        hit_first = torch.where(l_first, hit_l, hit_r)
        hit_second = torch.where(l_first, hit_r, hit_l)
        for child, push in ((second, inner & hit_second),
                            (first, inner & hit_first)):
            slot = torch.clamp_max(sp, MAX_DEPTH - 1)
            stack[rows, slot] = torch.where(push, child, stack[rows, slot])
            sp = sp + push.to(torch.int64)
    STEPS += step
    return out_i


def intersect_bvh(bvh: BVH, geometry, o: torch.Tensor, d: torch.Tensor,
                  t_min: float = 1e-4, t_max=BIG, any_hit: bool = False):
    """Closest hit (Hit, tri = original triangle ids) or, with any_hit, a
    bool[N] occlusion mask of rays [N, 3] against the BVH; t_max is a
    scalar or f32[N]."""
    n = o.shape[0]
    o_s, d_s = o.detach(), d.detach()
    t_max_arr = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=o.device), (n,))
    # The triangles in BVH order, detached, as the search reads them.
    order = debug.check_index("bvh triangles", bvh.tri_order.long(),
                              geometry.num_tris)
    p = geometry.positions.detach()
    tri = debug.check_index("vertex ids", geometry.indices.long()[order],
                            p.shape[0])                       # [T, 3]
    tv0 = p[tri[:, 0]]
    te1 = p[tri[:, 1]] - tv0
    te2 = p[tri[:, 2]] - tv0
    best_i = _walk(bvh, tv0, te1, te2, o_s, d_s, t_min, t_max_arr, any_hit)
    found = best_i >= 0
    if any_hit:
        return found
    # The winner re-intersected with gradient attached.
    win = torch.clamp_min(best_i, 0)
    widx = tri[win]
    pa = geometry.positions
    w0 = pa[widx[:, 0]]
    t, u, v, _ = mt_rows(o, d, w0, pa[widx[:, 1]] - w0,
                         pa[widx[:, 2]] - w0, t_min, BIG)
    orig_tri = torch.where(found, order[win], -1).to(
        torch.int32)
    return Hit(t=torch.where(found, t, BIG), tri=orig_tri,
               u=torch.where(found, u, 0.0), v=torch.where(found, v, 0.0))
