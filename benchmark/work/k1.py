# Frozen copy of chip_smoke.py::k1_work and k1_any_work (:749, :789) at
# commit d7302a1, fed by the reference: the tracer they replay is the
# reference's plain K1 (reference/pbr_plain/ops/trace_blocks.py).
# k1_any_work finds each ray's first hitting chunk in one pass over the
# chunks where the original made one capped call a chunk; the count is the
# same (tests/test_benchmark_work.py holds the two equal).
"""The work one K1 call needs on its inputs: ray-triangle tests and the
distinct clusters read, and the bytes its bound counts."""

from __future__ import annotations

import torch

from reference.pbr_plain.accel.clusters import SOUP_ROWS
from reference.pbr_plain.ops import trace_blocks as tb

BIG = 1e30


def k1_work(args, best_t, best_flat, chunk: int, tri_id):
    """The work one closest-hit K1 call needs on these inputs: (ray-triangle
    tests, distinct clusters read).  The block's early exit is replayed from
    the call's own t and winners: a block cannot stop before the chunk of
    its last winner, and from that chunk on its state is final, so it stops
    at the first chunk j at or after it whose next entry distance is at
    least max over live lanes of min(t, t_max).  Only live lanes (t_max > 0)
    test, and only real triangles of the clusters in the chunks a block
    visits count (padding and the sentinel are left out).  The chunk is
    K1's (`chunk_width`: at K = 32 a multiple of 4)."""
    u_idx, _, _, tm, soup, n_valid, entry = args
    dev = tm.device
    n_u, k = u_idx.shape[1], soup.shape[-1]
    ch = tb.chunk_width(chunk, n_u, k)
    w, nct = ch * k, n_u // ch
    live = tm > 0.0
    win_chunk = torch.where(live & (best_flat >= 0), best_flat // w,
                            -1).amax(dim=1)
    worst = torch.where(live, torch.minimum(best_t, tm), 0.0).amax(dim=1)
    j = torch.arange(nct, device=dev)
    nxt = torch.where((j[None] + 1) * ch < n_valid[:, None],
                      entry[:, torch.clamp_max(j + 1, nct - 1) * ch], BIG)
    stop = (j[None] >= win_chunk[:, None]) & (worst[:, None] <= nxt)
    first = torch.where(stop, j[None], nct).amin(dim=1)
    visited = torch.minimum(first + 1, (n_valid.long() + ch - 1) // ch)
    if bool((visited <= win_chunk).any()):
        raise AssertionError("K1 replay: a block stops before its winner")
    run = torch.arange(n_u, device=dev)[None] < visited[:, None] * ch
    n_clusters = tri_id.shape[0]
    real = torch.cat([(tri_id >= 0).sum(dim=1),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    tris = torch.where(run, real[u_idx.long()], 0).sum(dim=1)
    tests = int((tris * live.sum(dim=1)).sum())
    read = u_idx[run & (u_idx < n_clusters)]
    return tests, int(torch.unique(read).numel())


def first_hit_chunk(args, t_min: float, chunk: int):
    """int64[NB, B]: the first chunk in which each ray has an any-hit
    (t_min < t < t_max), or the chunk count; every chunk of every block is
    tested, in groups of blocks as the plain tracer takes them."""
    u_idx, o, d, t_max, soup, n_valid, _ = args
    nb, n_u = u_idx.shape
    b = o.shape[1]
    k = soup.shape[-1]
    ch = tb.chunk_width(chunk, n_u, k)
    nct = n_u // ch
    w = ch * k
    first = torch.full((nb, b), nct, dtype=torch.int64, device=o.device)
    step = max(1, tb._PLAIN_CHUNK // max(b * w, 1))
    for s in range(0, nb, step):
        sl = slice(s, s + step)
        g = u_idx[sl].shape[0]
        rox, roy, roz = (o[sl][..., c][..., None] for c in range(3))
        rdx, rdy, rdz = (d[sl][..., c][..., None] for c in range(3))
        rtm = t_max[sl][..., None]
        n_chunks = (n_valid[sl] + ch - 1) // ch
        for j in range(int(n_chunks.max()) if g else 0):
            rows = soup[u_idx[sl][:, j * ch:(j + 1) * ch].long()]
            rows = rows.permute(0, 2, 1, 3).reshape(g, SOUP_ROWS, 1, w)
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = rows.unbind(1)
            px = rdy * e2z - rdz * e2y
            py = rdz * e2x - rdx * e2z
            pz = rdx * e2y - rdy * e2x
            det = px * e1x + py * e1y + pz * e1z
            inv = torch.where(det.abs() > 1e-9, 1.0 / det, 0.0)
            tx = rox - v0x
            ty = roy - v0y
            tz = roz - v0z
            uu = (tx * px + ty * py + tz * pz) * inv
            qx = ty * e1z - tz * e1y
            qy = tz * e1x - tx * e1z
            qz = tx * e1y - ty * e1x
            vv = (rdx * qx + rdy * qy + rdz * qz) * inv
            tt = (e2x * qx + e2y * qy + e2z * qz) * inv
            hit = ((uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                   & (tt > t_min) & (tt < rtm)).any(dim=-1)
            hit = hit & (j < n_chunks)[:, None]
            first[sl] = torch.where(hit & (first[sl] == nct), j, first[sl])
    return first


def k1_any_work(args, t_min: float, chunk: int, tri_id):
    """The least work one any-hit K1 call needs on these inputs: (ray-
    triangle tests, distinct clusters read).  The chunk of each ray's first
    hit comes from `first_hit_chunk`; the block's early exit is then
    replayed from it: a block stops after chunk j once no live lane is open
    or the next entry lies beyond every open lane's t_max.  A live lane
    tests the real triangles of each visited chunk before its first hit,
    and at least one test in that chunk (where in the chunk it stops is not
    counted, so the bound stays low)."""
    u_idx, _, _, tm, soup, n_valid, entry = args
    dev = tm.device
    n_u = u_idx.shape[1]
    ch = tb.chunk_width(chunk, n_u, soup.shape[-1])
    nct = n_u // ch
    live = tm > 0.0
    first = first_hit_chunk(args, t_min, chunk)
    j = torch.arange(nct, device=dev)
    open_after = live[..., None] & (first[..., None] > j)       # [NB, B, J]
    rem_tmax = torch.where(open_after, tm[..., None], 0.0).amax(dim=1)
    nxt = torch.where((j[None] + 1) * ch < n_valid[:, None],
                      entry[:, torch.clamp_max(j + 1, nct - 1) * ch], BIG)
    stop = ~open_after.any(dim=1) | (nxt > rem_tmax)
    visited = torch.minimum(torch.where(stop, j[None], nct).amin(dim=1) + 1,
                            (n_valid.long() + ch - 1) // ch)
    n_clusters = tri_id.shape[0]
    real = torch.cat([(tri_id >= 0).sum(dim=1),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    per_chunk = real[u_idx.long()].reshape(-1, nct, ch).sum(dim=2)
    cum = torch.cat([torch.zeros_like(per_chunk[:, :1]),
                     per_chunk.cumsum(dim=1)], dim=1)          # [NB, J + 1]
    upto = torch.minimum(first, visited[:, None])
    full = torch.gather(cum, 1, upto)
    tests = int(torch.where(live, full + (first < visited[:, None]).long(),
                            0).sum())
    run = torch.arange(n_u, device=dev)[None] < visited[:, None] * ch
    read = u_idx[run & (u_idx < n_clusters)]
    return tests, int(torch.unique(read).numel())


def k1_bytes(args, any_hit: bool, n_clusters_read: int) -> int:
    """Bytes of one K1 call's bound (chip_smoke.py::k1_call_stats): o, d,
    t_max in and the results out a lane, the candidate lists and entries,
    n_valid, and the soup of the distinct clusters read, once."""
    u_idx, o_b, _, _, soup_b, _, _ = args
    nb, blk = o_b.shape[0], o_b.shape[1]
    return (nb * blk * (12 + 12 + 4 + (1 if any_hit else 8))
            + u_idx.numel() * 8 + nb * 4
            + n_clusters_read * soup_b[0].numel() * 4)
