"""Ring ray exchange between the ranks of a mesh axis (port of
`parallel/exchange.py`).

Under tile sharding the ranks' bounce workloads diverge: a tile of sky
finishes early while a tile of geometry keeps full blocks busy.  Every rank
sends the same-size tail slab of its (detached) rays one step round the
ring, traces what it received behind its own head rays, and sends the
slab's results back by the inverse step.  Tracing is a pure function of
each ray, so the exchange is invisible in the result.

In the reference the ring is `jax.lax.ppermute` inside `shard_map`.  Here
each rank is a process: one paired `isend`/`irecv` (`batch_isend_irecv`)
with ranks (r + 1) mod n and (r - 1) mod n of the axis' process group; at
n = 1 the shift is the identity, as `ppermute` is.  The integrator finds
the group by the axis name in `RenderConfig.exchange_axis`, on the mesh
bound by `on_mesh` (which `render_sample_sharded(exchange=True)` does).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist

_MESH: contextvars.ContextVar = contextvars.ContextVar("pbr_ring_mesh",
                                                       default=None)


@contextlib.contextmanager
def on_mesh(mesh):
    """Bind `mesh` (a DeviceMesh) for the exchange inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def axis_group(axis: str):
    """The process group of `axis` on the bound mesh."""
    mesh = _MESH.get()
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"exchange_axis {axis!r} names no axis of a bound mesh: the "
            "ring exchange runs inside render_sample_sharded(exchange=True)")
    return mesh.get_group(axis)


def _ring_shift(xs: list[torch.Tensor], group, shift: int) -> list:
    """Each tensor of `xs` from rank r to rank (r + shift) mod n of
    `group`; returns what arrived from rank (r - shift) mod n."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(xs)
    r = dist.get_rank(group)
    to = dist.get_global_rank(group, (r + shift) % n)
    frm = dist.get_global_rank(group, (r - shift) % n)
    sent = [x.contiguous() for x in xs]
    got = [torch.empty_like(x) for x in sent]
    ops = ([dist.P2POp(dist.isend, x, to, group) for x in sent]
           + [dist.P2POp(dist.irecv, y, frm, group) for y in got])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return got


def _fields(res):
    """(tensors, rebuild) of a trace result: a tensor or a dataclass of
    tensors (ops.intersect.Hit)."""
    if isinstance(res, torch.Tensor):
        return [res], lambda ts: ts[0]
    names = [f.name for f in dataclasses.fields(res)]
    return ([getattr(res, k) for k in names],
            lambda ts: dataclasses.replace(res, **dict(zip(names, ts))))


def with_ring_exchange(trace, o, d, t_max, group, frac: float = 0.25):
    """Run `trace(o, d, t_max)` (-> a tensor or a Hit over the N rays) with
    the tail `frac` of the rays traced by the next rank of `group`; the
    results come back in the caller's order.  The rays are detached: no
    gradient crosses ranks here (the train step all-reduces parameter
    gradients instead).  Every rank must pass the same N."""
    n_loc = o.shape[0]
    m = max(1, int(n_loc * frac))
    cut = n_loc - m
    o, d, t_max = o.detach(), d.detach(), t_max.detach()
    tails = _ring_shift([o[cut:], d[cut:], t_max[cut:]], group, 1)
    res = trace(torch.cat([o[:cut], tails[0]]),
                torch.cat([d[:cut], tails[1]]),
                torch.cat([t_max[:cut], tails[2]]))
    ts, rebuild = _fields(res)
    back = _ring_shift([t[cut:] for t in ts], group, -1)
    return rebuild([torch.cat([t[:cut], b]) for t, b in zip(ts, back)])
