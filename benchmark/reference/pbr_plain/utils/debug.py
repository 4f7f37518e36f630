# Frozen copy of physically_based_renderer_tpu_torch/utils/debug.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""Runtime validation, `--debug-checks` (port of `utils/debug.py`).

`checked_render` renders with index checks on and then checks that the
film is finite.  It pins the tracer to `bvh` when the scene has a BVH,
else `brute`, renders through `integrator.path.render` on the scene's
device (the reference moves its render to the host CPU, a workaround for
its TPU plugin) and raises `NonFiniteRenderError` when NaN or Inf reached
the film, `IndexCheckError` when a gather read outside its table.

The index checks are the counterpart of the reference's
`checkify.index_checks`, which flags every gather of the render whose
index it does not clip.  Inside `index_checks()` each such site of the
dense path calls `check_index(site, idx, size)`: it records on the device
whether any index lies outside [0, size) and the first that does, and
hands back the index clipped into range, so the render completes (on the
card an out-of-range index would stop the device) and gathers what the
reference's clamping gather reads.  One copy to the host after the
render reads every record.  Outside the context `check_index` returns
its index untouched and launches nothing.  The sites:

  vertex ids        geometry.indices into the vertex arrays (the corner
                    gathers of `pack_tri_attrs`, `tri_vertices`, the
                    emitter table and the BVH's triangles)
  material ids      tri_material into the material tables (`pack_tri_attrs`,
                    the emitter table)
  texture ids       a material's texture ids into the texture metadata
                    (`pack_tri_attrs`, the emissive texture of NEE)
  emitter triangles emitters.tri_idx into the triangles
  emitter alias     the slot into the emitter alias table
  env alias         the slot into the env alias table, and the texel it
                    picks into the map and its pdf
  bvh nodes         a popped node into the node table, and an inner
                    node's children into the boxes
  bvh triangles     tri_order into the triangles

Not flagged, as in the reference: `take_rows` (K5a), which clips and
fills by design, and the gathers whose index is clipped first (the BVH
leaf's triangle range, texture texels, the env pdf and radiance lookups
of escaped rays).  One divergence: the reference's walk also gathers the
boxes of a leaf's "children" (its triangle start and count), unused, and
checkify flags them where the count reaches the node count (a BVH whose
root is a leaf); the port checks inner nodes' children only.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


class NonFiniteRenderError(FloatingPointError):
    """The rendered film contains NaN/Inf radiance."""


class IndexCheckError(IndexError):
    """A gather of the render read outside its table."""

    def __init__(self, site: str, index: int, size: int):
        super().__init__(f"out-of-bounds gather at {site}: index {index} is "
                         f"out of bounds for a table of size {size}")
        self.site, self.index, self.size = site, index, size


# The records of the open `index_checks()` context, None outside it:
# (site, size, any-bad flag, first bad index), the last two on the device.
_records: list | None = None


def check_index(site: str, idx: torch.Tensor, size: int,
                skip: torch.Tensor | None = None) -> torch.Tensor:
    """Inside `index_checks()`: record whether idx leaves [0, size) (except
    where `skip`, broadcast to idx, is true) and return it clipped into
    range.  Outside: return idx untouched."""
    if _records is None or idx.numel() == 0:
        return idx
    bad = (idx < 0) | (idx >= size)
    if skip is not None:
        bad = bad & ~skip
    bad = bad.reshape(-1)
    first = idx.reshape(-1)[bad.to(torch.uint8).argmax()]
    _records.append((site, size, bad.any(), first))
    return idx.clamp(0, max(size - 1, 0))


@contextlib.contextmanager
def index_checks():
    """Turn the index checks on for the render inside; on a clean exit read
    every record with one copy to the host and raise IndexCheckError for
    the first site (in the order the render reached them) that read out
    of range."""
    global _records
    if _records is not None:
        raise RuntimeError("index_checks() does not nest")
    _records = records = []
    try:
        yield records
    finally:
        _records = None
    if not records:
        return
    flags = torch.stack([torch.stack([r[2].to(torch.int64),
                                      r[3].to(torch.int64)])
                         for r in records]).tolist()
    for (site, size, _, _), (bad, first) in zip(records, flags):
        if bad:
            raise IndexCheckError(site, first, size)


def checked_render(scene, camera, key, cfg):
    """Render with index checks on, then check that the film is finite ->
    the Film.  Raises IndexCheckError or NonFiniteRenderError."""
    from ..integrator.path import render
    cfg = dataclasses.replace(
        cfg, tracer="bvh" if scene.bvh is not None else "brute")
    with torch.no_grad(), index_checks():
        film = render(scene, camera, key, cfg)
    finite = torch.isfinite(film.hdr)
    if not bool(finite.all()):
        bad = int((~finite).sum())
        raise NonFiniteRenderError(
            f"rendered film contains {bad} non-finite value(s) "
            "(NaN/Inf radiance reached the output)")
    return film
