# Frozen copy of physically_based_renderer_tpu_torch/core/morton.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""Static morton (Z-order) pixel permutations (port of `core/morton.py`).

The block tracer (ops/blocktrace.py) culls candidate clusters per block of
consecutive rays, so its work follows the union of clusters a block's ray
bundle pierces.  In morton order a 256-ray block is a compact 16x16 tile
instead of half an image row.  Host-side numpy, cached per shape.
"""

from __future__ import annotations

import functools

import numpy as np


def _part1by1(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32) & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def morton_codes(ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """Interleaved-bit Z-order code per (y, x); works for any extent."""
    return (_part1by1(ys) << 1) | _part1by1(xs)


@functools.lru_cache(maxsize=32)
def morton_pixel_ids(height: int, width: int, row_start: int = 0,
                     n_rows: int | None = None) -> np.ndarray:
    """Global pixel ids (y * width + x) of a row band, morton-sorted within
    the band: i32[n_rows * width].  Only the processing order changes; the
    per-ray RNG keys still derive from the global ids."""
    if n_rows is None:
        n_rows = height
    yy, xx = np.mgrid[0:n_rows, 0:width]
    yy, xx = yy.ravel(), xx.ravel()
    order = np.argsort(morton_codes(yy, xx), kind="stable")
    gids = (yy + row_start) * width + xx
    return gids[order].astype(np.int32)
