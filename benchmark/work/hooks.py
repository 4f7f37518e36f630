"""Counts the work of the port's kernels on the reference's own calls.

While the reference renders a unit (a frame or a step) that a traced run
profiled, `Recorder.unit(offset)` wraps the reference's plain K1 (as
ops/blocktrace.py calls it), K2, K5a and K5b, and, for a frame that the
dispatch gives the whole-frame kernel, counts K4's work on that frame.
Each call's least time (`harness.peaks.bound_s`) is kept by kernel and by
the unit's offset in the traced stretch.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

from harness.peaks import MT_FLOPS, bound_s
from reference.pbr_plain.integrator import path
from reference.pbr_plain.ops import blocktrace, fused, gather, resident

from . import counts, k1


class Recorder:
    def __init__(self, scene, cfg):
        self.tri_id = (scene.clusters.tri_id if scene.clusters is not None
                       else None)
        self.cfg = cfg
        self.bounds = defaultdict(lambda: defaultdict(list))  # kernel->unit
        self.notes = []
        self._unit = None

    def _add(self, kernel: str, seconds: float) -> None:
        self.bounds[kernel][self._unit].append(seconds)

    # -- the wrapped calls -------------------------------------------------
    def _k1(self, real):
        def call(u_idx, o, d, t_max, soup, n_valid, entry, *, t_min,
                 any_hit, chunk=4):
            args = (u_idx, o, d, t_max, soup, n_valid, entry)
            out = real(*args, t_min=t_min, any_hit=any_hit, chunk=chunk)
            if any_hit:
                n_tests, n_read = k1.k1_any_work(args, t_min, chunk,
                                                 self.tri_id)
            else:
                n_tests, n_read = k1.k1_work(args, *out, chunk, self.tri_id)
            self._add("k1", bound_s(k1.k1_bytes(args, any_hit, n_read),
                                    n_tests * MT_FLOPS))
            return out
        return call

    def _k2(self, real):
        def call(soup, o, d, t_max, t_min, any_hit):
            n_tests = counts.resident_work(soup, o, d, t_max, t_min, any_hit)
            n = o.shape[0]
            n_bytes = n * (12 + 12 + 4 + (1 if any_hit else 8)) + (
                soup.numel() * 4)
            self._add("k2", bound_s(n_bytes, n_tests * MT_FLOPS))
            return real(soup, o, d, t_max, t_min, any_hit)
        return call

    def _k5a(self, real):
        def call(table, idx):
            n, (t, w) = idx.shape[0], table.shape
            if n and w:
                ok = idx[(idx >= 0) & (idx < t)]
                rows = torch.unique(ok).numel()
                self._add("k5a", bound_s(
                    n * w * 4 + n * idx.element_size() + rows * w * 4, 0))
            return real(table, idx)
        return call

    def _k5b(self, real):
        def call(idx, ct, t):
            n, w = ct.shape
            if n and w and t:
                self._add("k5b", bound_s(
                    n * w * 4 + n * idx.element_size() + t * w * 4, 0))
            return real(idx, ct, t)
        return call

    @contextlib.contextmanager
    def unit(self, offset: int, scene=None, camera=None, key=None):
        """Record the work of the calls made inside, as unit `offset` of the
        traced stretch.  With (scene, camera, key) of a frame that takes the
        whole-frame kernel, K4's work on that frame is counted too."""
        patches = [(blocktrace, "trace_blocks", self._k1),
                   (resident, "trace", self._k2),
                   (gather, "gather_fwd", self._k5a),
                   (gather, "gather_bwd", self._k5b)]
        saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
        self._unit = offset
        for m, n, wrap in patches:
            setattr(m, n, wrap(getattr(m, n)))
        try:
            yield
        finally:
            for m, n, real in saved:
                setattr(m, n, real)
        if scene is not None and path._use_fused(scene, self.cfg):
            frame = fused.fused_frame(scene, camera, key, self.cfg)
            w = counts.fused_work(frame)
            self._add("k4", bound_s(frame.width * frame.height * 3 * 4,
                                    w["tests"] * MT_FLOPS))
        self._unit = None

    def totals(self) -> dict:
        """{kernel: {unit offset: [bound seconds of each call]}}."""
        return {k: dict(v) for k, v in self.bounds.items()}
