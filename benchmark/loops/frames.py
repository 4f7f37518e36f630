"""The viewer's frame loop: `render_with_stats`, then K3's tonemap as the
render CLI calls it, and the LDR image copied to the host, one frame at a
time (a closed loop).

The mix's file sets: `render` (overrides of the configuration's render
settings: size, spp), `accumulate`
(tonemap the running mean of all films so far), `warm_units` (frames
rendered in set-up, from keys the window never uses), `check_units`
(frames drawn from the seed, by reservoir, whose films the reference
renders again after the window) and `profile` ({"first", "units"}: the
frames a traced run profiles; it then checks frames of that stretch).
Each frame's key is a hash of (seed, frame index).
"""

from __future__ import annotations

import contextlib
import importlib
import statistics
import time

from harness import compare, inputs, port, scenes

REF = scenes.REFERENCE


class Run:
    def __init__(self, ctx):
        self.ctx = ctx
        self.config = ctx.cell.config
        self.mix = ctx.cell.traffic
        self.settings = {**self.config["render"], **self.mix.get("render", {}),
                         **ctx.scale}
        self.rng = inputs.rng(ctx.seed, "check")
        self.kept = []          # (frame, hdr sum, count, ldr, image tonemapped)
        self.eligible = 0
        self.acc = None
        self.n_acc = 0
        prof = self.mix["profile"]
        self.p0, self.pn = prof["first"], prof["units"]
        self.min_units = self.p0 + self.pn if ctx.tracer.on else 1

    # -- the program -------------------------------------------------------
    def setup(self):
        import torch
        ctx = self.ctx
        dev = ctx.device
        port.load_kernels(dev)
        ctx.phase("kernel library")
        self.path = port.module("integrator.path")
        self.tonemap = port.module("ops.tonemap").tonemap
        self.cfg = self.path.RenderConfig(**self.settings)
        self.scene, self.cam = scenes.build(port.PACKAGE, self.config, dev,
                                            ctx.spans)
        ctx.phase("scene")
        for w in range(self.mix["warm_units"]):
            self._frame(w, key_stream=inputs.WARM)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.acc, self.n_acc = None, 0
        ctx.phase("warm frames")

    def _key(self, i, stream=inputs.FRAME):
        return inputs.key(self.ctx.seed, stream, i, self.ctx.device)

    def _frame(self, i, key_stream=inputs.FRAME):
        film, count = self.path.render_with_stats(
            self.scene, self.cam, self._key(i, key_stream), self.cfg)
        if self.mix["accumulate"]:
            self.acc = film.hdr if self.acc is None else self.acc + film.hdr
            self.n_acc += self.cfg.spp
            img = self.acc / self.n_acc
        else:
            img = film.mean()
        ldr = self.tonemap(img.contiguous()).cpu()
        return film.hdr, count, ldr, img

    def unit(self, i):
        tracer = self.ctx.tracer
        if tracer.on and i == self.p0:
            tracer.start()
        hdr, count, ldr, img = self._frame(i)
        if not tracer.on or self.p0 <= i < self.p0 + self.pn:
            self._keep(i, hdr, count, ldr, img)
        if tracer.on and i == self.p0 + self.pn - 1:
            tracer.stop(self.pn)

    def _keep(self, i, hdr, count, ldr, img):
        """Reservoir sample of `check_units` frames, drawn from the seed."""
        k = self.mix["check_units"]
        self.eligible += 1
        item = (i, hdr, count, ldr, img if self.mix["accumulate"] else None)
        if len(self.kept) < k:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.eligible)
            if j < k:
                self.kept[j] = item

    def e2e(self, window_s, lat):
        p95 = (statistics.quantiles(lat, n=100, method="inclusive")[94]
               if len(lat) > 1 else lat[0])
        return {"frame_ms": window_s / len(lat) * 1e3,
                "frame_p95_ms": p95 * 1e3}

    def release(self):
        if self.ctx.tracer.on and self.ctx.tracer.stretch is None:
            raise RuntimeError(f"the window ended before the traced frames "
                               f"{self.p0}..{self.p0 + self.pn - 1}")
        for name in ("scene", "cam", "path", "tonemap", "acc"):
            setattr(self, name, None)
        self.kept = [(i, h.cpu(), int(c), ldr, None if img is None
                      else img.cpu()) for i, h, c, ldr, img in self.kept]
        _empty_cache(self.ctx.device)

    # -- the reference -----------------------------------------------------
    def check(self):
        import torch
        ctx = self.ctx
        dev = ctx.device
        path = importlib.import_module(f"{REF}.integrator.path")
        tonemap = importlib.import_module(f"{REF}.ops.tonemap").tonemap
        scene, cam = scenes.build(REF, self.config, dev)
        cfg = path.RenderConfig(**self.settings)
        work = {}
        hooks = None
        if ctx.tracer.on:
            from work import hooks as hooks_mod
            hooks = hooks_mod.Recorder(scene, cfg)
        rows, notes = [], []
        t = time.perf_counter()
        for i, hdr, count, ldr, img in sorted(self.kept, key=lambda x: x[0]):
            key = self._key(i)
            with (hooks.unit(i - self.p0, scene, cam, key)
                  if hooks else contextlib.nullcontext()):
                film, count_r = path.render_with_stats(scene, cam, key, cfg)
            hdr_r = film.hdr.cpu()
            if img is None:
                ldr_r = tonemap(film.mean().contiguous()).cpu()
            else:
                # The running mean is the harness's own sum of the
                # program's films; the reference tonemaps that same image.
                ldr_r = tonemap(img.to(dev).contiguous()).cpu()
            rows.append(compare.image_numbers(
                hdr / cfg.spp, hdr_r / cfg.spp, ldr, ldr_r, count,
                int(count_r)))
            notes.append(f"frame {i}: ray queries {count} (reference "
                         f"{int(count_r)}), " + ", ".join(
                             f"{k} {v}" for k, v in rows[-1].items()))
        notes.append(f"reference: {len(rows)} frames in "
                     f"{time.perf_counter() - t:.3f} s")
        if hooks:
            work = hooks.totals()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return compare.worst(rows), work, notes


def _empty_cache(dev):
    import gc

    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
