"""Faults planted under the timed path, for the tests that see `correct`
come out false (tests/test_benchmark_faults.py) and for the readings of a
training cell's faults (calibrate.py --fault).  Each is a context manager
that patches the program (`harness.port.PACKAGE`) while it is entered.

Frames (the `frames` loop):
  unchanged  every frame returns the first frame's film: the state never
             advances;
  half       half of the samples are left out, the film scaled to the
             full count (the mean taken over the rest);
  altered    each frame's answer is altered where it is produced: it is
             rendered from another key than the frame's.
Steps (the `fit` loop):
  unchanged  the step computes its loss and leaves the parameters as they
             were;
  half       the loss is the mean over half of the image's rows;
  altered    the image the loss is taken of is rendered from another key.
The exchange between chips is not a fault a one-chip cell can have.
"""

from __future__ import annotations

import contextlib
import dataclasses

from harness import port

FAULTS = ("unchanged", "half", "altered")


def _other_key(key):
    return key ^ 0x5A5A5A5A


@contextlib.contextmanager
def _patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def frames(kind: str):
    path = port.module("integrator.path")

    def make(real):
        first = {}

        def call(scene, camera, key, cfg):
            if kind == "unchanged":
                if "out" not in first:
                    first["out"] = real(scene, camera, key, cfg)
                return first["out"]
            if kind == "half":
                film, count = real(scene, camera, key,
                                   dataclasses.replace(cfg, spp=cfg.spp // 2))
                scale = cfg.spp / (cfg.spp // 2)
                return dataclasses.replace(film, hdr=film.hdr * scale,
                                           spp=float(cfg.spp)), count
            return real(scene, camera, _other_key(key), cfg)
        return call
    return _patched(path, "render_with_stats", make)


@contextlib.contextmanager
def steps(kind: str):
    inverse = port.module("grad.inverse")
    if kind == "half":
        def make(real):
            return lambda hdr, target: real(hdr[: hdr.shape[0] // 2],
                                            target[: target.shape[0] // 2])
        with _patched(inverse, "pixel_loss", make):
            yield
    elif kind == "altered":
        def make(real):
            return lambda scene, camera, key, cfg: real(
                scene, camera, _other_key(key), cfg)
        with _patched(inverse, "render", make):
            yield
    else:
        def make(real):
            def build(scene, camera, cfg, optimizer, **kw):
                step = real(scene, camera, cfg, optimizer, **kw)

                def frozen(params, opt_state, key, target):
                    before = [v.detach().clone() for v in params.leaves()]
                    out = step(params, opt_state, key, target)
                    import torch
                    with torch.no_grad():
                        for v, b in zip(params.leaves(), before):
                            v.copy_(b)
                    return out
                return frozen
            return build
        with _patched(inverse, "make_train_step", make):
            yield


def planted(loop: str, kind: str):
    return (frames if loop == "frames" else steps)(kind)
