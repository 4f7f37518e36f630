"""The viewer's frame loop (`frames.py`, its logic unchanged) on a scene
that the frozen reference cannot build by name.

The configuration's `reference_scene` names a module of the benchmark
(`reference.spd_tetra`) with a function of the scene's name that builds
the scene from the reference's own generator and `reference/pbr_plain`.
While set-up and the check run, the reference's `scene.procedural` answers
that name with it, so `harness/scenes.py` builds the reference's scene as
it builds any other: for the check, and for the program's set-up where the
control (calibrate.py) puts the reference in the program's place.  A
program without the scene's function fails at the start of set-up, before
its kernels load.
"""

from __future__ import annotations

import contextlib
import importlib

from harness import bench, port, scenes

frames = bench.load_module(bench.HERE / "loops" / "frames.py",
                           "bench_loop_frames")


class Run(frames.Run):
    def setup(self):
        with _reference_scene(self.config):
            getattr(port.module("scene.procedural"),
                    self.config["scene"]["function"])
            super().setup()

    def check(self):
        with _reference_scene(self.config):
            return super().check()


@contextlib.contextmanager
def _reference_scene(config):
    """The reference's `scene.procedural` holds the configuration's scene
    function, from the module `config["reference_scene"]`, while entered."""
    procedural = importlib.import_module(
        f"{scenes.REFERENCE}.scene.procedural")
    name = config["scene"]["function"]
    generator = importlib.import_module(config["reference_scene"])
    setattr(procedural, name, getattr(generator, name))
    try:
        yield
    finally:
        delattr(procedural, name)
