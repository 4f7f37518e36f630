"""physically_based_renderer_tpu_torch: the PyTorch/CUDA port of the path tracer.

The reference package beside this one (same name without `_torch`) is the
reference; every module here mirrors the reference module of the same name
(`core/`, `scene/`, `ops/`, `models/`, `integrator/`, `grad/`, `utils/`,
`apps/`), so each function's counterpart is easy to find.  This package
imports torch and numpy only.

Conventions:
    * plain functions on tensors, frozen dataclasses for records;
    * the device comes from the scene (`scene.types.upload_scene`);
    * random numbers are the reference's threefry streams, bit for bit
      (`core/rng.py`), so a port image and a reference image drawn from the
      same seed compare pixel by pixel;
    * every kernel lives in `ops/` beside its plain-torch version: a CUDA
      tensor launches the hand-written kernel (sources in `csrc/`) or
      raises; the plain version runs only for CPU tensors.
"""

__version__ = "0.1.0"

from .core.camera import Camera  # noqa: F401
from .core.film import Film  # noqa: F401
from .grad.inverse import (TrainableParams, fit,  # noqa: F401
                           make_train_step)
from .integrator.path import (RenderConfig, render,  # noqa: F401
                              render_with_stats)
from .scene.types import Scene, make_scene, upload_scene  # noqa: F401
