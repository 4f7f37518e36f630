"""Profiling and observability (port of `utils/profiling.py`).

- `timed`: a host-clock section timer that waits for the card.
- `device_trace`: records a torch.profiler trace (CPU and, where a card
  is in use, CUDA activity) and writes it as a Chrome trace.
- `span`: the program's named stretches in that trace, on the
  profiler's clock; a flag read when no profiler records.  Every name
  starts with `pbr.`:

      pbr.frame             integrator/path.py::render_with_stats
      pbr.frame.capture     integrator/frame_graph.py: the dense frame
                            captured as a CUDA graph
      pbr.frame.replay      the same: a replay, its input and output
                            copies
      pbr.k4.seeds          ops/fused.py::fused_frame, the seed words
      pbr.k4.pack           ops/fused.py::fused_frame, the tables
      pbr.tonemap           ops/tonemap.py::tonemap
      pbr.step              grad/inverse.py::make_train_step's step
      pbr.step.forward      its loss
      pbr.step.backward     its loss.backward()
      pbr.rng               core/rng.py: fold_in, split, ray_keys,
                            ray_uniform
      pbr.trace.phase_a     ops/blocktrace.py::intersect_blocks_pallas:
                            root cull, octant sort, candidate selection
                            and K1's inputs, a tracer call
      pbr.trace.k1          the same call's K1 launch and winner decode
"""

from __future__ import annotations

import contextlib
import logging
import time
from pathlib import Path

import torch

logger = logging.getLogger("pbr_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter(
        "[%(asctime)s] [%(name)s] [%(levelname)s] %(message)s",
        datefmt="%H:%M:%S"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

# True while a torch.profiler session records (a C flag read, ~0.1 us).
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(name: str, sync: bool = True):
    """Host-clock section timer, logged as `name: seconds`.  With sync it
    waits for the card's queued work before it starts and before it
    stops, so the time covers the section's device work."""
    if sync:
        _sync()
    t0 = time.perf_counter()
    yield
    if sync:
        _sync()
    logger.info("%s: %.3fs", name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(logdir):
    """Record the section with torch.profiler and write the Chrome trace
    `<logdir>/trace.json` (open it in chrome://tracing or Perfetto).
    Yields the profiler; its `key_averages()` tabulate the kernels beside
    each span's device-side range, which `tools/timing.py::kernels`
    leaves out."""
    from torch.profiler import ProfilerActivity, profile
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(str(out / "trace.json"))


def span(name: str):
    """The section as `name` in the profiler's trace: a `record_function`
    while a profiler records, else one shared no-op context manager.

    Names start with `pbr.`, never with `cu` (the benchmark's trace
    reader takes host events named `cu*` for runtime calls)."""
    if _profiling():
        return torch.profiler.record_function(name)
    return _OFF

