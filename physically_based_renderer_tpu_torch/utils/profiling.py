"""Profiling and observability (port of `utils/profiling.py`).

Host-clock section timers that wait for the card, a rays/s meter (the
headless counterpart of a frame-time overlay), and `device_trace`, which
records a torch.profiler trace (CPU and, where a card is in use, CUDA
activity) and writes it as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
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
    Yields the profiler; its `key_averages()` tabulate the kernels."""
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


class RaysPerSecond:
    """Running rays/s meter."""

    def __init__(self):
        self.rays = 0.0
        self.seconds = 0.0

    def add(self, rays: float, seconds: float) -> None:
        self.rays += float(rays)
        self.seconds += float(seconds)

    @property
    def value(self) -> float:
        return self.rays / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return json.dumps({"rays": self.rays, "seconds": self.seconds,
                           "rays_per_s": self.value})
