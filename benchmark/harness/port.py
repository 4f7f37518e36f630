"""What the benchmark takes from the program: the package, its kernel
library, and its launch counters with the names of the kernels they count.
"""

from __future__ import annotations

import importlib

PACKAGE = "physically_based_renderer_tpu_torch"

# Launch counter (module, attribute) -> the part of the kernel's name that
# the profiler shows (`csrc/*.cu`).
COUNTERS = {
    ("ops.trace_blocks", "LAUNCHES"): "trace_blocks_kernel",
    ("ops.resident", "LAUNCHES"): "resident_kernel",
    ("ops.tonemap", "LAUNCHES"): "tonemap_kernel",
    ("ops.fused", "LAUNCHES"): "fused_kernel",
    ("ops.gather", "LAUNCHES_FWD"): "gather_fwd_kernel",
    ("ops.gather", "LAUNCHES_BWD"): "gather_bwd_kernel",
}


def module(name: str):
    """`physically_based_renderer_tpu_torch.<name>`."""
    return importlib.import_module(f"{PACKAGE}.{name}")


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load the kernel library, so that
    set-up pays for it and the window does not."""
    if device.type == "cuda":
        module("ops.cuda_lib").library()


def counters() -> dict:
    """{kernel name part: launches so far}."""
    return {part: getattr(module(mod), attr)
            for (mod, attr), part in COUNTERS.items()}
