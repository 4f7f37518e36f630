"""The card a run measures, and the refusal to measure without one."""

from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "physically_based_renderer_tpu")


def require_cards(n: int) -> None:
    """Exit 2 before any result when torch sees no CUDA card or fewer
    than the cell asks for: a run never falls back to the CPU."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("error: torch.cuda.is_available() is False; the benchmark "
                 "measures the card and does not run on the CPU")
    if torch.cuda.device_count() < n:
        sys.exit(f"error: the cell asks for {n} cards, torch sees "
                 f"{torch.cuda.device_count()}")


def power_line() -> str:
    """`name, power.limit` as nvidia-smi prints them, or why it could not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.stdout.strip().splitlines()[0]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
