"""Inputs the benchmark makes from --seed, the same for the program and
the reference: frame and step keys, a fit's start.

A key is the threefry word pair both packages take (int64[2], each word
32 bits).  A seed may exceed 32 bits, so a key's words are those
of a 64-bit hash of (seed, stream, index), not `key(seed)`.
"""

from __future__ import annotations

import math
import random

MASK64 = (1 << 64) - 1


def _mix(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def key_words(seed: int, stream: int, index: int) -> tuple[int, int]:
    h = _mix(_mix(_mix(seed & MASK64) ^ stream) ^ index)
    return h >> 32, h & 0xFFFFFFFF


def key(seed: int, stream: int, index: int, device):
    import torch
    return torch.tensor(key_words(seed, stream, index), dtype=torch.int64,
                        device=device)


# Streams of keys.
FRAME, STEP, TARGET, WARM = 1, 2, 3, 4


def rng(seed: int, purpose: str) -> random.Random:
    """A host generator for one purpose (the samples to check)."""
    return random.Random(f"{seed}/{purpose}")


def perturbation(seed: int, shapes: list, scale: float, device) -> list:
    """Uniform noise in [-scale, scale) for each trained field, drawn on
    the device from the seed in one call."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed & MASK64)
    sizes = [math.prod(s) for s in shapes]
    u = torch.rand(sum(sizes), generator=g, device=device)
    u = (u * 2.0 - 1.0) * scale
    out, at = [], 0
    for s, n in zip(shapes, sizes):
        out.append(u[at:at + n].reshape(s))
        at += n
    return out
