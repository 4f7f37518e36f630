"""Counter-based RNG: the reference's threefry streams, bit for bit.

Port of the reference's `core/rng.py`.  The reference keys every random
decision by (frame seed, sample, pixel, bounce, stream) through its
framework's threefry-2x32 random API in the partitionable scheme (the
default of the pinned framework version, 0.9.0).  This module reproduces
that scheme exactly, so a port render and a reference render from the same
seed draw the same numbers:

    key(seed)        -> (seed >> 32, seed & 0xFFFFFFFF)
    split(k, n)[i]   -> threefry2x32(k, (0, i))           (both words)
    fold_in(k, x)    -> threefry2x32(k, (0, x))           (both words)
    bits(k, m)[j]    -> w0 ^ w1 of threefry2x32(k, (0, j))
    uniform(k, m)[j] -> f32 from the top 23 bits: ((bits >> 9) | 1.0f) - 1

A key is an explicit uint32 pair carried in an int64 tensor [..., 2], each
word masked to 32 bits (torch's uint32 arithmetic is thin).  There is no
global generator.  On the card each threefry is about 170 elementwise
launches, the largest share of a frame's time (PERF.md); a fused kernel
for it is later work.  Under a profiler each call of `fold_in`, `split`,
`ray_keys` or `ray_uniform` is the span `pbr.rng`; they reach one another
through `_fold_in`, so the span never nests in itself.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

# Stream ids: disjoint random streams per decision point within one bounce.
STREAM_PIXEL_JITTER = 0
STREAM_BSDF = 1
STREAM_LIGHT = 2
STREAM_RR = 3  # Russian roulette

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 words held in int64 tensors.

    All four arguments broadcast; returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The reference's `key(seed)` as an int64[2] word pair.

    Like the reference (32-bit seeds, x64 off), the high word is 0 and the
    low word is the seed's two's-complement bits.
    """
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _counts(data, like: torch.Tensor) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device=like.device, dtype=torch.int64) & MASK
    return torch.tensor(int(data) & MASK, dtype=torch.int64,
                        device=like.device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """The reference's `fold_in` over a key batch [..., 2]; `data` is an int or
    an integer tensor broadcastable to the batch shape."""
    with span("pbr.rng"):
        return _fold_in(keys, data)


def _fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    x1 = _counts(data, keys)
    w0, w1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(x1), x1)
    w0, w1 = torch.broadcast_tensors(w0, w1)
    return torch.stack([w0, w1], dim=-1)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """The reference's `split(k, num)` for one key -> int64[num, 2]."""
    with span("pbr.rng"):
        return _fold_in(k, torch.arange(num, dtype=torch.int64,
                                        device=k.device))


def random_bits(keys: torch.Tensor, m: int) -> torch.Tensor:
    """32 random bits per count: keys [..., 2] -> int64[..., m]."""
    j = torch.arange(m, dtype=torch.int64, device=keys.device)
    w0, w1 = threefry2x32(keys[..., 0:1], keys[..., 1:2],
                          torch.zeros_like(j), j)
    return w0 ^ w1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> f32 in [0, 1), the reference's uniform mapping."""
    fb = (bits >> 9) | _ONE_F32_BITS
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """The reference's `uniform(k, shape, float32)` for one key."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    return bits_to_uniform(random_bits(k, n)).reshape(shape)


def pixel_keys(base: torch.Tensor, n_pixels: int) -> torch.Tensor:
    """One key per pixel from a single key -> int64[n_pixels, 2]."""
    return split(base, n_pixels)


def fold(keys: torch.Tensor, *data) -> torch.Tensor:
    """Fold integers (or integer tensors) into keys [..., 2], in order."""
    for x in data:
        keys = fold_in(keys, x)
    return keys


def sample_key(base: torch.Tensor, sample_idx, bounce,
               stream) -> torch.Tensor:
    """Key of a (sample, bounce, stream) from a per-frame base key."""
    return fold(base, sample_idx, bounce, stream)


def uniform2(k: torch.Tensor, shape) -> torch.Tensor:
    """U[0,1)^2 over a batch shape -> f32[*shape, 2], for one key."""
    return uniform(k, tuple(shape) + (2,))


def uniform1(k: torch.Tensor, shape) -> torch.Tensor:
    """U[0,1) over a batch shape -> f32[*shape], for one key."""
    return uniform(k, shape)


def ray_keys(sample_key: torch.Tensor, pixel_ids: torch.Tensor) -> torch.Tensor:
    """One key per ray from a per-sample key and GLOBAL pixel ids -> [N, 2].

    The key depends only on (frame, sample, pixel), so a pixel's random
    sequence is the same however rays are batched.
    """
    with span("pbr.rng"):
        return _fold_in(sample_key, pixel_ids)


def ray_uniform(keys: torch.Tensor, bounce: int, stream: int,
                m: int) -> torch.Tensor:
    """m U[0,1) numbers per ray -> f32[N, m], from per-ray keys [N, 2]."""
    with span("pbr.rng"):
        k = _fold_in(_fold_in(keys, bounce), stream)
        return bits_to_uniform(random_bits(k, m))
