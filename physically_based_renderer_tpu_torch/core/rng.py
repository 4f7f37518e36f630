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
global generator.  On a CUDA tensor every function here is one launch of
`csrc/threefry.cu` (counted in `LAUNCHES`); a broadcast the kernel does not
take is expanded first, and nothing falls back to torch ops.  On a CPU
tensor the plain version runs: each threefry as about 170 elementwise
torch ops, which the tests hold to the reference and the kernel to it.
Under a profiler each call of `fold_in`, `split`, `ray_keys` or
`ray_uniform` is the span `pbr.rng`; they reach one another through
`_fold_in`, so the span never nests in itself.
"""

from __future__ import annotations

import math

import torch

from ..ops import cuda_lib
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

# Kernel launches since the last reset (incremented once per launch).
LAUNCHES = 0


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on uint32 words held in int64 tensors.

    All four arguments broadcast; returns the two output words.  On CUDA
    the key words are tensors, stacked into one key batch for the kernel.
    """
    if isinstance(k0, torch.Tensor) and _on_card(k0):
        keys = torch.stack(torch.broadcast_tensors(k0, k1), dim=-1)
        out = _words(keys, x0, x1)
        return out[..., 0], out[..., 1]
    return threefry2x32_plain(k0, k1, x0, x1)


def threefry2x32_plain(k0, k1, x0, x1):
    """The plain version of `threefry2x32`: torch ops on any device."""
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
    if _on_card(keys):
        return _words(keys, 0, data)
    return fold_in_plain(keys, data)


def fold_in_plain(keys: torch.Tensor, data) -> torch.Tensor:
    """The plain version of `fold_in` (and of `split` and `ray_keys`, whose
    counts are its data): torch ops on any device."""
    x1 = _counts(data, keys)
    w0, w1 = threefry2x32_plain(keys[..., 0], keys[..., 1],
                                torch.zeros_like(x1), x1)
    w0, w1 = torch.broadcast_tensors(w0, w1)
    return torch.stack([w0, w1], dim=-1)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """The reference's `split(k, num)` for one key -> int64[num, 2]."""
    with span("pbr.rng"):
        if _on_card(k) and math.prod(k.shape[:-1]) == 1:
            return _words(k, 0, 0, iota=num)
        return _fold_in(k, torch.arange(num, dtype=torch.int64,
                                        device=k.device))


def random_bits(keys: torch.Tensor, m: int) -> torch.Tensor:
    """32 random bits per count: keys [..., 2] -> int64[..., m]."""
    if _on_card(keys):
        return _bits(keys, m, torch.int64)
    return random_bits_plain(keys, m)


def random_bits_plain(keys: torch.Tensor, m: int) -> torch.Tensor:
    """The plain version of `random_bits`: torch ops on any device."""
    j = torch.arange(m, dtype=torch.int64, device=keys.device)
    w0, w1 = threefry2x32_plain(keys[..., 0:1], keys[..., 1:2],
                                torch.zeros_like(j), j)
    return w0 ^ w1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> f32 in [0, 1), the reference's uniform mapping."""
    fb = (bits >> 9) | _ONE_F32_BITS
    return fb.to(torch.int32).view(torch.float32) - 1.0


def uniform(k: torch.Tensor, shape) -> torch.Tensor:
    """The reference's `uniform(k, shape, float32)` for one key."""
    shape = tuple(shape)
    n = math.prod(shape)
    if _on_card(k):
        if math.prod(k.shape[:-1]) != 1:
            raise ValueError(f"uniform takes one key, got {tuple(k.shape)}")
        return _bits(k, n, torch.float32).reshape(shape)
    return bits_to_uniform(random_bits_plain(k, n)).reshape(shape)


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
        if _on_card(keys):
            return _ray_uniform_card(keys, bounce, stream, m)
        return ray_uniform_plain(keys, bounce, stream, m)


def ray_uniform_plain(keys: torch.Tensor, bounce: int, stream: int,
                      m: int) -> torch.Tensor:
    """The plain version of `ray_uniform`: torch ops on any device."""
    k = fold_in_plain(fold_in_plain(keys, bounce), stream)
    return bits_to_uniform(random_bits_plain(k, m))


# ---------------------------------------------------------------------------
# The kernel's wrappers (csrc/threefry.cu): one launch a call
# ---------------------------------------------------------------------------

def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises for any other."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"core.rng: unsupported device {t.device}")
    return True


def _card_keys(keys: torch.Tensor) -> torch.Tensor:
    if keys.dtype != torch.int64:
        raise TypeError(f"keys must be int64 word pairs, got {keys.dtype}")
    if keys.dim() == 0 or keys.shape[-1] != 2:
        raise ValueError(f"keys must be [..., 2], got {tuple(keys.shape)}")
    return keys.contiguous()


def _card_word(x, shape, device):
    """A count word for the kernel: (array or None, step, value).  An int is
    a value; a tensor of one element is read at step 0, any other is
    expanded to the output's shape and read a lane at a time."""
    if not isinstance(x, torch.Tensor):
        return None, 0, int(x) & MASK
    if x.device != device:
        raise ValueError(f"counts on {x.device}, keys on {device}")
    if x.is_floating_point() or x.is_complex():
        raise TypeError(f"counts must be integers, got {x.dtype}")
    x = x.to(torch.int64)
    if x.numel() == 1:
        return x.contiguous(), 0, 0
    return x.expand(shape).contiguous(), 1, 0


def _broadcast(shapes) -> tuple:
    """The broadcast of `shapes`, as torch's rules give it.  Written out:
    `torch.broadcast_shapes` imports sympy on its first call, seconds of a
    process's first frame or step."""
    n = max(len(s) for s in shapes)
    out = []
    for dims in zip(*((1,) * (n - len(s)) + s for s in shapes)):
        sizes = {d for d in dims if d != 1}
        if len(sizes) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(sizes.pop() if sizes else 1)
    return tuple(out)


def _launched(rc: int, name: str) -> None:
    global LAUNCHES
    cuda_lib.check(rc, name)
    LAUNCHES += 1


def _words(keys: torch.Tensor, x0, x1, iota: int | None = None):
    """threefry2x32(key, (x0, x1 [+ i with iota])) over the broadcast of the
    keys' batch and the counts (int64[..., 2]) in one launch; with iota the
    output is [iota] and x1 gains the lane index (split's counts)."""
    keys = _card_keys(keys)
    dev = keys.device
    shapes = [tuple(keys.shape[:-1])]
    shapes += [tuple(x.shape) for x in (x0, x1) if isinstance(x, torch.Tensor)]
    if iota is not None:
        shapes.append((iota,))
    shape = _broadcast(shapes)
    out = torch.empty(*shape, 2, dtype=torch.int64, device=dev)
    n = math.prod(shape)
    if n == 0:
        return out
    if math.prod(keys.shape[:-1]) == 1:
        key_step = 0
    else:
        keys, key_step = keys.expand(*shape, 2).contiguous(), 1
    a, a_step, a_value = _card_word(x0, shape, dev)
    b, b_step, b_value = _card_word(x1, shape, dev)
    rc = cuda_lib.library().pbr_threefry_words(
        keys.data_ptr(), key_step,
        None if a is None else a.data_ptr(), a_step, a_value,
        None if b is None else b.data_ptr(), b_step, b_value,
        int(iota is not None), n, out.data_ptr(), cuda_lib.stream_ptr(dev))
    _launched(rc, "pbr_threefry_words")
    return out


def _bits(keys: torch.Tensor, m: int, dtype) -> torch.Tensor:
    """random_bits (int64) or its uniforms (float32) in one launch: [..., m]."""
    keys = _card_keys(keys)
    batch = tuple(keys.shape[:-1])
    out = torch.empty(*batch, m, dtype=dtype, device=keys.device)
    if out.numel() == 0:
        return out
    rc = cuda_lib.library().pbr_threefry_bits(
        keys.data_ptr(), math.prod(batch), m, int(dtype == torch.float32),
        out.data_ptr(), cuda_lib.stream_ptr(keys.device))
    _launched(rc, "pbr_threefry_bits")
    return out


def _ray_uniform_card(keys, bounce: int, stream: int, m: int) -> torch.Tensor:
    keys = _card_keys(keys)
    batch = tuple(keys.shape[:-1])
    out = torch.empty(*batch, m, dtype=torch.float32, device=keys.device)
    if out.numel() == 0:
        return out
    rc = cuda_lib.library().pbr_threefry_ray_uniform(
        keys.data_ptr(), math.prod(batch), int(bounce) & MASK,
        int(stream) & MASK, m, out.data_ptr(),
        cuda_lib.stream_ptr(keys.device))
    _launched(rc, "pbr_threefry_ray_uniform")
    return out
