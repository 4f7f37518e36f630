# Frozen copy of physically_based_renderer_tpu_torch/core/film.py at commit
# d7302a1, part of the benchmark's plain reference: it imports nothing
# of the port and runs the plain versions on every device.
"""Film: HDR accumulation buffer + LDR output (port of `core/film.py`),
and the port's PNG codec.

`encode_png`/`write_png` and `read_png` use the standard library alone
(zlib + struct), so neither rendering nor asset ingest needs an imaging
package.  The decoder reads what a glTF asset holds: non-interlaced PNGs of
bit depth 8 or less, colour types 0/2/3/4/6, all five scanline filters, any
number of IDAT chunks; anything else raises `GltfError` with the reason.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Film:
    """Accumulated radiance. `hdr` holds the RUNNING SUM; `spp` the count."""

    hdr: torch.Tensor  # f32[H, W, 3] sum of per-sample radiance
    spp: float         # number of accumulated samples

    @classmethod
    def zeros(cls, height: int, width: int, device=None) -> "Film":
        return cls(hdr=torch.zeros((height, width, 3), dtype=torch.float32,
                                   device=device), spp=0.0)

    def add_samples(self, radiance: torch.Tensor, n: float = 1.0) -> "Film":
        """Accumulate radiance summed over n new samples ([H, W, 3])."""
        return Film(hdr=self.hdr + radiance, spp=self.spp + n)

    def mean(self) -> torch.Tensor:
        """Current radiance estimate f32[H, W, 3]."""
        return self.hdr / max(self.spp, 1.0)


def to_u8(ldr) -> np.ndarray:
    """[0,1] float image -> uint8, round-to-nearest (Unorm store semantics)."""
    if isinstance(ldr, torch.Tensor):
        ldr = ldr.detach().cpu().numpy()
    arr = np.clip(np.asarray(ldr, np.float32), 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)


class GltfError(ValueError):
    """Malformed or unsupported asset input: a glTF container, accessor or
    image (`scene/gltf.py` raises it too)."""


PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels per pixel
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_CHANNELS_TO_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (grey) or [H, W, C] with C = 1 grey, 2 grey + alpha,
    3 RGB, 4 RGBA -> PNG bytes (8-bit, filter 0 on every row)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected uint8 [H, W] or [H, W, C], got "
                         f"{img.dtype} {img.shape}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _CHANNELS_TO_TYPE:
        raise ValueError(f"expected 1 to 4 channels, got {img.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          np.ascontiguousarray(img).reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _CHANNELS_TO_TYPE[c], 0, 0, 0)
    return (PNG_MAGIC + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, ldr) -> None:
    """Write [H, W, 3] float [0, 1] as an 8-bit RGB PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(to_u8(ldr)))


def _png_chunks(data: bytes):
    """Yield (tag, payload) of each chunk after the signature."""
    off = len(PNG_MAGIC)
    while off + 8 <= len(data):
        (n,) = struct.unpack_from(">I", data, off)
        tag = data[off + 4:off + 8]
        if off + 12 + n > len(data):
            raise GltfError(f"PNG chunk {tag!r} runs past the end of the data")
        yield tag, data[off + 8:off + 8 + n]
        off += 12 + n
        if tag == b"IEND":
            return


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of an inflated image -> u8[h, stride]."""
    if len(raw) < h * (stride + 1):
        raise GltfError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros((stride,), np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:                                  # Sub
            pad = (-stride) % bpp
            px = np.concatenate([line, np.zeros((pad,), np.uint8)])
            cur = np.cumsum(px.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)[:stride]
        elif ft == 2:                                  # Up
            cur = line + prev
        elif ft in (3, 4):                             # Average, Paeth
            cur_b = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur_b[i - bpp] if i >= bpp else 0
                b = up[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur_b[i] = (cur_b[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur_b), np.uint8)
        else:
            raise GltfError(f"PNG row {y} has unknown filter type {ft}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(data: bytes) -> np.ndarray:
    """PNG bytes -> u8 RGBA [H, W, 4].

    Grey becomes (l, l, l), a missing alpha 255, a palette is looked up
    (its tRNS chunk gives the alpha), and the tRNS colour of a grey or RGB
    image marks fully transparent pixels.
    """
    if data[:8] != PNG_MAGIC:
        raise GltfError("not a PNG file (bad signature)")
    header = palette = trns = None
    idat = []
    for tag, payload in _png_chunks(data):
        if tag == b"IHDR":
            header = payload
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = payload
        elif tag == b"IDAT":
            idat.append(payload)
    if header is None or len(header) != 13:
        raise GltfError("PNG has no valid IHDR chunk")
    w, h, depth, ctype, comp, flt, interlace = struct.unpack(">IIBBBBB",
                                                             header)
    if ctype not in _PNG_CHANNELS:
        raise GltfError(f"PNG has unknown colour type {ctype}")
    if depth == 16:
        raise GltfError("16-bit PNG images are not supported (8-bit only)")
    if depth not in (1, 2, 4, 8) or (depth < 8 and ctype not in (0, 3)):
        raise GltfError(f"PNG bit depth {depth} is invalid for colour type "
                        f"{ctype}")
    if interlace != 0:
        raise GltfError("interlaced (Adam7) PNG images are not supported")
    if comp != 0 or flt != 0:
        raise GltfError("PNG uses an unknown compression or filter method")
    if w == 0 or h == 0 or not idat:
        raise GltfError("PNG has no image data")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise GltfError(f"PNG image data does not inflate: {e}") from None
    ch = _PNG_CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    px = _unfilter(raw, h, stride, max(1, ch * depth // 8))
    if depth < 8:
        bits = np.unpackbits(px, axis=1)[:, :w * depth].reshape(h, w, depth)
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))
              ).sum(-1).astype(np.uint8)
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    px = px.reshape(h, w, ch)
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if palette is None:
            raise GltfError("palette PNG has no PLTE chunk")
        if int(px.max()) >= palette.shape[0]:
            raise GltfError("palette PNG indexes past its palette")
        out[..., :3] = palette[px[..., 0]]
        if trns is not None:
            alpha = np.full((palette.shape[0],), 255, np.uint8)
            n = min(len(trns), alpha.size)
            alpha[:n] = np.frombuffer(trns, np.uint8, n)
            out[..., 3] = alpha[px[..., 0]]
    elif ctype in (0, 4):
        out[..., :3] = px[..., :1]
        if ctype == 4:
            out[..., 3] = px[..., 1]
        elif trns is not None and len(trns) >= 2:
            key = struct.unpack(">H", trns[:2])[0]
            if depth < 8:
                key = key * (255 // ((1 << depth) - 1))
            out[..., 3] = np.where(px[..., 0] == key, 0, 255)
    else:
        out[..., :ch] = px
        if ctype == 2 and trns is not None and len(trns) >= 6:
            key = np.array(struct.unpack(">HHH", trns[:6]))
            out[..., 3] = np.where((px == key).all(-1), 0, 255)
    return out
