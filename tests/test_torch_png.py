"""The port's PNG codec (`core/film.py`) against PIL: every colour type and
scanline filter PIL writes decodes to PIL's own RGBA, the port's writer is
read back by PIL, and what the decoder does not take raises GltfError."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from physically_based_renderer_tpu_torch.core import film
from physically_based_renderer_tpu_torch.scene import gltf

SHAPES = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,)}
SIZES = [(1, 1), (7, 5), (16, 16), (33, 20)]


def _content(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, 200, np.uint8)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    if kind == "hramp":                      # favours the Sub filter
        base = xx * 3
    elif kind == "vramp":                    # favours Up
        base = yy * 5
    else:                                    # "smooth": Average / Paeth
        base = 60 * np.sin(xx / 3.0) + 60 * np.cos(yy / 4.0) + xx + yy + 128
    img = np.broadcast_to(base.reshape(shape[:2] + (1,) * (len(shape) - 2)),
                          shape)
    return (img + np.arange(shape[-1] if len(shape) > 2 else 1) * 7).astype(
        np.int64).astype(np.uint8) if len(shape) > 2 else img.astype(
        np.int64).astype(np.uint8)


def _pil_png(arr, mode, **kw):
    buf = io.BytesIO()
    im = Image.fromarray(arr)
    assert im.mode == mode
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _filter_types(data):
    """The filter byte of every row of a PNG."""
    idat = b"".join(p for t, p in film._png_chunks(data) if t == b"IDAT")
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    stride = (w * film._PNG_CHANNELS[ctype] * depth + 7) // 8
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(h)}


@pytest.mark.parametrize("kind", ["noise", "flat", "hramp", "vramp",
                                  "smooth"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_pil_written_png_decodes_like_pil(mode, size, kind):
    arr = _content(kind, size + SHAPES[mode], seed=len(kind) + size[0])
    data = _pil_png(arr, mode)
    got = film.read_png(data)
    assert got.dtype == np.uint8 and got.shape == size + (4,)
    np.testing.assert_array_equal(got, _pil_rgba(data))


def _filtered_png(img, filters):
    """Encode u8 [H, W, C] with the given filter type on each row (a plain
    per-byte encoder, independent of the decoder under test)."""
    h, w, c = img.shape
    flat = img.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        ft = filters[y % len(filters)]
        raw.append(ft)
        for i in range(w * c):
            a = flat[y, i - c] if i >= c else 0
            b = flat[y - 1, i] if y else 0
            d = flat[y - 1, i - c] if (y and i >= c) else 0
            p = a + b - d
            paeth = min((abs(p - a), 0, a), (abs(p - b), 1, b),
                        (abs(p - d), 2, d))[2]
            pred = (0, a, b, (a + b) // 2, paeth)[ft]
            raw.append((flat[y, i] - pred) % 256)
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (film.PNG_MAGIC
            + film._png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                                   0, 0, 0))
            + film._png_chunk(b"IDAT", zlib.compress(bytes(raw)))
            + film._png_chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
def test_every_scanline_filter_decodes_like_pil(filters, channels):
    img = _content("noise", (11, 9, channels), seed=sum(filters))
    data = _filtered_png(img, filters)
    assert _filter_types(data) == set(filters)
    np.testing.assert_array_equal(film.read_png(data), _pil_rgba(data))


def test_pil_itself_picks_several_filters():
    seen = set()
    for mode in SHAPES:
        for kind in ("noise", "flat", "hramp", "vramp", "smooth"):
            arr = _content(kind, (33, 20) + SHAPES[mode], seed=1)
            seen |= _filter_types(_pil_png(arr, mode))
    assert len(seen) >= 3


@pytest.mark.parametrize("colors", [2, 3, 7, 16, 40, 256])
def test_palette_png_decodes_like_pil(colors):
    rng = np.random.default_rng(colors)
    rgb = rng.integers(0, 256, (19, 23, 3)).astype(np.uint8)
    im = Image.fromarray(rgb).quantize(colors=colors)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    np.testing.assert_array_equal(film.read_png(buf.getvalue()),
                                  _pil_rgba(buf.getvalue()))
    buf = io.BytesIO()                      # palette with per-entry alpha
    im.save(buf, format="PNG", transparency=bytes(
        rng.integers(0, 256, colors).astype(np.uint8)))
    np.testing.assert_array_equal(film.read_png(buf.getvalue()),
                                  _pil_rgba(buf.getvalue()))


@pytest.mark.parametrize("mode,key", [("L", 200), ("RGB", (200, 200, 200))])
def test_transparent_colour_key_decodes_like_pil(mode, key):
    arr = _content("flat", (6, 9) + SHAPES[mode], 0)
    arr[2, 3] = 17
    data = _pil_png(arr, mode, transparency=key)
    got = film.read_png(data)
    np.testing.assert_array_equal(got, _pil_rgba(data))
    assert got[0, 0, 3] == 0 and got[2, 3, 3] == 255


def test_one_bit_grey_decodes_like_pil():
    arr = np.random.default_rng(3).integers(0, 2, (9, 13)).astype(bool)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    np.testing.assert_array_equal(film.read_png(buf.getvalue()),
                                  _pil_rgba(buf.getvalue()))


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (5, 7, 2), (5, 7, 3),
                                   (5, 7, 4), (1, 1, 4), (64, 64, 4)])
def test_port_writer_is_read_back_by_pil_and_by_the_port(shape):
    arr = np.random.default_rng(5).integers(0, 256, shape).astype(np.uint8)
    data = film.encode_png(arr)
    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back.reshape(shape), arr)
    np.testing.assert_array_equal(film.read_png(data), _pil_rgba(data))


def test_writer_rejects_other_arrays():
    with pytest.raises(ValueError):
        film.encode_png(np.zeros((4, 4, 5), np.uint8))
    with pytest.raises(ValueError):
        film.encode_png(np.zeros((4, 4, 3), np.float32))


def _rechunk(data, parts):
    """The same PNG with its image data split over `parts` IDAT chunks."""
    chunks = list(film._png_chunks(data))
    idat = b"".join(p for t, p in chunks if t == b"IDAT")
    cut = [len(idat) * i // parts for i in range(parts + 1)]
    out = film.PNG_MAGIC
    done = False
    for tag, payload in chunks:
        if tag != b"IDAT":
            out += film._png_chunk(tag, payload)
        elif not done:
            done = True
            for a, b in zip(cut, cut[1:]):
                out += film._png_chunk(b"IDAT", idat[a:b])
    return out


def test_several_idat_chunks():
    arr = _content("noise", (40, 40, 4), 9)
    data = _rechunk(_pil_png(arr, "RGBA"), 5)
    assert sum(t == b"IDAT" for t, _ in film._png_chunks(data)) == 5
    np.testing.assert_array_equal(film.read_png(data), arr)


def _with_header(data, **fields):
    """The PNG with IHDR fields replaced (crc recomputed)."""
    names = ("w", "h", "depth", "ctype", "comp", "flt", "interlace")
    vals = dict(zip(names, struct.unpack(">IIBBBBB", data[16:29])))
    vals.update(fields)
    ihdr = film._png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", *(vals[n] for n in names)))
    return data[:8] + ihdr + data[33:]


def test_unsupported_and_broken_pngs_raise_gltf_error():
    good = film.encode_png(_content("noise", (8, 8, 3), 0))
    sixteen = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8)
                    * np.uint16(900)).save(sixteen, format="PNG")
    cases = {
        "16-bit": sixteen.getvalue(),
        "interlaced": _with_header(good, interlace=1),
        "colour type": _with_header(good, ctype=5),
        "bit depth": _with_header(good, depth=4),
        "signature": b"JUNK" + good[4:],
        "shorter": _with_header(good, h=9),
        "inflate": good[:41] + b"\xff\xff\xff" + good[44:],
        "no image data": good[:33] + film._png_chunk(b"IEND", b""),
        "past the end": good[:60],
    }
    for reason, data in cases.items():
        with pytest.raises(film.GltfError, match=reason.split()[0]):
            film.read_png(data)
    assert film.GltfError is gltf.GltfError
    assert issubclass(film.GltfError, ValueError)


def _doc_with_image(raw, mime):
    return gltf.Document(
        json={"images": [{"bufferView": 0, "mimeType": mime}],
              "bufferViews": [{"buffer": 0, "byteLength": len(raw)}]},
        buffers=[raw], base_dir=None)


def test_decode_image_png_needs_no_pil_and_jpeg_names_it(monkeypatch):
    arr = _content("smooth", (16, 16, 3), 2)
    jpg = io.BytesIO()
    Image.fromarray(arr).save(jpg, format="JPEG")
    got = gltf.decode_image(_doc_with_image(jpg.getvalue(), "image/jpeg"), 0)
    np.testing.assert_array_equal(got, _pil_rgba(jpg.getvalue()))

    def no_pil(name):
        raise ImportError(name)
    monkeypatch.setattr(gltf.importlib, "import_module", no_pil)
    png = film.encode_png(arr)
    np.testing.assert_array_equal(
        gltf.decode_image(_doc_with_image(png, "image/png"), 0)[..., :3], arr)
    with pytest.raises(gltf.GltfError, match="PIL"):
        gltf.decode_image(_doc_with_image(jpg.getvalue(), "image/jpeg"), 0)
