"""glTF 2.0 ingest: .gltf/.glb -> SceneGraph + flat SoA Scene (port of
`scene/gltf.py`).

  * External buffers, data URIs and the GLB BIN chunk are resolved; node
    matrices are decomposed to TRS; meshes without indices get generated
    indices.
  * `load_scene_graph` injects a "DefaultCamera" node first when the scene
    has no camera.
  * POSITION/NORMAL/TANGENT/TEXCOORD_0 are read; missing normals, tangents
    and uvs are generated (flat normals, UV-derived or arbitrary tangents,
    zero uvs).  Indices may be u8, u16 or u32.
  * Materials: full metallic-roughness (factors + all four texture slots,
    all optional), emissive (incl. KHR_materials_emissive_strength),
    KHR_materials_specular.
  * Sampler wrap modes and filters; image sources URI, bufferView and
    data URI.  PNG images are decoded by the port's own reader
    (`core/film.read_png`); JPEG images and the Lanczos downscale above
    `max_dim` use PIL where it can be imported and otherwise raise
    `GltfError` naming the missing package.

Everything is host-side numpy, computed exactly as the reference does; the
resulting Scene holds CPU tensors and is moved to the render device by
`scene.types.upload_scene`.
"""

from __future__ import annotations

import base64
import dataclasses
import io
import importlib
import json
import struct
import urllib.parse
from pathlib import Path

import numpy as np

from ..core.film import PNG_MAGIC, GltfError, read_png
from . import graph as graph_mod
from .procedural import _materials
from .types import (DirectionalLight, EnvMap, FILTER_LINEAR, FILTER_NEAREST,
                    Materials, MIP_LINEAR, MIP_NEAREST, MIP_NONE,
                    TextureStack, WRAP_CLAMP, WRAP_MIRROR, WRAP_REPEAT,
                    make_scene)

GLB_MAGIC = 0x46546C67  # 'glTF'
CHUNK_JSON = 0x4E4F534A
CHUNK_BIN = 0x004E4942

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
    5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT2": 4, "MAT3": 9, "MAT4": 16}
_WRAP_MAP = {10497: WRAP_REPEAT, 33071: WRAP_CLAMP, 33648: WRAP_MIRROR}
MODE_TRIANGLES = 4


@dataclasses.dataclass
class Document:
    """Parsed glTF JSON + resolved binary buffers."""

    json: dict
    buffers: list[bytes]
    base_dir: Path


# ---------------------------------------------------------------------------
# Container parsing
# ---------------------------------------------------------------------------

def _read_data_uri(uri: str) -> bytes:
    header, _, payload = uri.partition(",")
    if ";base64" in header:
        return base64.b64decode(payload)
    return urllib.parse.unquote_to_bytes(payload)


def _parse_json(raw: bytes) -> dict:
    try:
        js = json.loads(raw.decode("utf-8"))
    except ValueError as e:          # JSONDecodeError, UnicodeDecodeError
        raise GltfError(f"glTF JSON does not parse: {e}") from None
    if not isinstance(js, dict):
        raise GltfError("glTF JSON is not an object")
    return js


def parse_glb(data: bytes) -> tuple[dict, bytes | None]:
    """Binary .glb container -> (json dict, BIN chunk or None).  A chunk
    that runs past the end of the data (a truncated file) and JSON that
    does not parse raise GltfError."""
    if len(data) < 12:
        raise GltfError("GLB too short")
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != GLB_MAGIC:
        raise GltfError("not a GLB file (bad magic)")
    if version != 2:
        raise GltfError(f"unsupported GLB version {version}")
    off = 12
    js = None
    bin_chunk = None
    while off + 8 <= len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        if off + clen > len(data):
            raise GltfError(f"GLB chunk of {clen} bytes runs past the end "
                            "of the file (truncated?)")
        chunk = data[off:off + clen]
        off += clen + ((-clen) % 4 if ctype == 0 else 0)
        # chunks are 4-byte aligned; JSON is space-padded, BIN zero-padded
        if ctype == CHUNK_JSON:
            js = _parse_json(chunk)
        elif ctype == CHUNK_BIN:
            bin_chunk = bytes(chunk)
    if js is None:
        raise GltfError("GLB missing JSON chunk")
    return js, bin_chunk


def load_document(path: str | Path) -> Document:
    """Parse .gltf/.glb and resolve all buffers."""
    path = Path(path)
    if not path.exists():
        raise GltfError(f"no such file: {path}")
    data = path.read_bytes()
    if data[:4] == b"glTF":
        js, bin_chunk = parse_glb(data)
    else:
        js = _parse_json(data)
        bin_chunk = None
    buffers: list[bytes] = []
    for i, buf in enumerate(js.get("buffers", [])):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise GltfError(f"buffer {i} has no uri and no GLB BIN chunk")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(_read_data_uri(uri))
        else:
            buffers.append(
                (path.parent / urllib.parse.unquote(uri)).read_bytes())
        if len(buffers[-1]) < buf.get("byteLength", 0):
            raise GltfError(f"buffer {i} shorter than declared byteLength")
    return Document(json=js, buffers=buffers, base_dir=path.parent)


# ---------------------------------------------------------------------------
# Accessors
# ---------------------------------------------------------------------------

def read_buffer_view(doc: Document, view_idx: int) -> bytes:
    view = doc.json["bufferViews"][view_idx]
    buf = doc.buffers[view["buffer"]]
    off = view.get("byteOffset", 0)
    return buf[off:off + view["byteLength"]]


def read_accessor(doc: Document, acc_idx: int) -> np.ndarray:
    """Decode accessor -> np array [count, components] (or [count] SCALAR).

    Handles interleaved strides, normalized integers (-> f32 [0,1]/[-1,1]),
    and sparse accessors.
    """
    acc = doc.json["accessors"][acc_idx]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    itemsize = np.dtype(dtype).itemsize * ncomp

    if "bufferView" in acc:
        view = doc.json["bufferViews"][acc["bufferView"]]
        raw = read_buffer_view(doc, acc["bufferView"])
        stride = view.get("byteStride") or itemsize
        off = acc.get("byteOffset", 0)
        if stride == itemsize:
            arr = np.frombuffer(raw, dtype=dtype, count=count * ncomp,
                                offset=off).reshape(count, ncomp)
        else:
            out = np.empty((count, ncomp), dtype=dtype)
            for i in range(count):
                out[i] = np.frombuffer(raw, dtype=dtype, count=ncomp,
                                       offset=off + i * stride)
            arr = out
    else:
        arr = np.zeros((count, ncomp), dtype=dtype)

    sparse = acc.get("sparse")
    if sparse:
        arr = arr.copy()
        sc = sparse["count"]
        idx_info = sparse["indices"]
        idx_dtype = _COMPONENT_DTYPES[idx_info["componentType"]]
        idx_raw = read_buffer_view(doc, idx_info["bufferView"])
        sp_idx = np.frombuffer(idx_raw, dtype=idx_dtype, count=sc,
                               offset=idx_info.get("byteOffset", 0))
        val_info = sparse["values"]
        val_raw = read_buffer_view(doc, val_info["bufferView"])
        sp_val = np.frombuffer(val_raw, dtype=dtype, count=sc * ncomp,
                               offset=val_info.get("byteOffset", 0)
                               ).reshape(sc, ncomp)
        arr[sp_idx.astype(np.int64)] = sp_val

    if acc.get("normalized") and np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = arr.astype(np.float32)
        if info.min < 0:
            arr = np.maximum(arr / info.max, -1.0)
        else:
            arr = arr / info.max
    if acc["type"] == "SCALAR":
        arr = arr.reshape(count)
    return arr


# ---------------------------------------------------------------------------
# Images & textures
# ---------------------------------------------------------------------------

def _pil_image(what: str):
    """PIL's Image module, for `what` the port's own codec does not do."""
    try:
        return importlib.import_module("PIL.Image")
    except ImportError:
        raise GltfError(f"{what} needs the PIL (Pillow) package, which is "
                        "not installed") from None


def decode_image(doc: Document, img_idx: int) -> np.ndarray:
    """Decode a glTF image -> u8 RGBA [H,W,4]."""
    img = doc.json["images"][img_idx]
    if "uri" in img:
        uri = img["uri"]
        if uri.startswith("data:"):
            raw = _read_data_uri(uri)
        else:
            raw = (doc.base_dir / urllib.parse.unquote(uri)).read_bytes()
    elif "bufferView" in img:
        raw = read_buffer_view(doc, img["bufferView"])
    else:
        raise GltfError(f"image {img_idx} has neither uri nor bufferView")
    if raw[:8] == PNG_MAGIC:
        return read_png(raw)
    kind = "a JPEG image" if raw[:2] == b"\xff\xd8" else "a non-PNG image"
    image_mod = _pil_image(f"decoding image {img_idx} ({kind})")
    try:
        with image_mod.open(io.BytesIO(raw)) as im:
            return np.asarray(im.convert("RGBA"), dtype=np.uint8)
    except OSError as e:
        raise GltfError(f"image {img_idx} cannot be decoded: {e}") from None


def _srgb_to_linear_np(c: np.ndarray) -> np.ndarray:
    lo = c / 12.92
    hi = ((c + 0.055) / 1.055) ** 2.4
    return np.where(c <= 0.04045, lo, hi).astype(np.float32)


def build_texture_stack(doc: Document, max_dim: int = 2048
                        ) -> tuple[TextureStack, dict[int, int]]:
    """Decode every glTF *texture* into one flat texel arena.

    Returns (stack, texture_index -> stack slot).  Color-space handling: a
    texture slot is decoded per USE — baseColor/emissive are sRGB, normal/MR
    are linear — so a texture used in both ways gets two slots.  Sampler
    wrapS/wrapT AND minFilter/magFilter map onto the stack's static
    metadata; each texture keeps its exact size (no pad-to-max canvas).
    """
    textures = doc.json.get("textures", [])
    if not textures:
        return TextureStack.empty(), {}

    # which texture indices are used as sRGB (color) vs linear data?
    srgb_use: set[int] = set()
    linear_use: set[int] = set()
    for mat in doc.json.get("materials", []):
        pbr = mat.get("pbrMetallicRoughness", {})
        if "baseColorTexture" in pbr:
            srgb_use.add(pbr["baseColorTexture"]["index"])
        if "metallicRoughnessTexture" in pbr:
            linear_use.add(pbr["metallicRoughnessTexture"]["index"])
        if "normalTexture" in mat:
            linear_use.add(mat["normalTexture"]["index"])
        if "emissiveTexture" in mat:
            srgb_use.add(mat["emissiveTexture"]["index"])
    # default untagged to linear
    images: dict[int, np.ndarray] = {}
    slots: list[np.ndarray] = []
    wraps: list[tuple[int, int]] = []
    filts: list[tuple[int, int, int]] = []
    mapping: dict[int, int] = {}

    def sampler_wrap(tex) -> tuple[int, int]:
        s_idx = tex.get("sampler")
        if s_idx is None:
            return (WRAP_REPEAT, WRAP_REPEAT)
        s = doc.json.get("samplers", [])[s_idx]
        return (_WRAP_MAP.get(s.get("wrapS", 10497), WRAP_REPEAT),
                _WRAP_MAP.get(s.get("wrapT", 10497), WRAP_REPEAT))

    def sampler_filt(tex) -> tuple[int, int, int]:
        """glTF magFilter/minFilter -> (mag, min_inner, min_mip); undefined
        filters default to trilinear (the usual runtime choice)."""
        s_idx = tex.get("sampler")
        s = (doc.json.get("samplers", [])[s_idx]
             if s_idx is not None else {})
        mag = {9728: FILTER_NEAREST, 9729: FILTER_LINEAR}.get(
            s.get("magFilter"), FILTER_LINEAR)
        min_map = {  # NEAREST/LINEAR x (none | MIPMAP_NEAREST | _LINEAR)
            9728: (FILTER_NEAREST, MIP_NONE),
            9729: (FILTER_LINEAR, MIP_NONE),
            9984: (FILTER_NEAREST, MIP_NEAREST),
            9985: (FILTER_LINEAR, MIP_NEAREST),
            9986: (FILTER_NEAREST, MIP_LINEAR),
            9987: (FILTER_LINEAR, MIP_LINEAR),
        }
        mi, mm = min_map.get(s.get("minFilter"), (FILTER_LINEAR,
                                                  MIP_LINEAR))
        return (mag, mi, mm)

    for ti, tex in enumerate(textures):
        src = tex.get("source")
        if src is None:
            continue
        if src not in images:
            im = decode_image(doc, src)
            h, w = im.shape[:2]
            if max(h, w) > max_dim:  # downscale huge textures
                image_mod = _pil_image(
                    f"downscaling the {w}x{h} image {src} to {max_dim}")
                scale = max_dim / max(h, w)
                nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
                pil = image_mod.fromarray(im).resize(
                    (nw, nh), image_mod.Resampling.LANCZOS)
                im = np.asarray(pil, dtype=np.uint8)
            images[src] = im
        im = images[src].astype(np.float32) / 255.0
        if ti in srgb_use:
            rgb = _srgb_to_linear_np(im[..., :3])
            im = np.concatenate([rgb, im[..., 3:4]], axis=-1)
        mapping[ti] = len(slots)
        slots.append(im.astype(np.float32))
        wraps.append(sampler_wrap(tex))
        filts.append(sampler_filt(tex))

    if not slots:
        return TextureStack.empty(), {}
    return TextureStack.from_images(slots, wrap=wraps, filt=filts), mapping


# ---------------------------------------------------------------------------
# Materials
# ---------------------------------------------------------------------------

def build_materials(doc: Document, tex_map: dict[int, int]) -> Materials:
    """Full metallic-roughness material table."""
    mats_js = doc.json.get("materials", [])
    n = max(len(mats_js), 1)
    bcf = np.ones((n, 4), np.float32)
    met = np.zeros((n,), np.float32)
    rgh = np.ones((n,), np.float32)
    emi = np.zeros((n, 3), np.float32)
    nsc = np.ones((n,), np.float32)
    spc = np.ones((n,), np.float32)
    bct = np.full((n,), -1, np.int32)
    mrt = np.full((n,), -1, np.int32)
    nrt = np.full((n,), -1, np.int32)
    emt = np.full((n,), -1, np.int32)

    def tex_slot(info) -> int:
        if info is None:
            return -1
        if info.get("texCoord", 0) != 0:
            return -1  # only TEXCOORD_0
        return tex_map.get(info["index"], -1)

    for i, mat in enumerate(mats_js):
        pbr = mat.get("pbrMetallicRoughness", {})
        bcf[i] = np.asarray(pbr.get("baseColorFactor", [1, 1, 1, 1]),
                            np.float32)
        met[i] = pbr.get("metallicFactor", 1.0)
        rgh[i] = pbr.get("roughnessFactor", 1.0)
        bct[i] = tex_slot(pbr.get("baseColorTexture"))
        mrt[i] = tex_slot(pbr.get("metallicRoughnessTexture"))
        nt = mat.get("normalTexture")
        nrt[i] = tex_slot(nt)
        if nt is not None:
            nsc[i] = nt.get("scale", 1.0)
        strength = mat.get("extensions", {}).get(
            "KHR_materials_emissive_strength", {}).get("emissiveStrength",
                                                       1.0)
        emi[i] = np.asarray(mat.get("emissiveFactor", [0, 0, 0]),
                            np.float32) * strength
        emt[i] = tex_slot(mat.get("emissiveTexture"))
        spec_ext = mat.get("extensions", {}).get("KHR_materials_specular")
        if spec_ext is not None:
            spc[i] = spec_ext.get("specularFactor", 1.0)
    return _materials(base_color_factor=bcf, metallic_factor=met,
                      roughness_factor=rgh, emissive_factor=emi,
                      normal_scale=nsc, specular_factor=spc,
                      base_color_tex=bct, metallic_roughness_tex=mrt,
                      normal_tex=nrt, emissive_tex=emt)


# ---------------------------------------------------------------------------
# Meshes & nodes
# ---------------------------------------------------------------------------

def _generate_flat_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    n = np.zeros_like(pos)
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                  pos[idx[:, 2]] - pos[idx[:, 0]])
    for k in range(3):
        np.add.at(n, idx[:, k], fn)
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                           1e-12)).astype(np.float32)


def _generate_tangents(pos, nrm, uv, idx) -> np.ndarray:
    """Per-vertex tangents from UV derivatives (Lengyel), falling back to an
    arbitrary frame when UVs are degenerate."""
    tan = np.zeros((pos.shape[0], 3), np.float64)
    p0, p1, p2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    u0, u1, u2 = uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    d1, d2 = u1 - u0, u2 - u0
    det = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
    r = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0)
    t = (e1 * d2[:, 1:2] - e2 * d1[:, 1:2]) * r[:, None]
    for k in range(3):
        np.add.at(tan, idx[:, k], t)
    # Gram-Schmidt against the normal
    tan = tan - nrm * np.sum(tan * nrm, axis=-1, keepdims=True)
    lens = np.linalg.norm(tan, axis=-1, keepdims=True)
    fallback = graph_fallback_tangents(nrm)
    tan = np.where(lens > 1e-8, tan / np.maximum(lens, 1e-12), fallback)
    out = np.zeros((pos.shape[0], 4), np.float32)
    out[:, :3] = tan
    out[:, 3] = 1.0
    return out


def graph_fallback_tangents(normals: np.ndarray) -> np.ndarray:
    a = np.where(np.abs(normals[:, 0:1]) < 0.9,
                 np.array([[1.0, 0, 0]], np.float32),
                 np.array([[0, 1.0, 0]], np.float32))
    t = np.cross(a, normals)
    return t / np.maximum(np.linalg.norm(t, axis=-1, keepdims=True), 1e-12)


def load_mesh(doc: Document, mesh_idx: int) -> graph_mod.HostMesh:
    mesh_js = doc.json["meshes"][mesh_idx]
    prims = []
    for prim_js in mesh_js.get("primitives", []):
        mode = prim_js.get("mode", MODE_TRIANGLES)
        if mode != MODE_TRIANGLES:
            raise GltfError(f"unsupported primitive mode {mode} "
                            f"(only TRIANGLES)")
        attrs = prim_js.get("attributes", {})
        if "POSITION" not in attrs:
            raise GltfError("primitive lacks POSITION attribute")
        pos = read_accessor(doc, attrs["POSITION"]).astype(np.float32)
        v = pos.shape[0]
        if "indices" in prim_js:
            idx = read_accessor(doc, prim_js["indices"]).astype(np.int32)
            idx = idx.reshape(-1, 3)
        else:  # generated indices
            idx = np.arange(v, dtype=np.int32).reshape(-1, 3)
        uv = (read_accessor(doc, attrs["TEXCOORD_0"]).astype(np.float32)
              if "TEXCOORD_0" in attrs else np.zeros((v, 2), np.float32))
        nrm = (read_accessor(doc, attrs["NORMAL"]).astype(np.float32)
               if "NORMAL" in attrs else _generate_flat_normals(pos, idx))
        if "TANGENT" in attrs:
            tan = read_accessor(doc, attrs["TANGENT"]).astype(np.float32)
            if tan.shape[1] == 3:
                tan = np.concatenate(
                    [tan, np.ones((v, 1), np.float32)], axis=-1)
        else:
            tan = _generate_tangents(pos, nrm, uv, idx)
        prims.append(graph_mod.MeshPrimitive(
            positions=pos, normals=nrm, tangents=tan, uvs=uv, indices=idx,
            material=prim_js.get("material", 0)))
    return graph_mod.HostMesh(name=mesh_js.get("name", f"mesh{mesh_idx}"),
                              primitives=prims)


def load_node(doc: Document, node_idx: int) -> graph_mod.Node:
    js = doc.json["nodes"][node_idx]
    if "matrix" in js:
        m = np.asarray(js["matrix"], np.float32).reshape(4, 4).T  # column-major
        tr = graph_mod.Transform.from_matrix(m)
    else:
        tr = graph_mod.Transform(
            translation=np.asarray(js.get("translation", [0, 0, 0]),
                                   np.float32),
            rotation=np.asarray(js.get("rotation", [0, 0, 0, 1]),
                                np.float32),
            scale=np.asarray(js.get("scale", [1, 1, 1]), np.float32))
    cam = None
    if "camera" in js:
        cam_js = doc.json.get("cameras", [])[js["camera"]]
        persp = cam_js.get("perspective", {})
        cam = graph_mod.CameraDef(
            yfov=persp.get("yfov", 1.0471976),
            znear=persp.get("znear", 0.01),
            zfar=persp.get("zfar", 1024.0),
            aspect=persp.get("aspectRatio"))
    node = graph_mod.Node(
        name=js.get("name", f"node{node_idx}"),
        transform=tr,
        mesh=js.get("mesh"),
        camera=cam,
    )
    node.children = [load_node(doc, c) for c in js.get("children", [])]
    return node


def load_scene_graph(doc: Document, scene_idx: int | None = None
                     ) -> graph_mod.SceneGraph:
    """Build the host scene graph for one glTF scene (default: the file's
    `scene`, else scene 0)."""
    js = doc.json
    if scene_idx is None:
        scene_idx = js.get("scene", 0)
    scenes = js.get("scenes", [{}])
    scene_js = scenes[scene_idx]
    g = graph_mod.SceneGraph(name=scene_js.get("name", f"scene{scene_idx}"))
    g.meshes = [load_mesh(doc, i) for i in range(len(js.get("meshes", [])))]
    g.roots = [load_node(doc, i) for i in scene_js.get("nodes", [])]
    # a scene without a camera gets the default one
    if g.find_camera() is None:
        g.add_default_camera()
    return g


def load(path: str | Path, scene_idx: int | None = None,
         env: EnvMap | None = None,
         directional: DirectionalLight | None = None,
         max_texture_dim: int = 2048):
    """One-call ingest: path -> (Scene of CPU tensors, SceneGraph, Camera).

    The returned Scene's geometry has world transforms baked (flattened
    graph); the Camera is the scene's first camera node (or the injected
    default), converted to core.camera.Camera.
    """
    from ..core.camera import Camera

    doc = load_document(path)
    g = load_scene_graph(doc, scene_idx)
    textures, tex_map = build_texture_stack(doc, max_texture_dim)
    materials = build_materials(doc, tex_map)
    geometry, _ = g.flatten()
    scene = make_scene(geometry, materials, textures=textures,
                       directional=directional, env=env)

    node, world = g.find_camera()
    pos = world[:3, 3]
    fwd = -world[:3, 2]  # glTF camera looks down its node's -Z
    camera = Camera.make(position=pos, target=pos + fwd,
                         fov_y=node.camera.yfov,
                         znear=node.camera.znear, zfar=node.camera.zfar)
    return scene, g, camera
