"""glTF 2.0 export: SceneGraph/Materials -> .glb (port of `scene/export.py`).

The inverse of scene/gltf.py: a graph with its material table and texture
stack is written out as a standard GLB.  Textures are stored as PNG images
written by the port's own encoder (`core/film.encode_png`): PNG is lossless,
so the bytes may differ from another encoder's while the decoded texels do
not.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from ..core.film import encode_png
from . import graph as graph_mod
from .gltf import CHUNK_BIN, CHUNK_JSON, GLB_MAGIC
from .types import Materials, TextureStack, _np

_WRAP_TO_GL = {0: 10497, 1: 33071, 2: 33648}


class _BinWriter:
    def __init__(self):
        self.blob = bytearray()
        self.views = []

    def add(self, data: bytes, target: int | None = None) -> int:
        # 4-byte align each view
        while len(self.blob) % 4:
            self.blob.append(0)
        off = len(self.blob)
        self.blob.extend(data)
        view = {"buffer": 0, "byteOffset": off, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        self.views.append(view)
        return len(self.views) - 1


def _accessor(js, view, ctype, count, type_, arr=None):
    acc = {"bufferView": view, "componentType": ctype, "count": count,
           "type": type_}
    if arr is not None and type_ in ("SCALAR", "VEC2", "VEC3", "VEC4"):
        a = arr.reshape(count, -1)
        acc["min"] = a.min(axis=0).tolist()
        acc["max"] = a.max(axis=0).tolist()
    js["accessors"].append(acc)
    return len(js["accessors"]) - 1


def _linear_to_srgb_np(c: np.ndarray) -> np.ndarray:
    c = np.clip(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * np.power(np.maximum(c, 1e-7), 1 / 2.4) - 0.055
    return np.where(c <= 0.0031308, lo, hi)


def export_glb(path: str | Path, g: graph_mod.SceneGraph,
               materials: Materials,
               textures: TextureStack | None = None) -> None:
    """Write a .glb with the graph's meshes/nodes and the material table."""
    bw = _BinWriter()
    js: dict = {
        "asset": {"version": "2.0",
                  "generator": "physically_based_renderer_tpu_torch"},
        "buffers": [], "bufferViews": [], "accessors": [],
        "meshes": [], "nodes": [], "scenes": [{"nodes": []}], "scene": 0,
        "materials": [], "samplers": [], "textures": [], "images": [],
    }

    # --- textures ---------------------------------------------------------
    n_tex = 0
    srgb_slots = set()
    if textures is not None and textures.num_textures > 0:
        for field in ("base_color_tex", "emissive_tex"):
            srgb_slots.update(
                int(i) for i in _np(getattr(materials, field)) if i >= 0)
        wraps = np.asarray(textures.wrap)
        n_tex = textures.num_textures
        for i in range(n_tex):
            tex = textures.image(i)
            rgb = tex[..., :3]
            if i in srgb_slots:
                rgb = _linear_to_srgb_np(rgb)
            rgba = np.concatenate([rgb, tex[..., 3:4]], axis=-1)
            u8 = (np.clip(rgba, 0, 1) * 255 + 0.5).astype(np.uint8)
            view = bw.add(encode_png(u8))
            js["images"].append({"bufferView": view, "mimeType": "image/png"})
            js["samplers"].append({
                "wrapS": _WRAP_TO_GL[int(wraps[i, 0])],
                "wrapT": _WRAP_TO_GL[int(wraps[i, 1])]})
            js["textures"].append({"source": i, "sampler": i})

    # --- materials --------------------------------------------------------
    m = SimpleNamespace(**{f: _np(getattr(materials, f))
                           for f in Materials.__dataclass_fields__})
    for i in range(m.base_color_factor.shape[0]):
        mat: dict = {"pbrMetallicRoughness": {
            "baseColorFactor": np.asarray(
                m.base_color_factor[i], np.float64).tolist(),
            "metallicFactor": float(m.metallic_factor[i]),
            "roughnessFactor": float(m.roughness_factor[i]),
        }}

        def tex_ref(slot):
            s = int(slot)
            return {"index": s} if 0 <= s < n_tex else None

        bct = tex_ref(m.base_color_tex[i])
        if bct:
            mat["pbrMetallicRoughness"]["baseColorTexture"] = bct
        mrt = tex_ref(m.metallic_roughness_tex[i])
        if mrt:
            mat["pbrMetallicRoughness"]["metallicRoughnessTexture"] = mrt
        nrt = tex_ref(m.normal_tex[i])
        if nrt:
            nrt["scale"] = float(m.normal_scale[i])
            mat["normalTexture"] = nrt
        emt = tex_ref(m.emissive_tex[i])
        if emt:
            mat["emissiveTexture"] = emt
        em = np.asarray(m.emissive_factor[i], np.float64)
        if em.max() > 0:
            strength = max(float(em.max()), 1.0)
            mat["emissiveFactor"] = (em / strength).tolist()
            if strength > 1.0:
                mat.setdefault("extensions", {})[
                    "KHR_materials_emissive_strength"] = {
                        "emissiveStrength": strength}
        spec = float(m.specular_factor[i])
        if spec != 1.0:
            mat.setdefault("extensions", {})["KHR_materials_specular"] = {
                "specularFactor": spec}
        js["materials"].append(mat)
    exts = set()
    for mat in js["materials"]:
        exts.update(mat.get("extensions", {}).keys())
    if exts:
        js["extensionsUsed"] = sorted(exts)

    # --- meshes -----------------------------------------------------------
    for mesh in g.meshes:
        prims = []
        for p in mesh.primitives:
            pos = np.ascontiguousarray(p.positions, np.float32)
            nrm = np.ascontiguousarray(p.normals, np.float32)
            tan = np.ascontiguousarray(p.tangents, np.float32)
            uv = np.ascontiguousarray(p.uvs, np.float32)
            idx = np.ascontiguousarray(p.indices.reshape(-1), np.uint32)
            attrs = {
                "POSITION": _accessor(js, bw.add(pos.tobytes(), 34962), 5126,
                                      pos.shape[0], "VEC3", pos),
                "NORMAL": _accessor(js, bw.add(nrm.tobytes(), 34962), 5126,
                                    nrm.shape[0], "VEC3", nrm),
                "TANGENT": _accessor(js, bw.add(tan.tobytes(), 34962), 5126,
                                     tan.shape[0], "VEC4", tan),
                "TEXCOORD_0": _accessor(js, bw.add(uv.tobytes(), 34962), 5126,
                                        uv.shape[0], "VEC2", uv),
            }
            prims.append({
                "attributes": attrs,
                "indices": _accessor(js, bw.add(idx.tobytes(), 34963), 5125,
                                     idx.shape[0], "SCALAR", idx),
                "material": p.material,
                "mode": 4,
            })
        js["meshes"].append({"name": mesh.name, "primitives": prims})

    # --- nodes ------------------------------------------------------------
    def emit_node(node: graph_mod.Node) -> int:
        nj: dict = {"name": node.name}
        t = node.transform
        if np.any(t.translation != 0):
            nj["translation"] = t.translation.astype(float).tolist()
        if np.any(t.rotation != np.array([0, 0, 0, 1], np.float32)):
            nj["rotation"] = t.rotation.astype(float).tolist()
        if np.any(t.scale != 1):
            nj["scale"] = t.scale.astype(float).tolist()
        if node.mesh is not None:
            nj["mesh"] = node.mesh
        if node.camera is not None:
            cam = {"type": "perspective", "perspective": {
                "yfov": node.camera.yfov, "znear": node.camera.znear,
                "zfar": node.camera.zfar}}
            if node.camera.aspect:
                cam["perspective"]["aspectRatio"] = node.camera.aspect
            js.setdefault("cameras", []).append(cam)
            nj["camera"] = len(js["cameras"]) - 1
        js["nodes"].append(nj)
        my_idx = len(js["nodes"]) - 1
        child_idx = [emit_node(c) for c in node.children]
        if child_idx:
            js["nodes"][my_idx]["children"] = child_idx
        return my_idx

    js["scenes"][0]["nodes"] = [emit_node(r) for r in g.roots]

    # --- container --------------------------------------------------------
    js["buffers"] = [{"byteLength": len(bw.blob)}]
    js["bufferViews"] = bw.views
    for key in ("samplers", "textures", "images", "materials"):
        if not js[key]:
            del js[key]
    payload = json.dumps(js, separators=(",", ":")).encode()
    payload += b" " * ((-len(payload)) % 4)
    blob = bytes(bw.blob)
    blob += b"\x00" * ((-len(blob)) % 4)
    total = 12 + 8 + len(payload) + 8 + len(blob)
    out = bytearray()
    out += struct.pack("<III", GLB_MAGIC, 2, total)
    out += struct.pack("<II", len(payload), CHUNK_JSON) + payload
    out += struct.pack("<II", len(blob), CHUNK_BIN) + blob
    Path(path).write_bytes(bytes(out))
