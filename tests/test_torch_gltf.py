"""The port's glTF ingest and export against the reference's: the same
documents through both loaders give the same Scene arrays (ints exact,
floats to 1e-7), the same camera and the same graph; malformed inputs raise
GltfError in both; .glb files cross between the packages both ways."""

import base64
import copy
import json

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.scene import gltf as JG
from physically_based_renderer_tpu.scene import graph as jgraph
from physically_based_renderer_tpu.scene import helmet_asset as jhelmet
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu.scene.export import (
    export_glb as j_export_glb)
from physically_based_renderer_tpu_torch.core import film
from physically_based_renderer_tpu_torch.scene import gltf as G
from physically_based_renderer_tpu_torch.scene import graph
from physically_based_renderer_tpu_torch.scene import helmet_asset
from physically_based_renderer_tpu_torch.scene import types
from physically_based_renderer_tpu_torch.scene.export import export_glb
from test_asset_golden import _author_asset
from test_gltf import _tri_gltf_json
from torch_parity import (assert_cameras_equal, assert_graphs_equal,
                          assert_scene_matches, np_)

torch.set_num_threads(1)

URI = "data:application/octet-stream;base64,"


def _blob(js):
    return base64.b64decode(js["buffers"][0]["uri"].split(",")[1])


def _set_blob(js, blob):
    js["buffers"][0] = {"uri": URI + base64.b64encode(blob).decode(),
                        "byteLength": len(blob)}


def _append(js, data, **acc):
    """Append bytes as a new bufferView (+ accessor); return its index."""
    blob = _blob(js)
    blob += b"\x00" * ((-len(blob)) % 4)
    js["bufferViews"].append({"buffer": 0, "byteOffset": len(blob),
                              "byteLength": len(data)})
    _set_blob(js, blob + data)
    if acc:
        js["accessors"].append({"bufferView": len(js["bufferViews"]) - 1,
                                **acc})
        return len(js["accessors"]) - 1
    return len(js["bufferViews"]) - 1


def _png_uri(img):
    return "data:image/png;base64," + base64.b64encode(
        film.encode_png(img)).decode()


def _doc_plain():
    return _tri_gltf_json()


def _doc_no_normals_tangents():
    js = _tri_gltf_json()
    del js["meshes"][0]["primitives"][0]["attributes"]["NORMAL"]
    return js


def _doc_no_uvs_no_indices():
    js = _tri_gltf_json()
    prim = js["meshes"][0]["primitives"][0]
    del prim["attributes"]["TEXCOORD_0"]
    del prim["indices"]
    return js


def _doc_u8_indices_two_tris():
    js = _tri_gltf_json()
    pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0.5], [-1, 1, 0]],
                   np.float32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    a = _append(js, pos.tobytes(), componentType=5126, count=4, type="VEC3")
    b = _append(js, uv.tobytes(), componentType=5126, count=4, type="VEC2")
    c = _append(js, np.array([0, 1, 2, 0, 2, 3], np.uint8).tobytes(),
                componentType=5121, count=6, type="SCALAR")
    js["meshes"][0]["primitives"][0] = {
        "attributes": {"POSITION": a, "TEXCOORD_0": b}, "indices": c,
        "material": 0}
    return js


def _doc_tangents_given_and_interleaved():
    """Explicit VEC4 tangents, and positions + normals interleaved in one
    strided bufferView; u32 indices."""
    js = _tri_gltf_json()
    pos = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.array([[0, 0, 1]], np.float32), (3, 1))
    inter = np.concatenate([pos, nrm], axis=1).astype(np.float32)
    view = _append(js, inter.tobytes())
    js["bufferViews"][view]["byteStride"] = 24
    js["accessors"] += [
        {"bufferView": view, "componentType": 5126, "count": 3,
         "type": "VEC3"},
        {"bufferView": view, "byteOffset": 12, "componentType": 5126,
         "count": 3, "type": "VEC3"}]
    p, n = len(js["accessors"]) - 2, len(js["accessors"]) - 1
    tan = np.tile(np.array([[0, 1, 0, -1]], np.float32), (3, 1))
    t = _append(js, tan.tobytes(), componentType=5126, count=3, type="VEC4")
    i = _append(js, np.array([0, 1, 2], np.uint32).tobytes(),
                componentType=5125, count=3, type="SCALAR")
    js["meshes"][0]["primitives"][0] = {
        "attributes": {"POSITION": p, "NORMAL": n, "TANGENT": t,
                       "TEXCOORD_0": 2}, "indices": i, "material": 0}
    return js


def _doc_sparse_and_normalized():
    js = _tri_gltf_json()
    vi = _append(js, np.array([2], np.uint16).tobytes())
    vv = _append(js, np.array([[0, 2, 0]], np.float32).tobytes())
    js["accessors"][0]["sparse"] = {
        "count": 1, "indices": {"bufferView": vi, "componentType": 5123},
        "values": {"bufferView": vv}}
    uv = np.array([[0, 0], [65535, 0], [32768, 65535]], np.uint16)
    js["meshes"][0]["primitives"][0]["attributes"]["TEXCOORD_0"] = _append(
        js, uv.tobytes(), componentType=5123, count=3, type="VEC2",
        normalized=True)
    return js


def _doc_extensions():
    return _tri_gltf_json(extra_material={
        "emissiveFactor": [1.0, 0.5, 0.25],
        "extensions": {
            "KHR_materials_emissive_strength": {"emissiveStrength": 4.0},
            "KHR_materials_specular": {"specularFactor": 0.0}}})


def _doc_hierarchy_matrix_camera():
    js = _tri_gltf_json()
    m = np.diag([2.0, 2.0, 2.0, 1.0])
    m[:3, 3] = [3, 0, 0]
    q = np.array([0.1, 0.7, -0.2, 0.6])
    q /= np.linalg.norm(q)
    js["cameras"] = [{"type": "perspective", "perspective": {
        "yfov": 0.8, "znear": 0.05, "zfar": 90.0, "aspectRatio": 1.5}}]
    js["nodes"] = [
        {"name": "parent", "translation": [1, 0, 0], "children": [1, 2]},
        {"name": "child", "mesh": 0, "translation": [0, 1, 0],
         "rotation": q.tolist(), "scale": [1, 2, 0.5]},
        {"name": "mat", "mesh": 0, "matrix": m.T.reshape(-1).tolist(),
         "children": [3]},
        {"name": "eye", "camera": 0, "translation": [0.5, 0.25, 6.0],
         "rotation": [0, 0.1, 0, 0.99498743710662]},
    ]
    js["scenes"] = [{"name": "main", "nodes": [0]}]
    return js


def _doc_textures_and_samplers():
    """Four textures over three images: sRGB and linear use of one image,
    every wrap mode, nearest/linear/mip filters, texCoord 1 ignored."""
    js = _tri_gltf_json()
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 256, (8, 8, 4)).astype(np.uint8),
            rng.integers(0, 256, (4, 16, 3)).astype(np.uint8),
            rng.integers(0, 256, (2, 2)).astype(np.uint8)]
    js["images"] = [{"uri": _png_uri(im)} for im in imgs]
    js["samplers"] = [
        {"wrapS": 33071, "wrapT": 33648, "magFilter": 9728,
         "minFilter": 9984},
        {"wrapS": 10497, "wrapT": 33071, "magFilter": 9729,
         "minFilter": 9987},
        {"minFilter": 9729}]
    js["textures"] = [{"source": 0, "sampler": 0}, {"source": 1, "sampler": 1},
                      {"source": 2, "sampler": 2}, {"source": 0}, {}]
    js["materials"] = [
        {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 0},
            "metallicRoughnessTexture": {"index": 1}},
         "normalTexture": {"index": 3, "scale": 0.5},
         "emissiveTexture": {"index": 2}, "emissiveFactor": [1, 1, 1]},
        {"pbrMetallicRoughness": {
            "baseColorTexture": {"index": 1, "texCoord": 1},
            "metallicRoughnessTexture": {"index": 0}}}]
    return js


DOCS = {
    "plain": _doc_plain,
    "no_normals_tangents": _doc_no_normals_tangents,
    "no_uvs_no_indices": _doc_no_uvs_no_indices,
    "u8_indices_two_tris": _doc_u8_indices_two_tris,
    "tangents_interleaved_u32": _doc_tangents_given_and_interleaved,
    "sparse_and_normalized": _doc_sparse_and_normalized,
    "extensions": _doc_extensions,
    "hierarchy_matrix_camera": _doc_hierarchy_matrix_camera,
    "textures_and_samplers": _doc_textures_and_samplers,
}


def _write(js, tmp_path, container):
    """The document as a .gltf with a data URI, a .gltf with an external
    .bin, or a .glb."""
    js = copy.deepcopy(js)
    if container == "data_uri":
        path = tmp_path / "doc.gltf"
        path.write_text(json.dumps(js))
    elif container == "external_bin":
        (tmp_path / "my data.bin").write_bytes(_blob(js))
        js["buffers"][0]["uri"] = "my%20data.bin"
        path = tmp_path / "doc.gltf"
        path.write_text(json.dumps(js))
    else:
        blob = _blob(js)
        js["buffers"][0] = {"byteLength": len(blob)}
        payload = json.dumps(js).encode()
        payload += b" " * ((-len(payload)) % 4)
        blob += b"\x00" * ((-len(blob)) % 4)
        import struct
        out = struct.pack("<III", G.GLB_MAGIC, 2,
                          28 + len(payload) + len(blob))
        out += struct.pack("<II", len(payload), G.CHUNK_JSON) + payload
        out += struct.pack("<II", len(blob), G.CHUNK_BIN) + blob
        path = tmp_path / "doc.glb"
        path.write_bytes(out)
    return path


def _assert_loads_alike(path, **kw):
    jkw = dict(kw)
    if "directional" in kw:
        d = kw["directional"]
        jkw["directional"] = jtypes.DirectionalLight(
            direction=np_(d.direction), radiance=np_(d.radiance))
    scene, g, cam = G.load(path, **kw)
    jscene, jg, jcam = JG.load(path, **jkw)
    assert_scene_matches(scene, jscene)
    assert_graphs_equal(g, jg)
    assert_cameras_equal(cam, jcam)
    return scene, g, cam


@pytest.mark.parametrize("container", ["data_uri", "external_bin", "glb"])
@pytest.mark.parametrize("name", sorted(DOCS))
def test_documents_load_like_the_reference(name, container, tmp_path):
    path = _write(DOCS[name](), tmp_path, container)
    scene, g, cam = _assert_loads_alike(path)
    assert scene.geometry.positions.dtype == torch.float32
    assert scene.device.type == "cpu"


def test_specific_values(tmp_path):
    scene, g, cam = G.load(_write(_doc_extensions(), tmp_path, "glb"))
    np.testing.assert_allclose(np_(scene.materials.emissive_factor[0]),
                               [4.0, 2.0, 1.0])
    assert float(scene.materials.specular_factor[0]) == 0.0
    assert scene.has_emitters and g.roots[0].name == "DefaultCamera"
    scene, g, cam = G.load(_write(_doc_hierarchy_matrix_camera(), tmp_path,
                                  "data_uri"))
    assert g.name == "main" and g.find_camera()[0].name == "eye"
    assert float(cam.fov_y) == np.float32(0.8)
    assert g.find("eye").camera.aspect == 1.5
    scene, _, _ = G.load(_write(_doc_textures_and_samplers(), tmp_path,
                                "glb"))
    # image 0 is used as sRGB (slot 0) and as linear data (slot 3)
    assert scene.textures.shapes == ((8, 8), (4, 16), (2, 2), (8, 8))
    assert scene.textures.wrap[0] == (types.WRAP_CLAMP, types.WRAP_MIRROR)
    assert scene.textures.filt[0] == (types.FILTER_NEAREST,
                                      types.FILTER_NEAREST, types.MIP_NEAREST)
    assert scene.textures.filt[2] == (types.FILTER_LINEAR,
                                      types.FILTER_LINEAR, types.MIP_NONE)
    assert scene.tex_slots == (True, True, True, True)
    assert not torch.equal(scene.textures.texels[:64],
                           scene.textures.texels[-64:])
    assert int(scene.materials.base_color_tex[1]) == -1     # texCoord 1


def test_load_with_lights_matches_reference(tmp_path):
    from physically_based_renderer_tpu.scene.procedural import (
        make_gradient_sky as j_sky)
    from physically_based_renderer_tpu_torch.scene.procedural import (
        make_gradient_sky)
    path = _write(_doc_plain(), tmp_path, "glb")
    light = types.DirectionalLight(direction=torch.tensor([0.0, 0.0, -1.0]),
                                   radiance=torch.tensor([3.0, 3.0, 3.0]))
    scene, _, _ = _assert_loads_alike(path, directional=light)
    assert scene.has_directional
    scene, _, _ = G.load(path, env=make_gradient_sky(8, 16))
    jscene, _, _ = JG.load(path, env=j_sky(8, 16))
    assert_scene_matches(scene, jscene)


def _broken(case, tmp_path):
    js = _tri_gltf_json()
    if case == "missing":
        return tmp_path / "nope.gltf"
    if case == "no_position":
        del js["meshes"][0]["primitives"][0]["attributes"]["POSITION"]
    elif case == "lines":
        js["meshes"][0]["primitives"][0]["mode"] = 1
    elif case == "short_buffer":
        js["buffers"][0]["byteLength"] = 4096
    elif case == "no_uri_no_bin":
        del js["buffers"][0]["uri"]
    elif case == "image_without_source":
        js["images"] = [{}]
        js["textures"] = [{"source": 0}]
        js["materials"][0]["pbrMetallicRoughness"]["baseColorTexture"] = {
            "index": 0}
    elif case in ("bad_magic", "bad_version", "too_short", "no_json"):
        import struct
        data = {"bad_magic": b"glTF" + b"\x00" * 3,
                "too_short": b"glTF\x02\x00",
                "bad_version": struct.pack("<III", G.GLB_MAGIC, 1, 12),
                "no_json": struct.pack("<III", G.GLB_MAGIC, 2, 12)}[case]
        path = tmp_path / "bad.glb"
        path.write_bytes(data)
        return path
    path = tmp_path / "bad.gltf"
    path.write_text(json.dumps(js))
    return path


@pytest.mark.parametrize("case", [
    "missing", "no_position", "lines", "short_buffer", "no_uri_no_bin",
    "image_without_source", "bad_magic", "bad_version", "too_short",
    "no_json"])
def test_malformed_inputs_raise_gltf_error_in_both(case, tmp_path):
    path = _broken(case, tmp_path)
    with pytest.raises(JG.GltfError) as jerr:
        JG.load(path)
    with pytest.raises(G.GltfError) as err:
        G.load(path)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("keep", [0.02, 0.5, 0.97])
def test_truncated_glb_raises_gltf_error(keep, tmp_path):
    """A tested divergence: a cut-off file or unparsable JSON is a GltfError
    in the port (the CLIs print it and return 2); the reference lets a
    JSONDecodeError or a numpy ValueError through."""
    whole = _write(_doc_textures_and_samplers(), tmp_path, "glb").read_bytes()
    path = tmp_path / "cut.glb"
    path.write_bytes(whole[:int(len(whole) * keep)])
    with pytest.raises(G.GltfError):
        G.load(path)
    path = tmp_path / "cut.gltf"
    path.write_text(json.dumps(_tri_gltf_json())[:200])
    with pytest.raises(G.GltfError, match="JSON"):
        G.load(path)


def _port_graph_of(jg):
    """A reference graph rebuilt from the port's classes (same arrays)."""
    def node(n):
        return graph.Node(
            name=n.name, mesh=n.mesh,
            transform=graph.Transform(n.transform.translation,
                                      n.transform.rotation, n.transform.scale),
            camera=(None if n.camera is None else graph.CameraDef(
                n.camera.yfov, n.camera.znear, n.camera.zfar,
                n.camera.aspect)),
            children=[node(c) for c in n.children])
    g = graph.SceneGraph(name=jg.name, roots=[node(r) for r in jg.roots])
    g.meshes = [graph.HostMesh(m.name, [graph.MeshPrimitive(
        p.positions, p.normals, p.tangents, p.uvs, p.indices, p.material)
        for p in m.primitives]) for m in jg.meshes]
    return g


def _port_materials(jm):
    return types.Materials(**{
        f: torch.from_numpy(np.array(getattr(jm, f)))
        for f in types.Materials.__dataclass_fields__})


def test_glb_files_cross_between_the_packages(tmp_path):
    """The asset of tests/test_asset_golden.py, written by the reference and
    by the port: each loader reads both files to the same scene."""
    ref_file, port_file = tmp_path / "ref.glb", tmp_path / "port.glb"
    _author_asset(ref_file)
    jscene, jg, _ = JG.load(ref_file)
    # the same graph, materials and (linear, as authored) textures through
    # the port's exporter
    from physically_based_renderer_tpu.scene.procedural import (
        make_checker_texture)
    albedo = make_checker_texture(32, 8, (0.8, 0.5, 0.3), (0.2, 0.3, 0.6))
    mr = np.ones((8, 16, 4), np.float32)
    mr[..., 1], mr[..., 2] = 0.6, 0.0
    stack = types.TextureStack.from_images([albedo, mr])
    jg.roots = [r for r in jg.roots if r.name != "DefaultCamera"]
    export_glb(port_file, _port_graph_of(jg), _port_materials(
        jscene.materials), stack)
    loaded = {}
    for who, load in (("port", G.load), ("ref", JG.load)):
        for which, f in (("ref_file", ref_file), ("port_file", port_file)):
            loaded[who, which] = load(f)
    for which in ("ref_file", "port_file"):
        (s, g, c), (js, jg2, jc) = loaded["port", which], loaded["ref", which]
        assert_scene_matches(s, js)
        assert_graphs_equal(g, jg2)
        assert_cameras_equal(c, jc)
    # and the two files hold the same scene
    assert_scene_matches(loaded["port", "port_file"][0],
                         loaded["ref", "ref_file"][0])
    assert loaded["port", "ref_file"][0].geometry.num_tris == 12 * 16 * 2 + 4


def test_helmet_glb_crosses_between_the_packages(tmp_path):
    ref_file = jhelmet.author_helmet_glb(tmp_path / "ref.glb", 0.02)
    port_file = helmet_asset.author_helmet_glb(tmp_path / "port.glb", 0.02)
    a, _, _ = G.load(ref_file)
    b, _, _ = JG.load(port_file)
    c, _, _ = JG.load(ref_file)
    assert_scene_matches(a, c)
    assert_scene_matches(a, b)
    assert a.tex_slots == (True, True, True, True)
    assert a.textures.shapes == ((256, 256), (256, 256), (128, 128), (64, 64))


def test_export_is_deterministic_and_keeps_samplers(tmp_path):
    g, m, stack = helmet_asset.build_helmet_graph(0.02)
    stack = types.TextureStack.from_images(
        [stack.image(i) for i in range(4)],
        wrap=((types.WRAP_CLAMP, types.WRAP_MIRROR),) * 4)
    export_glb(tmp_path / "a.glb", g, m, stack)
    export_glb(tmp_path / "b.glb", g, m, stack)
    assert ((tmp_path / "a.glb").read_bytes()
            == (tmp_path / "b.glb").read_bytes())
    scene, _, _ = G.load(tmp_path / "a.glb")
    assert scene.textures.wrap == ((types.WRAP_CLAMP, types.WRAP_MIRROR),) * 4
    np.testing.assert_allclose(np_(scene.materials.emissive_factor),
                               np_(m.emissive_factor), rtol=1e-6)
    np.testing.assert_array_equal(np_(scene.materials.normal_tex),
                                  np_(m.normal_tex))
    # 8-bit quantisation of the albedo's sRGB round trip
    np.testing.assert_allclose(scene.textures.image(0), stack.image(0),
                               atol=2e-2)


def test_lanczos_downscale_matches_reference_and_names_pil(tmp_path,
                                                           monkeypatch):
    js = _doc_textures_and_samplers()
    path = _write(js, tmp_path, "glb")
    scene, _, _ = G.load(path, max_texture_dim=4)
    jscene, _, _ = JG.load(path, max_texture_dim=4)
    assert scene.textures.shapes == ((4, 4), (1, 4), (2, 2), (4, 4))
    assert_scene_matches(scene, jscene)

    def no_pil(name):
        raise ImportError(name)
    monkeypatch.setattr(G.importlib, "import_module", no_pil)
    with pytest.raises(G.GltfError, match="PIL"):
        G.load(path, max_texture_dim=4)
    G.load(path)                                # PNG alone needs no PIL
