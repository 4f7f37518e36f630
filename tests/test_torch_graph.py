"""The port's host scene graph against the reference's: transforms, DFS,
camera lookup and flatten (both are numpy on the host, so results are held
exactly)."""

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.scene import graph as jgraph
from physically_based_renderer_tpu.scene import helmet_asset as jhelmet
from physically_based_renderer_tpu_torch.scene import graph
from physically_based_renderer_tpu_torch.scene import helmet_asset
from torch_parity import assert_graphs_equal, assert_records_equal

torch.set_num_threads(1)


def _random_trs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4).astype(np.float32)
    q /= np.linalg.norm(q)
    return dict(translation=rng.uniform(-3, 3, 3).astype(np.float32),
                rotation=q.astype(np.float32),
                scale=rng.uniform(0.3, 2.5, 3).astype(np.float32))


@pytest.mark.parametrize("seed", range(6))
def test_transform_matrix_round_trip(seed):
    trs = _random_trs(seed)
    t, jt = graph.Transform(**trs), jgraph.Transform(**trs)
    m = t.matrix()
    np.testing.assert_array_equal(m, jt.matrix())
    back = graph.Transform.from_matrix(m)
    jback = jgraph.Transform.from_matrix(m)
    for f in ("translation", "rotation", "scale"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jback, f))
    # TRS -> matrix -> TRS -> matrix is the same matrix (q and -q agree)
    np.testing.assert_allclose(back.matrix(), m, atol=2e-6)
    np.testing.assert_allclose(back.scale, trs["scale"], rtol=1e-5)


@pytest.mark.parametrize("diag", [(1, 1, 1), (-1, 1, 1), (2, -3, 0.5),
                                  (1, 1, -1)])
def test_from_matrix_handles_reflections_and_quaternion_branches(diag):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.diag(np.asarray(diag, np.float32))
    m[:3, 3] = (1, 2, 3)
    a, b = graph.Transform.from_matrix(m), jgraph.Transform.from_matrix(m)
    for f in ("translation", "rotation", "scale"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.matrix(), m, atol=1e-6)


def test_default_transform_is_identity():
    np.testing.assert_array_equal(graph.Transform().matrix(),
                                  np.eye(4, dtype=np.float32))


def _nested(mod):
    """Root -> child -> grandchild with TRS at each level, one quad mesh on
    two of them, a camera on the last."""
    quad = mod.MeshPrimitive(
        positions=np.array([[-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]],
                           np.float32),
        normals=np.tile(np.array([[0, 1, 0]], np.float32), (4, 1)),
        tangents=np.tile(np.array([[1, 0, 0, -1]], np.float32), (4, 1)),
        uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32), material=1)
    g = mod.SceneGraph(name="nested")
    g.meshes = [mod.HostMesh(name="quad", primitives=[quad])]
    leaf = mod.Node(name="leaf", mesh=0,
                    transform=mod.Transform(**_random_trs(12)),
                    camera=mod.CameraDef(yfov=0.7, znear=0.1, zfar=50.0))
    mid = mod.Node(name="mid", transform=mod.Transform(**_random_trs(11)),
                   children=[leaf, mod.Node(name="empty")])
    g.roots = [mod.Node(name="root", mesh=0,
                        transform=mod.Transform(**_random_trs(10)),
                        children=[mid])]
    return g


def test_dfs_find_and_camera_lookup():
    g, jg = _nested(graph), _nested(jgraph)
    assert [n.name for n in g.dfs()] == ["root", "mid", "leaf", "empty"]
    assert [n.name for n in g.dfs()] == [n.name for n in jg.dfs()]
    assert g.find("leaf").camera.yfov == 0.7 and g.find("nope") is None
    (node, world), (jnode, jworld) = g.find_camera(), jg.find_camera()
    assert node.name == jnode.name == "leaf"
    np.testing.assert_array_equal(world, jworld)
    for (n, w), (jn, jw) in zip(g.dfs_with_transform(),
                                jg.dfs_with_transform()):
        assert n.name == jn.name
        np.testing.assert_array_equal(w, jw)


def test_add_default_camera_goes_first():
    g = graph.SceneGraph(roots=[graph.Node(name="a")])
    assert g.find_camera() is None
    cam = g.add_default_camera()
    assert g.roots[0] is cam and cam.name == "DefaultCamera"
    node, world = g.find_camera()
    np.testing.assert_array_equal(world[:3, 3], [0, 0, 5])
    assert node.camera.yfov == jgraph.CameraDef().yfov


def test_flatten_nested_transforms_matches_reference():
    (geo, names), (jgeo, jnames) = _nested(graph).flatten(), _nested(
        jgraph).flatten()
    assert names == jnames == ["root"] * 2 + ["leaf"] * 2
    assert_records_equal(geo, jgeo)
    assert geo.positions.dtype == torch.float32
    assert geo.indices.dtype == geo.tri_material.dtype == torch.int32


def test_flatten_helmet_graph_matches_reference():
    g, _, _ = helmet_asset.build_helmet_graph(0.02)
    jg, _, _ = jhelmet.build_helmet_graph(0.02)
    assert_graphs_equal(g, jg)
    (geo, names), (jgeo, jnames) = g.flatten(), jg.flatten()
    assert names == jnames and set(names) == {"helmet", "collar"}
    assert_records_equal(geo, jgeo)
    assert geo.num_tris == 1880 and geo.num_vertices == jgeo.num_vertices


def test_flatten_without_meshes_raises():
    with pytest.raises(ValueError, match="no mesh geometry"):
        graph.SceneGraph(roots=[graph.Node(name="a")]).flatten()
