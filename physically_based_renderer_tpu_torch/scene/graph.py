"""Host-side scene graph: named TRS nodes, DFS iteration, camera lookup
(port of `scene/graph.py`).

The graph is the editable representation of an asset (`apps/report.py`
prints it); `flatten()` bakes the world transforms into the flat `Geometry`
arena the renderer consumes.  Everything here is numpy on the host, as in
the reference; only `flatten()`'s result is wrapped in CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from .types import Geometry


def _quat_to_mat3_np(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


@dataclasses.dataclass
class Transform:
    """TRS transform.  The quaternion is (x, y, z, w)."""

    translation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, 0, 1], np.float32))
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, np.float32))

    def matrix(self) -> np.ndarray:
        """4x4 = T @ R @ S."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = _quat_to_mat3_np(self.rotation) * self.scale[None, :]
        m[:3, 3] = self.translation
        return m

    @classmethod
    def from_matrix(cls, m: np.ndarray) -> "Transform":
        """Decompose a 4x4 into TRS.  Assumes no shear (glTF guarantees
        TRS-composable node matrices)."""
        m = np.asarray(m, np.float32)
        t = m[:3, 3].copy()
        r3 = m[:3, :3]
        s = np.linalg.norm(r3, axis=0)
        # guard degenerate scale
        s = np.where(s < 1e-12, 1e-12, s)
        rot = r3 / s[None, :]
        if np.linalg.det(rot) < 0:  # negative scale on one axis
            s[0] = -s[0]
            rot[:, 0] = -rot[:, 0]
        q = _mat3_to_quat_np(rot)
        return cls(translation=t, rotation=q, scale=s.astype(np.float32))


def _mat3_to_quat_np(m: np.ndarray) -> np.ndarray:
    tr = np.trace(m)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                      (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        q = np.array([0.25 * s, (m[0, 1] + m[1, 0]) / s,
                      (m[0, 2] + m[2, 0]) / s, (m[2, 1] - m[1, 2]) / s])
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        q = np.array([(m[0, 1] + m[1, 0]) / s, 0.25 * s,
                      (m[1, 2] + m[2, 1]) / s, (m[0, 2] - m[2, 0]) / s])
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        q = np.array([(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s,
                      0.25 * s, (m[1, 0] - m[0, 1]) / s])
    q = q / np.linalg.norm(q)
    return q.astype(np.float32)


@dataclasses.dataclass
class MeshPrimitive:
    """One glTF primitive: host vertex arrays + a material id.  Primitives
    stay separate on the host and are concatenated into the global arena at
    flatten time."""

    positions: np.ndarray   # f32[V,3] object space
    normals: np.ndarray     # f32[V,3]
    tangents: np.ndarray    # f32[V,4]
    uvs: np.ndarray         # f32[V,2]
    indices: np.ndarray     # i32[T,3]
    material: int


@dataclasses.dataclass
class HostMesh:
    name: str
    primitives: list[MeshPrimitive]


@dataclasses.dataclass
class CameraDef:
    """glTF perspective camera parameters (node placement gives the pose)."""

    yfov: float = 1.0471976
    znear: float = 0.01
    zfar: float = 1024.0
    aspect: Optional[float] = None


@dataclasses.dataclass
class Node:
    """Scene-graph node: a name, a transform, children, an optional mesh
    and an optional camera."""

    name: str = ""
    transform: Transform = dataclasses.field(default_factory=Transform)
    children: list["Node"] = dataclasses.field(default_factory=list)
    mesh: Optional[int] = None       # index into SceneGraph.meshes
    camera: Optional[CameraDef] = None

    def dfs(self) -> Iterator["Node"]:
        """Pre-order DFS."""
        yield self
        for c in self.children:
            yield from c.dfs()

    def dfs_with_transform(self, parent: np.ndarray | None = None):
        """DFS yielding (node, world_matrix)."""
        world = (parent if parent is not None
                 else np.eye(4, dtype=np.float32)) @ self.transform.matrix()
        yield self, world
        for c in self.children:
            yield from c.dfs_with_transform(world)


@dataclasses.dataclass
class SceneGraph:
    """Roots + mesh library; the editable host scene."""

    roots: list[Node] = dataclasses.field(default_factory=list)
    meshes: list[HostMesh] = dataclasses.field(default_factory=list)
    name: str = ""

    def dfs(self) -> Iterator[Node]:
        for r in self.roots:
            yield from r.dfs()

    def dfs_with_transform(self):
        for r in self.roots:
            yield from r.dfs_with_transform()

    def find_camera(self) -> Optional[tuple[Node, np.ndarray]]:
        """First camera node + its world matrix."""
        for node, world in self.dfs_with_transform():
            if node.camera is not None:
                return node, world
        return None

    def find(self, name: str) -> Optional[Node]:
        for node in self.dfs():
            if node.name == name:
                return node
        return None

    def add_default_camera(self, position=(0.0, 0.0, 5.0)) -> Node:
        """Insert a 'DefaultCamera' node as the first root."""
        cam = Node(name="DefaultCamera",
                   transform=Transform(
                       translation=np.asarray(position, np.float32)),
                   camera=CameraDef())
        self.roots.insert(0, cam)
        return cam

    def flatten(self):
        """Bake world transforms -> (Geometry arena, per-triangle node names).

        Positions and tangents transform by the linear part, normals by its
        inverse transpose.  The names map device triangles back to graph
        nodes.
        """
        pos_l, nrm_l, tan_l, uv_l, idx_l, mat_l = [], [], [], [], [], []
        names = []
        v_off = 0
        for node, world in self.dfs_with_transform():
            if node.mesh is None:
                continue
            mesh = self.meshes[node.mesh]
            r = world[:3, :3]
            nmat = np.linalg.inv(r).T
            for prim in mesh.primitives:
                p = prim.positions @ r.T + world[:3, 3]
                n = prim.normals @ nmat.T
                n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                                1e-12)
                t3 = prim.tangents[:, :3] @ r.T
                t3 /= np.maximum(np.linalg.norm(t3, axis=-1, keepdims=True),
                                 1e-12)
                tan = np.concatenate([t3, prim.tangents[:, 3:4]], axis=-1)
                pos_l.append(p.astype(np.float32))
                nrm_l.append(n.astype(np.float32))
                tan_l.append(tan.astype(np.float32))
                uv_l.append(prim.uvs.astype(np.float32))
                idx_l.append(prim.indices.astype(np.int32) + v_off)
                mat_l.append(np.full((prim.indices.shape[0],), prim.material,
                                     np.int32))
                names.extend([node.name] * prim.indices.shape[0])
                v_off += p.shape[0]
        if not pos_l:
            raise ValueError("scene graph contains no mesh geometry")
        cat = lambda parts: torch.from_numpy(np.concatenate(parts))
        geometry = Geometry(
            positions=cat(pos_l), normals=cat(nrm_l), tangents=cat(tan_l),
            uvs=cat(uv_l), indices=cat(idx_l), tri_material=cat(mat_l))
        return geometry, names
