"""Haines' SPD `tetra` for the plain reference, written from its definition
(E. Haines, "A Proposal for Standard Graphics Environments", IEEE CG&A
7(11), 1987; the Standard Procedural Databases' `tetra`): the regular
tetrahedron on the cube corners (1,1,1), (1,-1,-1), (-1,1,-1), (-1,-1,1);
each level replaces every tetrahedron by four half-size copies, copy i
scaled by 1/2 about corner i.  The leaves are kept in the order of a
depth-first walk (copy 4p + i of tetrahedron p) and each gives four
faces, face i opposite its corner i, wound counter-clockwise seen from
outside.

The scene is assembled by the frozen reference (`reference/pbr_plain`):
each face its own three vertices, one metallic-roughness material (base
colour 0.8, roughness 0.5, metallic 0, the default dielectric specular)
and `make_gradient_sky` as the only light, as the benchmark's
configuration `configs/spd_tetra.json` states.  Imports numpy and the
frozen reference only.
"""

from __future__ import annotations

import numpy as np

from reference.pbr_plain.scene import procedural, types

CORNERS = np.array([[1.0, 1.0, 1.0], [1.0, -1.0, -1.0],
                    [-1.0, 1.0, -1.0], [-1.0, -1.0, 1.0]])
# The corners of face i, the face opposite corner i, in counter-clockwise
# order seen from outside the root.  The copies are scaled and moved,
# never mirrored, so the same orders wind every leaf's faces outward.
FACES = np.array([[1, 3, 2], [0, 2, 3], [0, 3, 1], [0, 1, 2]])


def tetra_triangles(depth: int) -> np.ndarray:
    """f32[4^depth * 4, 3, 3]: the leaves' faces, leaf by leaf."""
    tets = CORNERS[None]                                   # [N, 4, 3]
    for _ in range(depth):
        # [N, i, j]: corner j of tetrahedron N moved halfway to corner i.
        tets = ((tets[:, :, None] + tets[:, None, :]) / 2.0).reshape(-1, 4, 3)
    return tets[:, FACES].reshape(-1, 3, 3).astype(np.float32)


def make_spd_tetra(depth: int = 4):
    """The configuration's scene, built by the reference."""
    tris = tetra_triangles(depth)
    n = tris.shape[0]
    geometry = procedural._geometry_from_arrays(
        tris.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3),
        np.zeros((n,), np.int32))
    mats = procedural._materials(
        base_color_factor=np.array([[0.8, 0.8, 0.8, 1.0]], np.float32),
        roughness_factor=np.array([0.5], np.float32),
        metallic_factor=np.zeros((1,), np.float32))
    return types.make_scene(geometry, mats, env=procedural.make_gradient_sky())
