"""Procedural test scenes (port of `scene/procedural.py`).

The builders compute in numpy exactly as the reference does and wrap the
result in CPU tensors; `scene.types.upload_scene` moves it to the device.
`make_helmet_class_scene` is the `helmet_proc` config: a displaced
224x224 UV sphere of 100,352 triangles with 256x256 albedo and
metallic-roughness maps under a procedural HDR sky.  `make_spd_tetra` is
the `spd_tetra` config, the port's own (the reference has no such
builder): Haines' Standard Procedural Databases `tetra` under that sky.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import (FILTER_LINEAR, MIP_NONE, WRAP_REPEAT, DirectionalLight,
                    EnvMap, Geometry, Materials, Scene, TextureStack,
                    build_env_tables, make_scene)


def _geometry_from_arrays(positions, indices, tri_material, uvs=None,
                          normals=None, tangents=None) -> Geometry:
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    v = positions.shape[0]
    if normals is None:
        normals = _vertex_normals(positions, indices)
    if uvs is None:
        uvs = np.zeros((v, 2), np.float32)
    if tangents is None:
        tangents = _default_tangents(np.asarray(normals, np.float32))
    t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x, dt))
    return Geometry(
        positions=t(positions, np.float32),
        normals=t(normals, np.float32),
        tangents=t(tangents, np.float32),
        uvs=t(uvs, np.float32),
        indices=t(indices, np.int32),
        tri_material=t(tri_material, np.int32),
    )


def _vertex_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (counter-clockwise winding)."""
    n = np.zeros_like(positions)
    v0, v1, v2 = (positions[indices[:, k]] for k in range(3))
    face_n = np.cross(v1 - v0, v2 - v0)
    for k in range(3):
        np.add.at(n, indices[:, k], face_n)
    lens = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(lens, 1e-12)).astype(np.float32)


def _default_tangents(normals: np.ndarray) -> np.ndarray:
    """Arbitrary valid tangent frame per vertex (w=+1)."""
    t = np.zeros((normals.shape[0], 4), np.float32)
    a = np.where(np.abs(normals[:, 0:1]) < 0.9,
                 np.array([[1.0, 0, 0]], np.float32),
                 np.array([[0, 1.0, 0]], np.float32))
    tan = np.cross(a, normals)
    tan /= np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-12)
    t[:, :3] = tan
    t[:, 3] = 1.0
    return t


def _materials(**fields) -> Materials:
    """Materials.default(n) with the given numpy columns replaced."""
    n = next(iter(fields.values())).shape[0]
    m = Materials.default(n)
    return Materials(**{
        f: (torch.from_numpy(np.ascontiguousarray(fields[f])) if f in fields
            else getattr(m, f)) for f in m.__dataclass_fields__})


def make_triangle_scene(albedo=(0.8, 0.3, 0.2),
                        light_dir=(0.0, 0.0, -1.0),
                        light_radiance=(3.0, 3.0, 3.0)) -> Scene:
    """One Lambertian triangle in the z=0 plane + a directional light."""
    positions = [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]]
    normals = [[0.0, 0.0, 1.0]] * 3
    uvs = [[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]]
    geometry = _geometry_from_arrays(positions, [[0, 1, 2]], [0], uvs=uvs,
                                     normals=normals)
    mats = _materials(
        base_color_factor=np.array([[*albedo, 1.0]], np.float32),
        roughness_factor=np.ones((1,), np.float32),
        metallic_factor=np.zeros((1,), np.float32),
        specular_factor=np.zeros((1,), np.float32))  # exact Lambert
    direction = (np.asarray(light_dir, np.float32)
                 / np.linalg.norm(light_dir)).astype(np.float32)
    directional = DirectionalLight(
        direction=torch.from_numpy(direction),
        radiance=torch.from_numpy(np.asarray(light_radiance, np.float32)))
    return make_scene(geometry, mats, directional=directional)


# Cornell-box layout: y-up right-handed, camera at +z looking toward -z;
# x in [-1,1], y in [0,2], z in [-1,1], open +z face.
CORNELL_WHITE = (0.73, 0.73, 0.73)
CORNELL_RED = (0.65, 0.05, 0.05)
CORNELL_GREEN = (0.12, 0.45, 0.15)
CORNELL_LIGHT = (17.0, 12.0, 4.0)


def _quad(p00, p10, p11, p01):
    """Two CCW triangles for quad corners given in order."""
    return [p00, p10, p11, p01], [[0, 1, 2], [0, 2, 3]]


def make_cornell_box(light_scale: float = 1.0,
                     metallic_tall_block: bool = False,
                     roughness: float = 1.0,
                     textured: bool = False,
                     tex_size: int = 8) -> Scene:
    """Cornell box with an area light (+ optional GGX metallic tall block).

    textured=True attaches a checker albedo map on the white surfaces and a
    metallic-roughness map (G = roughness ramp) on the tall block, both
    tex_size^2 and MIP_NONE (the `cornell_ggx` and `cornell_tex256`
    configs).
    """
    verts: list = []
    faces: list = []
    mat_ids: list = []
    uvs: list = []

    def add_quad(corners, mat):
        v, f = _quad(*corners)
        base = len(verts)
        verts.extend(v)
        faces.extend([[i + base for i in tri] for tri in f])
        mat_ids.extend([mat, mat])
        uvs.extend([[0.0, 0.0], [2.0, 0.0], [2.0, 2.0], [0.0, 2.0]])

    # materials: 0 white, 1 red, 2 green, 3 light, 4 blocks
    add_quad(([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1]), 0)    # floor
    add_quad(([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1]), 0)    # ceiling
    add_quad(([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1]), 0)  # back
    add_quad(([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1]), 1)  # left
    add_quad(([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1]), 2)      # right
    # area light: small quad just under the ceiling, normal -y
    s = 0.35
    eps = 1e-3
    add_quad(([-s, 2 - eps, -s], [s, 2 - eps, -s], [s, 2 - eps, s],
              [-s, 2 - eps, s]), 3)

    def add_box(cx, cz, sx, sz, h, mat):
        x0, x1 = cx - sx, cx + sx
        z0, z1 = cz - sz, cz + sz
        add_quad(([x0, h, z1], [x1, h, z1], [x1, h, z0], [x0, h, z0]), mat)
        add_quad(([x0, 0, z1], [x1, 0, z1], [x1, h, z1], [x0, h, z1]), mat)
        add_quad(([x1, 0, z0], [x0, 0, z0], [x0, h, z0], [x1, h, z0]), mat)
        add_quad(([x1, 0, z1], [x1, 0, z0], [x1, h, z0], [x1, h, z1]), mat)
        add_quad(([x0, 0, z0], [x0, 0, z1], [x0, h, z1], [x0, h, z0]), mat)

    add_box(0.35, 0.35, 0.25, 0.25, 0.6, 0)   # short block, white
    add_box(-0.35, -0.3, 0.25, 0.25, 1.2, 4)  # tall block

    geometry = _geometry_from_arrays(verts, faces, mat_ids,
                                     uvs=np.asarray(uvs, np.float32))
    base = np.ones((5, 4), np.float32)
    base[0, :3] = CORNELL_WHITE
    base[1, :3] = CORNELL_RED
    base[2, :3] = CORNELL_GREEN
    base[3, :3] = (0.0, 0.0, 0.0)  # light emits, reflects nothing
    base[4, :3] = (CORNELL_WHITE if not metallic_tall_block
                   else (0.95, 0.93, 0.88))
    emissive = np.zeros((5, 3), np.float32)
    emissive[3] = np.asarray(CORNELL_LIGHT) * light_scale
    metallic = np.zeros((5,), np.float32)
    rough = np.ones((5,), np.float32)
    if metallic_tall_block:
        metallic[4] = 1.0
        rough[4] = roughness
    # Diffuse-only walls: zero dielectric specular => exact Lambert.
    cols = dict(base_color_factor=base, emissive_factor=emissive,
                metallic_factor=metallic, roughness_factor=rough,
                specular_factor=np.zeros((5,), np.float32))
    textures = None
    if textured:
        ts = tex_size
        albedo = make_checker_texture(ts, 4 if ts <= 16 else 8,
                                      (1.0, 1.0, 1.0), (0.55, 0.55, 0.55))
        mr = np.ones((ts, ts, 4), np.float32)
        xx = np.arange(ts, dtype=np.float32) / (ts - 1.0)
        mr[..., 1] = 0.4 + 0.6 * xx[None, :]   # roughness scale ramp
        mr[..., 2] = 1.0                       # metallic scale (factor rules)
        textures = TextureStack.from_images(
            [albedo, mr], wrap=((WRAP_REPEAT, WRAP_REPEAT),) * 2,
            filt=((FILTER_LINEAR, FILTER_LINEAR, MIP_NONE),) * 2)
        bc_tex = np.full((5,), -1, np.int32)
        mr_tex = np.full((5,), -1, np.int32)
        bc_tex[0] = 0                          # checker on white surfaces
        mr_tex[4] = 1                          # roughness ramp on the block
        cols.update(base_color_tex=bc_tex, metallic_roughness_tex=mr_tex)
    return make_scene(geometry, _materials(**cols), textures=textures)


def make_furnace_scene(albedo: float = 0.7, env_radiance: float = 1.0,
                       metallic: float = 0.0, roughness: float = 1.0,
                       specular: float = 0.0) -> Scene:
    """Furnace test: a sphere in a constant environment.  A Lambert sphere
    of albedo 1 disappears into the background."""
    sphere = make_uv_sphere(radius=1.0, rings=32, sectors=64)
    mats = _materials(
        base_color_factor=np.asarray([[albedo, albedo, albedo, 1.0]],
                                     np.float32),
        metallic_factor=np.asarray([metallic], np.float32),
        roughness_factor=np.asarray([roughness], np.float32),
        specular_factor=np.asarray([specular], np.float32))
    return make_scene(sphere, mats,
                      env=EnvMap.constant((env_radiance,) * 3))


def make_uv_sphere(radius: float = 1.0, rings: int = 16, sectors: int = 32,
                   center=(0.0, 0.0, 0.0), material: int = 0) -> Geometry:
    """UV-sphere triangle mesh with exact normals and spherical UVs."""
    ring_t = np.linspace(0.0, np.pi, rings + 1)
    sec_t = np.linspace(0.0, 2.0 * np.pi, sectors + 1)
    verts, normals, uvs = [], [], []
    for i, th in enumerate(ring_t):
        for j, ph in enumerate(sec_t):
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)], np.float32)
            verts.append(np.asarray(center, np.float32) + radius * n)
            normals.append(n)
            uvs.append([j / sectors, i / rings])
    faces = []
    stride = sectors + 1
    for i in range(rings):
        for j in range(sectors):
            a = i * stride + j
            b = a + stride
            faces.append([a, b, a + 1])
            faces.append([a + 1, b, b + 1])
    faces_np = np.asarray(faces, np.int32)
    return _geometry_from_arrays(
        np.asarray(verts), faces_np, [material] * len(faces_np),
        uvs=np.asarray(uvs, np.float32), normals=np.asarray(normals))


def make_random_tris(n: int, seed: int = 0,
                     extent: float = 1.0) -> Geometry:
    """Random triangle soup for BVH stress tests (the reference's numpy
    draws, so the same bytes)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    offs = rng.normal(0.0, 0.1 * extent, (n, 3, 3)).astype(np.float32)
    verts = (centers[:, None, :] + offs).reshape(-1, 3)
    faces = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    return _geometry_from_arrays(verts, faces, [0] * n)


def make_checker_texture(size: int = 256, squares: int = 8,
                         c0=(0.8, 0.8, 0.8), c1=(0.2, 0.3, 0.6)):
    """Procedural checkerboard RGBA texture (linear) f32[size, size, 4]."""
    y, x = np.mgrid[0:size, 0:size]
    cell = ((x * squares // size) + (y * squares // size)) % 2
    tex = np.where(cell[..., None] == 0,
                   np.asarray(c0 + (1.0,), np.float32),
                   np.asarray(c1 + (1.0,), np.float32))
    return tex.astype(np.float32)


def make_gradient_sky(height: int = 64, width: int = 128,
                      zenith=(0.3, 0.5, 1.2), horizon=(0.9, 0.8, 0.7),
                      sun_dir=(0.3, 0.8, 0.2), sun_radiance=(60.0,) * 3,
                      sun_sharpness: float = 400.0) -> EnvMap:
    """Procedural HDR sky (gradient + sun disc) with importance tables."""
    theta = (np.arange(height) + 0.5) / height * np.pi
    phi = ((np.arange(width) + 0.5) / width - 0.5) * 2.0 * np.pi
    y = np.cos(theta)[:, None]
    t = np.clip(y, 0.0, 1.0)
    base = (t[..., None] * np.asarray(zenith, np.float32)
            + (1 - t)[..., None] * np.asarray(horizon, np.float32))
    dirs = np.stack(np.broadcast_arrays(
        np.sin(theta)[:, None] * np.cos(phi)[None, :],
        np.broadcast_to(y, (height, width)),
        np.sin(theta)[:, None] * np.sin(phi)[None, :]), axis=-1)
    sd = np.asarray(sun_dir, np.float32)
    sd = sd / np.linalg.norm(sd)
    cos = np.clip((dirs * sd).sum(-1), 0.0, 1.0)
    sun = np.exp((cos - 1.0) * sun_sharpness)[..., None] * np.asarray(
        sun_radiance, np.float32)
    return build_env_tables((base + sun).astype(np.float32))


def make_helmet_class_scene(rings: int = 224, sectors: int = 224,
                            bump: float = 0.06, seed: int = 0) -> Scene:
    """The `helmet_proc` scene: a ~100k-triangle displaced, textured,
    metallic-roughness sphere under an HDR sky (`seed` is unused, as in
    the reference)."""
    g = make_uv_sphere(radius=1.0, rings=rings, sectors=sectors)
    p = g.positions.numpy()
    n = g.normals.numpy()
    disp = (np.sin(5.0 * p[:, 0]) * np.sin(4.0 * p[:, 1])
            * np.sin(6.0 * p[:, 2]))
    p = (p + n * (bump * disp)[:, None].astype(np.float32)).astype(
        np.float32)
    g = dataclasses.replace(
        g, positions=torch.from_numpy(p),
        normals=torch.from_numpy(_vertex_normals(p, g.indices.numpy())))

    albedo = make_checker_texture(256, 12, (0.7, 0.45, 0.2), (0.2, 0.2, 0.25))
    # MR texture: G = roughness ramp, B = metallic split
    mr = np.zeros((256, 256, 4), np.float32)
    yy, xx = np.mgrid[0:256, 0:256]
    mr[..., 1] = 0.15 + 0.7 * (xx / 255.0)
    mr[..., 2] = (yy > 128).astype(np.float32)
    mr[..., 3] = 1.0
    mats = _materials(base_color_tex=np.asarray([0], np.int32),
                      metallic_roughness_tex=np.asarray([1], np.int32))
    return make_scene(g, mats, textures=TextureStack.from_images([albedo, mr]),
                      env=make_gradient_sky())


# The root of Haines' SPD `tetra` (E. Haines, "A Proposal for Standard
# Graphics Environments", IEEE CG&A 7(11), 1987): the regular tetrahedron on
# alternating corners of the cube [-1, 1]^3.
SPD_TETRA_CORNERS = ((1.0, 1.0, 1.0), (1.0, -1.0, -1.0),
                     (-1.0, 1.0, -1.0), (-1.0, -1.0, 1.0))


def spd_tetra_triangles(depth: int = 4) -> np.ndarray:
    """The faces of the recursive Sierpinski tetrahedron, f32[4^depth * 4,
    3, 3].  Each level replaces a tetrahedron by its four half-size copies,
    the i-th scaled by 1/2 about its i-th corner (depth first, corner
    order); a leaf gives its four faces, the i-th opposite its i-th
    corner, wound counter-clockwise seen from outside.  Every coordinate
    is a dyadic fraction, exact in float32."""
    def leaves(corners, level):
        if level == 0:
            yield corners
            return
        for c in corners:
            yield from leaves([(c + q) / 2.0 for q in corners], level - 1)

    faces = []
    root = [np.asarray(c, np.float64) for c in SPD_TETRA_CORNERS]
    for corners in leaves(root, depth):
        for i, apex in enumerate(corners):
            a, b, c = (corners[j] for j in range(4) if j != i)
            if np.dot(np.cross(b - a, c - a), apex - a) > 0.0:
                b, c = c, b                     # the normal faced the apex
            faces.append((a, b, c))
    return np.asarray(faces, np.float32)


def make_spd_tetra(depth: int = 4) -> Scene:
    """The `spd_tetra` config: SPD `tetra` at `depth` (4: 1,024
    triangles), each face its own three vertices (flat shaded), one
    metallic-roughness material (base colour 0.8, roughness 0.5, metallic
    0, the default dielectric specular, so GGX is sampled beside Lambert)
    under `make_gradient_sky`, the only light.  The SPD's point lights and
    flat background have no counterpart in the port; the material and the
    sky are set here."""
    tris = spd_tetra_triangles(depth)
    n = tris.shape[0]
    geometry = _geometry_from_arrays(
        tris.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3),
        np.zeros((n,), np.int32))
    mats = _materials(
        base_color_factor=np.asarray([[0.8, 0.8, 0.8, 1.0]], np.float32),
        roughness_factor=np.asarray([0.5], np.float32),
        metallic_factor=np.zeros((1,), np.float32))
    return make_scene(geometry, mats, env=make_gradient_sky())
