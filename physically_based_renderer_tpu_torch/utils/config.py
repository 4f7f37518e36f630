"""Named render configs (port of `utils/config.py`).

Same config names and `RenderConfig`s as the reference, and one of the
port's own, `spd_tetra` (Haines' SPD `tetra` at depth 4, 1,024 triangles,
under the HDR sky: the dense loop through phase A and K1).  `build_scene`
builds every scene and attaches the cluster grid of `SceneSpec.cluster_k`
triangles a cluster, as the reference does:
the procedural ones (triangle, cornell, cornell_ggx, cornell_tex256,
helmet_proc, spd_tetra), `helmet` (the authored .glb read back through
scene/gltf.py) and `gltf` (a file named by `extra["path"]`, with the
file's camera).
"""

from __future__ import annotations

import dataclasses

from ..integrator.path import RenderConfig


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """How to obtain the scene + camera for a named config."""

    builder: str               # 'triangle' | 'cornell' | 'cornell_ggx' |
    #                            'helmet' | 'helmet_glb' | 'spd_tetra' |
    #                            'gltf'
    camera_position: tuple = (0.0, 1.0, 3.9)
    camera_target: tuple = (0.0, 1.0, 0.0)
    fov_y: float = 0.95
    cluster_k: int | None = None   # None = accel/clusters.CLUSTER_K
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    """A named, fully specified render setup."""

    name: str
    render: RenderConfig
    scene: SceneSpec
    description: str = ""


CONFIGS: dict[str, BenchConfig] = {}


def _register(cfg: BenchConfig) -> BenchConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


_register(BenchConfig(
    name="triangle",
    description="single triangle + directional light, Lambertian, 1 bounce, "
                "256x256",
    render=RenderConfig(width=256, height=256, spp=4, max_bounces=1),
    scene=SceneSpec(builder="triangle", camera_position=(0.0, 0.0, 3.0),
                    camera_target=(0.0, 0.0, 0.0), fov_y=1.2),
))
_register(BenchConfig(
    name="cornell",
    description="Cornell box, diffuse-only path tracing, 4 bounces, NEE+MIS, "
                "512x512",
    render=RenderConfig(width=512, height=512, spp=4, max_bounces=4),
    scene=SceneSpec(builder="cornell"),
))
_register(BenchConfig(
    name="cornell_ggx",
    description="metallic-roughness GGX materials + textures, MIS, 4 spp",
    render=RenderConfig(width=512, height=512, spp=4, max_bounces=4),
    scene=SceneSpec(builder="cornell_ggx", extra={"roughness": 0.25}),
))
_register(BenchConfig(
    name="helmet",
    description="DamagedHelmet-class .glb asset (~100k tris, textures, "
                "normal + emissive maps) under an HDR environment map",
    render=RenderConfig(width=512, height=512, spp=4, max_bounces=3,
                        block_size=512),
    scene=SceneSpec(builder="helmet_glb", camera_position=(0.0, 0.1, 3.0),
                    camera_target=(0.0, 0.0, 0.0), fov_y=1.0),
))
_register(BenchConfig(
    name="helmet_proc",
    description="procedurally displaced textured sphere + HDR env",
    render=RenderConfig(width=512, height=512, spp=4, max_bounces=3),
    scene=SceneSpec(builder="helmet", camera_position=(0.0, 0.0, 3.0),
                    camera_target=(0.0, 0.0, 0.0), fov_y=1.0),
))
_register(BenchConfig(
    name="cornell_tex256",
    description="cornell_ggx with 256x256 albedo + metallic-roughness maps",
    render=RenderConfig(width=512, height=512, spp=4, max_bounces=4),
    scene=SceneSpec(builder="cornell_ggx",
                    extra={"roughness": 0.25, "tex_size": 256}),
))
_register(BenchConfig(
    name="spd_tetra",
    description="Haines' SPD tetra at depth 4 (1,024 triangles), one "
                "metallic-roughness material under an HDR sky, 4 bounces, "
                "NEE+MIS, 512x512",
    render=RenderConfig(width=512, height=512, spp=4, max_bounces=4),
    scene=SceneSpec(builder="spd_tetra", camera_position=(2.2, 1.6, 3.0),
                    camera_target=(0.0, 0.0, 0.0), fov_y=0.9,
                    extra={"depth": 4}),
))
_register(BenchConfig(
    name="inverse",
    description="recover albedo/roughness + emitter radiance via pixel-loss "
                "gradients",
    render=RenderConfig(width=64, height=64, spp=2, max_bounces=2),
    scene=SceneSpec(builder="cornell"),
))


def build_scene(spec: SceneSpec, device=None):
    """Materialize (scene, camera) for a SceneSpec on `device`."""
    from ..core.camera import Camera
    from ..scene import procedural
    from ..scene.types import with_clusters

    b = spec.builder
    if b == "triangle":
        scene = procedural.make_triangle_scene()
    elif b == "cornell":
        scene = procedural.make_cornell_box()
    elif b == "cornell_ggx":
        scene = procedural.make_cornell_box(
            metallic_tall_block=True,
            roughness=spec.extra.get("roughness", 0.25), textured=True,
            tex_size=spec.extra.get("tex_size", 8))
    elif b == "helmet":
        scene = procedural.make_helmet_class_scene(**spec.extra)
    elif b == "spd_tetra":
        scene = procedural.make_spd_tetra(**spec.extra)
    elif b == "helmet_glb":
        # The binary-asset path: author (cached) -> export_glb -> the whole
        # scene/gltf.py ingest -> env attach (scene/helmet_asset.py).
        from ..scene.helmet_asset import load_helmet_scene
        scene = load_helmet_scene(**spec.extra)
    elif b == "gltf":
        from ..scene import gltf as gltf_mod
        scene, _, camera = gltf_mod.load(spec.extra["path"])
        return _placed(with_clusters(scene, k=spec.cluster_k), camera,
                       device)
    else:
        raise ValueError(f"unknown scene builder {b!r}")
    # Always attach the cluster grid, as the reference does; scenes of at
    # most 512 triangles still take the resident tracer.
    camera = Camera.make(position=spec.camera_position,
                         target=spec.camera_target, fov_y=spec.fov_y)
    return _placed(with_clusters(scene, k=spec.cluster_k), camera, device)


def _placed(scene, camera, device):
    """(scene, camera) moved to `device` (None: left on the CPU)."""
    from ..scene.types import upload_scene
    if device is None:
        return scene, camera
    return upload_scene(scene, device), upload_scene(camera, device)


def get(name: str) -> BenchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; available: "
                       f"{sorted(CONFIGS)}")
    return CONFIGS[name]
