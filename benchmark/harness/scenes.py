"""A configuration's scene and camera, built by one package: the port, or
the reference's frozen copy (`reference/pbr_plain`), which has the same
module layout and names.

`scene` in a configuration file is {"function": <scene/procedural.py
function>, "args": {...}}.  Both take the cluster grid (`with_clusters`),
as the port's configs do.
"""

from __future__ import annotations

import importlib
import time

REFERENCE = "reference.pbr_plain"


def build(package: str, config: dict, device, spans: dict | None = None):
    """(scene, camera) of `config` built by `package` on `device`; the
    ingest's host seconds go to spans["ingest.scene_s"]."""
    def mod(name):
        return importlib.import_module(f"{package}.{name}")

    spec = config["scene"]
    types = mod("scene.types")
    t = time.perf_counter()
    scene = getattr(mod("scene.procedural"),
                    spec["function"])(**spec.get("args", {}))
    scene = types.upload_scene(types.with_clusters(scene), device)
    if spans is not None:
        spans["ingest.scene_s"] = time.perf_counter() - t
    cam = config["camera"]
    camera = types.upload_scene(mod("core.camera").Camera.make(
        position=tuple(cam["position"]), target=tuple(cam["target"]),
        fov_y=cam["fov_y"]), device)
    return scene, camera

