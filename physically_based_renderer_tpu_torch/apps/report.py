"""Scene and performance report CLI (port of `apps/report.py`).

    python -m physically_based_renderer_tpu_torch.apps.report SCENE
        [--render] [--device cuda] [--json out.json] [--html out.html]

SCENE is a .gltf/.glb path (the whole node tree is printed) or a builtin
config name (flat inventory).  `--render` also measures one warm frame
through `render_with_stats` on `--device` and reports ms per frame and
rays/s with the device's name.
"""

from __future__ import annotations

import argparse
import html as html_mod
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pbr-report",
        description="scene-tree + performance report")
    p.add_argument("scene", help=".gltf/.glb path or builtin config name")
    p.add_argument("--render", action="store_true",
                   help="also render one frame and report ms + rays/s")
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--json", dest="json_out", default=None,
                   help="write the report as JSON")
    p.add_argument("--html", dest="html_out", default=None,
                   help="write the report as a standalone HTML page")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --render frame (cuda, cpu)")
    return p


def _tree_lines(graph) -> list[str]:
    """The node tree as text: name, TRS, mesh info."""
    lines: list[str] = []

    def walk(node, depth):
        t = node.transform
        bits = [node.name or "<unnamed>"]
        if node.mesh is not None:
            mesh = graph.meshes[node.mesh]
            tris = sum(p.indices.shape[0] for p in mesh.primitives)
            bits.append(f"mesh[{node.mesh}] '{mesh.name}' "
                        f"({len(mesh.primitives)} prims, {tris} tris)")
        if node.camera is not None:
            bits.append(f"camera(yfov={node.camera.yfov:.3f})")
        lines.append("  " * depth + "- " + "  ".join(bits))
        lines.append("  " * depth
                     + f"    T={t.translation.tolist()} "
                       f"R={t.rotation.tolist()} S={t.scale.tolist()}")
        for c in node.children:
            walk(c, depth + 1)

    for r in graph.roots:
        walk(r, 0)
    return lines


def _scene_stats(scene) -> dict:
    g = scene.geometry
    tex = scene.textures
    stats = {
        "triangles": int(g.num_tris),
        "vertices": int(g.num_vertices),
        "materials": int(scene.materials.num_materials),
        "textures": tex.num_textures if scene.has_textures else 0,
        "texture_shapes": [list(s) for s in tex.shapes],
        "emitters": int(scene.emitters.valid.sum()),
        "directional_light": bool(scene.has_directional),
        "env_map": (list(scene.env.data.shape[:2])
                    if scene.env is not None else None),
        "flat_normals": bool(scene.flat_normals),
        "accel": "clusters" if scene.clusters is not None else "none",
    }
    if scene.clusters is not None:
        stats["clusters"] = {"count": int(scene.clusters.num_clusters),
                             "k": int(scene.clusters.k)}
    return stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils import config as config_mod

    report: dict = {"scene": args.scene}
    tree_lines: list[str] = []

    if args.scene in config_mod.CONFIGS:
        bc = config_mod.get(args.scene)
        scene, camera = config_mod.build_scene(bc.scene)
        rcfg = bc.render
        report["config"] = bc.description
        tree_lines = [f"- {args.scene} (procedural builtin; no node tree)"]
    else:
        from ..integrator.path import RenderConfig
        from ..scene import gltf as gltf_mod
        from ..scene.types import with_clusters
        try:
            scene, graph, camera = gltf_mod.load(args.scene)
        except gltf_mod.GltfError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        scene = with_clusters(scene)
        rcfg = RenderConfig()
        tree_lines = _tree_lines(graph)
        report["graph_name"] = graph.name

    report["tree"] = tree_lines
    report["stats"] = _scene_stats(scene)

    if args.render:
        import dataclasses

        import torch

        from ..core import rng
        from ..integrator.path import render_with_stats
        from ..scene.types import upload_scene
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"--device {args.device}: CUDA is not "
                               "available")
        if args.spp:
            rcfg = dataclasses.replace(rcfg, spp=args.spp)
        scene = upload_scene(scene, device)
        camera = upload_scene(camera, device)
        key = rng.key(0, device)

        def frame():
            film, count = render_with_stats(scene, camera, key, rcfg)
            return int(count)                   # waits for the device

        frame()                                 # warm: kernel build, caches
        t0 = time.perf_counter()
        rays = frame()
        dt = time.perf_counter() - t0
        report["perf"] = {
            "width": rcfg.width, "height": rcfg.height, "spp": rcfg.spp,
            "frame_ms": dt * 1e3,
            "rays_per_s": rays / dt,
            "backend": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        }

    # ---- text output (always) -------------------------------------------
    print(f"scene: {args.scene}")
    for ln in tree_lines:
        print(ln)
    print("stats:")
    for k, v in report["stats"].items():
        print(f"  {k}: {v}")
    if "perf" in report:
        p = report["perf"]
        print(f"perf: {p['frame_ms']:.2f} ms/frame "
              f"({p['width']}x{p['height']}x{p['spp']}spp) "
              f"= {p['rays_per_s'] / 1e6:.1f}M rays/s [{p['backend']}]")

    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"wrote {args.json_out}")
    if args.html_out:
        esc = html_mod.escape
        rows = "".join(f"<tr><td>{esc(str(k))}</td><td>{esc(str(v))}</td>"
                       f"</tr>" for k, v in report["stats"].items())
        perf = ""
        if "perf" in report:
            p = report["perf"]
            perf = (f"<h2>Performance</h2><p>{p['frame_ms']:.2f} ms/frame, "
                    f"{p['rays_per_s'] / 1e6:.1f}M rays/s "
                    f"({p['backend']})</p>")
        tree = "\n".join(esc(ln) for ln in tree_lines)
        page = (f"<!doctype html><title>{esc(args.scene)}</title>"
                f"<h1>{esc(args.scene)}</h1>"
                f"<h2>Scene tree</h2><pre>{tree}</pre>"
                f"<h2>Stats</h2><table border=1>{rows}</table>{perf}")
        with open(args.html_out, "w") as f:
            f.write(page)
        print(f"wrote {args.html_out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
