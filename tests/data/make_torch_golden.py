"""Write the reference goldens that the PyTorch port is held against on the card.

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py \
        [cornell|helmet_proc|helmet|cornell_ggx_fused|cornell_grad|
         cornell_bp|helmet_bp|entry]

Renders with the JAX package on the CPU and saves the mean HDR image:

  * cornell: the `cornell` config at 64x64, 2 spp, 2 bounces, seed 0
    (tracer="resident", the resident kernel in interpret mode), f32[64, 64, 3]
    in tests/data/cornell_64_golden.npy;
  * helmet_proc: the `helmet_proc` config at full geometry (100,352
    triangles, its textures and sky) at 32x32, 1 spp, 2 bounces, seed 0
    (tracer="pallas", the block-stream kernel in interpret mode),
    f32[32, 32, 3] in tests/data/helmet_proc_32_golden.npy;
  * helmet: the `helmet` config at full geometry (the ~99.4k-triangle .glb
    authored by scene/helmet_asset.py and read back through scene/gltf.py,
    normal and emissive maps, ~7.8k emissive triangles, the sky) at 32x32,
    2 spp, 3 bounces, block_size=512, seed 0 (tracer="pallas"),
    f32[32, 32, 3] in tests/data/helmet_32_golden.npy; the asset is authored
    into a temporary directory;
  * cornell_ggx_fused: the `cornell_ggx` config (textures, GGX, two
    emitters) at 64x64, 2 spp, 2 bounces, seed 0, through the fused
    whole-frame kernel (`ops/fused.py::render_fused_stats`, interpret
    mode), the sum divided by spp, f32[64, 64, 3] in
    tests/data/cornell_ggx_fused_64_golden.npy;
  * cornell_grad: gradients, in tests/data/cornell_grad_64_golden.npz.  For
    `cornell` (the four material fields) and `cornell_ggx` (texture_data),
    at 64x64, 2 spp, 2 bounces, tracer="resident": the target is the mean
    of a render of the unchanged scene at key 9999 and 8 spp
    (`<case>/target`), the parameters are the scene's own values, and the
    file holds `<case>/loss` and `<case>/grad/<field>`, the reference's
    jax.grad of pixel_loss(render(apply_params(scene, p), key 0).mean(),
    target) (`key`);
  * cornell_bp, helmet_bp: the headlight Blinn-Phong debug shading
    (`models/blinn_phong.py::render_blinn_phong`, the `--blinn-phong` CLI
    path) of the `cornell` config at 64x64 and of the `helmet` config at
    full geometry at 32x32 (the asset authored into a temporary
    directory), f32[S, S, 3] in tests/data/cornell_bp_64_golden.npy and
    tests/data/helmet_bp_32_golden.npy;
  * entry: the output of the reference's single-chip check,
    `__graft_entry__.py::entry()` (the Cornell box at 64x64, 1 spp, 2
    bounces through `render_sample`, key 0), jitted, f32[64, 64, 3] in
    tests/data/entry_cornell_64_golden.npy.

With no argument it writes all eight.  `chip_smoke.py` compares the port's
GPU renders and gradients with them using numpy alone;
tests/test_torch_render.py checks that the committed image files still
match fresh renders, tests/test_torch_grad.py holds the port's CPU
gradients to the gradient golden.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
GOLDEN = HERE / "cornell_64_golden.npy"
SIZE, SPP, BOUNCES, SEED = 64, 2, 2, 0
# The helmet_proc golden: (config, size, spp, bounces, seed, tracer, path).
HELMET = dict(config="helmet_proc", size=32, spp=1, bounces=2, seed=0,
              tracer="pallas", path=HERE / "helmet_proc_32_golden.npy")
# The helmet golden: the .glb asset, as HELMET.
HELMET_GLB = dict(config="helmet", size=32, spp=2, bounces=3, seed=0,
                  tracer="pallas", path=HERE / "helmet_32_golden.npy")

# The Blinn-Phong goldens: name -> (config, size, path).
BLINN_PHONG = {"cornell_bp": dict(config="cornell", size=64,
                                  path=HERE / "cornell_bp_64_golden.npy"),
               "helmet_bp": dict(config="helmet", size=32,
                                 path=HERE / "helmet_bp_32_golden.npy")}

# The golden of the reference's `__graft_entry__.py::entry()`.
ENTRY = HERE / "entry_cornell_64_golden.npy"

# The fused golden: (config, size, spp, bounces, seed, path).
FUSED = dict(config="cornell_ggx", size=64, spp=2, bounces=2, seed=0,
             path=HERE / "cornell_ggx_fused_64_golden.npy")


# The gradient golden: sizes, keys, and per case the config, the trained
# fields (TrainableParams.from_scene flags) and the element-wise tolerance
# relative to max|g_ref| that the port is held to.  cornell_ggx's is wider:
# its texture gradient runs through GGX lobes at roughness 0.25 and is
# ill-conditioned in float32 (measured on the CPU port: a random change of
# the texels by 1e-6 of their value moves it by 3.2e-4 of max|g|), and the
# reference's XLA compiler contracts multiply-adds that the port rounds
# twice (port against reference: 7.3e-4 of max|g| on one texel's
# roughness channel, 3 of 512 values above 1e-4; cornell: 6e-7).
GRAD = dict(size=64, spp=2, bounces=2, key=0, tracer="resident",
            target_key=9999, target_spp=8,
            cases={"cornell": dict(config="cornell", select=dict(
                       base_color=True, roughness=True, metallic=True,
                       emissive=True), rel=1e-4),
                   "cornell_ggx": dict(config="cornell_ggx",
                                       select=dict(textures=True),
                                       rel=2e-3)},
            path=HERE / "cornell_grad_64_golden.npz")


def _render(config: str, size: int, spp: int, bounces: int, seed: int,
            tracer: str) -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from physically_based_renderer_tpu.integrator.path import render_with_stats
    from physically_based_renderer_tpu.utils.config import build_scene, get

    bc = get(config)
    cfg = dataclasses.replace(bc.render, width=size, height=size, spp=spp,
                              max_bounces=bounces, tracer=tracer)
    scene, camera = build_scene(bc.scene)
    film, _ = render_with_stats(scene, camera, jax.random.key(seed), cfg)
    return np.asarray(film.mean(), np.float32)


def render_golden() -> np.ndarray:
    return _render("cornell", SIZE, SPP, BOUNCES, SEED, "resident")


def render_helmet_golden() -> np.ndarray:
    h = HELMET
    return _render(h["config"], h["size"], h["spp"], h["bounces"], h["seed"],
                   h["tracer"])


def _in_asset_cache(fn):
    """fn() with the helmet asset authored into a temporary directory."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as cache:
        old = os.environ.get("PBR_ASSET_CACHE")
        os.environ["PBR_ASSET_CACHE"] = cache
        try:
            return fn()
        finally:
            if old is None:
                del os.environ["PBR_ASSET_CACHE"]
            else:
                os.environ["PBR_ASSET_CACHE"] = old


def render_helmet_glb_golden() -> np.ndarray:
    h = HELMET_GLB
    return _in_asset_cache(lambda: _render(
        h["config"], h["size"], h["spp"], h["bounces"], h["seed"],
        h["tracer"]))


def render_blinn_phong_golden(name: str) -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from physically_based_renderer_tpu.models.blinn_phong import (
        render_blinn_phong)
    from physically_based_renderer_tpu.utils.config import build_scene, get

    b = BLINN_PHONG[name]

    def run():
        scene, camera = build_scene(get(b["config"]).scene)
        return np.asarray(render_blinn_phong(scene, camera, b["size"],
                                             b["size"]), np.float32)
    return _in_asset_cache(run)


def render_fused_golden() -> np.ndarray:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from physically_based_renderer_tpu.ops.fused import render_fused_stats
    from physically_based_renderer_tpu.utils.config import build_scene, get

    f = FUSED
    bc = get(f["config"])
    cfg = dataclasses.replace(bc.render, width=f["size"], height=f["size"],
                              spp=f["spp"], max_bounces=f["bounces"])
    scene, camera = build_scene(bc.scene)
    hdr, _ = render_fused_stats(scene, camera, jax.random.key(f["seed"]),
                                cfg, interpret=True)
    return np.asarray(hdr, np.float32) / np.float32(f["spp"])


def render_entry_golden() -> np.ndarray:
    """The reference's `__graft_entry__.entry()` step, jitted, on the CPU."""
    import importlib.util

    import jax

    jax.config.update("jax_platforms", "cpu")
    spec = importlib.util.spec_from_file_location(
        "graft_entry", HERE.parent.parent / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    return np.asarray(jax.jit(fn)(*args), np.float32)


def grad_golden() -> dict:
    """The gradient golden's arrays (see the module docstring)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from physically_based_renderer_tpu.grad.inverse import (
        TrainableParams, apply_params, pixel_loss)
    from physically_based_renderer_tpu.integrator.path import render
    from physically_based_renderer_tpu.utils.config import build_scene, get

    g = GRAD
    out = {"key": np.int64(g["key"]), "target_key": np.int64(g["target_key"]),
           "target_spp": np.int64(g["target_spp"])}
    for case, spec in g["cases"].items():
        bc = get(spec["config"])
        cfg = dataclasses.replace(bc.render, width=g["size"],
                                  height=g["size"], spp=g["spp"],
                                  max_bounces=g["bounces"], tracer=g["tracer"])
        scene, camera = build_scene(bc.scene)
        target = render(scene, camera, jax.random.key(g["target_key"]),
                        dataclasses.replace(cfg, spp=g["target_spp"])).mean()

        def loss(p):
            img = render(apply_params(scene, p), camera,
                         jax.random.key(g["key"]), cfg).mean()
            return pixel_loss(img, target)

        params = TrainableParams.from_scene(scene, **spec["select"])
        value, grad = jax.value_and_grad(loss)(params)
        out[f"{case}/target"] = np.asarray(target, np.float32)
        out[f"{case}/loss"] = np.float32(value)
        for field in dataclasses.fields(grad):
            v = getattr(grad, field.name)
            if v is not None:
                out[f"{case}/grad/{field.name}"] = np.asarray(v, np.float32)
    return out


def main(argv) -> int:
    sys.path.insert(0, str(HERE.parent.parent))
    which = argv[1:] or ["cornell", "helmet_proc", "helmet",
                         "cornell_ggx_fused", "cornell_grad", *BLINN_PHONG,
                         "entry"]
    for name in which:
        if name in BLINN_PHONG:
            img = render_blinn_phong_golden(name)
            np.save(BLINN_PHONG[name]["path"], img)
            print(f"wrote {BLINN_PHONG[name]['path']} {img.shape} mean "
                  f"{img.mean():.6f}")
            continue
        if name == "cornell_grad":
            arrays = grad_golden()
            np.savez_compressed(GRAD["path"], **arrays)
            print(f"wrote {GRAD['path']} ({len(arrays)} arrays)")
            continue
        render, path = {"cornell": (render_golden, GOLDEN),
                        "helmet_proc": (render_helmet_golden,
                                        HELMET["path"]),
                        "helmet": (render_helmet_glb_golden,
                                   HELMET_GLB["path"]),
                        "cornell_ggx_fused": (render_fused_golden,
                                              FUSED["path"]),
                        "entry": (render_entry_golden, ENTRY)}[name]
        img = render()
        np.save(path, img)
        print(f"wrote {path} {img.shape} mean {img.mean():.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
