"""Write the reference goldens that the PyTorch port is held against on the card.

    JAX_PLATFORMS=cpu python tests/data/make_torch_golden.py \
        [cornell|helmet_proc|cornell_ggx_fused]

Renders with the JAX package on the CPU and saves the mean HDR image:

  * cornell: the `cornell` config at 64x64, 2 spp, 2 bounces, seed 0
    (tracer="resident", the resident kernel in interpret mode), f32[64, 64, 3]
    in tests/data/cornell_64_golden.npy;
  * helmet_proc: the `helmet_proc` config at full geometry (100,352
    triangles, its textures and sky) at 32x32, 1 spp, 2 bounces, seed 0
    (tracer="pallas", the block-stream kernel in interpret mode),
    f32[32, 32, 3] in tests/data/helmet_proc_32_golden.npy;
  * cornell_ggx_fused: the `cornell_ggx` config (textures, GGX, two
    emitters) at 64x64, 2 spp, 2 bounces, seed 0, through the fused
    whole-frame kernel (`ops/fused.py::render_fused_stats`, interpret
    mode), the sum divided by spp, f32[64, 64, 3] in
    tests/data/cornell_ggx_fused_64_golden.npy.

With no argument it writes all three.  `chip_smoke.py` compares the port's GPU
renders with them using numpy alone; tests/test_torch_render.py checks that
the committed files still match fresh renders.
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


# The fused golden: (config, size, spp, bounces, seed, path).
FUSED = dict(config="cornell_ggx", size=64, spp=2, bounces=2, seed=0,
             path=HERE / "cornell_ggx_fused_64_golden.npy")


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


def main(argv) -> int:
    sys.path.insert(0, str(HERE.parent.parent))
    which = argv[1:] or ["cornell", "helmet_proc", "cornell_ggx_fused"]
    for name in which:
        render, path = {"cornell": (render_golden, GOLDEN),
                        "helmet_proc": (render_helmet_golden,
                                        HELMET["path"]),
                        "cornell_ggx_fused": (render_fused_golden,
                                              FUSED["path"])}[name]
        img = render()
        np.save(path, img)
        print(f"wrote {path} {img.shape} mean {img.mean():.6f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
