"""Inverse rendering in the port against the reference: apply_params and its
tie gradients, refit_clusters, one Adam train step, the recovery runs of
tests/test_inverse.py, checkpoints and the inverse CLI."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from physically_based_renderer_tpu.accel.clusters import \
    refit_clusters as j_refit
from physically_based_renderer_tpu.core.camera import Camera as JCamera
from physically_based_renderer_tpu.grad import inverse as jinv
from physically_based_renderer_tpu.integrator.path import (
    RenderConfig as JRenderConfig, render_image as j_render_image)
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.accel.clusters import refit_clusters
from physically_based_renderer_tpu_torch.apps import inverse as inverse_app
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.core.camera import camera_from_numpy
from physically_based_renderer_tpu_torch.grad import inverse as pinv
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.scene.types import (scene_from_numpy,
                                                             with_clusters)
from physically_based_renderer_tpu_torch.utils import checkpoint
from test_inverse import _ramp_quad_scene, _textured_quad_scene
from torch_parity import (flat, np_, params_numpy, params_to_port,
                          scene_arrays)

torch.set_num_threads(1)

QUAD_CAM = dict(position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0), fov_y=1.0)
CFG = path.RenderConfig(width=24, height=24, spp=2, max_bounces=1)


def _port(ref_scene):
    return scene_from_numpy(scene_arrays(ref_scene))


def _cam(**kw):
    return camera_from_numpy(flat(JCamera.make(**(kw or QUAD_CAM))))


def test_apply_params_values_and_tie_gradients_match_reference():
    """The clamps of apply_params, values and gradients, with entries below,
    on and above each bound."""
    scene = jproc.make_cornell_box()
    m = scene.materials.base_color_factor.shape[0]
    rng_np = np.random.default_rng(0)
    edge = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)

    def pick(shape):
        return rng_np.choice(edge, size=shape).astype(np.float32)

    jparams = jinv.TrainableParams(
        base_color_factor=pick((m, 4)), roughness_factor=pick((m,)),
        metallic_factor=pick((m,)), emissive_factor=pick((m, 3)),
        texture_data=pick((1, 4)))
    weights = {k: rng_np.normal(size=v.shape).astype(np.float32)
               for k, v in params_numpy(jparams).items()}
    fields = {"base_color_factor": lambda s: s.materials.base_color_factor,
              "roughness_factor": lambda s: s.materials.roughness_factor,
              "metallic_factor": lambda s: s.materials.metallic_factor,
              "emissive_factor": lambda s: s.materials.emissive_factor,
              "texture_data": lambda s: s.textures.texels}

    def j_obj(p):
        s = jinv.apply_params(scene, p)
        return sum(jnp.sum(get(s) * weights[k]) for k, get in fields.items())

    j_val, j_grad = jax.value_and_grad(j_obj)(
        jax.tree.map(jnp.asarray, jparams))
    pp = params_to_port(jparams)
    s = pinv.apply_params(_port(scene), pp)
    for k, get in fields.items():
        np.testing.assert_array_equal(
            np_(get(s)), np.asarray(get(jinv.apply_params(scene, jparams))))
    val = sum(torch.sum(get(s) * torch.from_numpy(weights[k]))
              for k, get in fields.items())
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-6)
    for k in fields:
        grad = np_(getattr(pp, k).grad)
        np.testing.assert_array_equal(grad, np.asarray(getattr(j_grad, k)))
        # the tie rule: exactly on a bound, half the weight
        bounds = [0.0] if k in ("emissive_factor", "texture_data") else [
            0.0, 1.0]
        on = np.isin(getattr(jparams, k), bounds)
        assert on.any()
        np.testing.assert_array_equal(grad[on], 0.5 * weights[k][on])


def test_pixel_loss_matches_reference_with_black_pixels():
    rng_np = np.random.default_rng(1)
    img = rng_np.uniform(-0.5, 2.0, (8, 8, 3)).astype(np.float32)
    img[:3] = 0.0                                   # black pixels: the bound
    target = rng_np.uniform(0.0, 2.0, (8, 8, 3)).astype(np.float32)
    j_val, j_g = jax.value_and_grad(jinv.pixel_loss)(jnp.asarray(img),
                                                     jnp.asarray(target))
    x = torch.from_numpy(img).requires_grad_(True)
    val = pinv.pixel_loss(x, torch.from_numpy(target))
    val.backward()
    # rtol 1e-5: the two frameworks' log1p differ in the last bit or two
    # (measured 3.8e-6 on 4 of 192 values); black pixels get half the
    # gradient of max(hdr, 0) on both sides.
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(j_g), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(
        pinv.pixel_loss_grad(x, torch.from_numpy(target)).numpy(),
        np.asarray(j_g), rtol=1e-5, atol=1e-12)


def test_refit_clusters_matches_reference():
    """test_inverse.py:136-151: the refit of a moved quad against the
    reference's refit (boxes, parent boxes, soup rows)."""
    ref = _ramp_quad_scene(0.0)
    moved = ref.geometry.replace(positions=jnp.asarray(ref.geometry.positions)
                                 + jnp.asarray([2.0, 0.0, 0.0]))
    want = j_refit(ref.clusters, moved)
    port = with_clusters(_port(ref))
    geom = dataclasses.replace(
        port.geometry, positions=(port.geometry.positions
                                  + torch.tensor([2.0, 0.0, 0.0]))
        .requires_grad_(True))
    got = refit_clusters(port.clusters, geom)
    for f in ("aabb_min", "aabb_max", "parent_min", "parent_max"):
        np.testing.assert_array_equal(np_(getattr(got, f)),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(np_(got.soup),
                                  np.asarray(want.soup)[:, :9])
    np.testing.assert_array_equal(np_(got.tri_id), np.asarray(want.tri_id))
    assert not got.soup.requires_grad and not got.aabb_min.requires_grad
    np.testing.assert_allclose(np_(got.aabb_min)[:, 0],
                               np_(port.clusters.aabb_min)[:, 0] + 2.0,
                               atol=1e-5)


def test_one_adam_step_matches_reference():
    """make_train_step with torch.optim.Adam against the reference's with
    optax.adam: same scene, key, target; the updated params and the loss."""
    scene = jproc.make_cornell_box()
    cam_kw = dict(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                  fov_y=0.95)
    jcam = JCamera.make(**cam_kw)
    small = dict(width=16, height=16, spp=2, max_bounces=1)
    jcfg = JRenderConfig(**small, tracer="resident")
    target = np.array(j_render_image(scene, jcam, 11, jcfg))
    jparams = jinv.TrainableParams.from_scene(scene, base_color=True,
                                              emissive=True)
    opt = optax.adam(5e-2)
    j_step = jinv.make_train_step(scene, jcam, jcfg, opt)
    key = jax.random.key(42)
    j_p1, _, j_loss = j_step(jparams, opt.init(jparams), key,
                             jnp.asarray(target))

    params = params_to_port(jparams)
    p_step = pinv.make_train_step(_port(scene), _cam(**cam_kw),
                                  path.RenderConfig(**small),
                                  torch.optim.Adam(params.leaves(), lr=5e-2))
    p1, state, loss = p_step(params, None, rng.key(42),
                             torch.from_numpy(target))
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5)
    assert p1 is params and state["state"]
    for k, v in params_numpy(j_p1).items():
        np.testing.assert_allclose(np_(getattr(p1, k)), v, rtol=0, atol=1e-6,
                                   err_msg=k)


class _Mesh:
    """A mesh's shape without a process group: the sharded step checks
    shapes before any collective."""

    def __init__(self, n, names=("tiles",)):
        self.n, self.mesh_dim_names = n, names

    def size(self, dim=None):
        return self.n


def test_sharded_step_raises():
    """The sharded step (tests/test_torch_sharding.py runs it) refuses a
    height its tiles do not divide, and a mesh without a `tiles` axis,
    with ValueError before any collective."""
    scene = _port(jproc.make_cornell_box())
    with pytest.raises(ValueError, match="divide"):
        pinv.make_train_step(scene, _cam(), CFG, None, mesh=_Mesh(5))
    with pytest.raises(ValueError, match="tiles"):
        pinv.make_train_step_spmd(scene, _cam(), CFG, None,
                                  _Mesh(2, ("rows",)))
    with pytest.raises(ValueError, match="divide"):
        pinv.fit(scene, _cam(), torch.zeros(24, 24, 3),
                 pinv.TrainableParams.from_scene(scene, base_color=True),
                 CFG, mesh=_Mesh(7))


def test_recover_texture_data():
    """test_inverse.py:58-75 on the port: 60 steps, lr 0.1."""
    h = 8
    true_tex = np.zeros((h, h, 3), np.float32)
    true_tex[:, : h // 2] = (0.9, 0.2, 0.2)
    true_tex[:, h // 2:] = (0.2, 0.9, 0.3)
    target = path.render(_port(_textured_quad_scene(true_tex)), _cam(),
                         rng.key(7), CFG).mean().detach()
    scene0 = _port(_textured_quad_scene(np.full((h, h, 3), 0.5, np.float32)))
    params = pinv.TrainableParams.from_scene(scene0, textures=True)
    params, losses = pinv.fit(scene0, _cam(), target, params, CFG, steps=60,
                              lr=0.1, seed=1)
    assert losses[-1] < 0.2 * losses[0]
    rec = np_(params.texture_data)[:, :3].reshape(h, h, 3)
    assert rec[:, : h // 2, 0].mean() > rec[:, : h // 2, 1].mean() + 0.15
    assert rec[:, h // 2:, 1].mean() > rec[:, h // 2:, 0].mean() + 0.15


def test_recover_env_data():
    """test_inverse.py:77-97 on the port: 60 steps, lr 0.1."""
    def sphere(zenith, horizon):
        env = jproc.make_gradient_sky(8, 16, zenith=zenith, horizon=horizon,
                                      sun_radiance=(0.0,) * 3)
        g = jproc.make_uv_sphere(radius=1.0, rings=8, sectors=12)
        return _port(jtypes.make_scene(g, jtypes.Materials.default(1),
                                       env=env))

    target = path.render(sphere((2.0, 0.3, 0.3), (0.3, 0.3, 2.0)), _cam(),
                         rng.key(3), CFG).mean().detach()
    scene0 = sphere((0.8, 0.8, 0.8), (0.8, 0.8, 0.8))
    params = pinv.TrainableParams.from_scene(scene0, env=True)
    params, losses = pinv.fit(scene0, _cam(), target, params, CFG, steps=60,
                              lr=0.1, seed=2)
    assert losses[-1] < 0.3 * losses[0]
    rec = np_(params.env_data)
    assert rec[:2, :, 0].mean() > rec[:2, :, 2].mean()


def test_recover_vertices_with_cluster_refit():
    """test_inverse.py:119-133 with the port's block tracer ("pallas": phase
    A + K1's plain version) and the refit each step, in place of the
    reference's XLA block tracer (not ported)."""
    cfg = dataclasses.replace(CFG, tracer="pallas")
    target = path.render(with_clusters(_port(_ramp_quad_scene(0.3))), _cam(),
                         rng.key(5), cfg).mean().detach()
    scene0 = with_clusters(_port(_ramp_quad_scene(0.0)))
    params = pinv.TrainableParams.from_scene(scene0, vertices=True)
    params, losses = pinv.fit(scene0, _cam(), target, params, cfg, steps=60,
                              lr=2e-2, seed=3)
    moved = (np_(params.vertex_positions)[:, 0].mean()
             - np_(scene0.geometry.positions)[:, 0].mean())
    assert moved > 0.1, f"vertices did not move toward target (dx={moved})"
    assert min(losses) < 0.5 * losses[0]


def test_checkpoint_round_trip_gives_the_same_next_step(tmp_path):
    scene = _port(_textured_quad_scene(np.full((8, 8, 3), 0.5, np.float32)))
    target = torch.full((24, 24, 3), 0.3)

    def fresh():
        p = pinv.trainable_copy(
            pinv.TrainableParams.from_scene(scene, textures=True))
        opt = torch.optim.Adam(p.leaves(), lr=0.1)
        return p, pinv.make_train_step(scene, _cam(), CFG, opt)

    params, step = fresh()
    params, state, _ = step(params, None, rng.key(1), target)
    checkpoint.save(tmp_path, 1, params, state, extra={"note": "x"})
    assert checkpoint.latest_step(tmp_path) == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["LATEST",
                                                          "step_00000001"]
    p_a, _, loss_a = step(params, state, rng.key(2), target)

    params_b, step_b = fresh()
    at, payload = checkpoint.restore(tmp_path)
    assert at == 1 and payload["extra"] == {"note": "x"}
    with torch.no_grad():
        params_b.texture_data.copy_(payload["params"]["texture_data"])
    p_b, _, loss_b = step_b(params_b, payload["opt_state"], rng.key(2),
                            target)
    assert float(loss_a) == float(loss_b)
    np.testing.assert_array_equal(np_(p_a.texture_data),
                                  np_(p_b.texture_data))
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(tmp_path / "none")
    checkpoint.save_npz(tmp_path / "p.npz", texture_data=p_a.texture_data)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npz")["texture_data"],
                                  np_(p_a.texture_data))


def test_cli_perturbation_matches_reference():
    """The CLI's perturbed initial guess draws the reference's numbers
    (apps/inverse.py:103-121 of the reference, restated here with jax)."""
    scene = jproc.make_cornell_box()
    true = jinv.TrainableParams.from_scene(scene, base_color=True,
                                           emissive=True)
    k = jax.random.key(0 + 1)

    def perturb(x):
        nonlocal k
        k, sub = jax.random.split(k)
        noise = jax.random.uniform(sub, jnp.asarray(x).shape, minval=-0.5,
                                   maxval=0.5)
        return jnp.clip(jnp.asarray(x) * (1.0 + noise) + 0.1 * noise, 0.0,
                        None)

    want = params_numpy(jax.tree.map(perturb, true))
    got = inverse_app._perturb(params_to_port(true, requires_grad=False), 0,
                               0.5, "cpu")
    for f, v in want.items():
        np.testing.assert_allclose(np_(getattr(got, f)), v, rtol=1e-6,
                                   atol=1e-7)


def test_cli_trains_checkpoints_and_resumes(tmp_path, capsys):
    ckpt, rep = tmp_path / "ckpt", tmp_path / "report.json"
    argv = ["--device", "cpu", "--size", "16", "--checkpoint-dir", str(ckpt),
            "--checkpoint-every", "2", "--report", str(rep)]
    assert inverse_app.main(argv + ["--steps", "2"]) == 0
    first = json.loads(rep.read_text())
    assert first["start_step"] == 0 and len(first["losses"]) == 2
    assert first["device"] == "cpu" and first["seconds_per_step"] > 0
    assert set(first["final_error"]) == {"base_color_factor",
                                         "emissive_factor"}
    assert checkpoint.latest_step(ckpt) == 2
    assert inverse_app.main(argv + ["--steps", "3", "--resume"]) == 0
    resumed = json.loads(rep.read_text())
    assert resumed["start_step"] == 2 and len(resumed["losses"]) == 1
    assert resumed["initial_error"] == first["initial_error"]
    printed = capsys.readouterr().out
    assert '"final_error"' in printed


@pytest.mark.parametrize("argv", [["--tiles", "2"], ["--scene", "x.glb"]])
def test_cli_unported_paths_raise(argv, monkeypatch):
    """--tiles N without a launcher starts N local ranks that rerun the
    CLI (recorded here; tests/test_torch_sharding.py runs the ranks); a
    scene that is no config name is a glTF path, and a missing file is the
    loader's GltfError, as in the reference."""
    from physically_based_renderer_tpu_torch.parallel import distributed
    from physically_based_renderer_tpu_torch.scene.gltf import GltfError
    argv = argv + ["--device", "cpu", "--steps", "1"]
    spawned = []
    monkeypatch.setattr(distributed, "spawn_local",
                        lambda *a: spawned.append(a) or 0)
    if "--tiles" not in argv:
        with pytest.raises(GltfError):
            inverse_app.main(argv)
        return
    assert inverse_app.main(argv) == 0
    assert spawned == [("physically_based_renderer_tpu_torch.apps.inverse",
                        argv, 2, "gloo")]


def test_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        inverse_app.main(["--steps", "1", "--size", "8"])
