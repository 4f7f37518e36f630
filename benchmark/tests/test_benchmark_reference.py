"""The plain reference agrees with the port's plain path (the port on the
CPU runs its plain versions) on a tiny Cornell box and a tiny
helmet-class scene, frame and gradient step."""

import importlib

import pytest
import torch

from harness import inputs, scenes

PORT = "physically_based_renderer_tpu_torch"
REF = scenes.REFERENCE


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cfg(pkg, **kw):
    return _m(pkg, "integrator.path").RenderConfig(**kw)


def _frame(pkg, config, settings):
    torch.set_num_threads(2)
    scene, cam = scenes.build(pkg, config, "cpu")
    key = torch.tensor(inputs.key_words(2**40 + 3, inputs.FRAME, 2))
    film, count = _m(pkg, "integrator.path").render_with_stats(
        scene, cam, key, _cfg(pkg, **settings))
    return film.hdr, int(count)


@pytest.mark.parametrize("config,settings", [
    ({"scene": {"function": "make_cornell_box", "args": {}},
      "camera": {"position": [0, 1, 3.9], "target": [0, 1, 0],
                 "fov_y": 0.95}},
     dict(width=16, height=12, spp=2, max_bounces=3)),
    ({"scene": {"function": "make_helmet_class_scene",
                "args": {"rings": 48, "sectors": 48}},
      "camera": {"position": [0, 0.1, 3.0], "target": [0, 0, 0],
                 "fov_y": 1.0}},
     dict(width=16, height=16, spp=1, max_bounces=2, block_size=64)),
])
def test_a_frame_is_the_ports_plain_frame_bit_for_bit(config, settings):
    hdr_p, count_p = _frame(PORT, config, settings)
    hdr_r, count_r = _frame(REF, config, settings)
    assert torch.equal(hdr_p, hdr_r) and count_p == count_r


def test_the_whole_frame_estimator_is_the_ports_plain_one():
    cfg = dict(width=12, height=10, spp=2, max_bounces=3)
    out = []
    config = {"scene": {"function": "make_cornell_box"},
              "camera": {"position": [0, 1, 3.9], "target": [0, 1, 0],
                         "fov_y": 0.95}}
    for pkg in (PORT, REF):
        scene, cam = scenes.build(pkg, config, "cpu")
        fused = _m(pkg, "ops.fused")
        out.append(fused.fused_plain(fused.fused_frame(
            scene, cam, torch.tensor([0, 7]), _cfg(pkg, **cfg))))
    assert torch.equal(out[0][0], out[1][0])
    assert int(out[0][1]) == int(out[1][1])


def test_a_gradient_step_is_the_ports():
    torch.set_num_threads(2)
    config = {"scene": {"function": "make_cornell_box"},
              "camera": {"position": [0, 1, 3.9], "target": [0, 1, 0],
                         "fov_y": 0.95}}
    res = []
    for pkg in (PORT, REF):
        inverse = _m(pkg, "grad.inverse")
        scene, cam = scenes.build(pkg, config, "cpu")
        cfg = _cfg(pkg, width=12, height=12, spp=1, max_bounces=2)
        params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
            scene, base_color=True, emissive=True))
        opt = torch.optim.Adam(params.leaves(), lr=0.05)
        step = inverse.make_train_step(scene, cam, cfg, opt)
        target = torch.zeros(12, 12, 3)
        params, _, loss = step(params, None, torch.tensor([0, 5]), target)
        res.append((float(loss), [v.detach().clone()
                                  for v in params.leaves()]))
    assert res[0][0] == res[1][0]
    for a, b in zip(res[0][1], res[1][1]):
        assert torch.equal(a, b)



@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 2, (0xFFFFFFFF,) * 2, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_the_references_threefry_gives_the_published_answers(key, count,
                                                              want):
    """Threefry-2x32, 20 rounds: the known answers of Salmon et al.
    (Random123), which vouch for the key stream apart from any port."""
    rng = _m(REF, "core.rng")
    t = [torch.tensor(x, dtype=torch.int64) for x in (*key, *count)]
    w0, w1 = rng.threefry2x32(*t)
    assert (int(w0) & 0xFFFFFFFF, int(w1) & 0xFFFFFFFF) == want
