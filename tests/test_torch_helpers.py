"""The port's helper API against the reference: core/math3d (quaternions,
TRS, camera matrices), core/rng (pixel_keys, fold, sample_key, uniform1/2),
core/tonemap (the sRGB pair), core/camera (generate_rays,
generate_rays_flat), scene/procedural.make_random_tris and
ops/texture.sample_bilinear.

Tolerances: the rng helpers, make_random_tris and the ray generators with
a key draw bit-equal numbers; the float helpers agree within 1e-6 (rtol
and atol), the reference's own oracles (tests/test_math3d.py,
tests/test_tonemap.py) hold the port to their tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.core import camera as jcam
from physically_based_renderer_tpu.core import math3d as jm
from physically_based_renderer_tpu.core import rng as jrng
from physically_based_renderer_tpu.core import tonemap as jtone
from physically_based_renderer_tpu.ops import texture as jtex
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.core import camera, math3d as m3
from physically_based_renderer_tpu_torch.core import rng, tonemap
from physically_based_renderer_tpu_torch.ops import texture
from physically_based_renderer_tpu_torch.scene import procedural
from physically_based_renderer_tpu_torch.scene.types import TextureStack
from torch_parity import flat

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _unit_quats(rng_, n):
    q = rng_.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# math3d against the reference, function by function
# ---------------------------------------------------------------------------

def test_quaternions_match_reference():
    g = np.random.default_rng(0)
    q1, q2 = _unit_quats(g, 32), _unit_quats(g, 32)
    v = g.normal(size=(32, 3)).astype(np.float32)
    axis = g.normal(size=(32, 3)).astype(np.float32)
    angle = g.uniform(-3.0, 3.0, 32).astype(np.float32)
    np.testing.assert_array_equal(m3.quat_identity().numpy(),
                                  np.asarray(jm.quat_identity()))
    np.testing.assert_allclose(m3.quat_mul(_t(q1), _t(q2)).numpy(),
                               np.asarray(jm.quat_mul(q1, q2)), **TOL)
    np.testing.assert_allclose(m3.quat_rotate(_t(q1), _t(v)).numpy(),
                               np.asarray(jm.quat_rotate(q1, v)), **TOL)
    np.testing.assert_allclose(
        m3.quat_from_axis_angle(_t(axis), _t(angle)).numpy(),
        np.asarray(jm.quat_from_axis_angle(axis, angle)), **TOL)
    # A single axis and a scalar angle, as the oracles call it.
    np.testing.assert_allclose(
        m3.quat_from_axis_angle([0.0, 0.0, 1.0], 0.3).numpy(),
        np.asarray(jm.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]), 0.3)),
        **TOL)
    m = m3.quat_to_mat3(_t(q1))
    np.testing.assert_allclose(m.numpy(), np.asarray(jm.quat_to_mat3(q1)),
                               **TOL)
    assert m.shape == (32, 3, 3)
    mats = np.asarray(jm.quat_to_mat3(q2))
    np.testing.assert_allclose(m3.mat3_to_quat(_t(mats)).numpy(),
                               np.asarray(jm.mat3_to_quat(mats)), **TOL)


def test_transforms_match_reference():
    g = np.random.default_rng(1)
    t = g.normal(size=(8, 3)).astype(np.float32)
    q = _unit_quats(g, 8)
    s = g.uniform(0.5, 2.0, (8, 3)).astype(np.float32)
    p = g.normal(size=(8, 3)).astype(np.float32)
    want = np.asarray(jm.trs_to_mat4(t, q, s))
    got = m3.trs_to_mat4(_t(t), _t(q), _t(s))
    assert got.shape == (8, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(m3.normal_matrix(got).numpy(),
                               np.asarray(jm.normal_matrix(want)),
                               rtol=1e-5, atol=1e-6)
    # One matrix applied to a batch, and a batch of matrices to a batch.
    np.testing.assert_allclose(m3.transform_points(got[0], _t(p)).numpy(),
                               np.asarray(jm.transform_points(want[0], p)),
                               **TOL)
    np.testing.assert_allclose(
        m3.transform_points(got, _t(p)[:, None, :]).numpy(),
        np.asarray(jm.transform_points(want, p[:, None, :])), **TOL)
    np.testing.assert_allclose(m3.transform_dirs(got[3], _t(p)).numpy(),
                               np.asarray(jm.transform_dirs(want[3], p)),
                               **TOL)


@pytest.mark.parametrize("fn", ["perspective_rh_no", "perspective_rh_zo"])
def test_projections_match_reference(fn):
    for fovy, aspect, zn, zf in ((1.0, 1.0, 0.1, 100.0),
                                 (0.95, 1.5, 0.01, 1024.0)):
        np.testing.assert_allclose(
            getattr(m3, fn)(fovy, aspect, zn, zf).numpy(),
            np.asarray(getattr(jm, fn)(fovy, aspect, zn, zf)), **TOL)


def test_look_at_matches_reference():
    for eye, center, up in (((0.0, 0.0, 5.0), (0.0, 0.0, 0.0),
                             (0.0, 1.0, 0.0)),
                            ((0.3, 1.0, 3.9), (0.0, 1.0, 0.0),
                             (0.0, -1.0, 0.0))):
        np.testing.assert_allclose(
            m3.look_at_rh(eye, center, up).numpy(),
            np.asarray(jm.look_at_rh(jnp.array(eye), jnp.array(center),
                                     jnp.array(up))), **TOL)


# The reference's own oracles (tests/test_math3d.py), run on the port.

def test_oracle_quat_rotations():
    z = torch.tensor([0.0, 0.0, 1.0])
    x = torch.tensor([1.0, 0.0, 0.0])
    np.testing.assert_allclose(
        m3.quat_rotate(m3.quat_identity(), torch.tensor([1.0, 2.0, 3.0])),
        [1.0, 2.0, 3.0], atol=1e-6)
    np.testing.assert_allclose(
        m3.quat_rotate(m3.quat_from_axis_angle(z, np.pi / 2), x),
        [0.0, 1.0, 0.0], atol=1e-6)
    ab = m3.quat_rotate(m3.quat_mul(m3.quat_from_axis_angle(z, 0.3),
                                    m3.quat_from_axis_angle(z, 0.5)), x)
    np.testing.assert_allclose(
        ab, m3.quat_rotate(m3.quat_from_axis_angle(z, 0.8), x), atol=1e-6)
    q = _unit_quats(np.random.default_rng(0), 16)
    q2 = m3.mat3_to_quat(m3.quat_to_mat3(_t(q))).numpy()
    sign = np.sign(np.sum(q * q2, axis=-1, keepdims=True))
    np.testing.assert_allclose(q2 * sign, q, atol=1e-5)


def test_oracle_trs_normal_matrix_and_views():
    q = m3.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]), np.pi / 2)
    m = m3.trs_to_mat4(torch.tensor([1.0, 2.0, 3.0]), q,
                       torch.tensor([2.0, 1.0, 1.0]))
    np.testing.assert_allclose(
        m3.transform_points(m, torch.tensor([1.0, 0.0, 0.0])),
        [1.0, 4.0, 3.0], atol=1e-5)
    nm = m3.normal_matrix(m3.trs_to_mat4(torch.zeros(3), m3.quat_identity(),
                                         torch.tensor([2.0, 1.0, 1.0])))
    n = (nm @ torch.tensor([1.0, 0.0, 0.0])).numpy()
    np.testing.assert_allclose(n / np.linalg.norm(n), [1.0, 0.0, 0.0],
                               atol=1e-6)
    v = m3.look_at_rh(torch.tensor([0.0, 0.0, 5.0]), torch.zeros(3),
                      torch.tensor([0.0, 1.0, 0.0]))
    np.testing.assert_allclose(
        m3.transform_points(v, torch.tensor([0.0, 0.0, 5.0])), 0.0,
        atol=1e-6)
    np.testing.assert_allclose(m3.transform_points(v, torch.zeros(3)),
                               [0.0, 0.0, -5.0], atol=1e-6)
    for fn, depths in ((m3.perspective_rh_no, (-1.0, 1.0)),
                       (m3.perspective_rh_zo, (0.0, 1.0))):
        proj = fn(1.0, 1.0, 0.1, 100.0)
        for z, expect in zip((-0.1, -100.0), depths):
            clip = proj @ torch.tensor([0.0, 0.0, z, 1.0])
            np.testing.assert_allclose(float(clip[2] / clip[3]), expect,
                                       atol=1e-4)


# ---------------------------------------------------------------------------
# rng helpers, bit for bit
# ---------------------------------------------------------------------------

def _data(keys) -> np.ndarray:
    return np.asarray(jax.random.key_data(keys))


@pytest.mark.parametrize("seed", [0, 7, -5])
def test_rng_helpers_bit_equal(seed):
    jk, k = jax.random.key(seed), rng.key(seed)
    np.testing.assert_array_equal(rng.pixel_keys(k, 37).numpy(),
                                  _data(jrng.pixel_keys(jk, 37)))
    np.testing.assert_array_equal(rng.fold(k, 3, 1, 2).numpy(),
                                  _data(jrng.fold(jk, 3, 1, 2)))
    # Over a batch of keys, with a tensor fold.
    pk, jpk = rng.pixel_keys(k, 9), jrng.pixel_keys(jk, 9)
    ids = np.arange(9, dtype=np.int32) * 5
    np.testing.assert_array_equal(
        rng.fold(pk, torch.from_numpy(ids), 4).numpy(),
        _data(jax.vmap(lambda kk, i: jrng.fold(kk, i, 4))(jpk, ids)))
    sk = rng.sample_key(k, 2, 1, rng.STREAM_BSDF)
    jsk = jrng.sample_key(jk, 2, 1, jrng.STREAM_BSDF)
    np.testing.assert_array_equal(sk.numpy(), _data(jsk))
    for got, want in ((rng.uniform2(sk, (5, 3)), jrng.uniform2(jsk, (5, 3))),
                      (rng.uniform1(sk, (17,)), jrng.uniform1(jsk, (17,)))):
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))


# ---------------------------------------------------------------------------
# sRGB, make_random_tris
# ---------------------------------------------------------------------------

def test_srgb_pair_matches_reference():
    x = np.concatenate([np.linspace(-0.5, 1.5, 257),
                        [0.0031308, 0.04045, 1e-7, 1e-9]]).astype(np.float32)
    np.testing.assert_allclose(tonemap.linear_to_srgb(_t(x)).numpy(),
                               np.asarray(jtone.linear_to_srgb(x)), **TOL)
    np.testing.assert_allclose(tonemap.srgb_to_linear(_t(x)).numpy(),
                               np.asarray(jtone.srgb_to_linear(x)), **TOL)
    # The reference's oracle (tests/test_tonemap.py): the round trip.
    lin = torch.linspace(0.0, 1.0, 128)
    np.testing.assert_allclose(
        tonemap.srgb_to_linear(tonemap.linear_to_srgb(lin)).numpy(),
        lin.numpy(), atol=1e-5)


@pytest.mark.parametrize("n,seed,extent", [(1, 0, 1.0), (100, 3, 2.5)])
def test_make_random_tris_same_bytes(n, seed, extent):
    got = procedural.make_random_tris(n, seed=seed, extent=extent)
    want = jproc.make_random_tris(n, seed=seed, extent=extent)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name


# ---------------------------------------------------------------------------
# Ray generators
# ---------------------------------------------------------------------------

def _cameras():
    kw = dict(position=(0.3, 1.0, 3.9), target=(0.0, 1.0, 0.0), fov_y=0.95)
    return camera.Camera.make(**kw), jcam.Camera.make(**kw)


def test_generate_rays_match_reference():
    cam, jc = _cameras()
    w, h = 12, 9
    o, d = camera.generate_rays(cam, w, h)
    jo, jd = jcam.generate_rays(jc, w, h)
    assert tuple(d.shape) == (h, w, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    # A band of rows with jitter.
    jit = np.random.default_rng(2).random((4, w, 2)).astype(np.float32)
    o, d = camera.generate_rays(cam, w, h, _t(jit), row_start=3, n_rows=4)
    jo, jd = jcam.generate_rays(jc, w, h, jnp.asarray(jit), row_start=3,
                                n_rows=4)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    # generate_rays equals generate_rays_at on the row-major grid.
    pix = torch.arange(3 * w, 7 * w)
    _, d_at = camera.generate_rays_at(cam, w, h, (pix % w).float(),
                                      (pix // w).float(),
                                      _t(jit).reshape(-1, 2))
    np.testing.assert_array_equal(d.reshape(-1, 3).numpy(), d_at.numpy())


@pytest.mark.parametrize("seed", [None, 0, 11])
def test_generate_rays_flat_matches_reference(seed):
    cam, jc = _cameras()
    w, h = 10, 7
    key = None if seed is None else rng.key(seed)
    jkey = None if seed is None else jax.random.key(seed)
    o, d = camera.generate_rays_flat(cam, w, h, key)
    jo, jd = jcam.generate_rays_flat(jc, w, h, jkey)
    assert tuple(o.shape) == tuple(d.shape) == (h * w, 3)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)
    if seed is not None:
        # The jitter itself is the reference's draw, bit for bit.
        jit = rng.uniform(key, (h, w, 2)).numpy()
        want = np.asarray(jax.random.uniform(jkey, (h, w, 2), jnp.float32))
        np.testing.assert_array_equal(jit.view(np.uint32),
                                      want.view(np.uint32))


# ---------------------------------------------------------------------------
# sample_bilinear
# ---------------------------------------------------------------------------

def test_sample_bilinear_matches_reference():
    g = np.random.default_rng(4)
    imgs = [g.random((8, 8, 4)).astype(np.float32),
            g.random((4, 16, 4)).astype(np.float32)]
    wrap = ((jtypes.WRAP_REPEAT, jtypes.WRAP_CLAMP),
            (jtypes.WRAP_MIRROR, jtypes.WRAP_REPEAT))
    ref_stack = jtypes.TextureStack.from_images(imgs, wrap=wrap)
    a = flat(ref_stack)
    stack = TextureStack(texels=_t(a["texels"]), shapes=a["shapes"],
                         wrap=a["wrap"], filt=a["filt"])
    n = 64
    idx = g.integers(-1, 2, n).astype(np.int32)
    uv = g.uniform(-1.5, 2.5, (n, 2)).astype(np.float32)
    got = texture.sample_bilinear(stack, torch.from_numpy(idx), _t(uv),
                                  default=0.25)
    want = np.asarray(jtex.sample_bilinear(ref_stack, jnp.asarray(idx),
                                           jnp.asarray(uv), default=0.25))
    assert tuple(got.shape) == (n, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[idx < 0], 0.25)
