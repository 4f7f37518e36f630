"""The native builders (accel/native.py) against the numpy builders and the
reference: bit-equal BVHs, cluster grids and alias tables, bad indices
rejected, the numpy fallback under PBR_TPU_NO_NATIVE, the scene builders
routed through them, and a build that writes under build/ only.

The library is compiled from native/bvh_builder.cpp with g++ (about 2 s,
once per source and host); every comparison is exact.
"""

import time

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu.accel import bvh as jbvh
from physically_based_renderer_tpu.accel import clusters as jclusters
from physically_based_renderer_tpu.scene import procedural as jproc
from physically_based_renderer_tpu.scene import types as jtypes
from physically_based_renderer_tpu_torch.accel import native
from physically_based_renderer_tpu_torch.accel.bvh import (
    BVH, build_bvh, validate_bvh)
from physically_based_renderer_tpu_torch.accel.clusters import build_clusters
from physically_based_renderer_tpu_torch.scene import procedural, types

torch.set_num_threads(1)
needs_native = pytest.mark.skipif(
    not native.available(),
    reason=f"the native library did not build: {native.BUILD_ERROR}")
BVH_FIELDS = ("node_min", "node_max", "node_left", "node_right", "tri_order")
GRID_FIELDS = ("aabb_min", "aabb_max", "tri_id", "parent_min", "parent_max")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mesh(g):
    return g.positions.numpy(), g.indices.numpy()


def test_fast_builders_work_either_way():
    pos, idx = _mesh(procedural.make_random_tris(100, seed=0))
    validate_bvh(native.build_bvh_fast(pos, idx), pos, idx)
    grid = native.build_clusters_fast(pos, idx)
    assert grid.tri_id.shape[1] == 128


def test_fallback_without_the_library(monkeypatch):
    """PBR_TPU_NO_NATIVE: no library, the numpy builders answer and the
    alias build returns None (its caller loops in Python)."""
    monkeypatch.setenv("PBR_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert not native.available()
    pos, idx = _mesh(procedural.make_random_tris(50, seed=2))
    a, b = native.build_bvh_fast(pos, idx), build_bvh(pos, idx)
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert native.build_alias_native(np.full(8, 0.125)) is None
    with pytest.raises(RuntimeError):
        native.build_bvh_native(pos, idx)
    prob, alias = types._build_alias_table(np.full(4, 0.25))
    np.testing.assert_array_equal(prob, 1.0)


@needs_native
@pytest.mark.parametrize("num_tris", [1, 7, 100, 2048])
def test_bvh_bit_equal(num_tris):
    pos, idx = _mesh(procedural.make_random_tris(num_tris, seed=num_tris))
    got = native.build_bvh_native(pos, idx)
    want = build_bvh(pos, idx)
    ref = jbvh.build_bvh(*(np.asarray(x) for x in (
        jproc.make_random_tris(num_tris, seed=num_tris).positions,
        jproc.make_random_tris(num_tris, seed=num_tris).indices)))
    for f in BVH_FIELDS:
        a = getattr(got, f)
        assert a.tobytes() == getattr(want, f).tobytes(), f
        assert a.tobytes() == np.asarray(getattr(ref, f)).tobytes(), f


@needs_native
@pytest.mark.parametrize("k", [32, 128])
def test_clusters_bit_equal(k):
    g = procedural.make_uv_sphere(rings=24, sectors=32)
    pos, idx = _mesh(g)
    got = native.build_clusters_native(pos, idx, k=k)
    want = build_clusters(pos, idx, k=k)
    ref = jclusters.build_clusters(pos, idx, k=k)
    for f in GRID_FIELDS:
        a = _np(getattr(got, f))
        assert a.tobytes() == _np(getattr(want, f)).tobytes(), f
        assert a.tobytes() == np.asarray(getattr(ref, f)).tobytes(), f


@needs_native
def test_native_faster_on_big_mesh():
    pos, idx = _mesh(procedural.make_uv_sphere(rings=128, sectors=128))
    t0 = time.perf_counter()
    build_bvh(pos, idx)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.build_bvh_native(pos, idx)
    assert time.perf_counter() - t0 < t_py


@needs_native
def test_native_rejects_bad_indices():
    pos, idx = _mesh(procedural.make_random_tris(10, seed=0))
    bad = idx.copy()
    bad[0, 0] = 10_000
    with pytest.raises(ValueError):
        native.build_bvh_native(pos, bad)


@needs_native
@pytest.mark.parametrize("n,power", [(1, 1), (4096, 4), (333, 1)])
def test_alias_table_bit_equal(n, power, monkeypatch):
    """The C++ alias build equals the Python loop it replaces (and the
    reference's table) byte for byte, and reconstructs p."""
    p = np.random.default_rng(3).random(n) ** power
    p /= p.sum()
    prob, alias = native.build_alias_native(p)
    rec = prob.astype(np.float64) / n
    np.add.at(rec, alias, (1.0 - prob.astype(np.float64)) / n)
    np.testing.assert_allclose(rec, p, atol=1e-7)
    ref_prob, ref_alias = jtypes._build_alias_table(p)
    assert prob.tobytes() == np.asarray(ref_prob).tobytes()
    assert alias.tobytes() == np.asarray(ref_alias).tobytes()
    monkeypatch.setattr(types, "build_alias_native", lambda p: None)
    py_prob, py_alias = types._build_alias_table(p)
    assert prob.tobytes() == py_prob.tobytes()
    assert alias.tobytes() == py_alias.tobytes()


@needs_native
def test_scene_builders_take_the_native_route(monkeypatch):
    """with_bvh and with_clusters build through accel/native.py, and give
    what the reference's builders give."""
    calls = []
    for name in ("build_bvh_native", "build_clusters_native"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    scene = procedural.make_uv_sphere(rings=24, sectors=32)
    scene = types.make_scene(scene, types.Materials.default(1))
    ref = jtypes.make_scene(jproc.make_uv_sphere(rings=24, sectors=32),
                            jtypes.Materials.default(1))
    got_bvh = types.with_bvh(scene).bvh
    got_grid = types.with_clusters(scene).clusters
    assert calls == ["build_bvh_native", "build_clusters_native"]
    want_bvh = jtypes.with_bvh(ref).bvh
    want_grid = jtypes.with_clusters(ref).clusters
    for f in BVH_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got_bvh, f)),
                                      np.asarray(getattr(want_bvh, f)))
    for f in GRID_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got_grid, f)),
                                      np.asarray(getattr(want_grid, f)))
    assert isinstance(got_bvh, BVH)


@needs_native
def test_library_lives_under_build():
    lib = native.build()
    root = native.SOURCE.parents[1]
    assert lib.parent.parent == root / "build" / "torch_native"
    assert lib.exists() and native.BUILD_SECONDS == 0.0
    assert root / "native" not in lib.parents
