"""Helpers shared by the tests/test_torch_*.py parity tests.

Reference (JAX) records are flattened to numpy with `dataclasses.fields`,
so the port receives exactly the reference's data.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

FLAG_FIELDS = ("has_emitters", "has_directional", "has_textures",
               "tex_slots", "flat_normals")
RECORDS = ("geometry", "materials", "textures", "emitters", "directional")

GOLDEN_SCRIPT = Path(__file__).resolve().parent / "data" / "make_torch_golden.py"

# Whole-render tolerance: a pixel agrees within ATOL + RTOL * |ref|.
ATOL, RTOL, PIXEL_FRAC, MEAN_REL, COUNT_REL = 1e-4, 1e-3, 0.99, 5e-3, 5e-3


def flat(obj) -> dict:
    """A reference record's fields as numpy arrays (tuples and None
    kept)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = v if v is None or isinstance(v, tuple) else np.asarray(v)
    return out


def scene_arrays(scene) -> dict:
    """A reference Scene as the mapping `scene_from_numpy` takes."""
    d = {k: flat(getattr(scene, k)) for k in RECORDS}
    d["env"] = None if scene.env is None else flat(scene.env)
    d["flags"] = {k: getattr(scene, k) for k in FLAG_FIELDS}
    return d


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def params_numpy(params) -> dict:
    """The trained fields of a TrainableParams of either package (or a
    reference gradient of one) as numpy arrays; None fields dropped."""
    return {f.name: np_(getattr(params, f.name))
            for f in dataclasses.fields(params)
            if getattr(params, f.name) is not None}


def params_to_port(params, requires_grad: bool = True):
    """A reference TrainableParams (or a params_numpy dict) as the port's,
    each field a fresh f32 leaf tensor: the weights carry-over for
    gradients, beside `scene_from_numpy`."""
    from physically_based_renderer_tpu_torch.grad.inverse import \
        TrainableParams
    arrays = params if isinstance(params, dict) else params_numpy(params)
    return TrainableParams(**{
        k: torch.from_numpy(np.array(v, np.float32)).requires_grad_(
            requires_grad) for k, v in arrays.items()})


def port_grads(params) -> dict:
    """The .grad of each trained leaf of a port TrainableParams, as numpy."""
    return {k: np_(v.grad) for k, v in params.items()}


def assert_grads_close(got: dict, want: dict, rel: float):
    """Element-wise |got - want| <= rel * max|want|, field by field."""
    assert sorted(got) == sorted(want)
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert scale > 0.0, f"{k}: reference gradient is zero"
        err = float(np.abs(got[k] - want[k]).max())
        print(f"{k}: max|g| {scale:.4g}, max err / max|g| {err / scale:.3g}")
        assert err <= rel * scale, (k, err / scale)


def assert_records_equal(port, ref):
    """Every field of a port record equals the reference record's."""
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, tuple):
            assert a == b, f.name
        else:
            np.testing.assert_array_equal(np_(a), np.asarray(b),
                                          err_msg=f.name)


def render_agreement(img: np.ndarray, ref: np.ndarray):
    """(fraction of pixels within tolerance, count of those outside)."""
    ok = (np.abs(img - ref) <= ATOL + RTOL * np.abs(ref)).all(-1)
    return float(ok.mean()), int((~ok).sum())


def assert_render_agrees(img, ref, count=None, ref_count=None):
    """At least PIXEL_FRAC of the pixels within ATOL + RTOL |ref|, the film
    means within MEAN_REL and, where given, the ray counts within
    COUNT_REL."""
    frac, n_bad = render_agreement(img, ref)
    print(f"{n_bad} of {img.shape[0] * img.shape[1]} pixels outside "
          f"tolerance ({frac:.4%} agree)")
    assert frac >= PIXEL_FRAC
    assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL
    if count is not None:
        assert abs(count / ref_count - 1.0) <= COUNT_REL


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def golden_module():
    """tests/data/make_torch_golden.py as a module (its SIZE, SPP, BOUNCES,
    SEED, GOLDEN path and render_golden())."""
    spec = importlib.util.spec_from_file_location("make_torch_golden",
                                                  GOLDEN_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def many_emitters_reference(n=80, seed=0):
    """Reference scene of n random triangles, each its own emissive
    material of random power: more than 64 emitters, so emitter picks take
    the alias-table branch."""
    from physically_based_renderer_tpu.scene import procedural, types
    g = procedural.make_random_tris(n, seed=seed)
    rng = np.random.default_rng(seed)
    m = types.Materials.default(n).replace(
        emissive_factor=rng.uniform(0.1, 5.0, (n, 3)).astype(np.float32),
        specular_factor=np.zeros((n,), np.float32))
    return types.make_scene(
        g.replace(tri_material=np.arange(n, dtype=np.int32)), m)


def assert_scene_matches(port, ref, atol: float = 1e-7):
    """Every array of a port Scene against a reference Scene: integer and
    boolean arrays and static tuples exact, floats within `atol`; the static
    flags equal."""
    for rec in RECORDS + ("env",):
        a, b = getattr(port, rec), getattr(ref, rec)
        assert (a is None) == (b is None), rec
        if b is None:
            continue
        for f in dataclasses.fields(b):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(y, tuple):
                assert x == y, (rec, f.name)
                continue
            x, y = np_(x), np.asarray(y)
            assert x.shape == y.shape, (rec, f.name, x.shape, y.shape)
            if y.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=0, atol=atol,
                                           err_msg=f"{rec}.{f.name}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{rec}.{f.name}")
    for k in FLAG_FIELDS:
        assert getattr(port, k) == getattr(ref, k), k


def assert_graphs_equal(port, ref):
    """Two scene graphs (either package's): names, tree shape, transforms,
    cameras and every primitive's arrays equal."""
    assert port.name == ref.name
    a, b = list(port.dfs()), list(ref.dfs())
    assert [n.name for n in a] == [n.name for n in b]
    for x, y in zip(a, b):
        assert [c.name for c in x.children] == [c.name for c in y.children]
        assert x.mesh == y.mesh
        for f in ("translation", "rotation", "scale"):
            np.testing.assert_array_equal(getattr(x.transform, f),
                                          getattr(y.transform, f), err_msg=f)
        assert (x.camera is None) == (y.camera is None)
        if y.camera is not None:
            assert dataclasses.asdict(x.camera) == dataclasses.asdict(y.camera)
    assert [m.name for m in port.meshes] == [m.name for m in ref.meshes]
    for m, r in zip(port.meshes, ref.meshes):
        assert len(m.primitives) == len(r.primitives)
        for p, q in zip(m.primitives, r.primitives):
            assert p.material == q.material
            for f in ("positions", "normals", "tangents", "uvs", "indices"):
                x, y = getattr(p, f), getattr(q, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)


def assert_cameras_equal(port, ref):
    for f in dataclasses.fields(ref):
        np.testing.assert_array_equal(np_(getattr(port, f.name)),
                                      np.asarray(getattr(ref, f.name),
                                                 np.float32), err_msg=f.name)
