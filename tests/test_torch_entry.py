"""`tools/dryrun.py::entry`, the single-card forward check, against the
reference's `__graft_entry__.py::entry`: the Cornell box at 64x64 x 1 spp
x 2 bounces through `render_sample`, key 0.  The port runs on the CPU
here (`device="cpu"`); the reference's step is jitted on the CPU.  The
image is held per pixel to the whole-render tolerance of
tests/torch_parity.py; the committed golden
(tests/data/entry_cornell_64_golden.npy, which the card run is held to) to
a fresh reference output.
"""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch.ops import gather, resident
from physically_based_renderer_tpu_torch.tools import dryrun
from torch_parity import assert_render_agrees, golden_module

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference_entry():
    """The reference's entry() output, jitted, as numpy."""
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    return np.asarray(jax.jit(fn)(*args), np.float32)


def test_entry_matches_reference_entry(reference_entry):
    fn, (scene, camera, key) = dryrun.entry(device="cpu")
    assert scene.device.type == "cpu" and camera.position.device.type == "cpu"
    assert key.tolist() == [0, 0]
    out = fn(scene, camera, key)
    assert out.shape == (64, 64, 3) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all()) and float(out.mean()) > 0.0
    assert_render_agrees(out.numpy(), reference_entry)


def test_entry_golden_matches_fresh_reference(reference_entry):
    golden = np.load(golden_module().ENTRY)
    assert golden.shape == (64, 64, 3) and golden.dtype == np.float32
    np.testing.assert_allclose(golden, reference_entry, rtol=1e-5, atol=1e-6)


def test_entry_calls_the_resident_tracer_and_the_gather(monkeypatch):
    """The step's kernels on the card: 32 triangles take the resident
    tracer (K2), 3 closest-hit and 2 shadow calls; every row gather is
    K5a's wrapper, 3 triangle-attribute and 2 emitter-row gathers."""
    calls = {"resident": 0, "gather_fwd": 0}

    def counted(name, real):
        def wrapper(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return wrapper

    monkeypatch.setattr(resident, "trace",
                        counted("resident", resident.trace))
    monkeypatch.setattr(gather, "gather_fwd",
                        counted("gather_fwd", gather.gather_fwd))
    fn, args = dryrun.entry(device="cpu")
    fn(*args)
    assert calls == {"resident": 5, "gather_fwd": 5}


def test_entry_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.entry()


def test_main_prints_entry_forward_on_one_gloo_rank(tmp_path, capsys):
    """`main` in a world of one gloo rank: rank 0 prints the entry step's
    shape and mean (as the reference's `__main__` does) before the dry
    run's line."""
    import torch.distributed as dist

    from physically_based_renderer_tpu_torch.parallel import distributed
    assert distributed.ensure_initialized(f"file://{tmp_path}/rdv", 1, 0,
                                          backend="gloo")
    try:
        assert dryrun.main(["--ranks", "1", "--device", "cpu"]) == 0
    finally:
        dist.destroy_process_group()
    lines = capsys.readouterr().out.strip().splitlines()
    fn, args = dryrun.entry(device="cpu")
    mean = float(fn(*args).mean())
    assert lines[-2] == f"entry forward: (64, 64, 3) {mean}"
    assert lines[-1].startswith("dryrun(1): loss=")
    assert lines[-1].endswith(" ok")
