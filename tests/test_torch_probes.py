"""The probes P1-P4: each plain version against the probe's own numpy
expectation, and against the reference repository's kernel run in interpret
mode through its own entry point (tools/probe2.py, untouched)."""

import functools
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch.ops import probes
from physically_based_renderer_tpu_torch.tools import probe2

torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parent.parent / "tools"


@pytest.fixture
def ref_probe2(monkeypatch):
    """The reference's tools/probe2.py with its kernels in interpret mode."""
    monkeypatch.syspath_prepend(str(TOOLS))
    monkeypatch.delitem(sys.modules, "probe2", raising=False)
    import probe2 as ref
    monkeypatch.setattr(ref.pl, "pallas_call", functools.partial(
        ref.pl.pallas_call, interpret=True))
    yield ref
    sys.modules.pop("probe2", None)


def _walk(boxes):
    """The scalar walk in plain Python on numpy data, independent of the
    port: (nodes visited, leaf list)."""
    b = boxes.reshape(-1, 6)
    hit = b[:, :3].max(axis=1) <= b[:, 3:].min(axis=1)
    stack, cand, visited = [0], [], 0
    while stack:
        node = stack.pop()
        left = 2 * node + 1
        if hit[node] and left < b.shape[0]:
            stack += [left, left + 1]
        elif hit[node]:
            cand.append(node)
        visited += 1
    return visited, cand


def _run_ref(ref, name, capsys):
    capsys.readouterr()
    ref.PROBES[name]()
    return capsys.readouterr().out


def test_probe_names_match_the_reference(ref_probe2):
    assert set(probe2.NAMES) == set(ref_probe2.PROBES) == set(probe2.PROBES)


# --------------------------------------------------------------------- P1

@pytest.mark.parametrize("data,visited,leaves", [("probe", 1, 0),
                                                 ("all", 2047, 1024),
                                                 ("partial", 745, 257)])
def test_scalar_stack_plain_on_the_tool_data(data, visited, leaves):
    boxes = probe2.scalar_stack_boxes(data)
    out, cand = probes.scalar_stack(torch.from_numpy(boxes))
    want_visited, want_cand = _walk(boxes)
    assert out.tolist() == [visited, leaves] == [want_visited, len(want_cand)]
    assert cand.shape == (1024,) and cand.dtype == torch.int32
    assert cand[:leaves].tolist() == want_cand
    assert (cand[leaves:] == -1).all()
    if data == "all":       # LIFO: the right child is walked first
        assert want_cand[0] == 2046 and want_cand[-1] == 1023


def test_scalar_stack_matches_the_reference_kernel(ref_probe2, capsys):
    """The reference's own data (default_rng(1)): its root box fails the
    slab test, so the walk it timed is one node long."""
    line = _run_ref(ref_probe2, "scalar_stack", capsys)
    visited, leaves = (int(v) for v in re.search(
        r"visited=(\d+) leaves=(\d+)", line).groups())
    out, _ = probes.scalar_stack(
        torch.from_numpy(probe2.scalar_stack_boxes("probe")))
    assert out.tolist() == [visited, leaves] == [1, 0]


@pytest.mark.parametrize("data", ["all", "partial"])
def test_scalar_stack_real_walks_match_the_reference_kernel(
        data, ref_probe2, capsys, monkeypatch):
    """The same kernel on data where the walk is real: the reference draws
    its boxes from np.random.default_rng, so handing it a generator that
    returns the tool's boxes runs its kernel on them."""
    boxes = probe2.scalar_stack_boxes(data).reshape(-1, 6)

    class Fixed:
        def __init__(self):
            self.calls = 0

        def uniform(self, lo, hi, shape):
            self.calls += 1      # first call: lo; second: hi - lo
            return (boxes[:, :3] if self.calls == 1
                    else boxes[:, 3:] - boxes[:, :3]).astype(np.float64)

    monkeypatch.setattr(ref_probe2.np.random, "default_rng",
                        lambda seed: Fixed())
    monkeypatch.setattr(ref_probe2, "bench", lambda run, *a, **k: 1e-6)
    line = _run_ref(ref_probe2, "scalar_stack", capsys)
    visited, leaves = (int(v) for v in re.search(
        r"visited=(\d+) leaves=(\d+)", line).groups())
    # hi = lo + (hi - lo) rounds back to hi only approximately: rebuild the
    # boxes exactly as the reference did
    lo = boxes[:, :3]
    ref_boxes = np.concatenate([lo, lo + (boxes[:, 3:] - lo)], 1).reshape(-1)
    out, _ = probes.scalar_stack(torch.from_numpy(ref_boxes))
    assert out.tolist() == [visited, leaves]
    assert visited > 100 and leaves > 50


@pytest.mark.parametrize("seed", [0, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 3, 63, 2047])
def test_scalar_stack_plain_other_seeds(seed, n):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1, 0.4, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.7, 1.9, (n, 3)).astype(np.float32)
    boxes = np.concatenate([lo, hi], 1).reshape(-1)
    out, cand = probes.scalar_stack(torch.from_numpy(boxes))
    visited, want = _walk(boxes)
    assert out.tolist() == [visited, len(want)]
    assert cand.tolist()[:len(want)] == want and cand.shape == ((n + 1) // 2,)


def test_scalar_stack_rejects_bad_boxes():
    with pytest.raises(ValueError):
        probes.scalar_stack(torch.zeros(6 * 4))              # even node count
    with pytest.raises(ValueError):
        probes.scalar_stack(torch.zeros(7))
    with pytest.raises(ValueError):
        probes.scalar_stack(torch.zeros(6, dtype=torch.float64))
    with pytest.raises(ValueError):
        probes.scalar_stack(torch.zeros(6 * (probes.MAX_NODES + 2)))
    with pytest.raises(ValueError):
        probes.scalar_stack(torch.zeros(6, device="meta"))


# --------------------------------------------------------------------- P2

def test_relayout_plain_on_the_probe_input(ref_probe2, capsys):
    x = probe2.relayout_input()
    for exchange in (True, False):
        got = probes.relayout(torch.from_numpy(x), exchange=exchange).numpy()
        np.testing.assert_array_equal(got, probe2.relayout_expected())
    assert "ok=True" in _run_ref(ref_probe2, "relayout", capsys)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relayout_plain_other_seeds(seed):
    x = np.random.default_rng(seed).integers(-500, 500, (8, 128)).astype(
        np.float32)
    want = sum(x.reshape(1024, 1) + np.float32(i) for i in range(10))
    np.testing.assert_array_equal(probes.relayout(torch.from_numpy(x)).numpy(),
                                  want.reshape(8, 128))
    with pytest.raises(ValueError):
        probes.relayout(torch.zeros(128, 8))


# --------------------------------------------------------------------- P3

@pytest.mark.parametrize("seed", [0, 1, 7])
def test_onehot_mm_plain_is_an_exact_gather(seed):
    lane, rows = probe2.onehot_inputs(seed)
    got = probes.onehot_mm(torch.from_numpy(lane), torch.from_numpy(rows))
    assert got.shape == (1024, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), rows.T[lane[:, 0]])


def test_onehot_mm_matches_the_reference_kernel(ref_probe2, capsys):
    assert "ok=True" in _run_ref(ref_probe2, "onehot_mm", capsys)
    # ragged shapes, and a lane outside the rows gives zeros
    rng = np.random.default_rng(5)
    rows = rng.normal(size=(7, 64)).astype(np.float32)
    lane = rng.integers(0, 64, (100, 1)).astype(np.int32)
    lane[3] = 64
    got = probes.onehot_mm(torch.from_numpy(lane), torch.from_numpy(rows))
    want = rows.T[np.minimum(lane[:, 0], 63)]
    want[3] = 0.0
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        probes.onehot_mm(torch.from_numpy(lane[:, 0]), torch.from_numpy(rows))
    with pytest.raises(ValueError):
        probes.onehot_mm(torch.from_numpy(lane), torch.zeros(33, 8))


# --------------------------------------------------------------------- P4

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("tag", sorted(probe2.GATHER_SHAPES))
def test_gather_plain_is_take_along_axis(tag, seed):
    rows, lanes, axis = probe2.GATHER_SHAPES[tag]
    x, idx = probe2.gather_inputs(rows, lanes, axis, seed)
    want = np.take_along_axis(x, idx, axis=axis)
    got = probes.gather(torch.from_numpy(x), torch.from_numpy(idx), axis)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tag", ["gather8", "gather_rows", "gather_lane",
                                 "gather_state"])
def test_gather_matches_the_reference_kernel(tag, ref_probe2, capsys):
    assert "ok=True" in _run_ref(ref_probe2, tag, capsys)


def test_gather_clamps_and_rejects():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    idx = torch.tensor([[-1, 0, 5, 2]] * 3, dtype=torch.int32)
    np.testing.assert_array_equal(
        probes.gather(x, idx, 0).numpy(),
        x.numpy()[np.clip(idx.numpy(), 0, 2), np.arange(4)[None]])
    np.testing.assert_array_equal(
        probes.gather(x, idx, 1).numpy(),
        np.take_along_axis(x.numpy(), np.clip(idx.numpy(), 0, 3), 1))
    with pytest.raises(ValueError):
        probes.gather(x, idx, 2)
    with pytest.raises(ValueError):
        probes.gather(x, idx[:2], 0)
    with pytest.raises(ValueError):
        probes.gather(x, idx.long(), 0)
    with pytest.raises(ValueError):
        probes.gather(x.int(), idx, 0)
    with pytest.raises(ValueError):
        probes.gather(x.t(), idx.t(), 0)            # not contiguous


# ------------------------------------------------------------------- tool

def test_tool_runs_every_probe_on_the_cpu(capsys):
    probes.reset_launches()
    assert probe2.main(["all", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "--- all on cpu"
    assert len(lines) == 1 + 3 + 2 + 5
    assert all("ok=True" in ln and ln.endswith("[cpu]") for ln in lines[1:])
    assert "visited=1 leaves=0" in lines[1]
    assert "visited=2047 leaves=1024" in lines[2]
    assert not any(probes.LAUNCHES.values())         # CPU: plain versions
