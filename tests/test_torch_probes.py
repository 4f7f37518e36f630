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


def _level_parallel(boxes):
    """P1 as its kernel computes it (csrc/probes.cu), in numpy: pass bits,
    then a level at a time a node's flag = it passes and its parent's flag
    is set, a node visited where its parent's flag is set; the flagged
    leaves in the walk's pop order: with D = floor(log2 n), the leaves
    above the last level, highest index first, then the last level's,
    highest index first.  (visited, leaf list)."""
    b = boxes.reshape(-1, 6)
    n = b.shape[0]
    flag = b[:, :3].max(axis=1) <= b[:, 3:].min(axis=1)
    visited, lo, width = 1, 1, 2
    while lo < n:
        i = np.arange(lo, min(lo + width, n))
        up = flag[(i - 1) // 2]
        visited += int(up.sum())
        flag[i] &= up
        lo, width = lo + width, 2 * width
    first_last = (1 << (n.bit_length() - 1)) - 1      # 2^D - 1
    order = np.concatenate([np.arange(first_last - 1, (n - 1) // 2 - 1, -1),
                            np.arange(n - 1, first_last - 1, -1)])
    return visited, order[flag[order]].tolist()


@pytest.mark.parametrize("rate", [1.0, 0.9, 0.7])
@pytest.mark.parametrize("sizes", ["odd n to 399", "2047", "5001", "8191"])
def test_scalar_stack_level_parallel_model_equals_the_walk(sizes, rate):
    """The kernel's design needs no serial walk: its numpy model gives the
    plain version's count, leaves and pop order on every odd n up to 399
    and at the tool's sizes."""
    ns = range(1, 400, 2) if sizes.startswith("odd") else [int(sizes)]
    for n in ns:
        boxes = probe2.tree_boxes(n, rate)
        out, cand = probes.scalar_stack(torch.from_numpy(boxes))
        visited, leaves = _level_parallel(boxes)
        assert out.tolist() == [visited, len(leaves)], n
        assert cand.tolist() == leaves + [-1] * (cand.shape[0] - len(leaves))
    if rate == 1.0 and not sizes.startswith("odd"):
        assert visited == n and len(leaves) == (n + 1) // 2


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
    for route in probes.RELAYOUT_ROUTES:
        got = probes.relayout(torch.from_numpy(x), route).numpy()
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
    with pytest.raises(ValueError):
        probes.relayout(torch.from_numpy(x), "column")


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


def _reference_onehot_body(win, rows):
    """The reference kernel's body (tools/probe2.py:136-143) on the CPU:
    the one-hot mask of each output row's winning lane, contracted with the
    rows over the lanes by jax.lax.dot_general."""
    import jax
    import jax.numpy as jnp
    lane = jax.lax.broadcasted_iota(jnp.int32, (win.shape[0], rows.shape[1]),
                                    1)
    mask = (lane == jnp.asarray(win)).astype(jnp.float32)
    return np.array(jax.lax.dot_general(
        mask, jnp.asarray(rows), dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))


def _count_then_select(win, rows):
    """The kernel's algorithm (csrc/probes.cu) in torch: count each row's
    non-finite entries, then take rows[c, w] + 0.0, or NaN where the row
    holds a non-finite entry at another lane; for w outside [0, L), +0.0
    or that NaN."""
    n_lanes = rows.shape[1]
    bad = (~torch.isfinite(rows)).sum(dim=1)
    w = win[:, 0].long()
    inside = ((w >= 0) & (w < n_lanes))[:, None]
    v = torch.where(inside, rows[:, w.clamp(0, n_lanes - 1)].t(),
                    torch.tensor(0.0))
    others = bad[None, :] - (inside & ~torch.isfinite(v)).int()
    return torch.where(others > 0, torch.tensor(float("nan")),
                       v + torch.tensor(0.0))


_EDGE_SHAPES = [(1024, 32, 512), (100, 7, 64), (33, 32, 1500)]


@pytest.mark.parametrize("n,r,l", _EDGE_SHAPES)
def test_onehot_mm_plain_is_the_reference_body_on_non_finite_rows(n, r, l):
    """On rows with +-0.0, inf, -inf and NaN and win at -1, at L, at a
    non-finite lane and in range, the plain version and the reference's
    mask-and-dot_general agree: NaN at the same places, every other value
    bit for bit (the sign of zero included)."""
    win, rows = probe2.onehot_edge_inputs(n, r, l)
    got = probes.onehot_mm(torch.from_numpy(win), torch.from_numpy(rows))
    want = torch.from_numpy(_reference_onehot_body(win, rows))
    assert probes.same_or_both_nan(got, want)
    # the edge data reaches every case: NaN from another lane, a non-finite
    # value at the winning lane, -0.0 at it (+0.0 out) and win outside
    finite = np.isfinite(rows)
    at = rows[:, np.clip(win[:, 0], 0, l - 1)].T
    inside = ((win >= 0) & (win < l))
    assert got.isnan().any() and torch.isinf(got).any()
    assert (inside & (at == 0) & np.signbit(at) & finite.all(1)[None]).any()
    assert (~inside).any() and not torch.signbit(got[got == 0]).any()


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("n,r,l", _EDGE_SHAPES)
def test_onehot_mm_count_then_select_equals_plain(n, r, l, seed):
    """The kernel's algorithm, modelled in torch, equals the plain version
    on the edge data and on the probe's kind of data."""
    for win, rows in (probe2.onehot_edge_inputs(n, r, l, seed),
                      (np.random.default_rng(seed).integers(
                          -2, l + 2, (n, 1)).astype(np.int32),
                       np.random.default_rng(seed).normal(
                           size=(r, l)).astype(np.float32))):
        win, rows = torch.from_numpy(win), torch.from_numpy(rows)
        assert probes.same_or_both_nan(_count_then_select(win, rows),
                                       probes.onehot_mm_plain(win, rows))


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


@pytest.mark.parametrize("tag", sorted(probe2.GATHER_SHAPES))
def test_gather_plain_clamps_and_keeps_negative_zero(tag):
    """On x with +-0.0 and indices at -1, past the end and at the int32
    extremes, P4 is take_along_axis of the clamped indices bit for bit."""
    rows, lanes, axis = probe2.GATHER_SHAPES[tag]
    x, idx = probe2.gather_edge_inputs(rows, lanes, axis)
    want = np.take_along_axis(x, np.clip(idx, 0, x.shape[axis] - 1), axis)
    got = probes.gather(torch.from_numpy(x), torch.from_numpy(idx), axis)
    assert probes.same_bits(got, torch.from_numpy(want))
    assert np.signbit(want[want == 0]).any()
    assert (idx < 0).any() and (idx >= x.shape[axis]).any()


@pytest.mark.parametrize("tag", sorted(probe2.GATHER_SHAPES))
def test_gather_plan_is_p5s_at_one_rep(tag):
    """P4's route is P5's plan at reps 1: its byte model sends gather_rows
    to a 16-column slab and the other four shapes to the direct route
    (gather_tex's table fits no slab of P5's)."""
    rows, lanes, axis = probe2.GATHER_SHAPES[tag]
    plan = probes.gather_plan(rows, lanes, axis)
    assert plan == probes.mosaic_gather_plan(rows, lanes, axis, 1)
    assert plan.route == ("slab" if tag == "gather_rows" else "direct")
    assert (probes.slab_plan(rows, lanes, axis) is None) == (
        tag == "gather_tex")


def test_sector_read_plain_and_checks():
    g = np.random.default_rng(2)
    table = g.normal(size=(64, 8)).astype(np.float32)
    addr = g.integers(0, table.size, 40).astype(np.int32)
    got = probes.sector_read(torch.from_numpy(table), torch.from_numpy(addr))
    v = table.reshape(-1)[addr].reshape(-1, 4)
    np.testing.assert_array_equal(got.numpy(),
                                  ((v[:, 0] + v[:, 1]) + v[:, 2]) + v[:, 3])
    with pytest.raises(ValueError):
        probes.sector_read(torch.from_numpy(table), torch.from_numpy(addr[:6]))
    with pytest.raises(ValueError):
        probes.sector_read(torch.from_numpy(table).double(),
                           torch.from_numpy(addr))


def test_sweep_source_variants_match_their_sources():
    """Every edit of a source variant of `tools/sweep.py` matches its
    source exactly once, so that none fails the sweep; the P4 plan variants
    give plans that cover every output of the tool's shapes."""
    from physically_based_renderer_tpu_torch.ops import cuda_lib
    from physically_based_renderer_tpu_torch.tools import sweep
    for name, (src, edits) in sweep.VARIANTS.items():
        text = (cuda_lib.CSRC / src).read_text()
        for old, _ in edits:
            assert text.count(old) == 1, (name, old)
    for name, attrs in sweep.PLAN_VARIANTS.items():
        if not name.startswith("p4_"):
            continue
        for rows, lanes, axis in probe2.GATHER_SHAPES.values():
            plan = attrs["gather_plan"](rows, lanes, axis)
            gx, gy = plan.grid(rows, lanes, axis)
            assert plan.slab_bytes(rows, lanes, axis) <= probes.P5_SMEM
            if plan.route == "direct":
                assert gx * plan.threads >= rows * lanes, name
            elif axis == 0:
                assert gx * plan.tile >= lanes and gy * plan.per >= rows
            else:
                assert gx * plan.tile >= rows and gy * plan.per >= lanes
    assert sweep._two_column_slab(True)(16384, 128, 0) == probes.GatherPlan(
        "slab", 2, 8192, 1024)


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


# ------------------------------------------------- P5-P7 (probe_mosaic.py)

from physically_based_renderer_tpu_torch.tools import (  # noqa: E402
    exp_subtile_dma, probe_mosaic)


@pytest.fixture
def ref_mosaic(monkeypatch):
    """The reference's tools/probe_mosaic.py with its kernels in interpret
    mode; its `timeit` hands back the jitted kernel and its inputs
    instead of timing them: {probe name: (run, args)}."""
    monkeypatch.syspath_prepend(str(TOOLS))
    monkeypatch.delitem(sys.modules, "probe_mosaic", raising=False)
    import probe_mosaic as ref
    monkeypatch.setattr(ref.pl, "pallas_call", functools.partial(
        ref.pl.pallas_call, interpret=True))
    caught = []
    monkeypatch.setattr(ref, "timeit", lambda f, *args, iters=0: (
        caught.append((f, args)), 1.0)[1])
    yield ref, caught
    sys.modules.pop("probe_mosaic", None)


def test_mosaic_cases_are_the_reference_calls():
    src = (TOOLS / "probe_mosaic.py").read_text()
    calls = re.findall(r"probe_gather\((\d+), (\d+), (\d)(?:, reps=(\d+))?"
                       r"(?:, iters=(\d+))?\)", src)
    assert [(int(r), int(l), int(a), int(rep or 16), int(it or 50))
            for r, l, a, rep, it in calls] == list(probe_mosaic.GATHER_CASES)


@pytest.mark.parametrize("case", probe_mosaic.GATHER_CASES,
                         ids=lambda c: f"{c[0]}x{c[1]}-axis{c[2]}")
def test_mosaic_gather_plain_is_the_probe_check(case):
    rows, lanes, axis, reps, _ = case
    x, idx = probe_mosaic.gather_inputs(rows, lanes, axis)
    got = probes.mosaic_gather(torch.from_numpy(x), torch.from_numpy(idx),
                               axis, reps)
    np.testing.assert_array_equal(
        got.numpy(), probe_mosaic.gather_expected(x, idx, axis, reps))


@pytest.mark.parametrize("case", [(8, 128, 0, 16), (8, 512, 1, 16),
                                  (32, 512, 0, 16)],
                         ids=lambda c: f"{c[0]}x{c[1]}-axis{c[2]}")
def test_mosaic_gather_matches_the_reference_kernel(case, ref_mosaic,
                                                    capsys):
    ref, caught = ref_mosaic
    rows, lanes, axis, reps = case
    ref.probe_gather(rows, lanes, axis, reps=reps)
    out = capsys.readouterr().out
    assert "FAIL" not in out and "MISMATCH" not in out
    run, (x, idx) = caught[0]
    want = np.asarray(run(x, idx))
    got = probes.mosaic_gather(torch.from_numpy(np.asarray(x)),
                               torch.from_numpy(np.asarray(idx)), axis, reps)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mosaic_gather_floor_modulo_and_checks():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    idx = torch.tensor([[-1, 7, 0, 3, -9, 5]] * 4, dtype=torch.int32)
    got = probes.mosaic_gather(x, idx, 1, 3)
    for r in range(4):
        for c in range(6):
            k = int(idx[r, c])
            assert got[r, c] == sum(x[r, (k + i) % 6] for i in range(3))
    with pytest.raises(ValueError):
        probes.mosaic_gather(x, idx[:, :5].contiguous(), 1, 3)
    with pytest.raises(ValueError):
        probes.mosaic_gather(x, idx, 2, 3)
    with pytest.raises(ValueError):
        probes.mosaic_gather(x.double(), idx, 0, 3)


def _plan_ctas(plan, rows, lanes, axis):
    """The CTAs of a slab plan as csrc/mosaic.cu's kernel cuts them: per
    CTA ((output rows), (output columns), (slab rows), (slab columns)),
    each a half-open range."""
    gx, gy = plan.grid(rows, lanes, axis)
    out = []
    for bx in range(gx):
        for by in range(gy):
            if axis == 0:
                cols = (bx * plan.tile, min(bx * plan.tile + plan.tile,
                                            lanes))
                out_rows = (by * plan.per, min(by * plan.per + plan.per,
                                               rows))
                out.append((out_rows, cols, (0, rows), cols))
            else:
                slab_rows = (bx * plan.tile, min(bx * plan.tile + plan.tile,
                                                 rows))
                cols = (by * plan.per, min(by * plan.per + plan.per, lanes))
                out.append((slab_rows, cols, slab_rows, (0, lanes)))
    return out


# Calls beside the tool's: ragged, tiny, and the edges of the slab route.
_PLAN_CASES = ((3, 6, 0, 2), (1, 1, 1, 1), (1, 1, 0, 1), (14_528, 8, 0, 3),
               (14_529, 8, 0, 3), (2, 58_112, 1, 3), (2, 58_113, 1, 3),
               (300, 700, 1, 2), (64, 4096, 1, 8))


@pytest.mark.parametrize(
    "case", [c[:4] for c in probe_mosaic.GATHER_CASES]
    + list(probe_mosaic.GATHER_EXTRA) + list(_PLAN_CASES),
    ids=lambda c: f"{c[0]}x{c[1]}-axis{c[2]}-x{c[3]}")
def test_mosaic_gather_plan_covers_every_output_once(case):
    """P5's plan: slabs or the direct route, whichever its model finds
    faster (the direct route where no slab fits).  Cut into CTAs as the
    kernel cuts it (the wrapper's plan, and the slab plan wherever one
    fits), every output is some CTA's exactly once, every index an output
    can reach (its column over all rows along axis 0, its row along axis
    1) lies in its CTA's slab, every slab fits the shared memory a CTA may
    take, and the slabs' CTAs restage no more than the plan allows."""
    rows, lanes, axis, reps = case
    fits = (rows * 4 * 4 if axis == 0 else lanes * 4) <= probes.P5_SMEM
    plan = probes.mosaic_gather_plan(rows, lanes, axis, reps)
    direct = probes.GatherPlan("direct", 0, 0, probes.P5_DIRECT_THREADS)
    assert probes.direct_plan() == direct
    slab = probes.slab_plan(rows, lanes, axis)
    assert (slab is not None) == fits
    slab = slab or direct
    assert plan == min(slab, direct, key=lambda p: probes.modelled_us(
        p, rows, lanes, axis, reps))
    for plan in {plan, slab}:
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
        if plan.route == "direct":
            assert (plan.grid(rows, lanes, axis)[0] * plan.threads
                    >= rows * lanes)
            continue
        assert plan.slab_bytes(rows, lanes, axis) <= probes.P5_SMEM
        if axis == 0:
            assert plan.tile in (4, 8, 16, 32)
            assert plan.threads % plan.tile == 0
        assert plan.grid(rows, lanes, axis)[1] <= 65_535
        count = np.zeros((rows, lanes), np.int32)
        for out_r, out_c, slab_r, slab_c in _plan_ctas(plan, rows, lanes,
                                                       axis):
            assert out_r[0] < out_r[1] and out_c[0] < out_c[1]
            count[slice(*out_r), slice(*out_c)] += 1
            if axis == 0:
                assert slab_r == (0, rows)
                assert slab_c[0] <= out_c[0] and out_c[1] <= slab_c[1]
            else:
                assert slab_c == (0, lanes)
                assert slab_r[0] <= out_r[0] and out_r[1] <= slab_r[1]
            assert ((slab_r[1] - slab_r[0]) * (slab_c[1] - slab_c[0]) * 4
                    <= plan.slab_bytes(rows, lanes, axis))
        assert (count == 1).all()
        restages = plan.grid(rows, lanes, axis)[1]
        assert restages == 1 or (restages * rows * lanes * 4
                                 <= probes.P5_RESTAGE)


def test_sweep_plan_variants_set_what_the_plan_reads():
    """Every P5 plan variant of `tools/sweep.py` names attributes the plan
    reads from `ops/probes.py`, and with them set gives a plan that covers
    the table: the direct route or a slab that fits."""
    from physically_based_renderer_tpu_torch.tools import sweep
    for name, attrs in sweep.PLAN_VARIANTS.items():
        saved = {k: getattr(probes, k) for k in attrs}
        try:
            for k, v in attrs.items():
                setattr(probes, k, v)
            for rows, lanes, axis, reps, *_ in probe_mosaic.GATHER_CASES:
                plan = probes.mosaic_gather_plan(rows, lanes, axis, reps)
                gx, gy = plan.grid(rows, lanes, axis)
                assert plan.slab_bytes(rows, lanes, axis) <= probes.P5_SMEM
                if plan.route == "direct":
                    assert gx * plan.threads >= rows * lanes, name
                elif axis == 0:
                    assert gx * plan.tile >= lanes and gy * plan.per >= rows
                else:
                    assert gx * plan.tile >= rows and gy * plan.per >= lanes
        finally:
            for k, v in saved.items():
                setattr(probes, k, v)
    assert probes.mosaic_gather_plan(1024, 512, 0, 4).tile == 16


def test_mosaic_gather_route_follows_a_ctas_slab_not_the_bytes():
    """[4096, 128] and [1024, 512] along axis 0 at reps 1 move the same
    bytes on each route, yet the card ran the first faster direct and the
    second faster on slabs (PERF.md, PR 10): the plan prices a slab by
    what one CTA stages (128 KB against 64 KB), not by all CTAs' bytes."""
    tall, wide = (4096, 128, 0, 1), (1024, 512, 0, 1)
    for route in (probes.slab_plan(*tall[:3]), probes.direct_plan()):
        assert (probes.mosaic_gather_l2_bytes(route, *tall)
                == probes.mosaic_gather_l2_bytes(
                    probes.slab_plan(*wide[:3]) if route.route == "slab"
                    else route, *wide))
    assert probes.slab_plan(*tall[:3]).slab_bytes(*tall[:3]) == 128 << 10
    assert probes.slab_plan(*wide[:3]).slab_bytes(*wide[:3]) == 64 << 10
    assert probes.mosaic_gather_plan(*tall).route == "direct"
    assert probes.mosaic_gather_plan(*wide).route == "slab"


@pytest.mark.parametrize(
    "case", [c[:4] for c in probe_mosaic.GATHER_CASES]
    + list(probe_mosaic.GATHER_EXTRA),
    ids=lambda c: f"{c[0]}x{c[1]}-axis{c[2]}-x{c[3]}")
def test_mosaic_gather_plain_is_a_rep_order_float32_sum(case):
    """On random floats (whose partial sums round) and indices in [-3 size,
    3 size), the plain version is numpy's float32 sum in rep order from 0,
    bit for bit: the order the kernel keeps."""
    rows, lanes, axis, reps = case
    x, idx = probe_mosaic.gather_random_inputs(rows, lanes, axis, seed=3)
    size = x.shape[axis]
    want = np.zeros_like(x)
    for i in range(reps):
        want = want + np.take_along_axis(x, (idx.astype(np.int64) + i) % size,
                                         axis=axis)
    got = probes.mosaic_gather(torch.from_numpy(x), torch.from_numpy(idx),
                               axis, reps).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if reps > 2:      # the data is not exact in every order
        other = np.zeros_like(x)
        for i in reversed(range(reps)):
            other = other + np.take_along_axis(
                x, (idx.astype(np.int64) + i) % size, axis=axis)
        assert not np.array_equal(other, want)


def _inner_open_count(boxes):
    """P6 as its kernel computes it (csrc/mosaic.cu on csrc/tree.cuh), in
    numpy: the pass bits of the inner nodes (both children exist), then a
    level at a time a node is open where it passes and its parent is open;
    the walk visits the root and both children of every open inner node."""
    b = boxes.reshape(-1, 6)
    m = (b.shape[0] - 1) // 2
    flag = b[:m, :3].max(axis=1) <= b[:m, 3:].min(axis=1)
    lo, width = 1, 2
    while lo < m:
        i = np.arange(lo, min(lo + width, m))
        flag[i] &= flag[(i - 1) // 2]
        lo, width = lo + width, 2 * width
    return 1 + 2 * int(flag.sum())


@pytest.mark.parametrize("rate", [1.0, 0.9, 0.7])
@pytest.mark.parametrize("sizes", ["odd n to 399", "2047", "5001", "8191"])
def test_mosaic_stack_level_parallel_model_equals_the_walk(sizes, rate):
    """P6 needs no serial walk: its numpy model and P1's (the nodes with an
    open parent) give the plain version's count on every odd n up to 399
    and at the tools' sizes."""
    ns = range(1, 400, 2) if sizes.startswith("odd") else [int(sizes)]
    for n in ns:
        boxes = probe2.tree_boxes(n, rate)
        got = int(probes.mosaic_scalar_stack(torch.from_numpy(boxes))[0])
        assert _inner_open_count(boxes) == _level_parallel(boxes)[0] == got, n


@pytest.mark.parametrize("data", sorted(probe2.STACK_DATA))
def test_mosaic_stack_counts_the_walk(data):
    """P6 counts the nodes P1's walk visits (an independent numpy walk
    here): one on the probe's own boxes (the root fails the slab test),
    2,047 and 745 on the sets where the tree is walked."""
    boxes = probe2.scalar_stack_boxes(data)
    got = probes.mosaic_scalar_stack(torch.from_numpy(boxes))
    assert got.dtype == torch.int32 and got.shape == (1,)
    assert int(got[0]) == _walk(boxes)[0] == {"probe": 1, "all": 2047,
                                              "partial": 745}[data]


def test_mosaic_stack_reference_binds_its_refs_out_of_order(ref_mosaic,
                                                            capsys):
    """A fault of the reference probe, not carried over: its kernel takes
    (boxes_ref, o_ref, stack, out_ref) while pallas_call passes inputs,
    then outputs, then scratch, so the 1-entry output serves as the stack
    and the count lands in the scratch.  In interpret mode it reports 0
    nodes on its own data, where the walk visits 1 (the port's P6)."""
    ref, caught = ref_mosaic
    ref.probe_scalar_stack()
    assert "visited 0 nodes" in capsys.readouterr().out
    run, _ = caught[0]
    boxes = probe2.scalar_stack_boxes("probe")
    assert int(np.asarray(run(boxes.reshape(-1, 6)))[0]) == 0
    assert int(probes.mosaic_scalar_stack(torch.from_numpy(boxes))[0]) == 1


def test_mosaic_stack_rejects_bad_boxes():
    for n in (7, 12):                  # not 6 floats a node; an even tree
        with pytest.raises(ValueError):
            probes.mosaic_scalar_stack(torch.zeros(n * 6 if n == 12 else n))
    with pytest.raises(ValueError):
        probes.mosaic_scalar_stack(torch.zeros((3, 6)))


_TINY = np.float32(2.0 ** -126)         # the least normal float32


def _chunk_numpy(o, t, n_chunks, lo=1e-9, zero_huge=False, ftz=False,
                 contract=False):
    """probe_mosaic.py:155-165 in numpy float32, op by op.  lo: the |det|
    that inv needs to pass; zero_huge: inv = 0 where |det| >= 2^126 (what
    the branch-free reciprocal gives there); ftz and contract: the float
    rules of XLA's CPU backend, which flushes subnormal inputs and results
    to zero and contracts the three multiply-adds (one rounding each)."""
    f = np.float32
    z = ((lambda x: np.where(np.abs(x) < _TINY, np.copysign(f(0), x),
                             x).astype(np.float32)) if ftz
         else (lambda x: x))
    if contract:
        mad = lambda a, b, c: z((a.astype(np.float64) * b + c).astype(
            np.float32))
    else:
        mad = lambda a, b, c: z(z(a * b) + c)
    rox = z(o[0][:, None])
    t = z(t)
    acc = np.full((o.shape[1], 1), f(1e30), np.float32)
    with np.errstate(all="ignore"):
        for j in range(n_chunks):
            e = z(z(t * f(j + 1.0)) * f(1.0001))
            px = z(rox * e[0][None, :])
            det = mad(px, e[1][None, :], px)
            inv = z(np.where(np.abs(det) > f(lo), f(1.0) / det, f(0.0)))
            if zero_huge:
                inv = np.where(np.abs(det) >= f(2.0 ** 126), f(0.0), inv)
            uu = z(px * inv)
            vv = mad(uu, inv, px)
            tt = mad(vv, uu, uu)
            ok = (uu >= 0) & (vv >= 0) & (z(uu + vv) <= 1) & (tt > 0)
            tt = np.where(ok, tt, f(1e30))
            acc = np.minimum(acc, tt.min(axis=1, keepdims=True))
    return acc


@pytest.mark.parametrize("data", sorted(probe_mosaic.CHUNK_DATA))
def test_chunk_plain_is_the_numpy_restatement(data):
    o, t = probe_mosaic.chunk_inputs(data)
    got = probes.chunk(torch.from_numpy(o), torch.from_numpy(t), 8).numpy()
    want = _chunk_numpy(o, t, 8)
    np.testing.assert_array_equal(got, want)
    if data == "probe":                # all ones: every test is masked
        assert (got == np.float32(1e30)).all()
    elif data == "random":
        assert (got < 1e30).all() and (got > 0).all()
    else:                              # rox = 0 and 1e10 hit nothing
        assert (got > 0).all()
        assert np.flatnonzero(got == np.float32(1e30)).tolist() == [0, 1]


def test_chunk_edge_data_reaches_each_edge():
    """The edge set's outputs depend on each edge: moving the 1e-9 test by
    2% either way changes a negative ray's result, and inv = 0 where
    |det| >= 2^126 (the branch-free reciprocal's value there, where the
    kernel divides instead) changes a positive ray's; t holds +-inf and
    NaN."""
    o, t = probe_mosaic.chunk_inputs("edge")
    b = o.shape[1]
    want = _chunk_numpy(o, t, 8)
    for lo in (0.98e-9, 1.02e-9):
        moved = (_chunk_numpy(o, t, 8, lo=lo) != want)[:, 0]
        assert moved[b // 2:].sum() >= 100 and not moved[:b // 2].any()
    zeroed = (_chunk_numpy(o, t, 8, zero_huge=True) != want)[:, 0]
    assert zeroed[:b // 2].sum() >= 100 and not zeroed[b // 2:].any()
    assert np.isposinf(t).any() and np.isneginf(t).any()
    assert np.isnan(t).any()


@pytest.mark.parametrize("data", sorted(probe_mosaic.CHUNK_DATA))
def test_chunk_matches_the_reference_kernel(data, ref_mosaic, capsys):
    """The reference in interpret mode is exactly the numpy restatement
    under XLA's CPU float rules (multiply-adds contracted, subnormals
    flushed to zero).  The plain version keeps IEEE float32 without
    contraction, as the kernel on the card does: within 2 ulps of the
    reference on every ray whose result no flushed subnormal changes (all
    rays of the probe's and the random data; on the edge data the 126
    positive rays whose least tt passes through a subnormal 1 / det are
    the others)."""
    ref, caught = ref_mosaic
    ref.probe_chunk()
    capsys.readouterr()
    run, _ = caught[0]
    o, t = probe_mosaic.chunk_inputs(data)
    want = np.asarray(run(o, t))
    np.testing.assert_array_equal(
        want, _chunk_numpy(o, t, 8, ftz=True, contract=True))
    got = probes.chunk(torch.from_numpy(o), torch.from_numpy(t), 8).numpy()
    flushed = _chunk_numpy(o, t, 8, ftz=True) != _chunk_numpy(o, t, 8)
    assert flushed.sum() == (126 if data == "edge" else 0)
    np.testing.assert_allclose(got[~flushed], want[~flushed], rtol=2.5e-7,
                               atol=0)


# ----------------------------------------------- P8 (exp_subtile_dma.py)

@pytest.fixture
def ref_subtile(monkeypatch):
    """The reference's tools/exp_subtile_dma.py kernel and `run` in
    interpret mode, without its import-time run: only its imports and
    function definitions are executed."""
    import ast
    from jax.experimental import pallas as pl
    path = TOOLS / "exp_subtile_dma.py"
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body if isinstance(
        n, (ast.Import, ast.ImportFrom, ast.FunctionDef))]
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    ns = {}
    exec(compile(tree, str(path), "exec"), ns)
    return ns["run"]


def test_subtile_copy_matches_the_reference_kernel(ref_subtile):
    nb = 8
    src, idx = exp_subtile_dma.inputs(3, nb)
    want = np.asarray(ref_subtile(idx, src, n_iters=exp_subtile_dma.NI,
                                  ch=exp_subtile_dma.CH, nb=nb))
    got = probes.subtile_copy(torch.from_numpy(src), torch.from_numpy(idx),
                              exp_subtile_dma.NI, exp_subtile_dma.CH)
    assert got.shape == want.shape == (nb, 1, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_subtile_copy_plain_is_the_reference_check():
    nb = 64
    src, idx = exp_subtile_dma.inputs(0, nb)
    got = probes.subtile_copy(torch.from_numpy(src), torch.from_numpy(idx),
                              exp_subtile_dma.NI, exp_subtile_dma.CH)
    np.testing.assert_allclose(got.numpy()[:, 0],
                               exp_subtile_dma.expected(src, idx, nb),
                               rtol=exp_subtile_dma.REF_RTOL)


@pytest.mark.parametrize("n_src,n_copies,route", [
    (4096, 8191, "direct"), (4096, 8192, "row_sums"), (1, 1, "direct"),
    (1, 2, "row_sums"), (4096, 96, "direct"), (4096, 32768, "row_sums")])
def test_subtile_copy_route_at_its_boundary(n_src, n_copies, route):
    """The row-sum pass reads every tile once: it is taken from twice as
    many copies as the table has tiles, where the routes tie on the card;
    the tool's shape takes it, the card test's nb = 3 (96 copies) the
    direct route."""
    assert probes.P8_ROW_SUMS_COPIES == 2
    assert probes.subtile_copy_route(n_src, n_copies) == route


def _row_sums_first(src, idx, nb):
    """The row-sum-first route in numpy float32: every tile's rows summed
    once, in order; then each copy's sums added step by step from 0."""
    n_iters, ch = exp_subtile_dma.NI, exp_subtile_dma.CH
    rows = src[:, 0].copy()
    for r in range(1, src.shape[1]):
        rows = rows + src[:, r]
    k = np.clip(idx, 0, src.shape[0] - 1).reshape(nb, n_iters, ch)
    acc = np.zeros((nb, ch, src.shape[2]), np.float32)
    for j in range(n_iters):
        acc = acc + rows[k[:, j]]
    return acc.reshape(nb, 1, -1)


@pytest.mark.parametrize("nb", [exp_subtile_dma.NB, 3])
def test_subtile_copy_row_sums_first_is_plain(nb):
    """Summing each tile's rows once and then gathering the sums does the
    plain version's additions in its order: equal bit for bit, and within
    the reference's own check."""
    src, idx = exp_subtile_dma.inputs(0, nb)
    idx[:2] = (-5, src.shape[0] + 7)             # clamped into range
    want = _row_sums_first(src, idx, nb)
    got = probes.subtile_copy(torch.from_numpy(src), torch.from_numpy(idx),
                              exp_subtile_dma.NI, exp_subtile_dma.CH)
    assert probes.same_bits(got, torch.from_numpy(want))
    idx = np.clip(idx, 0, src.shape[0] - 1)
    np.testing.assert_allclose(want[:, 0],
                               exp_subtile_dma.expected(src, idx, nb),
                               rtol=exp_subtile_dma.REF_RTOL)


@pytest.mark.parametrize("nb", [1, 5])
def test_subtile_read_plain_is_the_xor_of_every_copy(nb):
    src, idx = exp_subtile_dma.inputs(2, nb)
    idx[0] = -1
    n_iters, ch = exp_subtile_dma.NI, exp_subtile_dma.CH
    bits = src.view(np.int32)
    want = np.zeros((nb, 32), np.int32)
    for g in range(nb):
        for k in idx[g * n_iters * ch:(g + 1) * n_iters * ch]:
            for r in range(16):
                want[g] ^= bits[min(max(k, 0), src.shape[0] - 1), r]
    got = probes.subtile_read(torch.from_numpy(src), torch.from_numpy(idx),
                              n_iters, ch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_subtile_copy_rejects_bad_shapes():
    src = torch.zeros((4, 16, 32))
    idx = torch.zeros(32, dtype=torch.int32)
    for bad in (dict(src=torch.zeros((4, 16, 16))), dict(ch=0),
                dict(idx=torch.zeros(31, dtype=torch.int32)),
                dict(idx=idx.long())):
        kw = dict(dict(src=src, idx=idx, n_iters=8, ch=4), **bad)
        with pytest.raises(ValueError):
            probes.subtile_copy(kw["src"], kw["idx"], kw["n_iters"],
                                kw["ch"])


def test_mosaic_tools_run_on_the_cpu(capsys):
    probes.reset_launches()
    assert probe_mosaic.main(["--device", "cpu"]) == 0
    assert exp_subtile_dma.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "--- probe_mosaic on cpu"
    assert len(lines) == 1 + 10 + 3 + 3 + 2
    body = lines[1:17] + lines[18:]
    assert all("ok=True" in ln and ln.endswith("[cpu]") for ln in body)
    assert "visited 1 nodes" in lines[11]
    assert not any(probes.LAUNCHES.values())         # CPU: plain versions
