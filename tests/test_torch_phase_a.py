"""Phase A of the block tracer (`ops/blocktrace.py::block_inputs`): the
kernels of `csrc/phase_a.cu` against `block_inputs_plain`.

On the CPU: `block_inputs` is the plain version and launches nothing; the
wrapper of the card route, run here on CPU memory with the C entries
replaced by `_StandIn` (their work in torch ops, the sort as the kernels
count it), gives the plain version's outputs bit for bit; a card call
above the stated limit raises.  On the card
(tests marked `cuda`), the kernels equal the plain version bit for bit on
every route.  The file imports no JAX, so on a machine with only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_phase_a.py -q
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch.accel.clusters import (
    ClusterGrid, _parent_boxes)
from physically_based_renderer_tpu_torch.core import rng
from physically_based_renderer_tpu_torch.integrator import path
from physically_based_renderer_tpu_torch.ops import blocktrace as bt
from physically_based_renderer_tpu_torch.ops import cuda_lib
from physically_based_renderer_tpu_torch.ops.intersect import BIG
from physically_based_renderer_tpu_torch.scene import types
from physically_based_renderer_tpu_torch.utils import config
from torch_parity import cuda_device  # noqa: F401

NAMES = ("u_idx", "o", "d", "t_max", "soup", "n_valid", "entry")


def _grid(c, k=128, parents=True, seed=0, device="cpu"):
    """C random boxes in [-1, 1.3]^3, with their parent boxes, and an
    all-zero soup of the grid's shape."""
    g = np.random.default_rng(seed)
    lo = g.uniform(-1.0, 1.0, (c, 3)).astype(np.float32)
    hi = lo + g.uniform(0.01, 0.3, (c, 3)).astype(np.float32)
    amin, amax = torch.from_numpy(lo), torch.from_numpy(hi)
    pmin, pmax = _parent_boxes(amin, amax) if parents else (None, None)
    grid = ClusterGrid(aabb_min=amin, aabb_max=amax,
                       tri_id=torch.zeros((c, k), dtype=torch.int32),
                       parent_min=pmin, parent_max=pmax,
                       soup=torch.zeros((c + 1, 9, k)))
    return _to(grid, device)


def _to(grid, device):
    return type(grid)(**{f: None if getattr(grid, f) is None
                         else getattr(grid, f).to(device)
                         for f in grid.__dataclass_fields__})


def _rays(n, seed, device="cpu", block=256):
    """Rays from [-1.5, 1.5]^3 in random directions, a tenth with a zero
    component (of either sign), a per-ray t_max of which a tenth is 0;
    where there are two blocks or more, every ray of block 1 and lane 0 of
    block 2 point away from the boxes from far outside (culled)."""
    g = np.random.default_rng(seed)
    o = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    zero = g.random((n, 3)) < 0.04
    d[zero] = np.where(g.random(int(zero.sum())) < 0.5, 0.0, -0.0)
    tm = g.uniform(0.05, 3.0, n).astype(np.float32)
    tm[g.random(n) < 0.1] = 0.0
    for lanes in (slice(block, 2 * block), slice(2 * block, 2 * block + 1)):
        o[lanes] = (5.0, 5.0, 5.0)
        d[lanes] = np.float32(1.0 / np.sqrt(3.0))
    return [torch.from_numpy(x).to(device) for x in (o, d, tm)]


def _sphere_rays(n, seed, device):
    """Rays from a box around the helmet_proc sphere, a third starting
    inside it, with random per-ray t_max (tests/test_torch_cuda.py's)."""
    g = np.random.default_rng(seed)
    o = g.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    o[: n // 3] *= np.float32(0.5)
    d = g.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tm = g.uniform(0.05, 3.0, n).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (o, d, tm)]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _first_difference(name, g, w):
    at = (_bits(g) != _bits(w)).nonzero()[:3].tolist()
    return f"{name} differs at {at}: {[g[tuple(i)].item() for i in at]} " \
           f"against {[w[tuple(i)].item() for i in at]}"


def _assert_same(got, want):
    (g_args, g_perm), (w_args, w_perm) = got, want
    for name, g, w in zip(NAMES, g_args, w_args):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.is_contiguous(), name
        assert torch.equal(_bits(g), _bits(w)), _first_difference(name, g, w)
    assert (g_perm is None) == (w_perm is None)
    if g_perm is not None:
        assert g_perm.dtype == w_perm.dtype == torch.int64
        assert torch.equal(g_perm, w_perm), _first_difference(
            "perm", g_perm, w_perm)


# --- on the CPU --------------------------------------------------------------

def test_cpu_calls_take_the_plain_version(monkeypatch):
    """On CPU tensors nothing launches, nothing counts and the kernel
    library is never loaded."""
    def refuse():
        raise AssertionError("the kernel library was loaded for a CPU call")

    monkeypatch.setattr(cuda_lib, "library", refuse)
    before = bt.PHASE_A_LAUNCHES
    grid = _grid(40)
    o, d, tm = _rays(1000, 1)
    for sort in (False, True):
        for t_max in (BIG, tm):
            _assert_same(
                bt.block_inputs(grid, o, d, 1e-3, t_max, max_u=8, sort=sort),
                bt.block_inputs_plain(grid, o, d, 1e-3, t_max, max_u=8,
                                      sort=sort))
    assert bt.PHASE_A_LAUNCHES == before == 0


def test_other_devices_raise():
    grid = _grid(8)
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bt.block_inputs(grid, o, o, 1e-3)


def _mem(ptr, n, ctype=ctypes.c_float):
    return torch.from_numpy(np.ctypeslib.as_array(
        (ctype * n).from_address(ptr)))


class _StandIn:
    """csrc/phase_a.cu's C entries in torch ops, on the memory the wrapper
    hands them: what each entry reads and where it writes, and the sort as
    the kernels count it (a histogram a tile of 1,024 rays; a ray's place
    is the count of the smaller keys, of its key in the tiles before, and
    of its key before it in its tile)."""

    def __init__(self, max_u):
        self.max_u = max_u

    @staticmethod
    def _grid(cmin, cmax, c, pmin=None, pmax=None, n_par=0):
        parents = {}
        if pmin:
            parents = dict(parent_min=_mem(pmin, 3 * n_par).view(n_par, 3),
                           parent_max=_mem(pmax, 3 * n_par).view(n_par, 3))
        return ClusterGrid(aabb_min=_mem(cmin, 3 * c).view(c, 3),
                           aabb_max=_mem(cmax, 3 * c).view(c, 3),
                           tri_id=torch.zeros((c, 1), dtype=torch.int32),
                           **parents)

    @staticmethod
    def _culled(o, d, t_max, step, value, n, cmin, cmax, c, t_min):
        ro = _mem(o, 3 * n).view(n, 3).clone()
        rd = _mem(d, 3 * n).view(n, 3).clone()
        if t_max:
            tm = _mem(t_max, (n - 1) * step + 1)[torch.arange(n) * step]
        else:
            tm = torch.full((n,), value, dtype=torch.float32)
        grid = _StandIn._grid(cmin, cmax, c)
        tm = bt._root_cull(grid, ro, rd, t_min, tm)
        return ro, rd, tm, torch.where(tm > 0.0, bt.dir_bin(rd), 24)

    def pbr_phase_a_keys(self, o, d, t_max, step, value, n, cmin, cmax, c,
                         t_min, hist, stream):
        key = self._culled(o, d, t_max, step, value, n, cmin, cmax, c,
                           t_min)[3]
        tiles = -(-n // bt._SORT_TILE)
        h = torch.zeros((tiles, bt._SORT_KEYS), dtype=torch.int32)
        h.index_put_((torch.arange(n) // bt._SORT_TILE, key),
                     torch.ones(n, dtype=torch.int32), accumulate=True)
        _mem(hist, h.numel(), ctypes.c_int).copy_(h.reshape(-1))
        return 0

    def pbr_phase_a_scatter(self, o, d, t_max, step, value, n, n_pad, cmin,
                            cmax, c, t_min, hist, o_s, d_s, tm_s, perm,
                            stream):
        ro, rd, tm, key = self._culled(o, d, t_max, step, value, n, cmin,
                                       cmax, c, t_min)
        tiles = -(-n // bt._SORT_TILE)
        h = _mem(hist, tiles * bt._SORT_KEYS, ctypes.c_int).view(
            tiles, bt._SORT_KEYS).long()
        total = h.sum(0)
        start = torch.cumsum(total, 0) - total
        before_tile = torch.cumsum(h, 0) - h
        tile = torch.arange(n) // bt._SORT_TILE
        onehot = torch.nn.functional.one_hot(key, bt._SORT_KEYS)
        rank = torch.zeros(n, dtype=torch.int64)
        for t in range(tiles):
            s = slice(t * bt._SORT_TILE, (t + 1) * bt._SORT_TILE)
            rank[s] = (torch.cumsum(onehot[s], 0) - onehot[s]).gather(
                1, key[s, None])[:, 0]
        pos = start[key] + before_tile[tile, key] + rank
        out_o = _mem(o_s, 3 * n_pad).view(n_pad, 3)
        out_d = _mem(d_s, 3 * n_pad).view(n_pad, 3)
        out_t = _mem(tm_s, n_pad)
        out_o[pos], out_d[pos], out_t[pos] = ro, rd, tm
        _mem(perm, n, ctypes.c_longlong)[pos] = torch.arange(n)
        out_o[n:], out_d[n:], out_t[n:] = 3e30, torch.tensor([1.0, 0, 0]), 0
        return 0

    def pbr_phase_a_select(self, o, d, t_max, step, value, n, cmin, cmax, c,
                           pmin, pmax, n_par, n_sel, n_u, n_u_pad, t_min,
                           sorted_, n_blocks, block, ob, db, tmb, u_idx,
                           u_entry, n_valid, stream):
        grid = self._grid(cmin, cmax, c, pmin, pmax, n_par)
        assert bt._selection(grid, self.max_u) == (n_sel, n_u)
        n_pad = n_blocks * block
        o_s = _mem(ob, 3 * n_pad).view(n_pad, 3)
        d_s = _mem(db, 3 * n_pad).view(n_pad, 3)
        tm_s = _mem(tmb, n_pad)
        if not sorted_:
            ro, rd, tm, _ = self._culled(o, d, t_max, step, value, n, cmin,
                                         cmax, c, t_min)
            o_s[:n], d_s[:n], tm_s[:n] = ro, rd, tm
            o_s[n:], d_s[n:], tm_s[n:] = 3e30, torch.tensor([1.0, 0, 0]), 0
        u, e, nv, *_ = bt._select_candidates(grid, o_s, d_s, tm_s, n_blocks,
                                             block, t_min, self.max_u)
        out_u = _mem(u_idx, n_blocks * n_u_pad, ctypes.c_int).view(
            n_blocks, n_u_pad)
        out_e = _mem(u_entry, n_blocks * n_u_pad).view(n_blocks, n_u_pad)
        out_u[:, :n_u], out_u[:, n_u:] = u, c
        out_e[:, :n_u], out_e[:, n_u:] = e, BIG
        _mem(n_valid, n_blocks, ctypes.c_int).copy_(nv)
        return 0


# (grid, rays, block, max_u, chunk): each route of the card's wrapper.
_CASES = {
    "flat, 8 clusters": (dict(c=8), 2_500, 256, 48, 4),
    "flat, one tile": (dict(c=8), 700, 256, 48, 4),
    "flat at k = 32, chunk 16": (dict(c=40, k=32), 3_000, 128, 48, 16),
    "flat, no parents": (dict(c=300, parents=False), 2_100, 512, 48, 4),
    "hierarchical": (dict(c=300), 2_100, 256, 48, 4),
    "hierarchical at k = 32": (dict(c=300, k=32), 1_500, 32, 96, 4),
    "flat over max_u": (dict(c=100), 1_100, 96, 200, 1),
    "flat at the limit": (dict(c=16384, parents=False), 1_000, 256, 48, 4),
}


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("case", list(_CASES))
def test_card_wrapper_hands_the_kernels_what_the_plain_version_computes(
        monkeypatch, case, per_ray, sort):
    """The card's wrapper on CPU tensors with the library replaced by
    `_StandIn`: 1 launch, 3 with the sort, and the plain version's
    outputs."""
    grid_kw, n, block, max_u, chunk = _CASES[case]
    grid = _grid(**grid_kw)
    o, d, tm = _rays(n, n, block=block)
    t_max = tm if per_ray else 2.5
    want = bt.block_inputs_plain(grid, o, d, 1e-3, t_max, block, max_u, sort,
                                 chunk)
    monkeypatch.setattr(bt, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_lib, "library", lambda: _StandIn(max_u))
    monkeypatch.setattr(cuda_lib, "stream_ptr", lambda device: 0)
    monkeypatch.setattr(bt, "PHASE_A_LAUNCHES", 0)
    got = bt.block_inputs(grid, o, d, 1e-3, t_max, block, max_u, sort, chunk)
    assert bt.PHASE_A_LAUNCHES == (3 if sort else 1)
    _assert_same(got, want)


@pytest.mark.parametrize("t_max", [BIG, torch.tensor(2.5),
                                   torch.tensor([2.5])])
def test_card_t_max_by_value_or_array(t_max):
    """A number or a one-element CPU tensor goes by value (no copy to the
    card); a tensor on the rays' device is read at a step of 0 or 1."""
    arr, step, value = bt._card_t_max(t_max, 10, torch.device("cpu"))
    if isinstance(t_max, torch.Tensor):
        assert arr is None and value == 2.5
    else:
        assert arr is None and value == BIG
    assert step == 0


def test_card_t_max_per_ray_and_strided():
    tm = torch.arange(20, dtype=torch.float64)
    arr, step, _ = bt._card_t_max(tm[::2], 10, torch.device("meta"))
    assert arr.dtype == torch.float32 and step == 1 and arr.shape == (10,)


def _fits(grid, n_sel):
    try:
        bt._check_candidates(grid, n_sel)
    except ValueError:
        return False
    return True


def test_selection_limit_covers_the_parentless_helmet():
    """The kernels take a flat selection over 777 clusters (a parentless
    grid of the 99,400-triangle helmet packed full), 1,024 (the helmet
    grid as built, without parents), ~4,096 (its k = 32 sub-clusters) and
    up to 16,384; above, the call raises."""
    assert bt.PHASE_A_MAX_CANDIDATES == 16384
    for c, ok in ((777, True), (1024, True), (4096, True), (16384, True),
                  (16385, False)):
        grid = _grid(c, parents=False)
        n_sel, n_u = bt._selection(grid, 48)
        assert (n_sel, n_u) == (0, 48)
        assert _fits(grid, n_sel) is ok


@pytest.mark.parametrize("c,max_u,want", [
    (300, 48, (24, 48)),      # hierarchical: max_u // 2 parents, 4 children
    (300, 8, (8, 8)),         # at least 8 parents
    (192, 48, (0, 48)),       # C <= 4 max_u: flat
    (8, 48, (0, 8)),          # fewer clusters than max_u
    (20, 200, (0, 20)),
])
def test_selection_follows_select_candidates(c, max_u, want):
    grid = _grid(c)
    assert bt._selection(grid, max_u) == want
    o, d, tm = _rays(300, 3)
    n_pad = 512
    u_idx = bt._select_candidates(
        grid, torch.cat([o, o[:212]]), torch.cat([d, d[:212]]),
        torch.cat([tm, tm[:212]]), n_pad // 256, 256, 1e-3, max_u)[0]
    assert u_idx.shape[1] == want[1]


def test_hierarchical_limit_counts_parents_and_children():
    """On the hierarchical route both stages count: C = 65,536 clusters
    have 16,384 parents (taken), 65,540 have 16,385 (raises)."""
    for c, ok in ((65536, True), (65540, False)):
        grid = _grid(c)
        n_sel, _ = bt._selection(grid, 48)
        assert n_sel == 24
        assert _fits(grid, n_sel) is ok


def test_card_calls_above_the_limit_raise(monkeypatch):
    """A card call whose selection one CTA cannot hold raises before it
    launches anything, flat or hierarchical; there is no plain route on
    the card."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    o, d, tm = _rays(600, 4)
    monkeypatch.setattr(bt, "_on_card", lambda t: True)
    monkeypatch.setattr(cuda_lib, "library", refuse)
    monkeypatch.setattr(bt, "PHASE_A_LAUNCHES", 0)
    for grid in (_grid(16385, parents=False), _grid(65540)):
        for sort in (False, True):
            with pytest.raises(ValueError, match="at most 16384"):
                bt.block_inputs(grid, o, d, 1e-3, tm, sort=sort)
    assert bt.PHASE_A_LAUNCHES == 0


def test_card_boxes_refuse_another_device():
    grid = _grid(8)
    with pytest.raises(ValueError, match="cluster grid is on cpu"):
        bt._card_boxes(grid, 0, torch.device("meta"))


# --- on the card -------------------------------------------------------------

def _card(grid, o, d, t_min, t_max, **kw):
    """block_inputs (the kernels) and block_inputs_plain on the same
    call, and the kernels' launches."""
    before = bt.PHASE_A_LAUNCHES
    got = bt.block_inputs(grid, o, d, t_min, t_max, **kw)
    torch.cuda.synchronize()
    launches = bt.PHASE_A_LAUNCHES - before
    want = bt.block_inputs_plain(grid, o, d, t_min, t_max, **kw)
    _assert_same(got, want)
    return launches


@pytest.fixture(scope="module")
def helmet_proc():
    bc = config.get("helmet_proc")
    return bc, config.build_scene(bc.scene, "cpu")


@pytest.fixture(scope="module")
def helmet():
    bc = config.get("helmet")
    return bc, config.build_scene(bc.scene, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_synthetic_rays_on_every_route(cuda_device, sort):
    """Random boxes, flat (8, 300 and 16,384 clusters without parents:
    the limit, ~208 KB of shared memory a CTA) and hierarchical, k = 128 and 32 at chunk 4 and 16, blocks
    32-1024; rays with zero components, dead lanes, an all-dead block and
    a block whose lane 0 is dead, n not a multiple of B; scalar and per-ray
    t_max."""
    for grid_kw, n, block, max_u, chunk in _CASES.values():
        grid = _grid(**grid_kw, device=cuda_device)
        o, d, tm = _rays(n, n + block, cuda_device, block=block)
        for t_max in (2.5, tm):
            for t_min in (0.0, 1e-3):
                assert _card(grid, o, d, t_min, t_max, block=block,
                             max_u=max_u, sort=sort, chunk=chunk) == (
                    3 if sort else 1)
    grid = _grid(8, device=cuda_device)
    o, d, tm = _rays(5, 5, cuda_device)
    assert _card(grid, o, d, 1e-3, tm, sort=sort, block=1024) == (
        3 if sort else 1)


@pytest.mark.cuda
def test_spd_tetra_frame_calls(cuda_device, monkeypatch):
    """Every tracer call of a 64x64 spd_tetra frame (camera, bounce and
    env-shadow rays: unsorted and sorted, scalar and per-ray t_max)
    through the kernels, against the plain version."""
    bc = config.get("spd_tetra")
    cfg = dataclasses.replace(bc.render, width=64, height=64, spp=1)
    scene, cam = config.build_scene(bc.scene, cuda_device)
    calls = []
    inner = bt.block_inputs

    def record(grid, o, d, t_min, t_max, *args):
        calls.append((grid, o.clone(), d.clone(), t_min,
                      t_max.clone() if isinstance(t_max, torch.Tensor)
                      else t_max, args))
        return inner(grid, o, d, t_min, t_max, *args)

    monkeypatch.setattr(bt, "block_inputs", record)
    path.render_with_stats(scene, cam, rng.key(5, cuda_device), cfg)
    monkeypatch.undo()
    assert len(calls) == 2 * cfg.max_bounces + 1
    sorted_calls = 0
    for grid, o, d, t_min, t_max, args in calls:
        block, max_u, sort, chunk, geometry = args
        sorted_calls += sort
        assert _card(grid, o, d, t_min, t_max, block=block, max_u=max_u,
                     sort=sort, chunk=chunk,
                     geometry=geometry) == (3 if sort else 1)
    assert sorted_calls == 2 * cfg.max_bounces


@pytest.mark.cuda
def test_spd_tetra_frame_equals_the_plain_phase_a(cuda_device, monkeypatch):
    """A 64x64 spd_tetra frame with the kernels equals, pixel for pixel,
    the same frame with the plain phase A (rendered eagerly: a second
    render_with_stats of the scene would capture the frame's CUDA graph,
    integrator/frame_graph.py, and the plain phase A copies from the
    host)."""
    bc = config.get("spd_tetra")
    cfg = dataclasses.replace(bc.render, width=64, height=64)
    scene, cam = config.build_scene(bc.scene, cuda_device)
    before = bt.PHASE_A_LAUNCHES
    film, count = path.render_with_stats(scene, cam, rng.key(7, cuda_device),
                                         cfg)
    torch.cuda.synchronize()
    # per sample 1 camera call (1 launch) and 2 per bounce (3 each)
    assert bt.PHASE_A_LAUNCHES - before == cfg.spp * (
        1 + 2 * 3 * cfg.max_bounces)
    monkeypatch.setattr(bt, "block_inputs", bt.block_inputs_plain)
    with torch.no_grad():
        plain, plain_count = path._render_with_stats_dense(
            scene, cam, rng.key(7, cuda_device), cfg)
    assert torch.equal(film.hdr.view(torch.int32),
                       plain.hdr.view(torch.int32))
    assert torch.equal(torch.as_tensor(count), torch.as_tensor(plain_count))


def _card_grid(scene, device, **kw):
    return _to(dataclasses.replace(scene.clusters, **kw), device)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_helmet_proc_hierarchical(cuda_device, helmet_proc, sort):
    """helmet_proc (1,024 clusters of 128: the hierarchical route) at B 256
    and 512, scalar and per-ray t_max, 100,003 rays."""
    _, (scene, _) = helmet_proc
    grid = _card_grid(scene, cuda_device)
    assert grid.num_clusters > 4 * 48 and grid.parent_min is not None
    o, d, tm = _sphere_rays(100_003, 21, cuda_device)
    for block in (256, 512):
        for t_max in (1e30, tm):
            assert _card(grid, o, d, 1e-3, t_max, block=block,
                         sort=sort) == (3 if sort else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_parentless_helmet_flat(cuda_device, helmet, sort):
    """The helmet's grid without parents: the flat route over its 1,024
    clusters (the bitonic sort at 1,024 pairs), and at k = 32 over its
    ~4,096 sub-clusters (4,096 pairs, over 48 KB of shared memory)."""
    bc, (scene, _) = helmet
    grids = {128: _card_grid(scene, cuda_device, parent_min=None,
                             parent_max=None),
             32: _to(dataclasses.replace(
                 types.with_clusters(scene, k=32).clusters, parent_min=None,
                 parent_max=None), cuda_device)}
    assert grids[128].num_clusters == 1024
    assert 2048 < grids[32].num_clusters <= bt.PHASE_A_MAX_CANDIDATES
    o, d, tm = _sphere_rays(100_003, 22, cuda_device)
    for k, grid in grids.items():
        for t_max in (1e30, tm):
            for chunk in ((bc.render.chunk,) if k == 128 else (4, 16)):
                assert _card(grid, o, d, 1e-3, t_max,
                             block=bc.render.block_size,
                             max_u=bc.render.max_u, sort=sort,
                             chunk=chunk) == (3 if sort else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [4, 16])
def test_k32_grid(cuda_device, helmet_proc, chunk):
    """helmet_proc at k = 32 (hierarchical over 1,024 parents), chunk 4 and
    16, sorted and unsorted, max_u 48 and 96."""
    _, (scene, _) = helmet_proc
    grid = _to(types.with_clusters(scene, k=32).clusters, cuda_device)
    assert grid.k == 32
    o, d, tm = _sphere_rays(50_021, 23, cuda_device)
    for sort in (False, True):
        for max_u in (48, 96):
            assert _card(grid, o, d, 1e-3, tm, max_u=max_u, sort=sort,
                         chunk=chunk) == (3 if sort else 1)


@pytest.mark.cuda
def test_above_the_limit_raises(cuda_device, helmet_proc):
    """helmet_proc at k = 32 without parents takes the kernels; a grid of
    16,385 clusters without parents raises on the card, with no launch."""
    _, (scene, _) = helmet_proc
    grid = _to(dataclasses.replace(types.with_clusters(scene, k=32).clusters,
                                   parent_min=None, parent_max=None),
               cuda_device)
    assert grid.num_clusters <= bt.PHASE_A_MAX_CANDIDATES
    o, d, tm = _sphere_rays(10_007, 24, cuda_device)
    assert _card(grid, o, d, 1e-3, tm, sort=True) == 3
    before = bt.PHASE_A_LAUNCHES
    with pytest.raises(ValueError, match="at most 16384"):
        bt.block_inputs(_grid(16385, parents=False, device=cuda_device), o,
                        d, 1e-3, tm, sort=True)
    assert bt.PHASE_A_LAUNCHES == before


@pytest.mark.cuda
def test_no_host_sync(cuda_device):
    """A call makes no host sync: sorted and unsorted, scalar and per-ray
    t_max, under torch's sync debug mode set to raise."""
    grid = _grid(8, device=cuda_device)
    o, d, tm = _rays(3_000, 25, cuda_device)
    bt.block_inputs(grid, o, d, 1e-3, tm, sort=True)       # load the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sort in (False, True):
            for t_max in (BIG, tm):
                bt.block_inputs(grid, o, d, 1e-3, t_max, sort=sort)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
