"""The dense frame as one CUDA graph (`integrator/frame_graph.py`) and the
device constants that let it be captured.

On the CPU: the graph never engages there, the conditions it engages
under, its cache key, and the constants made once (`device_constant`, the
cached morton ids and texture meta tables) against the values the
integrator made per call.  On the card (marked `cuda`): replayed frames
against eager `_render_with_stats_dense` frames bit for bit, a moved
camera, an in-place edit, two frames held at once, a replay's kernels
by name against an eager frame's launches, and an eager frame with no
host sync.  The file imports neither JAX nor
PIL; on a machine with only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_frame_graph.py -q
"""

import dataclasses
import importlib.util
import types as pytypes
from pathlib import Path

import numpy as np
import pytest
import torch

from physically_based_renderer_tpu_torch.core import math3d, rng
from physically_based_renderer_tpu_torch.core.camera import Camera
from physically_based_renderer_tpu_torch.core.morton import (
    morton_pixel_ids, morton_pixel_ids_on)
from physically_based_renderer_tpu_torch.integrator import frame_graph, path
from physically_based_renderer_tpu_torch.ops import (blocktrace, gather,
                                                     resident, texture,
                                                     trace_blocks)
from physically_based_renderer_tpu_torch.scene import procedural, types
from physically_based_renderer_tpu_torch.tools import timing
from physically_based_renderer_tpu_torch.utils import config, debug
from torch_parity import cuda_device  # noqa: F401

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
SIZE = 16
CAM = Camera.make(position=(0.0, 0.1, 3.0), target=(0.0, 0.0, 0.0),
                  fov_y=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**over):
    return path.RenderConfig(width=SIZE, height=SIZE, spp=2, max_bounces=2,
                             **over)


def _counters():
    return (frame_graph.GRAPH_CAPTURES, frame_graph.GRAPH_REPLAYS)


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("tracer", ["resident", "pallas"])
def test_graph_never_engages_on_the_cpu(tracer):
    """Two frames at one key on the CPU: both eager, bit-equal to the dense
    frame, no capture, no replay, nothing cached."""
    scene = (procedural.make_cornell_box() if tracer == "resident" else
             types.with_clusters(procedural.make_spd_tetra(2)))
    cfg = _cfg(tracer=tracer)
    key = rng.key(7)
    before, live = _counters(), dict(frame_graph._live)
    assert not frame_graph.applies(scene, cfg, path.tracer_name(scene, cfg))
    want, want_n = path._render_with_stats_dense(scene, CAM, key, cfg)
    for _ in range(2):
        film, n = path.render_with_stats(scene, CAM, key, cfg)
        assert torch.equal(film.hdr, want.hdr) and int(n) == int(want_n)
    assert _counters() == before and frame_graph._live == live


@pytest.mark.parametrize("tracer,exchange,checks,capturing,engaged", [
    ("pallas", None, False, False, True),
    ("resident", None, False, False, True),
    ("bvh", None, False, False, False),
    ("brute", None, False, False, False),
    ("block", None, False, False, False),
    ("pallas", "x", False, False, False),
    ("pallas", None, True, False, False),
    ("pallas", None, False, True, False)])
def test_applies_only_where_the_frame_is_capturable(monkeypatch, tracer,
                                                    exchange, checks,
                                                    capturing, engaged):
    """A CUDA scene (a stand-in whose device is the card): the graph
    engages on the resident and K1 tracers, with no ring exchange, no
    index checks recording and no capture under way."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    scene = pytypes.SimpleNamespace(device=torch.device("cuda", 0))
    cfg = _cfg(exchange_axis=exchange)
    if checks:
        with debug.index_checks():
            got = frame_graph.applies(scene, cfg, tracer)
    else:
        got = frame_graph.applies(scene, cfg, tracer)
    assert got is engaged


def test_frame_key_follows_the_scene_not_the_camera():
    """The key changes on an in-place edit of a scene tensor, on a scene
    with a replaced tensor and on other settings; a moved camera or a new
    key of the same layout keep it."""
    scene = types.with_clusters(procedural.make_spd_tetra(1))
    cfg = _cfg()
    key = rng.key(3)
    k0 = frame_graph.frame_key(scene, CAM, key, cfg)
    moved = Camera.make(position=(1.0, 0.5, 2.0), target=(0.1, 0.0, 0.0),
                        fov_y=0.8)
    assert frame_graph.frame_key(scene, moved, rng.key(4), cfg) == k0
    assert frame_graph.frame_key(scene, CAM, key,
                                 dataclasses.replace(cfg, spp=3)) != k0
    replaced = dataclasses.replace(scene, materials=dataclasses.replace(
        scene.materials,
        roughness_factor=scene.materials.roughness_factor.clone()))
    assert frame_graph.frame_key(replaced, CAM, key, cfg) != k0
    scene.materials.roughness_factor.mul_(0.5)
    k1 = frame_graph.frame_key(scene, CAM, key, cfg)
    assert k1 != k0
    scene.clusters.aabb_min.add_(0.0)          # any in-place write counts
    assert frame_graph.frame_key(scene, CAM, key, cfg) != k1


def test_frame_key_covers_every_scene_tensor():
    """Each tensor of the scene, nested records included (the cluster
    grid, the BVH, the env map, the textures), is in the key once."""
    scene = types.with_bvh(types.with_clusters(
        procedural.make_helmet_class_scene(6, 6)))
    want = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            want.append((obj.data_ptr(), obj._version))
        elif dataclasses.is_dataclass(obj):
            for f in dataclasses.fields(obj):
                walk(getattr(obj, f.name))

    walk(scene)
    ptrs = [p for p, _ in frame_graph.frame_key(scene, CAM, rng.key(0),
                                                _cfg())[2]]
    assert ptrs == [p for p, _ in want]
    for t in (scene.env.data, scene.bvh.node_min, scene.clusters.aabb_min,
              scene.textures.texels, scene.emitters.alias_prob):
        assert t.data_ptr() in ptrs


def test_device_constant_is_made_once_and_equals_the_literal():
    """`device_constant` gives the f32 tensor the call sites built per call
    (`torch.tensor([1, 0, 0])`, `new_tensor([0, 0, 1])`), once per values
    and device."""
    dev = torch.device("cpu")
    for values in ((1.0, 0.0, 0.0), (0.0, 0.0, 1.0)):
        got = math3d.device_constant(values, dev)
        want = torch.tensor(list(values), dtype=torch.float32)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert math3d.device_constant(values, dev) is got


@pytest.mark.parametrize("band", [(0, None), (3, 5)])
def test_morton_ids_on_the_device_equal_the_per_frame_copy(band):
    row_start, n_rows = band
    n_rows = SIZE if n_rows is None else n_rows
    dev = torch.device("cpu")
    got = morton_pixel_ids_on(SIZE, SIZE, row_start, n_rows, dev)
    want = torch.from_numpy(morton_pixel_ids(
        SIZE, SIZE, row_start, n_rows)).to(device=dev, dtype=torch.int64)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert morton_pixel_ids_on(SIZE, SIZE, row_start, n_rows, dev) is got
    tables = path.frame_tables(types.with_clusters(
        procedural.make_spd_tetra(1)), _cfg(tracer="pallas"), row_start,
        n_rows)
    assert tables.pix is got


def test_morton_ids_outlive_any_number_of_other_bands():
    """A captured frame reads the band's ids by address: rendering many
    other bands and sizes keeps the first tensor cached, not freed."""
    dev = torch.device("cpu")
    first = morton_pixel_ids_on(SIZE, SIZE, 0, SIZE, dev)
    for n in range(1, 41):
        morton_pixel_ids_on(SIZE + n, SIZE, n % 4, 1 + n % 5, dev)
    assert morton_pixel_ids_on(SIZE, SIZE, 0, SIZE, dev) is first


def test_meta_table_outlives_any_number_of_other_layouts():
    """As for the morton ids: the meta table of a layout stays cached
    whatever other texture layouts are seen after it."""
    def stack(n):
        return pytypes.SimpleNamespace(shapes=((4 + n, 4),), wrap=((0, 0),),
                                       filt=((1, 1, 0),))

    first = texture.meta_table(stack(0), "cpu")
    for n in range(1, 25):
        texture.meta_table(stack(n), "cpu")
    assert texture.meta_table(stack(0), "cpu") is first


def test_meta_table_is_made_once_a_layout_and_equals_texture_meta():
    """`meta_table` equals `texture_meta` as its readers copied it per
    call, and two stacks of one layout share it."""
    stack = procedural.make_helmet_class_scene(6, 6).textures
    got = texture.meta_table(stack, "cpu")
    want = torch.from_numpy(texture.texture_meta(stack))
    assert got.dtype == torch.float32 and torch.equal(got, want)
    twin = dataclasses.replace(stack, texels=stack.texels.clone())
    assert texture.meta_table(twin, torch.device("cpu")) is got
    assert not torch.equal(
        texture.meta_table(types.TextureStack.empty(), "cpu"), got[:1])


def _every_slot_scene():
    """The textured cornell box with its texture 0 as every material's
    normal and emissive map too, under a constant sky: each site of a
    shared constant (the GGX tangent, the normal map's default, the meta
    table of the attribute rows and of NEE's emissive texture)."""
    c = procedural.make_cornell_box(metallic_tall_block=True, roughness=0.3,
                                    textured=True)
    tex0 = torch.zeros_like(c.materials.base_color_tex)
    mats = dataclasses.replace(c.materials, normal_tex=tex0, emissive_tex=tex0)
    scene = types.make_scene(c.geometry, mats, c.textures,
                             env=types.EnvMap.constant((0.3, 0.3, 0.4)))
    assert scene.tex_slots == (True, True, True, True) and scene.has_emitters
    return scene


@pytest.mark.parametrize("tracer", ["resident", "pallas"])
def test_frame_with_shared_constants_equals_per_call_constants(monkeypatch,
                                                               tracer):
    """A frame through every site equals, bit for bit, the frame whose
    constants are made per call, as the integrator made them before."""
    scene = _every_slot_scene()
    if tracer == "pallas":
        scene = types.with_clusters(scene)
    cfg = _cfg(tracer=tracer)
    key = rng.key(5)
    got, n = path._render_with_stats_dense(scene, CAM, key, cfg)

    def fresh_meta(stack, device):
        return torch.from_numpy(texture.texture_meta(stack)).to(device)

    from physically_based_renderer_tpu_torch.integrator import shading
    from physically_based_renderer_tpu_torch.models import lights
    monkeypatch.setattr(shading, "meta_table", fresh_meta)
    monkeypatch.setattr(lights, "meta_table", fresh_meta)
    monkeypatch.setattr(math3d, "device_constant",
                        lambda v, d: torch.tensor(list(v), device=d))
    monkeypatch.setattr(path, "morton_pixel_ids_on",
                        lambda h, w, r, n_, d: torch.from_numpy(
                            morton_pixel_ids(h, w, r, n_)).to(
                                device=d, dtype=torch.int64))
    want, want_n = path._render_with_stats_dense(scene, CAM, key, cfg)
    assert torch.equal(got.hdr.view(torch.int32), want.hdr.view(torch.int32))
    assert int(n) == int(want_n) and float(got.hdr.abs().sum()) > 0.0


def test_replay_pct_reader_counts_replay_spans_in_the_stretch():
    """benchmark/metrics/frame.replay_pct.py: 100 x the `pbr.frame.replay`
    spans that start inside the traced stretch over its frames; 0 where
    its frames replayed none, so a graph that stops engaging reads as a
    drop; None with no stretch or no frame in it."""
    spec = importlib.util.spec_from_file_location(
        "frame_replay_pct", BENCH / "metrics" / "frame.replay_pct.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)

    def read(host_ops, units=4):
        stretch = pytypes.SimpleNamespace(units=units, host_ops=host_ops,
                                          t0=100, t1=200)
        return reader.read(pytypes.SimpleNamespace(stretch=stretch))

    replays = [("pbr.frame.replay", 110 + 20 * i, 120 + 20 * i)
               for i in range(4)]
    outside = [("pbr.frame.replay", 90, 105), ("pbr.frame.replay", 200, 210)]
    assert read(replays + outside + [("pbr.frame", 100, 199)]) == 100.0
    assert read(replays[:2]) == 50.0
    assert read([("pbr.frame", 100, 199)] + outside) == 0.0
    assert read([]) == 0.0
    assert read(replays, units=0) is None
    assert reader.read(pytypes.SimpleNamespace(stretch=None)) is None


# --------------------------------------------------------------------------
# The card
# --------------------------------------------------------------------------

CARD_SIZE = 128


def _card_case(name, dev):
    """(scene, camera, cfg) of a card case: spd_tetra (K1), cornell through
    the resident tracer (K2), the textured helmet_proc (K1, textures),
    spd_tetra with batch_spp at 2 spp (its film sums two samples a pixel,
    so their order cannot change a bit)."""
    bc = config.get({"spd_tetra": "spd_tetra", "resident": "cornell",
                     "helmet_proc": "helmet_proc",
                     "batch_spp": "spd_tetra"}[name])
    scene, cam = config.build_scene(bc.scene, dev)
    cfg = dataclasses.replace(bc.render, width=CARD_SIZE, height=CARD_SIZE,
                              spp=2, max_bounces=3)
    if name == "resident":
        cfg = dataclasses.replace(cfg, tracer="resident")
    if name == "batch_spp":
        cfg = dataclasses.replace(cfg, batch_spp=True)
    return scene, cam, cfg


def _bits(film, count):
    torch.cuda.synchronize()
    return film.hdr.view(torch.int32).cpu(), int(count)


def _same(a, b):
    return torch.equal(a[0], b[0]) and a[1] == b[1]


def _eager(scene, cam, key, cfg):
    with torch.no_grad():
        return _bits(*path._render_with_stats_dense(scene, cam, key, cfg))


CASES = ["spd_tetra", "resident", "helmet_proc", "batch_spp"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_replayed_frames_equal_eager_frames(cuda_device, case):
    """Four keys through render_with_stats (eager, capture and replay,
    replay, replay) against eager dense frames: bit for bit, one capture,
    three replays."""
    scene, cam, cfg = _card_case(case, cuda_device)
    assert frame_graph.applies(scene, cfg, path.tracer_name(scene, cfg))
    c0 = _counters()
    for i in range(4):
        key = rng.key(100 + i, cuda_device)
        got = _bits(*path.render_with_stats(scene, cam, key, cfg))
        assert _same(got, _eager(scene, cam, key, cfg)), f"frame {i}"
    assert tuple(b - a for a, b in zip(c0, _counters())) == (1, 3)


@pytest.mark.cuda
def test_moved_camera_replays_without_capture(cuda_device):
    scene, cam, cfg = _card_case("spd_tetra", cuda_device)
    key = rng.key(3, cuda_device)
    for _ in range(2):
        path.render_with_stats(scene, cam, key, cfg)
    c0 = _counters()
    moved = Camera.make(position=(2.0, 1.2, 3.3), target=(0.1, 0.0, 0.0),
                        fov_y=0.8, device=cuda_device)
    got = _bits(*path.render_with_stats(scene, moved, key, cfg))
    assert tuple(b - a for a, b in zip(c0, _counters())) == (0, 1)
    assert _same(got, _eager(scene, moved, key, cfg))
    assert not _same(got, _eager(scene, cam, key, cfg))


@pytest.mark.cuda
def test_in_place_edit_recaptures(cuda_device):
    """An in-place edit of a material: the next frame renders eagerly, the
    one after captures again; both are the edited scene's frames."""
    scene, cam, cfg = _card_case("spd_tetra", cuda_device)
    key = rng.key(4, cuda_device)
    for _ in range(2):
        path.render_with_stats(scene, cam, key, cfg)
    scene.materials.base_color_factor.mul_(0.5)
    c0 = _counters()
    want = _eager(scene, cam, key, cfg)
    got = [_bits(*path.render_with_stats(scene, cam, key, cfg))
           for _ in range(2)]
    assert tuple(b - a for a, b in zip(c0, _counters())) == (1, 1)
    assert _same(got[0], want) and _same(got[1], want)


@pytest.mark.cuda
def test_two_frames_held_at_once_do_not_alias(cuda_device):
    scene, cam, cfg = _card_case("spd_tetra", cuda_device)
    keys = [rng.key(20 + i, cuda_device) for i in range(4)]
    held = [path.render_with_stats(scene, cam, k, cfg) for k in keys]
    ptrs = {f.hdr.data_ptr() for f, _ in held} | {
        n.data_ptr() for _, n in held}
    assert len(ptrs) == 2 * len(held)
    for (film, n), k in zip(held, keys):
        assert _same(_bits(film, n), _eager(scene, cam, k, cfg))


# Launch counter of the port -> the part of its kernels' names.
KERNEL_COUNTERS = {(trace_blocks, "LAUNCHES"): "trace_blocks_kernel",
                   (blocktrace, "PHASE_A_LAUNCHES"): "phase_a_",
                   (rng, "LAUNCHES"): "threefry_",
                   (gather, "LAUNCHES_FWD"): "gather_fwd_kernel",
                   (resident, "LAUNCHES"): "resident_kernel"}


def _counts():
    return {part: getattr(m, a) for (m, a), part in KERNEL_COUNTERS.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spd_tetra", "resident"])
def test_replay_launches_the_eager_frames_kernels(cuda_device, case):
    """An eager frame's launch counters against the kernels a replay runs,
    counted by name in a profiler trace of it: the same number of each.
    A replay calls no wrapper, so the counters stay where they were."""
    scene, cam, cfg = _card_case(case, cuda_device)
    key = rng.key(6, cuda_device)
    before = _counts()
    with torch.no_grad():
        path._render_with_stats_dense(scene, cam, key, cfg)
    torch.cuda.synchronize()
    eager = {p: n - before[p] for p, n in _counts().items()}
    assert any(eager.values())
    for _ in range(2):                         # eager, then the capture
        path.render_with_stats(scene, cam, key, cfg)
    before = _counts()
    for attempt in range(3):       # the tracer may drop a short kernel
        seen = timing.kernel_launches(
            lambda: path.render_with_stats(scene, cam, key, cfg),
            tuple(eager))
        if seen == eager:
            break
    assert seen == eager
    assert _counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_eager_dense_frame_makes_no_host_sync(cuda_device, case):
    """After one warm frame (which makes the constants), an eager dense
    frame runs under torch.cuda.set_sync_debug_mode("error")."""
    scene, cam, cfg = _card_case(case, cuda_device)
    key = rng.key(8, cuda_device)
    _eager(scene, cam, key, cfg)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.no_grad():
            film, n = path._render_with_stats_dense(scene, cam, key, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(film.hdr.cpu().numpy()).all() and int(n) > 0
