"""The dense frame as one CUDA graph (`path.render_with_stats`, its dense
branch).

A dense frame on the card is thousands of small kernels, each launched by
the host: at 512x512 x 4 spp x 4 bounces some 13,000, whose launches take
the host several times the card's own time.  The frame's shape is fixed:
every bounce runs all lanes under masks, the hand-written kernels check
their limits on shapes, take their inputs by pointer and launch on the
current stream, and no operator of the frame reads the card's data on the
host or copies from it.  So the frame's kernels are recorded once as a CUDA
graph and replayed with one launch: the same kernels in the same order on
the same inputs, so the same film and ray count bit for bit.

When (`applies`): a CUDA scene whose tracer is the resident tracer (K2) or
the block tracer through K1 ("pallas"), no ring exchange, no index checks
recording (utils/debug.py) and no capture under way.  The BVH walk reads
its live count on the host, and brute force and the XLA block tracer copy
constants from it: their frames stay eager.

Cache: one graph a device, valid for one `frame_key`: the render settings,
the scene object, the (data_ptr, version) of each of its tensors, and the
layout of the camera's tensors and of the key.  The first frame under a
key renders eagerly, so a one-shot render pays for no capture; the second
captures and replays; later ones replay.  A new key drops the old graph
and its memory pool.  Before each replay the camera's six tensors and the
key are copied into the graph's static inputs, so a moving camera replays
without a capture; the film and the ray count are copied out, so a
caller's tensors are not overwritten by the next replay.  A capture that
fails raises.

The graph holds the addresses of what the frame reads: the scene's
tensors (the cache holds the scene) and the constants made once outside
any frame (`math3d.device_constant`, `morton.morton_pixel_ids_on`,
`texture.meta_table`), whose caches never evict, so a live graph's
tables are never freed and reused.

Counters: `GRAPH_CAPTURES`, `GRAPH_REPLAYS`.  The kernels' own launch
counters (`trace_blocks.LAUNCHES` and the like) count their wrappers'
calls on the host: a capture's calls count once, and a replay calls no
wrapper and leaves them as they are, so a replay's kernels are counted
by name in a profiler trace.  Spans: `pbr.frame.capture`, and
`pbr.frame.replay` around the input copies, the replay and the output
copies.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.camera import Camera
from ..core.film import Film
from ..utils import debug
from ..utils.profiling import span

GRAPH_CAPTURES = 0
GRAPH_REPLAYS = 0

# The tracers whose calls are hand-written kernels with no host sync.
TRACERS = ("resident", "pallas")


@dataclasses.dataclass
class _Graph:
    """A device's cached frame: eager until its second frame captures."""

    key: tuple                        # frame_key
    scene: object                     # held: the graph reads its tensors
    graph: torch.cuda.CUDAGraph | None = None
    camera: Camera | None = None      # static inputs
    rng_key: torch.Tensor | None = None
    film: Film | None = None          # static outputs
    count: torch.Tensor | None = None


_live: dict = {}                      # device -> _Graph


def applies(scene, cfg, tracer: str) -> bool:
    """True where `render` takes the dense frame of `render_with_stats`
    (module docstring); `tracer` is the frame's (path.tracer_name)."""
    return (scene.device.type == "cuda" and tracer in TRACERS
            and cfg.exchange_axis is None and not debug.recording()
            and not torch.cuda.is_current_stream_capturing())


def _tensors(obj):
    """Every tensor of a record of tensors, nested records included, in
    field order."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _layout(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


def frame_key(scene, camera: Camera, key: torch.Tensor, cfg) -> tuple:
    """What a captured frame holds for: cfg, the scene object, each scene
    tensor's storage and version (an in-place edit or a new tensor changes
    it), and the layouts of the camera's tensors and the key (their values
    are the graph's inputs)."""
    return (cfg, id(scene),
            tuple((t.data_ptr(), t._version) for t in _tensors(scene)),
            tuple(_layout(t) for t in _tensors(camera)), _layout(key))


def render(frame, scene, camera: Camera, key: torch.Tensor, cfg):
    """`frame(scene, camera, key, cfg)` -> (Film, int64 count): eager the
    first time under its frame_key, then captured once and replayed."""
    dev = scene.device
    fk = frame_key(scene, camera, key, cfg)
    g = _live.get(dev)
    if g is None or g.key != fk:
        _live[dev] = _Graph(fk, scene)    # the old graph and its pool go
        return frame(scene, camera, key, cfg)
    if g.graph is None:
        with span("pbr.frame.capture"):
            _capture(g, frame, camera, key, cfg)
    with span("pbr.frame.replay"):
        return _replay(g, camera, key)


def _capture(g: _Graph, frame, camera: Camera, key: torch.Tensor,
             cfg) -> None:
    global GRAPH_CAPTURES
    dev = g.scene.device
    g.camera = Camera(**{f.name: getattr(camera, f.name).detach().to(
        dev).clone() for f in dataclasses.fields(Camera)})
    g.rng_key = key.detach().to(dev).clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g.film, g.count = frame(g.scene, g.camera, g.rng_key, cfg)
    g.graph = graph
    GRAPH_CAPTURES += 1


def _replay(g: _Graph, camera: Camera, key: torch.Tensor):
    global GRAPH_REPLAYS
    for f in dataclasses.fields(Camera):
        getattr(g.camera, f.name).copy_(getattr(camera, f.name))
    g.rng_key.copy_(key)
    g.graph.replay()
    GRAPH_REPLAYS += 1
    return Film(hdr=g.film.hdr.clone(), spp=g.film.spp), g.count.clone()
