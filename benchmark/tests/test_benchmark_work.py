"""The frozen work counters equal the originals they were copied from
(chip_smoke.py's K1 counters, the port's tools/work.py) on small inputs."""

import dataclasses

import pytest
import torch

import chip_smoke
from physically_based_renderer_tpu_torch.core import rng as port_rng
from physically_based_renderer_tpu_torch.ops import fused as port_fused
from physically_based_renderer_tpu_torch.tools import work as port_work
from physically_based_renderer_tpu_torch.utils import config as port_config
from reference.pbr_plain.ops import blocktrace, trace_blocks
from reference.pbr_plain.scene import procedural, types
from work import counts, k1


@pytest.fixture(scope="module")
def grid_scene():
    torch.manual_seed(0)
    scene = types.with_clusters(procedural.make_helmet_class_scene(
        rings=40, sectors=40))
    return scene


def _rays(n, seed):
    g = torch.Generator().manual_seed(seed)
    o = torch.randn(n, 3, generator=g) * 0.2 + torch.tensor([0.0, 0.0, 3.0])
    d = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g) * 0.3 + torch.tensor([0.0, 0.0, -1.0]),
        dim=-1)
    t_max = torch.rand(n, generator=g) * 4.0
    return o, d, t_max


@pytest.mark.parametrize("block,max_u,chunk", [(64, 16, 4), (32, 8, 2)])
def test_k1_counters_equal_the_originals(grid_scene, block, max_u, chunk):
    grid = grid_scene.clusters
    o, d, t_max = _rays(700, block)
    for t_lim in (1e30, t_max):
        args, _ = blocktrace.block_inputs(grid, o, d, 1e-3, t_lim, block,
                                          max_u, True, chunk)
        best = trace_blocks.trace_blocks_plain(*args, t_min=1e-3,
                                               any_hit=False, chunk=chunk)
        assert k1.k1_work(args, *best, chunk, grid.tri_id) == \
            chip_smoke.k1_work(args, *best, chunk, grid.tri_id)
        assert k1.k1_any_work(args, 1e-3, chunk, grid.tri_id) == \
            chip_smoke.k1_any_work(args, 1e-3, chunk, grid.tri_id)


def test_fused_and_resident_counters_equal_the_originals():
    bc = port_config.get("cornell")
    scene, cam = port_config.build_scene(bc.scene, "cpu")
    cfg = dataclasses.replace(bc.render, width=12, height=10, spp=1)
    key = port_rng.key(3)
    frame = port_fused.fused_frame(scene, cam, key, cfg)
    assert counts.fused_work(frame) == port_work.fused_work(frame)
    soup = torch.cat([v.detach() for v in (
        lambda v: (v[0], v[1] - v[0], v[2] - v[0]))(
            scene.geometry.tri_vertices())], dim=1).contiguous()
    o, d, t_max = _rays(300, 7)
    o = o * 0.0 + torch.tensor([0.0, 1.0, 3.9])
    for any_hit in (False, True):
        assert counts.resident_work(soup, o, d, t_max, 1e-3, any_hit) == \
            port_work.resident_work(soup, o, d, t_max, 1e-3, any_hit)
