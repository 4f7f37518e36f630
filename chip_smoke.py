#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card.  Phases, each
of which raises on failure (an uncaught exception exits non-zero):

  0. device check: no CUDA -> exit 1; print the card's name and power limit;
  1. build the CUDA kernels from physically_based_renderer_tpu_torch/csrc/,
     and the native builders from native/bvh_builder.cpp with g++
     (accel/native.py, into build/torch_native/); fail if they do not load;
  2. K2 (resident tracer) against its plain-torch version on the card:
     Cornell soup with 512x512 camera rays and random interior rays, closest
     and any-hit, t_min 0 and 1e-3, per-ray t_max; dead lanes (t_max 0,
     NaN, equal to t_min, negative) among live ones; a 1e19 triangle inside
     a group, whose |det| reaches 2^126 on some rays (the group's division
     fallback), at an odd ray count; 1, 1,001 and a ragged number of rays;
     one triangle, and a random 2048-triangle soup (dynamic shared memory
     above 48 KB); the camera closest-hit call timed beside its bound; then
     every K2 call of one dense cornell frame (512x512, 4 spp, 4 bounces,
     logged by tools/work.py), each held to its plain version, and each
     (kind, bounce) timed on its own calls beside the bound from the work
     its data needs: the frame's device ms, bound and launches x (time -
     bound);
  3. K3 (tonemap) against its plain-torch version: a 512x512 HDR image with
     negatives, zeros and values above 100, and a ragged 37x53 image;
  3b. threefry (csrc/threefry.cu, core/rng.py) against its plain-torch
     version on the card, bit for bit: ray_keys and ray_uniform at m = 5
     over 262,144 lanes and the K4 seed words, one launch a call; one K4
     cornell frame at its config's size makes exactly one; each call's
     device and wrapper times beside its byte bound, its integer
     operations' time and the plain version's, and the seed words with
     their copy to the host on the host clock;
  4. the branch-free reciprocal of K1, K2 and K4 (csrc/rcp.cuh) against
     1.0f / x on every float with |x| in [1e-9, 2^126); the registers and
     spill bytes of K1's, K2's, K4's, K5a's, K5b's, P1's, P5's and P6's
     instantiations (cuobjdump -res-usage); K1 (block-stream tracer)
     against its plain-torch version on
     `helmet_proc` (100,352 triangles, 1,024 clusters, ray blocks of 256)
     and on `helmet` (the 99,400-triangle .glb, ray blocks of 512): 512x512
     morton camera rays, direction-sorted surface bounce rays, env shadow
     rays (any hit, root-culled t_max), on `helmet` also shadow rays toward
     its 15,600 emissive triangles, and a ragged ray count, through phase A
     as the integrator calls it; device and wrapper times, bound, tests a
     second and the ratio to the bound of the camera closest-hit call and
     the env and emitter shadow any-hit calls at 262,144 rays (any-hit
     work replayed by k1_any_work), and the plain version's time of the
     camera call; on `helmet`, K5a on the emitter table (15,600 x 20)
     against its plain version, and the time to author, write and ingest
     the asset; K1 once more on `helmet_proc` at chunk=16 (2 x 72 KB of
     shared memory a block, the opt-in branch), each timed call held to
     the chunk=4 run's work and bound (the same rays need no more work),
     with the tests its coarser exit adds counted apart;
  5. K4 (fused whole-frame kernel) against its plain-torch version on the
     same packed tables: `cornell` and `cornell_ggx` at their full configs
     (512x512, 4 spp, 4 bounces), `triangle` at its full config (256x256,
     4 spp, 1 bounce) and a ragged 24x20 cornell frame, images and ray
     counts; kernel and plain times of the cornell and cornell_ggx frames
     beside the bound from the ray-triangle tests their data needs
     (tools/work.py) and the lane use of the closest-hit loop;
  6. the main paths at full size, launch counts reset just before each:
     the render CLI on `cornell` and on `cornell_ggx`, which K4 renders
     (1 K4, 1 K3, no tracer kernel); the dense cornell path,
     `render_with_stats` with tracer="resident" (36 K2); the render CLI on
     `helmet_proc` (28 K1, 1 K3) and on `helmet` (40 K1, 184 K5a, 1 K3);
     then a small .glb (the helmet at scale_tris=0.02) rendered by path
     through the CLI and held against brute force on the same file, a
     truncated copy that must return 2, and `apps/report helmet --render`;
     6c. the BVH walk, the XLA block tracer and batch_spp at 512x512,
     launch counts reset just before each: `helmet` built without its
     cluster grid and with its BVH, so that tracer "auto" takes the BVH
     walk (1 spp, 3 bounces; 46 K5a), held to the render agreement at the
     same key: its camera frame (no bounce) against the K1 route, the
     whole frame on BVH_EXACT_BAND's rows against the brute-force tracer;
     the whole frame against the K1 route is printed only (the pixels that
     differ are phase A's truncation against an exact tracer); one walk
     over the camera rays under torch.profiler gives launches and device
     busy time a lockstep step; `helmet_proc`
     through the XLA block tracer (tracer="block", 1 spp, 3 bounces; 24
     K5a) against the K1 route (film mean within MEAN_REL, equal ray
     counts); the dense cornell path with batch_spp (tracer="resident", 4
     spp, 4 bounces, all samples one ray stream: 9 K2, 9 K5a) against the
     sample loop (PIXEL_FRAC of the pixels within tolerance: only the order
     of the film sums differs; equal ray counts);
 14. (after 6c) the modules ported last, each main-path run with the counts
     reset just before it: `--blinn-phong` through the CLI on `cornell`
     and `helmet` at 512x512 (frame s, the run's peak device memory, K3
     and K5a launches; helmet's hit triangles against K1's camera closest
     hit on the same pixel-centre rays, MAX_MISMATCH_FRAC and T_REL;
     cornell against the plain path on the CPU; both against the
     reference's goldens tests/data/cornell_bp_64_golden.npy and
     helmet_bp_32_golden.npy); `cornell --debug-checks` through the CLI at
     512x512 x 4 spp x 4 bounces beside the same render unchecked (the
     ratio is the checks' cost; the images bit-equal), then at 8x8 a NaN
     base colour and an out-of-range material id raising, and
     `--debug-checks` beside `--tiles 2` or `--blinn-phong` returning 2;
     `helmet_proc` (512x512 x 1 spp) on a cluster grid without a packed
     soup through K1 (7 launches) against the packed grid (equal pixels
     and ray counts); the native builders (built in phase 1) against the
     numpy builders on helmet's mesh, bit for bit, both timed; one K4
     cornell frame and its K3 under utils/profiling.device_trace, whose
     Chrome trace must name both kernels;
 15. (after 14) the k = 32 sub-cluster route: `helmet` built with
     SceneSpec.cluster_k = 32 (4,096 sub-clusters; set-up seconds), its
     frame through render_with_stats at the config's size (512x512, 4 spp,
     3 bounces; 40 K1 + 184 K5a, counts reset just before it) cold and
     warm, beside the K = 128 frame and the BVH walk at the same key
     (pixels that differ, film means, ray counts: printed, not held); K1
     at K = 32 on the camera closest-hit, env shadow and emitter shadow
     calls of 262,144 rays (and a bounce closest-hit call), equal to its
     plain version on every winner, t and mask, each timed beside its
     work-counted bound, and the same calls on the same rays through the
     K = 128 grid; then `helmet_proc` at K = 32 with chunk 16 and max_u 96
     (tools/prof_k32.py's settings) through phase 4's K1 checks, every
     winner equal;
 16. (after 15) cluster grids without parent boxes, as the reference
     allows (phase A's flat top-k over all C clusters): `helmet` at K =
     128 (1,024 clusters) and k = 32 (4,096), parents set to None; on
     phase 15's 262,144 camera rays phase A's selection flat beside
     hierarchical (CUDA events; candidates a block, blocks whose lists
     differ); K1 on the flat lists of the camera closest-hit, env shadow
     and emitter shadow calls, equal to its plain version on every winner,
     t and mask, timed beside its work-counted bound and phase 15's K1 on
     the parented lists; one `helmet` frame at K = 128 without parents
     (40 K1 + 184 K5a, counts reset just before it) beside the parented
     frame at the same key (pixels that differ, ray counts: printed, not
     held); then tools/dryrun.py::entry() cold and warm (5 K2 + 5 K5a
     each), its image against tests/data/entry_cornell_64_golden.npy;
     16c. phase A's kernels (csrc/phase_a.cu) on the tracer calls of one
     `spd_tetra` frame (512x512, 1 spp, 4 bounces): the camera call (1
     launch) and the first two sorted calls (3 launches each), each bit
     for bit the plain version (`block_inputs_plain`), timed: the kernels'
     device ms (torch.profiler), the wrapper back to back (CUDA events),
     the host's enqueue a call, the plain version, beside the bound from
     the bytes a call must move; then the host syncs of a whole frame
     (512x512 x 4 spp) under torch's sync debug mode ("warn"), and its
     seconds, with the kernels and with the plain phase A, and the
     launches of the frame with the kernels (36 K1, 4 x 1 + 32 x 3 = 100
     phase A; the kernels line's `spd_tetra` path);
  7. renders on the card against the committed reference goldens: 64x64
     cornell on the dense path (tests/data/cornell_64_golden.npy), 32x32
     helmet_proc (tests/data/helmet_proc_32_golden.npy), 64x64
     cornell_ggx through K4 (tests/data/cornell_ggx_fused_64_golden.npy,
     the reference's fused kernel in interpret mode), 32x32 helmet
     (tests/data/helmet_32_golden.npy);
  8. K5a (row gather) and K5b (its backward scatter-add) against their
     plain versions: tables T in {2, 32, 2048, 100352} x W in {1, 20, 86}
     plus the texture-quad and env-quad tables of helmet_proc, N = 262,144
     and a ragged 1,000,003, indices -1 and T among them, int32 and int64,
     and skewed cases where every ray picks one row; forward bit-equal,
     backward within K5B_REL * max|plain|; kernel, plain and library
     (index_select, index_add_) times at cornell's shape (262,144 rays x 86
     columns from 32 rows, random indices, and every row on one index);
     then K5a at every distinct (T, W, N) that a helmet frame and a dense
     cornell frame gather, logged from the frames and timed on their own
     tensors, with index_select beside it; and K5b at every (T, W, N) of
     one gradient step's render() backward (tri_attrs [32, 86] and the
     emitter table [2, 20]), on the step's own indices and cotangents,
     each call held to its plain version, with index_add_ beside it;
  9. the gradient path: (a) render() + pixel_loss gradients against the
     reference's (tests/data/cornell_grad_64_golden.npz) with exact K5a/K5b
     counts; (b) the inverse CLI at the cornell config's full size (512x512,
     4 spp, 4 bounces, four material fields, 3 steps), seconds per warm
     step, peak memory and exact K2/K5a/K5b launches per step; (c) the CLI
     at its defaults (64x64, 2 spp, 2 bounces, base colour + emission): 20
     steps with a checkpoint at step 20, then a --resume run from step 20 to
     40 that must lower every field's error (of the clamped values the
     scene renders); (d) one full-size gradient
     step under torch.profiler: device busy time, idle share and launches;
 10. the probes P1-P4 (`ops/probes.py`, `csrc/probes.cu`) against their
     plain versions at every shape of the probe tool (exact), with device,
     wrapper, plain and library times and bounds; P1 also on trees of
     5,001 (pass rates 1.0 and 0.9) and 8,191 nodes, each timed beside an
     empty kernel's device time and its byte and depth bounds; P3 also on
     rows with +-0.0, inf, -inf and NaN (NaN for NaN, the rest bit for
     bit), its byte bound beside the empty kernel and the product's
     operations bound; P4 also on -0.0 and indices outside the axis (bit
     for bit), each shape timed with its route, byte bound and
     torch.gather's device time, beside the card's random-sector read
     ceiling (2,097,152 reads at random rows of an 8 MiB table, the
     addresses precomputed); then the probe tool itself
     (`tools/probe2.py all`), whose launches the kernels line reports;
 11. one `helmet` frame and one `helmet_proc` frame under torch.profiler:
     launches, device idle share and K1's and K5a's shares of the device
     time;
 12. the probes P5-P8 (`ops/probes.py`, `csrc/mosaic.cu`) against their
     plain versions at every shape of their tools (bit for bit; P8 also
     the reference's own check), with device, wrapper and plain times and
     bounds; P7 on the probe's, random and edge data (dets about +-1e-9, at
     and above 2^126, inf and NaN), each beside an empty kernel; P8 on
     both routes (each tile's rows summed once, the route rule's at the
     tool's shape; the direct route, the parent's kernel) beside the
     every-copy read ceiling under the direct route (`subtile_read`) and
     the yardstick src.sum(1) then embedding_bag; P5 also on random
     floats with indices in [-3 size, 3 size), at reps 0 and 1, where no
     slab fits shared memory and at rows and lanes that are not multiples
     of 4, each shape with
     its plan and the L2 bytes the plan moves, and at reps 1 beside
     torch.gather (the kernels line's P5 entry: one call, [1024,512] axis
     0 x1); P6 also at 8,191 nodes, beside an empty kernel and the depth
     and byte bounds of its inner nodes; then the tools themselves
     (`tools/probe_mosaic.py`, `tools/exp_subtile_dma.py`), whose launches
     the kernels line reports;
 13. parallel/ on a world of one NCCL rank (a FileStore in a temporary
     directory): `render_sharded` of `helmet` (512x512, 4 spp, 3 bounces;
     its launches counted as a main path), `render_sharded_2d` on a 1x1
     mesh, the ring render (one sample) and, without the direction sort,
     four row bands of 128 rows equal to render() bit for bit (with the
     sort, the pixels that differ are counted and the film mean held to
     0.5%: a block's candidate list depends on its rays); the NCCL broadcast,
     all-gather and all-reduces run over the one rank, the ring's send and
     receive do not (the shift is the identity at one rank);
     plain and sharded frames in turns (the sharded program's cost; one
     card, so scaling over GPUs is not measured); the sharded cornell step
     (512x512, 4 spp, 4 bounces, four fields) against the plain one: loss
     bit-equal, gradients within K5B_REL of max|g| (K5b's atomics), its
     launches counted; `--tiles 1` through the render CLI (equal to
     render() bit for bit) and the inverse CLI; the group is destroyed at
     the end.  Last, so that NCCL's threads start after the profiled
     phases.

Prints, before the last line, the card, one JSON line with the kernels
({"kernels": [...]}: `launches` is the sum over the main-path runs,
`launches_by_path` the count of each run, `ms` the kernel's own device
time per launch (torch.profiler), `wrapper_ms` the time per call of its
Python wrapper back to back (CUDA events: host dispatch, checks and
allocation included), `plain_ms` and `library_ms` the time per call of the
plain version and of one PyTorch call computing the same function where
there is one (CUDA events), `bound_ms` the least time the card could take
for the timed call, from the bytes it must move at 3.35 TB/s and the float
operations these inputs need at 33.5e12 per second) and one JSON line with
the measurements; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "data" / "cornell_64_golden.npy"
HELMET_GOLDEN = ROOT / "tests" / "data" / "helmet_proc_32_golden.npy"
HELMET_GLB_GOLDEN = ROOT / "tests" / "data" / "helmet_32_golden.npy"
FUSED_GOLDEN = ROOT / "tests" / "data" / "cornell_ggx_fused_64_golden.npy"
GRAD_GOLDEN = ROOT / "tests" / "data" / "cornell_grad_64_golden.npz"
ENTRY_GOLDEN = ROOT / "tests" / "data" / "entry_cornell_64_golden.npy"

# Full-size film means: the CPU port renders cornell at 0.1577-0.1596 on
# the dense path and 0.15309 / 0.15847 through K4's plain version (64x64 /
# 128x128, 4 spp, 4 bounces), cornell_ggx at 0.13906 / 0.14392 through K4's
# plain version, and helmet_proc at 0.63066 / 0.63147 (4 spp, 3 bounces),
# so a 512x512 frame lies well inside these bands.  helmet: its mean falls
# with the image size on the CPU port, as the ray cones narrow and the
# texture fetches move to sharper mip levels of the normal and roughness maps
# (0.7037 at 16x16 x 1 spp, 0.6885 at 32x32 x 2 spp, where the reference
# gives the same image; at 4 spp 0.6242 at 64x64, 0.5800 at 96x96, 0.5676 at
# 128x128, 0.5641 at 192x192), so the band is wide.
FILM_MEAN_BAND = {"cornell": (0.14, 0.18), "cornell_ggx": (0.12, 0.17),
                  "cornell_dense": (0.14, 0.18), "helmet_proc": (0.60, 0.66),
                  "helmet": (0.50, 0.62)}
# The main paths: (label, config, how it is driven: the render CLI, or
# render_with_stats with the named tracer).
MAIN_PATHS = (("cornell", "cornell", "cli"),
              ("cornell_ggx", "cornell_ggx", "cli"),
              ("cornell_dense", "cornell", "resident"),
              ("helmet_proc", "helmet_proc", "cli"),
              ("helmet", "helmet", "cli"))
# Launches per frame.  cornell and cornell_ggx: one K4 launch renders the
# frame.  cornell_dense: 4 spp x (5 closest + 4 shadow) K2 queries and no
# tonemap (it does not go through the CLI).  helmet_proc: no area emitter
# and no directional light, so 4 spp x (4 closest + 3 env shadow) K1
# queries; one K3 for each CLI run.
# K5a (gather_fwd): cornell_dense 4 spp x (5 tri_attrs rows + 4 emitter
# rows); helmet_proc 4 spp x 4 bounces x (1 tri_attrs + 2 texture slots x 2
# trilinear levels + 1 env lookup) = 96.  No K5b on a forward path.
# helmet: area emitters and a sky, so one shadow trace per light family:
# 4 spp x (4 closest + 3 bounces x 2 shadow) = 40 K1 at ray blocks of 512;
# K5a 4 spp x (4 shades x (1 tri_attrs + 4 texture slots x 2 trilinear
# levels + 1 env lookup) + 3 NEE passes x (1 emitter row + 1 emissive
# texel fetch at level 0)) = 184; K4 refuses its normal and emissive maps.
# Phase A (csrc/phase_a.cu) before each K1 call: 1 launch for a sample's
# camera rays, 3 for each direction-sorted bounce or shadow call, so
# helmet_proc 4 x 1 + 24 x 3 = 76 and helmet 4 x 1 + 36 x 3 = 112.
EXPECTED_LAUNCHES = {
    "cornell": {"fused": 1, "resident": 0, "trace_blocks": 0, "tonemap": 1,
                "gather_fwd": 0, "gather_bwd": 0, "phase_a": 0},
    "cornell_ggx": {"fused": 1, "resident": 0, "trace_blocks": 0,
                    "tonemap": 1, "gather_fwd": 0, "gather_bwd": 0,
                    "phase_a": 0},
    "cornell_dense": {"fused": 0, "resident": 36, "trace_blocks": 0,
                      "tonemap": 0, "gather_fwd": 36, "gather_bwd": 0,
                      "phase_a": 0},
    "helmet_proc": {"fused": 0, "resident": 0, "trace_blocks": 28,
                    "tonemap": 1, "gather_fwd": 96, "gather_bwd": 0,
                    "phase_a": 76},
    "helmet": {"fused": 0, "resident": 0, "trace_blocks": 40,
               "tonemap": 1, "gather_fwd": 184, "gather_bwd": 0,
               "phase_a": 112},
}
# The routes of phase 6c: launches of each run.  bvh: helmet at 1 spp x 3
# bounces, K5a as a quarter of its CLI frame's 184; block: helmet_proc at
# 1 spp, a quarter of 96; batch_spp: the dense cornell frame's 36 K2 and
# 36 K5a in one stream of the four samples, 9 each.
ROUTE_LAUNCHES = {
    "bvh": {"fused": 0, "resident": 0, "trace_blocks": 0, "tonemap": 0,
            "gather_fwd": 46, "gather_bwd": 0, "phase_a": 0},
    "block": {"fused": 0, "resident": 0, "trace_blocks": 0, "tonemap": 0,
              "gather_fwd": 24, "gather_bwd": 0, "phase_a": 0},
    "batch_spp": {"fused": 0, "resident": 9, "trace_blocks": 0, "tonemap": 0,
                  "gather_fwd": 9, "gather_bwd": 0, "phase_a": 0},
}
# Phase 14's Blinn-Phong frames through the CLI: K5a gathers one tri_attrs
# row a pixel, plus a level-0 fetch for each texture slot the scene uses
# (none on cornell, four on helmet); one K3 tonemaps the frame.  The checked
# cornell frame (--debug-checks) renders the dense path with the tracer
# pinned to brute force: 4 spp x (5 tri_attrs rows + 4 emitter rows) K5a
# and one K3.  The soup-less helmet_proc grid at 1 spp: 4 closest + 3 env
# shadow K1 calls, 1 + 6 x 3 phase A launches, and a quarter of the
# frame's 96 K5a.
MODULE_SIZE = 512
MODULE_LAUNCHES = {
    "blinn_phong_cornell": {"fused": 0, "resident": 0, "trace_blocks": 0,
                            "tonemap": 1, "gather_fwd": 1, "gather_bwd": 0,
                            "phase_a": 0},
    "blinn_phong_helmet": {"fused": 0, "resident": 0, "trace_blocks": 0,
                           "tonemap": 1, "gather_fwd": 5, "gather_bwd": 0,
                           "phase_a": 0},
    "debug_checks_cornell": {"fused": 0, "resident": 0, "trace_blocks": 0,
                             "tonemap": 1, "gather_fwd": 36,
                             "gather_bwd": 0, "phase_a": 0},
    "soupless_helmet_proc": {"fused": 0, "resident": 0, "trace_blocks": 7,
                             "tonemap": 0, "gather_fwd": 24,
                             "gather_bwd": 0, "phase_a": 19},
}
# Phase 15's helmet frame on a k = 32 grid through render_with_stats (no
# CLI, so no K3): the helmet CLI frame's 40 K1, 112 phase A and 184 K5a.
K32_LAUNCHES = {"fused": 0, "resident": 0, "trace_blocks": 40, "tonemap": 0,
                "gather_fwd": 184, "gather_bwd": 0, "phase_a": 112}
# Phase 16's helmet frame at K = 128 without parent boxes, through
# render_with_stats: the same 40 K1, 112 phase A and 184 K5a.  entry(): one sample of
# the dense cornell path at 2 bounces, 3 closest + 2 shadow K2 queries and
# 3 tri_attrs + 2 emitter rows of K5a.
PARENTLESS_LAUNCHES = K32_LAUNCHES
ENTRY_LAUNCHES = {"fused": 0, "resident": 5, "trace_blocks": 0, "tonemap": 0,
                  "gather_fwd": 5, "gather_bwd": 0, "phase_a": 0}
# Phase 16c's spd_tetra frame (512x512 x 4 spp x 4 bounces, 8 clusters):
# 4 x (5 closest + 4 env shadow) K1 calls, phase A 4 x 1 + 32 x 3.
SPD_TETRA_K1, SPD_TETRA_PHASE_A = 36, 100
# The bvh frame at 1 spp x 3 bounces is held per pixel to the exact
# brute-force tracer on this band of rows (first row, rows) at the same
# key: brute force over the whole frame would take minutes.  Against the
# K1 route it is only measured: phase A truncates the bounce rays'
# candidates there.
BVH_EXACT_BAND = (224, 64)
# The goldens: (label, config, file, (size, spp, bounces), how it is
# driven, as in MAIN_PATHS).
GOLDENS = (("cornell", "cornell", GOLDEN, (64, 2, 2), "resident"),
           ("helmet_proc", "helmet_proc", HELMET_GOLDEN, (32, 1, 2), "cli"),
           ("cornell_ggx_fused", "cornell_ggx", FUSED_GOLDEN, (64, 2, 2),
            "cli"),
           ("helmet", "helmet", HELMET_GLB_GOLDEN, (32, 2, 3), "cli"))
# Render agreement (same as tests/test_torch_render.py): a pixel agrees
# within atol + rtol*|ref|; at least PIXEL_FRAC of pixels must agree.
ATOL, RTOL, PIXEL_FRAC, MEAN_REL = 1e-4, 1e-3, 0.99, 5e-3
# K4 against its plain version: the same render agreement, and ray counts
# within COUNT_REL (paths may branch apart after a one-ulp difference of
# sin/cos).
COUNT_REL = 5e-3
# Kernel tolerances: K1 and K2 winners may differ only on exact ties
# between triangles that share an edge (at most MAX_MISMATCH_FRAC of the
# rays), with t within T_REL there; where the winners agree, t is equal
# (both kernels are built with -fmad=false); K3 within K3_ATOL.
MAX_MISMATCH_FRAC, T_REL, K3_ATOL = 1e-4, 1e-5, 1e-5
BIG = 1e30
# K5b against its plain version: both sum cotangent rows with atomics in an
# order that changes from run to run, so the last bits differ; held to
# K5B_REL * max|plain| (the dyadic cotangents of the coverage cases sum
# exactly in any order, so there they agree exactly).
K5B_REL = 1e-5
GATHER_TABLES = tuple((t, w) for t in (2, 32, 2048, 100_352)
                      for w in (1, 20, 86)) + ((174_762, 16), (8192, 12),
                                               (15_600, 20))
GATHER_NS = (262_144, 1_000_003)
# Gradients on the card against the reference's (the golden): per case the
# trained fields, the element-wise tolerance relative to max|g_ref|, and the
# K5a/K5b launches of one 64x64 x 2 spp x 2 bounce render and its backward.
# cornell: 2 spp x (3 tri_attrs + 2 emitter) rows, all of them trained;
# cornell_ggx (texels only): 2 spp x 3 shades x 2 texture slots more, and
# only the texture gathers of the 2 bounces that sample the BSDF reach the
# loss (the last shade uses only the untextured emission), so 2 x 2 x 2
# K5b.  Both are held to 1e-3 of max|g_ref| on the card (cornell_ggx's
# texel gradient is ill-conditioned, make_torch_golden.py; measured 5.3e-5
# here, 7.3e-4 for the CPU port, whose test allows 2e-3).
GRAD_SIZE, GRAD_SPP, GRAD_BOUNCES = 64, 2, 2
GRAD_CASES = {
    "cornell": (dict(base_color=True, roughness=True, metallic=True,
                     emissive=True), 1e-3, (10, 10)),
    "cornell_ggx": (dict(textures=True), 1e-3, (22, 8)),
}
# The full-size inverse CLI (phase 9b): the cornell config's size, the four
# material fields; launches per render = spp x (bounces + 1 closest hits +
# bounces shadow rays) for K2 and K5a alike, and per step as many K5b (every
# gathered table is trained).
GRAD_CLI = dict(size=512, spp=4, bounces=4, target_spp=16, steps=3)
# The card's peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, and float32
# instructions/s outside the tensor cores.  The data sheet's 67 TFLOP/s
# counts a fused multiply-add as two operations; the kernels are built with
# -fmad=false, so every add and multiply is an instruction of its own, at
# half that rate (132 SMs x 128 lanes x 1.98 GHz = 33.5e12 per second).
PEAK_BYTES_PER_S, PEAK_F32_OPS_PER_S = 3.35e12, 33.5e12
# Float adds, multiplies and divides of one Moller-Trumbore ray-triangle
# test as the kernels write it (p = d x e2: 9, det: 5, 1/det: 1, s = o - v0:
# 3, u: 6, q = s x e1: 9, v: 6, t: 6, u + v: 1); compares and the
# reciprocal's refinement are not counted, so the bound stays low.
MT_FLOPS = 46
# P1 and P6 are chains of dependent shared-memory loads, which neither peak
# describes: beside the contract's bound each gets a latency bound, their
# level-parallel search's one shared-memory load per level of the tree,
# taken as 30 cycles at the card's 1.98 GHz boost clock (15.2 ns).
SMEM_LOAD_CYCLES, SM_CLOCK_HZ = 30, 1.98e9
# The small .glb of the by-path run: the helmet at this tessellation scale
# (1,880 triangles), at the CLI's default RenderConfig (256x256, 4 spp, 1
# bounce).
SMALL_GLB_SCALE = 0.02


def phase_modules(dev, counters, tmp):
    """Phase 14: the modules ported last.  --blinn-phong through the CLI on
    cornell and helmet at 512x512 (frame s, peak memory, launches; helmet's
    hit triangles against K1's camera closest hit on the same pixel-centre
    rays, cornell against the plain path on the CPU, both against the
    reference's goldens); --debug-checks on cornell at the config's size
    beside the same render unchecked, and its failures at a small size on
    the card; a cluster grid without a packed soup through K1; the native
    builders against the numpy ones on helmet; a K4 frame under
    utils/profiling.device_trace.  Each main-path run has the counts reset
    just before it."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.accel import bvh as bvh_mod
    from physically_based_renderer_tpu_torch.accel import clusters
    from physically_based_renderer_tpu_torch.accel import native
    from physically_based_renderer_tpu_torch.apps import render
    from physically_based_renderer_tpu_torch.core import morton
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.core.camera import (
        Camera, generate_rays_flat)
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.models import blinn_phong
    from physically_based_renderer_tpu_torch.ops import blocktrace, tonemap
    from physically_based_renderer_tpu_torch.ops.intersect import (
        intersect_brute)
    from physically_based_renderer_tpu_torch.scene import procedural, types
    from physically_based_renderer_tpu_torch.utils import (config, debug,
                                                           profiling)

    def reset():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    def counts():
        return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}

    def cli(label, argv):
        """The render CLI with --stats: (HDR image, stats, launches, peak
        device bytes), the counts and the peak reset just before it."""
        png, npy = Path(tmp) / f"{label}.png", Path(tmp) / f"{label}.npy"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset()
        stats = run_cli(argv + ["-o", str(png), "--hdr-output", str(npy),
                                "--stats", "--device", "cuda"])
        got = counts()
        # The run's own peak, above what was allocated before it.
        peak = torch.cuda.max_memory_allocated(dev) - base
        if png.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
            raise AssertionError(f"{label}: the CLI wrote no PNG")
        img = np.load(npy)
        if not np.isfinite(img).all():
            raise AssertionError(f"{label}: the frame is not finite")
        return img, stats, got, peak

    def held(label, img, ref):
        frac, n_bad = render_agreement(img, ref)
        mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
        print(f"{label}: {n_bad} of {img.shape[0] * img.shape[1]} pixels "
              f"differ, mean rel {mean_rel:.3g}")
        if frac < PIXEL_FRAC or mean_rel > MEAN_REL:
            raise AssertionError(f"{label} disagrees")
        return {"pixel_frac": frac, "pixels_differ": n_bad,
                "mean_rel": mean_rel}

    out, runs = {}, {}
    data = ROOT / "tests" / "data"
    goldens = {"cornell": (data / "cornell_bp_64_golden.npy", 64),
               "helmet": (data / "helmet_bp_32_golden.npy", 32)}
    for name in ("cornell", "helmet"):
        label = f"blinn_phong_{name}"
        img, stats, got, peak = cli(label, [name, "--blinn-phong", "--width",
                                            str(MODULE_SIZE), "--height",
                                            str(MODULE_SIZE)])
        if img.shape != (MODULE_SIZE, MODULE_SIZE, 3) or stats[
                "rays"] != MODULE_SIZE ** 2:
            raise AssertionError(f"{label}: {img.shape}, {stats['rays']} rays")
        if got != MODULE_LAUNCHES[label]:
            raise AssertionError(f"{label} launches {got}, expected "
                                 f"{MODULE_LAUNCHES[label]}")
        print(f"{label} {MODULE_SIZE}x{MODULE_SIZE}: "
              f"{stats['seconds']:.3f} s, peak device "
              f"memory {peak / 2**30:.3f} GiB, brute-force chunk "
              f"{blinn_phong.brute_chunk(MODULE_SIZE ** 2)} triangles, "
              f"launches {got} [{card_line()}]")
        bc = config.get(name)
        runs[label] = {"seconds": stats["seconds"], "peak_bytes": peak,
                       "film_mean": float(img.mean()), "launches": got,
                       "chunk": blinn_phong.brute_chunk(MODULE_SIZE ** 2)}
        path_g, size = goldens[name]
        gimg, _, _, _ = cli(f"{label}_golden", [
            name, "--blinn-phong", "--width", str(size), "--height",
            str(size)])
        runs[label]["golden"] = held(f"{label} golden {size}x{size}", gimg,
                                     np.load(path_g))
        if name == "cornell":
            scene, cam = config.build_scene(bc.scene)
            t0 = time.perf_counter()
            ref = blinn_phong.render_blinn_phong(scene, cam, MODULE_SIZE,
                                                 MODULE_SIZE).numpy()
            runs[label]["cpu_plain_s"] = time.perf_counter() - t0
            runs[label]["cpu_plain"] = held(f"{label} against the CPU", img,
                                            ref)
            continue
        # helmet: the frame's hit triangles against K1's camera closest hit
        # on the same pixel-centre rays, in morton order as the frame's.
        scene, cam = config.build_scene(bc.scene, dev)
        o, d = generate_rays_flat(cam, MODULE_SIZE, MODULE_SIZE)
        pix = torch.from_numpy(morton.morton_pixel_ids(
            MODULE_SIZE, MODULE_SIZE)).to(dev).long()
        with torch.no_grad():
            t0 = time.perf_counter()
            v0, v1, v2 = scene.geometry.tri_vertices()
            hb = intersect_brute(o, d, v0, v1, v2, t_min=0.0,
                                 chunk=blinn_phong.brute_chunk(o.shape[0]))
            torch.cuda.synchronize()
            brute_s = time.perf_counter() - t0
            hk = blocktrace.intersect_blocks_pallas(
                scene.clusters, o[pix].contiguous(), d[pix].contiguous(),
                t_min=0.0, block=bc.render.block_size,
                max_u=bc.render.max_u, chunk=bc.render.chunk)
        tri_k = torch.empty_like(hk.tri)
        tri_k[pix] = hk.tri
        t_k = torch.empty_like(hk.t)
        t_k[pix] = hk.t
        diff = tri_k != hb.tri
        n_diff = int(diff.sum())
        both = (tri_k >= 0) & (hb.tri >= 0)
        rel = (t_k - hb.t).abs() / hb.t.abs().clamp_min(1e-30)
        # Where the winners differ (shared-edge ties) t must agree; where
        # they agree t is only printed: the brute-force tracer is torch
        # ops, K1 a kernel of its own rounding (-fmad=false, rcp_rn).
        tie_rel = float(rel[both & diff].max()) if bool(
            (both & diff).any()) else 0.0
        same_rel = float(rel[both & ~diff].max())
        print(f"{label}: brute-force camera hits {brute_s:.3f} s; "
              f"{int((hb.tri >= 0).sum())} of {o.shape[0]} rays hit, "
              f"{n_diff} hit triangles differ from K1's (t rel there "
              f"{tie_rel:.3g}); t rel where they agree {same_rel:.3g} "
              f"[{card_line()}]")
        if (n_diff > MAX_MISMATCH_FRAC * o.shape[0] or tie_rel > T_REL
                or bool((diff & ~both).any())):
            raise AssertionError(f"{label}: hits disagree with K1's")
        runs[label]["k1_hits"] = {"rays": o.shape[0], "tri_differ": n_diff,
                                  "tie_t_rel": tie_rel,
                                  "same_t_rel": same_rel,
                                  "brute_s": brute_s}
        del scene, hb, hk
    out.update(runs)

    # --debug-checks on cornell at the config's size, beside the same
    # render with the checks off (the brute-force tracer, as it pins).
    label = "debug_checks_cornell"
    img, stats, got, _ = cli(label, ["cornell", "--debug-checks", "--width",
                                     str(MODULE_SIZE), "--height",
                                     str(MODULE_SIZE)])
    if got != MODULE_LAUNCHES[label]:
        raise AssertionError(f"{label} launches {got}, expected "
                             f"{MODULE_LAUNCHES[label]}")
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, dev)
    cfg = dataclasses.replace(bc.render, tracer="brute", width=MODULE_SIZE,
                              height=MODULE_SIZE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        plain = path.render(scene, cam, rng_mod.key(0, dev), cfg).mean()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    equal = bool(np.array_equal(img, plain.cpu().numpy()))
    print(f"{label} {MODULE_SIZE}x{MODULE_SIZE} x {cfg.spp} spp x "
          f"{cfg.max_bounces} bounces: "
          f"{stats['seconds']:.3f} s checked, {plain_s:.3f} s "
          f"unchecked ({stats['seconds'] / plain_s:.3f}x), image equal "
          f"{equal}, launches {got} [{card_line()}]")
    if not equal:
        raise AssertionError("the checked render differs from render()")
    out[label] = {"seconds": stats["seconds"], "unchecked_s": plain_s,
                  "ratio": stats["seconds"] / plain_s, "launches": got}

    # Its failures, at 8x8 on the card.
    small = procedural.make_triangle_scene()
    g, m = small.geometry, small.materials
    bad_mat = dataclasses.replace(small, geometry=dataclasses.replace(
        g, tri_material=torch.full_like(g.tri_material, 7)))
    nan = dataclasses.replace(small, materials=dataclasses.replace(
        m, base_color_factor=torch.full_like(m.base_color_factor,
                                             float("nan"))))
    cam8 = Camera.make(position=(0.0, 0.0, 2.5), target=(0.0, 0.0, 0.0),
                       fov_y=0.8, device=dev)
    cfg8 = path.RenderConfig(width=8, height=8, spp=1, max_bounces=1)
    key = rng_mod.key(0, dev)
    failures = {}
    for case, sc, exc in (("material_ids", bad_mat, debug.IndexCheckError),
                          ("nan", nan, debug.NonFiniteRenderError)):
        try:
            debug.checked_render(types.upload_scene(sc, dev), cam8, key,
                                 cfg8)
        except exc as e:
            failures[case] = str(e)
        else:
            raise AssertionError(f"checked_render let {case} through")
    if "material ids" not in failures["material_ids"]:
        raise AssertionError(f"the index error names no site: {failures}")
    debug.checked_render(types.upload_scene(small, dev), cam8, key, cfg8)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rcs = [render.main(["triangle", "--debug-checks", *extra, "-o",
                            str(Path(tmp) / "never.png")])
               for extra in (["--tiles", "2"], ["--blinn-phong"])]
    if rcs != [2, 2] or (Path(tmp) / "never.png").exists():
        raise AssertionError(f"--debug-checks with --tiles/--blinn-phong "
                             f"returned {rcs}")
    print(f"debug checks on the card: {failures}; --tiles 2 and "
          f"--blinn-phong beside --debug-checks return {rcs}")
    out["debug_failures"] = failures

    # A cluster grid without a packed soup: K1 on a soup packed at trace
    # time, against the packed grid at the same key.
    bc = config.get("helmet_proc")
    cfg = dataclasses.replace(bc.render, spp=1, width=MODULE_SIZE,
                              height=MODULE_SIZE)
    scene, cam = config.build_scene(bc.scene, dev)
    gm = scene.geometry
    grid = clusters.build_clusters(gm.positions.cpu().numpy(),
                                   gm.indices.cpu().numpy())
    bare = dataclasses.replace(scene, clusters=types.upload_scene(grid, dev))
    label = "soupless_helmet_proc"
    res = {}
    for which, sc in ((label, bare), ("packed", scene)):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film, count = path.render_with_stats(sc, cam, rng_mod.key(0, dev),
                                             cfg)
        img = film.mean().cpu().numpy()
        res[which] = (img, int(count), time.perf_counter() - t0, counts())
    img, count, secs, got = res[label]
    ref, ref_count, ref_s, _ = res["packed"]
    if got != MODULE_LAUNCHES[label]:
        raise AssertionError(f"{label} launches {got}, expected "
                             f"{MODULE_LAUNCHES[label]}")
    n_bad = int((img != ref).any(-1).sum())
    print(f"{label} {MODULE_SIZE}x{MODULE_SIZE} x 1 spp: {secs:.3f} s "
          f"({ref_s:.3f} s packed), "
          f"{count} ray queries ({ref_count}), {n_bad} pixels differ, "
          f"launches {got} [{card_line()}]")
    if n_bad or count != ref_count:
        raise AssertionError("the soup-less grid renders differently")
    out[label] = {"seconds": secs, "packed_s": ref_s, "rays": count,
                  "launches": got}
    del scene, bare

    # The native builders on helmet's mesh against the numpy builders.
    if not native.available():
        raise AssertionError(f"native library: {native.BUILD_ERROR}")
    scene, _ = config.build_scene(config.get("helmet").scene)
    pos = scene.geometry.positions.numpy()
    idx = scene.geometry.indices.numpy()
    times = {}
    for what, fns, fields in (
            ("bvh", (bvh_mod.build_bvh, native.build_bvh_native),
             ("node_min", "node_max", "node_left", "node_right",
              "tri_order")),
            ("clusters", (clusters.build_clusters,
                          native.build_clusters_native),
             ("aabb_min", "aabb_max", "tri_id", "parent_min",
              "parent_max"))):
        built = []
        for who, fn in zip(("numpy", "native"), fns):
            t0 = time.perf_counter()
            with profiling.timed(f"helmet {what}, {who} builder"):
                built.append(fn(pos, idx))
            times[f"{what}_{who}_s"] = time.perf_counter() - t0
        for f in fields:
            a, b = (np.asarray(getattr(x, f)) for x in built)
            if a.tobytes() != b.tobytes():
                raise AssertionError(f"native {what}.{f} differs")
    print(f"native builders on helmet ({len(idx)} triangles), bit-equal: "
          f"BVH {times['bvh_numpy_s']:.3f} s numpy, "
          f"{times['bvh_native_s']:.4f} s native; cluster grid "
          f"{times['clusters_numpy_s']:.3f} s numpy, "
          f"{times['clusters_native_s']:.4f} s native (the card's host) "
          f"[{card_line()}]")
    out["native"] = {**times, "build_s": native.BUILD_SECONDS}

    # One K4 cornell frame and its K3 tonemap under device_trace.
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, dev)
    path.render_with_stats(scene, cam, rng_mod.key(0, dev), bc.render)
    logdir = Path(tmp) / "trace"
    with profiling.device_trace(logdir):
        film, _ = path.render_with_stats(scene, cam, rng_mod.key(0, dev),
                                         bc.render)
        tonemap.tonemap(film.mean().contiguous())
    trace = json.loads((logdir / "trace.json").read_text())
    kernels = sorted({e.get("name", "") for e in trace["traceEvents"]
                      if e.get("cat") == "kernel"})
    named = {k: any(k in n for n in kernels)
             for k in ("fused_kernel", "tonemap_kernel")}
    print(f"device_trace of a K4 cornell frame: {len(kernels)} kernel "
          f"names, {named}")
    if not all(named.values()):
        raise AssertionError(f"the trace misses a kernel: {kernels[:20]}")
    out["device_trace"] = {"kernel_names": len(kernels), **named}
    return out


@functools.lru_cache(maxsize=None)
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(n_bytes: float, n_flops: float):
    """(bound_ms, bound_by): the larger of moving n_bytes at the card's HBM
    rate and doing n_flops single float operations at its float32 rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_work(args, best_t, best_flat, chunk: int, tri_id):
    """The work one closest-hit K1 call needs on these inputs: (ray-triangle
    tests, distinct clusters read).  The block's early exit is replayed from
    the call's own t and winners: a block cannot stop before the chunk of
    its last winner, and from that chunk on its state is final, so it stops
    at the first chunk j at or after it whose next entry distance is at
    least max over live lanes of min(t, t_max).  Only live lanes (t_max > 0)
    test, and only real triangles of the clusters in the chunks a block
    visits count (padding and the sentinel are left out).  The chunk is
    K1's (`chunk_width`: at K = 32 a multiple of 4)."""
    import torch

    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    u_idx, _, _, tm, soup, n_valid, entry = args
    dev = tm.device
    n_u, k = u_idx.shape[1], soup.shape[-1]
    ch = tb.chunk_width(chunk, n_u, k)
    w, nct = ch * k, n_u // ch
    live = tm > 0.0
    win_chunk = torch.where(live & (best_flat >= 0), best_flat // w,
                            -1).amax(dim=1)
    worst = torch.where(live, torch.minimum(best_t, tm), 0.0).amax(dim=1)
    j = torch.arange(nct, device=dev)
    nxt = torch.where((j[None] + 1) * ch < n_valid[:, None],
                      entry[:, torch.clamp_max(j + 1, nct - 1) * ch], BIG)
    stop = (j[None] >= win_chunk[:, None]) & (worst[:, None] <= nxt)
    first = torch.where(stop, j[None], nct).amin(dim=1)
    visited = torch.minimum(first + 1, (n_valid.long() + ch - 1) // ch)
    if bool((visited <= win_chunk).any()):
        raise AssertionError("K1 replay: a block stops before its winner")
    run = torch.arange(n_u, device=dev)[None] < visited[:, None] * ch
    n_clusters = tri_id.shape[0]
    real = torch.cat([(tri_id >= 0).sum(dim=1),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    tris = torch.where(run, real[u_idx.long()], 0).sum(dim=1)
    tests = int((tris * live.sum(dim=1)).sum())
    read = u_idx[run & (u_idx < n_clusters)]
    return tests, int(torch.unique(read).numel())


def k1_any_work(args, t_min: float, chunk: int, tri_id):
    """The least work one any-hit K1 call needs on these inputs: (ray-
    triangle tests, distinct clusters read).  The chunk of each ray's first
    hit comes from the plain version with n_valid capped at j + 1 chunks
    (the capped call runs chunks 0..j exactly as the full one does); the
    block's early exit is then replayed from it: a block stops after chunk
    j once no live lane is open or the next entry lies beyond every open
    lane's t_max.  A live lane tests the real triangles of each visited
    chunk before its first hit, and at least one test in that chunk (where
    in the chunk it stops is not counted, so the bound stays low)."""
    import torch

    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    u_idx, _, _, tm, soup, n_valid, entry = args
    dev = tm.device
    n_u = u_idx.shape[1]
    ch = tb.chunk_width(chunk, n_u, soup.shape[-1])
    nct = n_u // ch
    live = tm > 0.0
    first = torch.full(tm.shape, nct, dtype=torch.int64, device=dev)
    for j in reversed(range(nct)):
        capped = torch.clamp_max(n_valid, (j + 1) * ch).contiguous()
        occ = tb.trace_blocks_plain(*args[:5], capped, args[6], t_min=t_min,
                                    any_hit=True, chunk=chunk)
        first = torch.where(occ, j, first)
    j = torch.arange(nct, device=dev)
    open_after = live[..., None] & (first[..., None] > j)       # [NB, B, J]
    rem_tmax = torch.where(open_after, tm[..., None], 0.0).amax(dim=1)
    nxt = torch.where((j[None] + 1) * ch < n_valid[:, None],
                      entry[:, torch.clamp_max(j + 1, nct - 1) * ch], BIG)
    stop = ~open_after.any(dim=1) | (nxt > rem_tmax)
    visited = torch.minimum(torch.where(stop, j[None], nct).amin(dim=1) + 1,
                            (n_valid.long() + ch - 1) // ch)
    n_clusters = tri_id.shape[0]
    real = torch.cat([(tri_id >= 0).sum(dim=1),
                      torch.zeros(1, dtype=torch.int64, device=dev)])
    per_chunk = real[u_idx.long()].reshape(-1, nct, ch).sum(dim=2)
    cum = torch.cat([torch.zeros_like(per_chunk[:, :1]),
                     per_chunk.cumsum(dim=1)], dim=1)          # [NB, J + 1]
    upto = torch.minimum(first, visited[:, None])
    full = torch.gather(cum, 1, upto)
    tests = int(torch.where(live, full + (first < visited[:, None]).long(),
                            0).sum())
    run = torch.arange(n_u, device=dev)[None] < visited[:, None] * ch
    read = u_idx[run & (u_idx < n_clusters)]
    return tests, int(torch.unique(read).numel())


def k1_call_stats(args, t_min: float, any_hit: bool, chunk: int, tri_id):
    """One K1 call on these inputs: device ms (torch.profiler), wrapper ms
    (CUDA events), the ray-triangle tests its data needs (k1_work,
    k1_any_work), the distinct clusters it reads and its bound.  Bytes: o,
    d, t_max in and the results out per lane, the candidate lists and
    entries, the soup of the distinct clusters read, once."""
    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    call = functools.partial(tb.trace_blocks, *args, t_min=t_min,
                             any_hit=any_hit, chunk=chunk)
    ms, _ = device_ms(call, 50, "trace_blocks_kernel")
    wrapper_ms = time_ms(call, 50)
    if any_hit:
        tests, n_clusters = k1_any_work(args, t_min, chunk, tri_id)
    else:
        tests, n_clusters = k1_work(args, *call(), chunk, tri_id)
    u_idx, o_b, _, _, soup_b, n_valid, _ = args
    nb, blk = o_b.shape[0], o_b.shape[1]
    bnd = bound(nb * blk * (12 + 12 + 4 + (1 if any_hit else 8))
                + u_idx.numel() * 8 + nb * 4
                + n_clusters * soup_b[0].numel() * 4, tests * MT_FLOPS)
    return {"ms": ms, "wrapper_ms": wrapper_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "tests": tests, "clusters_read": n_clusters,
            "lanes": nb * blk, "block": blk,
            "chunk": tb.chunk_width(chunk, u_idx.shape[1], soup_b.shape[-1]),
            "candidates": u_idx.shape[1], "tests_per_s": tests / (ms * 1e-3),
            "ratio_to_bound": ms / bnd[0]}


class TraceStats:
    """Agreement of a tracer kernel with its plain version, and its bound
    at the timed shape."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.bound = None
        self.wrapper_ms = None
        self.work = None
        self.rays = 0
        self.mismatch = 0
        self.max_abs_err = 0.0
        self.frame = None

    def closest(self, label, kern, plain):
        import torch
        (tk, ik), (tp, ip) = kern, plain
        diff = ik != ip
        n_diff = int(diff.sum())
        if n_diff:
            rel = ((tk[diff] - tp[diff]).abs()
                   / tp[diff].abs().clamp_min(1e-30)).max().item()
            if rel > T_REL:
                raise AssertionError(f"{self.kernel} {label}: {n_diff} winners "
                                     f"differ with t rel diff {rel:.3g}")
        if n_diff > MAX_MISMATCH_FRAC * ik.numel():
            raise AssertionError(f"{self.kernel} {label}: {n_diff}/"
                                 f"{ik.numel()} winners differ")
        hit = (ik >= 0) & (ip >= 0)
        if bool(((ik < 0) != (ip < 0)).any()):
            raise AssertionError(f"{self.kernel} {label}: hit/miss disagrees")
        same = hit & (ik == ip)
        err = ((tk[same] - tp[same]).abs().max().item() if bool(same.any())
               else 0.0)
        if not torch.equal(tk[same], tp[same]):
            raise AssertionError(f"{self.kernel} {label}: hit distances "
                                 "differ where the winners agree "
                                 f"(max |dt| {err:.3g})")
        if not torch.equal(tk[~hit], tp[~hit]):
            raise AssertionError(f"{self.kernel} {label}: miss distances "
                                 "differ")
        self.rays += ik.numel()
        self.mismatch += n_diff
        self.max_abs_err = max(self.max_abs_err, err)
        print(f"{self.kernel} {label}: {ik.numel()} rays, {int(hit.sum())} "
              f"hits, {n_diff} winner mismatches, max |dt| {err:.3g}")

    def any_hit(self, label, kern, plain):
        n_diff = int((kern != plain).sum())
        if n_diff:
            raise AssertionError(f"{self.kernel} {label}: {n_diff} any-hit "
                                 "masks differ")
        self.rays += kern.numel()
        print(f"{self.kernel} {label}: {kern.numel()} rays, "
              f"{int(kern.sum())} occluded, masks equal")


def random_soup(n_tris: int, rng):
    import numpy as np
    centers = rng.uniform(-1.0, 1.0, (n_tris, 3)).astype(np.float32)
    offs = rng.normal(0.0, 0.1, (n_tris, 3, 3)).astype(np.float32)
    v = centers[:, None, :] + offs
    return np.concatenate([v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]],
                          axis=1).astype(np.float32)


def random_rays(n: int, rng, lo, hi):
    import numpy as np
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def phase_k2(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.core.camera import Camera
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import resident
    from physically_based_renderer_tpu_torch.scene.procedural import (
        make_cornell_box)
    from physically_based_renderer_tpu_torch.scene.types import upload_scene
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    st = TraceStats("K2")
    rng = np.random.default_rng(0)
    scene = upload_scene(make_cornell_box(), dev)
    soup = resident.pack_resident_soup(scene.geometry)

    # 512x512 jittered camera rays of the cornell config.
    w = h = 512
    cam = Camera.make(position=(0.0, 1.0, 3.9), target=(0.0, 1.0, 0.0),
                      fov_y=0.95, device=dev)
    pix = torch.arange(w * h, device=dev)
    keys = rng_mod.ray_keys(rng_mod.key(0, dev), pix)
    o_cam, d_cam, _ = path.camera_rays(
        scene, cam, path.RenderConfig(width=w, height=h), pix, keys)
    o_cam = o_cam.contiguous()
    # Bounce-like rays: origins inside the box, directions uniform.
    o_np, d_np = random_rays(w * h, rng, (-0.99, 0.01, -0.99),
                             (0.99, 1.99, 0.99))
    o_bnc, d_bnc = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)

    def both(soup, o, d, tm, t_min, any_hit):
        k = resident.trace(soup, o, d, tm, t_min, any_hit)
        p = resident.trace_plain(soup, o, d, tm, t_min, any_hit)
        torch.cuda.synchronize()
        return k, p

    for name, o, d in (("camera", o_cam, d_cam), ("bounce", o_bnc, d_bnc)):
        n = o.shape[0]
        big = torch.full((n,), BIG, device=dev)
        rand_tm = torch.from_numpy(
            rng.uniform(0.05, 4.0, n).astype(np.float32)).to(dev)
        for t_min in (0.0, 1e-3):
            st.closest(f"cornell {name} closest t_min={t_min}",
                       *both(soup, o, d, big, t_min, False))
            st.closest(f"cornell {name} closest t_min={t_min} random t_max",
                       *both(soup, o, d, rand_tm, t_min, False))
            st.any_hit(f"cornell {name} any-hit t_min={t_min}",
                       *both(soup, o, d, rand_tm, t_min, True))
    # Ragged ray count (not a multiple of the block size).
    nr = w * h - 77
    o_r, d_r = o_bnc[:nr].contiguous(), d_bnc[:nr].contiguous()
    tm_r = torch.from_numpy(rng.uniform(0.05, 4.0, nr).astype(np.float32)).to(dev)
    st.closest("cornell ragged closest", *both(soup, o_r, d_r, tm_r, 1e-3, False))
    st.any_hit("cornell ragged any-hit",
               *both(soup, o_r, d_r, tm_r, 1e-3, True))

    # Dead lanes among live ones: t_max 0, NaN, equal to t_min, negative
    # (the kernel answers them without a test, the plain version by its
    # tests).
    n = w * h
    tm = torch.from_numpy(rng.uniform(0.05, 4.0, n).astype(np.float32))
    pick = torch.from_numpy(rng.integers(0, 5, n))
    for code, value in ((1, 0.0), (2, float("nan")), (3, 1e-3), (4, -1.0)):
        tm[pick == code] = value
    tm = tm.to(dev)
    for name, o, d in (("camera", o_cam, d_cam), ("bounce", o_bnc, d_bnc)):
        st.closest(f"cornell {name} closest dead lanes",
                   *both(soup, o, d, tm, 1e-3, False))
        st.any_hit(f"cornell {name} any-hit dead lanes",
                   *both(soup, o, d, tm, 1e-3, True))
    # A triangle with edges of 1e19 inside a group (index 13 of 33): |det|
    # reaches 2^126 on the rays nearly normal to it, where the group runs
    # again with the division.
    huge = torch.tensor([[-1.0, -1.0, -0.5, 1e19, 0.0, 0.0, 0.0, 1e19, 0.0]],
                        device=dev)
    soup_h = torch.cat([soup[:13], huge, soup[13:]]).contiguous()
    n_h = 262_143                      # odd: the last thread has one ray
    det = (torch.linalg.cross(d_bnc[:n_h], huge[:, 6:9].expand(n_h, 3))
           * huge[:, 3:6]).sum(dim=1)
    n_out = int((det.abs() >= 2.0 ** 126).sum())
    if not 0 < n_out < n_h:
        raise AssertionError(f"K2 huge triangle: {n_out} of {n_h} rays have "
                             "|det| >= 2^126")
    o_h, d_h = o_bnc[:n_h].contiguous(), d_bnc[:n_h].contiguous()
    tm_h = torch.from_numpy(rng.uniform(0.05, 4.0, n_h).astype(
        np.float32)).to(dev)
    k, p = both(soup_h, o_h, d_h, torch.full((n_h,), BIG, device=dev), 1e-3,
                False)
    st.closest(f"cornell + a 1e19 triangle closest ({n_out} rays with "
               f"|det| >= 2^126, {int((p[1] == 13).sum())} hit it)", k, p)
    st.any_hit("cornell + a 1e19 triangle any-hit",
               *both(soup_h, o_h, d_h, tm_h, 1e-3, True))
    # Odd and tiny ray counts; one triangle.
    for nr in (1, 1001):
        st.closest(f"cornell {nr} rays closest",
                   *both(soup, o_h[:nr].contiguous(), d_h[:nr].contiguous(),
                         tm_h[:nr].contiguous(), 1e-3, False))
        st.any_hit(f"cornell {nr} rays any-hit",
                   *both(soup, o_h[:nr].contiguous(), d_h[:nr].contiguous(),
                         tm_h[:nr].contiguous(), 1e-3, True))
    soup_1 = soup[4:5].contiguous()
    st.closest("one triangle closest",
               *both(soup_1, o_bnc, d_bnc, torch.full((n,), BIG, device=dev),
                     1e-3, False))
    st.any_hit("one triangle any-hit",
               *both(soup_1, o_bnc, d_bnc, rand_tm, 1e-3, True))

    # Random 2048-triangle soup: 96 KB of dynamic shared memory per block.
    soup_r = torch.from_numpy(
        random_soup(resident.RESIDENT_MAX_TRIS, rng)).to(dev)
    nr = 100_003
    o_np, d_np = random_rays(nr, rng, -1.2, 1.2)
    o_r, d_r = torch.from_numpy(o_np).to(dev), torch.from_numpy(d_np).to(dev)
    tm_r = torch.from_numpy(rng.uniform(0.05, 3.0, nr).astype(np.float32)).to(dev)
    big = torch.full((nr,), BIG, device=dev)
    st.closest("random2048 closest", *both(soup_r, o_r, d_r, big, 0.0, False))
    st.closest("random2048 closest random t_max",
               *both(soup_r, o_r, d_r, tm_r, 1e-3, False))
    st.any_hit("random2048 any-hit",
               *both(soup_r, o_r, d_r, tm_r, 1e-3, True))

    # Time at the main path's shape: 262,144 camera rays x 32 triangles.
    big = torch.full((w * h,), BIG, device=dev)
    call = lambda: resident.trace(soup, o_cam, d_cam, big, 0.0, False)
    ms, _ = device_ms(call, 50, "resident_kernel")
    st.wrapper_ms = time_ms(call, 50)
    plain_ms = time_ms(
        lambda: resident.trace_plain(soup, o_cam, d_cam, big, 0.0, False), 10)
    # Every ray tests every triangle (no early exit for the closest hit):
    # o, d, t_max in and t, tri out per ray, the soup once.
    n, n_tris = w * h, soup.shape[0]
    st.bound = bound(n * (12 + 12 + 4 + 4 + 4) + soup.numel() * 4,
                     n * n_tris * MT_FLOPS)
    st.frame = k2_frame(dev, st)
    return st, ms, plain_ms


def k2_frame(dev, st):
    """K2 on the calls of one dense cornell frame (512x512, 4 spp, 4
    bounces; tools/work.py::dense_frame_calls), each held to its plain
    version; then the device time of each (kind, bounce) over its calls in
    turn, beside the bound from the work its data needs
    (tools/work.py::resident_work: a lane with t_max not above t_min tests
    nothing and reads only its t_max; a closest-hit lane tests every
    triangle; an any-hit lane up to its first occluder).  The frame's
    totals: device ms, bound and launches x (time - bound)."""
    import itertools

    import torch

    from physically_based_renderer_tpu_torch.ops import resident
    from physically_based_renderer_tpu_torch.tools import work
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    groups = {}
    for sample, bounce, call in work.dense_frame_calls(dev):
        any_hit = call[5]
        kern, plain = resident.trace(*call), resident.trace_plain(*call)
        torch.cuda.synchronize()
        kind = "any-hit" if any_hit else "closest"
        label = f"frame {kind} sample {sample} bounce {bounce}"
        (st.any_hit if any_hit else st.closest)(label, kern, plain)
        groups.setdefault((kind, bounce), []).append(call)
    if sum(map(len, groups.values())) != EXPECTED_LAUNCHES[
            "cornell_dense"]["resident"]:
        raise AssertionError(f"K2 frame calls: {groups.keys()}")
    rows = []
    for (kind, bounce), group in sorted(groups.items()):
        turn = itertools.cycle(group)
        ms, _ = device_ms(lambda: resident.trace(*next(turn)),
                          25 * len(group), "resident_kernel")
        live = tests = 0
        bounds = []
        for soup, o, d, tm, t_min, any_hit in group:
            n_live = int((tm > t_min).sum())
            n_tests = work.resident_work(soup, o, d, tm, t_min, any_hit)
            live += n_live
            tests += n_tests
            bounds.append(bound(o.shape[0] * (4 + (1 if any_hit else 8))
                                + n_live * 24 + soup.numel() * 4,
                                n_tests * MT_FLOPS)[0])
        n_rays = sum(c[1].shape[0] for c in group)
        row = {"kind": kind, "bounce": bounce, "calls": len(group), "ms": ms,
               "bound_ms": sum(bounds) / len(bounds),
               "live_share": live / n_rays, "tests_a_call": tests / len(group),
               "tests_a_live_lane": tests / max(live, 1)}
        row["ratio_to_bound"] = ms / row["bound_ms"]
        rows.append(row)
        print(f"K2 frame {kind} bounce {bounce} ({len(group)} calls, "
              f"{row['live_share']:.4f} of the lanes live, "
              f"{row['tests_a_live_lane']:.2f} tests a live lane): device "
              f"{ms:.4f} ms, bound {row['bound_ms']:.4f} ms, "
              f"{row['ratio_to_bound']:.2f}x [{card_line()}]")
    out = {"calls": rows,
           "ms": sum(r["ms"] * r["calls"] for r in rows),
           "bound_ms": sum(r["bound_ms"] * r["calls"] for r in rows)}
    out["gap_ms"] = out["ms"] - out["bound_ms"]
    print(f"K2 dense cornell frame (512x512, 4 spp, 4 bounces), "
          f"{sum(r['calls'] for r in rows)} calls: device {out['ms']:.4f} ms,"
          f" bound {out['bound_ms']:.4f} ms, launches x (time - bound) "
          f"{out['gap_ms']:.4f} ms [{card_line()}]")
    return out


def phase_k3(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core.tonemap import aces_gamma
    from physically_based_renderer_tpu_torch.ops import tonemap
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    rng = np.random.default_rng(1)
    out = {"max_abs_err": 0.0, "max_abs_err_vs_aces_gamma": 0.0,
           "values_compared": 0, "values_over_tol": 0}
    for h, w in ((512, 512), (37, 53)):
        x = rng.lognormal(-1.0, 2.0, (h, w, 3)).astype(np.float32)
        x[rng.random((h, w, 3)) < 0.05] *= -1.0
        x[rng.random((h, w, 3)) < 0.05] = 0.0
        x[rng.random((h, w, 3)) < 0.02] = rng.uniform(100.0, 1e4)
        hdr = torch.from_numpy(x).to(dev)
        k = tonemap.tonemap(hdr)
        p = tonemap.tonemap_plain(hdr)
        ref = aces_gamma(hdr)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"K3 {h}x{w}: non-finite output")
        err = (k - p).abs().max().item()
        n_bad = int(((k - p).abs() > K3_ATOL).sum())
        if n_bad:
            raise AssertionError(f"K3 {h}x{w}: {n_bad} values off by up to "
                                 f"{err:.3g}")
        out["values_compared"] += k.numel()
        out["values_over_tol"] += n_bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_abs_err_vs_aces_gamma"] = max(
            out["max_abs_err_vs_aces_gamma"], (k - ref).abs().max().item())
        print(f"K3 {h}x{w}: max |kernel - plain| {err:.3g}")
    hdr = torch.from_numpy(
        rng.lognormal(-1.0, 2.0, (512, 512, 3)).astype(np.float32)).to(dev)
    ms, _ = device_ms(lambda: tonemap.tonemap(hdr), 200, "tonemap_kernel")
    out["wrapper_ms"] = time_ms(lambda: tonemap.tonemap(hdr), 200)
    plain_ms = time_ms(lambda: tonemap.tonemap_plain(hdr), 50)
    # 12 bytes in and 12 out per pixel; ~63 float operations (two 3x3 mixes
    # 30, three rational fits 24, three log/multiply/exp 9).
    out["bound"] = bound(hdr.numel() * 4 * 2, hdr.numel() // 3 * 63)
    return out, ms, plain_ms


def phase_threefry(dev):
    """Threefry (csrc/threefry.cu) against core/rng.py's plain version on
    the card: ray_keys and ray_uniform at m = 5 over 262,144 lanes, bit for
    bit, one launch a call; a K4 frame's seed words (one launch a frame);
    device ms of each beside its byte bound and the plain version's."""
    import torch

    from physically_based_renderer_tpu_torch.core import rng
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.tools.timing import device_ms
    from physically_based_renderer_tpu_torch.utils import config

    n = 262_144
    key = rng.key(7, dev)
    sk = rng.split(key, 4)[1]
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    before = rng.LAUNCHES
    keys = rng.ray_keys(sk, pix)
    u = rng.ray_uniform(keys, 3, rng.STREAM_LIGHT, 5)
    seeds = rng.fold_in(key, 0x5EED)
    torch.cuda.synchronize()
    if rng.LAUNCHES - before != 3:
        raise AssertionError(f"threefry: {rng.LAUNCHES - before} launches "
                             "for 3 calls")
    if not torch.equal(keys, rng.fold_in_plain(sk, pix)):
        raise AssertionError("threefry ray_keys differs from the plain "
                             "version")
    plain_u = rng.ray_uniform_plain(keys, 3, rng.STREAM_LIGHT, 5)
    if not torch.equal(u.view(torch.int32), plain_u.view(torch.int32)):
        raise AssertionError("threefry ray_uniform differs from the plain "
                             "version")
    if not torch.equal(seeds, rng.fold_in_plain(key, 0x5EED)):
        raise AssertionError("threefry seed words differ from the plain "
                             "version")
    # One K4 frame at the cornell config's size: its seed words are the
    # frame's only threefry.
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, dev)
    before = rng.LAUNCHES
    path.render_with_stats(scene, cam, rng.key(3, dev), bc.render)
    torch.cuda.synchronize()
    frame_launches = rng.LAUNCHES - before
    if frame_launches != 1:
        raise AssertionError(f"a K4 frame made {frame_launches} threefry "
                             "launches, expected 1")
    out = {"lanes": n, "frame_launches": frame_launches, "calls": {}}
    # Bytes each lane must move: ray_keys a pixel id in and a key out (the
    # one key read once); ray_uniform a key in and m float32 out; the seed
    # words one key in, one out.  A threefry is ~73 32-bit integer
    # operations (20 rounds of add, funnel shift, xor; 5 injections),
    # which neither peak describes: their time at 64 a clock an SM is
    # printed beside the bound.
    calls = (
        ("ray_keys", lambda: rng.ray_keys(sk, pix),
         lambda: rng.fold_in_plain(sk, pix), n * (8 + 16) + 16, n * 1),
        ("ray_uniform m=5", lambda: rng.ray_uniform(keys, 3,
                                                    rng.STREAM_LIGHT, 5),
         lambda: rng.ray_uniform_plain(keys, 3, rng.STREAM_LIGHT, 5),
         n * (16 + 5 * 4), n * 7),
        ("seed words", lambda: rng.fold_in(key, 0x5EED),
         lambda: rng.fold_in_plain(key, 0x5EED), 32, 1),
    )
    for label, fn, plain, n_bytes, n_threefry in calls:
        ms, _ = device_ms(fn, 200, "threefry_")
        plain_ms, _ = device_ms(plain, 20, None)
        int_ms = n_threefry * 73 / (132 * 64 * SM_CLOCK_HZ) * 1e3
        out["calls"][label] = {
            "ms": ms, "wrapper_ms": time_ms(fn, 200), "plain_ms": plain_ms,
            "plain_wrapper_ms": time_ms(plain, 20),
            "bound": bound(n_bytes, 0), "int_ops_ms": int_ms}
        c = out["calls"][label]
        print(f"threefry {label}: kernel {ms:.4f} ms (wrapper "
              f"{c['wrapper_ms']:.4f}), bound {c['bound'][0]:.3g} ms "
              f"(bytes), integer ops {int_ms:.3g} ms, plain device "
              f"{plain_ms:.4f} ms (wrapper {c['plain_wrapper_ms']:.4f}) "
              f"[{card_line()}]")
    # The K4 frame's seed words as fused_frame takes them, the copy to the
    # host and its wait included (host clock).
    for label, fn in (("kernel", rng.fold_in), ("plain", rng.fold_in_plain)):
        for _ in range(20):
            fn(key, 0x5EED).tolist()
        t0 = time.perf_counter()
        for _ in range(500):
            fn(key, 0x5EED).tolist()
        out[f"seed_words_tolist_ms_{label}"] = (
            (time.perf_counter() - t0) / 500 * 1e3)
    print(f"threefry seed words with .tolist(): kernel "
          f"{out['seed_words_tolist_ms_kernel']:.4f} ms, plain "
          f"{out['seed_words_tolist_ms_plain']:.4f} ms a frame (host clock)")
    return out


def phase_k1(dev, name="helmet_proc", chunk=None, held_to=None,
             cluster_k=None, max_u=None):
    """K1 against its plain version on the rays of config `name`, at that
    config's block size (and `chunk` clusters a step, `max_u` candidates a
    block and a grid of `cluster_k` triangles a cluster where given); on a
    scene with area emitters also shadow rays toward them and K5a on the
    emitter table.  `held_to`: the timed calls of a run on the same rays
    at the config's own chunk; each call here is held to that run's work
    and bound (the same rays need no more work), and the tests its own
    chunk's coarser exit adds are counted apart."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import morton
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.integrator.shading import (
        shade_surface)
    from physically_based_renderer_tpu_torch.models import lights
    from physically_based_renderer_tpu_torch.ops import blocktrace, gather
    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    from physically_based_renderer_tpu_torch.utils import config

    st = TraceStats(f"K1 {name}" + (f" chunk={chunk}" if chunk else "")
                    + (f" k={cluster_k}" if cluster_k else ""))
    tag = f"K1 {name}" + (f" k={cluster_k}" if cluster_k else "")
    rng = np.random.default_rng(2)
    bc = config.get(name)
    cfg = dataclasses.replace(bc.render, chunk=chunk or bc.render.chunk,
                              max_u=max_u or bc.render.max_u)
    scene, cam = config.build_scene(
        dataclasses.replace(bc.scene, cluster_k=cluster_k), dev)
    grid = scene.clusters
    kw = dict(block=cfg.block_size, max_u=cfg.max_u, chunk=cfg.chunk)

    # 512x512 camera rays in morton order, as _sample_radiance makes them.
    w, h = cfg.width, cfg.height
    pix = torch.from_numpy(morton.morton_pixel_ids(h, w)).to(dev).long()
    keys = rng_mod.ray_keys(rng_mod.key(0, dev), pix)
    o_cam, d_cam, _ = path.camera_rays(scene, cam, cfg, pix, keys)
    n = o_cam.shape[0]

    def both(args, n_rays, t_min, any_hit):
        """Kernel and plain outputs over the real (unpadded) lanes."""
        k = tb.trace_blocks(*args, t_min=t_min, any_hit=any_hit,
                            chunk=cfg.chunk)
        p = tb.trace_blocks_plain(*args, t_min=t_min, any_hit=any_hit,
                                  chunk=cfg.chunk)
        torch.cuda.synchronize()
        flat = lambda x: x.reshape(-1)[:n_rays]
        if any_hit:
            return flat(k), flat(p)
        return (flat(k[0]), flat(k[1])), (flat(p[0]), flat(p[1]))

    def compare(label, o, d, t_min, t_max, sort, any_hit):
        args, _ = blocktrace.block_inputs(grid, o, d, t_min, t_max,
                                          sort=sort, **kw)
        nv = args[5].float()
        if args[1].shape[1] != cfg.block_size:
            raise AssertionError(f"ray blocks of {args[1].shape[1]}, expected "
                                 f"{cfg.block_size}")
        print(f"{tag} B={cfg.block_size} {label}: candidates per block "
              f"mean {nv.mean().item():.2f}, max {int(nv.max())}")
        (st.any_hit if any_hit else st.closest)(
            label, *both(args, o.shape[0], t_min, any_hit))
        return args

    cam_args = compare("camera closest", o_cam, d_cam, 0.0, 1e30, False,
                       False)
    # Surface bounce rays: from the camera hits, directions about the
    # geometric normal; dead lanes (camera misses) carry t_max = 0.
    hit = path.closest_hit(scene, o_cam, d_cam, 0.0, cfg)
    active = ~hit.miss
    sp = shade_surface(scene, hit, o_cam, d_cam)
    o_b = (sp.pos + sp.ng * cfg.ray_eps).contiguous()
    jitter = torch.from_numpy(rng.normal(size=(n, 3)).astype(
        np.float32)).to(dev)
    d_b = torch.nn.functional.normalize(
        sp.ng + torch.nn.functional.normalize(jitter, dim=-1), dim=-1)
    alive = torch.where(active, 1e30, 0.0)
    for t_min in (1e-3, 0.0):
        compare(f"bounce closest sorted t_min={t_min}", o_b, d_b, t_min,
                alive, True, False)
    # Interior rays: from just inside the surface, uniform directions (most
    # hit the far side; a harder, direction-scattered stream).
    o_in = (sp.pos - sp.ng * cfg.ray_eps).contiguous()
    d_in = torch.nn.functional.normalize(jitter, dim=-1)
    compare("interior closest sorted", o_in, d_in, cfg.ray_eps, alive, True,
            False)
    # Env shadow rays: environment NEE directions from the same points,
    # sorted as the integrator's occluded() sorts them (resort).
    u2 = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    es = lights.sample_env(scene, n, u2)
    t_sh = torch.where(active & es.valid, es.dist * (1.0 - 1e-3), 0.0)
    timed = {"camera closest": (cam_args, 0.0, False),
             "env shadow any-hit": (compare(
                 "env shadow any-hit sorted", o_b, es.wi, cfg.ray_eps, t_sh,
                 True, True), cfg.ray_eps, True)}
    compare("env shadow any-hit unsorted", o_b, es.wi, cfg.ray_eps, t_sh,
            False, True)
    st.emitter_rows = 0
    if scene.has_emitters:
        # Shadow rays toward the emissive triangles (alias pick, emissive
        # texture), as the integrator's NEE makes them.
        u3 = torch.from_numpy(rng.random((n, 3)).astype(np.float32)).to(dev)
        attrs = lights.pack_emitter_attrs(scene)
        ls = lights.sample_area_emitters(scene, sp.pos, u3[:, 0], u3[:, 1:],
                                         emitter_attrs=attrs)
        t_em = torch.where(active & ls.valid, ls.dist * (1.0 - 1e-3), 0.0)
        timed["emitter shadow any-hit"] = (compare(
            "emitter shadow any-hit sorted", o_b, ls.wi, cfg.ray_eps, t_em,
            True, True), cfg.ray_eps, True)
        # K5a on the emitter table at the frame's shape (timed in phase 8
        # with the frame's other gathers).
        e_idx = torch.from_numpy(rng.integers(
            0, attrs.shape[0], n).astype(np.int32)).to(dev)
        rows_k = gather.gather_fwd(attrs, e_idx)
        rows_p = gather.take_rows_plain(attrs, e_idx)
        torch.cuda.synchronize()
        if not torch.equal(rows_k, rows_p):
            raise AssertionError(f"K5a on the {tuple(attrs.shape)} emitter "
                                 "table differs from its plain version")
        st.emitter_rows = attrs.shape[0]
        print(f"K5a {name} emitter table {tuple(attrs.shape)} x {n} rows: "
              "bit-equal")
    # Ragged ray count (not a multiple of the block size).
    nr = n - 77
    compare("ragged closest", o_cam[:nr], d_cam[:nr], 0.0, 1e30, False,
            False)
    rand_tm = torch.from_numpy(rng.uniform(0.05, 4.0, nr).astype(
        np.float32)).to(dev)
    compare("ragged any-hit random t_max", o_b[:nr], d_b[:nr], 1e-3,
            rand_tm, True, True)

    # Times at the main path's shape: 262,144 rays through phase A as the
    # integrator calls it, the camera's closest hit and the shadow rays' any
    # hit.  The work these inputs need: closest hit, the tests of live lanes
    # against the real triangles of the chunks each block visits before its
    # early exit, replayed from the call's winners (k1_work); any hit, the
    # tests before each lane's first hit, replayed likewise (k1_any_work).
    # Bytes: o, d, t_max in and the results out per lane, the candidate
    # lists and entries, the soup of the distinct clusters read, once.
    tri_id = grid.tri_id.to(dev)
    st.calls = {}
    for label, (args, t_min, any_hit) in timed.items():
        c = k1_call_stats(args, t_min, any_hit, cfg.chunk, tri_id)
        ms, wrapper_ms = c["ms"], c["wrapper_ms"]
        tests, n_clusters = c["tests"], c["clusters_read"]
        nb, blk = c["lanes"] // c["block"], c["block"]
        bnd = (c["bound_ms"], c["bound_by"])
        added = None
        if held_to is not None:
            base = held_to[label]
            # Any-hit counts are lower bounds, and their difference is no
            # count of tests; the closest-hit replay is exact.
            if not any_hit:
                added = tests - base["tests"]
            tests, n_clusters = base["tests"], base["clusters_read"]
            bnd = (base["bound_ms"], base["bound_by"])
        st.calls[label] = {
            "ms": ms, "wrapper_ms": wrapper_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "tests": tests, "clusters_read": n_clusters,
            "tests_added_by_chunk": added, "chunk": c["chunk"],
            "candidates": c["candidates"],
            "tests_per_s": tests / (ms * 1e-3), "ratio_to_bound": ms / bnd[0]}
        extra = (f"; the chunk's coarser exit adds {added} tests"
                 if added is not None else "")
        print(f"{tag} B={blk} chunk={cfg.chunk} {label} ({nb * blk} "
              f"lanes): device {ms:.4f} ms, wrapper {wrapper_ms:.4f} ms, "
              f"bound {bnd[0]:.4f} ms ({bnd[1]}; {tests} tests needed, "
              f"{n_clusters} clusters read{extra}), "
              f"{tests / (ms * 1e-3):.4g} tests/s, {ms / bnd[0]:.2f}x the "
              f"bound [{card_line()}]")
    cam = st.calls["camera closest"]
    ms, st.wrapper_ms = cam["ms"], cam["wrapper_ms"]
    st.bound = (cam["bound_ms"], cam["bound_by"])
    plain_ms = time_ms(lambda: tb.trace_blocks_plain(
        *cam_args, t_min=0.0, any_hit=False, chunk=cfg.chunk), 5, warmup=1)
    u_idx, o_b, _, _, soup_b, n_valid, _ = cam_args
    st.work = {"tests": cam["tests"], "tests_if_no_exit": int(n_valid.sum())
               * o_b.shape[1] * soup_b.shape[-1],
               "clusters_read": cam["clusters_read"],
               "tests_added_by_chunk": cam["tests_added_by_chunk"]}
    print(f"{tag} camera closest work: {st.work['tests']} ray-triangle "
          f"tests needed ({st.work['tests_if_no_exit']} if every lane tested "
          f"every candidate), {st.work['clusters_read']} clusters read")
    return st, ms, plain_ms


def phase_k4(dev):
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.ops import fused
    from physically_based_renderer_tpu_torch.tools import work
    from physically_based_renderer_tpu_torch.tools.timing import device_ms
    from physically_based_renderer_tpu_torch.utils import config

    out = {"frames_compared": 0, "pixels_compared": 0, "pixels_differ": 0,
           "max_abs_err": 0.0, "max_mean_rel": 0.0, "max_count_rel": 0.0}
    frames = {}
    for label, name, over in (("cornell", "cornell", {}),
                              ("cornell_ggx", "cornell_ggx", {}),
                              ("triangle", "triangle", {}),
                              ("cornell ragged", "cornell",
                               dict(width=24, height=20))):
        bc = config.get(name)
        scene, cam = config.build_scene(bc.scene, dev)
        cfg = dataclasses.replace(bc.render, **over)
        frame = fused.fused_frame(scene, cam, rng_mod.key(0, dev), cfg)
        hdr, count = fused.fused_kernel(frame)
        plain, count_p = fused.fused_plain(frame)
        torch.cuda.synchronize()
        img = (hdr / cfg.spp).cpu().numpy()
        ref = (plain / cfg.spp).cpu().numpy()
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(
                img).all():
            raise AssertionError(f"K4 {label}: shape {img.shape}, finite "
                                 f"{bool(np.isfinite(img).all())}")
        frac, n_bad = render_agreement(img, ref)
        mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
        count_rel = abs(int(count) / int(count_p) - 1.0)
        err = float(np.abs(img - ref).max())
        print(f"K4 {label} {cfg.width}x{cfg.height} x {cfg.spp} spp x "
              f"{cfg.max_bounces} bounces: {frac:.4%} pixels agree "
              f"({n_bad} differ), max |kernel - plain| {err:.3g}, mean rel "
              f"diff {mean_rel:.3g}, ray queries {int(count)} vs "
              f"{int(count_p)}")
        if frac < PIXEL_FRAC or mean_rel > MEAN_REL or count_rel > COUNT_REL:
            raise AssertionError(f"K4 {label}: kernel disagrees with its "
                                 "plain version")
        out["frames_compared"] += 1
        out["pixels_compared"] += cfg.width * cfg.height
        out["pixels_differ"] += n_bad
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["max_mean_rel"] = max(out["max_mean_rel"], mean_rel)
        out["max_count_rel"] = max(out["max_count_rel"], count_rel)
        frames[label] = frame

    # Times at the main paths' shapes: the whole cornell and cornell_ggx
    # frames.  Bound: the ray-triangle tests this frame's data needs
    # (tools/work.py, replayed from the plain version's own queries: every
    # triangle for a closest hit, up to and including the first occluder
    # for a shadow ray), MT_FLOPS each; the shading arithmetic is left out.
    # Bytes: the HDR sum out (the tables are kilobytes).  Beside it, the
    # earlier lower bound, from the query count alone: of `count` queries
    # at least one in 1 + n_shadow is a closest hit.
    out["frames"] = {}
    for label in ("cornell", "cornell_ggx"):
        frame = frames[label]
        ms, _ = device_ms(lambda: fused.fused_kernel(frame), 20,
                          "fused_kernel")
        wrapper_ms = time_ms(lambda: fused.fused_kernel(frame), 20)
        plain_ms = time_ms(lambda: fused.fused_plain(frame), 3, warmup=1)
        w = work.fused_work(frame)
        n_shadow = int(frame.has_em) + int(frame.has_dir)
        n_tris = frame.tri.shape[0]
        n_bytes = frame.width * frame.height * 3 * 4
        bnd = bound(n_bytes, w["tests"] * MT_FLOPS)
        old = bound(n_bytes, -(-w["count"] // (1 + n_shadow)) * n_tris
                    * MT_FLOPS)
        print(f"K4 {label} frame device {ms:.4f} ms, wrapper "
              f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bnd[0]:.4f} ms ({w['tests']} tests: {w['closest_queries']}"
              f" closest-hit queries x {n_tris} triangles, "
              f"{w['shadow_queries']} shadow queries traced with "
              f"{w['shadow_tests']} tests), {ms / bnd[0]:.2f}x the bound; "
              f"the closest-hit-only lower bound {old[0]:.4f} ms; lane use "
              f"of the closest-hit loop {w['lane_use_samples']:.4f} with a "
              f"thread a (pixel, sample), {w['lane_use_pixels']:.4f} with a "
              f"thread a pixel [{card_line()}]")
        out["frames"][label] = {"ms": ms, "wrapper_ms": wrapper_ms,
                                "plain_ms": plain_ms, "bound": bnd,
                                "closest_hit_only_bound_ms": old[0],
                                "work": w, "ratio_to_bound": ms / bnd[0]}
    cornell = out["frames"]["cornell"]
    out["wrapper_ms"] = cornell["wrapper_ms"]
    out["bound"] = cornell["bound"]
    return out, cornell["ms"], cornell["plain_ms"]


def phase_k5(dev):
    """K5a/K5b against their plain versions over GATHER_TABLES x GATHER_NS
    and skewed index sets; times at cornell's shape."""
    import torch

    from physically_based_renderer_tpu_torch.ops import gather
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    gen = torch.Generator(device=dev).manual_seed(8)
    out = {"cases": 0, "rows_compared": 0, "fwd_max_abs_err": 0.0,
           "bwd_max_rel_err": 0.0}

    def dyadic(n, w):
        # Multiples of 2^-10 below 8 in magnitude: every partial sum of up
        # to ~10^6 of them is exact in float32, whatever the order.
        x = torch.randn((n, w), device=dev, generator=gen).clamp(-7.9, 7.9)
        return torch.round(x * 1024.0) / 1024.0

    def check(label, table, idx, ct):
        t = table.shape[0]
        k = gather.gather_fwd(table, idx)
        p = gather.take_rows_plain(table, idx)
        dk = gather.gather_bwd(idx, ct, t)
        dp = gather.take_rows_bwd_plain(idx, ct, t)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K5a {label}: rows differ (max "
                                 f"{(k - p).abs().max().item():.3g})")
        scale = dp.abs().max().item()
        err = (dk - dp).abs().max().item()
        if err > K5B_REL * scale:
            raise AssertionError(f"K5b {label}: max |kernel - plain| {err:.3g}"
                                 f" > {K5B_REL} x {scale:.3g}")
        out["cases"] += 1
        out["rows_compared"] += idx.shape[0]
        out["bwd_max_rel_err"] = max(out["bwd_max_rel_err"],
                                     err / max(scale, 1e-30))
        return err

    for t, w in GATHER_TABLES:
        table = torch.randn((t, w), device=dev, generator=gen) * 1e3
        for n in GATHER_NS:
            idx = torch.randint(-1, t + 1, (n,), device=dev, generator=gen,
                                dtype=torch.int32)
            idx[:2] = torch.tensor([-1, t], dtype=torch.int32)
            check(f"T={t} W={w} N={n}", table, idx, dyadic(n, w))
        print(f"K5 T={t} W={w}: rows bit-equal, cotangent sums equal")
    # int64 indices; every ray on one row (the atomics' worst case), with a
    # table in shared memory and one in global memory; real-valued
    # cotangents at cornell's shape.
    for t, w, n, same in ((32, 86, 262_144, False), (32, 86, 1_000_003, True),
                          (100_352, 86, 262_144, True)):
        table = torch.randn((t, w), device=dev, generator=gen)
        idx = (torch.full((n,), 7, device=dev, dtype=torch.int64) if same
               else torch.randint(-1, t + 1, (n,), device=dev,
                                  generator=gen))
        check(f"int64 T={t} W={w} N={n} one row {same}", table, idx,
              dyadic(n, w))
    table = torch.randn((32, 86), device=dev, generator=gen)
    idx = torch.randint(0, 32, (262_144,), device=dev, generator=gen,
                        dtype=torch.int32)
    ct = torch.randn((262_144, 86), device=dev, generator=gen)
    err = check("float cotangents T=32 W=86 N=262144", table, idx, ct)
    out["bwd_max_abs_err_float"] = err
    print(f"K5 {out['cases']} cases, {out['rows_compared']} rows: forward "
          f"bit-equal, backward max rel err {out['bwd_max_rel_err']:.3g} "
          f"(float cotangents at cornell's shape: max |err| {err:.3g})")

    # Times at cornell's shape (tri_attrs: 262,144 rays x 86 columns of 32
    # rows).  The library calls are the yardsticks the port never calls.
    # `*_ms` is the kernel's own device time (torch.profiler), `*_wrapper_ms`
    # the wrapper called back to back (CUDA events; host dispatch, checks,
    # the output's allocation and K5b's zero fill included),
    # `bwd_fill_ms` the device time of K5b's zero fill of d_table.
    acc = torch.zeros((32, 86), device=dev)
    n, w, t = 262_144, 86, 32
    fwd = lambda: gather.gather_fwd(table, idx)
    bwd = lambda: gather.gather_bwd(idx, ct, t)
    index_select = lambda: torch.index_select(table, 0, idx)
    index_add = lambda: acc.index_add_(0, idx, ct)
    times = {}
    times["fwd_ms"], _ = device_ms(fwd, 200, "gather_fwd_kernel")
    times["bwd_ms"], times["bwd_fill_ms"] = device_ms(bwd, 200, "gather_bwd_")
    times["fwd_library_device_ms"], _ = device_ms(index_select, 200, None)
    times["bwd_library_device_ms"], _ = device_ms(index_add, 200, None)
    times["fwd_wrapper_ms"] = time_ms(fwd, 200)
    times["bwd_wrapper_ms"] = time_ms(bwd, 200)
    times["fwd_plain_ms"] = time_ms(
        lambda: gather.take_rows_plain(table, idx), 50)
    times["bwd_plain_ms"] = time_ms(
        lambda: gather.take_rows_bwd_plain(idx, ct, t), 50)
    times["fwd_library_ms"] = time_ms(index_select, 200)
    times["bwd_library_ms"] = time_ms(index_add, 200)
    one_row = torch.zeros_like(idx)
    times["bwd_one_row_ms"], _ = device_ms(
        lambda: gather.gather_bwd(one_row, ct, t), 50, "gather_bwd_")
    # Each input read once, each output written once: idx, the table and
    # the rows (forward) or the cotangent rows and d_table (backward); the
    # backward adds N*W floats.
    n_bytes = n * w * 4 + n * 4 + t * w * 4
    out["fwd_bound"] = bound(n_bytes, 0)
    out["bwd_bound"] = bound(n_bytes, n * w)
    out.update(times)
    print("K5 262144 x 86 from 32 rows: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    print(f"K5a at cornell's shape: kernel {times['fwd_ms']:.4f} ms, "
          f"index_select {times['fwd_library_device_ms']:.4f} ms, bound "
          f"{out['fwd_bound'][0]:.4f} ms [{card_line()}]")

    # K5a at every (T, W) that a helmet frame and a dense cornell frame
    # gather, on the frames' own tables and indices, index_select beside it.
    out["main_path_shapes"] = [time_k5a_shape(*c)
                               for c in k5a_main_path_calls(dev)]
    # K5b at every (T, W, N) of one gradient step's render() backward, on
    # the step's own indices and cotangents, index_add_ beside it.
    out["bwd_main_path_shapes"] = [time_k5b_shape(*c)
                                   for c in k5b_main_path_calls(dev)]
    return out


def k5a_main_path_calls(dev):
    """The distinct K5a calls of one helmet frame and one dense cornell
    frame (512x512, 4 spp, their configs' bounces), logged by wrapping
    gather.gather_fwd while the frames render: [(label, table, idx,
    calls by frame)], keyed by (T, W, N, index type), each with the first
    call's tensors."""
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import gather
    from physically_based_renderer_tpu_torch.utils import config

    seen = {}
    frame = None
    real = gather.gather_fwd

    def logged(table, idx):
        key = (*table.shape, idx.shape[0], str(idx.dtype).split(".")[-1])
        entry = seen.setdefault(key, [table, idx, {}])
        entry[2][frame] = entry[2].get(frame, 0) + 1
        return real(table, idx)

    gather.gather_fwd = logged
    try:
        for frame, tracer in (("helmet", "auto"), ("cornell", "resident")):
            bc = config.get(frame)
            scene, cam = config.build_scene(bc.scene, dev)
            cfg = dataclasses.replace(bc.render, tracer=tracer)
            path.render_with_stats(scene, cam, rng_mod.key(0, dev), cfg)
    finally:
        gather.gather_fwd = real
    calls = []
    for (t, w, n, dtype), (table, idx, by_frame) in sorted(seen.items()):
        label = f"T={t} W={w} N={n} {dtype}"
        print(f"K5a main-path shape {label}: {by_frame} calls")
        calls.append((label, table, idx, by_frame))
    return calls


def time_k5a_shape(label, table, idx, by_frame):
    """K5a on one main-path call's tensors: bit-equal to the plain version;
    device and wrapper times, its bound and index_select's device time.
    The yardstick gets the indices clamped into [0, T) (index_select has no
    zero rows, and an index outside the table would fault), so it moves the
    same bytes.  Bytes: the rows out, the indices in, the distinct table
    rows read, once each."""
    import torch

    from physically_based_renderer_tpu_torch.ops import gather
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    t, w = table.shape
    n = idx.shape[0]
    if not torch.equal(gather.gather_fwd(table, idx),
                       gather.take_rows_plain(table, idx)):
        raise AssertionError(f"K5a {label}: rows differ from the plain "
                             "version")
    call = lambda: gather.gather_fwd(table, idx)
    ms, _ = device_ms(call, 200, "gather_fwd_kernel")
    wrapper_ms = time_ms(call, 200)
    safe = idx.clamp(0, t - 1)
    library_ms, _ = device_ms(lambda: torch.index_select(table, 0, safe),
                              200, None)
    rows = int(torch.unique(idx[(idx >= 0) & (idx < t)]).numel())
    bnd = bound(n * w * 4 + n * idx.element_size() + rows * w * 4, 0)
    # The route csrc/gather.cu takes for this table.
    mode = "quads" if w % 4 == 0 and table.data_ptr() % 16 == 0 else "rows"
    print(f"K5a {label} ({mode}; {rows} rows read): device {ms:.4f} ms, "
          f"wrapper {wrapper_ms:.4f} ms, index_select {library_ms:.4f} ms, "
          f"bound {bnd[0]:.4f} ms, {ms / bnd[0]:.2f}x the bound, "
          f"{library_ms / ms:.2f}x faster than index_select "
          f"[{card_line()}]")
    return {"shape": label, "route": mode, "calls": by_frame,
            "rows_read": rows, "ms": ms, "wrapper_ms": wrapper_ms,
            "library_ms": library_ms, "bound_ms": bnd[0],
            "ratio_to_bound": ms / bnd[0]}


def k5b_main_path_calls(dev):
    """The K5b calls of one render() backward of the gradient step (the
    inverse CLI's cornell at GRAD_CLI's size, the four material fields),
    logged by tools/work.py: [(label, [(idx, ct, T), ...])] by (T, W, N,
    index type), calls in launch order."""
    from physically_based_renderer_tpu_torch.tools import work

    c = GRAD_CLI
    calls = work.gradient_step_calls(dev, c["size"], c["spp"], c["bounces"])
    want = c["spp"] * (2 * c["bounces"] + 1)
    if len(calls) != want:
        raise AssertionError(f"{len(calls)} K5b calls in a step's backward, "
                             f"expected {want}")
    groups = {}
    for idx, ct, t in calls:
        key = (t, ct.shape[1], idx.shape[0], str(idx.dtype).split(".")[-1])
        groups.setdefault(key, []).append((idx, ct, t))
    out = []
    for (t, w, n, dtype), group in sorted(groups.items()):
        label = f"T={t} W={w} N={n} {dtype}"
        print(f"K5b main-path shape {label}: {len(group)} calls a step")
        out.append((label, group))
    return out


def time_k5b_shape(label, calls):
    """K5b on one main-path shape's calls (a step's own indices and
    cotangents): each within K5B_REL * max|plain| of the plain version;
    device and wrapper times per launch over the calls in turn, the bound
    and index_add_'s device time.  The yardstick gets the indices clamped
    into [0, T) (index_add_ faults on an index outside the table), so it
    moves the same bytes.  Bytes: the cotangent rows and indices in,
    d_table out, once each; operations: one add an element."""
    import itertools

    import torch

    from physically_based_renderer_tpu_torch.ops import gather
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    worst, runs = 0.0, 0
    for idx, ct, t in calls:
        dk = gather.gather_bwd(idx, ct, t)
        dp = gather.take_rows_bwd_plain(idx, ct, t)
        scale = dp.abs().max().item()
        err = (dk - dp).abs().max().item()
        if err > K5B_REL * scale:
            raise AssertionError(f"K5b {label}: max |kernel - plain| {err:.3g}"
                                 f" > {K5B_REL} x {scale:.3g}")
        worst = max(worst, err / max(scale, 1e-30))
        runs += 1 + int((idx[1:] != idx[:-1]).sum())
    idx, ct, t = calls[0]
    n, w = ct.shape
    iters = len(calls) * max(1, 200 // len(calls))
    turn = itertools.cycle(calls)
    call = lambda: gather.gather_bwd(*next(turn))
    ms, fill_ms = device_ms(call, iters, "gather_bwd_")
    wrapper_ms = time_ms(call, iters)
    acc = torch.zeros((t, w), device=ct.device)
    lib_turn = itertools.cycle([(i.clamp(0, t - 1), c) for i, c, _ in calls])
    library_ms, _ = device_ms(lambda: acc.index_add_(0, *next(lib_turn)),
                              iters, None)
    bnd = bound(n * w * 4 + n * idx.element_size() + t * w * 4, n * w)
    rows_a_run = len(calls) * n / runs
    print(f"K5b {label} ({len(calls)} calls, {rows_a_run:.1f} rows a run "
          f"of equal indices): device {ms:.4f} ms (+ {fill_ms:.4f} zero "
          f"fill), wrapper {wrapper_ms:.4f} ms, index_add_ {library_ms:.4f}"
          f" ms, bound {bnd[0]:.4f} ms, {ms / bnd[0]:.2f}x the bound, max "
          f"rel err {worst:.3g} [{card_line()}]")
    return {"shape": label, "calls": len(calls), "rows_a_run": rows_a_run,
            "ms": ms, "fill_ms": fill_ms, "wrapper_ms": wrapper_ms,
            "library_ms": library_ms, "bound_ms": bnd[0],
            "ratio_to_bound": ms / bnd[0], "max_rel_err": worst}


def phase_grad_golden(dev):
    """render() + pixel_loss gradients on the card against the reference's
    (the gradient golden), with exact K5a/K5b counts."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.grad import inverse
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import fused, gather
    from physically_based_renderer_tpu_torch.utils import config

    gold = np.load(GRAD_GOLDEN)
    out = {}
    for case, (select, rel, (want_fwd, want_bwd)) in GRAD_CASES.items():
        bc = config.get(case)
        scene, cam = config.build_scene(bc.scene, dev)
        cfg = dataclasses.replace(bc.render, width=GRAD_SIZE,
                                  height=GRAD_SIZE, spp=GRAD_SPP,
                                  max_bounces=GRAD_BOUNCES, tracer="resident")
        params = inverse.trainable_copy(
            inverse.TrainableParams.from_scene(scene, **select))
        gather.LAUNCHES_FWD = gather.LAUNCHES_BWD = fused.LAUNCHES = 0
        img = path.render(inverse.apply_params(scene, params), cam,
                          rng_mod.key(int(gold["key"]), dev), cfg).mean()
        loss = inverse.pixel_loss(img, torch.from_numpy(
            gold[f"{case}/target"]).to(dev))
        loss.backward()
        torch.cuda.synchronize()
        got = (gather.LAUNCHES_FWD, gather.LAUNCHES_BWD, fused.LAUNCHES)
        if got != (want_fwd, want_bwd, 0):
            raise AssertionError(f"gradient {case}: K5a/K5b/K4 launches {got},"
                                 f" expected {(want_fwd, want_bwd, 0)}")
        worst = 0.0
        for field, leaf in params.items():
            want = gold[f"{case}/grad/{field}"]
            g = leaf.grad.cpu().numpy()
            scale = float(np.abs(want).max())
            err = float(np.abs(g - want).max()) / scale
            if not np.isfinite(g).all() or err > rel:
                raise AssertionError(f"gradient {case} {field}: max err "
                                     f"{err:.3g} x max|g_ref| > {rel}")
            worst = max(worst, err)
        loss_rel = abs(float(loss.detach()) / float(gold[f"{case}/loss"])
                       - 1.0)
        print(f"gradient golden {case} {GRAD_SIZE}x{GRAD_SIZE}: max err "
              f"{worst:.3g} x max|g_ref| (allowed {rel}), loss rel diff "
              f"{loss_rel:.3g}, K5a {got[0]}, K5b {got[1]}")
        out[case] = {"max_rel_err": worst, "allowed": rel,
                     "loss_rel_diff": loss_rel, "gather_fwd": got[0],
                     "gather_bwd": got[1]}
    return out


def run_inverse_cli(argv, tmp, label):
    """Run the inverse CLI in this process; return its report (JSON file)."""
    from physically_based_renderer_tpu_torch.apps import inverse
    report = Path(tmp) / f"{label}.json"
    with contextlib.redirect_stdout(io.StringIO()):
        rc = inverse.main(argv + ["--report", str(report), "--device",
                                  "cuda"])
    if rc != 0:
        raise AssertionError(f"inverse CLI exited {rc}")
    return json.loads(report.read_text())


def phase_grad_step(counters, tmp):
    """The inverse CLI at the cornell config's full size: seconds per warm
    step, peak memory and exact launches per step."""
    import numpy as np
    import torch

    c = GRAD_CLI
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.reset_peak_memory_stats()
    rep = run_inverse_cli(
        ["--scene", "cornell", "--params",
         "base_color,roughness,metallic,emissive", "--size", str(c["size"]),
         "--spp", str(c["spp"]), "--bounces", str(c["bounces"]),
         "--target-spp", str(c["target_spp"]), "--steps", str(c["steps"])],
        tmp, "grad_step")
    peak = torch.cuda.max_memory_allocated()
    got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    per_render = 2 * c["bounces"] + 1
    want = {k: 0 for k in got}
    want["resident"] = want["gather_fwd"] = (
        (c["target_spp"] + c["steps"] * c["spp"]) * per_render)
    want["gather_bwd"] = c["steps"] * c["spp"] * per_render
    if got != want:
        raise AssertionError(f"gradient step launches {got}, expected {want}")
    if not np.isfinite(list(rep["final_error"].values())
                       + [rep["final_loss"]]).all():
        raise AssertionError(f"gradient step report {rep}")
    per_step = {k: (v - (c["target_spp"] * per_render
                         if k in ("resident", "gather_fwd") else 0))
                // c["steps"] for k, v in got.items()}
    print(f"gradient step cornell {c['size']}x{c['size']} x {c['spp']} spp "
          f"x {c['bounces']} bounces: {rep['seconds_per_step']:.4f} s per "
          f"warm step, peak memory {peak / 2**30:.3f} GiB, launches per step "
          f"{per_step}")
    return {"seconds_per_step": rep["seconds_per_step"],
            "step_seconds": rep["step_seconds"], "peak_bytes": peak,
            "launches_per_step": per_step, "launches": got,
            "final_loss": rep["final_loss"]}, got


def phase_fit(counters, tmp):
    """The CLI at its defaults: 20 steps with a checkpoint at step 20, then
    a --resume run to step 40 that lowers every field's error."""
    ckpt = str(Path(tmp) / "ckpt")
    common = ["--checkpoint-dir", ckpt, "--checkpoint-every", "20"]
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    first = run_inverse_cli(common + ["--steps", "20"], tmp, "fit_first")
    resumed = run_inverse_cli(common + ["--steps", "40", "--resume"], tmp,
                              "fit_resumed")
    got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    if first["start_step"] != 0 or resumed["start_step"] != 20:
        raise AssertionError(f"resume started at {resumed['start_step']}, "
                             "expected 20")
    # The error of the values the scene renders (after apply_params'
    # clamps) must fall for every field.  The raw parameters' error need
    # not: at these defaults Adam carries parameters past their clamps,
    # where the loss no longer sees them, and the raw base colour error
    # rises in the reference's own CLI too (0.274 -> 0.397 after 40 steps
    # on the CPU, the port's equal to 6 digits).
    for field, err0 in resumed["initial_error_applied"].items():
        err1 = resumed["final_error_applied"][field]
        if not err1 < err0:
            raise AssertionError(f"fit did not lower {field}'s error: "
                                 f"{err0} -> {err1}")
    print(f"fit 64x64 x 2 spp, 20 + 20 steps (resumed at 20): error of the "
          f"rendered values {resumed['initial_error_applied']} -> "
          f"{resumed['final_error_applied']}, of the raw parameters "
          f"{resumed['initial_error']} -> {resumed['final_error']}, "
          f"{resumed['seconds_per_step']:.4f} s per warm step")
    return {key: resumed[key] for key in (
        "initial_error", "final_error", "initial_error_applied",
        "final_error_applied", "seconds_per_step")} | {
        "error_applied_at_20": first["final_error_applied"],
        "losses": first["losses"] + resumed["losses"]}, got


def phase_profile(dev):
    """One full-size gradient step (GRAD_CLI's) under torch.profiler: the
    device's busy time, idle share and kernel launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.grad import inverse
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.tools import timing
    from physically_based_renderer_tpu_torch.utils import config

    c = GRAD_CLI
    bc = config.get("cornell")
    scene, cam = config.build_scene(bc.scene, dev)
    cfg = path.RenderConfig(width=c["size"], height=c["size"], spp=c["spp"],
                            max_bounces=c["bounces"])
    with torch.no_grad():
        target = path.render(scene, cam, rng_mod.key(9999, dev), cfg).mean()
    params = inverse.trainable_copy(inverse.TrainableParams.from_scene(
        scene, base_color=True, roughness=True, metallic=True,
        emissive=True))
    step = inverse.make_train_step(
        scene, cam, cfg, torch.optim.Adam(params.leaves(), lr=5e-2))
    state = None
    params, state, _ = step(params, state, rng_mod.key(1, dev), target)
    torch.cuda.synchronize()
    rng_before = rng_mod.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, loss = step(params, state, rng_mod.key(2, dev), target)
        float(loss)
        wall = time.perf_counter() - t0
    # One threefry launch a call: the samples' split, then a sample's
    # ray_keys and jitter and a bounce's light and BSDF draws (Russian
    # roulette starts past the last bounce).
    rng_launches = rng_mod.LAUNCHES - rng_before
    if rng_launches != 1 + c["spp"] * (2 + 2 * c["bounces"]):
        raise AssertionError(f"profiled step: {rng_launches} threefry "
                             "launches")
    kernels = timing.kernels(prof.key_averages())
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in prof.key_averages()
                   if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    out = {"wall_s": wall, "device_busy_s": busy_us / 1e6,
           "idle_share": (1.0 - busy_us / 1e6 / wall) if busy_us else None,
           "launches": launches, "rng_launches": rng_launches,
           "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3,
                            e.count) for e in top]}
    print(f"profiled gradient step: wall {wall:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s, idle share {out['idle_share']}, "
          f"{launches} kernel launches, {rng_launches} of them threefry")
    return out


def phase_helmet_asset(dev):
    """Author, write and ingest the helmet .glb (into a temporary directory,
    so that nothing is cached), timed apart from the frame."""
    import torch

    from physically_based_renderer_tpu_torch.scene import gltf, helmet_asset
    from physically_based_renderer_tpu_torch.scene.types import (
        upload_scene, with_clusters)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        glb = helmet_asset.cached_helmet_glb(tmp)
        out["author_write_s"] = time.perf_counter() - t0
        out["glb_bytes"] = glb.stat().st_size
        t0 = time.perf_counter()
        scene, _, _ = gltf.load(glb)
        out["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = with_clusters(scene)
    out["clusters_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = upload_scene(scene, dev)
    torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0
    out.update(triangles=scene.geometry.num_tris,
               emitters=scene.emitters.num_emitters,
               clusters=scene.clusters.num_clusters)
    if (out["triangles"], out["emitters"], scene.tex_slots) != (
            99_400, 15_600, (True,) * 4):
        raise AssertionError(f"helmet asset: {out}, slots {scene.tex_slots}")
    print(f"helmet asset: author + write {out['author_write_s']:.2f} s "
          f"({out['glb_bytes']} bytes), ingest {out['ingest_s']:.2f} s, "
          f"cluster grid {out['clusters_s']:.2f} s, upload "
          f"{out['upload_s']:.2f} s; {out['triangles']} triangles, "
          f"{out['emitters']} emitters, {out['clusters']} clusters")
    return out


def phase_glb_path(dev, tmp, counters):
    """A small .glb rendered by path through the CLI (its camera, the
    default RenderConfig, K1 + K5a + K3) against brute force on the same
    file; a truncated copy must return 2."""
    import numpy as np

    from physically_based_renderer_tpu_torch.apps import render
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.scene import helmet_asset
    from physically_based_renderer_tpu_torch.utils import config

    glb = helmet_asset.cached_helmet_glb(Path(tmp) / "assets",
                                         SMALL_GLB_SCALE)
    png, hdr_path = Path(tmp) / "by_path.png", Path(tmp) / "by_path.npy"
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    stats = run_cli([str(glb), "-o", str(png), "--hdr-output", str(hdr_path),
                     "--stats", "--device", "cuda"])
    got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
    # default RenderConfig: 4 spp x (2 closest + 1 emitter shadow) K1 queries
    if (got["trace_blocks"], got["tonemap"], got["fused"]) != (12, 1, 0):
        raise AssertionError(f".glb by path launches {got}")
    img = np.load(hdr_path)
    cfg = path.RenderConfig()
    if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(img).all():
        raise AssertionError(f".glb by path: film {img.shape}")
    scene, cam = config.build_scene(
        config.SceneSpec(builder="gltf", extra={"path": glb}), dev)
    film, count = path.render_with_stats(
        scene, cam, rng_mod.key(0, dev),
        dataclasses.replace(cfg, tracer="brute"))
    ref = film.mean().cpu().numpy()
    lit = (ref > 0).any(-1) | (img > 0).any(-1)
    frac, n_bad = render_agreement(img, ref)
    frac_lit, n_bad_lit = render_agreement(img[lit], ref[lit])
    print(f".glb by path ({glb.name}, {scene.geometry.num_tris} triangles) "
          f"{cfg.width}x{cfg.height}: {stats['seconds']:.3f} s, "
          f"{stats['rays']} ray queries (brute force: {int(count)}), "
          f"{frac:.4%} of pixels and {frac_lit:.4%} of the {int(lit.sum())} "
          f"lit ones agree with brute force")
    # The file holds no sky: only the visor's thin emissive strips light it.
    if (frac < PIXEL_FRAC or frac_lit < PIXEL_FRAC or not lit.any()
            or abs(stats["rays"] / int(count) - 1.0) > COUNT_REL):
        raise AssertionError(".glb by path disagrees with brute force")
    bad = Path(tmp) / "truncated.glb"
    bad.write_bytes(glb.read_bytes()[:glb.stat().st_size // 2])
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = render.main([str(bad), "-o", str(Path(tmp) / "bad.png"),
                          "--device", "cuda"])
    if rc != 2 or not err.getvalue().startswith("error: "):
        raise AssertionError(f"truncated .glb: exit {rc}, {err.getvalue()!r}")
    print(f"truncated .glb: exit 2, {err.getvalue().strip()}")
    return {"seconds": stats["seconds"], "rays": stats["rays"],
            "pixel_frac": frac, "lit_pixels": int(lit.sum()),
            "lit_pixel_frac": frac_lit, "truncated_exit": rc,
            "launches": got}


def phase_report(tmp):
    """`apps/report helmet --render` on the card, its JSON parsed."""
    from physically_based_renderer_tpu_torch.apps import report
    out = Path(tmp) / "report.json"
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = report.main(["helmet", "--render", "--device", "cuda", "--json",
                          str(out)])
    rep = json.loads(out.read_text())
    perf, stats = rep.get("perf", {}), rep["stats"]
    if (rc != 0 or stats["triangles"] != 99_400 or stats["emitters"] != 15_600
            or stats["textures"] != 4 or not perf.get("frame_ms", 0) > 0
            or "ms/frame" not in text.getvalue()):
        raise AssertionError(f"report helmet --render: exit {rc}, {rep}")
    print(f"report helmet --render: {perf['frame_ms']:.1f} ms per warm frame, "
          f"{perf['rays_per_s']:.4g} rays/s on {perf['backend']}")
    return {"stats": stats, "perf": perf}


def cuobjdump(flag):
    """cuobjdump's `flag` listing of the built kernel library, or None
    where the toolkit has no cuobjdump."""
    import shutil

    from physically_based_renderer_tpu_torch.ops import cuda_lib
    tool = shutil.which("cuobjdump") or str(
        Path(cuda_lib._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return None
    return subprocess.run(
        [tool, flag, str(cuda_lib.build_dir() / cuda_lib.LIB_NAME)],
        capture_output=True, text=True, timeout=120, check=True).stdout


def kernel_resources():
    """Registers and local-memory (spill) bytes a thread of each K1, K2,
    K4, K5a, K5b, P1, P3-P8 instantiation, as ptxas allotted them
    (`cuobjdump -res-usage` on the built library), keyed by the mangled
    name up to its parameters: trace_blocks_kernelILb<any hit>ELi<rays a
    thread>E, resident_kernelILb<any hit>E, fused_kernel,
    gather_fwd_kernel_<route>I<index type><flat index type>E,
    gather_bwd_kernelI<index type><accumulator><column groups>E,
    probe_scalar_stack_kernel, probe_onehot_mm_kernel,
    probe_gather_kernel_<route>ILi<axis>E[Lb<vector>E],
    mosaic_gather_kernel_<route>ILi<axis>E, mosaic_scalar_stack_kernel,
    mosaic_chunk_kernel, subtile_copy_kernel_<route>, subtile_read_kernel."""
    import re

    usage = cuobjdump("-res-usage")
    if usage is None:
        print("K1/K2/K4/K5/P1/P3-P8 registers: not measured (no "
              "cuobjdump)")
        return None
    out = {}
    for name, line in re.findall(r"Function (\S+):\s*\n([^\n]*)", usage):
        short = re.search(r"(trace_blocks_kernel|resident_kernel|fused_kernel|"
                          r"gather_fwd_kernel_\w+?|gather_bwd_kernel|"
                          r"probe_scalar_stack_kernel|probe_onehot_mm_kernel|"
                          r"probe_gather_kernel_\w+?|mosaic_gather_kernel_"
                          r"\w+?|mosaic_scalar_stack_kernel|"
                          r"mosaic_chunk_kernel|subtile_copy_kernel_\w+?|"
                          r"subtile_read_kernel)"
                          r"(I\w*?E)?(?:E|v)", name)
        if short:
            res = dict(re.findall(r"(\w+):(\d+)", line))
            out[short.group(1) + (short.group(2) or "")] = {
                "registers": int(res["REG"]), "stack_bytes": int(res["STACK"]),
                "local_bytes": int(res["LOCAL"])}
    print(f"K1/K2/K4/K5/P1/P3-P8 registers a thread (cuobjdump "
          f"-res-usage) "
          f"[{card_line()}]: {out}")
    return out


def relayout_sass():
    """Shared-memory stores, loads and barriers in the SASS of P2's two
    kernels, from cuobjdump on the built library: the elementwise kernel
    has none, and the compiler kept the eleven moves of the exchange
    route's.  None where the toolkit has no cuobjdump."""
    import re

    sass = cuobjdump("-sass")
    if sass is None:
        print("P2 relayout SASS: not measured (no cuobjdump)")
        return None
    counts = {}
    for part in sass.split("Function :")[1:]:
        name = part.split("\n")[0]
        if "probe_relayout" in name:
            route = "exchange" if "exchange" in name else "elementwise"
            counts[route] = {op: len(re.findall(rf"\b{op}\b", part))
                             for op in ("STS", "LDS", "BAR")}
    print(f"P2 relayout SASS: {counts}")
    ex, no = counts["exchange"], counts["elementwise"]
    if ex["STS"] < 11 or ex["LDS"] < 11 or any(no.values()):
        raise AssertionError(f"P2 relayout SASS: {counts}")
    return counts


def phase_probes(dev):
    """P1-P4 against their plain versions at every shape of the probe tool
    (exact), and their times; then the tool itself, for the launch counts."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.ops import probes
    from physically_based_renderer_tpu_torch.tools import probe2
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    t = lambda a: torch.from_numpy(a).to(dev)
    out = {}
    errs = dict.fromkeys(("probe_scalar_stack", "probe_relayout",
                          "probe_onehot_mm", "probe_gather"), 0.0)

    def same(label, kern, plain, name):
        torch.cuda.synchronize()
        for k, p in zip(kern, plain):
            errs[name] = max(errs[name], float(
                (k.double() - p.to(k.device).double()).abs().max()))
            if not torch.equal(k, p.to(k.device)):
                raise AssertionError(f"{label}: kernel and plain version "
                                     "differ")
        print(f"{label}: equal to its plain version")

    # P1: the tool's three data sets and trees of other sizes and pass
    # rates (tools/probe2.py::tree_boxes), each equal to its plain version
    # and timed, beside an empty kernel's device time (the launch floor).
    # Bounds: the bytes (boxes in, out and leaves out), and the depth
    # chain, one shared-memory round trip a level.
    sets = {f"[{data}]": probe2.scalar_stack_boxes(data)
            for data in probe2.STACK_DATA}
    sets.update({f"[n={n} pass {rate}]": probe2.tree_boxes(n, rate)
                 for n, rate in ((5001, 1.0), (5001, 0.9), (8191, 1.0))})
    empty_ms, _ = device_ms(lambda: probes.empty_kernel(dev), 200,
                            "probe_empty_kernel")
    by_set = {}
    for label, boxes_np in sets.items():
        boxes = t(boxes_np)
        kern = probes.scalar_stack(boxes)
        visited, leaves = (int(v) for v in kern[0].cpu())
        same(f"P1 scalar_stack{label} visited={visited} leaves={leaves}",
             kern, probes.scalar_stack_plain(boxes), "probe_scalar_stack")
        n = boxes.numel() // 6
        ms, _ = device_ms(lambda: probes.scalar_stack(boxes), 100,
                          "probe_scalar_stack_kernel")
        row = by_set[label] = {
            "nodes": n, "visited": visited, "leaves": leaves, "ms": ms,
            "bound": bound(n * 24 + 8 + probes.leaf_capacity(n) * 4, 0),
            "depth_bound_ms": (n.bit_length() * SMEM_LOAD_CYCLES
                               / SM_CLOCK_HZ * 1e3)}
        print(f"P1 {label}: {n} nodes, {visited} visited, {leaves} leaves: "
              f"device {ms * 1e3:.2f} us, empty kernel {empty_ms * 1e3:.2f} "
              f"us, depth bound {row['depth_bound_ms'] * 1e3:.3f} us "
              f"({n.bit_length()} levels), byte bound "
              f"{row['bound'][0] * 1e3:.4f} us [{card_line()}]")
    boxes = t(sets["[all]"])
    call = lambda: probes.scalar_stack(boxes)
    out["probe_scalar_stack"] = {
        **by_set["[all]"], "wrapper_ms": time_ms(call, 100),
        "plain_ms": time_ms(lambda: probes.scalar_stack_plain(boxes), 3,
                            warmup=1),
        "library_ms": None, "empty_kernel_ms": empty_ms, "by_set": by_set,
        "shape": "2,047 boxes, every box passes"}

    # P2: both routes bit-equal to the plain version on the probe's tile
    # and on random tiles; the elementwise route timed beside the exchange
    # route (what moving every term across threads costs) and the empty
    # kernel.
    x = t(probe2.relayout_input())
    tiles = [x] + [t(np.random.default_rng(seed).standard_normal(
        probes.TILE).astype(np.float32) * 100) for seed in (1, 2, 3)]
    for tile in tiles:
        same("P2 relayout", tuple(probes.relayout(tile, route)
                                  for route in probes.RELAYOUT_ROUTES),
             (probes.relayout_plain(tile),) * 2, "probe_relayout")
    if not np.array_equal(probes.relayout(x).cpu().numpy(),
                          probe2.relayout_expected()):
        raise AssertionError("P2 relayout: not the probe's expectation")
    call = lambda: probes.relayout(x)
    ms, _ = device_ms(call, 200, "probe_relayout_kernel")
    moved_ms, _ = device_ms(lambda: probes.relayout(x, "exchange"), 200,
                            "probe_relayout_exchange_kernel")
    out["probe_relayout"] = {
        "ms": ms, "exchange_ms": moved_ms, "empty_kernel_ms": empty_ms,
        "wrapper_ms": time_ms(call, 200),
        "plain_ms": time_ms(lambda: probes.relayout_plain(x), 50),
        # the tile in and out; ten adds of i and ten of the accumulator
        "bound": bound(2 * x.numel() * 4, 20 * x.numel()),
        "library_ms": None, "shape": "f32[8,128], elementwise"}
    print(f"P2 relayout f32[8,128]: elementwise device {ms * 1e3:.2f} us, "
          f"exchange route (11 moves across threads) {moved_ms * 1e3:.2f} "
          f"us, empty kernel {empty_ms * 1e3:.2f} us [{card_line()}]")
    if not moved_ms > ms:
        raise AssertionError(f"P2: the exchange route ({moved_ms} ms) is no "
                             f"slower than the elementwise one ({ms} ms)")
    out["probe_relayout"]["sass"] = relayout_sass()

    # P3
    lane_np, rows_np = probe2.onehot_inputs()
    lane, rows = t(lane_np), t(rows_np)
    same("P3 onehot_mm [1024,512]x[32,512]", (probes.onehot_mm(lane, rows),),
         (probes.onehot_mm_plain(lane, rows),), "probe_onehot_mm")
    if not np.array_equal(probes.onehot_mm(lane, rows).cpu().numpy(),
                          rows_np.T[lane_np[:, 0]]):
        raise AssertionError("P3 onehot_mm: not rows.T[lane] bit for bit")
    # the product's arithmetic: NaN from 0 * inf, +0.0 from -0.0, win
    # outside the lanes
    edge = tuple(map(t, probe2.onehot_edge_inputs()))
    if not probes.same_or_both_nan(probes.onehot_mm(*edge),
                                   probes.onehot_mm_plain(*edge)):
        raise AssertionError("P3 onehot_mm on non-finite rows: not its plain "
                             "version (NaN for NaN, the rest bit for bit)")
    print("P3 onehot_mm on rows with +-0.0, inf, -inf and NaN: NaN where its "
          "plain version is, every other value bit for bit")
    call = lambda: probes.onehot_mm(lane, rows)
    ms, _ = device_ms(call, 200, "probe_onehot_mm_kernel")
    edge_ms, _ = device_ms(lambda: probes.onehot_mm(*edge), 200,
                           "probe_onehot_mm_kernel")
    onehot = (torch.arange(rows.shape[1], device=dev)[None, :]
              == lane).to(torch.float32)
    rows_t = rows.t().contiguous()
    flat_lane = lane[:, 0]
    n_out = lane.shape[0] * rows.shape[0]
    out["probe_onehot_mm"] = {
        "ms": ms, "edge_ms": edge_ms, "wrapper_ms": time_ms(call, 200),
        "plain_ms": time_ms(lambda: probes.onehot_mm_plain(lane, rows), 20),
        # the function is a gather: win and the rows read once, the output
        # written once; the product the parent computed needed 2 N R L
        # operations
        "bound": bound((lane.numel() + rows.numel() + n_out) * 4, 0),
        "bound_product": bound(0, n_out * rows.shape[1] * 2),
        "empty_kernel_ms": empty_ms,
        # the same function as one library call each way: the product of
        # the materialised one-hot, and a direct row gather
        "library_ms": time_ms(lambda: torch.matmul(onehot, rows_t), 200),
        "library_index_select_ms": time_ms(
            lambda: torch.index_select(rows_t, 0, flat_lane), 200),
        "shape": "i32[1024,1], f32[32,512]"}
    e = out["probe_onehot_mm"]
    print(f"P3 onehot_mm [1024,512]x[32,512]: device {ms * 1e3:.2f} us (edge "
          f"data {edge_ms * 1e3:.2f} us), byte bound "
          f"{e['bound'][0] * 1e3:.4f} us, empty kernel {empty_ms * 1e3:.2f} "
          f"us, the product's operations bound "
          f"{e['bound_product'][0] * 1e3:.3f} us, torch.matmul "
          f"{e['library_ms'] * 1e3:.2f} us, index_select "
          f"{e['library_index_select_ms'] * 1e3:.2f} us [{card_line()}]")

    # P4: every shape of the tool, on its data and with -0.0 in x and
    # indices outside the axis; each timed with its route.  The kernels
    # line carries gather_tex.
    gathers = {}
    for tag, (n_rows, lanes, axis) in probe2.GATHER_SHAPES.items():
        x_np, idx_np = probe2.gather_inputs(n_rows, lanes, axis)
        xg, idx = t(x_np), t(idx_np)
        got = probes.gather(xg, idx, axis)
        same(f"P4 {tag} [{n_rows},{lanes}] axis={axis}", (got,),
             (probes.gather_plain(xg, idx, axis),), "probe_gather")
        if not np.array_equal(got.cpu().numpy(), np.take_along_axis(
                x_np, idx_np, axis=axis)):
            raise AssertionError(f"P4 {tag}: not take_along_axis")
        edge = tuple(map(t, probe2.gather_edge_inputs(n_rows, lanes, axis)))
        if not probes.same_bits(probes.gather(*edge, axis),
                                probes.gather_plain(*edge, axis)):
            raise AssertionError(f"P4 {tag} with -0.0 and indices outside "
                                 "the axis: not its plain version bit for "
                                 "bit")
        call = lambda: probes.gather(xg, idx, axis)
        idx64 = idx.long()
        ms, _ = device_ms(call, 100, "probe_gather_kernel")
        lib_ms, _ = device_ms(lambda: torch.gather(xg, axis, idx64), 100,
                              None)
        gathers[tag] = {
            "ms": ms, "wrapper_ms": time_ms(call, 100),
            "plain_ms": time_ms(lambda: probes.gather_plain(xg, idx, axis),
                                20),
            "bound": bound(3 * xg.numel() * 4, 0),
            "library_ms": time_ms(lambda: torch.gather(xg, axis, idx64), 100),
            "library_device_ms": lib_ms,
            "route": probes.gather_plan(n_rows, lanes, axis).route,
            "shape": f"[{n_rows},{lanes}] axis {axis}"}
        g = gathers[tag]
        print(f"P4 {tag} [{n_rows},{lanes}] axis {axis} ({g['route']}): "
              f"device {ms * 1e3:.2f} us, byte bound "
              f"{g['bound'][0] * 1e3:.3f} us ({ms / g['bound'][0]:.2f}x), "
              f"torch.gather device {lib_ms * 1e3:.2f} us [{card_line()}]")
    # The random-sector read ceiling under gather_tex: its 2,097,152 reads
    # at random rows of an 8 MiB table, each address precomputed (row * 128
    # + column), four a thread from one int4, no clamp and no output row.
    n_rows, lanes, _ = probe2.GATHER_SHAPES["gather_tex"]
    x_np, idx_np = probe2.gather_inputs(n_rows, lanes, 0)
    table = t(x_np)
    addr = t((idx_np * lanes + np.arange(lanes)[None, :]).astype(
        np.int32).reshape(-1))
    if not torch.equal(probes.sector_read(table, addr),
                       probes.sector_read_plain(table, addr)):
        raise AssertionError("the sector-read kernel differs from its plain "
                             "version")
    ceiling_ms, _ = device_ms(lambda: probes.sector_read(table, addr), 100,
                              "probe_sector_read_kernel")
    out["probe_gather"] = {**gathers["gather_tex"], "by_shape": gathers,
                           "sector_ceiling_ms": ceiling_ms,
                           "sector_reads_per_s": addr.numel() / ceiling_ms
                           * 1e3}
    print(f"P4 random-sector read ceiling: {addr.numel()} reads at random "
          f"rows of [{n_rows},{lanes}] f32 in {ceiling_ms * 1e3:.2f} us "
          f"({addr.numel() / ceiling_ms / 1e6:.1f} G sectors/s, "
          f"{addr.numel() * 32 / ceiling_ms / 1e9:.2f} TB/s of 32-byte "
          f"sectors); gather_tex {gathers['gather_tex']['ms'] * 1e3:.2f} us "
          f"[{card_line()}]")
    for name, e in out.items():
        e["max_abs_err"] = errs[name]
        print(f"{name} ({e['shape']}): device {e['ms'] * 1e3:.2f} us, wrapper "
              f"{e['wrapper_ms'] * 1e3:.2f} us, plain "
              f"{e['plain_ms'] * 1e3:.2f} us, bound "
              f"{e['bound'][0] * 1e3:.3f} us ({e['bound'][1]}), library "
              f"{e['library_ms']}")

    # The tool's own run: every probe through its entry point; its launches
    # are the ones the kernels line reports.
    probes.reset_launches()
    tool = probe2.run("all", dev, iters=50)
    flat = [r for res in tool.values()
            for r in (res.values() if "ok" not in res else (res,))]
    if not all(r["ok"] for r in flat):
        raise AssertionError(f"probe tool: {tool}")
    counts = {k: probes.LAUNCHES[k] for k in (
        "scalar_stack", "relayout", "onehot_mm", "gather")}
    if not all(counts.values()):
        raise AssertionError(f"probe tool launched {counts}")
    return out, counts, tool


def phase_mosaic(dev):
    """P5-P8 against their plain versions at every shape of their tools
    (bit for bit), their times and bounds; P8 on both routes beside its
    every-copy read ceiling and a two-call yardstick; then the two tools
    themselves, for the launch counts."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.ops import probes
    from physically_based_renderer_tpu_torch.tools import (exp_subtile_dma,
                                                           probe2,
                                                           probe_mosaic)
    from physically_based_renderer_tpu_torch.tools.timing import device_ms

    t = lambda a: torch.from_numpy(a).to(dev)
    out = {}

    empty_ms, _ = device_ms(lambda: probes.empty_kernel(dev), 200,
                            "probe_empty_kernel")

    # P5: every shape of the tool on its own data (against the plain
    # version and the probe's numpy check) and on random floats with
    # indices in [-3 size, 3 size); then GATHER_EXTRA (reps 0 and 1, the
    # direct route, rows and lanes not multiples of 4) on random floats.
    # Each is timed beside its plan, the L2 bytes the plan moves, its bound
    # and an empty kernel.  The kernels line carries the largest table at
    # reps 1, [1024, 512] axis 0 (2 MB), where torch.gather computes the
    # same function: its ms, bound and library_ms are of one call.
    shapes = {}
    p5_err = 0.0

    def p5_case(rows, lanes, axis, reps, x_np, idx_np, probe_check):
        nonlocal p5_err
        x, idx = t(x_np), t(idx_np)
        got = probes.mosaic_gather(x, idx, axis, reps)
        want = probes.mosaic_gather_plain(x, idx, axis, reps)
        torch.cuda.synchronize()
        p5_err = max(p5_err, float((got - want).abs().max()))
        if not torch.equal(got, want) or (probe_check and not np.array_equal(
                got.cpu().numpy(), probe_mosaic.gather_expected(
                    x_np, idx_np, axis, reps))):
            raise AssertionError(f"P5 [{rows},{lanes}] axis {axis} x{reps}: "
                                 "kernel, plain version and the probe's "
                                 "check differ")
        return x, idx

    for rows, lanes, axis, reps, _ in probe_mosaic.GATHER_CASES:
        p5_case(rows, lanes, axis, reps,
                *probe_mosaic.gather_random_inputs(rows, lanes, axis), False)
    for rows, lanes, axis, reps in (
            *(c[:4] for c in probe_mosaic.GATHER_CASES),
            *probe_mosaic.GATHER_EXTRA):
        probe_data = (rows, lanes, axis, reps) in (
            c[:4] for c in probe_mosaic.GATHER_CASES)
        x, idx = p5_case(rows, lanes, axis, reps, *(
            probe_mosaic.gather_inputs(rows, lanes, axis) if probe_data
            else probe_mosaic.gather_random_inputs(rows, lanes, axis)),
            probe_data)
        call = lambda: probes.mosaic_gather(x, idx, axis, reps)
        ms, _ = device_ms(call, 100, "mosaic_gather_kernel")
        plan = probes.mosaic_gather_plan(rows, lanes, axis, reps)
        l2 = probes.mosaic_gather_l2_bytes(plan, rows, lanes, axis, reps)
        row = shapes[f"{rows}x{lanes}_axis{axis}_x{reps}"] = {
            "ms": ms, "wrapper_ms": time_ms(call, 100),
            "plain_ms": time_ms(lambda: probes.mosaic_gather_plain(
                x, idx, axis, reps), 10),
            # table, indices and output once; reps adds an element
            "bound": bound(3 * x.numel() * 4, reps * x.numel()),
            "library_ms": None, "plan": dataclasses.asdict(plan),
            "l2_bytes": l2, "empty_kernel_ms": empty_ms,
            "data": "probe" if probe_data else "random",
            "shape": f"[{rows},{lanes}] axis {axis} x{reps}"}
        print(f"P5 [{rows},{lanes}] axis={axis} x{reps} ({row['data']} "
              f"data): equal to its plain version, device {ms * 1e3:.2f} "
              f"us, bound {row['bound'][0] * 1e3:.3f} us "
              f"({row['bound'][1]}), L2 {l2['total']} B (x: "
              f"{l2['stage']} B), empty kernel {empty_ms * 1e3:.2f} us, "
              f"plan {probe_mosaic.plan_text(rows, lanes, axis, reps)} "
              f"[{card_line()}]")

    # P5 at reps = 1 is torch.gather: both on the probe's data (indices in
    # range), the int64 index made outside the timed call.
    library = {}
    for rows, lanes, axis in ((1024, 512, 0), (4096, 128, 0),
                              (256, 512, 1)):
        x_np, idx_np = probe_mosaic.gather_inputs(rows, lanes, axis)
        x, idx = t(x_np), t(idx_np)
        idx64 = idx.long()
        got = probes.mosaic_gather(x, idx, axis, 1)
        if not torch.equal(got, torch.gather(x, axis, idx64)):
            raise AssertionError(f"P5 [{rows},{lanes}] axis {axis} x1 is "
                                 "not torch.gather")
        call = lambda: probes.mosaic_gather(x, idx, axis, 1)
        ms, _ = device_ms(call, 100, "mosaic_gather_kernel")
        lib_ms, _ = device_ms(lambda: torch.gather(x, axis, idx64), 100,
                              None)
        row = library[f"{rows}x{lanes}_axis{axis}"] = {
            "ms": ms, "library_ms": lib_ms, "wrapper_ms": time_ms(call, 100),
            "plain_ms": time_ms(lambda: probes.mosaic_gather_plain(
                x, idx, axis, 1), 10),
            "bound": bound(3 * x.numel() * 4, x.numel()),
            "shape": f"[{rows},{lanes}] axis {axis} x1"}
        print(f"P5 [{rows},{lanes}] axis={axis} x1: device {ms * 1e3:.2f} "
              f"us, torch.gather device {lib_ms * 1e3:.2f} us, bound "
              f"{row['bound'][0] * 1e3:.3f} us [{card_line()}]")
    out["probe_mosaic_gather"] = {
        **library["1024x512_axis0"], "by_shape": shapes,
        "max_abs_err": p5_err, "reps1": library,
        "library": "torch.gather (device time), the same call"}

    # P6: the three data sets of P1 and 8,191 nodes that all pass, each
    # equal to its plain version and timed beside an empty kernel, its
    # byte bound and P1's depth bound (one shared-memory round trip a
    # level).  The count needs the inner nodes alone (a leaf's test never
    # changes it), so both bounds are the inner tree's: (n - 1) / 2 boxes
    # and their levels.
    sets = {f"[{data}]": probe2.scalar_stack_boxes(data)
            for data in probe2.STACK_DATA}
    sets["[n=8191 pass 1.0]"] = probe2.tree_boxes(8191, 1.0)
    by_set = {}
    p6_err = 0
    for label, boxes_np in sets.items():
        boxes = t(boxes_np)
        got = probes.mosaic_scalar_stack(boxes)
        want = probes.mosaic_scalar_stack_plain(boxes)
        torch.cuda.synchronize()
        p6_err = max(p6_err, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"P6 {label}: kernel and plain differ")
        n = boxes.numel() // 6
        inner = (n - 1) // 2
        levels = max(1, inner.bit_length())
        ms, _ = device_ms(lambda: probes.mosaic_scalar_stack(boxes), 100,
                          "mosaic_scalar_stack_kernel")
        row = by_set[label] = {
            "nodes": n, "inner_nodes": inner, "visited": int(got[0]),
            "ms": ms, "bound": bound(inner * 24 + 4, 0),
            "latency_bound_ms": (levels * SMEM_LOAD_CYCLES
                                 / SM_CLOCK_HZ * 1e3)}
        print(f"P6 scalar_stack{label}: {n} nodes, visited {row['visited']}, "
              f"equal to its plain version, device {ms * 1e3:.2f} us, empty "
              f"kernel {empty_ms * 1e3:.2f} us, depth bound "
              f"{row['latency_bound_ms'] * 1e3:.3f} us ({levels} levels of "
              f"{inner} inner nodes), byte bound {row['bound'][0] * 1e3:.4f} "
              f"us [{card_line()}]")
    boxes = t(sets["[all]"])
    call = lambda: probes.mosaic_scalar_stack(boxes)
    out["probe_mosaic_stack"] = {
        **by_set["[all]"], "wrapper_ms": time_ms(call, 100),
        "plain_ms": time_ms(lambda: probes.mosaic_scalar_stack_plain(boxes),
                            3, warmup=1),
        "library_ms": None, "empty_kernel_ms": empty_ms, "by_set": by_set,
        "max_abs_err": p6_err, "shape": "2,047 boxes, every box passes"}

    # P7: the probe's data (all ones: every test masked), random data where
    # the mask passes and the edge data (dets about +-1e-9, at and above
    # 2^126, inf and NaN in t), each bit-equal to its plain version and
    # timed beside the empty kernel; the kernels line carries the random
    # data's time.
    b, w, n_chunks = probe_mosaic.CHUNK
    p7_err = 0.0
    p7_sets = {}
    # per test 10 float operations (px 1, det 2, 1/det 1, u 1, v 2, t 2,
    # u + v 1); per chunk and column 4 more for e0 and e1; reads o's row 0
    # and t's rows 0-1, writes b floats
    p7_bound = bound((2 * b + 2 * w) * 4, n_chunks * (b * w * 10 + w * 4))
    for data in probe_mosaic.CHUNK_DATA:
        o_np, t_np = probe_mosaic.chunk_inputs(data)
        o, tt = t(o_np), t(t_np)
        got = probes.chunk(o, tt, n_chunks)
        torch.cuda.synchronize()
        want = probes.chunk_plain(o.cpu(), tt.cpu(), n_chunks)
        p7_err = max(p7_err, float((got.cpu() - want).abs().max()))
        if not probes.same_bits(got.cpu(), want):
            raise AssertionError(f"P7 [{data}]: kernel and plain differ")
        ms, _ = device_ms(lambda: probes.chunk(o, tt, n_chunks), 200,
                          "mosaic_chunk_kernel")
        hits = int((want < 1e30).sum())
        p7_sets[data] = {"ms": ms, "hits": hits}
        print(f"P7 chunk[{data}]: bit-equal to its plain version, {hits} "
              f"of {b} rays hit, device {ms * 1e3:.2f} us, empty kernel "
              f"{empty_ms * 1e3:.2f} us, operations bound "
              f"{p7_bound[0] * 1e3:.3f} us [{card_line()}]")
    # The random data at 4 chunks and at none: the kernel's cost without
    # a test, and a chunk's.
    o, tt = (t(a) for a in probe_mosaic.chunk_inputs("random"))
    for k in (4, 0):
        got = probes.chunk(o, tt, k)
        if not probes.same_bits(got.cpu(), probes.chunk_plain(
                o.cpu(), tt.cpu(), k)):
            raise AssertionError(f"P7 [random] x{k}: kernel and plain differ")
        ms, _ = device_ms(lambda: probes.chunk(o, tt, k), 200,
                          "mosaic_chunk_kernel")
        p7_sets[f"random x{k}"] = {"ms": ms, "hits": int((got < 1e30).sum())}
        print(f"P7 chunk[random] at {k} chunks: device {ms * 1e3:.2f} us "
              f"[{card_line()}]")
    call = lambda: probes.chunk(o, tt, n_chunks)
    ms = p7_sets["random"]["ms"]
    out["probe_chunk"] = {
        "ms": ms, "wrapper_ms": time_ms(call, 200),
        "plain_ms": time_ms(lambda: probes.chunk_plain(o, tt, n_chunks), 10),
        "bound": p7_bound, "library_ms": None,
        "empty_kernel_ms": empty_ms,
        "ratio_to_floor": ms / max(p7_bound[0], empty_ms),
        "us_per_chunk": ms * 1e3 / n_chunks, "by_set": p7_sets,
        "max_abs_err": p7_err,
        "shape": f"{b} rays x {w} columns x {n_chunks} chunks"}

    # P8 at the tool's shape: each route bit-equal to the plain version,
    # the route rule's (each tile's rows summed once, then gathered) also
    # within the reference's host check; each timed per call over all of
    # its kernels (one launch either route) beside the direct route (the
    # parent's kernel, unchanged), the every-copy read ceiling under it
    # (`subtile_read`: the same 67.1 MB of copies in the same order, no
    # float arithmetic) and, as a yardstick of two PyTorch calls (no one
    # call computes the function), src.sum(1) then embedding_bag.
    src_np, idx_np = exp_subtile_dma.inputs(0)
    src, idx = t(src_np), t(idx_np)
    nb, ni, ch = exp_subtile_dma.NB, exp_subtile_dma.NI, exp_subtile_dma.CH
    plain = probes.subtile_copy_plain(src, idx, ni, ch)
    route_rule = probes.subtile_copy_route
    route = route_rule(src.shape[0], idx.numel())
    call = lambda: probes.subtile_copy(src, idx, ni, ch)
    p8_routes = {}
    p8_err = 0.0
    for r in ("row_sums", "direct"):
        probes.subtile_copy_route = lambda *_, r=r: r
        try:
            got = call()
            torch.cuda.synchronize()
            p8_err = max(p8_err, float((got - plain).abs().max()))
            if not probes.same_bits(got, plain):
                raise AssertionError(f"P8 {r}: kernel and plain differ")
            ms, _ = device_ms(call, 100, "subtile_copy_kernel")
            p8_routes[r] = {"ms": ms, "wrapper_ms": time_ms(call, 100)}
        finally:
            probes.subtile_copy_route = route_rule
    got = call()
    ok_ref = np.allclose(got.cpu().numpy()[:, 0], exp_subtile_dma.expected(
        src_np, idx_np, nb), rtol=exp_subtile_dma.REF_RTOL)
    if not ok_ref:
        raise AssertionError("P8: the reference's host check fails")
    read = probes.subtile_read(src, idx, ni, ch)
    torch.cuda.synchronize()
    if not torch.equal(read, probes.subtile_read_plain(src, idx, ni, ch)):
        raise AssertionError("P8's copy read ceiling and its plain differ")
    ceiling_ms, _ = device_ms(lambda: probes.subtile_read(src, idx, ni, ch),
                              100, "subtile_read_kernel")
    bags = idx.long().reshape(nb, ni, ch).transpose(1, 2).reshape(
        nb * ch, ni).contiguous()
    yardstick = lambda: torch.nn.functional.embedding_bag(
        bags, src.sum(1), mode="sum").reshape(nb, 1, ch * 32)
    yard_rel = float(((yardstick() - plain).abs() / plain.abs()).max())
    yard_ms, _ = device_ms(yardstick, 100, None)
    n_copies = idx.numel()
    distinct = int(torch.unique(idx).numel())
    small = idx.numel() * 4 + got.numel() * 4
    copy_bytes = n_copies * exp_subtile_dma.TILE_BYTES
    ms = p8_routes[route]["ms"]
    out["subtile_dma"] = {
        "ms": ms, "wrapper_ms": p8_routes[route]["wrapper_ms"],
        "route": route, "routes": p8_routes,
        "plain_ms": time_ms(lambda: probes.subtile_copy_plain(
            src, idx, ni, ch), 10),
        # each distinct tile read once (the table's 8.4 MB fits in L2), the
        # indices and the output; beside it every copy from device memory;
        # 16 adds per output lane a step
        "bound": bound(distinct * exp_subtile_dma.TILE_BYTES + small,
                       n_copies * 32 * 16),
        "bound_all_copies": bound(copy_bytes + small, n_copies * 32 * 16),
        "copy_ceiling_ms": ceiling_ms,
        "copy_ceiling_tb_per_s": copy_bytes / ceiling_ms / 1e9,
        "distinct_tiles": distinct, "max_abs_err": p8_err,
        "library_ms": None, "yardstick_ms": yard_ms,
        "yardstick": "src.sum(1) then embedding_bag(mode='sum'), device "
                     "time of both calls",
        "yardstick_max_rel": yard_rel,
        "shape": f"{nb} x {ni} x {ch} copies of 2 KB"}
    e = out["subtile_dma"]
    print(f"P8 subtile copy ({nb} x {ni} x {ch} copies of 2 KB): bit-equal "
          f"to its plain version on both routes, the reference's check "
          f"holds; {route} (the route rule's) device "
          f"{ms * 1e3:.2f} us, direct {p8_routes['direct']['ms'] * 1e3:.2f} "
          f"us, every-copy read ceiling {ceiling_ms * 1e3:.2f} us "
          f"({e['copy_ceiling_tb_per_s']:.2f} TB/s of {copy_bytes} B), "
          f"byte bound {e['bound'][0] * 1e3:.3f} us ({distinct} distinct "
          f"tiles; {e['bound_all_copies'][0] * 1e3:.3f} us every copy), "
          f"yardstick src.sum(1) + embedding_bag {yard_ms * 1e3:.2f} us "
          f"(max rel diff {yard_rel:.3g}) [{card_line()}]")
    for name, e in out.items():
        print(f"{name} ({e['shape']}): device {e['ms'] * 1e3:.2f} us, wrapper "
              f"{e['wrapper_ms'] * 1e3:.2f} us, plain "
              f"{e['plain_ms'] * 1e3:.2f} us, bound "
              f"{e['bound'][0] * 1e3:.3f} us ({e['bound'][1]}), library "
              f"{e['library_ms']} [{card_line()}]")

    # The tools' own runs: every shape through their entry points; their
    # launches are the ones the kernels line reports.
    probes.reset_launches()
    if probe_mosaic.main(["--device", "cuda", "--iters", "20"]) != 0:
        raise AssertionError("probe_mosaic tool failed")
    if exp_subtile_dma.main(["--device", "cuda", "--iters", "20"]) != 0:
        raise AssertionError("exp_subtile_dma tool failed")
    counts = {k: probes.LAUNCHES[k] for k in (
        "mosaic_gather", "mosaic_scalar_stack", "chunk", "subtile_copy")}
    if not all(counts.values()):
        raise AssertionError(f"the P5-P8 tools launched {counts}")
    return out, counts


def _grads(params):
    return {k: v.grad.detach().clone() for k, v in params.items()}


def phase_sharded(dev, tmp, counters):
    """parallel/ on one card: a world of one NCCL rank (FileStore).  The
    sharded helmet frame, the 1x1 2-D render, the ring render and four row
    bands without the direction sort against render() bit for bit, four
    with it against render()'s film mean; the sharded train step against the
    plain one; --tiles 1 through both CLIs; what the sharded program costs
    over the plain one.  At a world of one the NCCL broadcast, all-gather
    and all-reduces run, each over one rank; the ring's send and receive
    do not (the shift is the identity).  One card: scaling over several
    GPUs is not measured."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from physically_based_renderer_tpu_torch.apps import render as render_app
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.grad import inverse as pinv
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.parallel import sharding
    from physically_based_renderer_tpu_torch.utils import config

    def counted(fn):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        res = fn()
        torch.cuda.synchronize()
        return res, {k: getattr(mod, attr)
                     for k, (mod, attr) in counters.items()}

    out = {}
    dist.init_process_group("nccl", store=dist.FileStore(
        str(Path(tmp) / "nccl_store"), 1), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(1)
        mesh2 = sharding.make_mesh_2d(1, 1)
        bc = config.get("helmet")
        cfg = bc.render
        scene, cam = config.build_scene(bc.scene, dev)
        scene = sharding.replicate_scene(scene, mesh)
        key = rng_mod.key(0, dev)

        # The sharded helmet frame is a main path: its launches.
        film, got = counted(lambda: sharding.render_sharded(
            scene, cam, key, cfg, mesh))
        want = dict(EXPECTED_LAUNCHES["helmet"], tonemap=0)
        if got != want:
            raise AssertionError(f"sharded helmet launches {got}, expected "
                                 f"{want}")
        sharded = film.mean()
        plain = path.render(scene, cam, key, cfg).mean()
        two_d = sharding.render_sharded_2d(scene, cam, key, cfg,
                                           mesh2).mean()
        k0 = rng_mod.split(key, cfg.spp)[0]
        one = path.render_sample(scene, cam, k0, cfg)
        ring = sharding.render_sample_sharded(scene, cam, k0, cfg, mesh,
                                              exchange=True)
        # Bands below full height on the card, as ranks of a larger world
        # render them: four 128-row bands, stacked.  Without the direction
        # sort a band of whole 16-row tile rows blocks its rays as the full
        # frame does (whole morton tiles), so the bands equal the frame bit
        # for bit.  With it (the
        # config's `resort`) bounce and shadow rays are blocked by
        # direction among the band's rays only, and which rays share a
        # block decides K1's candidate list (the nearest `max_u` clusters
        # of the block) and its exact-t ties: those pixels may differ, so
        # they are counted and the film mean is held to the repo's 0.5%.
        keys = rng_mod.split(key, cfg.spp)

        def four_bands(c):
            rows = c.height // 4
            return torch.cat([path.render_band(
                scene, cam, keys, c, row_start=r * rows, n_rows=rows)[0].mean()
                for r in range(4)])
        unsorted = dataclasses.replace(cfg, resort=False)
        plain_unsorted = path.render(scene, cam, key, unsorted).mean()
        bands_unsorted = four_bands(unsorted)
        bands_sorted = four_bands(cfg)
        err = (bands_sorted - plain).abs()
        within = float((err <= 1e-4 + 1e-3 * plain.abs()).all(-1).float()
                       .mean())
        mean_rel = float((bands_sorted.mean() - plain.mean()).abs()
                         / plain.mean())
        out["bands_sorted"] = {
            "pixels_differing": int((err.amax(-1) > 0).sum()),
            "pixels_within_tol": within, "mean_rel": mean_rel,
            "max_abs_err": float(err.max())}
        print(f"helmet four row bands with the direction sort [{card_line()}]"
              f": {out['bands_sorted']['pixels_differing']} of "
              f"{cfg.height * cfg.width} pixels differ from render() "
              f"({within:.6f} within 1e-4 + 1e-3|ref|), film mean "
              f"{mean_rel:.3g} relative, max |diff| {float(err.max()):.4g}")
        if not (torch.isfinite(bands_sorted).all() and mean_rel <= 5e-3):
            raise AssertionError(f"helmet bands with the sort: {out}")
        for label, a, b in (("render_sharded", sharded, plain),
                            ("render_sharded_2d 1x1", two_d, plain),
                            ("ring render (one sample)", ring, one),
                            ("four row bands without the direction sort",
                             bands_unsorted, plain_unsorted)):
            if not torch.equal(a, b):
                raise AssertionError(f"helmet {label} differs from render()")
            print(f"helmet {cfg.width}x{cfg.height} {label}: equal to the "
                  "unsharded render bit for bit")
        mean = float(sharded.mean())
        lo, hi = FILM_MEAN_BAND["helmet"]
        if (sharded.shape != (cfg.height, cfg.width, 3)
                or not lo <= mean <= hi):
            raise AssertionError(f"sharded helmet film {tuple(sharded.shape)}"
                                 f" mean {mean}")
        out["helmet_launches"] = got
        out["helmet_film_mean"] = mean

        # What the sharded program costs: frames in turns plain, sharded,
        # sharded, plain (host clock, each ending in a sync).
        def frame(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        plain_fn = lambda: path.render(scene, cam, key, cfg)
        sharded_fn = lambda: sharding.render_sharded(scene, cam, key, cfg,
                                                     mesh)
        order = [("plain", plain_fn), ("sharded", sharded_fn),
                 ("sharded", sharded_fn), ("plain", plain_fn)] * 2
        times = {"plain": [], "sharded": []}
        for name, fn in order:
            times[name].append(frame(fn))
        out["helmet_frame_s"] = times
        print(f"helmet frame [{card_line()}], plain render() {times['plain']} s, "
              f"render_sharded on one rank {times['sharded']} s (median "
              f"{np.median(times['sharded']) / np.median(times['plain']):.3f}"
              "x); one card: scaling over GPUs not measured")

        # The sharded train step against the plain one: cornell at full
        # size, four material fields.  The forward is deterministic, so the
        # losses are equal bit for bit; K5b adds with atomics in an order
        # that changes from run to run, so the gradients are held to
        # K5B_REL * max|g|, beside the plain step's own run-to-run spread.
        c = GRAD_CLI
        gc = config.get("cornell")
        cscene, ccam = config.build_scene(gc.scene, dev)
        ccfg = dataclasses.replace(gc.render, width=c["size"],
                                   height=c["size"], spp=c["spp"],
                                   max_bounces=c["bounces"])
        target = path.render(cscene, ccam, rng_mod.key(9999, dev),
                             dataclasses.replace(ccfg, spp=8)).mean()

        def one_step(m):
            params = pinv.trainable_copy(pinv.TrainableParams.from_scene(
                cscene, base_color=True, roughness=True, metallic=True,
                emissive=True))
            opt = torch.optim.Adam(params.leaves(), lr=5e-2)
            step = pinv.make_train_step(cscene, ccam, ccfg, opt, mesh=m)
            _, _, loss = step(params, None, rng_mod.key(7, dev), target)
            return loss, _grads(params)

        (loss_s, g_s), got = counted(lambda: one_step(mesh))
        per_render = c["spp"] * (2 * c["bounces"] + 1)
        want = {k: 0 for k in got}
        want.update(resident=per_render, gather_fwd=per_render,
                    gather_bwd=per_render)
        if got != want:
            raise AssertionError(f"sharded step launches {got}, expected "
                                 f"{want}")
        loss_p, g_p = one_step(None)
        loss_q, g_q = one_step(None)
        rel = {k: float((g_s[k] - g_p[k]).abs().max()
                        / g_p[k].abs().max().clamp_min(1e-30)) for k in g_p}
        spread = {k: float((g_q[k] - g_p[k]).abs().max()
                           / g_p[k].abs().max().clamp_min(1e-30))
                  for k in g_p}
        if not torch.equal(loss_s, loss_p) or max(rel.values()) > K5B_REL:
            raise AssertionError(f"sharded step: loss {float(loss_s)} vs "
                                 f"{float(loss_p)}, gradients rel {rel}")
        print(f"sharded step [{card_line()}] cornell {c['size']}x{c['size']} "
              f"x {c['spp']} spp "
              f"x {c['bounces']} bounces on one rank: loss equal bit for bit "
              f"({float(loss_s):.6g}), gradients within {rel} of max|g| "
              f"(the plain step against itself: {spread}); launches {got}")
        out["step"] = {"loss": float(loss_s), "grad_rel": rel,
                       "plain_run_to_run_rel": spread, "launches": got}

        # --tiles 1 through both CLIs, inside this world.
        hdr_path = Path(tmp) / "tiles1.npy"
        stats, got = counted(lambda: run_cli(
            ["cornell", "-o", str(Path(tmp) / "tiles1.png"), "--hdr-output",
             str(hdr_path), "--stats", "--device", "cuda", "--tiles", "1"]))
        dense = path.render(cscene, ccam, rng_mod.key(0, dev), gc.render)
        if not np.array_equal(np.load(hdr_path), dense.mean().cpu().numpy()):
            raise AssertionError("render CLI --tiles 1 differs from render()")
        if got["resident"] != 36 or got["tonemap"] != 1 or got["fused"]:
            raise AssertionError(f"render CLI --tiles 1 launches {got}")
        print(f"render CLI cornell --tiles 1 [{card_line()}]: equal to "
              "render() bit for bit, "
              f"{stats['seconds']:.3f} s, {stats['rays']} ray queries, "
              f"launches {got}")
        rep, got_inv = counted(lambda: run_inverse_cli(
            ["--scene", "cornell", "--steps", "4", "--tiles", "1",
             "--checkpoint-dir", str(Path(tmp) / "ckpt_tiles"),
             "--checkpoint-every", "2"], tmp, "inverse_tiles1"))
        if rep["tiles"] != 1 or not np.isfinite(rep["final_loss"]):
            raise AssertionError(f"inverse CLI --tiles 1: {rep}")
        print(f"inverse CLI --tiles 1 [{card_line()}]: 4 steps, final loss "
              f"{rep['final_loss']:.6g}, launches {got_inv}")
        out["cli_tiles1"] = {"render_stats": stats, "render_launches": got,
                             "inverse_final_loss": rep["final_loss"],
                             "inverse_launches": got_inv}
    finally:
        dist.destroy_process_group()
    return out


def helmet_trace_calls(scene, cam, cfg, dev):
    """Phase 15's trace calls on `helmet` (262,144 rays each): 512x512
    morton camera rays (as phase_k1), env and emitter shadow rays and
    bounce rays from the scene's camera hits.  ({label: (o, d, t_min,
    t_max, sort, any_hit)}, the ray count)."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import morton
    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.integrator.shading import (
        shade_surface)
    from physically_based_renderer_tpu_torch.models import lights

    rng = np.random.default_rng(2)
    w, h = cfg.width, cfg.height
    pix = torch.from_numpy(morton.morton_pixel_ids(h, w)).to(dev).long()
    keys = rng_mod.ray_keys(rng_mod.key(0, dev), pix)
    o_cam, d_cam, _ = path.camera_rays(scene, cam, cfg, pix, keys)
    n = o_cam.shape[0]
    hit = path.closest_hit(scene, o_cam, d_cam, 0.0, cfg)
    active = ~hit.miss
    sp = shade_surface(scene, hit, o_cam, d_cam)
    o_b = (sp.pos + sp.ng * cfg.ray_eps).contiguous()
    u2 = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    es = lights.sample_env(scene, n, u2)
    t_sh = torch.where(active & es.valid, es.dist * (1.0 - 1e-3), 0.0)
    u3 = torch.from_numpy(rng.random((n, 3)).astype(np.float32)).to(dev)
    ls = lights.sample_area_emitters(scene, sp.pos, u3[:, 0], u3[:, 1:],
                                     emitter_attrs=lights.pack_emitter_attrs(
                                         scene))
    t_em = torch.where(active & ls.valid, ls.dist * (1.0 - 1e-3), 0.0)
    jitter = torch.nn.functional.normalize(torch.from_numpy(rng.normal(
        size=(n, 3)).astype(np.float32)).to(dev), dim=-1)
    d_bounce = torch.nn.functional.normalize(sp.ng + jitter, dim=-1)
    calls = {"camera closest": (o_cam, d_cam, 0.0, 1e30, False, False),
             "env shadow any-hit": (o_b, es.wi, cfg.ray_eps, t_sh, True,
                                    True),
             "emitter shadow any-hit": (o_b, ls.wi, cfg.ray_eps, t_em, True,
                                        True),
             "bounce closest": (o_b, d_bounce, 1e-3,
                                torch.where(active, 1e30, 0.0), True, False)}
    return calls, n


def phase_k32(dev, counters):
    """Phase 15: the k = 32 sub-cluster route.  `helmet` built with
    SceneSpec.cluster_k = 32 (set-up timed: the cluster builder and the
    soup), rendered through render_with_stats at its config (512x512, 4
    spp, 3 bounces, B = 512, max_u 48, chunk 4), cold then warm, the counts
    reset just before the cold frame; that frame beside the K = 128 frame
    and the BVH walk at the same key (pixels that differ, film means, ray
    counts: measured, not held; phase A's truncation is the reference's
    own).  K1 at K = 32 on the camera closest-hit, env shadow and emitter
    shadow calls of 262,144 rays, each equal to its plain version on every
    winner, t and mask, timed beside its work-counted bound, and the same
    calls on the same rays through the K = 128 grid.  Then helmet_proc at
    K = 32 with chunk 16 and max_u 96 (phase_k1)."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import blocktrace, traverse
    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    from physically_based_renderer_tpu_torch.scene import types
    from physically_based_renderer_tpu_torch.utils import config

    bc = config.get("helmet")
    cfg = bc.render
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene, cam = config.build_scene(
        dataclasses.replace(bc.scene, cluster_k=32), dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = types.with_clusters(scene, k=32)
    torch.cuda.synchronize()
    grid_s = time.perf_counter() - t0
    grid = scene.clusters
    if grid.k != 32 or tuple(grid.soup.shape) != (grid.num_clusters + 1, 9,
                                                  32):
        raise AssertionError(f"helmet k=32 grid: k {grid.k}, soup "
                             f"{tuple(grid.soup.shape)}")
    scene128 = types.with_clusters(scene)
    print(f"helmet k=32: {grid.num_clusters} sub-clusters (k=128: "
          f"{scene128.clusters.num_clusters} clusters); set-up {setup_s:.3f}"
          f" s (scene, builders and soup), cluster grid and soup alone "
          f"{grid_s:.3f} s")

    def frame(sc):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        traverse.STEPS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film, count = path.render_with_stats(sc, cam, rng_mod.key(0, dev),
                                             cfg)
        img = film.mean().cpu().numpy()
        dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(
                img).all():
            raise AssertionError(f"helmet k=32 film: shape {img.shape}, "
                                 f"finite {bool(np.isfinite(img).all())}")
        return img, {"seconds": dt, "rays": int(count),
                     "rays_per_s": int(count) / dt,
                     "film_mean": float(img.mean()), "launches": got}

    img, cold = frame(scene)
    if cold["launches"] != K32_LAUNCHES:
        raise AssertionError(f"helmet k=32 launches {cold['launches']}, "
                             f"expected {K32_LAUNCHES}")
    img_warm, warm = frame(scene)
    out = {"sub_clusters": grid.num_clusters,
           "clusters_k128": scene128.clusters.num_clusters,
           "setup_s": setup_s, "grid_s": grid_s, "cold": cold, "warm": warm,
           "warm_equal_cold": bool(np.array_equal(img, img_warm))}
    print(f"helmet k=32 512x512 x {cfg.spp} spp x {cfg.max_bounces} bounces:"
          f" cold {cold['seconds']:.3f} s, warm {warm['seconds']:.3f} s, "
          f"{cold['rays']} ray queries, {warm['rays_per_s']:.4g} rays/s "
          f"warm, film mean {cold['film_mean']:.5f}, launches "
          f"{cold['launches']} [{card_line()}]")
    bvh_scene = types.with_bvh(dataclasses.replace(scene, clusters=None))
    for label, sc in (("k=128", scene128), ("bvh", bvh_scene)):
        other, st = frame(sc)
        frac, n_bad = render_agreement(img, other)
        out[label] = {**st, "pixels_differ": n_bad, "pixel_frac": frac,
                      "film_mean_diff": cold["film_mean"] - st["film_mean"],
                      "rays_diff": cold["rays"] - st["rays"]}
        print(f"helmet k=32 against {label} at the same key: {n_bad} of "
              f"{img.shape[0] * img.shape[1]} pixels differ, film mean "
              f"{cold['film_mean']:.5f} against {st['film_mean']:.5f} "
              f"(diff {cold['film_mean'] - st['film_mean']:.3g}), "
              f"{cold['rays']} ray queries against {st['rays']} (diff "
              f"{cold['rays'] - st['rays']}); {label} frame "
              f"{st['seconds']:.3f} s")
    del bvh_scene

    calls, n = helmet_trace_calls(scene, cam, cfg, dev)
    timed = ("camera closest", "env shadow any-hit", "emitter shadow any-hit")
    out["calls"] = {}
    for k, g in ((32, grid), (128, scene128.clusters)):
        st = TraceStats(f"K1 helmet k={k}")
        tri_id = g.tri_id.to(dev)
        for label, (o, d, t_min, t_max, sort, any_hit) in calls.items():
            args, _ = blocktrace.block_inputs(
                g, o, d, t_min, t_max, block=cfg.block_size, max_u=cfg.max_u,
                sort=sort, chunk=cfg.chunk)
            kern = tb.trace_blocks(*args, t_min=t_min, any_hit=any_hit,
                                   chunk=cfg.chunk)
            plain = tb.trace_blocks_plain(*args, t_min=t_min,
                                          any_hit=any_hit, chunk=cfg.chunk)
            torch.cuda.synchronize()
            flat = lambda x: x.reshape(-1)[:n]
            if any_hit:
                st.any_hit(label, flat(kern), flat(plain))
            else:
                st.closest(label, (flat(kern[0]), flat(kern[1])),
                           (flat(plain[0]), flat(plain[1])))
            if k == 32 and st.mismatch:
                raise AssertionError(f"K1 at k=32 {label}: {st.mismatch} "
                                     "winners differ from its plain version")
            if label not in timed:
                continue
            c = k1_call_stats(args, t_min, any_hit, cfg.chunk, tri_id)
            out["calls"][f"k={k} {label}"] = c
            print(f"K1 helmet k={k} B={c['block']} chunk={c['chunk']} "
                  f"{label} ({c['lanes']} lanes, {c['candidates']} "
                  f"candidates a block): device {c['ms']:.4f} ms, wrapper "
                  f"{c['wrapper_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms "
                  f"({c['bound_by']}; {c['tests']} tests needed, "
                  f"{c['clusters_read']} clusters read), "
                  f"{c['tests_per_s']:.4g} tests/s, "
                  f"{c['ratio_to_bound']:.2f}x the bound [{card_line()}]")
        out[f"k{k}_rays_compared"] = st.rays
        out[f"k{k}_winner_mismatches"] = st.mismatch
        out[f"k{k}_max_abs_err"] = st.max_abs_err
    plain_ms = time_ms(lambda: tb.trace_blocks_plain(
        *blocktrace.block_inputs(grid, *calls["camera closest"][:2], 0.0,
                                 1e30,
                                 block=cfg.block_size, max_u=cfg.max_u,
                                 chunk=cfg.chunk)[0], t_min=0.0,
        any_hit=False, chunk=cfg.chunk), 3, warmup=1)
    out["camera_plain_ms"] = plain_ms
    del scene, scene128, grid

    # helmet_proc at tools/prof_k32.py's settings (chunk 16, max_u 96),
    # every phase_k1 call held equal to the plain version.
    proc, proc_ms, proc_plain_ms = phase_k1(dev, "helmet_proc", chunk=16,
                                            cluster_k=32, max_u=96)
    if proc.mismatch:
        raise AssertionError(f"K1 helmet_proc k=32: {proc.mismatch} winners "
                             "differ from its plain version")
    out["helmet_proc"] = {"calls": proc.calls, "work": proc.work,
                          "rays_compared": proc.rays, "ms": proc_ms,
                          "plain_ms": proc_plain_ms}
    print(f"K1 262144 helmet_proc camera rays at k=32, chunk=16, max_u=96: "
          f"kernel {proc_ms:.4f} ms (wrapper {proc.wrapper_ms:.4f}, bound "
          f"{proc.bound[0]:.4f}), plain {proc_plain_ms:.4f} ms "
          f"[{card_line()}]")
    return out


def lists_differ(u_a, u_b) -> int:
    """The blocks whose candidate sets (rows of u_idx) differ."""
    return int((u_a.sort(dim=1).values
                != u_b.sort(dim=1).values).any(dim=1).sum())


def permuted_grid(grid, seed: int):
    """The grid with its clusters in a seeded random order (boxes, tri_id
    and soup rows together, the sentinel last) and parents rebuilt over
    that order."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.accel.clusters import (
        ClusterGrid, _parent_boxes)
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(
        grid.num_clusters)).to(grid.tri_id.device)
    amin, amax = grid.aabb_min[perm], grid.aabb_max[perm]
    pmin, pmax = _parent_boxes(amin, amax)
    return ClusterGrid(aabb_min=amin, aabb_max=amax, tri_id=grid.tri_id[perm],
                       parent_min=pmin, parent_max=pmax,
                       soup=torch.cat([grid.soup[:-1][perm], grid.soup[-1:]]))


def hold_k1(st, tag, kern, plain, any_hit, n):
    """Hold a K1 call to its plain version on the first n lanes: every
    winner, t and mask equal (TraceStats `st` records it)."""
    import torch
    torch.cuda.synchronize()
    flat = lambda x: x.reshape(-1)[:n]
    if any_hit:
        st.any_hit(tag, flat(kern), flat(plain))
    else:
        st.closest(tag, (flat(kern[0]), flat(kern[1])),
                   (flat(plain[0]), flat(plain[1])))
    if st.mismatch:
        raise AssertionError(f"{st.kernel} {tag}: {st.mismatch} winners "
                             "differ from its plain version")


def phase_parentless(dev, counters, k32):
    """Phase 16: cluster grids without parent boxes (phase A's flat top-k
    over all C clusters).  `helmet` at K = 128 (1,024 clusters) and at
    k = 32 (4,096 sub-clusters), each with `parent_min = parent_max =
    None`.  On phase 15's 262,144 camera rays: phase A's selection flat
    beside hierarchical (CUDA events; candidates a block, blocks whose
    lists differ), and the whole of phase A (`block_inputs`) both ways.  K1
    on the flat lists of the camera closest-hit, env shadow and emitter
    shadow calls, equal to its plain version on every winner, t and mask,
    timed beside its work-counted bound and beside phase 15's K1 on the
    parented lists of the same calls; the camera and env shadow calls on
    the same grids with their clusters permuted (`permuted_grid`: lists
    the parents do not select), K1 held to its plain version, the hits
    through either selection.  Then one `helmet` frame at K = 128
    without parents through render_with_stats at phase 15's key and config
    (40 K1 + 184 K5a, counts reset just before it) beside the parented
    frame: frame seconds, ray queries, film means and the pixels that
    differ (measured, not held)."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import blocktrace
    from physically_based_renderer_tpu_torch.ops import trace_blocks as tb
    from physically_based_renderer_tpu_torch.scene import types
    from physically_based_renderer_tpu_torch.utils import config

    bc = config.get("helmet")
    cfg = bc.render
    scene32, cam = config.build_scene(
        dataclasses.replace(bc.scene, cluster_k=32), dev)
    scenes = {128: types.with_clusters(scene32), 32: scene32}
    calls, n = helmet_trace_calls(scene32, cam, cfg, dev)
    timed = ("camera closest", "env shadow any-hit", "emitter shadow any-hit")
    out = {"phase_a": {}, "calls": {}, "permuted": {}}
    st = TraceStats("K1 flat")
    for k, sc in scenes.items():
        parented = sc.clusters
        grid = dataclasses.replace(parented, parent_min=None,
                                   parent_max=None)
        c = grid.num_clusters
        if grid.k != k or c <= 4 * cfg.max_u:
            raise AssertionError(f"helmet k={k}: {c} clusters of {grid.k}")

        # Phase A on the camera rays: the selection alone on the root-culled
        # rays in blocks, and block_inputs whole, flat beside hierarchical.
        o, d, t_min, t_max = calls["camera closest"][:4]
        kw = dict(block=cfg.block_size, max_u=cfg.max_u, chunk=cfg.chunk)
        args, _ = blocktrace.block_inputs(grid, o, d, t_min, t_max, **kw)
        nb, blk = args[1].shape[:2]

        def select(g, a=args):
            return blocktrace._select_candidates(
                g, a[1].reshape(-1, 3), a[2].reshape(-1, 3),
                a[3].reshape(-1), nb, blk, t_min, cfg.max_u)

        ways = {"flat": grid, "hierarchical": parented}
        lists = {name: select(g) for name, g in ways.items()}
        a_ms = {name: time_ms(lambda g=g: select(g), 20)
                for name, g in ways.items()}
        full_ms = {name: time_ms(lambda g=g: blocktrace.block_inputs(
            g, o, d, t_min, t_max, **kw), 10) for name, g in ways.items()}
        differ = lists_differ(lists["flat"][0], lists["hierarchical"][0])
        counts = {name: lists[name][2].float() for name in lists}
        st_a = {"clusters": c, "blocks": nb, "select_ms": a_ms,
                "block_inputs_ms": full_ms, "blocks_lists_differ": differ,
                "candidates_mean": {m: float(v.mean())
                                    for m, v in counts.items()},
                "candidates_min": {m: int(v.min()) for m, v in counts.items()},
                "blocks_full": {m: int((v == cfg.max_u).sum())
                                for m, v in counts.items()}}
        out["phase_a"][f"k={k}"] = st_a
        print(f"phase A helmet k={k} (C = {c}) on {n} camera rays, {nb} "
              f"blocks of {blk}, max_u {cfg.max_u}: selection flat "
              f"{a_ms['flat']:.4f} ms against hierarchical "
              f"{a_ms['hierarchical']:.4f} ms "
              f"({a_ms['flat'] / a_ms['hierarchical']:.2f}x); "
              f"block_inputs flat {full_ms['flat']:.4f} ms against "
              f"{full_ms['hierarchical']:.4f} ms; candidates a block flat "
              f"mean {st_a['candidates_mean']['flat']:.2f} (min "
              f"{st_a['candidates_min']['flat']}, "
              f"{st_a['blocks_full']['flat']} blocks full), hierarchical mean "
              f"{st_a['candidates_mean']['hierarchical']:.2f} (min "
              f"{st_a['candidates_min']['hierarchical']}, "
              f"{st_a['blocks_full']['hierarchical']} blocks full); "
              f"{differ} of {nb} blocks' lists differ [{card_line()}]")

        # K1 on the flat lists, each call held to its plain version.
        tri_id = grid.tri_id.to(dev)
        for label in timed:
            o, d, t_min, t_max, sort, any_hit = calls[label]
            args, _ = blocktrace.block_inputs(grid, o, d, t_min, t_max,
                                              sort=sort, **kw)
            hier_args, _ = blocktrace.block_inputs(parented, o, d, t_min,
                                                   t_max, sort=sort, **kw)
            differ = lists_differ(args[0], hier_args[0])
            kern = tb.trace_blocks(*args, t_min=t_min, any_hit=any_hit,
                                   chunk=cfg.chunk)
            hold_k1(st, f"k={k} {label}", kern,
                    tb.trace_blocks_plain(*args, t_min=t_min,
                                          any_hit=any_hit, chunk=cfg.chunk),
                    any_hit, n)
            cs = k1_call_stats(args, t_min, any_hit, cfg.chunk, tri_id)
            cs["valid_mean"] = float(args[5].float().mean())
            cs["blocks_lists_differ"] = differ
            hier = k32["calls"][f"k={k} {label}"]
            cs["parented_ms"] = hier["ms"]
            cs["parented_bound_ms"] = hier["bound_ms"]
            out["calls"][f"k={k} {label}"] = cs
            print(f"K1 helmet k={k} flat lists B={cs['block']} "
                  f"chunk={cs['chunk']} {label} ({cs['lanes']} lanes, "
                  f"{cs['candidates']} candidates a block, "
                  f"{cs['valid_mean']:.2f} valid on average; {differ} of "
                  f"{args[0].shape[0]} blocks' lists differ from the "
                  f"parented grid's): device "
                  f"{cs['ms']:.4f} ms, wrapper {cs['wrapper_ms']:.4f} ms, "
                  f"bound {cs['bound_ms']:.4f} ms ({cs['bound_by']}; "
                  f"{cs['tests']} tests needed, {cs['clusters_read']} "
                  f"clusters read), {cs['tests_per_s']:.4g} tests/s, "
                  f"{cs['ratio_to_bound']:.2f}x the bound; parented lists "
                  f"(phase 15) {hier['ms']:.4f} ms, bound "
                  f"{hier['bound_ms']:.4f} ms [{card_line()}]")

        # The same grid with its clusters permuted: each parent box spans
        # the scene, so the flat lists are ones the parents do not select.
        # K1 on them held to its plain version; the hits each selection
        # finds.
        perm_p = permuted_grid(parented, 0)
        perm = dataclasses.replace(perm_p, parent_min=None, parent_max=None)
        for label in ("camera closest", "env shadow any-hit"):
            o, d, t_min, t_max, sort, any_hit = calls[label]
            lists, hits = {}, {}
            for name, g in (("flat", perm), ("hierarchical", perm_p)):
                args, _ = blocktrace.block_inputs(g, o, d, t_min, t_max,
                                                  sort=sort, **kw)
                kern = tb.trace_blocks(*args, t_min=t_min, any_hit=any_hit,
                                       chunk=cfg.chunk)
                lists[name] = args[0]
                hits[name] = int((kern if any_hit else kern[1] >= 0).sum())
                if name == "flat":
                    hold_k1(st, f"k={k} permuted {label}", kern,
                            tb.trace_blocks_plain(*args, t_min=t_min,
                                                  any_hit=any_hit,
                                                  chunk=cfg.chunk),
                            any_hit, n)
            differ = lists_differ(lists["flat"], lists["hierarchical"])
            out["permuted"][f"k={k} {label}"] = {
                "blocks_lists_differ": differ, "hits": hits}
            print(f"K1 helmet k={k} permuted clusters {label}: {differ} of "
                  f"{lists['flat'].shape[0]} blocks' lists differ; "
                  f"{hits['flat']} rays hit through the flat lists, "
                  f"{hits['hierarchical']} through the parents")
    out["rays_compared"] = st.rays
    out["winner_mismatches"] = st.mismatch
    out["max_abs_err"] = st.max_abs_err

    # One helmet frame at K = 128 without parents beside the parented one.
    def frame(sc):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film, count = path.render_with_stats(sc, cam, rng_mod.key(0, dev),
                                             cfg)
        img = film.mean().cpu().numpy()
        dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(
                img).all():
            raise AssertionError(f"helmet frame: shape {img.shape}, finite "
                                 f"{bool(np.isfinite(img).all())}")
        return img, {"seconds": dt, "rays": int(count),
                     "rays_per_s": int(count) / dt,
                     "film_mean": float(img.mean()), "launches": got}

    sc = scenes[128]
    img_p, parented = frame(sc)
    img, flat_run = frame(dataclasses.replace(sc, clusters=dataclasses.replace(
        sc.clusters, parent_min=None, parent_max=None)))
    if flat_run["launches"] != PARENTLESS_LAUNCHES:
        raise AssertionError(f"parent-less helmet launches "
                             f"{flat_run['launches']}, expected "
                             f"{PARENTLESS_LAUNCHES}")
    frac, n_bad = render_agreement(img, img_p)
    out["frame"] = {**flat_run, "parented": parented, "pixels_differ": n_bad,
                    "pixel_frac": frac,
                    "rays_diff": flat_run["rays"] - parented["rays"]}
    print(f"helmet k=128 without parents {cfg.width}x{cfg.height} x "
          f"{cfg.spp} spp x "
          f"{cfg.max_bounces} bounces: {flat_run['seconds']:.3f} s, "
          f"{flat_run['rays']} ray queries, film mean "
          f"{flat_run['film_mean']:.5f}, launches {flat_run['launches']}; "
          f"the parented frame at the same key {parented['seconds']:.3f} s, "
          f"{parented['rays']} ray queries (diff {out['frame']['rays_diff']}"
          f"), film mean {parented['film_mean']:.5f}; {n_bad} of "
          f"{img.shape[0] * img.shape[1]} pixels differ [{card_line()}]")
    return out


def phase_entry(counters):
    """Phase 16b: tools/dryrun.py::entry(), the single-card forward check
    (the Cornell box at 64x64 x 1 spp x 2 bounces through render_sample),
    cold and warm, each with the counts reset just before it (5 K2 + 5
    K5a); its image held per pixel to the reference's
    (tests/data/entry_cornell_64_golden.npy)."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.tools import dryrun

    fn, args = dryrun.entry()
    if args[0].device.type != "cuda":
        raise AssertionError(f"entry() ran on {args[0].device}")
    runs = {}
    for run in ("cold", "warm"):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        img = out.cpu().numpy()
        dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if got != ENTRY_LAUNCHES:
            raise AssertionError(f"entry() {run} launches {got}, expected "
                                 f"{ENTRY_LAUNCHES}")
        runs[run] = {"seconds": dt, "launches": got}
    ref = np.load(ENTRY_GOLDEN)
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise AssertionError(f"entry() image {img.shape}, finite "
                             f"{bool(np.isfinite(img).all())}")
    frac, n_bad = render_agreement(img, ref)
    mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
    print(f"entry forward: {tuple(out.shape)} {float(out.mean())}; cold "
          f"{runs['cold']['seconds']:.4f} s, warm "
          f"{runs['warm']['seconds']:.4f} s, launches {runs['warm']['launches']}; golden {frac:.4%} pixels "
          f"agree ({n_bad} differ), mean rel diff {mean_rel:.3g} "
          f"[{card_line()}]")
    if frac < PIXEL_FRAC or mean_rel > MEAN_REL:
        raise AssertionError("entry() disagrees with the reference's golden")
    return {**runs, "shape": list(out.shape), "mean": float(out.mean()),
            "pixel_frac": frac, "pixels_differ": n_bad, "mean_rel": mean_rel}


def phase_phase_a(dev, counters=None):
    """Phase 16c: phase A's kernels on the tracer calls of one spd_tetra
    frame, against the plain version, timed; a frame's host syncs and
    launches with the kernels (36 K1, 100 phase A), and its host syncs
    with the plain phase A (module docstring)."""
    import warnings

    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import blocktrace as bt
    from physically_based_renderer_tpu_torch.tools.timing import device_ms
    from physically_based_renderer_tpu_torch.utils import config

    if counters is None:                        # the phase alone
        from physically_based_renderer_tpu_torch.ops import trace_blocks
        counters = {"trace_blocks": (trace_blocks, "LAUNCHES"),
                    "phase_a": (bt, "PHASE_A_LAUNCHES")}
    bc = config.get("spd_tetra")
    scene, cam = config.build_scene(bc.scene, dev)
    kernels = bt.block_inputs
    calls = []

    def record(grid, o, d, t_min, t_max, *args):
        calls.append((grid, o.clone(), d.clone(), t_min,
                      t_max.clone() if isinstance(t_max, torch.Tensor)
                      else t_max, *args))
        return kernels(grid, o, d, t_min, t_max, *args)

    bt.block_inputs = record
    try:
        path.render_with_stats(scene, cam, rng_mod.key(11, dev),
                               dataclasses.replace(bc.render, spp=1))
    finally:
        bt.block_inputs = kernels
    sorted_calls = [c for c in calls if c[7]]
    picked = {"camera (unsorted)": next(c for c in calls if not c[7]),
              "first sorted": sorted_calls[0],
              "second sorted": sorted_calls[1]}
    out = {"calls": {}}
    for label, call in picked.items():
        grid, o, d, t_min, t_max, block, max_u, sort, chunk, geo = call
        args = (grid, o, d, t_min, t_max, block, max_u, sort, chunk, geo)
        launches = 3 if sort else 1
        before = bt.PHASE_A_LAUNCHES
        (got, perm) = kernels(*args)
        torch.cuda.synchronize()
        if bt.PHASE_A_LAUNCHES - before != launches:
            raise AssertionError(f"phase A {label}: "
                                 f"{bt.PHASE_A_LAUNCHES - before} launches")
        want, want_perm = bt.block_inputs_plain(*args)
        for name, g, w in zip(("u_idx", "o", "d", "t_max", "soup",
                               "n_valid", "entry"), got, want):
            bits = ((g.view(torch.int32), w.view(torch.int32))
                    if g.dtype == torch.float32 else (g, w))
            if g.shape != w.shape or not torch.equal(*bits):
                raise AssertionError(f"phase A {label}: {name} differs from "
                                     "the plain version")
        if sort and not torch.equal(perm, want_perm):
            raise AssertionError(f"phase A {label}: perm differs")
        n = o.shape[0]
        nb, n_u = got[0].shape
        n_bytes = (24 * n + (4 * n if isinstance(t_max, torch.Tensor)
                             else 0)                      # o, d, t_max in
                   + 28 * nb * block + 8 * nb * n_u + 4 * nb  # lists out
                   + (8 * n if sort else 0))              # perm out
        bnd = bound(n_bytes, 0.0)
        dev_ms, other_ms = device_ms(lambda: kernels(*args), 20, "phase_a_",
                                     per_call=launches)
        wrapper_ms = time_ms(lambda: kernels(*args), 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            kernels(*args)
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        plain_ms = time_ms(lambda: bt.block_inputs_plain(*args), 20)
        plain_dev_ms, _ = device_ms(lambda: bt.block_inputs_plain(*args), 10,
                                    None)
        live = int((got[3] > 0).sum())
        out["calls"][label] = {
            "rays": n, "live": live, "blocks": nb, "list": n_u,
            "launches": launches, "ms": dev_ms, "other_kernels_ms": other_ms,
            "wrapper_ms": wrapper_ms, "host_us": host_us,
            "plain_ms": plain_ms, "plain_device_ms": plain_dev_ms,
            "bytes": n_bytes, "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(f"phase A spd_tetra {label}: {n} rays ({live} live), {nb} "
              f"blocks of {block}, lists of {n_u}; {launches} launches, "
              f"device {dev_ms:.4f} ms (other kernels {other_ms:.4f}), "
              f"bound {bnd[0]:.4f} ms ({n_bytes} B, {dev_ms / bnd[0]:.2f}x); "
              f"wrapper {wrapper_ms:.4f} ms, host {host_us:.1f} us a call; "
              f"plain {plain_ms:.4f} ms (device {plain_dev_ms:.4f}) "
              f"[{card_line()}]")

    def syncs_and_seconds():
        key = rng_mod.key(13, dev)
        path.render_with_stats(scene, cam, key, bc.render)     # warm
        torch.cuda.synchronize()
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                path.render_with_stats(scene, cam, key, bc.render)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        # The mode's own once-a-process notice ("... prototype feature and
        # does not yet detect all synchronizing operations") is no sync.
        n_sync = sum("synchroniz" in str(w.message)
                     and "prototype" not in str(w.message) for w in caught)
        torch.cuda.synchronize()
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        t0 = time.perf_counter()
        for _ in range(3):
            film, _ = path.render_with_stats(scene, cam, key, bc.render)
        film.hdr.sum().item()
        return n_sync, (time.perf_counter() - t0) / 3, got

    *out["frame_kernels"], got = syncs_and_seconds()
    if (got["trace_blocks"], got["phase_a"]) != (SPD_TETRA_K1,
                                                 SPD_TETRA_PHASE_A):
        raise AssertionError(f"spd_tetra frame launches {got}, expected "
                             f"{SPD_TETRA_K1} K1 and {SPD_TETRA_PHASE_A} "
                             "phase A")
    out["frame_launches"] = got
    bt.block_inputs = bt.block_inputs_plain
    try:
        *out["frame_plain"], got = syncs_and_seconds()
    finally:
        bt.block_inputs = kernels
    if got["phase_a"]:
        raise AssertionError(f"the plain phase A launched {got['phase_a']}")
    print(f"spd_tetra frame 512x512 x {bc.render.spp} spp: host syncs "
          f"{out['frame_kernels'][0]} with the phase A kernels, "
          f"{out['frame_plain'][0]} with the plain phase A; "
          f"{out['frame_kernels'][1]:.4f} s against "
          f"{out['frame_plain'][1]:.4f} s a frame; launches "
          f"{out['frame_launches']} [{card_line()}]")
    return out


def phase_profile_frame(dev, name):
    """One warm frame of config `name` under torch.profiler: launches, the
    device's busy and idle share, K1's and K5a's shares of the device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.tools import timing
    from physically_based_renderer_tpu_torch.utils import config

    bc = config.get(name)
    scene, cam = config.build_scene(bc.scene, dev)
    key = rng_mod.key(0, dev)

    def frame():
        t0 = time.perf_counter()
        _, count = path.render_with_stats(scene, cam, key, bc.render)
        rays = int(count)
        return time.perf_counter() - t0, rays

    frame()
    warm = [frame()[0] for _ in range(3)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, rays = frame()
    events = prof.key_averages()
    kernels = timing.kernels(events)
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    k1 = sum(e.self_device_time_total for e in kernels
             if "trace_blocks_kernel" in e.key) / 1e6
    k5 = sum(e.self_device_time_total for e in kernels
             if "gather_fwd_kernel" in e.key) / 1e6
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    out = {"warm_frame_s": warm, "profiled_wall_s": wall, "rays": rays,
           "device_busy_s": busy, "launches": launches,
           "idle_share_profiled": 1.0 - busy / wall,
           "idle_share_warm": 1.0 - busy / min(warm),
           "k1_device_s": k1, "k1_share_of_device": k1 / busy,
           "k1_share_of_warm_frame": k1 / min(warm),
           "k5a_device_s": k5, "k5a_share_of_device": k5 / busy,
           "block_size": bc.render.block_size,
           "top_kernels": [(e.key[:80], e.self_device_time_total / 1e3,
                            e.count) for e in top]}
    print(f"profiled {name} frame (B={bc.render.block_size}): warm frames "
          f"{', '.join(f'{w:.3f}' for w in warm)} s, profiled wall "
          f"{wall:.3f} s, {launches} launches, device busy {busy:.4f} s "
          f"(idle {out['idle_share_warm']:.1%} of the fastest warm frame), "
          f"K1 {k1 * 1e3:.2f} ms = {out['k1_share_of_device']:.1%} of the "
          f"device time, {out['k1_share_of_warm_frame']:.2%} of the frame; "
          f"K5a {k5 * 1e3:.2f} ms = {out['k5a_share_of_device']:.1%} "
          f"[{card_line()}]")
    return out


def render_direct(name, dev, tracer, **over):
    """render_with_stats on a named config with the given tracer: (mean HDR
    image as numpy, {"seconds", "rays", "rays_per_s"})."""
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.utils import config

    bc = config.get(name)
    scene, cam = config.build_scene(bc.scene, dev)
    cfg = dataclasses.replace(bc.render, tracer=tracer, **over)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    film, count = path.render_with_stats(scene, cam, rng_mod.key(0, dev), cfg)
    hdr = film.mean()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rays = int(count)
    return hdr.cpu().numpy(), {"seconds": dt, "rays": rays,
                               "rays_per_s": rays / dt}


def phase_routes(dev, counters):
    """Phase 6c: the BVH walk, the XLA block tracer and batch_spp at
    512x512, each run with the launch counts reset just before it, beside
    the route it is held to at the same key (that run's launches are not
    counted)."""
    import numpy as np
    import torch

    from physically_based_renderer_tpu_torch.core import rng as rng_mod
    from physically_based_renderer_tpu_torch.integrator import path
    from physically_based_renderer_tpu_torch.ops import traverse
    from physically_based_renderer_tpu_torch.scene import types
    from physically_based_renderer_tpu_torch.tools import timing
    from physically_based_renderer_tpu_torch.utils import config

    def run(scene, cam, cfg):
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        traverse.STEPS = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        film, count = path.render_with_stats(scene, cam, rng_mod.key(0, dev),
                                             cfg)
        img = film.mean().cpu().numpy()
        dt = time.perf_counter() - t0
        got = {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(
                img).all():
            raise AssertionError(f"{cfg.tracer} film: shape {img.shape}, "
                                 f"finite {bool(np.isfinite(img).all())}")
        return img, {"seconds": dt, "rays": int(count),
                     "rays_per_s": int(count) / dt,
                     "bvh_steps": traverse.STEPS, "film_mean":
                     float(img.mean()), "launches": got}

    def held(label, img, st, ref, ref_st, equal_rays, mean_limit=MEAN_REL):
        """Print how `img` compares with `ref` and hold it there (film mean
        within mean_limit, equal ray counts if asked); a mean_limit of None
        only measures."""
        frac, n_bad = render_agreement(img, ref)
        mean_rel = abs(st["film_mean"] / ref_st["film_mean"] - 1.0)
        print(f"{label} {img.shape[1]}x{img.shape[0]}: {st['seconds']:.3f} s "
              f"({ref_st['seconds']:.3f} s by the route it is held to), "
              f"{st['rays']} ray queries ({ref_st['rays']}), "
              f"{st['rays_per_s']:.4g} rays/s, film mean "
              f"{st['film_mean']:.5f} ({ref_st['film_mean']:.5f}, rel "
              f"{mean_rel:.3g}), {n_bad} of {img.shape[0] * img.shape[1]} "
              f"pixels differ, BVH steps {st['bvh_steps']}, launches "
              f"{st['launches']} [{card_line()}]")
        if label in ROUTE_LAUNCHES and st["launches"] != ROUTE_LAUNCHES[
                label]:
            raise AssertionError(f"{label} launches {st['launches']}, "
                                 f"expected {ROUTE_LAUNCHES[label]}")
        if mean_limit is not None and (mean_rel > mean_limit or (
                equal_rays and st["rays"] != ref_st["rays"])):
            raise AssertionError(f"{label} disagrees with its reference "
                                 "route")
        return {**st, "held_to": {k: ref_st[k] for k in (
                    "seconds", "rays", "film_mean")},
                "pixel_frac": frac, "pixels_differ": n_bad,
                "mean_rel": mean_rel}

    def exact_band(scene, cam, cfg, img):
        """Hold the rows BVH_EXACT_BAND of the frame `img` per pixel to the
        brute-force tracer's render of those rows at the same key."""
        row0, rows = BVH_EXACT_BAND
        keys = rng_mod.split(rng_mod.key(0, dev), cfg.spp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            film, count = path.render_band(
                scene, cam, keys, dataclasses.replace(cfg, tracer="brute"),
                row0, rows)
        ref = film.mean().cpu().numpy()
        dt = time.perf_counter() - t0
        band = img[row0:row0 + rows]
        frac, n_bad = render_agreement(band, ref)
        mean_rel = abs(float(band.mean()) / float(ref.mean()) - 1.0)
        print(f"bvh rows {row0}-{row0 + rows - 1} against brute force: "
              f"{n_bad} of {ref.shape[0] * ref.shape[1]} pixels differ, "
              f"film mean {float(band.mean()):.5f} ({float(ref.mean()):.5f},"
              f" rel {mean_rel:.3g}); brute force {dt:.3f} s, "
              f"{int(count)} ray queries [{card_line()}]")
        if frac < PIXEL_FRAC or mean_rel > MEAN_REL:
            raise AssertionError("the bvh frame differs from the brute-force "
                                 "tracer")
        return {"rows": [row0, rows], "pixel_frac": frac,
                "pixels_differ": n_bad, "mean_rel": mean_rel,
                "brute_seconds": dt, "brute_rays": int(count)}

    def profile_walk(scene, cam, cfg):
        """One closest-hit walk over the frame's camera rays (pixel
        centres) under torch.profiler: kernel launches and device busy
        time a lockstep step."""
        from torch.profiler import ProfilerActivity, profile

        from physically_based_renderer_tpu_torch.core.camera import (
            generate_rays_at)
        w, h = cfg.width, cfg.height
        pix = torch.arange(w * h, device=dev)
        o, d = generate_rays_at(cam, w, h, (pix % w).float(),
                                (pix // w).float(),
                                torch.full((w * h, 2), 0.5, device=dev))

        def walk():
            traverse.STEPS = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                hit = traverse.intersect_bvh(scene.bvh, scene.geometry, o, d)
            n_hit = int((hit.tri >= 0).sum())
            return time.perf_counter() - t0, traverse.STEPS, n_hit

        walk()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall, steps, n_hit = walk()
        events = prof.key_averages()
        busy = sum(e.self_device_time_total
                   for e in timing.kernels(events)) / 1e6
        launches = sum(e.count for e in events
                       if e.key.startswith(("cudaLaunch", "cuLaunch")))
        res = {"rays": w * h, "hits": n_hit, "steps": steps,
               "profiled_wall_s": wall, "device_busy_s": busy,
               "idle_share": 1.0 - busy / wall, "launches": launches,
               "launches_per_step": launches / steps,
               "device_ms_per_step": busy * 1e3 / steps,
               "wall_ms_per_step": wall * 1e3 / steps}
        print(f"profiled BVH walk, {w * h} camera rays ({n_hit} hit): "
              f"{steps} lockstep steps, {launches} launches "
              f"({res['launches_per_step']:.1f} a step), wall {wall:.4f} s, "
              f"device busy {busy:.4f} s (idle {res['idle_share']:.1%}; "
              f"{res['device_ms_per_step']:.4f} of "
              f"{res['wall_ms_per_step']:.4f} ms a step) [{card_line()}]")
        return res

    out = {}
    # bvh: helmet without its grid, with its BVH, against the K1 route and,
    # on a band of rows, the brute-force tracer.
    bc = config.get("helmet")
    cfg = dataclasses.replace(bc.render, spp=1, max_bounces=3)
    scene, cam = config.build_scene(bc.scene)
    t0 = time.perf_counter()
    bvh_scene = types.with_bvh(dataclasses.replace(scene, clusters=None))
    build_s = time.perf_counter() - t0
    cam = types.upload_scene(cam, dev)
    bvh_scene = types.upload_scene(bvh_scene, dev)
    grid_scene = types.upload_scene(scene, dev)
    if path.make_tracer(bvh_scene, cfg).name != "bvh":
        raise AssertionError("tracer auto does not take the BVH walk")
    # Camera rays come in coherent blocks, which phase A does not truncate:
    # there the two exact answers agree per pixel.
    cam_cfg = dataclasses.replace(cfg, max_bounces=0)
    img, st = run(bvh_scene, cam, cam_cfg)
    ref, ref_st = run(grid_scene, cam, cam_cfg)
    camera = held("bvh_camera", img, st, ref, ref_st, True)
    if camera["pixel_frac"] < PIXEL_FRAC:
        raise AssertionError("bvh camera frame differs from the K1 route")
    img, st = run(bvh_scene, cam, cfg)
    exact = exact_band(bvh_scene, cam, cfg, img)
    # Bounce rays: phase A keeps max(max_u // 2, 8) parent boxes a block
    # (ROADMAP's known fault of the reference), so K1 drops hits that the
    # BVH walk finds; the pixels that differ measure that truncation.
    ref, ref_st = run(grid_scene, cam, cfg)
    out["bvh"] = {**held("bvh", img, st, ref, ref_st, False, None),
                  "camera_frame": camera, "exact_band": exact,
                  "walk_profile": profile_walk(bvh_scene, cam, cfg),
                  "bvh_build_s": build_s,
                  "bvh_nodes": int(bvh_scene.bvh.node_left.shape[0])}
    print(f"bvh: {out['bvh']['bvh_nodes']} nodes built in {build_s:.2f} s "
          "on the host")
    del bvh_scene, grid_scene

    # block: helmet_proc through the XLA block tracer against K1.
    bc = config.get("helmet_proc")
    cfg = dataclasses.replace(bc.render, spp=1)
    scene, cam = config.build_scene(bc.scene, dev)
    img, st = run(scene, cam, dataclasses.replace(cfg, tracer="block"))
    ref, ref_st = run(scene, cam, dataclasses.replace(cfg, tracer="pallas"))
    out["block"] = held("block", img, st, ref, ref_st, True)
    del scene

    # batch_spp: the dense cornell frame as one stream against the loop.
    bc = config.get("cornell")
    cfg = dataclasses.replace(bc.render, tracer="resident")
    scene, cam = config.build_scene(bc.scene, dev)
    img, st = run(scene, cam, dataclasses.replace(cfg, batch_spp=True))
    ref, ref_st = run(scene, cam, cfg)
    out["batch_spp"] = held("batch_spp", img, st, ref, ref_st, True)
    if out["batch_spp"]["pixel_frac"] < PIXEL_FRAC:
        raise AssertionError("batch_spp differs from the sample loop")
    return out


def run_cli(argv):
    """Run the render CLI; return its --stats JSON (echoing its stderr)."""
    from physically_based_renderer_tpu_torch.apps import render
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = render.main(argv)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        raise AssertionError(f"render CLI exited {rc}")
    return json.loads(err.getvalue().strip().splitlines()[-1])


def render_agreement(img, ref):
    import numpy as np
    ok = (np.abs(img - ref) <= ATOL + RTOL * np.abs(ref)).all(-1)
    return float(ok.mean()), int((~ok).sum())


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from physically_based_renderer_tpu_torch.ops import (blocktrace,
                                                         cuda_lib, fused,
                                                         gather, resident,
                                                         tonemap,
                                                         trace_blocks)

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. build the kernels, and the native builders from native/
    cuda_lib.library()
    build_s = cuda_lib.BUILD_SECONDS
    print(f"build: {build_s:.2f} s into {cuda_lib.build_dir()}")
    from physically_based_renderer_tpu_torch.accel import native
    if not native.available():
        raise AssertionError(f"the native library did not build: "
                             f"{native.BUILD_ERROR}")
    print(f"native builders: built in {native.BUILD_SECONDS:.2f} s")

    # 2-3. kernels against their plain versions
    k2, k2_ms, k2_plain_ms = phase_k2(dev)
    k3, k3_ms, k3_plain_ms = phase_k3(dev)
    print(f"K2 262144 camera rays x 32 tris: kernel {k2_ms:.4f} ms (wrapper "
          f"{k2.wrapper_ms:.4f}), bound {k2.bound[0]:.4f} ms, "
          f"{k2_ms / k2.bound[0]:.2f}x, plain {k2_plain_ms:.4f} ms "
          f"[{card_line()}]")
    print(f"K3 512x512: kernel {k3_ms:.4f} ms (wrapper "
          f"{k3['wrapper_ms']:.4f}), plain {k3_plain_ms:.4f} ms")
    threefry = phase_threefry(dev)

    # 4. K1 against its plain version; the reciprocal of K1, K2 and K4
    # (csrc/rcp.cuh) against division
    rcp_bad = trace_blocks.rcp_mismatches(dev)
    print(f"K1/K2/K4 reciprocal: {rcp_bad} floats with |x| in [1e-9, 2^126) "
          "differ from 1.0f / x")
    if rcp_bad:
        raise AssertionError("the reciprocal differs from 1.0f / x")
    resources = kernel_resources()
    k1, k1_ms, k1_plain_ms = phase_k1(dev)
    print(f"K1 262144 helmet_proc camera rays: kernel {k1_ms:.4f} ms "
          f"(wrapper {k1.wrapper_ms:.4f}), "
          f"plain {k1_plain_ms:.4f} ms")
    # K1 at 16 clusters a step: 72 KB of shared memory, the opt-in branch.
    k1c, k1c_ms, k1c_plain_ms = phase_k1(dev, "helmet_proc", chunk=16,
                                         held_to=k1.calls)
    print(f"K1 262144 helmet_proc camera rays at chunk=16: kernel "
          f"{k1c_ms:.4f} ms (wrapper {k1c.wrapper_ms:.4f}, bound "
          f"{k1c.bound[0]:.4f} as at chunk=4; the coarser exit adds "
          f"{k1c.work['tests_added_by_chunk']} tests), plain "
          f"{k1c_plain_ms:.4f} ms [{card_line()}]")
    asset = phase_helmet_asset(dev)
    k1h, k1h_ms, k1h_plain_ms = phase_k1(dev, "helmet")
    print(f"K1 262144 helmet camera rays at B=512: kernel {k1h_ms:.4f} ms "
          f"(wrapper {k1h.wrapper_ms:.4f}, bound {k1h.bound[0]:.4f}), "
          f"plain {k1h_plain_ms:.4f} ms")

    # 5. K4 against its plain version
    k4, k4_ms, k4_plain_ms = phase_k4(dev)
    print(f"K4 cornell frame 512x512 x 4 spp x 4 bounces: kernel "
          f"{k4_ms:.4f} ms (wrapper {k4['wrapper_ms']:.4f}), plain "
          f"{k4_plain_ms:.4f} ms")

    # 8. K5a and K5b against their plain versions
    k5 = phase_k5(dev)

    # Each kernel's launch count: (module, attribute).
    counters = {"fused": (fused, "LAUNCHES"),
                "resident": (resident, "LAUNCHES"),
                "trace_blocks": (trace_blocks, "LAUNCHES"),
                "tonemap": (tonemap, "LAUNCHES"),
                "gather_fwd": (gather, "LAUNCHES_FWD"),
                "gather_bwd": (gather, "LAUNCHES_BWD"),
                "phase_a": (blocktrace, "PHASE_A_LAUNCHES")}
    launches = {name: {} for name in counters}
    runs, goldens = {}, {}

    def drive(label, name, how, tmp, **over):
        """One run of a path with the counts reset just before it: (mean
        HDR image, its stats, the launches it made)."""
        for mod, attr in counters.values():
            setattr(mod, attr, 0)
        if how == "cli":
            png = Path(tmp) / f"{label}.png"
            hdr_path = Path(tmp) / f"{label}.npy"
            argv = [name, "-o", str(png), "--hdr-output", str(hdr_path),
                    "--stats", "--device", "cuda"]
            for flag, key in (("--width", "width"), ("--height", "height"),
                              ("--spp", "spp"), ("--bounces", "max_bounces")):
                if key in over:
                    argv += [flag, str(over[key])]
            stats = run_cli(argv)
            if png.read_bytes()[:8] != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("render CLI wrote no PNG")
            img = np.load(hdr_path)
        else:
            img, stats = render_direct(name, dev, how, **over)
        return img, stats, {k: getattr(mod, attr)
                            for k, (mod, attr) in counters.items()}

    with tempfile.TemporaryDirectory() as tmp:
        # 6. the main paths at full size
        for label, name, how in MAIN_PATHS:
            hdr, stats, got = drive(label, name, how, tmp)
            if hdr.shape != (512, 512, 3) or not np.isfinite(hdr).all():
                raise AssertionError(f"{label} film: shape {hdr.shape}, "
                                     f"finite {bool(np.isfinite(hdr).all())}")
            mean = float(hdr.mean())
            lo, hi = FILM_MEAN_BAND[label]
            if not lo <= mean <= hi:
                raise AssertionError(f"{label} film mean {mean} outside "
                                     f"({lo}, {hi})")
            if got != EXPECTED_LAUNCHES[label]:
                raise AssertionError(f"{label} main-path launches {got}, "
                                     f"expected {EXPECTED_LAUNCHES[label]}")
            for k in launches:
                launches[k][label] = got[k]
            runs[label] = {"seconds": stats["seconds"], "rays": stats["rays"],
                           "rays_per_s": stats["rays_per_s"],
                           "film_mean": mean, "launches": got}
            print(f"{label} 512x512: {stats['seconds']:.3f} s, "
                  f"{stats['rays']} ray queries, "
                  f"{stats['rays_per_s']:.4g} rays/s, film mean {mean:.5f}, "
                  f"launches {got}")

        # 7. goldens from the reference package
        for label, name, golden, (size, spp, bounces), how in GOLDENS:
            img, _, got = drive(f"{label}_golden", name, how, tmp,
                                width=size, height=size, spp=spp,
                                max_bounces=bounces)
            want_k4 = int(label == "cornell_ggx_fused")
            if got["fused"] != want_k4:
                raise AssertionError(f"{label} golden render made "
                                     f"{got['fused']} K4 launches, expected "
                                     f"{want_k4}")
            ref = np.load(golden)
            frac, n_bad = render_agreement(img, ref)
            mean_rel = abs(float(img.mean()) / float(ref.mean()) - 1.0)
            print(f"{label} golden {size}x{size}: {frac:.4%} pixels agree "
                  f"({n_bad} differ), mean rel diff {mean_rel:.3g}")
            if frac < PIXEL_FRAC or mean_rel > MEAN_REL:
                raise AssertionError(f"{label} {size}x{size} render "
                                     "disagrees with the golden")
            goldens[label] = {"size": size, "pixel_frac": frac,
                              "pixels_differ": n_bad, "mean_rel": mean_rel,
                              "launches": got}

        # 6c. the BVH walk, the XLA block tracer and batch_spp
        routes = phase_routes(dev, counters)
        for label, run in routes.items():
            for k in launches:
                launches[k][label] = run["launches"][k]

        # 14. --blinn-phong, --debug-checks, the soup-less grid, the native
        # builders and device_trace
        modules = phase_modules(dev, counters, tmp)
        for label in MODULE_LAUNCHES:
            for k in launches:
                launches[k][label] = modules[label]["launches"][k]

        # 15. the k = 32 sub-cluster route
        k32 = phase_k32(dev, counters)
        for k in launches:
            launches[k]["helmet_k32"] = k32["cold"]["launches"][k]

        # 16. grids without parent boxes (phase A's flat top-k), and
        # tools/dryrun.py::entry
        parentless = phase_parentless(dev, counters, k32)
        entry_run = phase_entry(counters)
        phase_a = phase_phase_a(dev, counters)
        for k in launches:
            launches[k]["helmet_parentless"] = (
                parentless["frame"]["launches"][k])
            launches[k]["entry"] = entry_run["warm"]["launches"][k]
            launches[k]["spd_tetra"] = phase_a["frame_launches"][k]

        # 6b. a .glb by path, a truncated one, the report CLI
        by_path = phase_glb_path(dev, tmp, counters)
        report = phase_report(tmp)

        # 9. the gradient path
        grad_golden = phase_grad_golden(dev)
        grad_step, got = phase_grad_step(counters, tmp)
        for k in launches:
            launches[k]["gradient_step"] = got[k]
        fit, got = phase_fit(counters, tmp)
        for k in launches:
            launches[k]["gradient_fit"] = got[k]
        if got["fused"] or not (got["gather_fwd"] and got["gather_bwd"]
                                and got["resident"]):
            raise AssertionError(f"fit launches {got}")
        profiled = phase_profile(dev)

    # 10. the probes, and the probe tool's run
    probe_times, probe_counts, probe_tool = phase_probes(dev)
    for kernel, count in probe_counts.items():
        launches[f"probe_{kernel}"] = {"probe_tool": count}

    # 12. the probes P5-P8, and their tools' runs
    mosaic_times, mosaic_counts = phase_mosaic(dev)
    for name, kernel, tool in (
            ("probe_mosaic_gather", "mosaic_gather", "probe_mosaic_tool"),
            ("probe_mosaic_stack", "mosaic_scalar_stack", "probe_mosaic_tool"),
            ("probe_chunk", "chunk", "probe_mosaic_tool"),
            ("subtile_dma", "subtile_copy", "exp_subtile_dma_tool")):
        launches[name] = {tool: mosaic_counts[kernel]}

    # 11. where a helmet frame's time goes, beside helmet_proc's
    frames = {name: phase_profile_frame(dev, name)
              for name in ("helmet", "helmet_proc")}

    # 13. parallel/ on one NCCL rank; its main paths' launches.  Last: the
    # profiled phases run before NCCL's threads start.
    with tempfile.TemporaryDirectory() as tmp:
        sharded = phase_sharded(dev, tmp, counters)
    for k in counters:
        launches[k]["sharded_helmet"] = sharded["helmet_launches"][k]
        launches[k]["sharded_step"] = sharded["step"]["launches"][k]
        launches[k]["render_cli_tiles1"] = (
            sharded["cli_tiles1"]["render_launches"][k])

    def entry(name, src, replaces, err, ms, wrapper_ms, plain_ms, bnd,
              library_ms):
        return {"name": name, "route": "cuda",
                "source": f"physically_based_renderer_tpu_torch/csrc/{src}",
                "replaces": (replaces if replaces.startswith("tools/")
                             else f"physically_based_renderer_tpu/{replaces}"),
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name], "max_abs_err": err,
                "ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": library_ms}

    print(json.dumps({"kernels": [
        {**entry("resident", "resident.cu", "ops/resident.py:54",
                 k2.max_abs_err, k2_ms, k2.wrapper_ms, k2_plain_ms, k2.bound,
                 None),
         "frame_ms": k2.frame["ms"], "frame_bound_ms": k2.frame["bound_ms"],
         "frame_gap_ms": k2.frame["gap_ms"]},
        entry("tonemap", "tonemap.cu", "ops/tonemap.py:52",
              k3["max_abs_err"], k3_ms, k3["wrapper_ms"], k3_plain_ms,
              k3["bound"], None),
        {"name": "threefry", "route": "cuda",
         "source": "physically_based_renderer_tpu_torch/csrc/threefry.cu",
         "replaces": None, "max_abs_err": 0.0,
         "launches_by_path": {"k4_frame": threefry["frame_launches"],
                              "gradient_step": profiled["rng_launches"]},
         **{k: threefry["calls"]["ray_uniform m=5"][k]
            for k in ("ms", "wrapper_ms", "plain_ms")},
         "bound_ms": threefry["calls"]["ray_uniform m=5"]["bound"][0],
         "bound_by": threefry["calls"]["ray_uniform m=5"]["bound"][1],
         "library_ms": None, "calls": threefry["calls"]},
        {"name": "phase_a", "route": "cuda",
         "source": "physically_based_renderer_tpu_torch/csrc/phase_a.cu",
         "replaces": None, "max_abs_err": 0.0,
         "launches": sum(launches["phase_a"].values()),
         "launches_by_path": launches["phase_a"],
         **{k: phase_a["calls"]["first sorted"][k]
            for k in ("ms", "wrapper_ms", "plain_ms", "bound_ms",
                      "bound_by")},
         "library_ms": None, "calls": phase_a["calls"]},
        {**entry("trace_blocks", "trace_blocks.cu", "ops/pallas_trace.py:54",
                 max(k1.max_abs_err, k32["k32_max_abs_err"],
                     parentless["max_abs_err"]), k1_ms,
                 k1.wrapper_ms, k1_plain_ms, k1.bound, None),
         "k32_camera_ms": k32["calls"]["k=32 camera closest"]["ms"],
         "k32_camera_bound_ms": k32["calls"]["k=32 camera closest"][
             "bound_ms"],
         "k32_camera_plain_ms": k32["camera_plain_ms"],
         "flat_lists_camera_ms": {
             k: parentless["calls"][f"{k} camera closest"]["ms"]
             for k in ("k=128", "k=32")},
         "flat_lists_camera_bound_ms": {
             k: parentless["calls"][f"{k} camera closest"]["bound_ms"]
             for k in ("k=128", "k=32")}},
        entry("fused", "fused.cu", "ops/fused.py:402", k4["max_abs_err"],
              k4_ms, k4["wrapper_ms"], k4_plain_ms, k4["bound"], None),
        entry("gather_fwd", "gather.cu", "ops/gather.py:47",
              k5["fwd_max_abs_err"], k5["fwd_ms"], k5["fwd_wrapper_ms"],
              k5["fwd_plain_ms"], k5["fwd_bound"], k5["fwd_library_ms"]),
        entry("gather_bwd", "gather.cu", "ops/gather.py:60",
              k5["bwd_max_abs_err_float"], k5["bwd_ms"],
              k5["bwd_wrapper_ms"], k5["bwd_plain_ms"], k5["bwd_bound"],
              k5["bwd_library_ms"]),
    ] + [
        entry(name, "probes.cu", replaces, e["max_abs_err"], e["ms"],
              e["wrapper_ms"], e["plain_ms"], e["bound"], e["library_ms"])
        for name, replaces in (("probe_scalar_stack", "tools/probe2.py:36"),
                               ("probe_relayout", "tools/probe2.py:103"),
                               ("probe_onehot_mm", "tools/probe2.py:133"))
        for e in (probe_times[name],)
    ] + [
        {**entry("probe_gather", "probes.cu", "tools/probe2.py:166",
                 e["max_abs_err"], e["ms"], e["wrapper_ms"], e["plain_ms"],
                 e["bound"], e["library_ms"]),
         "sector_ceiling_ms": e["sector_ceiling_ms"]}
        for e in (probe_times["probe_gather"],)
    ] + [
        entry(name, "mosaic.cu", replaces, e["max_abs_err"], e["ms"],
              e["wrapper_ms"], e["plain_ms"], e["bound"], e["library_ms"])
        for name, replaces in (
            ("probe_mosaic_gather", "tools/probe_mosaic.py:37"),
            ("probe_mosaic_stack", "tools/probe_mosaic.py:83"))
        for e in (mosaic_times[name],)
    ] + [
        {**entry("probe_chunk", "mosaic.cu", "tools/probe_mosaic.py:148",
                 e["max_abs_err"], e["ms"], e["wrapper_ms"], e["plain_ms"],
                 e["bound"], e["library_ms"]),
         "empty_kernel_ms": e["empty_kernel_ms"]}
        for e in (mosaic_times["probe_chunk"],)
    ] + [
        {**entry("subtile_dma", "mosaic.cu", "tools/exp_subtile_dma.py:14",
                 e["max_abs_err"], e["ms"], e["wrapper_ms"], e["plain_ms"],
                 e["bound"], e["library_ms"]),
         "p8_route": e["route"], "direct_ms": e["routes"]["direct"]["ms"],
         "copy_ceiling_ms": e["copy_ceiling_ms"],
         "yardstick_ms": e["yardstick_ms"], "yardstick": e["yardstick"]}
        for e in (mosaic_times["subtile_dma"],)
    ]}))
    print(json.dumps({
        "card": card, "build_s": build_s,
        "k2": {"rays_compared": k2.rays, "winner_mismatches": k2.mismatch,
               "max_abs_err_t": k2.max_abs_err, "ms": k2_ms,
               "wrapper_ms": k2.wrapper_ms, "plain_ms": k2_plain_ms,
               "bound_ms": k2.bound[0], "frame": k2.frame,
               "shape": "262144 camera rays x 32 tris"},
        "k3": {**k3, "ms": k3_ms, "plain_ms": k3_plain_ms,
               "shape": "512x512x3"},
        "threefry": threefry,
        "k1_rcp_mismatches": rcp_bad, "kernel_resources": resources,
        "k1": {"rays_compared": k1.rays, "winner_mismatches": k1.mismatch,
               "max_abs_err_t": k1.max_abs_err, "ms": k1_ms,
               "wrapper_ms": k1.wrapper_ms, "plain_ms": k1_plain_ms,
               "work": k1.work,
               "shape": "262144 helmet_proc camera rays x 1024 clusters"},
        "k4": {**k4, "ms": k4_ms, "plain_ms": k4_plain_ms,
               "shape": "cornell frame 512x512 x 4 spp x 4 bounces"},
        "k5": {**k5, "shape": "262144 rows x 86 columns from 32 rows"},
        "k1_helmet_b512": {
            "rays_compared": k1h.rays, "winner_mismatches": k1h.mismatch,
            "max_abs_err_t": k1h.max_abs_err, "ms": k1h_ms,
            "wrapper_ms": k1h.wrapper_ms, "plain_ms": k1h_plain_ms,
            "bound_ms": k1h.bound[0], "work": k1h.work,
            "k5a_emitter_rows": k1h.emitter_rows,
            "shape": "262144 helmet camera rays x 1024 clusters, B=512"},
        "k1_calls": {"helmet_proc B=256 chunk=4": k1.calls,
                     "helmet_proc B=256 chunk=16": k1c.calls,
                     "helmet B=512 chunk=4": k1h.calls},
        "k1_chunk16": {
            "rays_compared": k1c.rays, "winner_mismatches": k1c.mismatch,
            "max_abs_err_t": k1c.max_abs_err, "ms": k1c_ms,
            "wrapper_ms": k1c.wrapper_ms, "plain_ms": k1c_plain_ms,
            # The same rays need no more work at chunk=16 than at chunk=4:
            # both settings are held to the chunk=4 run's bound, and the
            # tests the coarser early exit adds are a number of their own.
            "bound_ms": k1c.bound[0], "work": k1c.work,
            "tests_added_by_chunk": k1c.work["tests_added_by_chunk"],
            "shape": "262144 helmet_proc camera rays, chunk=16 (72 KB)"},
        "helmet_asset": asset, "glb_by_path": by_path, "report": report,
        "probes": probe_times, "probe_tool": probe_tool,
        "probes_p5_p8": mosaic_times, "sharded": sharded,
        "profiled_frames": frames,
        "main_paths": runs, "routes": routes, "goldens": goldens,
        "modules": modules, "k32": k32, "parentless": parentless,
        "entry": entry_run, "phase_a": phase_a,
        "gradient": {"golden": grad_golden, "step": grad_step, "fit": fit,
                     "profiled_step": profiled},
        "seconds": time.perf_counter() - T0,
    }))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
