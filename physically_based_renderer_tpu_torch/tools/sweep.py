"""Time variants of K4, K5b, K2, P1-P8 against the tree's own
kernels, on the card.

    python -m physically_based_renderer_tpu_torch.tools.sweep \
        [--other NAME=DIR:fused.cu,gather.cu ...] [--variants ...] \
        [--cases k4,k5b,k2,p1,p2,p3,p4,p5,p6,p7,p8]

A variant is one source of `csrc/` with named textual edits (VARIANTS; an
edit must match the source exactly once, so a stale one fails; a variant
named for a case, `p5_...`, runs on that case alone; VARIANT_PLANS
names the route one also takes), another plan or route of P4's, P5's or
P8's (PLAN_VARIANTS: the tree's library with other values of
`ops/probes.py`'s P5 plan constants, or another `mosaic_gather_plan`,
`gather_plan` or `subtile_copy_route`), or the same source of another
checkout (`--other`, e.g. the parent commit unpacked with `git archive`
into the ignored `build/`; its C interface must be the tree's; P5's entry
point takes the tree's plan, and another checkout's P4 and P8 run their
direct routes, `pbr_probe_gather` and `pbr_subtile_copy`, at every shape:
OTHER_PLANS).  Each variant's source
is compiled with `cuda_lib`'s flags into a library of its own, all `nvcc`
processes started together (a named variant that does not compile is
reported and left out; another checkout's source that does not compile
stops the sweep); while a variant is timed, the wrappers of `ops/` call its
functions in place of the tree's (`cuda_lib._lib` is swapped for an
overlay).  Every variant is first held against the plain version on each
case, at the tolerances of `chip_smoke.py`.  Times are device times per
launch
(`tools/timing.py::device_ms`; P8 a call over all of its kernels, with
the route and CUDA events a call beside), taken in turns: the tree, each
variant, the tree again.  Cases: K4 on the cornell and cornell_ggx frames (512x512, 4
spp, 4 bounces); K5b on the calls of one gradient step's render()
backward, by shape, and at [32, 86] on uniformly random indices; K2 on the
calls of one dense cornell frame (512x512, 4 spp, 4 bounces;
`tools/work.py::dense_frame_calls`): the camera's closest hits, the
bounces' closest hits and the shadow rays' any hits, each kind's calls in
turn (exact against the plain version); P1 on the tool's all-pass boxes
and on trees of 5,001 and 8,191 nodes (`tools/probe2.py::tree_boxes`,
exact); P2 on the probe's tile by its elementwise route and by the kept
exchange route (`relayout(x, "exchange")`; another checkout's P2 is
called with the same exchange flag, so on the exchange case it runs its
own exchanging kernel, its `relayout` before the elementwise route, and
on the elementwise case that kernel's instantiation without moves; bit
for bit); P3 on the probe's data and on `tools/probe2.py::onehot_edge_inputs`
(exact, NaN for NaN); P4 at the five shapes of
`tools/probe2.py::GATHER_SHAPES` on the probe's data, checked also with
indices outside the axis and -0.0 in x (exact); P5 at the ten shapes of `tools/probe_mosaic.py::GATHER_CASES` on
random floats with indices in [-3 size, 3 size) (exact); P6 on the tool's
all-pass boxes, the probe's own and 8,191 nodes that all pass (exact); P7
on the tool's three data sets (`tools/probe_mosaic.py::CHUNK_DATA`, bit
for bit; the random data also at 4 chunks and at none); P8 at the
tool's shape and at 512 down to 64 blocks (P8_BLOCKS: where the routes
cross; bit for bit).
Only the variants of the chosen cases' sources are built.
Prints one line per (case, variant) and, last, one JSON object.  PERF.md
names the variants whose numbers it keeps.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import itertools
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_lib, fused, gather, probes, resident
from . import exp_subtile_dma, probe2, probe_mosaic, work
from .probe2 import card_line
from .timing import device_ms

# K2's steps, each an edit that takes one back out of csrc/resident.cu:
# IEEE division for every test (no rcp_rn); the soup staged and read as
# nine scalars a triangle (the [T, 9] rows, no float4); a shape (threads a
# block and rays a thread, closest-hit and any-hit); dead lanes traced as
# live ones; the plain version's select of inv, a compare for |det| >=
# 2^126 a test and separate compares with t_max and the best t.
_K2_DIVISION = [("        amax = fmaxf(amax, ad);\n        inv = rcp_rn(det);",
                 "        inv = 1.0f / det;")]
_K2_SCALAR = [(
    """  for (int k = threadIdx.x; k < 3 * n_pad; k += blockDim.x) {
    const int tri = k / 3;
    const float* src = soup + kSoupW * tri + 3 * (k - 3 * tri);
    s_tri[k] = tri < n_tris ? make_float4(src[0], src[1], src[2], 0.0f)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }""",
    """  float* s = reinterpret_cast<float*>(s_tri);
  for (int k = threadIdx.x; k < kSoupW * n_pad; k += blockDim.x)
    s[k] = k < kSoupW * n_tris ? soup[k] : 0.0f;"""), (
    """  a = s_tri[3 * k];
  b = s_tri[3 * k + 1];
  c = s_tri[3 * k + 2];""",
    """  const float* s = reinterpret_cast<const float*>(s_tri) + kSoupW * k;
  a = make_float4(s[0], s[1], s[2], 0.0f);
  b = make_float4(s[3], s[4], s[5], 0.0f);
  c = make_float4(s[6], s[7], s[8], 0.0f);""")]


def _k2_shape(threads_closest, rays_closest, threads_any, rays_any,
              lanes_any=512):
    return [("constexpr int kThreadsClosest = 128, kRaysClosest = 2;\n"
             "constexpr int kThreadsAny = 256, kRaysAny = 1;\n"
             "constexpr int kLanesAny = 512;",
             f"constexpr int kThreadsClosest = {threads_closest}, "
             f"kRaysClosest = {rays_closest};\n"
             f"constexpr int kThreadsAny = {threads_any}, "
             f"kRaysAny = {rays_any};\n"
             f"constexpr int kLanesAny = {lanes_any};")]


def _k2_threads_an_sm(threads):
    return [("constexpr int kThreadsAnSm = 768;",
             f"constexpr int kThreadsAnSm = {threads};")]


_K2_NO_SKIP = [("    live[s] = in && t_max[i] > t_min;", "    live[s] = in;")]
_K2_UNTRIMMED = [
    ("        inv = 1.0f / det;",
     "        inv = nonzero ? 1.0f / det : 0.0f;"),
    ("  float amax = 0.0f;", "  bool outside = false;"),
    ("        amax = fmaxf(amax, ad);\n        inv = rcp_rn(det);",
     "        outside |= ad >= kRcpHi;\n"
     "        inv = nonzero ? rcp_rn(det) : 0.0f;"),
    ("  return amax >= kRcpHi;", "  return outside;"),
    ("uu + vv <= 1.0f && tt > t_min;",
     "uu + vv <= 1.0f && tt > t_min && tt < rtm[r];"),
    ("occ[r] = occ[r] || (ok && tt < rtm[r]);", "occ[r] = occ[r] || ok;"),
    ("    lim[r] = fminf(rtm[r], kBig);", "    lim[r] = kBig;")]

def _p6_threads(threads):
    return [("constexpr int kScalarThreads = 512;",
             f"constexpr int kScalarThreads = {threads};")]


def _p4_threads(threads):
    return [("constexpr int kTakeThreads = 256;   // P4 direct route and "
             "sector reads",
             f"constexpr int kTakeThreads = {threads};")]


def _p4_consecutive(n):
    """P4's direct route with n (a multiple of 4) consecutive outputs a
    thread: where lanes % n == 0 and idx and out are 16-byte aligned, their
    indices read as int4s, the n gathers in flight together, and float4
    stores; else one at a time."""
    return [(
        """  const unsigned e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const unsigned row = e / unsigned(lanes);
  const unsigned col = e - row * unsigned(lanes);
  const int hi = (kAxis == 0 ? rows : lanes) - 1;
  const unsigned k = unsigned(min(max(__ldg(idx + e), 0), hi));
  out[e] = __ldg(x + (kAxis == 0 ? k * unsigned(lanes) + col
                                 : row * unsigned(lanes) + k));""",
        f"""  constexpr int kN = {n};
  const unsigned e0 = (blockIdx.x * blockDim.x + threadIdx.x) * kN;
  if (e0 >= total) return;
  const int hi = (kAxis == 0 ? rows : lanes) - 1;
  if (lanes % kN == 0 && aligned16(idx) && aligned16(out)) {{
    const unsigned row = e0 / unsigned(lanes);
    const unsigned col = e0 - row * unsigned(lanes);
    int k[kN];
    float v[kN];
#pragma unroll
    for (int q = 0; q < kN / 4; ++q) {{
      const int4 t = __ldg(reinterpret_cast<const int4*>(idx + e0) + q);
      k[4 * q] = t.x;
      k[4 * q + 1] = t.y;
      k[4 * q + 2] = t.z;
      k[4 * q + 3] = t.w;
    }}
#pragma unroll
    for (int j = 0; j < kN; ++j) {{
      const unsigned kk = unsigned(min(max(k[j], 0), hi));
      v[j] = __ldg(x + (kAxis == 0 ? kk * unsigned(lanes) + col + j
                                   : row * unsigned(lanes) + kk));
    }}
#pragma unroll
    for (int q = 0; q < kN / 4; ++q)
      reinterpret_cast<float4*>(out + e0)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    return;
  }}
  for (unsigned e = e0; e < min(e0 + kN, total); ++e) {{
    const unsigned row = e / unsigned(lanes);
    const unsigned col = e - row * unsigned(lanes);
    const unsigned k = unsigned(min(max(__ldg(idx + e), 0), hi));
    out[e] = __ldg(x + (kAxis == 0 ? k * unsigned(lanes) + col
                                   : row * unsigned(lanes) + k));
  }}"""), (
        """  const unsigned blocks = unsigned((total + kTakeThreads - 1) /
                                   kTakeThreads);""",
        f"""  const unsigned blocks = unsigned((total + {n} * kTakeThreads - 1) /
                                   ({n} * kTakeThreads));""")]


_P6_CTAS = [(
    """__global__ void __launch_bounds__(kScalarThreads)
    mosaic_scalar_stack_kernel(const float* __restrict__ boxes, int n_nodes,
                               int* __restrict__ out) {
  __shared__ unsigned char s_open[pbr::kTreeMaxNodes / 2];
  __shared__ int s_open_count;
  const int m = (n_nodes - 1) / 2;  // inner nodes: both children exist
  pbr::tree_pass_bits(boxes, m, s_open);
  if (threadIdx.x == 0) s_open_count = 0;
  __syncthreads();""",
    """constexpr int kStackCtas = 8;
__device__ unsigned char g_pass[pbr::kTreeMaxNodes / 2];
__device__ unsigned int g_arrived;

__global__ void __launch_bounds__(kScalarThreads)
    mosaic_scalar_stack_kernel(const float* __restrict__ boxes, int n_nodes,
                               int* __restrict__ out) {
  __shared__ unsigned char s_open[pbr::kTreeMaxNodes / 2];
  __shared__ int s_open_count;
  __shared__ bool s_last;
  const int m = (n_nodes - 1) / 2;  // inner nodes: both children exist
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x) {
    const float* b = boxes + 6 * i;
    g_pass[i] = pbr::box_passes(b[0], b[1], b[2], b[3], b[4], b[5]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&g_arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const volatile unsigned char* pass = g_pass;
  for (int i = threadIdx.x; i < m; i += blockDim.x) s_open[i] = pass[i];
  if (threadIdx.x == 0) {
    s_open_count = 0;
    g_arrived = 0;
  }
  __syncthreads();"""), (
    "mosaic_scalar_stack_kernel<<<1, kScalarThreads, 0,",
    "mosaic_scalar_stack_kernel<<<kStackCtas, kScalarThreads, 0,")]

def _p7_rays(rays):
    return [("constexpr int kChunkRays = 2;        // P7 rays a thread (and "
             "a CTA)", f"constexpr int kChunkRays = {rays};")]


def _p7_threads(threads):
    return [("constexpr int kChunkThreads = 512;   // P7 threads a CTA",
             f"constexpr int kChunkThreads = {threads};")]


# P7: e0 and e1 of every (chunk, column) computed once a CTA into shared
# memory (static, for the tool's 8 x 512), then read by the tests, in
# place of an item's own registers.
_P7_SMEM = [(
    """  float t0 = 0.0f, t1 = 0.0f;
  if (threadIdx.x < items) {
    const int c = threadIdx.x % w;
    t0 = __ldg(t + c);
    t1 = __ldg(t + w + c);
  }""",
    """  __shared__ float2 s_e[8 * 512];  // [chunk][w]
  for (int q = threadIdx.x; q < items * kGroup; q += kChunkThreads) {
    const int j = q / w, c = q - j * w;
    const float scale = float(j) + 1.0f;
    s_e[q] = make_float2((__ldg(t + c) * scale) * 1.0001f,
                         (__ldg(t + w + c) * scale) * 1.0001f);
  }
  __syncthreads();"""), (
    """    float e0[kGroup], e1[kGroup];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      const float scale = float(j0 + m) + 1.0f;
      e0[m] = (t0 * scale) * 1.0001f;
      e1[m] = (t1 * scale) * 1.0001f;
    }
    if (q + kChunkThreads < items) {
      const int c = (q + kChunkThreads) % w;
      t0 = __ldg(t + c);
      t1 = __ldg(t + w + c);
    }""",
    """    const int c = q % w;
    float e0[kGroup], e1[kGroup];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      const float2 e = s_e[(j0 + m) * w + c];
      e0[m] = e.x;
      e1[m] = e.y;
    }""")]


def _p7_group(group):
    """P7 in groups of `group` chunks at every n_chunks."""
    return [("  if (n_chunks % 8 == 0)\n    mosaic_chunk_kernel<8>",
             "  if (false)\n    mosaic_chunk_kernel<8>"),
            ("    mosaic_chunk_kernel<4><<<",
             f"    mosaic_chunk_kernel<{group}><<<")]


# P8's row-sum-first route in two launches: the row sums, then the gather
# launched with programmatic stream serialization (its CTAs may start
# while the row sums finish, and wait at griddepcontrol.wait for them).
_P8_TWO_LAUNCHES = [(
    """  tile_row_sums(reinterpret_cast<const float4*>(src), n_src,
                reinterpret_cast<float4*>(rows));
  cooperative_groups::this_grid().sync();
  gather_row_sums(idx, reinterpret_cast<const float4*>(rows), n_src, nb,
                  n_iters, ch, reinterpret_cast<float4*>(out));
}""",
    """  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  tile_row_sums(reinterpret_cast<const float4*>(src), n_src,
                reinterpret_cast<float4*>(rows));
}

__global__ void __launch_bounds__(kRowSumThreads)
    subtile_copy_kernel_row_gather(const float* __restrict__ src,
                                   const int* __restrict__ idx, int n_src,
                                   int nb, int n_iters, int ch, float* rows,
                                   float* __restrict__ out) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  gather_row_sums(idx, reinterpret_cast<const float4*>(rows), n_src, nb,
                  n_iters, ch, reinterpret_cast<float4*>(out));
}"""), (
    """  void* args[] = {&src, &idx, &n_src, &nb, &n_iters, &ch, &rows, &out};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(subtile_copy_kernel_row_sums), blocks,
      kRowSumThreads, args, 0, static_cast<cudaStream_t>(stream));
  return int(err != cudaSuccess ? err : cudaGetLastError());""",
    """  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  subtile_copy_kernel_row_sums<<<blocks, kRowSumThreads, 0, s>>>(
      src, idx, n_src, nb, n_iters, ch, rows, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kRowSumThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, subtile_copy_kernel_row_gather, src, idx,
                           n_src, nb, n_iters, ch, rows, out);
  return int(err != cudaSuccess ? err : cudaGetLastError());""")]


def _p8_threads(threads):
    return [("constexpr int kRowSumThreads = 256;  // P8 row-sum-first route",
             f"constexpr int kRowSumThreads = {threads};")]


# P8's direct route with each step's ch tiles copied by the TMA
# (cp.async.bulk, 2 KB a tile, one thread issuing) onto an mbarrier a slot,
# in place of 16-byte cp.async from every thread.
_P8_TMA = [(
    """  auto issue = [&](int j) {
    float4* dst = slots4 + size_t(j & 1) * (slot_floats / 4);
    for (int q = threadIdx.x; q < ch * kTileChunks; q += blockDim.x) {
      const int i = q / kTileChunks;
      const int piece = q - i * kTileChunks;
      const int tile = min(max(my_idx[j * ch + i], 0), n_src - 1);
      cp_async16(dst + i * kTileChunks + piece,
                 reinterpret_cast<const float4*>(src) +
                     size_t(tile) * kTileChunks + piece);
    }
    cp_async_commit();
  };""",
    """  __shared__ unsigned long long s_bar[2];
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(
          unsigned(__cvta_generic_to_shared(s_bar + k))));
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int j) {
    if (threadIdx.x != 0) return;
    float4* dst = slots4 + size_t(j & 1) * (slot_floats / 4);
    const unsigned bar = unsigned(__cvta_generic_to_shared(s_bar + (j & 1)));
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n" ::"r"(
            bar), "r"(unsigned(ch * kTileFloats * 4)) : "memory");
    for (int i = 0; i < ch; ++i) {
      const int tile = min(max(my_idx[j * ch + i], 0), n_src - 1);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\\n" ::"r"(unsigned(
              __cvta_generic_to_shared(dst + i * kTileChunks))),
          "l"(src + size_t(tile) * kTileFloats),
          "r"(unsigned(kTileFloats * 4)), "r"(bar) : "memory");
    }
  };
  auto wait = [&](int j) {
    const unsigned bar = unsigned(__cvta_generic_to_shared(s_bar + (j & 1)));
    asm volatile(
        "{\\n .reg .pred P1;\\n LAB_WAIT:\\n"
        " mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\\n"
        " @P1 bra DONE;\\n bra LAB_WAIT;\\n DONE:\\n }\\n" ::"r"(bar),
        "r"(unsigned((j >> 1) & 1)) : "memory");
  };"""), (
    """    if (j + 1 < n_iters) {
      issue(j + 1);
      cp_async_wait<1>();  // step j's copies have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();""",
    """    if (j + 1 < n_iters) issue(j + 1);
    wait(j);
    __syncthreads();""")]


def _slab_wherever_it_fits(rows, lanes, axis, reps=1):
    return probes.slab_plan(rows, lanes, axis) or probes.direct_plan()


def _two_column_slab(split: bool):
    """P4's plan with a slab of 2 columns (at [16384, 128] 128 KiB a CTA,
    staged in 8-byte pieces) where no slab of P5's plan fits along axis 0,
    the tree's plan elsewhere.  With split, the CTAs of a slab split its
    output rows to fill the SMs (P5_SMS), whatever they restage; without,
    each slab is staged once."""
    def plan(rows, lanes, axis):
        if (axis != 0 or probes.slab_plan(rows, lanes, axis) is not None
                or rows * 2 * 4 > probes.P5_SMEM):
            return probes.mosaic_gather_plan(rows, lanes, axis, 1)
        n = max(1, probes.P5_SMS // -(-lanes // 2)) if split else 1
        per = -(-rows // n)
        return probes.GatherPlan("slab", 2, per,
                                 min(probes.P5_THREADS, -(-per * 2 // 32) * 32))
    return plan


# P5 plans other than the tree's: name -> the attributes of ops/probes.py
# set while the variant runs.
PLAN_VARIANTS = {
    # the L1/L2 route at every shape
    "p5_direct": {"mosaic_gather_plan": lambda *_: probes.direct_plan()},
    # a slab wherever one fits (the direct route for no small call)
    "p5_slab": {"mosaic_gather_plan": _slab_wherever_it_fits},
    # axis 0: wider and narrower slabs (bytes restaged against bank
    # conflicts)
    "p5_columns32": {"P5_COLUMNS": 32},
    "p5_columns8": {"P5_COLUMNS": 8},
    "p5_columns4": {"P5_COLUMNS": 4},
    # twice and half the bytes restaged
    "p5_restage16": {"P5_RESTAGE": 16 << 20},
    "p5_restage4": {"P5_RESTAGE": 4 << 20},
    # threads a CTA at most
    "p5_threads256": {"P5_THREADS": 256},
    "p5_threads512": {"P5_THREADS": 512},
    # CTAs the plan aims at: half a wave (fewer slabs restaged), two waves
    "p5_ctas66": {"P5_SMS": 66},
    "p5_ctas264": {"P5_SMS": 264},
    # P4: the direct route at every shape; a slab wherever one fits
    "p4_direct": {"gather_plan": lambda *_: probes.direct_plan()},
    "p4_slab": {"gather_plan": _slab_wherever_it_fits},
    # P4 at [16384, 128]: 2-column slabs, 2 CTAs a slab (128 CTAs, 16 MiB
    # restaged) or one (64 CTAs, the table staged once)
    "p4_slab2": {"gather_plan": _two_column_slab(True)},
    "p4_slab2_once": {"gather_plan": _two_column_slab(False)},
    # P8: the direct route at every shape; the row-sum-first route at every
    # shape
    "p8_direct": {"subtile_copy_route": lambda *_: "direct"},
    "p8_row_sums": {"subtile_copy_route": lambda *_: "row_sums"},
}

# Another checkout's P4 has the direct route alone (`pbr_probe_gather`):
# its runs take it at every shape.
OTHER_PLANS = {"p4": {"gather_plan": lambda *_: probes.direct_plan()},
               "p8": {"subtile_copy_route": lambda *_: "direct"}}

# Source variants that also run on another route: name -> the attributes
# of ops/probes.py set while they run.
VARIANT_PLANS = {"p8_tma": {"subtile_copy_route": lambda *_: "direct"}}

# Kernel launches a call of a source variant, where not one.
VARIANT_LAUNCHES = {"p8_two_launches": 2}

# name -> (source, [(text, replacement), ...]).
VARIANTS = {
    # K2, the steps in order: 1 rcp_rn in groups of four; 2 float4
    # geometry; 3 two rays a thread; 4 dead lanes packed out (256 threads
    # x 2 rays, a lane a ray, at most 128 registers); 5 (the tree) a shape
    # a kind, fewer instructions a test, two lanes an any-hit thread.
    "k2_step1": ("resident.cu", _K2_UNTRIMMED + _k2_shape(256, 1, 256, 1, 256)
                 + _k2_threads_an_sm(512) + _K2_SCALAR + _K2_NO_SKIP),
    "k2_step2": ("resident.cu", _K2_UNTRIMMED + _k2_shape(256, 1, 256, 1, 256)
                 + _k2_threads_an_sm(512) + _K2_NO_SKIP),
    "k2_step3": ("resident.cu", _K2_UNTRIMMED + _k2_shape(256, 2, 256, 2, 512)
                 + _k2_threads_an_sm(512) + _K2_NO_SKIP),
    "k2_step4": ("resident.cu", _K2_UNTRIMMED + _k2_shape(256, 2, 256, 2, 512)
                 + _k2_threads_an_sm(512)),
    # K2: the tree with one thing taken out or changed.
    "k2_untrimmed": ("resident.cu", _K2_UNTRIMMED),
    "k2_division": ("resident.cu", _K2_DIVISION),
    "k2_scalar_geometry": ("resident.cu", _K2_SCALAR),
    "k2_no_skip": ("resident.cu", _K2_NO_SKIP),
    "k2_closest_256x2": ("resident.cu", _k2_shape(256, 2, 256, 1)),
    "k2_any_lanes256": ("resident.cu", _k2_shape(128, 2, 256, 1, 256)),
    "k2_any_lanes1024": ("resident.cu", _k2_shape(128, 2, 256, 1, 1024)),
    "k2_any_128x1": ("resident.cu", _k2_shape(128, 2, 128, 1, 256)),
    "k2_any_256x2": ("resident.cu", _k2_shape(128, 2, 256, 2, 512)),
    # K2: threads an SM asked of ptxas (the registers a thread it may give).
    "k2_registers64": ("resident.cu", _k2_threads_an_sm(1024)),
    "k2_registers128": ("resident.cu", _k2_threads_an_sm(512)),
    # P1: each node's reach from its own ancestors, every node at once,
    # in place of a level at a time with a barrier a level.
    "p1_ancestors": ("probes.cu", [(
        """  pbr::block_add(pbr::tree_levels(n_nodes, s_open), &s_visited);""",
        """  __shared__ unsigned char s_reach[kMaxNodes];
  int visited = 0;
  for (int i = tid; i < n_nodes; i += nt) {
    unsigned char up = 1;
    for (int a = i; a > 0;) {
      a = (a - 1) >> 1;
      up &= s_open[a];
    }
    s_reach[i] = up;
    visited += up;
  }
  __syncthreads();
  for (int i = tid; i < n_nodes; i += nt) s_open[i] &= s_reach[i];
  __syncthreads();
  pbr::block_add(visited, &s_visited);""")]),
    # P1: threads of its one CTA.
    "p1_threads256": ("probes.cu", [("constexpr int kStackThreads = 512;",
                                     "constexpr int kStackThreads = 256;")]),
    "p1_threads1024": ("probes.cu", [("constexpr int kStackThreads = 512;",
                                      "constexpr int kStackThreads = 1024;")]),
    # P2's elementwise route: one warp of 8 float4s a lane; 128 threads
    # of two.
    "p2_warp": ("probes.cu", [("constexpr int kRelayoutThreads = 256;",
                               "constexpr int kRelayoutThreads = 32;")]),
    "p2_threads128": ("probes.cu", [("constexpr int kRelayoutThreads = 256;",
                                     "constexpr int kRelayoutThreads = 128;")]),
    # P3: output rows a CTA (two threads a row).
    "p3_outs64": ("probes.cu", [("constexpr int kOhOuts = 128;",
                                 "constexpr int kOhOuts = 64;")]),
    "p3_outs256": ("probes.cu", [("constexpr int kOhOuts = 128;",
                                  "constexpr int kOhOuts = 256;")]),
    # P4's direct route: four or eight consecutive outputs a thread (int4
    # index loads, the gathers in flight together, float4 stores); threads
    # a CTA; x read through L2 alone (ld.global.cg: no L1 line allocated
    # for a random row).
    "p4_direct4": ("probes.cu", _p4_consecutive(4)),
    "p4_direct8": ("probes.cu", _p4_consecutive(8)),
    "p4_threads128": ("probes.cu", _p4_threads(128)),
    "p4_threads512": ("probes.cu", _p4_threads(512)),
    "p4_l2": ("probes.cu", [("  out[e] = __ldg(x + (kAxis == 0",
                             "  out[e] = __ldcg(x + (kAxis == 0")]),
    # P6: threads of its one CTA.
    "p6_threads256": ("mosaic.cu", _p6_threads(256)),
    "p6_threads1024": ("mosaic.cu", _p6_threads(1024)),
    # P6: the pass bits spread over 8 CTAs, written to global memory; the
    # last CTA to finish (a global counter after a __threadfence) runs the
    # levels.
    "p6_ctas8": ("mosaic.cu", _P6_CTAS),
    # K5b: rows a warp takes at a time.
    "k5b_run64": ("gather.cu", [("constexpr int kBwdRun = 32;",
                                 "constexpr int kBwdRun = 64;")]),
    "k5b_run128": ("gather.cu", [("constexpr int kBwdRun = 32;",
                                  "constexpr int kBwdRun = 128;")]),
    # K5b: rows loaded before any is added.
    "k5b_ahead4": ("gather.cu", [("constexpr int kBwdAhead = 8;",
                                  "constexpr int kBwdAhead = 4;")]),
    "k5b_ahead16": ("gather.cu", [("constexpr int kBwdAhead = 8;",
                                   "constexpr int kBwdAhead = 16;")]),
    # K5b: threads a block (and so warps sharing the SM).
    "k5b_threads256": ("gather.cu", [("constexpr int kBwdThreads = 1024;",
                                      "constexpr int kBwdThreads = 256;")]),
    "k5b_threads512": ("gather.cu", [("constexpr int kBwdThreads = 1024;",
                                      "constexpr int kBwdThreads = 512;")]),
    "k5b_threads768": ("gather.cu", [("constexpr int kBwdThreads = 1024;",
                                      "constexpr int kBwdThreads = 768;")]),
    # K5b: read every row, so that no load waits for the indices (a row
    # whose index lies outside the table is summed and then dropped).
    "k5b_load_all": ("gather.cu", [(
        "a + u < m && ks[u] >= 0 && c < w ?", "a + u < m && c < w ?")]),
    # K5b: the block's one table (shared-memory atomics) where a table a
    # warp would fit.
    "k5b_block_table": ("gather.cu", [(
        "if (kBwdWarps * table <= size_t(optin))", "if (false)")]),
    # K4: IEEE division for every test (no branch-free reciprocal).
    "k4_division": ("fused.cu", [(
        "    *outside |= ad >= kRcpHi;\n"
        "    inv = nonzero ? rcp_rn(det) : 0.0f;",
        "    inv = nonzero ? 1.0f / det : 0.0f;")]),
    # K4: registers a thread, from 64 (32 warps an SM) to 85 (24) and
    # unbounded (ptxas' choice).
    "k4_registers85": ("fused.cu", [(
        "__launch_bounds__(kThreads, 1024 / kThreads)",
        "__launch_bounds__(kThreads, 768 / kThreads)")]),
    "k4_registers_unbounded": ("fused.cu", [(
        "__launch_bounds__(kThreads, 1024 / kThreads)",
        "__launch_bounds__(kThreads)")]),
    # K4: threads a block.
    "k4_threads256": ("fused.cu", [("constexpr int kThreads = 1024;",
                                    "constexpr int kThreads = 256;")]),
    "k4_threads512": ("fused.cu", [("constexpr int kThreads = 1024;",
                                    "constexpr int kThreads = 512;")]),
    # K4: the division where |det| >= 2^126 chosen test by test, not by
    # running the group again.
    "k4_fallback_per_test": ("fused.cu", [(
        "    *outside |= ad >= kRcpHi;\n"
        "    inv = nonzero ? rcp_rn(det) : 0.0f;",
        "    inv = nonzero ? (ad >= kRcpHi ? 1.0f / det : rcp_rn(det)) "
        ": 0.0f;")]),
    # P7: rays a thread (and a CTA: 256, 64 or 32 CTAs for the tool's 256
    # rays); threads a CTA; e0 and e1 staged in shared memory; IEEE
    # division for every test (no rcp_rn).
    "p7_rays1": ("mosaic.cu", _p7_rays(1)),
    "p7_rays4": ("mosaic.cu", _p7_rays(4)),
    "p7_rays8": ("mosaic.cu", _p7_rays(8)),
    "p7_threads256": ("mosaic.cu", _p7_threads(256)),
    "p7_threads1024": ("mosaic.cu", _p7_threads(1024)),
    "p7_smem": ("mosaic.cu", _P7_SMEM),
    # P7: chunks a group of tests (and an item) at every n_chunks: 4 (at
    # the tool's 8 chunks, two items a column) or 2.
    "p7_group4": ("mosaic.cu", _p7_group(4)),
    "p7_group2": ("mosaic.cu", _p7_group(2)),
    "p7_division": ("mosaic.cu", [(
        "        amax = fmaxf(amax, ad);\n        inv = rcp_rn(det);",
        "        inv = 1.0f / det;")]),
    # P8: the row-sum-first route in two launches (programmatic dependent
    # launch) in place of one cooperative launch; its threads a CTA; the
    # direct route's copies by the TMA.
    "p8_two_launches": ("mosaic.cu", _P8_TWO_LAUNCHES),
    "p8_threads128": ("mosaic.cu", _p8_threads(128)),
    "p8_threads512": ("mosaic.cu", _p8_threads(512)),
    "p8_tma": ("mosaic.cu", _P8_TMA),
    # P8: each thread's first gather unit's indices prefetched into L1
    # before the row sums, so that the gather after the barrier finds them
    # there.
    "p8_prefetch_idx": ("mosaic.cu", [(
        """  tile_row_sums(reinterpret_cast<const float4*>(src), n_src,
                reinterpret_cast<float4*>(rows));
  cooperative_groups::this_grid().sync();""",
        """  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u < nb * ch * kRowQuads) {
    const int gi = u >> 3, g = gi / ch;
    const int* my = idx + size_t(g) * n_iters * ch + (gi - g * ch);
    for (int j = 0; j < n_iters; j += 32 / ch)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(my + j * ch));
  }
  tile_row_sums(reinterpret_cast<const float4*>(src), n_src,
                reinterpret_cast<float4*>(rows));
  cooperative_groups::this_grid().sync();""")]),
}

# Tolerances of chip_smoke.py.
K5B_REL = 1e-5
PIXEL_FRAC, ATOL, RTOL, MEAN_REL, COUNT_REL = 0.99, 1e-4, 1e-3, 5e-3, 5e-3


def build_variants(names, others, out_dir: Path) -> dict:
    """{name: (source, library path)} of every variant, all compiled at
    once with cuda_lib's flags.  A named variant that does not compile is
    left out; another checkout's source must compile."""
    jobs = {}
    for name in names:
        src, edits = VARIANTS[name]
        text = (cuda_lib.CSRC / src).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise ValueError(f"variant {name}: {old!r} occurs "
                                 f"{text.count(old)} times in {src}")
            text = text.replace(old, new)
        jobs[name] = (src, text, cuda_lib.CSRC)
    for spec in others:
        name, rest = spec.split("=", 1)
        root, sources = rest.rsplit(":", 1)
        csrc = Path(root) / "physically_based_renderer_tpu_torch" / "csrc"
        for src in sources.split(","):
            jobs[f"{name}_{src.split('.')[0]}"] = (
                src, (csrc / src).read_text(), csrc)
    cmds, libs = [], {}
    for name, (src, text, inc) in jobs.items():
        path = out_dir / f"{name}.cu"
        path.write_text(text)
        lib = out_dir / f"lib{name}.so"
        cmds.append([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", str(inc),
                     "-shared", "-o", str(lib), str(path)])
        libs[name] = (src, lib)
    procs = [(name, subprocess.Popen(c, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
             for name, c in zip(libs, cmds)]
    failed = []
    for name, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode == 0:
            continue
        if name not in VARIANTS:
            failed.append(name)
        print(f"variant {name} does not compile:\n{out}")
        del libs[name]
    if failed:
        raise RuntimeError(f"another checkout's sources do not compile: "
                           f"{failed}")
    return libs


class _Overlay:
    """The variant's functions, and the tree's for every other name."""

    def __init__(self, lib, base):
        self._lib, self._base = lib, base

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return getattr(self._base, name)


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return _Overlay(lib, cuda_lib.library())


def k4_cases(dev):
    from ..core import rng
    from ..utils import config
    out = {}
    for name in ("cornell", "cornell_ggx"):
        bc = config.get(name)
        scene, cam = config.build_scene(bc.scene, dev)
        out[f"K4 {name}"] = fused.fused_frame(scene, cam, rng.key(0, dev),
                                              bc.render)
    return out


def k4_check(frame):
    hdr, count = fused.fused_kernel(frame)
    plain, count_p = fused.fused_plain(frame)
    hdr, plain = hdr / frame.spp, plain / frame.spp
    close = (hdr - plain).abs() <= ATOL + RTOL * plain.abs()
    frac = float(close.all(dim=-1).float().mean())
    mean_rel = abs(float(hdr.mean()) / float(plain.mean()) - 1.0)
    count_rel = abs(int(count) / int(count_p) - 1.0)
    if frac < PIXEL_FRAC or mean_rel > MEAN_REL or count_rel > COUNT_REL:
        raise AssertionError(f"K4 disagrees: {frac:.4%} pixels, mean "
                             f"{mean_rel:.3g}, count {count_rel:.3g}")


def k5b_cases(dev):
    """{label: [(idx, ct, T), ...]}: one gradient step's K5b calls by
    shape, and cornell's shape on random indices."""
    out = {}
    for idx, ct, t in work.gradient_step_calls(dev):
        out.setdefault(f"K5b step T={t} W={ct.shape[1]}", []).append(
            (idx, ct, t))
    g = torch.Generator(device=dev).manual_seed(8)
    out["K5b random T=32 W=86"] = [(
        torch.randint(0, 32, (262_144,), device=dev, generator=g,
                      dtype=torch.int32),
        torch.randn((262_144, 86), device=dev, generator=g), 32)]
    return out


def k5b_check(calls):
    for idx, ct, t in calls:
        got = gather.gather_bwd(idx, ct, t)
        plain = gather.take_rows_bwd_plain(idx, ct, t)
        if (got - plain).abs().max() > K5B_REL * plain.abs().max():
            raise AssertionError("K5b disagrees with its plain version")


def k2_cases(dev):
    """{label: [(soup, o, d, t_max, t_min, any_hit), ...]}: one dense
    cornell frame's K2 calls by kind."""
    out = {}
    for _, bounce, call in work.dense_frame_calls(dev):
        kind = ("any-hit" if call[5] else
                "camera closest" if bounce == 0 else "bounce closest")
        out.setdefault(f"K2 frame {kind}", []).append(call)
    return out


def k2_check(calls):
    for call in calls:
        got = resident.trace(*call)
        plain = resident.trace_plain(*call)
        if call[5]:
            got, plain = (got,), (plain,)
        if not all(torch.equal(a, b) for a, b in zip(got, plain)):
            raise AssertionError("K2 differs from its plain version")


def p1_cases(dev):
    """{label: boxes}: the tool's all-pass boxes and two larger trees."""
    return {"P1 2047 all pass": probe2.scalar_stack_boxes("all"),
            "P1 5001 pass 0.9": probe2.tree_boxes(5001, 0.9),
            "P1 8191 all pass": probe2.tree_boxes(8191, 1.0)}


def p1_check(boxes):
    got = probes.scalar_stack(boxes)
    plain = probes.scalar_stack_plain(boxes)
    if not all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, plain)):
        raise AssertionError("P1 differs from its plain version")


# P5 calls beside the tool's: rows of 64 KB and 16 KB along axis 1, where
# a direct CTA's gathers reach beyond what it reuses; the large tables at
# fewer and more reps.
P5_SWEEP_SHAPES = ((16, 16384, 1, 4), (64, 4096, 1, 8), (4096, 128, 0, 1),
                   (4096, 128, 0, 4), (1024, 512, 0, 1), (1024, 512, 0, 2),
                   (256, 512, 0, 1), (256, 512, 1, 1))


def p2_cases(dev):
    """{label: (x, route)}: the probe's tile by both routes."""
    x = torch.from_numpy(probe2.relayout_input()).to(dev)
    return {f"P2 [8,128] {route}": (x, route)
            for route in probes.RELAYOUT_ROUTES}


def p2_check(case):
    if not torch.equal(probes.relayout(*case), probes.relayout_plain(case[0])):
        raise AssertionError("P2 differs from its plain version")


def p3_cases(dev):
    """{label: (win, rows)}: the probe's data and the edge data."""
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"P3 [1024,512]x[32,512]": tuple(map(t, probe2.onehot_inputs())),
            "P3 edge [1024,512]x[32,512]": tuple(
                map(t, probe2.onehot_edge_inputs()))}


def p3_check(case):
    if not probes.same_or_both_nan(probes.onehot_mm(*case),
                                   probes.onehot_mm_plain(*case)):
        raise AssertionError("P3 differs from its plain version")


def p4_cases(dev):
    """{label: (x, idx, axis)}: the tool's five shapes on the probe's data
    (timed), each checked also with indices at -1, past the end and at the
    int32 extremes and -0.0 in x (`tools/probe2.py::gather_edge_inputs`)."""
    out = {}
    for tag, (rows, lanes, axis) in probe2.GATHER_SHAPES.items():
        x, idx = probe2.gather_inputs(rows, lanes, axis)
        out[f"P4 {tag} [{rows},{lanes}] axis {axis}"] = (
            torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev), axis)
    return out


def p4_check(case):
    x, _, axis = case
    edge = probe2.gather_edge_inputs(*x.shape, axis)
    for c in (case, (*(torch.from_numpy(a).to(x.device) for a in edge),
                     axis)):
        if not probes.same_bits(probes.gather(*c), probes.gather_plain(*c)):
            raise AssertionError("P4 differs from its plain version")


def p5_cases(dev):
    """{label: (x, idx, axis, reps)}: the tool's ten shapes and
    P5_SWEEP_SHAPES on random floats, indices in [-3 size, 3 size)."""
    out = {}
    for rows, lanes, axis, reps, *_ in (*probe_mosaic.GATHER_CASES,
                                        *P5_SWEEP_SHAPES):
        x, idx = probe_mosaic.gather_random_inputs(rows, lanes, axis)
        out[f"P5 [{rows},{lanes}] axis {axis} x{reps}"] = (
            torch.from_numpy(x).to(dev), torch.from_numpy(idx).to(dev),
            axis, reps)
    return out


def p5_check(case):
    if not torch.equal(probes.mosaic_gather(*case),
                       probes.mosaic_gather_plain(*case)):
        raise AssertionError("P5 differs from its plain version")


def p5_info(case) -> dict:
    """The plan P5 takes at the case's shape and the L2 bytes it moves."""
    x, _, axis, reps = case
    rows, lanes = x.shape
    plan = probes.mosaic_gather_plan(rows, lanes, axis, reps)
    return {"plan": dataclasses.asdict(plan),
            "l2_bytes": probes.mosaic_gather_l2_bytes(
                plan, rows, lanes, axis, reps)["total"]}


def p6_cases(dev):
    """{label: boxes}: the tool's all-pass and own boxes, and 8,191 nodes
    that all pass."""
    return {"P6 2047 all pass": probe2.scalar_stack_boxes("all"),
            "P6 2047 probe": probe2.scalar_stack_boxes("probe"),
            "P6 8191 all pass": probe2.tree_boxes(8191, 1.0)}


def p6_check(boxes):
    if not torch.equal(probes.mosaic_scalar_stack(boxes).cpu(),
                       probes.mosaic_scalar_stack_plain(boxes).cpu()):
        raise AssertionError("P6 differs from its plain version")


def p7_cases(dev):
    """{label: (o, t, n_chunks)}: the tool's shape on each of its data
    sets; on the random data also at 4 chunks and at none (the kernel's
    cost without a test)."""
    b, w, n = probe_mosaic.CHUNK
    out = {}
    for data in probe_mosaic.CHUNK_DATA:
        o, t = (torch.from_numpy(a).to(dev)
                for a in probe_mosaic.chunk_inputs(data))
        for k in (n, 4, 0) if data == "random" else (n,):
            out[f"P7 [{data}] {b}x{w}x{k}"] = (o, t, k)
    return out


def p7_check(case):
    o, t, n = case
    if not probes.same_bits(probes.chunk(o, t, n),
                            probes.chunk_plain(o.cpu(), t.cpu(), n)):
        raise AssertionError("P7 differs from its plain version")


# P8 at the tool's shape and at fewer blocks, down to as many copies as the
# table has tiles (128) and half as many (64): where the routes cross.
P8_BLOCKS = (1024, 512, 256, 128, 64)


def p8_cases(dev):
    """{label: (src, idx)}: the tool's table and indices at P8_BLOCKS."""
    out = {}
    for nb in P8_BLOCKS:
        src, idx = exp_subtile_dma.inputs(0, nb)
        out[f"P8 {nb}x{exp_subtile_dma.NI}x{exp_subtile_dma.CH}"] = (
            torch.from_numpy(src).to(dev), torch.from_numpy(idx).to(dev))
    return out


def p8_call(case):
    return probes.subtile_copy(*case, exp_subtile_dma.NI, exp_subtile_dma.CH)


def p8_check(case):
    if not probes.same_bits(p8_call(case), probes.subtile_copy_plain(
            *case, exp_subtile_dma.NI, exp_subtile_dma.CH)):
        raise AssertionError("P8 differs from its plain version")


CASES = ("k4", "k5b", "k2", "p1", "p2", "p3", "p4", "p5", "p6", "p7", "p8")
CASE_SOURCES = {"k4": "fused.cu", "k5b": "gather.cu", "k2": "resident.cu",
                "p1": "probes.cu", "p2": "probes.cu", "p3": "probes.cu",
                "p4": "probes.cu",
                "p5": "mosaic.cu", "p6": "mosaic.cu", "p7": "mosaic.cu",
                "p8": "mosaic.cu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR:SOURCES",
                    help="time SOURCES (comma-separated) of the checkout "
                    "DIR as the variants NAME_<source>")
    ap.add_argument("--variants",
                    default=",".join([*VARIANTS, *PLAN_VARIANTS]),
                    help="comma-separated names of VARIANTS and "
                    "PLAN_VARIANTS (or none)")
    ap.add_argument("--cases", default=",".join(CASES),
                    help=f"comma-separated cases of {', '.join(CASES)}")
    args = ap.parse_args(argv)
    chosen = [c for c in args.cases.split(",") if c]
    if set(chosen) - set(CASES):
        ap.error(f"--cases: unknown {sorted(set(chosen) - set(CASES))}")
    sources = {CASE_SOURCES[c] for c in chosen}
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(card)
    picked = [n for n in args.variants.split(",") if n]
    names = [n for n in picked if n in VARIANTS and VARIANTS[n][0] in sources]
    plans = {n: PLAN_VARIANTS[n] for n in picked if n in PLAN_VARIANTS}
    base = cuda_lib.library()
    with tempfile.TemporaryDirectory(dir=cuda_lib.build_dir()) as d:
        libs = build_variants(names, args.other, Path(d))
        overlays = {name: (src, load(lib)) for name, (src, lib)
                    in libs.items()}
        cases = []
        if "k4" in chosen:
            cases += [("k4", label, "fused.cu", frame, k4_check,
                       lambda f=frame: fused.fused_kernel(f), 20,
                       "fused_kernel")
                      for label, frame in k4_cases(dev).items()]
        turns = []
        if "k5b" in chosen:
            turns += [("k5b", label, "gather.cu", calls, k5b_check,
                       gather.gather_bwd, "gather_bwd_")
                      for label, calls in k5b_cases(dev).items()]
        if "k2" in chosen:
            turns += [("k2", label, "resident.cu", calls, k2_check,
                       resident.trace,
                       "resident_kernel")
                      for label, calls in k2_cases(dev).items()]
        for key, label, src, calls, check, fn, kernel in turns:
            turn = itertools.cycle(calls)
            cases.append((key, label, src, calls, check,
                          lambda t=turn, f=fn: f(*next(t)),
                          len(calls) * max(1, 200 // len(calls)), kernel))
        if "p1" in chosen:
            for label, boxes in p1_cases(dev).items():
                b = torch.from_numpy(boxes).to(dev)
                cases.append(("p1", label, "probes.cu", b, p1_check,
                              lambda b=b: probes.scalar_stack(b), 200,
                              "probe_scalar_stack_kernel"))
        if "p2" in chosen:
            cases += [("p2", label, "probes.cu", case, p2_check,
                       lambda c=case: probes.relayout(*c), 200,
                       "probe_relayout")
                      for label, case in p2_cases(dev).items()]
        if "p3" in chosen:
            cases += [("p3", label, "probes.cu", case, p3_check,
                       lambda c=case: probes.onehot_mm(*c), 200,
                       "probe_onehot_mm_kernel")
                      for label, case in p3_cases(dev).items()]
        if "p4" in chosen:
            cases += [("p4", label, "probes.cu", case, p4_check,
                       lambda c=case: probes.gather(*c), 200,
                       "probe_gather_kernel")
                      for label, case in p4_cases(dev).items()]
        if "p5" in chosen:
            cases += [("p5", label, "mosaic.cu", case, p5_check,
                       lambda c=case: probes.mosaic_gather(*c), 200,
                       "mosaic_gather_kernel")
                      for label, case in p5_cases(dev).items()]
        if "p6" in chosen:
            for label, boxes in p6_cases(dev).items():
                b = torch.from_numpy(boxes).to(dev)
                cases.append(("p6", label, "mosaic.cu", b, p6_check,
                              lambda b=b: probes.mosaic_scalar_stack(b), 200,
                              "mosaic_scalar_stack_kernel"))
        if "p7" in chosen:
            cases += [("p7", label, "mosaic.cu", case, p7_check,
                       lambda c=case: probes.chunk(*c), 200,
                       "mosaic_chunk_kernel")
                      for label, case in p7_cases(dev).items()]
        if "p8" in chosen:
            cases += [("p8", label, "mosaic.cu", case, p8_check,
                       lambda c=case: p8_call(c), 200, "subtile_copy_kernel")
                      for label, case in p8_cases(dev).items()]
        results = []
        for key, label, src, data, check, call, iters, kernel in cases:
            # a named variant runs on its own case; another checkout's
            # source on every case of that source, with OTHER_PLANS
            mine = lambda n: n.startswith(f"{key}_") or n not in VARIANTS
            runs = [("tree", base, None)] + [
                (name, lib, VARIANT_PLANS.get(name) if name in VARIANTS
                 else OTHER_PLANS.get(key))
                for name, (s, lib) in overlays.items()
                if s == src and mine(name)] + [
                (name, base, kw) for name, kw in plans.items()
                if name.startswith(f"{key}_")] + [("tree", base, None)]
            for name, lib, kw in runs:
                cuda_lib._lib = lib
                saved = {k: getattr(probes, k) for k in kw or {}}
                for k, v in (kw or {}).items():
                    setattr(probes, k, v)
                try:
                    check(data)
                    ms, _ = device_ms(call, iters, kernel,
                                      per_call=VARIANT_LAUNCHES.get(name, 1))
                    info = (p5_info(data) if key == "p5" else
                            {"events_ms": probe2.wrapper_us(
                                call, iters, dev) / 1e3,
                             "route": probes.subtile_copy_route(
                                 data[0].shape[0], data[1].shape[0])}
                            if key == "p8" else {})
                finally:
                    cuda_lib._lib = base
                    for k, v in saved.items():
                        setattr(probes, k, v)
                extra = "".join(f" {k}={v}" for k, v in info.items())
                print(f"{label} {name}: {ms:.4f} ms{extra} [{card}]")
                results.append({"case": label, "variant": name, "ms": ms,
                                **info})
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
