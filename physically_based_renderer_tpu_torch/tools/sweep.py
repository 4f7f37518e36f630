"""Time variants of K4, K5b, K2 and P1 against the tree's own kernels, on
the card.

    python -m physically_based_renderer_tpu_torch.tools.sweep \
        [--other NAME=DIR:fused.cu,gather.cu ...] [--variants ...] \
        [--cases k4,k5b,k2,p1]

A variant is one source of `csrc/` with named textual edits (VARIANTS; an
edit must match the source exactly once, so a stale one fails), or the same
source of another checkout (`--other`, e.g. the parent commit unpacked with
`git archive` into the ignored `build/`; its C interface must be the
tree's).  Each variant's source is compiled with `cuda_lib`'s flags into a
library of its own, all `nvcc` processes started together; while a variant
is timed, the wrappers of `ops/` call its functions in place of the tree's
(`cuda_lib._lib` is swapped for an overlay).  Every variant is first held
against the plain version on each case, at the tolerances of
`chip_smoke.py`.  Times are device times per launch
(`tools/timing.py::device_ms`), taken in turns: the tree, each variant, the
tree again.  Cases: K4 on the cornell and cornell_ggx frames (512x512, 4
spp, 4 bounces); K5b on the calls of one gradient step's render()
backward, by shape, and at [32, 86] on uniformly random indices; K2 on the
calls of one dense cornell frame (512x512, 4 spp, 4 bounces;
`tools/work.py::dense_frame_calls`): the camera's closest hits, the
bounces' closest hits and the shadow rays' any hits, each kind's calls in
turn (exact against the plain version); P1 on the tool's all-pass boxes
and on trees of 5,001 and 8,191 nodes (`tools/probe2.py::tree_boxes`,
exact).  Only the variants of the chosen cases' sources are built.
Prints one line per (case, variant) and, last, one JSON object.  PERF.md
names the variants whose numbers it keeps.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_lib, fused, gather, probes, resident
from . import probe2, work
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
        """  int visited = tid == 0;   // the root
  for (int lo = 1, width = 2; lo < n_nodes; lo += width, width *= 2) {
    const int hi = min(lo + width, n_nodes);
    for (int i = lo + tid; i < hi; i += nt) {
      const unsigned char up = s_open[(i - 1) >> 1];
      visited += up;
      s_open[i] &= up;
    }
    __syncthreads();
  }""",
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
  __syncthreads();""")]),
    # P1: the pass bits' loop unrolled by eight.
    "p1_unroll8": ("probes.cu", [(
        "    const float4* q = reinterpret_cast<const float4*>(boxes);\n",
        "    const float4* q = reinterpret_cast<const float4*>(boxes);\n"
        "#pragma unroll 8\n")]),
    # P1: threads of its one CTA.
    "p1_threads256": ("probes.cu", [("constexpr int kStackThreads = 512;",
                                     "constexpr int kStackThreads = 256;")]),
    "p1_threads1024": ("probes.cu", [("constexpr int kStackThreads = 512;",
                                      "constexpr int kStackThreads = 1024;")]),
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
}

# Tolerances of chip_smoke.py.
K5B_REL = 1e-5
PIXEL_FRAC, ATOL, RTOL, MEAN_REL, COUNT_REL = 0.99, 1e-4, 1e-3, 5e-3, 5e-3


def build_variants(names, others, out_dir: Path) -> dict:
    """{name: (source, library path)} of every variant, all compiled at
    once with cuda_lib's flags."""
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
    cuda_lib._run(cmds)
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


CASES = ("k4", "k5b", "k2", "p1")
CASE_SOURCES = {"k4": "fused.cu", "k5b": "gather.cu", "k2": "resident.cu",
                "p1": "probes.cu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR:SOURCES",
                    help="time SOURCES (comma-separated) of the checkout "
                    "DIR as the variants NAME_<source>")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS (or none)")
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
    names = [n for n in args.variants.split(",")
             if n and VARIANTS[n][0] in sources]
    base = cuda_lib.library()
    with tempfile.TemporaryDirectory(dir=cuda_lib.build_dir()) as d:
        libs = build_variants(names, args.other, Path(d))
        overlays = {name: (src, load(lib)) for name, (src, lib)
                    in libs.items()}
        cases = []
        if "k4" in chosen:
            cases += [(label, "fused.cu", frame, k4_check,
                       lambda f=frame: fused.fused_kernel(f), 20,
                       "fused_kernel")
                      for label, frame in k4_cases(dev).items()]
        turns = []
        if "k5b" in chosen:
            turns += [(label, "gather.cu", calls, k5b_check,
                       gather.gather_bwd, "gather_bwd_")
                      for label, calls in k5b_cases(dev).items()]
        if "k2" in chosen:
            turns += [(label, "resident.cu", calls, k2_check, resident.trace,
                       "resident_kernel")
                      for label, calls in k2_cases(dev).items()]
        for label, src, calls, check, fn, kernel in turns:
            turn = itertools.cycle(calls)
            cases.append((label, src, calls, check,
                          lambda t=turn, f=fn: f(*next(t)),
                          len(calls) * max(1, 200 // len(calls)), kernel))
        if "p1" in chosen:
            for label, boxes in p1_cases(dev).items():
                b = torch.from_numpy(boxes).to(dev)
                cases.append((label, "probes.cu", b, p1_check,
                              lambda b=b: probes.scalar_stack(b), 200,
                              "probe_scalar_stack_kernel"))
        results = []
        for label, src, data, check, call, iters, kernel in cases:
            runs = [("tree", base)] + [
                (name, lib) for name, (s, lib) in overlays.items()
                if s == src] + [("tree", base)]
            for name, lib in runs:
                cuda_lib._lib = lib
                try:
                    check(data)
                    ms, _ = device_ms(call, iters, kernel)
                finally:
                    cuda_lib._lib = base
                print(f"{label} {name}: {ms:.4f} ms [{card}]")
                results.append({"case": label, "variant": name, "ms": ms})
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
