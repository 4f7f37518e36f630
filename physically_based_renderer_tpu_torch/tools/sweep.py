"""Time variants of K4 and K5b against the tree's own kernels, on the card.

    python -m physically_based_renderer_tpu_torch.tools.sweep \
        [--other NAME=DIR:fused.cu,gather.cu ...] [--variants ...]

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
backward, by shape, and at [32, 86] on uniformly random indices.  Prints
one line per (case, variant) and, last, one JSON object.  PERF.md names
the variants whose numbers it keeps.
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

from ..ops import cuda_lib, fused, gather
from . import work
from .probe2 import card_line
from .timing import device_ms

# name -> (source, [(text, replacement), ...]).
VARIANTS = {
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR:SOURCES",
                    help="time SOURCES (comma-separated) of the checkout "
                    "DIR as the variants NAME_<source>")
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS (or none)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line(dev)
    print(card)
    names = [n for n in args.variants.split(",") if n]
    base = cuda_lib.library()
    with tempfile.TemporaryDirectory(dir=cuda_lib.build_dir()) as d:
        libs = build_variants(names, args.other, Path(d))
        overlays = {name: (src, load(lib)) for name, (src, lib)
                    in libs.items()}
        cases = [(label, "fused.cu", frame, k4_check,
                  lambda f=frame: fused.fused_kernel(f), 20, "fused_kernel")
                 for label, frame in k4_cases(dev).items()]
        for label, calls in k5b_cases(dev).items():
            turn = itertools.cycle(calls)
            cases.append((label, "gather.cu", calls, k5b_check,
                          lambda t=turn: gather.gather_bwd(*next(t)),
                          len(calls) * max(1, 200 // len(calls)),
                          "gather_bwd_"))
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
