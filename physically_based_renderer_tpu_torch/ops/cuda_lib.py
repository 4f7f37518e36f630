"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by its own `nvcc` process, all started together,
and the objects are linked into one shared library with a plain C
interface, loaded with ctypes: seconds to build, where an extension that
includes PyTorch's headers takes minutes.  The library lands in
`build/torch_kernels/<hash>/` at the repository root, keyed by a hash of
the sources, the headers they include and the flags, and is built at
first use.  A failed build
raises; nothing falls back to the plain versions.

Flags: `-fmad=false` keeps nvcc from contracting a*b+c into an FMA, so
each kernel rounds exactly like its plain-torch version (one rounding per
operation) and the resident tracer's hit distances and winners agree with
the plain version bit for bit (the block tracer likewise).  No
`--use_fast_math`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("resident.cu", "tonemap.cu", "trace_blocks.cu", "fused.cu",
           "gather.cu", "probes.cu", "mosaic.cu", "threefry.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC")
LIB_NAME = "libpbr_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_L = ctypes.c_longlong
_SIGNATURES = {
    # o, d, t_max, soup, n_rays, n_tris, t_min, t_out, tri_out, stream
    "pbr_resident_closest": [_P, _P, _P, _P, _I, _I, _F, _P, _P, _P],
    # o, d, t_max, soup, n_rays, n_tris, t_min, occ_out, stream
    "pbr_resident_any": [_P, _P, _P, _P, _I, _I, _F, _P, _P],
    # hdr, out, n_pixels, inv_gamma, stream
    "pbr_tonemap": [_P, _P, _I, _F, _P],
    # u_idx, n_valid, entry, o, d, t_max, soup, n_blocks, block, n_u, k, ch,
    # t_min, best_t, best_flat, stream
    "pbr_trace_blocks_closest": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _F, _P, _P, _P],
    # ... t_min, occ_out, stream
    "pbr_trace_blocks_any": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _P, _P],
    # lo, count, bad, stream
    "pbr_rcp_check": [_U, _L, _P, _P],
    # cam, tri, n_tris, em, n_em, mtex, n_mats, quads, n_rows, width,
    # height, spp, max_bounces, eps, inv_w, inv_h, seed0, seed1, has_em,
    # has_dir, textured, hdr_out, count_out, samples, arrivals, stream
    "pbr_fused_render": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I,
                         _F, _F, _F, _U, _U, _I, _I, _I, _P, _P, _P, _P, _P],
    # table, idx, n_rows, n_table_rows, width, out, stream
    "pbr_gather_fwd_i32": [_P, _P, _L, _I, _I, _P, _P],
    "pbr_gather_fwd_i64": [_P, _P, _L, _I, _I, _P, _P],
    # idx, ct, n_rows, n_table_rows, width, d_table, stream
    "pbr_gather_bwd_i32": [_P, _P, _L, _I, _I, _P, _P],
    "pbr_gather_bwd_i64": [_P, _P, _L, _I, _I, _P, _P],
    # boxes, n_nodes, leaf capacity, out, leaves_out, stream
    "pbr_probe_scalar_stack": [_P, _I, _I, _P, _P, _P],
    # stream
    "pbr_probe_empty": [_P],
    # x, out, exchange, stream
    "pbr_probe_relayout": [_P, _P, _I, _P],
    # win, rows, n, r, l, out, stream
    "pbr_probe_onehot_mm": [_P, _P, _I, _I, _I, _P, _P],
    # x, idx, rows, lanes, axis, out, stream
    "pbr_probe_gather": [_P, _P, _I, _I, _I, _P, _P],
    # x, idx, rows, lanes, axis, tile, per, threads, out, stream
    "pbr_probe_gather_slab": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # table, addr, n, out, stream
    "pbr_probe_sector_read": [_P, _P, _I, _P, _P],
    # x, idx, rows, lanes, axis, reps, route, tile, per, threads, out,
    # stream
    "pbr_mosaic_gather": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # boxes, n_nodes, out, stream
    "pbr_mosaic_scalar_stack": [_P, _I, _P, _P],
    # o, t, b, w, n_chunks, out, stream
    "pbr_mosaic_chunk": [_P, _P, _I, _I, _I, _P, _P],
    # src, idx, n_src, nb, n_iters, ch, out, stream
    "pbr_subtile_copy": [_P, _P, _I, _I, _I, _I, _P, _P],
    # src, idx, n_src, nb, n_iters, ch, rows, out, stream
    "pbr_subtile_copy_row_sums": [_P, _P, _I, _I, _I, _I, _P, _P, _P],
    # src, idx, n_src, nb, n_iters, ch, out, stream
    "pbr_subtile_read": [_P, _P, _I, _I, _I, _I, _P, _P],
    # keys, key_step, x0s, x0_step, x0_value, x1s, x1_step, x1_value,
    # x1_iota, n, out, stream
    "pbr_threefry_words": [_P, _I, _P, _I, _U, _P, _I, _U, _I, _L, _P, _P],
    # keys, n, bounce, stream id, m, out, stream
    "pbr_threefry_ray_uniform": [_P, _L, _U, _U, _I, _P, _P],
    # keys, n_keys, m, uniform, out, stream
    "pbr_threefry_bits": [_P, _L, _L, _I, _P, _P],
}

_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def headers() -> list[str]:
    """The headers the sources include (`csrc/*.cuh`)."""
    return sorted(p.name for p in CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """Where this build's library lives: keyed by the flags and the bytes of
    every source and header, so that an edit to either builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (*SOURCES, *headers()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return _PKG.parent / "build" / "torch_kernels" / h.hexdigest()[:16]


def _run(cmds):
    """Run commands in parallel; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(c)}\n{out}")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    global BUILD_SECONDS
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        BUILD_SECONDS = 0.0
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # Objects and the unfinished library live in a scratch directory that
    # is removed whether or not the build succeeds.
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        objs = [Path(tmp_dir) / f"{Path(s).stem}.o" for s in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
              for src, obj in zip(SOURCES, objs)])
        tmp = Path(tmp_dir) / LIB_NAME
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for obj in objs)]])
        os.replace(tmp, lib_path)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.pbr_error_string.argtypes = [_I]
        lib.pbr_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().pbr_error_string(rc).decode()
        raise RuntimeError(f"{name} failed: CUDA error {rc} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer."""
    return torch.cuda.current_stream(device).cuda_stream
