"""ctypes bindings of the native (C++) builders (port of `accel/native.py`).

The builders of `native/bvh_builder.cpp` (a BVH, the cluster grid and the
Walker/Vose alias table) give the same bytes as the numpy builders of
accel/bvh.py, accel/clusters.py and scene/types.py (the same Morton
presort, median splits and stack order), many times faster on a large
mesh.  The library is built at first use with g++ and the flags of
`native/Makefile` into `build/torch_native/<hash>/`, keyed by the
compiler, the flags, the source and what `-march=native` means on this
host; the build runs in a scratch directory and is renamed into place, so
concurrent processes may build at once.  Nothing is written into
`native/`.  With PBR_TPU_NO_NATIVE set, or where no library builds or
loads, `available()` is False and the `_fast` builders fall back to the
numpy builders (`BUILD_ERROR` says why a build failed).
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

import numpy as np
import torch

from .bvh import BVH, LEAF_SIZE
from .clusters import CLUSTER_K, ClusterGrid, _parent_boxes

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-march=native")
LIB_NAME = "libpbr_native.so"

_lib = None
_tried = False
BUILD_SECONDS: float | None = None   # 0.0 when the library was cached
BUILD_ERROR: str | None = None


def _cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    return cxx


def build_dir(cxx: str) -> Path:
    """Where this build's library lives: keyed by the compiler, the flags,
    the source bytes and the host's `-march=native` target options."""
    h = hashlib.sha256(" ".join((cxx, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    h.update(subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60,
                            check=True).stdout)
    return _ROOT / "build" / "torch_native" / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this key has none yet; its path."""
    global BUILD_SECONDS
    cxx = _cxx()
    out_dir = build_dir(cxx)
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        BUILD_SECONDS = 0.0
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp_dir:
        tmp = Path(tmp_dir) / LIB_NAME
        cmd = [cxx, *CXX_FLAGS, "-shared", "-o", str(tmp), str(SOURCE)]
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib_path)
    BUILD_SECONDS = time.perf_counter() - t0
    return lib_path


def load_library():
    """The loaded library (built on first call), or None."""
    global _lib, _tried, BUILD_ERROR
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if os.environ.get("PBR_TPU_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        BUILD_ERROR = str(e)
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.c_int64
    lib.pbr_build_bvh.restype = i64
    lib.pbr_build_bvh.argtypes = [f32p, i64, i32p, i64, ctypes.c_int, f32p,
                                  f32p, i32p, i32p, i32p]
    lib.pbr_build_clusters.restype = i64
    lib.pbr_build_clusters.argtypes = [f32p, i64, i32p, i64, ctypes.c_int,
                                       f32p, f32p, i32p]
    lib.pbr_build_alias.restype = i64
    lib.pbr_build_alias.argtypes = [ctypes.POINTER(ctypes.c_double), i64,
                                    f32p, i32p]
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _library():
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable"
                           + (f": {BUILD_ERROR}" if BUILD_ERROR else ""))
    return lib


def build_bvh_native(positions, indices, leaf_size: int = LEAF_SIZE) -> BVH:
    """C++ BVH build (numpy fields, as build_bvh's); RuntimeError if the
    library is unavailable, ValueError on bad indices."""
    lib = _library()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    t = indices.shape[0]
    cap = 2 * t + 1
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_left = np.empty((cap,), np.int32)
    node_right = np.empty((cap,), np.int32)
    tri_order = np.empty((t,), np.int32)
    n = lib.pbr_build_bvh(_fptr(positions), positions.shape[0],
                          _iptr(indices), t, leaf_size, _fptr(node_min),
                          _fptr(node_max), _iptr(node_left),
                          _iptr(node_right), _iptr(tri_order))
    if n < 0:
        raise ValueError("native BVH build failed (bad indices?)")
    return BVH(node_min=node_min[:n].copy(), node_max=node_max[:n].copy(),
               node_left=node_left[:n].copy(),
               node_right=node_right[:n].copy(), tri_order=tri_order)


def build_clusters_native(positions, indices,
                          k: int = CLUSTER_K) -> ClusterGrid:
    """C++ cluster build (CPU tensors, as build_clusters'); RuntimeError if
    the library is unavailable."""
    lib = _library()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    t = indices.shape[0]
    # every leaf holds at least one triangle: at most t clusters
    amin = np.empty((t, 3), np.float32)
    amax = np.empty((t, 3), np.float32)
    tri_id = np.empty((t, k), np.int32)
    c = lib.pbr_build_clusters(_fptr(positions), positions.shape[0],
                               _iptr(indices), t, k, _fptr(amin),
                               _fptr(amax), _iptr(tri_id))
    if c < 0:
        raise ValueError("native cluster build failed")
    amin, amax = amin[:c].copy(), amax[:c].copy()
    pmin, pmax = _parent_boxes(amin, amax)
    return ClusterGrid(aabb_min=torch.from_numpy(amin),
                       aabb_max=torch.from_numpy(amax),
                       tri_id=torch.from_numpy(tri_id[:c].copy()),
                       parent_min=pmin, parent_max=pmax)


def build_bvh_fast(positions, indices, leaf_size: int = LEAF_SIZE) -> BVH:
    """Native when available, the numpy builder otherwise."""
    if available():
        return build_bvh_native(positions, indices, leaf_size)
    from .bvh import build_bvh
    return build_bvh(positions, indices, leaf_size)


def build_clusters_fast(positions, indices,
                        k: int = CLUSTER_K) -> ClusterGrid:
    """Native when available, the numpy builder otherwise."""
    if available():
        return build_clusters_native(positions, indices, k)
    from .clusters import build_clusters
    return build_clusters(positions, indices, k)


def build_alias_native(p):
    """C++ Walker/Vose alias build -> (prob f32[n], alias i32[n]), or None
    where the library is unavailable or n is 0."""
    lib = load_library()
    if lib is None:
        return None
    p = np.ascontiguousarray(p, np.float64)
    n = p.size
    prob = np.empty((n,), np.float32)
    alias = np.empty((n,), np.int32)
    rc = lib.pbr_build_alias(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, _fptr(prob),
        _iptr(alias))
    if rc != 0:
        return None
    return prob, alias
