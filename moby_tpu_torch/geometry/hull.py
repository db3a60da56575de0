"""3-D convex hull for scene compilation: a ctypes binding of the repo's
native quickhull (``native/hull.cpp``, ``moby_convex_hull``; standalone
C++17, no other dependency).

The library is built by ``g++`` at first use into ``moby_tpu_torch/build/``
(rebuilt when the source is newer) and loaded with `ctypes`; a failed build
raises with the compiler's output. Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "hull.cpp")
_LIB_PATH = os.path.join(_PKG_DIR, "build", "libmoby_hull.so")
# the flags of native/Makefile
_CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None


def build(force: bool = False) -> str:
    """Compile ``native/hull.cpp`` into the package's build directory when
    the library is missing or older than its source. Returns its path."""
    if not os.path.exists(_SOURCE):
        raise RuntimeError(f"convex hull source not found: {_SOURCE}")
    if (force or not os.path.exists(_LIB_PATH)
            or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SOURCE)):
        os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError("building the convex hull needs g++, found none")
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        cmd = [cxx, *_CXX_FLAGS, "-o", tmp, _SOURCE]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({out.returncode}): {' '.join(cmd)}\n"
                f"{out.stdout}{out.stderr}")
        os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        dptr = ctypes.POINTER(ctypes.c_double)
        iptr = ctypes.POINTER(ctypes.c_int)
        lib.moby_convex_hull.restype = ctypes.c_int
        lib.moby_convex_hull.argtypes = [dptr, ctypes.c_int, iptr, ctypes.c_int]
        _lib = lib
    return _lib


def convex_hull(points):
    """Convex hull of points (n, 3). Returns (verts (m, 3), faces (f, 3)
    indices into verts) with outward winding, the hull's vertices in their
    input order. Raises ValueError on degenerate input (fewer than 4
    affinely independent points)."""
    lib = _load()
    pts = np.ascontiguousarray(points, dtype=np.float64)
    n = pts.shape[0]
    max_faces = max(64, 4 * n)
    faces = np.zeros((max_faces, 3), dtype=np.int32)
    nf = lib.moby_convex_hull(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_faces)
    if nf < 0:
        raise RuntimeError("convex hull face buffer overflow")
    if nf == 0:
        raise ValueError("degenerate input (coplanar or < 4 points)")
    faces = faces[:nf]
    used = np.unique(faces.ravel())
    remap = np.full(n, -1, dtype=np.int32)
    remap[used] = np.arange(len(used), dtype=np.int32)
    return pts[used], remap[faces]
