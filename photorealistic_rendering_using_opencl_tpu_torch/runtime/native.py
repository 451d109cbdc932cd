"""ctypes bindings for the framework-free native host library.

The C++ source, ``runtime/csrc/prt_native.cpp`` in this package (sweep-SAH
BVH build and OBJ import, no framework headers), is a copy of the JAX
package's ``runtime/csrc/prt_native.cpp``: the same code, line for line,
with two comments naming the OpenCL reference's files by their path in
that project.  It is compiled
lazily with g++ into this package's own build directory (``_build/``,
listed in .gitignore) and rebuilt when the source's hash changes.  Where
g++ is missing, or ``PRT_NO_NATIVE`` is set (read at each call, as the
reference reads it), scene/bvh_build.py and scene/obj.py use their Python
versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG_DIR, "runtime", "csrc", "prt_native.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")


class _NativeLib:
    """Lazily built handle to the library (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._tried = False

    def _build(self) -> str | None:
        try:
            with open(_SRC, "rb") as fh:
                digest = hashlib.sha256(fh.read()).hexdigest()[:16]
            so = os.path.join(BUILD_DIR, f"libprt_native_{digest}.so")
            if os.path.exists(so):
                return so
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
                            "-o", tmp, _SRC],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, so)
            return so
        except (OSError, subprocess.SubprocessError):
            return None

    def get(self):
        """The loaded library, or None when it cannot be built here."""
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            so = self._build()
            if so is None:
                return None
            try:
                lib = ctypes.CDLL(so)
            except OSError:
                return None
            c_ll = ctypes.c_longlong
            c_vp = ctypes.c_void_p
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.prt_bvh_build.argtypes = [f32p, c_ll]
            lib.prt_bvh_build.restype = c_vp
            lib.prt_bvh_n_nodes.argtypes = [c_vp]
            lib.prt_bvh_n_nodes.restype = c_ll
            lib.prt_bvh_export.argtypes = [c_vp, f32p, f32p, i32p, i32p,
                                           i32p, i64p]
            lib.prt_bvh_export.restype = None
            lib.prt_bvh_free.argtypes = [c_vp]
            lib.prt_bvh_free.restype = None
            lib.prt_obj_load.argtypes = [ctypes.c_char_p]
            lib.prt_obj_load.restype = c_vp
            lib.prt_obj_n_tris.argtypes = [c_vp]
            lib.prt_obj_n_tris.restype = c_ll
            lib.prt_obj_export.argtypes = [c_vp, f32p, f32p]
            lib.prt_obj_export.restype = None
            lib.prt_obj_free.argtypes = [c_vp]
            lib.prt_obj_free.restype = None
            lib.prt_last_error.argtypes = []
            lib.prt_last_error.restype = ctypes.c_char_p
            self._lib = lib
            return lib


_NATIVE = _NativeLib()


def get_lib():
    """Load (building if needed) the native library; None if unavailable
    or when ``PRT_NO_NATIVE`` asks for the Python builds."""
    if os.environ.get("PRT_NO_NATIVE"):
        return None
    return _NATIVE.get()


def build_bvh_native(tri_verts: np.ndarray):
    """Native sweep-SAH build -> (bounds_min, bounds_max, miss, first_prim,
    prim_count, order), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    tv = np.ascontiguousarray(tri_verts, np.float32)
    t = tv.shape[0]
    handle = lib.prt_bvh_build(tv.reshape(-1, 9), t)
    if not handle:
        raise RuntimeError(lib.prt_last_error().decode())
    try:
        m = lib.prt_bvh_n_nodes(handle)
        bmin = np.empty((m, 3), np.float32)
        bmax = np.empty((m, 3), np.float32)
        miss = np.empty((m,), np.int32)
        first = np.empty((m,), np.int32)
        count = np.empty((m,), np.int32)
        order = np.empty((t,), np.int64)
        lib.prt_bvh_export(handle, bmin, bmax, miss, first, count, order)
    finally:
        lib.prt_bvh_free(handle)
    return bmin, bmax, miss, first, count, order


def load_obj_native(path: str):
    """Native OBJ import; (verts[T,3,3], normals[T,3,3]) or None."""
    lib = get_lib()
    if lib is None:
        return None
    handle = lib.prt_obj_load(path.encode())
    if not handle:
        raise FileNotFoundError(lib.prt_last_error().decode())
    try:
        t = lib.prt_obj_n_tris(handle)
        verts = np.empty((t, 3, 3), np.float32)
        normals = np.empty((t, 3, 3), np.float32)
        lib.prt_obj_export(handle, verts.reshape(-1, 9),
                           normals.reshape(-1, 9))
    finally:
        lib.prt_obj_free(handle)
    return verts, normals
