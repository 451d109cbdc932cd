"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds, one process per source, all started together, and
links them into one shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c -o <objects>/<name>.o csrc/<name>.cu
    nvcc -shared -o _build/libprt_kernels_<hash>.so <objects>/*.o

(``<objects>`` is a directory of this process under ``_build/``, removed
after the link.)

The build runs at the first launch, never at import, into the package's
``_build/`` directory (listed in .gitignore); a change to any source or
header (``csrc/*.cuh``) changes the hash and triggers a rebuild.  A failed
build raises: there is no fallback for CUDA tensors.  Every C entry point returns
``cudaGetLastError()`` after its launch; ``check`` turns a non-zero code
into an exception.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_c_vp = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_float = ctypes.c_float
_SIGNATURES = {
    "prt_mesh_brute": [_c_vp, _c_ll, _c_int, _c_int, _c_vp, _c_vp, _c_vp,
                       _c_vp, _c_vp, _c_vp, _c_vp, _c_ll, _c_vp, _c_vp,
                       _c_vp, _c_int, _c_vp],
    "prt_mesh_brute_tc": [_c_vp, _c_int, _c_int, _c_int, _c_vp, _c_vp, _c_vp,
                          _c_vp, _c_vp, _c_vp, _c_vp, _c_ll, _c_vp, _c_vp,
                          _c_int, _c_int, _c_vp],
    "prt_mesh_brute_tc_resources": [_c_int, _c_int, _c_int, _c_vp],
    "prt_tonemap": [_c_vp, _c_vp, _c_int, _c_int, _c_int, _c_int, _c_int,
                    _c_float, _c_int, _c_vp],
    "prt_block_scan": [_c_vp, _c_vp, _c_vp, _c_ll, _c_int, _c_vp],
    "prt_matmul_only": [_c_vp, _c_int, _c_vp, _c_vp, _c_ll, _c_int, _c_int,
                        _c_ll, _c_int, _c_vp, _c_vp, _c_vp],
    "prt_passthrough": [_c_vp, _c_vp, _c_ll, _c_vp],
    "prt_envmap_lookup": [_c_vp, _c_vp, _c_vp, _c_vp, _c_ll, _c_int, _c_int,
                          _c_vp],
    "prt_envmap_lookup_grad": [_c_vp, _c_vp, _c_vp, _c_vp, _c_vp, _c_vp,
                               _c_vp, _c_ll, _c_int, _c_int, _c_int, _c_vp,
                               _c_vp],
    "prt_bvh_walk": [_c_vp, _c_vp, _c_vp, _c_int, _c_vp, _c_vp, _c_vp, _c_vp,
                     _c_vp, _c_ll, _c_vp, _c_vp, _c_vp, _c_vp, _c_vp, _c_vp,
                     _c_vp],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (looked on PATH and in /usr/local/cuda/bin)")


class KernelLibrary:
    """The kernels' shared library, built on first use (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.build_seconds = None  # None: loaded from an earlier build
        self.build_log = ""

    def sources(self) -> list[str]:
        return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))

    def _so_path(self) -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        headers = glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
        for src in sorted(self.sources() + headers):
            with open(src, "rb") as fh:
                h.update(os.path.basename(src).encode() + fh.read())
        return os.path.join(BUILD_DIR, f"libprt_kernels_{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        so = self._so_path()
        if os.path.exists(so):
            return so
        obj_dir = f"{so[:-3]}.{os.getpid()}.o"
        os.makedirs(obj_dir, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        jobs = []
        for src in self.sources():
            obj = os.path.join(obj_dir, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate(timeout=900)
            logs.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)} ({proc.returncode})")
        self.build_log = "".join(logs)
        if failed:
            raise RuntimeError("nvcc failed: " + "; ".join(failed) + "\n"
                               + self.build_log)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, "-shared", "-o", tmp, *(obj for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        self.build_log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{self.build_log}")
        os.replace(tmp, so)
        shutil.rmtree(obj_dir, ignore_errors=True)
        self.build_seconds = time.perf_counter() - t0
        return so

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build())
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = argtypes
                    fn.restype = _c_int
                lib.prt_cuda_error_string.argtypes = [_c_int]
                lib.prt_cuda_error_string.restype = ctypes.c_char_p
                self._lib = lib
            return self._lib


LIBRARY = KernelLibrary()


def check(code: int, name: str) -> None:
    """Raise when a kernel's launch reported a CUDA error."""
    if code != 0:
        msg = LIBRARY.get().prt_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a raw pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor):
    """Context in which a wrapper calls into C: ``t``'s device made the
    current one, so that the launch, the device the C code queries (grid
    sizes, shared-memory opt-ins) and the stream of ``stream_handle(t)`` are
    the same card whatever device was current before."""
    return torch.cuda.device(t.device)


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
            device: torch.device) -> None:
    """Validate a kernel argument before its pointer goes to C."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
