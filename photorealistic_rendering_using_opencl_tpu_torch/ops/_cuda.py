"""Builds and loads the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface (no PyTorch headers), so ``nvcc``
builds them in seconds into one shared library, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _build/libprt_kernels_<hash>.so csrc/*.cu

The build runs at the first launch, never at import, into the package's
``_build/`` directory (listed in .gitignore); a change to any source
changes the hash and triggers a rebuild.  A failed build raises: there is
no fallback for CUDA tensors.  Every C entry point returns
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_c_vp = ctypes.c_void_p
_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_float = ctypes.c_float
_SIGNATURES = {
    "prt_mesh_brute": [_c_vp, _c_ll, _c_int, _c_vp, _c_vp, _c_vp, _c_vp,
                       _c_vp, _c_vp, _c_vp, _c_ll, _c_vp, _c_vp, _c_vp,
                       _c_vp],
    "prt_tonemap": [_c_vp, _c_vp, _c_int, _c_int, _c_float, _c_int, _c_vp],
    "prt_block_scan": [_c_vp, _c_vp, _c_vp, _c_ll, _c_int, _c_vp],
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
        for src in self.sources():
            with open(src, "rb") as fh:
                h.update(os.path.basename(src).encode() + fh.read())
        return os.path.join(BUILD_DIR, f"libprt_kernels_{h.hexdigest()[:16]}.so")

    def build(self) -> str:
        so = self._so_path()
        if os.path.exists(so):
            return so
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *self.sources()]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{self.build_log}")
        os.replace(tmp, so)
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
