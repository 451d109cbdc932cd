"""Pass-through probes: identity copies in the reference's two layouts, the
CUDA kernels T2a and T2b (``csrc/passthrough.cu``).

Port of the two Pallas kernels of ``tools/pallas_barrier_test.py``:
``_passthrough`` (T2a, [N, 3] float32 in [1024, 3] blocks) and
``_passthrough_flat`` (T2b, [N] float32 viewed as [N/128, 128] rows, in
[256, 128] blocks).  On the card both launch one copy kernel over their
buffer's floats; each keeps its own shape check and launch count.  The
barrier probe (``tools/barrier_test.py``) puts them inside
``shadow_visible`` to time one more launch in the shading chain.  Their
plain version is ``x.clone()``: CPU tensors take it, CUDA tensors launch
the kernel or raise.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda


class _PassthroughKernel:
    """Wrapper of ``prt_passthrough`` for one layout.  ``launches`` counts
    kernel launches and nothing else."""

    def __init__(self, name: str, flat: bool):
        self.name = name
        self.flat = flat
        self.launches = 0

    def __call__(self, x):
        n = x.shape[0]
        shape = (n,) if self.flat else (n, 3)
        _cuda.require(x, "x", torch.float32, shape, x.device)
        if self.flat and n % 128:
            raise ValueError(f"{self.name}: needs N % 128 == 0 (N = {n})")
        out = torch.empty_like(x)
        if n == 0:
            return out
        lib = _cuda.LIBRARY.get()
        with _cuda.on_device(x):
            code = lib.prt_passthrough(x.data_ptr(), out.data_ptr(),
                                       x.numel(), _cuda.stream_handle(x))
        _cuda.check(code, f"prt_passthrough ({self.name})")
        self.launches += 1
        return out


passthrough_kernel = _PassthroughKernel("T2a", flat=False)
passthrough_flat_kernel = _PassthroughKernel("T2b", flat=True)


def _dispatch(kernel, x):
    if x.device.type == "cpu":
        return x.clone()
    if x.device.type != "cuda":
        raise ValueError(f"{kernel.name}: unsupported device {x.device}")
    return kernel(x.contiguous())


def passthrough(x):
    """T2a: a copy of ``x`` [N, 3] float32."""
    return _dispatch(passthrough_kernel, x)


def passthrough_flat(x):
    """T2b: a copy of ``x`` [N] float32, N a multiple of 128."""
    return _dispatch(passthrough_flat_kernel, x)
