"""Display transform: vignette + filmic Reinhard + smoothstep toe + gamma.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/tonemap.py`` (the
plain version) and of the fused Pallas kernel
``ops/pallas_kernels.py:_tonemap_kernel`` as the CUDA kernel K2
(``csrc/tonemap.cu``).  ``tonemap`` runs the plain version on CPU tensors
and launches K2 on CUDA tensors, with no fallback.  Both give NaN where the
reference does: for a NaN or infinite pixel, and for one large enough that
the curve overflows.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import smoothstep

_W = 1.2
_T2 = 7.5
# K2 indexes a launch's floats in 32 bits, so an image is launched in bands
# of at most this many pixels (3 floats each, so 3 * BAND_PIXELS < 2^31): a
# multiple of 4, so every band of a 16-byte-aligned image starts aligned
BAND_PIXELS = 1 << 29


def filmic_reinhard_curve(x):
    q = (_T2 * _T2 + 1.0) * x * x
    return q / (q + x + _T2 * _T2)


def filmic_reinhard(x):
    return filmic_reinhard_curve(x) / filmic_reinhard_curve(_W)


def tonemap_plain(img: torch.Tensor, vignette: bool = True,
                  brightness: float = 1.0) -> torch.Tensor:
    """img[H,W,3] linear radiance -> display RGB in [0,1], plain PyTorch."""
    h, w = img.shape[0], img.shape[1]
    color = img
    if vignette:
        ar_h = torch.arange(h, dtype=torch.float32, device=img.device)
        ar_w = torch.arange(w, dtype=torch.float32, device=img.device)
        ys = 1.0 - 2.0 * (ar_h + 0.5) / h
        xs = 1.0 - 2.0 * (ar_w + 0.5) / w
        pp = ys[:, None] * ys[:, None] + xs[None, :] * xs[None, :]
        vig = 1.25 / (1.1 + 1.1 * pp)
        vig = vig * vig
        vig = 1.0 + (smoothstep(0.1, 1.1, vig) - 1.0) * 0.25
        color = color * vig[..., None]
    color = filmic_reinhard(brightness * color)
    color = smoothstep(-0.025, 1.0, color)
    return torch.pow(torch.clamp(color, 0.0, 1.0), 1.0 / 2.2)


def bands(h: int, w: int) -> list[tuple[int, int, int, int]]:
    """K2's launches over an [h, w, 3] image: (first pixel, pixels, the
    first pixel's row, its column) of each band of at most BAND_PIXELS
    consecutive pixels."""
    n = h * w
    return [(p0, min(BAND_PIXELS, n - p0), *divmod(p0, w))
            for p0 in range(0, n, BAND_PIXELS)]


class _TonemapKernel:
    """Wrapper of ``prt_tonemap`` (csrc/tonemap.cu), one launch a band (one
    for images up to BAND_PIXELS pixels).  ``launches`` counts kernel
    launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, img: torch.Tensor, vignette: bool, brightness: float):
        if img.ndim != 3 or img.shape[2] != 3:
            raise ValueError(f"tonemap: expected [H,W,3], got {tuple(img.shape)}")
        h, w = img.shape[0], img.shape[1]
        _cuda.require(img, "img", torch.float32, (h, w, 3), img.device)
        out = torch.empty_like(img)
        if h * w == 0:
            return out
        lib = _cuda.LIBRARY.get()
        src, dst = img.data_ptr(), out.data_ptr()
        for p0, n, y0, x0 in bands(h, w):
            with _cuda.on_device(img):
                code = lib.prt_tonemap(src + 12 * p0, dst + 12 * p0, n, w, h,
                                       y0, x0, float(brightness),
                                       int(bool(vignette)),
                                       _cuda.stream_handle(img))
            _cuda.check(code, "prt_tonemap")
            self.launches += 1
        return out


tonemap_kernel = _TonemapKernel()


def tonemap(img: torch.Tensor, vignette: bool = True,
            brightness: float = 1.0) -> torch.Tensor:
    """img[H,W,3] linear radiance -> display RGB in [0,1].

    CPU tensors take ``tonemap_plain``; CUDA tensors launch K2.
    """
    if img.device.type == "cpu":
        return tonemap_plain(img, vignette=vignette, brightness=brightness)
    if img.device.type != "cuda":
        raise ValueError(f"tonemap: unsupported device {img.device}")
    return tonemap_kernel(img.contiguous(), vignette, brightness)
