"""Environment map: equirect lookup on a miss, and importance sampling.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/envmap.py``: the
equirect lookup with bilinear filtering (u wraps, v clamps), the
luminance-times-sin(theta) CDF tables built once at load, the continuous
inverse-CDF sampler and its solid-angle pdf.  The per-row search is a
bisection of O(log W) single-element gathers, never an [N, W] gather.

On the CPU the lookup is four gathers and a blend, and its backward (the
gradient of the map) an indexed accumulation of each gather.  On the card
it is one hand-written kernel pair (``csrc/envmap.cu``) behind
``BilinearLookup``: the forward computes the four taps and the blend in
the plain expression's order of operations, bit for bit the same; the
backward adds each lane's four weighted taps into the map with atomic
adds, and skips a lane whose gradient is exactly zero (most lanes: dead,
or not a miss).  The atomics come in an order that changes from run to
run, so the map's gradient agrees with the CPU's to a tolerance, not
bitwise.  The device alone decides the path.
"""
from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    INV_PI, INV_TWO_PI, PI, TWO_PI,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import TRACER

LUMINANCE = (0.2126, 0.7152, 0.0722)


def equirect_uv(direction: torch.Tensor):
    """direction [..., 3] -> (u, v) in [0, 1]^2."""
    u = torch.atan2(direction[..., 2], direction[..., 0]) * INV_TWO_PI + 0.5
    v = torch.acos(torch.clamp(direction[..., 1], -1.0, 1.0)) * INV_PI
    return u, v


def sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear fetch from img [H,W,3]; u wraps, v clamps."""
    if img.device.type == "cuda":
        out = BilinearLookup.apply(img.contiguous(), u.reshape(-1).contiguous(),
                                   v.reshape(-1).contiguous())
        if TRACER.on and out.requires_grad:
            # the one backward node: the kernel that scatters the map's
            # gradient
            TRACER.span_nodes("prt.sky_grad", [out.grad_fn])
        return out.reshape(*u.shape, 3)
    return lookup_plain(img, u, v)


def lookup_plain(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The lookup as four gathers and a blend, on any device: the CPU's
    path, and the plain version the card's kernel pair is held to."""
    h, w = img.shape[0], img.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w)
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1)
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = img.reshape(h * w, 3)

    def tap(yi, xi):
        return flat[(yi * w + xi).long()]

    c00 = tap(y0i, x0i)
    c10 = tap(y0i, x1i)
    c01 = tap(y1i, x0i)
    c11 = tap(y1i, x1i)
    if TRACER.on and c00.requires_grad:
        # the taps' backward scatters the map's gradient (index_put)
        TRACER.span_nodes("prt.sky_grad",
                          [c.grad_fn for c in (c00, c10, c01, c11)])
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


class _BilinearKernel:
    """Wrappers of ``prt_envmap_lookup`` and ``prt_envmap_lookup_grad``
    (``csrc/envmap.cu``) on img [H,W,3] and u, v [N] float32.
    ``launches`` and ``grad_launches`` count the two kernels' launches and
    nothing else."""

    THREADS = 256  # the backward kernel's block
    MAX_BLOCKS = 2048  # its grid: some 8 blocks an SM of 132, twice over

    def __init__(self):
        self.launches = 0
        self.grad_launches = 0

    @staticmethod
    def _check(img, u, v):
        h, w = img.shape[0], img.shape[1]
        n = u.shape[0]
        _cuda.require(img, "img", torch.float32, (h, w, 3), img.device)
        _cuda.require(u, "u", torch.float32, (n,), img.device)
        _cuda.require(v, "v", torch.float32, (n,), img.device)
        return h, w, n

    def __call__(self, img, u, v):
        """The lookup [N,3]."""
        h, w, n = self._check(img, u, v)
        out = torch.empty((n, 3), dtype=torch.float32, device=img.device)
        if n == 0:
            return out
        lib = _cuda.LIBRARY.get()
        with _cuda.on_device(img):
            code = lib.prt_envmap_lookup(
                img.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(),
                n, h, w, _cuda.stream_handle(img))
        _cuda.check(code, "prt_envmap_lookup")
        self.launches += 1
        return out

    def grad(self, img, u, v, grad_out, need_map: bool, need_uv: bool):
        """The lookup's backward for grad_out [N,3] -> (the map's gradient
        [H,W,3] or None, grad_u [N] or None, grad_v [N] or None), each
        computed only where asked.  While the tracer is on, counter
        ``sky_grad.writes`` receives the texel writes the kernel made
        (one count a block, summed after the traced region)."""
        h, w, n = self._check(img, u, v)
        dev = img.device
        _cuda.require(grad_out, "grad_out", torch.float32, (n, 3), dev)
        grad_map = (torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
                    if need_map else None)
        grad_u, grad_v = ((torch.empty((n,), dtype=torch.float32, device=dev),
                           torch.empty((n,), dtype=torch.float32, device=dev))
                          if need_uv else (None, None))
        if n == 0 or not (need_map or need_uv):
            return grad_map, grad_u, grad_v
        blocks = min(-(-n // self.THREADS), self.MAX_BLOCKS)
        counts = (torch.empty((blocks,), dtype=torch.int32, device=dev)
                  if need_map and TRACER.on else None)
        lib = _cuda.LIBRARY.get()
        with _cuda.on_device(img):
            code = lib.prt_envmap_lookup_grad(
                img.data_ptr(), u.data_ptr(), v.data_ptr(),
                grad_out.data_ptr(),
                *(None if t is None else t.data_ptr()
                  for t in (grad_map, grad_u, grad_v)),
                n, h, w, blocks, None if counts is None else counts.data_ptr(),
                _cuda.stream_handle(img))
        _cuda.check(code, "prt_envmap_lookup_grad")
        self.grad_launches += 1
        if counts is not None:
            TRACER.count_tensor("sky_grad.writes", counts)
        return grad_map, grad_u, grad_v


bilinear_kernel = _BilinearKernel()


class BilinearLookup(torch.autograd.Function):
    """The lookup of img [H,W,3] at u, v [N] -> [N,3] on CUDA tensors, by
    the kernel pair, with its gradients of the map, u and v.  It saves u, v
    and the map, nothing per tap.  While the tracer is on, each backward
    adds 4 N to counter ``sky_grad.taps``."""

    @staticmethod
    def forward(ctx, img, u, v):
        ctx.save_for_backward(img, u, v)
        return bilinear_kernel(img, u, v)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        img, u, v = ctx.saved_tensors
        need_map, need_u, need_v = ctx.needs_input_grad
        need_uv = need_u or need_v
        if need_map:
            TRACER.count("sky_grad.taps", 4 * u.shape[0])
        grad_map, grad_u, grad_v = bilinear_kernel.grad(
            img, u, v, grad_out.contiguous(), need_map, need_uv)
        return (grad_map, grad_u if need_u else None,
                grad_v if need_v else None)


def radiance(env_map: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    u, v = equirect_uv(direction)
    return sample_bilinear(env_map, u, v)


# ---------------------------------------------------------------------------
# Luminance-CDF importance sampling (tables at load, inverse CDF per ray)
# ---------------------------------------------------------------------------

def build_env_distribution(env_map: torch.Tensor) -> dict:
    """Row and conditional CDFs of luminance x sin(theta): a dict with
    cond_cdf [H,W], marg_cdf [H], weights [H,W] and total [] (the
    SceneData leaves env_cond_cdf, env_marg_cdf, env_weights,
    env_total)."""
    env_map = env_map.detach()
    h = env_map.shape[0]
    dev = env_map.device
    lum = torch.sum(env_map * torch.tensor(LUMINANCE, dtype=torch.float32,
                                           device=dev), dim=-1)
    theta = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h * PI
    weights = lum * torch.sin(theta)[:, None] + 1e-12
    row_sums = torch.sum(weights, dim=1)
    cond_cdf = torch.cumsum(weights, dim=1) / row_sums[:, None]
    marg_cdf = torch.cumsum(row_sums, dim=0) / torch.sum(row_sums)
    return dict(cond_cdf=cond_cdf, marg_cdf=marg_cdf, weights=weights,
                total=torch.sum(row_sums))


def searchsorted_rows(cdf_table: torch.Tensor, row: torch.Tensor,
                      u: torch.Tensor) -> torch.Tensor:
    """Per-ray searchsorted within a selected row of an [H,W] CDF table:
    the first index where cdf >= u, by bisection with one single-element
    gather a step (the reference's ``jax_searchsorted_rows``)."""
    w = cdf_table.shape[1]
    steps = max(1, int(math.ceil(math.log2(max(w, 2)))))
    flat = cdf_table.reshape(-1)
    base = row.long() * w
    lo = torch.zeros_like(row)
    hi = torch.full_like(row, w - 1)
    for _ in range(steps):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        below = flat[base + mid.long()] < u
        lo, hi = torch.where(below, mid + 1, lo), torch.where(below, hi, mid)
    return lo.to(torch.int32)


def sample_env(dist: dict, u1: torch.Tensor, u2: torch.Tensor):
    """Continuous inverse-CDF sample -> (direction [N,3], solid-angle pdf
    [N]), uniform within the selected texel so that radiance / pdf is
    unbiased."""
    row, col, v, u = sample_env_cell(dist, u1, u2)
    theta = v * PI
    phi = (u - 0.5) * TWO_PI
    sin_t = torch.sin(theta)
    direction = torch.stack([torch.cos(phi) * sin_t, torch.cos(theta),
                             torch.sin(phi) * sin_t], dim=-1)
    return direction, env_pdf_from_cell(dist, row, col, sin_t)


def sample_env_cell(dist: dict, u1: torch.Tensor, u2: torch.Tensor):
    """The inverse CDF of ``sample_env`` -> (row [N], col [N] int64, v [N],
    u [N]): the texel and the sample's equirect coordinates in it."""
    h, w = dist["cond_cdf"].shape
    marg = dist["marg_cdf"]
    row = torch.clamp(torch.searchsorted(marg, u1), 0, h - 1)
    c_hi = marg[row]
    c_lo = torch.where(row > 0, marg[torch.clamp(row - 1, min=0)], 0.0)
    frac_v = torch.clamp((u1 - c_lo) / torch.clamp(c_hi - c_lo, min=1e-12),
                         0.0, 1.0)

    cond = dist["cond_cdf"]
    col = torch.clamp(searchsorted_rows(cond, row, u2), 0, w - 1).long()
    d_hi = cond[row, col]
    d_lo = torch.where(col > 0, cond[row, torch.clamp(col - 1, min=0)], 0.0)
    frac_u = torch.clamp((u2 - d_lo) / torch.clamp(d_hi - d_lo, min=1e-12),
                         0.0, 1.0)

    v = (row.to(torch.float32) + frac_v) / h
    u = (col.to(torch.float32) + frac_u) / w
    return row, col, v, u


def env_pdf_from_cell(dist, row, col, sin_theta):
    h, w = dist["cond_cdf"].shape
    cell = dist["weights"][row.long(), col.long()] / dist["total"]
    # p(u,v) = cell * H*W; dw = (2pi/W)(pi/H) sin(theta)
    return cell * h * w / torch.clamp(TWO_PI * PI * sin_theta, min=1e-12)


def env_pdf(dist: dict, direction: torch.Tensor):
    """Solid-angle pdf of sampling a given direction."""
    h, w = dist["cond_cdf"].shape
    u, v = equirect_uv(direction)
    col = torch.clamp((u * w).to(torch.int32), 0, w - 1)
    row = torch.clamp((v * h).to(torch.int32), 0, h - 1)
    sin_t = torch.sqrt(torch.clamp(
        1.0 - direction[..., 1] * direction[..., 1], min=1e-12))
    return env_pdf_from_cell(dist, row, col, sin_t)
