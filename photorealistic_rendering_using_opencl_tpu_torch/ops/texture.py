"""Texture sampling: bilinear / trilinear-mip / anisotropic, batched.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/texture.py`` (a
working form of the reference's dormant texture-atlas sampler; nothing in
the renderer calls it).  Textures are [H,W,C] tensors; a mip pyramid is a
tuple of them.  UVs wrap (repeat addressing); the LOD is continuous.
"""
from __future__ import annotations

import math

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import sqrt_rn


def build_mip_pyramid(tex: torch.Tensor, max_levels: int | None = None):
    """2x box-filter pyramid [full, half, ...] down to 1x1 (a tuple)."""
    cur = torch.as_tensor(tex, dtype=torch.float32)
    levels = [cur]
    h, w = cur.shape[0], cur.shape[1]
    n = (int(math.floor(math.log2(max(min(h, w), 1))))
         if max_levels is None else max_levels - 1)
    for _ in range(n):
        ch, cw = cur.shape[0], cur.shape[1]
        if ch < 2 or cw < 2:
            break
        c = cur[:ch // 2 * 2, :cw // 2 * 2]
        cur = (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2]
               + c[1::2, 1::2]) * 0.25
        levels.append(cur)
    return tuple(levels)


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear fetch, u/v wrap (repeat addressing)."""
    h, w = tex.shape[0], tex.shape[1]
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = torch.remainder(x0.to(torch.int32), w).long()
    x1i = torch.remainder(x0i + 1, w)
    y0i = torch.remainder(y0.to(torch.int32), h).long()
    y1i = torch.remainder(y0i + 1, h)
    c00 = tex[y0i, x0i]
    c10 = tex[y0i, x1i]
    c01 = tex[y1i, x0i]
    c11 = tex[y1i, x1i]
    return ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
            + (c01 * (1 - fx) + c11 * fx) * fy)


def sample_trilinear(pyramid: tuple, u: torch.Tensor, v: torch.Tensor,
                     lod: torch.Tensor):
    """Bilinear in the two straddling mips, lerped by frac(lod); lod is
    clamped to the pyramid's height."""
    n = len(pyramid)
    lod = torch.clamp(lod, 0.0, n - 1.0)
    lo = torch.floor(lod).to(torch.int32)
    f = (lod - lo.to(torch.float32))[..., None]
    hi = torch.clamp(lo + 1, max=n - 1)
    # every level sampled and picked by a mask (the levels' shapes differ)
    out_lo = torch.zeros(u.shape + (pyramid[0].shape[-1],),
                         dtype=torch.float32, device=u.device)
    out_hi = torch.zeros_like(out_lo)
    for i, level in enumerate(pyramid):
        s = sample_bilinear(level, u, v)
        out_lo = torch.where((lo == i)[..., None], s, out_lo)
        out_hi = torch.where((hi == i)[..., None], s, out_hi)
    return out_lo * (1.0 - f) + out_hi * f


def sample_anisotropic(pyramid: tuple, u: torch.Tensor, v: torch.Tensor,
                       du: torch.Tensor, dv: torch.Tensor,
                       max_taps: int = 4):
    """Several trilinear taps along the major UV-gradient axis at the LOD
    of the minor axis."""
    h, w = pyramid[0].shape[0], pyramid[0].shape[1]
    scale = torch.tensor([w, h], dtype=torch.float32, device=u.device)

    def length(d):
        d = d * scale
        return sqrt_rn(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])

    lx, ly = length(du), length(dv)
    minor = torch.clamp(torch.minimum(lx, ly), min=1e-8)
    lod = torch.log2(torch.clamp(minor, min=1.0))
    step = torch.where((lx >= ly)[..., None], du, dv)
    acc = 0.0
    for i in range(max_taps):
        t = (i + 0.5) / max_taps - 0.5
        acc = acc + sample_trilinear(pyramid, u + step[..., 0] * t,
                                     v + step[..., 1] * t, lod)
    return acc / max_taps
