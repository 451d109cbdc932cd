"""Microfacet distributions: Beckmann / Phong / GGX (D, G1, G, pdf, sample),
and the Blinn NDF (``blinn_d``, ``blinn_sample``) that nothing calls.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/microfacet.py``:
the distribution id is a per-ray bitmask and all three closed forms are
evaluated and selected with masks.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    INV_PI, INV_TWO_PI, TWO_PI, safe_sqrt, sqrt_rn,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    BECKMANN, PHONG,
)


def roughness_to_alpha(dist, roughness):
    """Phong maps roughness -> exponent."""
    r = torch.clamp(roughness, min=1e-3)
    phong = 2.0 / (r * r) - 2.0
    return torch.where((dist & PHONG) != 0, phong, r)


def D(dist, alpha, m):
    mz = m[..., 2]
    a2 = alpha * alpha
    c2 = mz * mz
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    c4 = torch.clamp(c2 * c2, min=1e-20)
    # Beckmann in log space (finite partials at grazing half-vectors)
    a2s = torch.clamp(a2, min=1e-12)
    c2s = torch.clamp(c2, min=1e-12)
    beck = INV_PI * torch.exp(-t2 / a2s - torch.log(a2s) - 2.0 * torch.log(c2s))
    phong = (alpha + 2.0) * INV_TWO_PI * torch.pow(torch.clamp(mz, min=1e-12),
                                                   alpha)
    ggx = a2 * INV_PI / (c4 * torch.square(a2 + t2))
    d = torch.where((dist & BECKMANN) != 0, beck,
                    torch.where((dist & PHONG) != 0, phong, ggx))
    return torch.where(mz <= 0.0, 0.0, d)


def _smith_rational(a):
    a = torch.clamp(a, min=1e-12)
    low = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    return torch.where(a < 1.6, low, 1.0)


def G1(dist, alpha, v, m):
    vz = v[..., 2]
    back = torch.sum(v * m, dim=-1) * vz <= 0.0
    c2 = vz * vz
    tan_theta = torch.abs(safe_sqrt(1.0 - c2)
                          / torch.where(vz == 0.0, 1e-12, vz))
    tan_theta = torch.clamp(tan_theta, min=1e-12)
    beck = _smith_rational(1.0 / (torch.clamp(alpha, min=1e-12) * tan_theta))
    phong = _smith_rational(torch.sqrt(0.5 * alpha + 1.0) / tan_theta)
    t2 = torch.clamp(1.0 - c2, min=0.0) / torch.clamp(c2, min=1e-12)
    ggx = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))
    g = torch.where((dist & BECKMANN) != 0, beck,
                    torch.where((dist & PHONG) != 0, phong, ggx))
    return torch.where(back, 0.0, g)


def G(dist, alpha, wi, wo, m):
    return G1(dist, alpha, wi, m) * G1(dist, alpha, wo, m)


def pdf(dist, alpha, m):
    return D(dist, alpha, m) * torch.clamp(m[..., 2], min=0.0)


def sample(dist, alpha, u1, u2):
    phi = u2 * TWO_PI
    xs = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    beck_t2 = -alpha * alpha * torch.log1p(-xs)
    beck_c = 1.0 / torch.sqrt(1.0 + beck_t2)
    phong_c = torch.pow(xs, 1.0 / (alpha + 2.0))
    ggx_t2 = alpha * alpha * xs / (1.0 - xs)
    ggx_c = 1.0 / torch.sqrt(1.0 + ggx_t2)
    cos_theta = torch.where((dist & BECKMANN) != 0, beck_c,
                            torch.where((dist & PHONG) != 0, phong_c, ggx_c))
    r = safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, cos_theta],
                       dim=-1)


# Blinn NDF: dead in the reference (nothing includes it), ported for
# parity with the JAX package

def blinn_d(cos_nh, alpha):
    """(a+2) max(0, n.wh)^a / 2pi."""
    return (alpha + 2.0) * torch.pow(torch.clamp(cos_nh, min=0.0),
                                     alpha) * INV_TWO_PI


def blinn_sample(u1, u2, alpha):
    """A unit half-vector about +z with cos theta = u^(1/(a+1))."""
    phi = TWO_PI * u1
    cos_t = torch.pow(u2, 1.0 / (alpha + 1.0))
    sin_t = sqrt_rn(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)
