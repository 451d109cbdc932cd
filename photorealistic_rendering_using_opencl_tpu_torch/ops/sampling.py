"""Direction samplers with pdfs, batched (the ones the forward path uses).

Port of ``photorealistic_rendering_using_opencl_tpu/ops/sampling.py``.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    INV_FOUR_PI, INV_PI, INV_TWO_PI, TWO_PI, safe_sqrt,
)


def _from_polar(phi, z):
    r = safe_sqrt(1.0 - z * z)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def uniform_sphere(u1, u2):
    return _from_polar(u1 * TWO_PI, u2 * 2.0 - 1.0)


def uniform_sphere_pdf():
    return INV_FOUR_PI


def uniform_spherical_cap(u1, u2, cos_theta_max):
    z = u2 * (1.0 - cos_theta_max) + cos_theta_max
    return _from_polar(u1 * TWO_PI, z)


def uniform_spherical_cap_pdf(cos_theta_max):
    return INV_TWO_PI / torch.clamp(1.0 - cos_theta_max, min=1e-12)


def cosine_hemisphere(u1, u2):
    phi = u1 * TWO_PI
    r = torch.sqrt(u2)
    return torch.stack([
        torch.cos(phi) * r,
        torch.sin(phi) * r,
        torch.sqrt(torch.clamp(1.0 - u2, min=0.0)),
    ], dim=-1)


def cosine_hemisphere_pdf(w):
    return torch.abs(w[..., 2]) * INV_PI


def uniform_disk(u1, u2):
    """Polar disk sample (thin-lens aperture)."""
    angle = TWO_PI * u1
    r = torch.sqrt(u2)
    return torch.stack([torch.cos(angle) * r, torch.sin(angle) * r], dim=-1)
