"""Direction samplers with pdfs and inverses, batched.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/sampling.py``: the
samplers the forward path uses, and the uniform-hemisphere and Phong
samplers and the ``invert_*`` maps that nothing in the renderer calls.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    INV_FOUR_PI, INV_PI, INV_TWO_PI, TWO_PI, safe_sqrt, sqrt_rn,
)


def _from_polar(phi, z):
    r = safe_sqrt(1.0 - z * z)
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, z], dim=-1)


def invert_phi(w, mu):
    x, y = w[..., 0], w[..., 1]
    deg = (x == 0.0) & (y == 0.0)
    res = torch.where(deg, mu * INV_TWO_PI, torch.atan2(y, x) * INV_TWO_PI)
    return torch.where(res < 0.0, res + 1.0, res)


def uniform_sphere(u1, u2):
    return _from_polar(u1 * TWO_PI, u2 * 2.0 - 1.0)


def uniform_sphere_pdf():
    return INV_FOUR_PI


def invert_uniform_sphere(w, mu):
    return invert_phi(w, mu), (w[..., 2] + 1.0) * 0.5


def uniform_hemisphere(u1, u2):
    phi = TWO_PI * u1
    r = sqrt_rn(torch.clamp(1.0 - u2 * u2, min=0.0))
    return torch.stack([torch.cos(phi) * r, torch.sin(phi) * r, u2], dim=-1)


def uniform_hemisphere_pdf():
    return INV_TWO_PI


def invert_uniform_hemisphere(w, mu):
    return invert_phi(w, mu), w[..., 2]


def uniform_spherical_cap(u1, u2, cos_theta_max):
    z = u2 * (1.0 - cos_theta_max) + cos_theta_max
    return _from_polar(u1 * TWO_PI, z)


def uniform_spherical_cap_pdf(cos_theta_max):
    return INV_TWO_PI / torch.clamp(1.0 - cos_theta_max, min=1e-12)


def invert_uniform_spherical_cap(w, cos_theta_max, mu):
    """Returns (valid, u1, u2)."""
    xi_y = (w[..., 2] - cos_theta_max) / (1.0 - cos_theta_max)
    valid = (xi_y >= 0.0) & (xi_y < 1.0)
    return valid, invert_phi(w, mu), xi_y


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


def invert_cosine_hemisphere(w, mu):
    return invert_phi(w, mu), torch.clamp(1.0 - w[..., 2] * w[..., 2],
                                          min=0.0)


def phong_hemisphere(u1, u2, n):
    phi = u1 * TWO_PI
    cos_theta = torch.pow(u2, 1.0 / (n + 1.0))
    return _from_polar(phi, cos_theta)


def phong_hemisphere_pdf(w, n):
    return INV_TWO_PI * (n + 1.0) * torch.pow(torch.clamp(w[..., 2], min=0.0),
                                              n)


def invert_phong_hemisphere(w, n, mu):
    return invert_phi(w, mu), torch.pow(w[..., 2], n + 1.0)


def uniform_disk(u1, u2):
    """Polar disk sample (thin-lens aperture)."""
    angle = TWO_PI * u1
    r = torch.sqrt(u2)
    return torch.stack([torch.cos(angle) * r, torch.sin(angle) * r], dim=-1)
