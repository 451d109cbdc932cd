"""Phase functions: isotropic, Henyey-Greenstein and Rayleigh, batched.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/phase.py``.  The
choice is the static ``SceneConfig.phase_function``; the HG anisotropy
``g`` is a differentiable scene leaf (``SceneData.phase_g``).  All
functions take world-space directions; ``wi`` is the propagation
direction of the ray entering the scatter event.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    INV_FOUR_PI, PI, TWO_PI, dot, to_global,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.sampling import uniform_sphere


def _const(wi, value):
    return torch.full(wi.shape[:-1], value, dtype=torch.float32,
                      device=wi.device)


# ----------------------------- isotropic -----------------------------------

def iso_eval(wi, wo, g=None):
    return _const(wi, INV_FOUR_PI)


def iso_pdf(wi, wo, g=None):
    return _const(wi, INV_FOUR_PI)


def iso_sample(wi, u1, u2, g=None):
    return uniform_sphere(u1, u2), _const(wi, INV_FOUR_PI)


# ------------------------- Henyey-Greenstein -------------------------------

def _hg(cos_theta, g):
    term = 1.0 + g * g - 2.0 * g * cos_theta
    return INV_FOUR_PI * (1.0 - g * g) / (
        term * torch.sqrt(torch.clamp(term, min=1e-12)))


def hg_eval(wi, wo, g):
    return _hg(dot(wi, wo), g)


def hg_pdf(wi, wo, g):
    return _hg(dot(wi, wo), g)


def _local_dir(phi, cos_theta):
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return torch.stack([torch.cos(phi) * sin_theta,
                        torch.sin(phi) * sin_theta, cos_theta], dim=-1)


def hg_sample(wi, u1, u2, g):
    phi = u1 * TWO_PI
    g_safe = torch.where(torch.abs(g) < 1e-4, 1e-4, g)
    cos_theta = (1.0 + g_safe * g_safe
                 - torch.square((1.0 - g_safe * g_safe)
                                / (1.0 + g_safe * (u2 * 2.0 - 1.0)))) / (
                     2.0 * g_safe)
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    return to_global(wi, _local_dir(phi, cos_theta)), _hg(cos_theta, g)


# ------------------------------ Rayleigh -----------------------------------

def _rayleigh(cos_theta):
    return (3.0 / (16.0 * PI)) * (1.0 + cos_theta * cos_theta)


def rayleigh_eval(wi, wo, g=None):
    return _rayleigh(dot(wi, wo))


def rayleigh_pdf(wi, wo, g=None):
    return _rayleigh(dot(wi, wo))


def rayleigh_sample(wi, u1, u2, g=None):
    """Exact inverse CDF through the cubic root."""
    phi = u1 * TWO_PI
    z = u2 * 4.0 - 2.0
    inv_z = torch.sqrt(z * z + 1.0)
    u = torch.pow(z + inv_z, 1.0 / 3.0)  # the base is > 0: sqrt(z^2+1) > |z|
    cos_theta = u - 1.0 / u
    return to_global(wi, _local_dir(phi, cos_theta)), _rayleigh(cos_theta)


_TABLE = {
    "isotropic": (iso_eval, iso_pdf, iso_sample),
    "hg": (hg_eval, hg_pdf, hg_sample),
    "rayleigh": (rayleigh_eval, rayleigh_pdf, rayleigh_sample),
}


def get(name: str):
    """(eval, pdf, sample) of a statically selected phase function."""
    return _TABLE[name]
