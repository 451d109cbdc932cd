"""Participating media: homogeneous and exponential (height-fog) distance
sampling with spectral-channel MIS, batched.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/media.py``.  The
medium type is the static ``SceneConfig.medium_type``; sigma_a, sigma_s
and sigma_t are differentiable [3] scene leaves.  The channel is picked
uniformly (``u_chan * 3`` truncated) and the pdf is the channel average.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import avg3


class MediumSample(NamedTuple):
    t: torch.Tensor  # [N] sampled distance (min(t_medium, t_surface))
    weight: torch.Tensor  # [N,3] throughput multiplier (includes sigma_s / pdf)
    pdf: torch.Tensor  # [N]
    exited: torch.Tensor  # [N] bool: True where the ray reached the surface
    p: torch.Tensor  # [N,3] scatter or exit point


def _channel(sigma_t, u_chan):
    chan = torch.clamp((u_chan * 3.0).to(torch.int32), 0, 2).long()
    return torch.clamp(sigma_t[chan], min=1e-12)


def homogeneous_sample_distance(sigma_s, sigma_t, absorption_only: bool,
                                origin, direction, max_t, u_chan, u_dist
                                ) -> MediumSample:
    """Free-flight sampling in a homogeneous medium; sigma_* are [3],
    origin/direction [N,3], max_t [N]."""
    if absorption_only:
        t = max_t
        weight = torch.exp(-t[..., None] * sigma_t)
        return MediumSample(t, weight, torch.ones_like(t),
                            torch.ones_like(t, dtype=torch.bool),
                            origin + direction * t[..., None])

    sigma_tc = _channel(sigma_t, u_chan)
    t_free = -torch.log1p(-torch.clamp(u_dist, 0.0, 1.0 - 1e-7)) / sigma_tc
    t = torch.minimum(t_free, max_t)
    exited = t_free >= max_t

    tau = t[..., None] * sigma_t
    weight = torch.exp(-tau)
    pdf_exit = avg3(torch.exp(-tau))
    pdf_scat = avg3(sigma_t * torch.exp(-tau))
    pdf = torch.where(exited, pdf_exit, pdf_scat)
    weight = torch.where(exited[..., None], weight, weight * sigma_s)
    weight = weight / torch.clamp(pdf, min=1e-30)[..., None]
    return MediumSample(t, weight, pdf, exited,
                        origin + direction * t[..., None])


def homogeneous_transmittance(sigma_t, dist):
    """exp(-sigma_t * d): the shadow-ray attenuation of NEE contributions."""
    return torch.exp(-dist[..., None] * sigma_t)


# ---------------------------------------------------------------------------
# Exponential (height-fog) medium, density exp(-scale * dot(p - p0, dir_f)),
# with the reference's falloff (scale 1, direction +y, unit point 0)
# ---------------------------------------------------------------------------

_INF = 1e30


def _density_integral(x, dx, t_max):
    """Optical-depth integral of exp(-(x + dx*t)) over [0, t_max]."""
    flat_dx = torch.abs(dx) < 1e-12
    safe_dx = torch.where(flat_dx, 1.0, dx)
    finite = (torch.exp(-x) - torch.exp(-safe_dx * t_max - x)) / safe_dx
    flat = torch.exp(-x) * t_max
    return torch.where(flat_dx, flat, finite)


def _inverse_optical_depth(x, dx, sigma_t, log_xi):
    flat = -log_xi / torch.clamp(sigma_t * torch.exp(-x), min=1e-30)
    denom = sigma_t + dx * torch.exp(x) * log_xi
    flat_dx = torch.abs(dx) < 1e-12
    safe_dx = torch.where(flat_dx, 1.0, dx)
    slope = torch.where(
        denom <= 0.0, _INF,
        torch.log(torch.clamp(sigma_t / torch.clamp(denom, min=1e-30),
                              min=1e-30)) / safe_dx)
    return torch.where(flat_dx, flat, slope)


def _falloff(origin, direction, falloff_scale, falloff_dir, unit_point):
    fdir = torch.tensor(falloff_dir, dtype=torch.float32, device=origin.device)
    upt = torch.tensor(unit_point, dtype=torch.float32, device=origin.device)
    x = falloff_scale * torch.sum((origin - upt) * fdir, dim=-1)
    dx = falloff_scale * torch.sum(direction * fdir, dim=-1)
    return x, dx


def exponential_sample_distance(sigma_s, sigma_t, absorption_only: bool,
                                origin, direction, max_t, u_chan, u_dist,
                                falloff_scale: float = 1.0,
                                falloff_dir=(0.0, 1.0, 0.0),
                                unit_point=(0.0, 0.0, 0.0)) -> MediumSample:
    x, dx = _falloff(origin, direction, falloff_scale, falloff_dir,
                     unit_point)
    if absorption_only:
        t = max_t
        weight = torch.exp(-sigma_t * _density_integral(x, dx, t)[..., None])
        return MediumSample(t, weight, torch.ones_like(t),
                            torch.ones_like(t, dtype=torch.bool),
                            origin + direction * t[..., None])

    sigma_tc = _channel(sigma_t, u_chan)
    log_xi = torch.log(torch.clamp(1.0 - u_dist, min=1e-12))
    t_free = _inverse_optical_depth(x, dx, sigma_tc, log_xi)
    t = torch.minimum(t_free, max_t)
    exited = t_free >= max_t

    trans = torch.exp(-sigma_t * _density_integral(x, dx, t)[..., None])
    rho = torch.exp(-(x + dx * t))
    pdf_exit = avg3(trans)
    pdf_scat = avg3(rho[..., None] * sigma_t * trans)
    pdf = torch.where(exited, pdf_exit, pdf_scat)
    weight = torch.where(exited[..., None], trans,
                         rho[..., None] * sigma_t * trans)
    # scattering multiplies by rho * sigma_t; the albedo sigma_s / sigma_t
    # is folded in here, as in the homogeneous medium
    weight = torch.where(exited[..., None], weight,
                         weight * (sigma_s / torch.clamp(sigma_t, min=1e-30)))
    weight = weight / torch.clamp(pdf, min=1e-30)[..., None]
    return MediumSample(t, weight, pdf, exited,
                        origin + direction * t[..., None])


def exponential_transmittance(sigma_t, origin, direction, dist,
                              falloff_scale: float = 1.0,
                              falloff_dir=(0.0, 1.0, 0.0),
                              unit_point=(0.0, 0.0, 0.0)):
    x, dx = _falloff(origin, direction, falloff_scale, falloff_dir,
                     unit_point)
    return torch.exp(-sigma_t * _density_integral(x, dx, dist)[..., None])


def equiangular_sample(origin, direction, t_max, light_pos, xi):
    """Equiangular distance sampling toward a point light -> (dist [N],
    pdf [N] in distance measure over [0, t_max]).  The reference has it
    and calls it nowhere; so does this port."""
    delta = torch.sum((light_pos - origin) * direction, dim=-1)
    closest = origin + delta[..., None] * direction
    dd = torch.clamp(torch.linalg.vector_norm(light_pos - closest, dim=-1),
                     min=1e-6)
    theta_a = torch.atan2(0.0 - delta, dd)
    theta_b = torch.atan2(t_max - delta, dd)
    t = dd * torch.tan(theta_a + (theta_b - theta_a) * xi)
    dist = delta + t
    pdf = dd / (torch.clamp(theta_b - theta_a, min=1e-9) * (dd * dd + t * t))
    return dist, pdf
