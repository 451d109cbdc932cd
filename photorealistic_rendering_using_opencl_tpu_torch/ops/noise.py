"""Procedural value noise + fractal Brownian motion, batched.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/noise.py`` (the
reference's sin-hash value noise with quintic smoothing and a 5-octave
FBM).  Nothing in the renderer calls it: it is a procedural-texture hook.
The lattice hash multiplies a sine by 43758.5, so a last bit of the sine
moves the hash by ~3e-3: the sine here is correctly rounded (float64,
rounded once), and every other step keeps the reference's order.
"""
from __future__ import annotations

import torch

_HASH = (127.1, 311.7, 74.7)


def _sin(x: torch.Tensor) -> torch.Tensor:
    return torch.sin(x.double()).float()


def _hash3(p: torch.Tensor) -> torch.Tensor:
    """sin-based lattice hash -> [0,1); p[...,3] integer lattice coords."""
    h = p * torch.tensor(_HASH, dtype=torch.float32, device=p.device)
    h = (h[..., 0] + h[..., 1]) + h[..., 2]
    return torch.remainder(torch.abs(_sin(h) * 43758.5453123), 1.0)


def value_noise(p: torch.Tensor) -> torch.Tensor:
    """Trilinear value noise in [0,1); p[...,3] sample positions."""
    pi = torch.floor(p)
    pf = p - pi
    # quintic fade
    w = pf * pf * pf * (pf * (pf * 6.0 - 15.0) + 10.0)

    def corner(dx, dy, dz):
        off = torch.tensor([dx, dy, dz], dtype=torch.float32, device=p.device)
        return _hash3(pi + off)

    c000, c100 = corner(0, 0, 0), corner(1, 0, 0)
    c010, c110 = corner(0, 1, 0), corner(1, 1, 0)
    c001, c101 = corner(0, 0, 1), corner(1, 0, 1)
    c011, c111 = corner(0, 1, 1), corner(1, 1, 1)

    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    x00 = c000 + wx * (c100 - c000)
    x10 = c010 + wx * (c110 - c010)
    x01 = c001 + wx * (c101 - c001)
    x11 = c011 + wx * (c111 - c011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def value_fbm(p: torch.Tensor, octaves: int = 5, lacunarity: float = 2.0,
              gain: float = 0.5) -> torch.Tensor:
    """Fractal Brownian motion over value noise."""
    amp = 1.0
    freq = 1.0
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    norm = 0.0
    for _ in range(octaves):
        total = total + amp * value_noise(p * freq)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / norm
