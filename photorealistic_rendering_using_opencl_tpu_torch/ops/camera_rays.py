"""Thin-lens camera ray generation, batched over pixels.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/camera_rays.py``
(with the reference's sub-pixel jitter fix).  The camera "pytree" is a
dict of float32 tensors with the same keys as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    cross, normalize,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.sampling import uniform_disk
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)

CAMERA_KEYS = ("position", "view", "up", "fov", "aperture_radius",
               "focal_distance")


@dataclasses.dataclass
class Camera:
    """POD render camera."""

    position: Any  # [3]
    view: Any  # [3] unit view direction
    up: Any  # [3]
    resolution: tuple[int, int]  # (width, height)
    fov: Any  # [2] degrees (x, y)
    aperture_radius: Any = 0.0
    focal_distance: Any = 4.0

    def pytree(self, device=DEFAULT_DEVICE) -> dict:
        """The differentiable leaves as float32 tensors on ``device`` (the
        card unless the caller asks for the CPU)."""
        return pytree_from_numpy(
            {k: getattr(self, k) for k in CAMERA_KEYS}, resolve_device(device))


def pytree_from_numpy(leaves: dict, device) -> dict:
    """Camera dict from numpy-convertible leaves (e.g. the JAX package's
    ``Camera.pytree()`` passed through ``np.asarray``)."""
    return {k: torch.from_numpy(np.array(leaves[k], np.float32)).to(device)
            for k in CAMERA_KEYS}


def default_camera(width: int, height: int) -> Camera:
    """The reference's startup orbit camera: yaw 0, pitch 0.3, radius 4,
    fovx 45."""
    yaw, pitch, radius = 0.0, 0.3, 4.0
    d = np.array([np.sin(yaw) * np.cos(pitch),
                  np.sin(pitch),
                  np.cos(yaw) * np.cos(pitch)], np.float32)
    position = d * radius
    view = -d
    fovx = 45.0
    fovy = np.degrees(np.arctan(np.tan(np.radians(fovx) * 0.5)
                                * (height / width)) * 2.0)
    return Camera(position=position, view=view,
                  up=np.array([0., 1., 0.], np.float32),
                  resolution=(width, height),
                  fov=np.array([fovx, fovy], np.float32),
                  aperture_radius=0.01, focal_distance=4.0)


def generate_rays(cam: dict, width: int, height: int,
                  px: torch.Tensor, py: torch.Tensor,
                  u_jitter: tuple, u_aperture: tuple,
                  jitter: bool = True):
    """px/py: integer pixel coords [N]; returns (origin[N,3], dir[N,3])."""
    view = normalize(cam["view"])
    up = normalize(cam["up"])
    horiz_axis = normalize(cross(view, up))
    vert_axis = normalize(cross(horiz_axis, view))

    middle = cam["position"] + view
    fov = cam["fov"]
    horizontal = horiz_axis * torch.tan(fov[0] * 0.5 * (math.pi / 180.0))
    vertical = vert_axis * (-torch.tan(fov[1] * 0.5 * (math.pi / 180.0)))

    jx, jy = u_jitter
    if not jitter:
        jx = torch.zeros_like(jx)
        jy = torch.zeros_like(jy)
    # flip y like the reference (pixely = height - y - 1)
    sx = (px.to(torch.float32) + jx) / float(width - 1.0)
    sy = ((height - 1 - py).to(torch.float32) + jy) / float(height - 1.0)

    point_on_plane = (middle[None]
                      + horizontal[None] * (2.0 * sx - 1.0)[:, None]
                      + vertical[None] * (2.0 * sy - 1.0)[:, None])
    point_on_image = (cam["position"][None]
                      + (point_on_plane - cam["position"][None])
                      * cam["focal_distance"])

    u1, u2 = u_aperture
    disk = uniform_disk(u1, u2) * cam["aperture_radius"]
    aperture = (cam["position"][None]
                + horiz_axis[None] * disk[:, 0:1]
                + vert_axis[None] * disk[:, 1:2])
    use_dof = cam["aperture_radius"] > 1e-5
    origin = torch.where(use_dof, aperture,
                         torch.broadcast_to(cam["position"], aperture.shape))
    direction = normalize(point_on_image - origin)
    return origin, direction


def sample_time(u, shutter_open: float = 0.0, shutter_close: float = 1.0):
    """A ray's time in the shutter interval: the reference's dormant
    motion-blur hook (nothing consumes a ray's time there either)."""
    return shutter_open + (shutter_close - shutter_open) * u
