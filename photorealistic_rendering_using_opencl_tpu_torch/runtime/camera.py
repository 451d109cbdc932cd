"""Interactive orbit camera (host state; builds the per-frame ``Camera``).

Port of ``photorealistic_rendering_using_opencl_tpu/runtime/camera.py``,
the reference's ``InteractiveCamera``: yaw/pitch/radius orbit around a
center point, proportional radius/aperture steps, clamped pitch, radius,
aperture and focal distance.  Edits are numpy math on the host, op for op
and clamp for clamp the reference's; ``build_render_camera`` returns the
port's ``Camera``, whose ``pytree(device)`` puts it on the device for the
next progressive step.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import Camera

_PI_OVER_TWO = math.pi / 2.0


@dataclasses.dataclass
class InteractiveCamera:
    center: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    yaw: float = 0.0
    pitch: float = 0.3
    radius: float = 4.0
    aperture_radius: float = 0.01
    focal_distance: float = 4.0
    resolution: tuple[int, int] = (1024, 1024)
    fov_x: float = 45.0

    # ---- edit operations; all proportional/clamped ----
    def change_yaw(self, m: float) -> None:
        self.yaw = (self.yaw + m) % (2.0 * math.pi)

    def change_pitch(self, m: float) -> None:
        pad = 0.05
        self.pitch = float(np.clip(self.pitch + m,
                                   -_PI_OVER_TWO + pad, _PI_OVER_TWO - pad))

    def change_radius(self, m: float) -> None:
        self.radius = float(np.clip(self.radius + self.radius * m, 0.2, 100.0))

    def change_altitude(self, m: float) -> None:
        self.center[1] += m

    def go_forward(self, m: float) -> None:
        self.center += self._view_direction() * m

    def strafe(self, m: float) -> None:
        axis = np.cross(self._view_direction(), np.array([0., 1., 0.]))
        n = np.linalg.norm(axis)
        if n > 1e-12:
            self.center += (axis / n).astype(np.float32) * m

    def change_aperture_diameter(self, m: float) -> None:
        self.aperture_radius = float(np.clip(
            self.aperture_radius + (self.aperture_radius + 0.01) * m,
            0.0, 25.0))

    def change_focal_distance(self, m: float) -> None:
        self.focal_distance = float(np.clip(self.focal_distance + m,
                                            0.2, 100.0))

    def set_fov_x(self, fovx: float) -> None:
        self.fov_x = fovx

    # ---- frame build ----
    def _direction_to_camera(self) -> np.ndarray:
        return np.array([
            math.sin(self.yaw) * math.cos(self.pitch),
            math.sin(self.pitch),
            math.cos(self.yaw) * math.cos(self.pitch),
        ], np.float32)

    def _view_direction(self) -> np.ndarray:
        return -self._direction_to_camera()

    def build_render_camera(self) -> Camera:
        w, h = self.resolution
        d = self._direction_to_camera()
        fovy = math.degrees(
            math.atan(math.tan(math.radians(self.fov_x) * 0.5) * (h / w))
            * 2.0)
        return Camera(
            position=self.center + d * self.radius,
            view=-d,
            up=np.array([0., 1., 0.], np.float32),
            resolution=(w, h),
            fov=np.array([self.fov_x, fovy], np.float32),
            aperture_radius=self.aperture_radius,
            focal_distance=self.focal_distance,
        )


# the reference viewer's keyboard map; the terminal shell (runtime/app.py)
# takes it one keypress per line
KEY_BINDINGS = {
    "a": lambda c: c.strafe(-0.05),
    "d": lambda c: c.strafe(0.05),
    "r": lambda c: c.change_altitude(0.05),
    "f": lambda c: c.change_altitude(-0.05),
    "w": lambda c: c.go_forward(0.05),
    "s": lambda c: c.go_forward(-0.05),
    "g": lambda c: c.change_aperture_diameter(0.1),
    "h": lambda c: c.change_aperture_diameter(-0.1),
    "t": lambda c: c.change_focal_distance(0.1),
    "y": lambda c: c.change_focal_distance(-0.1),
    "left": lambda c: c.change_yaw(0.02),
    "right": lambda c: c.change_yaw(-0.02),
    "up": lambda c: c.change_pitch(0.02),
    "down": lambda c: c.change_pitch(-0.02),
}
