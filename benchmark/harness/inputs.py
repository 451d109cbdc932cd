"""What the benchmark makes itself and hands alike to the program and the
reference: the mesh, the sky map, the camera, the fitted leaves' start.

The recipes are copies, so that no later change of the program moves
them: the icosphere of ``scene/obj.make_icosphere`` (the same vertices as
``scenes/assets/icosphere_hi.obj`` at subdivision 6, radius 1.2, centre
(0, -0.8, 0)), the sky of ``chip_smoke.seeded_env_map``, and the orbit
camera of ``runtime/camera.InteractiveCamera`` and
``ops/camera_rays.default_camera``.
"""
from __future__ import annotations

import math

import numpy as np

MASK32 = 0xFFFFFFFF


def icosphere(subdiv: int, radius: float, center) -> tuple:
    """(verts [T,3,3], normals [T,3,3]) float32: an icosahedron split
    ``subdiv`` times, each face into four in order, vertices on the sphere;
    the normals are the unit positions."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
    ], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    vlist = list(verts)
    for _ in range(subdiv):
        cache: dict = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
    unit = np.asarray(vlist, np.float32)
    f = np.asarray(faces, np.int64)
    tri_v = unit[f] * np.float32(radius) + np.asarray(center, np.float32)
    return tri_v.astype(np.float32), unit[f].astype(np.float32)


def sky(height: int, width: int, seed: int) -> np.ndarray:
    """An equirect HDR sky [H,W,3] float32 from the seed: a smooth
    gradient, noise, and a small bright sun."""
    rng = np.random.default_rng(seed)
    v = (np.arange(height, dtype=np.float32) + 0.5)[:, None] / height
    u = (np.arange(width, dtype=np.float32) + 0.5)[None, :] / width
    s = np.stack([0.4 + 0.3 * (1 - v) + 0 * u, 0.5 + 0.3 * (1 - v) + 0 * u,
                  0.9 - 0.2 * v + 0 * u], axis=-1)
    s = s * (0.8 + 0.4 * rng.random((height, width, 1)))
    sy, sx = int(0.22 * height), int(0.3 * width)
    s[sy - 4:sy + 4, sx - 8:sx + 8] = 200.0
    return s.astype(np.float32)


def orbit_camera(spec: dict, width: int, height: int) -> dict:
    """The orbit camera's leaves (position, view, up, fov, aperture_radius,
    focal_distance) as float32 numpy arrays."""
    yaw = float(spec.get("yaw", 0.0))
    pitch = float(spec.get("pitch", 0.3))
    radius = float(spec.get("radius", 4.0))
    fov_x = float(spec.get("fov_x", 45.0))
    center = np.asarray(spec.get("center", [0.0, 0.0, 0.0]), np.float32)
    d = np.array([math.sin(yaw) * math.cos(pitch), math.sin(pitch),
                  math.cos(yaw) * math.cos(pitch)], np.float32)
    fovy = math.degrees(math.atan(math.tan(math.radians(fov_x) * 0.5)
                                  * (height / width)) * 2.0)
    return {
        "position": (center + d * np.float32(radius)).astype(np.float32),
        "view": (-d).astype(np.float32),
        "up": np.array([0.0, 1.0, 0.0], np.float32),
        "fov": np.array([fov_x, fovy], np.float32),
        "aperture_radius": np.array(spec.get("aperture_radius", 0.01),
                                    np.float32),
        "focal_distance": np.array(spec.get("focal_distance", 4.0),
                                   np.float32),
    }


def mix(seed: int, *salt: int) -> int:
    """A uint32 from a seed of any size and salts (splitmix64's finaliser),
    so that step and pass seeds of nearby run seeds share nothing."""
    x = (int(seed) * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    for s in salt:
        x = (x ^ (int(s) + 0x632BE59BD9B4E019)) & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & 0xFFFFFFFFFFFFFFFF
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & 0xFFFFFFFFFFFFFFFF
        x ^= x >> 31
    return x & MASK32


def build(config: dict, seed: int, width: int, height: int) -> dict:
    """A configuration's inputs for one run: the scene document, the mesh,
    the sky (its noise from the run's seed) and the camera's leaves."""
    mesh = config.get("mesh")
    env = config.get("env_map")
    return {
        "doc": config["scene"],
        "mesh": None if mesh is None else icosphere(**mesh["icosphere"]),
        "env": None if env is None else sky(env["height"], env["width"],
                                            mix(seed, 7)),
        "camera": orbit_camera(config.get("camera", {}), width, height),
    }
