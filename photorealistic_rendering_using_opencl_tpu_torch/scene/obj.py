"""Wavefront OBJ import and the procedural test mesh (host, numpy).

Port of ``photorealistic_rendering_using_opencl_tpu/scene/obj.py``: fan
triangulation, ``vn`` normals when every corner references one, otherwise
area-weighted smooth vertex normals.
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (verts[T,3,3], normals[T,3,3]) float32 triangle soup.

    Uses the native importer (runtime/native.py) when it builds, else the
    Python implementation; set PRT_NO_NATIVE=1 to force the latter.
    """
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import native
    res = native.load_obj_native(path)
    if res is not None:
        return res
    return load_obj_py(path)


def load_obj_py(path: str):
    """Pure-Python implementation of the OBJ importer."""
    positions: list[list[float]] = []
    vnormals: list[list[float]] = []
    faces: list[tuple] = []  # ((vi, ni), (vi, ni), (vi, ni))

    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                positions.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                vnormals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                refs = line.split()[1:]
                idx = []
                for r in refs:
                    comps = r.split("/")
                    vi = int(comps[0])
                    ni = int(comps[2]) if len(comps) >= 3 and comps[2] else 0
                    idx.append((vi, ni))
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    pos = np.asarray(positions, np.float32)
    vn = np.asarray(vnormals, np.float32) if vnormals else None
    nv = len(pos)

    def _resolve(i, n):
        return (i - 1) if i > 0 else (n + i)

    tri_v = np.empty((len(faces), 3, 3), np.float32)
    tri_vi = np.empty((len(faces), 3), np.int64)
    tri_ni = np.empty((len(faces), 3), np.int64)
    for f, face in enumerate(faces):
        for c in range(3):
            vi, ni = face[c]
            vi = _resolve(vi, nv)
            tri_v[f, c] = pos[vi]
            tri_vi[f, c] = vi
            tri_ni[f, c] = _resolve(ni, len(vnormals)) if ni else -1

    if vn is not None and np.all(tri_ni >= 0):
        tri_n = vn[tri_ni]
    else:
        # area-weighted smooth normals over shared positions
        e1 = tri_v[:, 1] - tri_v[:, 0]
        e2 = tri_v[:, 2] - tri_v[:, 0]
        fn = np.cross(e1, e2)
        acc = np.zeros((nv, 3), np.float64)
        for c in range(3):
            np.add.at(acc, tri_vi[:, c], fn)
        norm = np.linalg.norm(acc, axis=1, keepdims=True)
        acc = acc / np.maximum(norm, 1e-20)
        tri_n = acc[tri_vi].astype(np.float32)

    ln = np.linalg.norm(tri_n, axis=-1, keepdims=True)
    tri_n = (tri_n / np.maximum(ln, 1e-20)).astype(np.float32)
    return tri_v, tri_n


def make_icosphere(subdiv: int = 2, radius: float = 1.0,
                   center=(0.0, 0.0, 0.0)):
    """Procedural test mesh (keeps tests independent of external assets)."""
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
    for _ in range(subdiv):
        new_faces = []
        cache: dict = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        verts = np.asarray(vlist)

    verts = np.asarray(verts, np.float32)
    ctr = np.asarray(center, np.float32)
    f = np.asarray(faces, np.int64)
    tri_v = verts[f] * radius + ctr
    tri_n = verts[f]  # unit sphere normal == position
    return tri_v.astype(np.float32), tri_n.astype(np.float32)
