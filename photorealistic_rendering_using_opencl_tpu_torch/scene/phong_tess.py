"""Phong tessellation: curved-triangle evaluation + conservative AABBs.

Port of ``photorealistic_rendering_using_opencl_tpu/scene/phong_tess.py``
(the reference's dormant Phong tessellation; nothing in the renderer calls
it).  The surface point blends the barycentric point with its projections
onto the three vertex tangent planes [Boubekeur & Alexa 2008];
``tessellated_aabb`` inflates triangle bounds so a BVH over curved patches
stays conservative.  Batched over leading axes; alpha = 0 is the flat
triangle.
"""
from __future__ import annotations

import torch


def _project_on_plane(q, p, n):
    d = (q - p) * n
    return q - ((d[..., 0] + d[..., 1]) + d[..., 2])[..., None] * n


def phong_tessellate(p1, p2, p3, n1, n2, n3, alpha, u, v):
    """Curved-surface point at barycentric (u, v, w=1-u-v); p*/n* are
    [...,3], u/v broadcast."""
    u = torch.as_tensor(u, dtype=torch.float32, device=p1.device)[..., None]
    v = torch.as_tensor(v, dtype=torch.float32, device=p1.device)[..., None]
    w = 1.0 - u - v
    p_bary = p1 * u + p2 * v + p3 * w
    p_t = (u * _project_on_plane(p_bary, p1, n1)
           + v * _project_on_plane(p_bary, p2, n2)
           + w * _project_on_plane(p_bary, p3, n3))
    return (1.0 - alpha) * p_bary + alpha * p_t


_SAMPLE_UV = (
    (0.0, 0.5), (0.5, 0.0), (0.5, 0.5), (0.25, 0.75), (0.75, 0.25),
    (0.25, 0.0), (0.75, 0.0), (0.0, 0.25), (0.0, 0.75),
    (1.0 / 3.0, 1.0 / 3.0),
)


def tessellated_aabb(p1, p2, p3, n1, n2, n3, alpha):
    """Conservative bounds of each curved patch from its vertices, nine
    edge and side samples and the centroid -> (bmin, bmax) [...,3]."""
    pts = [p1, p2, p3]
    for u, v in _SAMPLE_UV:
        pts.append(phong_tessellate(p1, p2, p3, n1, n2, n3, alpha, u, v))
    stack = torch.stack(pts, dim=0)
    return torch.amin(stack, dim=0), torch.amax(stack, dim=0)
