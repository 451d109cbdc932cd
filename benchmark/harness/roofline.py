"""Published peaks of one NVIDIA H100 and the byte counts of the kernels
whose share of their roofline the benchmark reports.

The peaks are NVIDIA's data sheet for the SXM part, dense rates without
sparsity, at its full power limit of 700 W (``nvidia-smi``'s power.limit
is reported beside every share).
"""
from __future__ import annotations

H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12  # outside the tensor cores

F32 = 4
TRIANGLE_BYTES = 9 * F32  # three vertices
# a ray's inputs: origin, direction, t limit (floats), any-hit and active
# flags (a byte each); its hit: t, triangle, u, v (four words)
W1_RAY_IN_BYTES = 7 * F32 + 2
W1_HIT_OUT_BYTES = 4 * F32


def w1_bytes(n_triangles: int, launches: int, rays: int) -> int:
    """The least bytes the BVH walk moves: per launch the scene's triangles
    read once; per ray its inputs read once and its hit written once.  The
    count reads the scene and the rays, not the walk's node tables, so a
    change of the BVH's layout does not move it."""
    return (launches * n_triangles * TRIANGLE_BYTES
            + rays * (W1_RAY_IN_BYTES + W1_HIT_OUT_BYTES))


def least_seconds(n_bytes: float, flops: float = 0.0,
                  flop_per_s: float = H100_FP32_FLOP_PER_S) -> float:
    """The larger of bytes over the HBM rate and operations over the
    compute rate."""
    return max(n_bytes / H100_HBM_BYTES_PER_S, flops / flop_per_s)
