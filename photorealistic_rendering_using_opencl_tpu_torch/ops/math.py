"""Vector math + orthonormal bases, batched over leading axes.

Port of the helpers of ``photorealistic_rendering_using_opencl_tpu/ops/math.py``
that the render path uses, forward and backward.  The last axis is the
3-vector; the operation order follows the reference so results agree to
rounding.
"""
from __future__ import annotations

import math

import torch

EPS = 1e-5
# the reference clamps rays at INF = 2e1 (a 20-unit world)
RAY_INF = 2e1

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)
INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def dot3(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def normalize(a: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return a * torch.reciprocal(torch.sqrt(torch.clamp(dot3(a, a), min=eps)))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt clamped at zero (double-where form, NaN-free under autograd)."""
    neg = x <= 0.0
    return torch.where(neg, 0.0, torch.sqrt(torch.where(neg, 1.0, x)))


def fmax3(v: torch.Tensor) -> torch.Tensor:
    """Max component over the last axis."""
    return torch.amax(v, dim=-1)


def avg3(v: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis."""
    return torch.mean(v, dim=-1)


def sgn_e(x: torch.Tensor) -> torch.Tensor:
    """Signum excluding zero: sgn_e(0) = +1."""
    return torch.where(x < 0.0, -1.0, 1.0)


def copysign(mag: float, x: torch.Tensor) -> torch.Tensor:
    """``jnp.copysign(mag, x)`` for a scalar magnitude."""
    return torch.copysign(torch.full_like(x, mag), x)


# ---------------------------------------------------------------------------
# Tangent frames: branchless ONB [Duff et al. 2017]
# ---------------------------------------------------------------------------

def tangent_frame(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (tangent, bitangent) for unit normal(s) n[..., 3]."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sn = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sn + nz)
    b = nx * ny * a
    tangent = torch.stack([1.0 + sn * nx * nx * a, sn * b, -sn * nx], dim=-1)
    bitangent = torch.stack([b, sn + ny * ny * a, -ny], dim=-1)
    return tangent, bitangent


def to_local(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """World -> tangent space where n is the local +z."""
    t, bt = tangent_frame(n)
    return torch.stack([dot(t, v), dot(bt, v), dot(n, v)], dim=-1)


def to_global(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Tangent -> world."""
    t, bt = tangent_frame(n)
    return t * v[..., 0:1] + bt * v[..., 1:2] + n * v[..., 2:3]


def reflect_local(wi: torch.Tensor) -> torch.Tensor:
    """Mirror about local +z: (-x, -y, z)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


class _FetchFloatRows(torch.autograd.Function):
    """``table[idx]`` whose backward is one one-hot product (see
    ``fetch_float_rows``)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.k = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        onehot = (idx[:, None] == torch.arange(ctx.k, dtype=idx.dtype,
                                               device=idx.device)[None, :])
        return torch.matmul(onehot.to(g.dtype).T, g), None


def fetch_float_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` ([K,F] by [N] -> [N,F]) with a deterministic backward.

    Port of the reference's ``fetch_float_rows`` (ops/math.py): the VJP of
    a row fetch is a segment sum of the [N,F] cotangent into the [K,F]
    table, computed here as ONE one-hot [K,N] x [N,F] product in float32.
    Plain indexing's backward would be ``index_put_(accumulate=True)``:
    atomic adds from every lane into a handful of rows, contended on the
    card and summed in an order that changes from run to run.  The product
    runs through ``torch.matmul``, whose float32 products stay out of TF32
    under PyTorch's default (``torch.backends.cuda.matmul.allow_tf32``
    False; ``chip_smoke.py`` pins it), so the sum is float32-exact per
    term, as the reference's HIGHEST-precision product is.
    """
    return _FetchFloatRows.apply(table, idx.long())


def power_heuristic(pdf0: torch.Tensor, pdf1: torch.Tensor) -> torch.Tensor:
    """Power heuristic beta=2 with the reference's overflow guard: both pdfs
    are scaled by a common detached factor bringing the larger to 1e12
    (exactly 1.0 for pdfs <= 1e12), and a ~0 denominator gives 0."""
    m = torch.maximum(pdf0, pdf1).detach()
    big = m > 1e12
    s = torch.where(big, 1e12 / torch.where(big, m, 1.0), 1.0)
    pdf0 = pdf0 * s
    pdf1 = pdf1 * s
    p0 = pdf0 * pdf0
    denom = p0 + pdf1 * pdf1
    tiny = denom < 1e-12
    return torch.where(tiny, 0.0, p0 / torch.where(tiny, 1.0, denom))
