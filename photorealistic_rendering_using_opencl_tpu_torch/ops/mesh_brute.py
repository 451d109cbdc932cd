"""Exhaustive mesh intersection: the Moller-Trumbore coefficient table, its
plain PyTorch twin, the CUDA kernel K1 (``csrc/mesh_brute.cu``), and K1's
compute-only ablation T1 (``csrc/matmul_only.cu``) with the relevance pass
that feeds it.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py``.
With e1 = p0-p1, e2 = p2-p0, n = e1 x e2 and the ray feature
f = [o, d, d x o, 1], the four den-multiplied quantities

    den = n.d,  t*den = n.(p0-o),  u*den = (d x c).e2,  v*den = (d x c).e1

are linear in f, so ``pack_brute`` stores one [16, 4*Tpad] coefficient
table (pre-scaled by 1/|n|), grouped in tiles of TILE triangles with one
AABB ("cluster") per tile.  The hit test is a sign test on products with
den; only a winning pair pays the division.

``mesh_intersect`` dispatches on the device of its inputs: CPU tensors run
``_intersect_xla``, the plain twin of the reference's XLA path (a loop over
tiles, each one matrix product); CUDA tensors launch K1 or raise
(``uses_kernel`` says which).  Only the winning index leaves this module:
callers re-derive exact t/u/v from it (ops/intersect.py: tri_reattach).

``_block_relevance`` is the reference's XLA-side tile prune, which K1
folds into itself; here it feeds only T1 (``matmul_only``), the
microbenchmark's ablation that keeps K1's per-pair dot products and
drops everything else (tools/bench_kernel.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import EPS

TILE = 128  # triangles per tile (and per cluster AABB)
FEAT = 16  # ray feature width (10 used)
# the reference's resident-table cap; above it the loader asks for the ray
# sort (scene/loader.py: mesh_sort_rays)
BRUTE_MAX_TRIS = 32768
# the brute backend carries meshes up to this size; beyond it the loader
# packs only the BVH walk's tables (scene/loader.py)
BRUTE_STREAM_MAX_TRIS = 262144


class BrutePack(NamedTuple):
    """Host-packed tables (numpy)."""
    feat: np.ndarray  # [FEAT, 4*Tpad] coefficient table, tile-grouped cols
    clusters: np.ndarray  # [NT, 8] per-tile AABB: bmin(3) bmax(3) pad(2)
    tri_verts: np.ndarray  # [Tpad,3,3] vertices, same (compact) order
    tri_normals: np.ndarray  # [Tpad,3,3] vertex normals, same order


def pack_brute(tri_verts: np.ndarray, tri_normals: np.ndarray,
               tile: int = TILE) -> BrutePack:
    """Precompute the coefficient table from spatially sorted triangles.

    ``tri_verts`` must already be in BVH order so consecutive tiles are
    compact.  Padding slots get all-zero coefficients: den = t*den = 0 fails
    the strict t*den > EPS*den^2 test, so they never register a hit.
    """
    t = tri_verts.shape[0]
    tpad = max(-(-t // tile) * tile, tile)
    v = np.zeros((tpad, 3, 3), np.float32)
    v[:t] = tri_verts
    nrm = np.zeros((tpad, 3, 3), np.float32)
    nrm[:t] = tri_normals

    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = p0 - p1
    e2 = p2 - p0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    degen = nlen[:, 0] < 1e-20
    s = np.where(degen[:, None], 0.0, 1.0 / np.maximum(nlen, 1e-30))

    coef = np.zeros((4, tpad, FEAT), np.float32)
    coef[0, :, 3:6] = n * s  # den = n.d
    coef[1, :, 0:3] = -n * s  # t*den = -n.o + n.p0
    coef[1, :, 9] = np.sum(n * p0, axis=-1) * s[:, 0]
    coef[2, :, 3:6] = np.cross(p0, e2) * s  # u*den = d.(p0 x e2) - (d x o).e2
    coef[2, :, 6:9] = -e2 * s
    coef[3, :, 3:6] = np.cross(p0, e1) * s  # v*den = d.(p0 x e1) - (d x o).e1
    coef[3, :, 6:9] = -e1 * s

    # column layout per tile j: [den(C) | tden(C) | uden(C) | vden(C)]
    nt = tpad // tile
    feat = (coef.reshape(4, nt, tile, FEAT)
            .transpose(1, 0, 2, 3)
            .reshape(nt * 4 * tile, FEAT)
            .T.copy())

    clusters = np.zeros((nt, 8), np.float32)
    vt = v.reshape(nt, tile, 3, 3)
    live = ~degen.reshape(nt, tile)
    big = np.float32(3e38)
    lo = np.where(live[..., None, None], vt, big).min(axis=(1, 2))
    hi = np.where(live[..., None, None], vt, -big).max(axis=(1, 2))
    empty = ~live.any(axis=1)
    clusters[:, 0:3] = np.where(empty[:, None], big, lo)
    clusters[:, 3:6] = np.where(empty[:, None], -big, hi)
    return BrutePack(feat, clusters, v, nrm)


# ---------------------------------------------------------------------------
# Plain PyTorch twin (the reference's XLA path)
# ---------------------------------------------------------------------------

def _tile_scores(f, a_tile, c):
    """f [B,FEAT] x a_tile [FEAT,4C] -> per-pair t (inf when no hit)."""
    out = torch.matmul(f, a_tile)
    den = out[:, 0 * c:1 * c]
    tden = out[:, 1 * c:2 * c]
    uden = out[:, 2 * c:3 * c]
    vden = out[:, 3 * c:4 * c]
    den2 = den * den
    m = torch.minimum(torch.minimum(uden * den, vden * den),
                      (den - uden - vden) * den)
    td = tden * den
    hit = (m >= 0.0) & (td > EPS * den2)
    return torch.where(hit, td / den2, torch.inf)


def _ray_features(origin, direction):
    o0, o1, o2 = origin[:, 0:1], origin[:, 1:2], origin[:, 2:3]
    d0, d1, d2 = direction[:, 0:1], direction[:, 1:2], direction[:, 2:3]
    dxo = torch.cat([d1 * o2 - d2 * o1,
                     d2 * o0 - d0 * o2,
                     d0 * o1 - d1 * o0], dim=1)
    ones = torch.ones_like(o0)
    zeros = torch.zeros(origin.shape[:-1] + (FEAT - 10,), dtype=torch.float32,
                        device=origin.device)
    return torch.cat([origin, direction, dxo, ones, zeros], dim=1)


def _intersect_xla(feat, clusters, origin, direction, t_init, active,
                   exclude=None):
    """Closest hit for every lane (any-hit lanes included: the closest hit
    subsumes occlusion), scanning every tile: strict ``<`` across tiles,
    the lowest index on ties within one."""
    n = origin.shape[0]
    c = TILE
    nt = feat.shape[1] // (4 * c)
    f = _ray_features(origin, direction)
    tiles = feat.T.reshape(nt, 4 * c, FEAT).transpose(1, 2)
    t_init = torch.broadcast_to(torch.as_tensor(t_init, dtype=torch.float32,
                                                device=origin.device), (n,))
    best_t = t_init.clone()
    best_i = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    ids0 = torch.arange(c, dtype=torch.int32, device=origin.device)
    for j in range(nt):
        off = j * c
        score = _tile_scores(f, tiles[j], c)
        if exclude is not None:
            score = torch.where((ids0 + off)[None, :] == exclude[:, None],
                                torch.inf, score)
        tmin, targ = torch.min(score, dim=1)
        targ = targ.to(torch.int32) + off
        better = tmin < best_t
        best_t = torch.where(better, tmin, best_t)
        best_i = torch.where(better, targ, best_i)
    got = best_i >= 0
    if active is not None:
        got = got & active
    return torch.where(got, best_t, t_init), torch.where(got, best_i, -1)


# ---------------------------------------------------------------------------
# CUDA kernel K1
# ---------------------------------------------------------------------------

K1_COUNTERS = 5  # the kernel's work counts, see _MeshBruteKernel


class _MeshBruteKernel:
    """Wrapper of ``prt_mesh_brute`` (csrc/mesh_brute.cu).  ``launches``
    counts kernel launches and nothing else.  ``counters``, an int64 [5]
    tensor on the card, receives the launch's work counts ((warp, tile)
    pairs a warp processed, (ray, tile) pairs whose ray needed the tile's
    triangles, (ray, tile) slab tests, and the (warp, tile) and (ray, tile)
    pairs of the first two run in per-thread mode); the render path passes
    none."""

    def __init__(self):
        self.launches = 0

    def __call__(self, feat, clusters, origin, direction, t_init, active,
                 any_hit, exclude, counters=None):
        dev = origin.device
        n = origin.shape[0]
        nt = clusters.shape[0]
        if feat.shape[1] != 4 * TILE * nt:
            raise ValueError(f"feat {tuple(feat.shape)} does not match "
                             f"{nt} clusters of {TILE} triangles")
        _cuda.require(feat, "feat", torch.float32, (FEAT, 4 * TILE * nt), dev)
        _cuda.require(clusters, "clusters", torch.float32, (nt, 8), dev)
        _cuda.require(origin, "origin", torch.float32, (n, 3), dev)
        _cuda.require(direction, "direction", torch.float32, (n, 3), dev)
        _cuda.require(t_init, "t_init", torch.float32, (n,), dev)
        _cuda.require(active, "active", torch.bool, (n,), dev)
        _cuda.require(any_hit, "any_hit", torch.bool, (n,), dev)
        _cuda.require(exclude, "exclude", torch.int32, (n,), dev)
        if counters is not None:
            _cuda.require(counters, "counters", torch.int64, (K1_COUNTERS,),
                          dev)
        out_t = torch.empty((n,), dtype=torch.float32, device=dev)
        out_tri = torch.empty((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return out_t, out_tri
        lib = _cuda.LIBRARY.get()
        with _cuda.on_device(origin):
            code = lib.prt_mesh_brute(
                feat.data_ptr(), feat.stride(0), nt, clusters.data_ptr(),
                origin.data_ptr(), direction.data_ptr(), t_init.data_ptr(),
                active.data_ptr(), any_hit.data_ptr(), exclude.data_ptr(), n,
                out_t.data_ptr(), out_tri.data_ptr(),
                None if counters is None else counters.data_ptr(),
                _cuda.stream_handle(origin))
        _cuda.check(code, "prt_mesh_brute")
        self.launches += 1
        return out_t, out_tri


mesh_brute_kernel = _MeshBruteKernel()


def uses_kernel(x: torch.Tensor) -> bool:
    """True when ``mesh_intersect`` launches K1 for tensors on ``x``'s
    device; callers gate what only the kernel needs (the ray sort of
    ``intersect.mesh_closest``) on it, as the reference gates its on
    ``uses_pallas()``.  The twin on the CPU scans every tile per lane, so
    lane order cannot change its work."""
    return x.device.type == "cuda"


def _lane_tensor(x, n, dtype, device, default):
    if x is None:
        x = default
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(device=device, dtype=dtype),
                                  (n,)).contiguous()
    return torch.full((n,), x, dtype=dtype, device=device)


def mesh_intersect(feat, clusters, origin, direction, t_init, active=None,
                   any_hit=False, exclude=None):
    """Closest mesh hit by exhaustive testing.

    Returns (t [N], tri [N] int32 index into the compact bf arrays, -1 on
    miss); t falls back to t_init when no triangle beats it.  ``any_hit``
    may be a bool or a per-lane [N] bool tensor: for any-hit lanes only
    tri >= 0 (occluded) is meaningful (the kernel stops them at their first
    occluding tile and returns t_init).  Detached.  CPU tensors run the
    plain twin; CUDA tensors launch K1, with no fallback.
    """
    origin = origin.detach()
    direction = direction.detach()
    if isinstance(t_init, torch.Tensor):
        t_init = t_init.detach()
    if origin.device.type == "cpu":
        return _intersect_xla(feat, clusters, origin, direction, t_init,
                              active, exclude=exclude)
    if origin.device.type != "cuda":
        raise ValueError(f"mesh_intersect: unsupported device {origin.device}")
    n = origin.shape[0]
    dev = origin.device
    return mesh_brute_kernel(
        feat.contiguous(), clusters.contiguous(), origin.contiguous(),
        direction.contiguous(),
        _lane_tensor(t_init, n, torch.float32, dev, None),
        _lane_tensor(active, n, torch.bool, dev, True),
        _lane_tensor(any_hit, n, torch.bool, dev, False),
        _lane_tensor(exclude, n, torch.int32, dev, -1))


# ---------------------------------------------------------------------------
# T1: the compute-only ablation of K1, and the relevance pass that feeds it
# ---------------------------------------------------------------------------

def _block_relevance(clusters, origin, direction, t_init, act, nblocks,
                     block, pad=0):
    """[nblocks, ceil(nt/32)] relevance words: bit j of block b is set when
    some active ray of the block's ``block`` rays enters tile j's AABB
    closer than its t_init.  A plain port of the reference's vectorised
    slab test; the words are int32 holding the reference's uint32 bits.
    ``pad`` appends that many inactive rays to fill the last block."""
    n, nt = origin.shape[0], clusters.shape[0]
    dev = origin.device
    safe = torch.where(direction.abs() < 1e-12,
                       torch.where(direction >= 0.0, 1e-12, -1e-12),
                       direction)
    inv_d = 1.0 / safe
    t_init = torch.broadcast_to(torch.as_tensor(t_init, dtype=torch.float32,
                                                device=dev), (n,))
    # axis at a time, so intermediates stay [N, nt]
    ent = torch.full((n, nt), EPS, dtype=torch.float32, device=dev)
    ext = torch.full((n, nt), torch.inf, dtype=torch.float32, device=dev)
    for k in range(3):
        lo = (clusters[None, :, k] - origin[:, k:k + 1]) * inv_d[:, k:k + 1]
        hi = (clusters[None, :, 3 + k] - origin[:, k:k + 1]) * inv_d[:, k:k + 1]
        ent = torch.maximum(ent, torch.minimum(lo, hi))
        ext = torch.minimum(ext, torch.maximum(lo, hi))
    rel = (ent <= torch.minimum(ext, t_init[:, None])) & act[:, None]
    if pad:
        rel = torch.cat([rel, torch.zeros((pad, nt), dtype=torch.bool,
                                          device=dev)])
    rel = rel.reshape(nblocks, block, nt).any(dim=1)
    nwords = -(-nt // 32)
    rel = torch.cat([rel, torch.zeros((nblocks, nwords * 32 - nt),
                                      dtype=torch.bool, device=dev)], dim=1)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    words = (rel.reshape(nblocks, nwords, 32).to(torch.int64)
             << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def relevance_words(clusters, origin, direction, t_init, active, block):
    """``_block_relevance`` over ceil(N / block) blocks, the last one padded
    with inactive rays -> [nblocks, ceil(nt/32)] int32."""
    n = origin.shape[0]
    nblocks = -(-n // block)
    return _block_relevance(clusters, origin, direction, t_init, active,
                            nblocks, block, pad=nblocks * block - n)


# rays a chunk of ray_cluster_count: its [chunk, nt, 3] temporaries are
# 12 * chunk * nt bytes each (94 MB at cornell_hi's 640 tiles)
CLUSTER_COUNT_CHUNK = 32768


def ray_cluster_count(clusters, origin, direction, t_init):
    """Per-ray count of tiles whose AABB the ray enters closer than
    ``t_init`` -> [N] int32: the brute backend's traversal-cost metric for
    the debug AOV (the reference's VIEW_STACK_INDEX analogue).  The
    reference's broadcast, with its order of operations (so the counts are
    bitwise), over CLUSTER_COUNT_CHUNK rays at a time: at 1024^2 rays on
    cornell_hi one [N, nt, 3] temporary would take 7.5 GB."""
    n = origin.shape[0]
    chunk = CLUSTER_COUNT_CHUNK
    t_init = torch.broadcast_to(torch.as_tensor(
        t_init, dtype=torch.float32, device=origin.device), (n,))
    out = []
    for s in range(0, n, chunk):
        o, d = origin[s:s + chunk], direction[s:s + chunk]
        safe = torch.where(d.abs() < 1e-12,
                           torch.where(d >= 0.0, 1e-12, -1e-12), d)
        inv_d = 1.0 / safe
        lo = (clusters[None, :, 0:3] - o[:, None, :]) * inv_d[:, None, :]
        hi = (clusters[None, :, 3:6] - o[:, None, :]) * inv_d[:, None, :]
        ent = torch.clamp(torch.amax(torch.minimum(lo, hi), dim=-1), min=EPS)
        ext = torch.amin(torch.maximum(lo, hi), dim=-1)
        rel = ent <= torch.minimum(ext, t_init[s:s + chunk, None])
        out.append(rel.sum(dim=-1, dtype=torch.int32))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=origin.device)
    return torch.cat(out)


def matmul_only_pack(origin, direction, t_init):
    """The reference tool's transposed ray pack [FEAT, N]: the ray features
    [o, d, d x o, 1] with t_init and the active flag (1) in rows 10 and 11;
    rows 10-15 meet all-zero coefficient rows."""
    p = _ray_features(origin, direction).T.contiguous()
    p[10] = torch.broadcast_to(torch.as_tensor(t_init, dtype=torch.float32,
                                               device=origin.device),
                               p[10].shape)
    p[11] = 1.0
    return p


def matmul_only_plain(words, pack, feat, block):
    """T1's plain version: for each ray, the masked per-tile sum over the
    tiles whose bit is set for its block of the column sums of
    ``A_tile^T . p`` -> (t [N] f32, i [N] int32 zeros)."""
    n = pack.shape[1]
    nt = feat.shape[1] // (4 * TILE)
    w = words.reshape(-1, -(-nt // 32)).to(torch.int64) & 0xFFFFFFFF
    ray_block = torch.arange(n, device=pack.device) // block
    pt = pack.T
    t = torch.zeros((n,), dtype=torch.float32, device=pack.device)
    for j in range(nt):
        bit = ((w[:, j // 32] >> (j % 32)) & 1).bool()[ray_block]
        s = torch.matmul(pt, feat[:, j * 4 * TILE:(j + 1) * 4 * TILE]).sum(1)
        t = torch.where(bit, t + s, t)
    return t, torch.zeros((n,), dtype=torch.int32, device=pack.device)


class _MatmulOnlyKernel:
    """Wrapper of ``prt_matmul_only`` (csrc/matmul_only.cu).  ``launches``
    counts kernel launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, words, pack, feat, block):
        dev = pack.device
        n = pack.shape[1]
        nt = feat.shape[1] // (4 * TILE)
        nwords = -(-nt // 32)
        if block not in (128, 256):
            raise ValueError(f"block {block}: the kernel takes 128 or 256")
        if feat.shape[1] != 4 * TILE * nt:
            raise ValueError(f"feat {tuple(feat.shape)} is not whole tiles")
        _cuda.require(words, "words", torch.int32, (-(-n // block), nwords),
                      dev)
        _cuda.require(pack, "pack", torch.float32, (FEAT, n), dev)
        _cuda.require(feat, "feat", torch.float32, (FEAT, 4 * TILE * nt), dev)
        if feat.data_ptr() % 16:
            raise ValueError("feat: the kernel copies it in 16-byte pieces; "
                             "its data must start on a 16-byte boundary")
        out_t = torch.empty((n,), dtype=torch.float32, device=dev)
        out_i = torch.empty((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return out_t, out_i
        lib = _cuda.LIBRARY.get()
        with _cuda.on_device(pack):
            code = lib.prt_matmul_only(
                words.data_ptr(), nwords, pack.data_ptr(), feat.data_ptr(),
                feat.stride(0), nt, n, block, out_t.data_ptr(),
                out_i.data_ptr(), _cuda.stream_handle(pack))
        _cuda.check(code, "prt_matmul_only")
        self.launches += 1
        return out_t, out_i


matmul_only_kernel = _MatmulOnlyKernel()


def matmul_only(words, pack, feat, block):
    """T1 -> (t [N], i [N] zeros): ``matmul_only_plain`` for CPU tensors,
    the kernel for CUDA tensors (no fallback).  ``words`` from
    ``relevance_words`` at the same ``block``."""
    if pack.device.type == "cpu":
        return matmul_only_plain(words, pack, feat, block)
    if pack.device.type != "cuda":
        raise ValueError(f"matmul_only: unsupported device {pack.device}")
    return matmul_only_kernel(words.contiguous(), pack.contiguous(),
                              feat.contiguous(), block)
