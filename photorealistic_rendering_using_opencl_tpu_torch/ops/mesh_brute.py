"""Exhaustive mesh intersection: the Moller-Trumbore coefficient table, its
plain PyTorch twin, the CUDA kernel K1 (``csrc/mesh_brute.cu``), the
tensor-core kernel of the reduced-precision forms (``csrc/mesh_brute_tc.cu``)
with its plain version, and K1's compute-only ablation T1
(``csrc/matmul_only.cu``) with the relevance pass that feeds it.

Port of ``photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py``.
With e1 = p0-p1, e2 = p2-p0, n = e1 x e2 and the ray feature
f = [o, d, d x o, 1], the four den-multiplied quantities

    den = n.d,  t*den = n.(p0-o),  u*den = (d x c).e2,  v*den = (d x c).e1

are linear in f, so ``pack_brute`` stores one [16, 4*Tpad] coefficient
table (pre-scaled by 1/|n|), grouped in tiles of TILE triangles with one
AABB ("cluster") per tile.  The hit test is a sign test on products with
den; only a winning pair pays the division.

Sizes.  ``PRT_MESH_TILE`` (TILE, triangles a tile, default 128) and
``PRT_MESH_BLOCK`` (RELEVANCE_BLOCK, rays a relevance block, default 256)
are read once, at import, as the reference reads its TILE and BLOCK.  The
loader packs its tables at TILE; everything that takes a table reads the
table's own tile from it (``table_tile``: columns over 4 x clusters), so
tables of several tile sizes can live in one process.  The relevance block
is a keyword of the functions that prune by blocks, RELEVANCE_BLOCK when
not given.  The plain versions take any positive size; the kernels are
built for the sizes of KERNEL_TILES and KERNEL_BLOCKS (the reference's
round-5 sweep) and raise ``ValueError`` naming the switch for any other.

Arithmetic forms.  The reference's TPU kernel has three: f32 operands at
MATMUL_PRECISION, the stacked-K hi/lo split (each operand cut into bf16
parts by ``hi_lo_parts``, the ``FORM_TERMS`` pairs of parts stacked along
the contracted dimension, one dot), and a bf16 coefficient table (the
loader's ``PRT_MESH_DTYPE=bf16``).  ``PRT_MESH_PRECISION`` is read once, at
import, into ``_PRECISION_NAME``; an unknown name raises, as the
reference's dict lookup does.  ``PRT_MESH_NOREL`` and
``PRT_MESH_FORCE_XLA`` are read at each call.  What each switch means:

    switch          reference, TPU    reference, CPU   port, CPU  port, card
    PRECISION unset bf16x6            XLA, f32         XLA, f32   K1 (FFMA)
    highest         f32 passes        f32              f32        K1
    bf16x6, bf16x3  split, T = 6 / 3  f32 (interpret:  f32        tensor-core
                                      the split)                  kernel, the
                                                                  split
    default         one bf16 pass     f32              f32        tensor-core,
                                                                  "bf16" on the
                                                                  f32 table
    DTYPE=bf16      bf16 table, no    bf16 table, f    as the     tensor-core,
                    split (any name)  cast to bf16     reference  "bf16"

The unset default is the one place where the port's name differs from the
reference's: the reference calls its f32-exact split "bf16x6" and runs it
off the TPU as XLA's f32 dot; the port's default is "highest", and on the
card that is K1, bitwise what it was before the forms were ported.

``mesh_intersect`` dispatches on the device of its inputs: CPU tensors run
``_intersect_xla``, the plain twin of the reference's XLA path (a loop over
tiles, each one matrix product); CUDA tensors launch K1 or the tensor-core
kernel (by the table above) or raise.  ``PRT_MESH_FORCE_XLA`` runs
``_intersect_xla`` on the card too, and ``uses_kernel`` is then False, as
the reference's ``uses_pallas`` is: the ray sort and the second pass of
``intersect.mesh_closest`` are off.  ``PRT_MESH_NOREL`` makes both kernels
test every tile for every live lane (the reference's all-ones relevance);
it changes nothing on the CPU.  Only the winning index leaves this module:
callers re-derive exact t/u/v from it (ops/intersect.py: tri_reattach).

``intersect_reduced_plain`` is the tensor-core kernel's plain version:
what the reference's TPU kernel computes in a form, down to its tile
prune.  In a reduced form the prune is part of the result (a false hit
may lie outside its tile's box), so both follow the reference's
``_block_relevance``: blocks of RELEVANCE_BLOCK rays in lane order,
unpadded boxes, each lane's t_init.  The CPU path of ``mesh_intersect``
does not use it.

``_block_relevance`` is the reference's XLA-side tile prune, which K1
folds into itself; here it feeds T1 (``matmul_only``), the
microbenchmark's ablation that keeps K1's per-pair dot products and
drops everything else (tools/bench_kernel.py), and the plain version of
the tensor-core kernel.
"""
from __future__ import annotations

import os
import weakref
from typing import NamedTuple

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import EPS

# triangles per tile (and per cluster AABB) of the tables the loader packs
TILE = int(os.environ.get("PRT_MESH_TILE", "128"))
FEAT = 16  # ray feature width (10 used)
# the reference's resident-table cap; above it the loader asks for the ray
# sort (scene/loader.py: mesh_sort_rays)
BRUTE_MAX_TRIS = 32768
# the brute backend carries meshes up to this size; beyond it the loader
# packs only the BVH walk's tables (scene/loader.py)
BRUTE_STREAM_MAX_TRIS = 262144
# rays a relevance block of the reference's TPU kernel (its BLOCK): the
# tensor-core kernel and its plain version prune tiles by blocks of these
RELEVANCE_BLOCK = int(os.environ.get("PRT_MESH_BLOCK", "256"))
# the tiles K1, the tensor-core kernel and T1 are built for, and the
# relevance blocks of the tensor-core kernel (csrc/*.cu instantiate each)
KERNEL_TILES = (128, 256, 512)
KERNEL_BLOCKS = (128, 256, 512)

# the reference's PRT_MESH_PRECISION names, each with the tensor-core
# kernel's form on the card (None: K1); see the module docstring
_CARD_FORMS = {"default": "bf16", "bf16x3": "bf16x3", "bf16x6": "bf16x6",
               "highest": None}
_PRECISION_NAME = os.environ.get("PRT_MESH_PRECISION", "highest")
if _PRECISION_NAME not in _CARD_FORMS:
    raise KeyError(_PRECISION_NAME)
# each reduced form's terms, (table part, ray part) pairs adding a_i . p_j
# to the one dot: "bf16" is one pass of both operands in bf16; the split
# forms are the reference's _SPLIT_TERMS (bf16x3 drops the ~2^-16-relative
# terms, bf16x6 keeps every term above ~2^-24)
FORM_TERMS = {
    "bf16": ((0, 0),),
    "bf16x3": ((0, 0), (1, 0), (0, 1)),
    "bf16x6": ((0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (0, 2)),
}
# the tensor-core kernel's form codes (csrc/mesh_brute_tc.cu)
_FORM_CODES = {"bf16": 0, "bf16x3": 1, "bf16x6": 2}
# columns of the ray pack (the reference's ROW_TINIT .. ROW_EXCLUDE rows)
# that carry per-lane control values; the table's rows 10-15 are zero
_PACK_TINIT, _PACK_ACTIVE, _PACK_ANYHIT, _PACK_EXCLUDE = 10, 11, 12, 13


class BrutePack(NamedTuple):
    """Host-packed tables (numpy)."""
    feat: np.ndarray  # [FEAT, 4*Tpad] coefficient table, tile-grouped cols
    clusters: np.ndarray  # [NT, 8] per-tile AABB: bmin(3) bmax(3) pad(2)
    tri_verts: np.ndarray  # [Tpad,3,3] vertices, same (compact) order
    tri_normals: np.ndarray  # [Tpad,3,3] vertex normals, same order


def table_tile(feat, clusters) -> int:
    """The tile of a packed table: its 4 x tile columns a cluster."""
    return feat.shape[1] // (4 * clusters.shape[0])


def kernel_tile(tile: int) -> int:
    """``tile`` when the kernels have an instance for it, else ValueError."""
    if tile not in KERNEL_TILES:
        raise ValueError(f"tile of {tile} triangles: the mesh kernels are "
                         f"built for PRT_MESH_TILE in {KERNEL_TILES}")
    return tile


def kernel_block(block: int) -> int:
    """``block`` when the tensor-core kernel has an instance for it, else
    ValueError."""
    if block not in KERNEL_BLOCKS:
        raise ValueError(f"relevance block of {block} rays: the tensor-core "
                         f"kernel is built for PRT_MESH_BLOCK in "
                         f"{KERNEL_BLOCKS}")
    return block


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
    """f [B,FEAT] x a_tile [FEAT,4C] -> per-pair t (inf when no hit).  A
    bf16 table meets the features cast to bf16, as the reference's does:
    bf16 x bf16 products are exact in f32, and the dot sums them in f32."""
    if a_tile.dtype == torch.bfloat16:
        f = f.to(torch.bfloat16).float()
        a_tile = a_tile.float()
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
    subsumes occlusion), scanning every tile of the table's own size
    (``table_tile``): strict ``<`` across tiles, the lowest index on ties
    within one."""
    n = origin.shape[0]
    nt = clusters.shape[0]
    c = table_tile(feat, clusters)
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
# The reduced-precision forms: the plain version of the tensor-core kernel
# ---------------------------------------------------------------------------

def hi_lo_parts(x, n):
    """``x`` cut into ``n`` bf16 parts, each rounded to nearest-even from
    what the parts before it left: x ~ parts[0] + parts[1] + ... (the
    reference's ``_hi_lo_parts``)."""
    parts = []
    rem = x
    for _ in range(n):
        h = rem.to(torch.bfloat16)
        parts.append(h)
        rem = rem - h.float()
    return parts


def reduced_form(feat) -> str | None:
    """The tensor-core kernel's form for ``feat`` on the card: "bf16" for a
    bf16 table whatever the precision (the reference turns its split off
    for one), else ``_PRECISION_NAME``'s form; None for K1."""
    if feat.dtype == torch.bfloat16:
        return "bf16"
    return _CARD_FORMS[_PRECISION_NAME]


def _ray_pack(origin, direction, t_init, active, any_hit, exclude):
    """The reference's ray pack, lanes major: [N, FEAT] f32, the features
    of ``_ray_features`` with t_init, the active and any-hit flags and the
    excluded triangle written into _PACK_TINIT.._PACK_EXCLUDE."""
    pack = _ray_features(origin, direction)
    pack[:, _PACK_TINIT] = t_init
    pack[:, _PACK_ACTIVE] = active.float()
    pack[:, _PACK_ANYHIT] = any_hit.float()
    pack[:, _PACK_EXCLUDE] = exclude.float()
    return pack


def _form_operands(feat, pack, form):
    """-> (F [N, 16T] ray parts, A [16T, 4*Tpad] table parts, both bf16
    values held in f32, stacked term by term; the control columns as the
    kernel reads them).  In a split form the control values are rebuilt
    from the ray's distinct parts, as the reference's kernel rebuilds
    them: bf16x3's two parts round t_init."""
    terms = FORM_TERMS[form]
    n_ray = max(j for _, j in terms) + 1
    if form == "bf16":
        pp = [pack.to(torch.bfloat16)]
        ap = [feat.to(torch.bfloat16)]
        ctrl = pack
    else:
        if feat.dtype != torch.float32:
            raise TypeError(f"form {form} splits an f32 table, not "
                            f"{feat.dtype}")
        pp = hi_lo_parts(pack, n_ray)
        ap = hi_lo_parts(feat, table_parts(form))
        ctrl = pp[0].float()
        for part in pp[1:]:
            ctrl = ctrl + part.float()
    f = torch.cat([pp[j].float() for _, j in terms], dim=1)
    a = torch.cat([ap[i].float() for i, _ in terms], dim=0)
    return f, a, ctrl


def intersect_reduced_plain(feat, clusters, origin, direction, t_init, active,
                            any_hit, exclude, form, norel=False, block=None):
    """What the reference's TPU kernel computes in ``form`` ("bf16",
    "bf16x3" or "bf16x6"), in plain PyTorch: the plain version of the
    tensor-core kernel -> (t [N], tri [N] int32).

    Every bf16 part is rounded to nearest-even (``hi_lo_parts``); each
    tile's four quantities are one f32 product of the stacked parts, whose
    bf16 x bf16 products are exact, summed in f32 over the stacked dimension
    in order; the control values are the ones the kernel reads
    (``_form_operands``).  Tiles (the table's own, ``table_tile``) are
    taken in table order and only for blocks of ``block`` lanes
    (RELEVANCE_BLOCK when None) whose relevance bit is set (all of them
    with ``norel``), every lane of such a block tested; a strictly smaller t
    wins across tiles, the lowest index within one; an inactive lane never
    records a hit, an any-hit lane stops after its first occluding tile
    with that tile's winner, a lane's excluded triangle never hits; t
    falls back to the (rebuilt) t_init.  "default" on the card is form
    "bf16" of the f32 table.

    The control columns enter the product against the table's zero rows,
    as the reference's pack does: a t_init whose parts are not finite (inf,
    or a value past bf16's range) makes every quantity of its lane NaN, so
    the lane records no hit (the split forms' rebuilt t_init is then NaN).
    The kernel keeps the control values out of its products and gives such
    a lane no hit itself."""
    n = origin.shape[0]
    dev = origin.device
    c = table_tile(feat, clusters)
    nt = clusters.shape[0]
    block = RELEVANCE_BLOCK if block is None else block
    t_init = _lane_tensor(t_init, n, torch.float32, dev, None)
    active = _lane_tensor(active, n, torch.bool, dev, True)
    any_hit = _lane_tensor(any_hit, n, torch.bool, dev, False)
    exclude = _lane_tensor(exclude, n, torch.int32, dev, -1)
    if norel:
        words = torch.full((-(-n // block), -(-nt // 32)), -1,
                           dtype=torch.int32, device=dev)
    else:
        words = relevance_words(clusters, origin, direction, t_init, active,
                                block)
    f, a, ctrl = _form_operands(feat, _ray_pack(origin, direction, t_init,
                                                active, any_hit, exclude),
                                form)
    tinit = ctrl[:, _PACK_TINIT]
    act = ctrl[:, _PACK_ACTIVE] > 0.5
    anyh = ctrl[:, _PACK_ANYHIT] > 0.5
    excl = ctrl[:, _PACK_EXCLUDE]
    best_t = torch.where(act, tinit, -torch.inf)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rowf = torch.arange(c, dtype=torch.float32, device=dev)
    block_of = torch.arange(n, device=dev) // block
    w = words.to(torch.int64) & 0xFFFFFFFF
    for j in range(nt):
        lanes = ((w[:, j // 32] >> (j % 32)) & 1).bool()[block_of]
        idx = torch.nonzero(lanes).flatten()
        if idx.numel() == 0:
            continue
        score = _tile_scores(f[idx], a[:, j * 4 * c:(j + 1) * 4 * c], c)
        score = torch.where(rowf + float(j * c) == excl[idx, None],
                            torch.inf, score)
        tmin, targ = torch.min(score, dim=1)
        cur_t, cur_i = best_t[idx], best_i[idx]
        better = tmin < cur_t
        best_t[idx] = torch.where(
            better, torch.where(anyh[idx], -torch.inf, tmin), cur_t)
        best_i[idx] = torch.where(better, targ.to(torch.int32) + j * c, cur_i)
    got = best_i >= 0
    return torch.where(got & torch.isfinite(best_t), best_t, tinit), best_i


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
    none.  ``norel`` (``PRT_MESH_NOREL``) skips the slab tests: every live
    lane tests every tile.  The tile is the table's (``table_tile``), one of
    KERNEL_TILES."""

    def __init__(self):
        self.launches = 0

    def __call__(self, feat, clusters, origin, direction, t_init, active,
                 any_hit, exclude, counters=None, norel=False):
        dev = origin.device
        n = origin.shape[0]
        nt = clusters.shape[0]
        tile = table_tile(feat, clusters)
        if feat.shape[1] != 4 * tile * nt:
            raise ValueError(f"feat {tuple(feat.shape)} is not {nt} whole "
                             "tiles")
        kernel_tile(tile)
        _cuda.require(feat, "feat", torch.float32, (FEAT, 4 * tile * nt), dev)
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
                feat.data_ptr(), feat.stride(0), nt, tile, clusters.data_ptr(),
                origin.data_ptr(), direction.data_ptr(), t_init.data_ptr(),
                active.data_ptr(), any_hit.data_ptr(), exclude.data_ptr(), n,
                out_t.data_ptr(), out_tri.data_ptr(),
                None if counters is None else counters.data_ptr(),
                int(norel), _cuda.stream_handle(origin))
        _cuda.check(code, "prt_mesh_brute")
        self.launches += 1
        return out_t, out_tri


mesh_brute_kernel = _MeshBruteKernel()


# ---------------------------------------------------------------------------
# The tensor-core kernel of the reduced-precision forms
# ---------------------------------------------------------------------------

# the kernel's shape (csrc/mesh_brute_tc.cuh: N, STAGE_TRIS): columns a
# wgmma (m64nNk16, N / 4 triangles) and triangles a ring stage.  The table
# image does not depend on either; the CPU tests use them to emulate the
# kernel's accumulators and triangle indices, and chip_smoke.py checks them
# against the build (tc_resources)
TC_N = 64
TC_STAGE_TRIS = 64
TC_TRI_BYTES = 128  # a triangle's 4 quantities x 16 features, bf16
# the kernel keeps a block's relevance bits in shared memory (256 words),
# whatever the tile's size
TC_MAX_TILES = 8192


def table_parts(form):
    """The bf16 parts of the table that ``form``'s terms use."""
    return max(i for i, _ in FORM_TERMS[form]) + 1


def tc_column_map(tile):
    """(triangle, quantity) of each of a tile's 4 x ``tile`` columns in the
    kernel's order: column n = 16m + 8h + 2tig + b holds quantity 2h + b
    (den, t*den, u*den, v*den) of the tile's triangle 4m + tig, so that
    m64nN's accumulators give a thread all four quantities of one pair
    (``tc_accumulator_map``)."""
    n = torch.arange(4 * tile)
    return 4 * (n // 16) + (n % 8) // 2, 2 * ((n // 8) % 2) + n % 2


def tc_accumulator_map(n_cols=TC_N):
    """[128, n_cols / 2] (row, column) of each f32 accumulator of a
    wgmma.m64n{n_cols}k16 over a warpgroup, in register order: register
    4i + e of lane 4g + tig of warp w is row 16w + g + 8 (e >> 1), column
    8i + 2 tig + (e & 1) (PTX ISA, wgmma's register fragment of D)."""
    thread = torch.arange(128)[:, None]
    reg = torch.arange(n_cols // 2)[None, :]
    w, g, tig = thread // 32, (thread % 32) // 4, thread % 4
    i, e = reg // 4, reg % 4
    return 16 * w + g + 8 * (e >> 1), 8 * i + 2 * tig + (e & 1)


def tc_fragments(feat, n_parts, tile=None):
    """The coefficient table cut into ``n_parts`` bf16 parts
    (``hi_lo_parts``; one part of a bf16 table is the table) and laid out
    as the exact image of the kernel's shared-memory slabs -> [n_parts, nt,
    tile / 2, 2, 8, 8] bf16: for each part and tile (of ``tile``
    triangles, TILE when None), the tile's 4 x tile columns in
    ``tc_column_map``'s order as wgmma's K-major core matrices without
    swizzle: [column // 8][feature // 8][column % 8][feature % 8], 8
    columns x 8 features (128 bytes) a core matrix, the next 8 features 128
    bytes on, the next 8 columns 256.  A ring stage of the kernel is one
    contiguous TC_STAGE_TRIS x 128 bytes of it a part."""
    tile = TILE if tile is None else tile
    k, cols4 = feat.shape
    nt = cols4 // (4 * tile)
    src = feat if feat.dtype == torch.bfloat16 else feat.float()
    parts = torch.stack(hi_lo_parts(src, n_parts))  # [P, 16, 4*Tpad]
    tri, q = tc_column_map(tile)
    a = parts.reshape(n_parts, k, nt, 4 * tile)[
        ..., (q * tile + tri).to(feat.device)]  # [P, 16, nt, column]
    a = a.reshape(n_parts, 2, 8, nt, tile // 2, 8)  # [P, kh, k8, nt, c8, r]
    return a.permute(0, 3, 4, 1, 5, 2).contiguous()


# each table's fragments, made once per table, number of parts and tile
# (the reference hoists its table split out of the render loop the same
# way): id(table) -> (a weak reference to it, its _version, {(parts, tile):
# fragments}); an entry leaves with its table, and an in-place change of
# the table makes its fragments anew
_FRAGMENTS = {}


def form_fragments(feat, form, tile=None):
    """``tc_fragments`` of ``feat`` for ``form`` at ``tile`` (TILE when
    None; ``table_tile`` of the table and its clusters), cached per
    table."""
    key_parts = (table_parts(form), TILE if tile is None else tile)
    key = id(feat)
    entry = _FRAGMENTS.get(key)
    if entry is None or entry[0]() is not feat or entry[1] != feat._version:
        entry = (weakref.ref(feat), feat._version, {})
        _FRAGMENTS[key] = entry
        weakref.finalize(feat, _FRAGMENTS.pop, key, None)
    if key_parts not in entry[2]:
        entry[2][key_parts] = tc_fragments(feat, *key_parts)
    return entry[2][key_parts]


class _MeshBruteTcKernel:
    """Wrapper of ``prt_mesh_brute_tc`` (csrc/mesh_brute_tc.cu), the
    reduced-precision forms on the tensor cores; its plain version is
    ``intersect_reduced_plain``.  ``launches`` counts kernel launches and
    nothing else.  ``frag`` is ``form_fragments(feat, form, tile)``, whose
    shape gives the tile (one of KERNEL_TILES); ``block`` is the relevance
    block (RELEVANCE_BLOCK when None), one of KERNEL_BLOCKS."""

    def __init__(self):
        self.launches = 0

    def __call__(self, frag, clusters, origin, direction, t_init, active,
                 any_hit, exclude, form, norel=False, block=None):
        dev = origin.device
        n = origin.shape[0]
        nt = clusters.shape[0]
        if form not in _FORM_CODES:
            raise ValueError(f"form {form!r}: one of {sorted(_FORM_CODES)}")
        n_parts = table_parts(form)
        if nt > TC_MAX_TILES:
            raise ValueError(f"{nt} tiles: the kernel takes at most "
                             f"{TC_MAX_TILES}")
        tile = frag.shape[2] * 2 if frag.dim() == 6 else 0
        _cuda.require(frag, "frag", torch.bfloat16,
                      (n_parts, nt, tile // 2, 2, 8, 8), dev)
        kernel_tile(tile)
        block = kernel_block(RELEVANCE_BLOCK if block is None else block)
        if frag.data_ptr() % 16:
            raise ValueError("frag: the kernel copies it to shared memory "
                             "in bulk; its data must start on a 16-byte "
                             "boundary")
        _cuda.require(clusters, "clusters", torch.float32, (nt, 8), dev)
        if clusters.data_ptr() % 16:
            raise ValueError("clusters: the kernel loads a box in two "
                             "16-byte pieces; its data must start on a "
                             "16-byte boundary")
        _cuda.require(origin, "origin", torch.float32, (n, 3), dev)
        _cuda.require(direction, "direction", torch.float32, (n, 3), dev)
        _cuda.require(t_init, "t_init", torch.float32, (n,), dev)
        _cuda.require(active, "active", torch.bool, (n,), dev)
        _cuda.require(any_hit, "any_hit", torch.bool, (n,), dev)
        _cuda.require(exclude, "exclude", torch.int32, (n,), dev)
        out_t = torch.empty((n,), dtype=torch.float32, device=dev)
        out_tri = torch.empty((n,), dtype=torch.int32, device=dev)
        if n == 0:
            return out_t, out_tri
        lib = _cuda.LIBRARY.get()
        with _cuda.on_device(origin):
            code = lib.prt_mesh_brute_tc(
                frag.data_ptr(), nt, tile, block, clusters.data_ptr(),
                origin.data_ptr(),
                direction.data_ptr(), t_init.data_ptr(), active.data_ptr(),
                any_hit.data_ptr(), exclude.data_ptr(), n, out_t.data_ptr(),
                out_tri.data_ptr(), _FORM_CODES[form], int(norel),
                _cuda.stream_handle(origin))
        _cuda.check(code, "prt_mesh_brute_tc")
        self.launches += 1
        return out_t, out_tri


mesh_brute_tc_kernel = _MeshBruteTcKernel()

# the ints prt_mesh_brute_tc_resources writes, in order
TC_RESOURCES = ("registers", "local_bytes", "static_smem", "dynamic_smem",
                "threads", "ctas_per_sm", "active_clusters", "wgmma_n",
                "stages", "stage_tris")


def tc_resources(tile, block, form):
    """The tensor-core kernel's (tile, block, form) instance on the current
    card (the CUDA runtime's function attributes and occupancy calculator)
    -> {name: int} by TC_RESOURCES; needs the card."""
    import ctypes
    out = (ctypes.c_int * len(TC_RESOURCES))()
    code = _cuda.LIBRARY.get().prt_mesh_brute_tc_resources(
        kernel_tile(tile), kernel_block(block), _FORM_CODES[form], out)
    _cuda.check(code, "prt_mesh_brute_tc_resources")
    return dict(zip(TC_RESOURCES, out))


def uses_kernel(x: torch.Tensor) -> bool:
    """True when ``mesh_intersect`` launches a kernel (K1 or the
    tensor-core kernel) for tensors on ``x``'s device; callers gate what
    only the kernels need (the ray sort and the second pass of
    ``intersect.mesh_closest``) on it, as the reference gates them on
    ``uses_pallas()``, which ``PRT_MESH_FORCE_XLA`` turns off there and
    here.  The twin on the CPU scans every tile per lane, so lane order
    cannot change its work."""
    return (x.device.type == "cuda"
            and not os.environ.get("PRT_MESH_FORCE_XLA"))


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
    tri >= 0 (occluded) is meaningful (the kernels stop them at their first
    occluding tile and return t_init).  Detached.  CPU tensors run the
    plain twin, and so do CUDA tensors under ``PRT_MESH_FORCE_XLA``; else
    CUDA tensors launch K1 or, in a reduced-precision form
    (``reduced_form``), the tensor-core kernel, with no fallback.
    ``PRT_MESH_NOREL`` reaches either kernel as its flag.
    """
    origin = origin.detach()
    direction = direction.detach()
    if isinstance(t_init, torch.Tensor):
        t_init = t_init.detach()
    if origin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mesh_intersect: unsupported device {origin.device}")
    # the device and the switch themselves, as the reference tests them
    # here beside uses_pallas (which callers' tests may force open)
    if (origin.device.type == "cpu"
            or os.environ.get("PRT_MESH_FORCE_XLA")):
        return _intersect_xla(feat, clusters, origin, direction, t_init,
                              active, exclude=exclude)
    return _launch(feat, clusters, origin, direction, t_init, active,
                   any_hit, exclude)


def _launch(feat, clusters, origin, direction, t_init, active, any_hit,
            exclude):
    """``mesh_intersect``'s kernel launch: K1 for the f32 form, the
    tensor-core kernel for ``reduced_form``'s, ``PRT_MESH_NOREL`` (read
    here, at each call) as the kernel's flag."""
    n = origin.shape[0]
    dev = origin.device
    lanes = (origin.contiguous(), direction.contiguous(),
             _lane_tensor(t_init, n, torch.float32, dev, None),
             _lane_tensor(active, n, torch.bool, dev, True),
             _lane_tensor(any_hit, n, torch.bool, dev, False),
             _lane_tensor(exclude, n, torch.int32, dev, -1))
    norel = bool(os.environ.get("PRT_MESH_NOREL"))
    form = reduced_form(feat)
    if form is None:
        return mesh_brute_kernel(feat.contiguous(), clusters.contiguous(),
                                 *lanes, norel=norel)
    return mesh_brute_tc_kernel(
        form_fragments(feat, form, table_tile(feat, clusters)),
        clusters.contiguous(), *lanes, form, norel=norel)


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


def matmul_only_plain(words, pack, feat, block, tile=None):
    """T1's plain version: for each ray, the masked per-tile sum over the
    tiles (of ``tile`` triangles, TILE when None) whose bit is set for its
    block of the column sums of ``A_tile^T . p`` -> (t [N] f32, i [N]
    int32 zeros)."""
    tile = TILE if tile is None else tile
    n = pack.shape[1]
    nt = feat.shape[1] // (4 * tile)
    w = words.reshape(-1, -(-nt // 32)).to(torch.int64) & 0xFFFFFFFF
    ray_block = torch.arange(n, device=pack.device) // block
    pt = pack.T
    t = torch.zeros((n,), dtype=torch.float32, device=pack.device)
    for j in range(nt):
        bit = ((w[:, j // 32] >> (j % 32)) & 1).bool()[ray_block]
        s = torch.matmul(pt, feat[:, j * 4 * tile:(j + 1) * 4 * tile]).sum(1)
        t = torch.where(bit, t + s, t)
    return t, torch.zeros((n,), dtype=torch.int32, device=pack.device)


class _MatmulOnlyKernel:
    """Wrapper of ``prt_matmul_only`` (csrc/matmul_only.cu).  ``launches``
    counts kernel launches and nothing else.  ``tile`` (TILE when None) is
    the table's, one of KERNEL_TILES."""

    def __init__(self):
        self.launches = 0

    def __call__(self, words, pack, feat, block, tile=None):
        dev = pack.device
        n = pack.shape[1]
        tile = kernel_tile(TILE if tile is None else tile)
        nt = feat.shape[1] // (4 * tile)
        nwords = -(-nt // 32)
        if block not in (128, 256):
            raise ValueError(f"block {block}: the kernel takes 128 or 256")
        if feat.shape[1] != 4 * tile * nt:
            raise ValueError(f"feat {tuple(feat.shape)} is not whole tiles")
        _cuda.require(words, "words", torch.int32, (-(-n // block), nwords),
                      dev)
        _cuda.require(pack, "pack", torch.float32, (FEAT, n), dev)
        _cuda.require(feat, "feat", torch.float32, (FEAT, 4 * tile * nt), dev)
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
                feat.stride(0), nt, tile, n, block, out_t.data_ptr(),
                out_i.data_ptr(), _cuda.stream_handle(pack))
        _cuda.check(code, "prt_matmul_only")
        self.launches += 1
        return out_t, out_i


matmul_only_kernel = _MatmulOnlyKernel()


def matmul_only(words, pack, feat, block, tile=None):
    """T1 -> (t [N], i [N] zeros): ``matmul_only_plain`` for CPU tensors,
    the kernel for CUDA tensors (no fallback).  ``words`` from
    ``relevance_words`` at the same ``block``; ``tile`` the table's (TILE
    when None)."""
    if pack.device.type == "cpu":
        return matmul_only_plain(words, pack, feat, block, tile)
    if pack.device.type != "cuda":
        raise ValueError(f"matmul_only: unsupported device {pack.device}")
    return matmul_only_kernel(words.contiguous(), pack.contiguous(),
                              feat.contiguous(), block, tile)
