"""Scene intersection for the render path: analytic spheres, SDFs, boxes
and quads, and the triangle mesh through either backend: the brute one
(ops/mesh_brute.py, the kernel K1 on the card) or the skip-link BVH walk
(``bvh_traverse``, the kernel W1 of ops/bvh_walk.py on the card).

Port of ``photorealistic_rendering_using_opencl_tpu/ops/intersect.py``.
The whole ray batch is intersected
against each primitive class with broadcasting ([rays x objects]); SDFs
are sphere-traced by a masked loop over the batch; the mesh runs once per
call on the merged closest-hit + shadow batch.  Selection is detached;
the winner is reattached with zero-in-primal corrections,
``t_det - (f - f.detach()) / dfdt``, so that gradients only need autograd
switched on.  The merged dispatch comes in two halves so the
differentiable render loops can keep the expensive one out of their
recomputed regions: ``intersect_and_shadow_detached`` (analytic sweep and
SDF march, shadow tests, the mesh kernel, winner validation; no gradient)
and ``finish_hit`` (the reattach functions; every gradient of the
geometry enters here).  The reference's one-piece entry points are those
halves in a row: ``intersect_scene`` (a closest-hit batch alone),
``intersect_and_shadow`` (closest hits and shadow batches), and
``shadow_visible`` (one shadow batch, the mesh last).

The reference's ``sdf_march`` is a ``while_loop`` that stops when every
lane is done; a done lane's t is frozen, so running all of the budget's
steps gives bitwise the same t.  Here the march runs the whole budget
(no host sync: the differentiable loops' dispatches) or, with
``early_exit``, asks the device whether every lane is done once every
``MARCH_EXIT_EVERY`` steps (the forward loops, which sync anyway).

Object order is [spheres | sdfs | boxes | quads]; the OBJ triangle mesh
is a virtual object with id == cfg.n_objects.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    EPS, RAY_INF, copysign, cross, fetch_float_rows, fma32, normalize,
    sqrt_rn,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    BOX, DIEL, QUAD, ROUGH_DIEL, SceneConfig, SceneData, SDF, SDF_BOX,
    SDF_CYLINDER, SDF_PLANE, SDF_ROUND_BOX, SDF_SPHERE, SDF_TORUS, SPHERE,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import (
    TRACER, spanned,
)

# the early-exit march asks the device "every lane done?" once this many
# steps (the reference's while_loop asks every step)
MARCH_EXIT_EVERY = 16


class Hit(NamedTuple):
    t: torch.Tensor  # [N] distance (RAY_INF on miss)
    mesh_id: torch.Tensor  # [N] int32; object index, cfg.n_objects for the OBJ
    pos: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3] (shading normal, backside-resolved)
    backside: torch.Tensor  # [N] bool
    # winning triangle index in the index space of the backend that found
    # it (brute: the bf_* tables; the walk: leaf-major, leaf_idx*4 + k),
    # -1 for analytic/miss; fed back as the next dispatch's self-exclusion,
    # which only the brute backend reads
    tri: torch.Tensor = None

    @property
    def valid(self):
        return self.t < RAY_INF


# ===========================================================================
# Analytic primitives (broadcast over [rays, objects])
# ===========================================================================

def sphere_hits(origin, direction, centers, radii):
    """[N,3] rays vs [S] spheres -> t[N,S] (inf on miss), nearest positive
    root."""
    p = origin[:, None, :] - centers[None, :, :]
    b = torch.sum(p * direction[:, None, :], dim=-1)
    c = torch.sum(p * p, dim=-1) - radii[None, :] * radii[None, :]
    det_sq = b * b - c
    miss = det_sq < EPS * EPS
    det = torch.sqrt(torch.where(miss, 1.0, det_sq))
    det = torch.where(miss, 0.0, det)
    t0 = -b - det
    t1 = -b + det
    t = torch.where(t0 > EPS, t0, torch.where(t1 > EPS, t1, torch.inf))
    return torch.where(det_sq >= 0.0, t, torch.inf)


def box_hits(origin, direction, centers, half_extents):
    """Slab test vs [B] boxes -> (t[N,B], normal[N,B,3], backside[N,B]).

    The two corners are ``pos + half_extents`` and ``pos - half_extents``;
    the normal is the axis that achieves the entry (or, from inside, the
    exit) time, found by exact comparison.
    """
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                              copysign(1e-12, direction), direction)
    o = origin[:, None, :]
    idv = inv_d[:, None, :]
    tmin = (centers[None] + half_extents[None] - o) * idv
    tmax = (centers[None] - half_extents[None] - o) * idv
    real_min = torch.minimum(tmin, tmax)  # [N,B,3]
    real_max = torch.maximum(tmin, tmax)
    minmax = torch.amin(real_max, dim=-1)
    maxmin = torch.amax(real_min, dim=-1)
    outside = maxmin > 0.0
    hit = (minmax > maxmin) & ((outside & (maxmin > 0.0)) | (minmax > 0.0))
    t = torch.where(outside, maxmin, minmax)
    plane = torch.where(outside[..., None], real_min, real_max)
    sel = torch.where(outside[..., None], plane == maxmin[..., None],
                      plane == minmax[..., None])
    normal = -torch.sign(direction)[:, None, :] * sel.to(torch.float32)
    backside = ~outside
    t = torch.where(hit & (t > EPS), t, torch.inf)
    return t, normal, backside


def quad_hits(origin, direction, base, edge0, edge1, normal):
    """One-sided parallelogram intersect -> t[N,Q]; ``base`` is the rect
    center, the anchor corner is base - (edge0+edge1)/2."""
    ndotw = torch.sum(normal[None] * direction[:, None, :], dim=-1)
    anchor = base - (edge0 + edge1) * 0.5
    rt = (torch.sum(normal[None] * (anchor[None] - origin[:, None, :]), dim=-1)
          / torch.where(torch.abs(ndotw) < 1e-12, 1e-12, ndotw))
    q = origin[:, None, :] + rt[..., None] * direction[:, None, :]
    v = q - anchor[None]
    l0 = torch.sum(v * edge0[None], dim=-1) / torch.clamp(
        torch.sum(edge0 * edge0, dim=-1)[None], min=1e-12)
    l1 = torch.sum(v * edge1[None], dim=-1) / torch.clamp(
        torch.sum(edge1 * edge1, dim=-1)[None], min=1e-12)
    ok = ((ndotw >= 1e-5) & (rt > EPS)
          & (l0 >= 0.0) & (l0 <= 1.0) & (l1 >= 0.0) & (l1 <= 1.0))
    return torch.where(ok, rt, torch.inf)


# ===========================================================================
# SDF raymarching
# ===========================================================================

def _sum3(x):
    """x0 + x1 + x2 over the last axis, as elementwise adds in that order:
    bitwise the same on the CPU and the card (a reduction kernel's order is
    its own).  The central differences of ``_sdf_grad`` magnify a last-bit
    difference of a distance to ~1e-3 of the normal."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def _norm(x):
    """sqrt(x0^2 + x1^2 + x2^2): the reference's 2-norm, with a zero
    derivative at the zero vector.  The reference's sqrt has an infinite
    one there, so a lane whose evaluation of the box or round-box formula
    has all of |p| - b <= 0 (every box-class hit on a face evaluates it)
    turns every gradient of the SDF tables into NaN (ROADMAP F12).  The
    value is the reference's bit for bit."""
    s = _sum3(x * x)
    zero = s <= 0.0
    return torch.where(zero, 0.0, sqrt_rn(torch.where(zero, 1.0, s)))


def sd_primitive(geom_type, center_rel, params):
    """Signed distance of one SDF object; broadcast over [..., objects].

    geom_type carries the SDF subtype bits, params [..., 4], center_rel
    [..., 3] = p - position.  Every subtype is evaluated and the type bits
    select one, as in the reference (cylinder and torus are JSON types 8
    and 9; a torus's radii are params 0 and 1).
    """
    p = center_rel
    r = params[..., 0]
    b = params[..., :3]
    d_sphere = _norm(p) - r
    q = torch.abs(p) - b
    d_box = (torch.clamp(torch.amax(q, dim=-1), max=0.0)
             + _norm(torch.clamp(q, min=0.0)))
    d_round = _norm(torch.clamp(q, min=0.0)) - params[..., 3]
    d_plane = _sum3(p * params[..., :3]) + params[..., 3]
    len_xz = sqrt_rn(torch.clamp(p[..., 0] * p[..., 0]
                                 + p[..., 2] * p[..., 2], min=1e-30))
    d_cyl = torch.maximum(len_xz - params[..., 0],
                          torch.abs(p[..., 1]) - params[..., 1])
    ring = len_xz - params[..., 0]
    d_torus = sqrt_rn(torch.clamp(ring * ring + p[..., 1] * p[..., 1],
                                  min=1e-30)) - params[..., 1]
    d = torch.where((geom_type & SDF_TORUS) != 0, d_torus, torch.inf)
    for bit, dist in ((SDF_CYLINDER, d_cyl), (SDF_PLANE, d_plane),
                      (SDF_ROUND_BOX, d_round), (SDF_BOX, d_box),
                      (SDF_SPHERE, d_sphere)):
        d = torch.where((geom_type & bit) != 0, dist, d)
    return d


def sdf_map(pos, centers, geom_type, params):
    """Min over SDF objects; pos [N,3] -> (dist [N], argmin [N] int32)."""
    rel = pos[:, None, :] - centers[None]
    d = sd_primitive(geom_type[None], rel, params[None])  # [N,S]
    dist, arg = torch.min(d, dim=-1)
    return dist, arg.to(torch.int32)


def sdf_march(origin, direction, t_limit, centers, geom_type, params,
              steps: int, active=None, early_exit: bool = False):
    """Sphere tracing -> (t [N], obj [N], hit [N]), detached.

    Masked-out lanes (active=False) are born done.  A done lane's t stays
    frozen, so every one of ``steps`` iterations may run: bitwise the
    reference's early-stopping loop.  With ``early_exit`` the loop also
    stops once every lane is done, asked every MARCH_EXIT_EVERY steps.
    ``sdf_march.calls`` and ``sdf_march.steps`` count the marches and
    their iterations (each iteration one sdf_map over the batch).
    """
    with torch.no_grad():
        origin, direction = origin.detach(), direction.detach()
        centers, params = centers.detach(), params.detach()
        t_limit = torch.as_tensor(t_limit).detach()
        n = origin.shape[:-1]
        t = torch.full(n, EPS * 10.0, dtype=torch.float32,
                       device=origin.device)
        done = torch.zeros(n, dtype=torch.bool, device=origin.device)
        if active is not None:
            done = done | ~active.detach()
        sdf_march.calls += 1
        for i in range(steps):
            if early_exit and i % MARCH_EXIT_EVERY == 0 and bool(done.all()):
                break
            pos = origin + direction * t[..., None]
            h, _ = sdf_map(pos, centers, geom_type, params)
            h = torch.abs(h)
            done = done | (h < EPS) | (t > t_limit)
            t = torch.where(done, t, t + h)
            sdf_march.steps += 1
        hit = t <= t_limit
        pos = origin + direction * t[..., None]
        _, obj = sdf_map(pos, centers, geom_type, params)
    return t, obj, hit


sdf_march.calls = 0
sdf_march.steps = 0


def _sdf_grad(gt, p, c, prm):
    """Central differences of the selected SDF at p (differentiable)."""
    e = EPS * 2.0
    grads = []
    for axis in range(3):
        off = torch.zeros(3, dtype=torch.float32, device=p.device)
        off[axis] = e
        grads.append(sd_primitive(gt, p + off - c, prm)
                     - sd_primitive(gt, p - off - c, prm))
    return normalize(torch.stack(grads, dim=-1))


def sdf_normal(pos, centers, geom_type, params, obj_idx):
    """Central differences on the selected object."""
    i = obj_idx.long()
    return _sdf_grad(geom_type[i], pos, centers[i], params[i])


def sdf_reattach(origin, direction, t_det, centers, geom_type, params,
                 obj_idx):
    """Differentiable sphere-tracing distance by one Newton step.

    With f(t) = sdf(o + t d) and the detached root ``t_det``, the implicit
    function theorem gives dt = -df / <grad f, d>: ``t_det - f /
    stop(<grad f, d>)`` is ``t_det`` in the primal (f ~ 0 at the root) and
    carries the first-order derivative with respect to the ray and the SDF
    tables.  |<grad f, d>| below 1e-4 is clamped to 1e-4 with its sign, as
    in the reference.
    """
    i = obj_idx.long()
    pos = origin + direction * t_det[..., None]
    f = sd_primitive(geom_type[i], pos - centers[i], params[i])
    g = sdf_normal(pos, centers, geom_type, params, obj_idx)
    dfdt = _sum3(g * direction).detach()
    dfdt = torch.where(torch.abs(dfdt) < 1e-4, copysign(1e-4, dfdt), dfdt)
    return t_det - f / dfdt


# ===========================================================================
# Triangles
# ===========================================================================

def _tri_intersect(p0, p1, p2, origin, direction, t_best):
    """Reference triangle test -> (hit, t, u, v)."""
    e1 = p0 - p1
    e2 = p2 - p0
    n = cross(e1, e2)
    c = p0 - origin
    r = cross(direction, c)
    den = torch.sum(n * direction, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(den) < 1e-20, copysign(1e-20, den),
                                den)
    u = torch.sum(r * e2, dim=-1) * inv_det
    v = torch.sum(r * e1, dim=-1) * inv_det
    w = 1.0 - u - v
    t = torch.sum(n * c, dim=-1) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (w >= 0.0) & (t > EPS) & (t < t_best)
    return hit, t, u, v


def _fma_cross(a, b):
    """a x b with each component fma(a_i, b_j, -(a_j * b_i)): how XLA's CPU
    backend compiles the reference's ``jnp.cross`` inside its walk."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([fma32(a1, b2, -(a2 * b1)),
                        fma32(a2, b0, -(a0 * b2)),
                        fma32(a0, b1, -(a1 * b0))], dim=-1)


def _fma_dot(a, b):
    """fma(a2, b2, fma(a1, b1, a0 * b0)): XLA's CPU form of the reference's
    ``jnp.sum(a * b, axis=-1)`` over three terms."""
    return fma32(a[..., 2], b[..., 2],
                 fma32(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _walk_tri_intersect(p0, p1, p2, origin, direction, t_best):
    """The walk's triangle test, ``_tri_intersect`` with the reference's
    crosses and dot products contracted as XLA's CPU backend contracts
    them in its walk (``_fma_cross``, ``_fma_dot``; tests/test_torch_bvh.py
    measures the pattern), so the walk is bitwise the reference's on the
    CPU; W1 computes the same FMAs (csrc/bvh_walk.cu)."""
    e1 = p0 - p1
    e2 = p2 - p0
    n = _fma_cross(e1, e2)
    c = p0 - origin
    r = _fma_cross(direction, c)
    den = _fma_dot(n, direction)
    inv_det = 1.0 / torch.where(torch.abs(den) < 1e-20, copysign(1e-20, den),
                                den)
    u = _fma_dot(r, e2) * inv_det
    v = _fma_dot(r, e1) * inv_det
    w = 1.0 - u - v
    t = _fma_dot(n, c) * inv_det
    hit = (u >= 0.0) & (v >= 0.0) & (w >= 0.0) & (t > EPS) & (t < t_best)
    return hit, t, u, v


# ===========================================================================
# BVH traversal: the stackless skip-link walk
# ===========================================================================

LEAF_SIZE = 4  # triangles a leaf row holds (scene/bvh_build.py)


def bvh_traverse(scene: SceneData, origin, direction, t_init, any_hit=False,
                 active=None, count_steps: bool = False):
    """Closest hit over the threaded BVH -> (t [N], tri [N] leaf-major,
    -1 = none, u [N], v [N]), plus the node visits [N] int32 with
    ``count_steps``.  Detached.  ``any_hit`` is a bool or a per-lane [N]
    bool tensor: such a lane stops at its first hit.  Inactive lanes
    return (t_init, -1, 0, 0) and visit no node.  CPU tensors run the plain
    twin ``_bvh_traverse_chunk``; CUDA tensors launch W1 (ops/bvh_walk.py)
    or raise."""
    if TRACER.on:
        TRACER.count("w1.launches")
        if isinstance(active, torch.Tensor):
            TRACER.count_mask("w1.rays", active)
        else:
            TRACER.count("w1.rays", origin.shape[0] if active in (None, True)
                         else 0)
    if origin.device.type == "cpu":
        return _bvh_traverse_chunk(scene, origin, direction, t_init,
                                   any_hit, active, count_steps)
    return bvh_walk.walk(scene.bvh_nodes, scene.bvh_links, scene.leaf_verts,
                         origin, direction, t_init, any_hit, active,
                         count_steps)


@torch.no_grad()
def _bvh_traverse_chunk(scene: SceneData, origin, direction, t_init,
                        any_hit=False, active=None, count_steps: bool = False,
                        counters=None):
    """The walk's plain twin, the reference's ``_bvh_traverse_chunk`` op for
    op: every lane advances one node a step (hit and inner: the octant's
    hit link, else its miss link) until every lane has passed the last
    node.  A step fetches the 32-byte node row and the octant's links,
    slab-tests the box (entry clamped to EPS, exit to the lane's best t;
    min/max propagate NaN, as jnp's do) and, at a leaf it enters, tests the
    leaf's triangles in order, each against the best t so far
    (``_walk_tri_intersect``).  A lane's result depends on that lane
    alone, so lanes that are done leave the arrays and only the lanes that
    enter a leaf fetch and test it (the reference tests every lane and
    discards the rest): a step costs what those lanes need.  ``counters``,
    an int64 tensor of at least 3 words, gains the walk's node visits,
    leaves entered and triangle tests, as W1 counts them."""
    origin, direction = origin.detach(), direction.detach()
    nodes, links = scene.bvh_nodes.detach(), scene.bvh_links
    leaves = scene.leaf_verts.detach()
    dev = origin.device
    n_nodes = nodes.shape[0]
    n = origin.shape[0]
    inv_d = 1.0 / torch.where(torch.abs(direction) < 1e-12,
                              copysign(1e-12, direction), direction)
    oct_ = ((direction[:, 0] < 0).to(torch.int64)
            | ((direction[:, 1] < 0).to(torch.int64) << 1)
            | ((direction[:, 2] < 0).to(torch.int64) << 2))
    out_t = torch.broadcast_to(torch.as_tensor(
        t_init, dtype=torch.float32, device=dev), (n,)).clone()
    out_tri = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_steps = torch.zeros((n,), dtype=torch.int32, device=dev)
    ah = torch.broadcast_to(torch.as_tensor(any_hit, dtype=torch.bool,
                                            device=dev), (n,))
    lane = torch.arange(n, device=dev)
    if active is not None:
        lane = lane[active.detach().to(torch.bool)]
    o, d, idv, ah = origin[lane], direction[lane], inv_d[lane], ah[lane]
    base = oct_[lane] * n_nodes
    t, tri = out_t[lane], out_tri[lane]
    u, v, steps = out_u[lane], out_v[lane], out_steps[lane]
    node = torch.zeros(lane.shape, dtype=torch.int64, device=dev)
    eps = torch.tensor(EPS, dtype=torch.float32, device=dev)
    while lane.numel():
        row = nodes[node]
        meta = row[:, 7].contiguous().view(torch.int32)
        lk = links[base + node]
        t_lo = (row[:, 0:3] - o) * idv
        t_hi = (row[:, 3:6] - o) * idv
        entry = torch.maximum(torch.amax(torch.minimum(t_lo, t_hi), dim=-1),
                              eps)
        exit_ = torch.minimum(torch.amin(torch.maximum(t_lo, t_hi), dim=-1),
                              t)
        box_hit = entry <= exit_
        count = meta & 7
        leaf_idx = meta >> 3
        at = torch.nonzero(box_hit & (count > 0)).squeeze(1)
        if counters is not None:
            counters[0] += lane.numel()
            counters[1] += at.numel()
            counters[2] += torch.clamp(count[at], max=LEAF_SIZE).sum()
        if at.numel():
            tv = leaves[leaf_idx[at].long()].reshape(-1, LEAF_SIZE, 3, 3)
            ta, tria, ua, va = t[at], tri[at], u[at], v[at]
            oa, da, ca, la = o[at], d[at], count[at], leaf_idx[at]
            for k in range(LEAF_SIZE):
                h, tk, uk, vk = _walk_tri_intersect(tv[:, k, 0], tv[:, k, 1],
                                                    tv[:, k, 2], oa, da, ta)
                take = (k < ca) & h
                ta = torch.where(take, tk, ta)
                tria = torch.where(take, la * LEAF_SIZE + k, tria)
                ua = torch.where(take, uk, ua)
                va = torch.where(take, vk, va)
            t, tri = t.index_put((at,), ta), tri.index_put((at,), tria)
            u, v = u.index_put((at,), ua), v.index_put((at,), va)
        nxt = torch.where(box_hit & (count == 0), lk[:, 0], lk[:, 1]).long()
        node = torch.where(ah & (tri >= 0), n_nodes, nxt)
        steps = steps + 1
        done = node >= n_nodes
        if bool(done.any()):
            fin = lane[done]
            out_t[fin], out_tri[fin] = t[done], tri[done]
            out_u[fin], out_v[fin] = u[done], v[done]
            out_steps[fin] = steps[done]
            keep = ~done
            lane, node, base = lane[keep], node[keep], base[keep]
            o, d, idv, ah = o[keep], d[keep], idv[keep], ah[keep]
            t, tri, u, v, steps = (t[keep], tri[keep], u[keep], v[keep],
                                   steps[keep])
    if count_steps:
        return out_t, out_tri, out_u, out_v, out_steps
    return out_t, out_tri, out_u, out_v


def tri_reattach(tri_verts, tri, origin, direction):
    """(t, u, v) for an already-selected triangle; the detached search's
    winner re-derived in exact f32 (and differentiable)."""
    tv = tri_verts.reshape(-1, 9)[torch.clamp(tri, min=0).long()]
    p0, p1, p2 = tv[:, 0:3], tv[:, 3:6], tv[:, 6:9]
    e1 = p0 - p1
    e2 = p2 - p0
    n = cross(e1, e2)
    c = p0 - origin
    r = cross(direction, c)
    den = torch.sum(n * direction, dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(den) < 1e-20, copysign(1e-20, den),
                                den)
    u = torch.sum(r * e2, dim=-1) * inv_det
    v = torch.sum(r * e1, dim=-1) * inv_det
    t = torch.sum(n * c, dim=-1) * inv_det
    return t, u, v


def _surface_f(cfg, gt, p, c, prm, qb, qe0, qe1, qn):
    """Signed surface function F(p) of the winning analytic object: zero on
    the surface, smooth in p and in the object's table rows."""
    rel = p - c
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    if cfg.n_sdfs:
        out = torch.where((gt & SDF) != 0, sd_primitive(gt, rel, prm), out)
    if cfg.n_quads:
        anchor = qb - (qe0 + qe1) * 0.5
        out = torch.where((gt & QUAD) != 0,
                          torch.sum(qn * (p - anchor), dim=-1), out)
    if cfg.n_boxes:
        out = torch.where((gt & BOX) != 0,
                          torch.amax(torch.abs(rel) - prm[:, 0:3], dim=-1),
                          out)
    if cfg.n_spheres:
        out = torch.where((gt & SPHERE) != 0,
                          torch.sum(rel * rel, dim=-1) - prm[:, 0] * prm[:, 0],
                          out)
    return out


def _surface_dfdt(cfg, gt, p, c, prm, qn, d):
    """dF/dt along the ray for ``_surface_f`` (detached): the directional
    derivative of F at p along d.  SDFs take it by forward-mode AD (the
    reference's ``jax.jvp``), the other classes in closed form."""
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    if cfg.n_sdfs:
        _, ddir = torch.func.jvp(lambda pp: sd_primitive(gt, pp - c, prm),
                                 (p,), (d,))
        out = torch.where((gt & SDF) != 0, ddir, out)
    if cfg.n_quads:
        out = torch.where((gt & QUAD) != 0, torch.sum(qn * d, dim=-1), out)
    if cfg.n_boxes:
        _, ddir = torch.func.jvp(
            lambda pp: torch.amax(torch.abs(pp - c) - prm[:, 0:3], dim=-1),
            (p,), (d,))
        out = torch.where((gt & BOX) != 0, ddir, out)
    if cfg.n_spheres:
        out = torch.where((gt & SPHERE) != 0,
                          torch.sum((p - c) * d, dim=-1) * 2.0, out)
    return out


def analytic_reattach(cfg: SceneConfig, scene: SceneData, origin, direction,
                      t_det, mesh_id, normal_det):
    """Winner-only (t, normal) for analytic hits with zero-in-primal
    corrections: t = t_det - (F - F.detach()) / dF/dt is t_det in the
    forward pass and carries the implicit-function derivative under
    autograd; normals get the same correction."""
    if cfg.n_objects == 0:
        return t_det, normal_det
    k = scene.position.shape[0]
    analytic = (mesh_id >= 0) & (mesh_id < cfg.n_objects)
    idx = torch.clamp(mesh_id, 0, k - 1).long()
    rows = torch.cat(
        [scene.position, scene.params, scene.quad_base, scene.quad_edge0,
         scene.quad_edge1, scene.quad_normal], dim=1)  # [K,19]
    g = fetch_float_rows(rows, idx)
    c, prm = g[:, 0:3], g[:, 3:7]
    qb, qe0, qe1, qn = g[:, 7:10], g[:, 10:13], g[:, 13:16], g[:, 16:19]
    gt = scene.geom_type.detach()[idx]

    t_sg = t_det.detach()
    p = origin + direction * t_sg[..., None]
    f = _surface_f(cfg, gt, p, c, prm, qb, qe0, qe1, qn)
    p_sg = (origin.detach() + direction.detach() * t_sg[..., None])
    dfdt = _surface_dfdt(cfg, gt, p_sg, c.detach(), prm.detach(),
                         qn.detach(), direction.detach())
    dfdt = torch.where(torch.abs(dfdt) < 1e-6, copysign(1e-6, dfdt), dfdt)

    t_re = t_det - torch.where(analytic, f - f.detach(), 0.0) / dfdt

    n_dif = normal_det.detach()
    if cfg.n_sdfs:
        # the reference's form, at the hit point with a detached t (the
        # sphere's below moves with t: ROADMAP F2)
        n_dif = torch.where((gt & SDF)[..., None] != 0,
                            _sdf_grad(gt, p, c, prm), n_dif)
    if cfg.n_quads:
        n_dif = torch.where((gt & QUAD)[..., None] != 0, qn, n_dif)
    if cfg.n_spheres:
        # the normal at the REATTACHED hit point: it moves with t, and the
        # reference's normalize(p - c) with a detached t leaves that term
        # out (ROADMAP F2: finite differences disagree without it)
        p_re = origin + direction * t_re[..., None]
        n_dif = torch.where((gt & SPHERE)[..., None] != 0, normalize(p_re - c),
                            n_dif)
    # match the stored primal's sign so the correction stays zero in primal
    sign = torch.sign(torch.sum(n_dif * normal_det.detach(), dim=-1,
                                keepdim=True))
    n_dif = n_dif * torch.where(sign == 0.0, 1.0, sign)
    n_re = normal_det + torch.where(analytic[..., None],
                                    n_dif - n_dif.detach(), 0.0)
    return t_re, n_re


def bvh_smooth_normal(tri_normals, tri, u, v):
    """Barycentric vertex-normal interpolation."""
    tn = tri_normals.reshape(-1, 9)[torch.clamp(tri, min=0).long()]
    w = 1.0 - u - v
    return (w[..., None] * tn[:, 0:3] + u[..., None] * tn[:, 3:6]
            + v[..., None] * tn[:, 6:9])


# ===========================================================================
# Scene-level closest hit + shadow
# ===========================================================================

def ray_sort_key(origin, direction, clusters):
    """The reference's block-coherence sort key, bit for bit: the direction
    octant (3 bits) above the origin's cell in a 32^3 grid over the mesh
    bounds, ``(octant << 15) | (cx << 10) | (cy << 5) | cz`` -> [N] int32.
    Clusters whose upper bound is at or below -1e37 (empty tiles) leave
    the bounds.  The cell is clamped in float before the conversion: the
    same as the reference's clip of the converted value, whose float to
    int conversion saturates (NaN -> 0)."""
    o, d = origin.detach(), direction.detach()
    cl = clusters.detach()
    lo = torch.amin(cl[:, 0:3], dim=0)
    hi = torch.amax(torch.where(cl[:, 3:6] > -1e37, cl[:, 3:6], lo[None]),
                    dim=0)
    x = (o - lo) / torch.clamp(hi - lo, min=1e-6) * 31.0
    x = torch.where(torch.isnan(x), 0.0, torch.clamp(x, 0.0, 31.0))
    cell = x.to(torch.int32)
    octant = ((d[:, 0] < 0).to(torch.int32)
              | ((d[:, 1] < 0).to(torch.int32) << 1)
              | ((d[:, 2] < 0).to(torch.int32) << 2))
    return ((octant << 15) | (cell[:, 0] << 10) | (cell[:, 1] << 5)
            | cell[:, 2])


# a mesh hit's mesh_id is cfg.n_objects plus this offset
OBJ_MESH_ID_OFFSET = 0


def mesh_tables(cfg: SceneConfig, scene: SceneData):
    """(tri_verts, tri_normals) in the index space of ``cfg.mesh_accel``'s
    winners."""
    if cfg.mesh_accel == "bvh":
        return scene.tri_verts, scene.tri_normals
    return scene.bf_tri_verts, scene.bf_tri_normals


def mesh_closest(cfg: SceneConfig, scene: SceneData, origin, direction,
                 t_init, any_hit=False, active=None, exclude_tri=None):
    """Mesh intersection through ``cfg.mesh_accel``'s backend.

    Returns (t_detached [N], tri [N], tri_verts, tri_normals), tables in
    ``tri``'s index space; tri == -1 where nothing beats ``t_init``.
    ``exclude_tri`` ([N] int32, -1 = none) removes one triangle per lane
    (self-exclusion for rays leaving a mesh surface) in the brute backend,
    whose den-multiplied tests need it; the walk ignores it, as the
    reference's does (its t tests are exact f32), and is not validated.

    With ``cfg.mesh_sort_rays`` and rays for the kernel
    (``mesh_brute.uses_kernel``), the batch goes to K1 sorted by
    ``ray_sort_key``, so that a warp's rays need the same tiles, and the
    outputs come back in lane order: every per-lane input is permuted, and
    the results are bitwise the unsorted ones, since the tile prune is
    conservative per lane.  The sort is stable (``torch.argsort`` is not by
    default; ``jnp.argsort`` is): camera rays share one origin cell, and
    only a stable sort keeps them in pixel order within an octant.

    With ``cfg.mesh_second_pass`` and rays for a kernel, a lane whose winner
    fails ``_validate_winner`` (a grazing false hit of the den-multiplied
    test, which the reduced-precision forms make more of) is searched again
    in lane order with that winner excluded, only such lanes active, and
    the new winner validated in its turn: the reference's backstop.
    """
    if cfg.mesh_accel == "bvh":
        tm, tri, _, _ = bvh_traverse(scene, origin, direction, t_init,
                                     any_hit=any_hit, active=active)
        return tm, tri, scene.tri_verts, scene.tri_normals
    if cfg.n_triangles > mesh_brute.BRUTE_STREAM_MAX_TRIS:
        # the loader packs no brute tables past K1's limit
        raise ValueError(
            f"{cfg.n_triangles} triangles: the brute backend carries at most "
            f"{mesh_brute.BRUTE_STREAM_MAX_TRIS}; use mesh_accel='bvh'")
    origin_k, direction_k, t_init_k = origin, direction, t_init
    active_k, any_hit_k, exclude_k = active, any_hit, exclude_tri
    perm = None
    if cfg.mesh_sort_rays and mesh_brute.uses_kernel(origin):
        key = ray_sort_key(origin, direction, scene.bf_clusters)
        perm = torch.sort(key, stable=True).indices
        origin_k, direction_k = origin[perm], direction[perm]
        t_init_k = torch.broadcast_to(torch.as_tensor(
            t_init, dtype=torch.float32, device=origin.device),
            key.shape)[perm]
        active_k = None if active is None else active[perm]
        any_hit_k = (any_hit if isinstance(any_hit, bool)
                     else any_hit[perm])
        exclude_k = None if exclude_tri is None else exclude_tri[perm]
    tm, tri_raw = mesh_brute.mesh_intersect(
        scene.bf_feat, scene.bf_clusters, origin_k, direction_k, t_init_k,
        active=active_k, any_hit=any_hit_k, exclude=exclude_k)
    if perm is not None:
        tm = torch.empty_like(tm).index_copy_(0, perm, tm)
        tri_raw = torch.empty_like(tri_raw).index_copy_(0, perm, tri_raw)
    tri = _validate_winner(scene.bf_tri_verts, tri_raw, origin, direction,
                           t_init)
    if cfg.mesh_second_pass and mesh_brute.uses_kernel(origin):
        rejected = (tri_raw >= 0) & (tri < 0)
        act2 = rejected if active is None else rejected & active
        _, tri2_raw = mesh_brute.mesh_intersect(
            scene.bf_feat, scene.bf_clusters, origin, direction, t_init,
            active=act2, any_hit=any_hit, exclude=tri_raw)
        tri2 = _validate_winner(scene.bf_tri_verts, tri2_raw, origin,
                                direction, t_init)
        tri = torch.where(rejected, tri2, tri)
    return tm, tri, scene.bf_tri_verts, scene.bf_tri_normals


def _validate_winner(tri_verts, tri, origin, direction, t_init):
    """Exact f32 re-test of the winning triangle: a winner that fails it
    (grazing den-multiplied false hit) falls back to -1."""
    tv = tri_verts.reshape(-1, 9)[torch.clamp(tri, min=0).long()]
    t_b = torch.broadcast_to(torch.as_tensor(t_init, dtype=torch.float32,
                                             device=tri.device), tri.shape)
    ok, _, _, _ = _tri_intersect(tv[:, 0:3], tv[:, 3:6], tv[:, 6:9],
                                 origin, direction, t_b * (1.0 + 1e-5))
    return torch.where(ok, tri, -1)


def _closest_analytic(cfg: SceneConfig, scene: SceneData, origin, direction,
                      active=None, early_exit: bool = True):
    """Closest hit over the analytic classes, detached -> (t, mesh_id,
    normal).  Every class keeps only a strictly closer hit; the SDF march
    starts with the spheres' t as its limit."""
    origin = origin.detach()
    direction = direction.detach()
    n = origin.shape[0]
    dev = origin.device
    t = torch.full((n,), RAY_INF, dtype=torch.float32, device=dev)
    mesh_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    s0, s1 = 0, cfg.n_spheres
    d0, d1 = s1, s1 + cfg.n_sdfs
    b0, b1 = d1, d1 + cfg.n_boxes
    q0, q1 = b1, b1 + cfg.n_quads
    position = scene.position.detach()
    params = scene.params.detach()
    if cfg.n_spheres:
        ts = sphere_hits(origin, direction, position[s0:s1], params[s0:s1, 0])
        best, arg = torch.min(ts, dim=-1)
        arg = arg.to(torch.int32)
        better = best < t
        t = torch.where(better, best, t)
        mesh_id = torch.where(better, s0 + arg, mesh_id)
        pos = origin + direction * t[..., None]
        ns = normalize(pos - position[s0 + torch.clamp(arg, min=0).long()])
        normal = torch.where(better[..., None], ns, normal)

    if cfg.n_sdfs:
        gt = scene.geom_type[d0:d1]
        tsdf, obj, hit_s = sdf_march(origin, direction, t, position[d0:d1],
                                     gt, params[d0:d1], cfg.marching_steps,
                                     active=active, early_exit=early_exit)
        better = hit_s & (tsdf < t)
        t = torch.where(better, tsdf, t)
        mesh_id = torch.where(better, d0 + obj, mesh_id)
        pos = origin + direction * t[..., None]
        nsdf = sdf_normal(pos, position[d0:d1], gt, params[d0:d1], obj)
        normal = torch.where(better[..., None], nsdf, normal)

    if cfg.n_boxes:
        tb, nb, _ = box_hits(origin, direction, position[b0:b1],
                             params[b0:b1, :3])
        best, arg = torch.min(tb, dim=-1)
        better = best < t
        t = torch.where(better, best, t)
        mesh_id = torch.where(better, b0 + arg.to(torch.int32), mesh_id)
        nsel = nb[torch.arange(n, device=dev), arg]
        normal = torch.where(better[..., None], nsel, normal)

    if cfg.n_quads:
        qn_all = scene.quad_normal.detach()
        tq = quad_hits(origin, direction, scene.quad_base.detach()[q0:q1],
                       scene.quad_edge0.detach()[q0:q1],
                       scene.quad_edge1.detach()[q0:q1], qn_all[q0:q1])
        best, arg = torch.min(tq, dim=-1)
        arg = arg.to(torch.int32)
        better = best < t
        t = torch.where(better, best, t)
        mesh_id = torch.where(better, q0 + arg, mesh_id)
        nq = qn_all[q0 + torch.clamp(arg, min=0).long()]
        normal = torch.where(better[..., None], nq, normal)
    return t, mesh_id, normal


def material_type_of(cfg: SceneConfig, scene: SceneData, mesh_id):
    idx = torch.clamp(mesh_id, 0, scene.mat_type.shape[0] - 1).long()
    t = scene.mat_type[idx]
    if cfg.has_mesh:
        t = torch.where(mesh_id == cfg.n_objects, scene.obj_mat_type, t)
    return torch.where(mesh_id < 0, 0, t)


def _finish_hit(cfg: SceneConfig, scene: SceneData, origin, direction,
                t, mesh_id, normal, tri=None, tvs=None, tns=None) -> Hit:
    """Fold the mesh result into the analytic closest hit and resolve the
    shading normal."""
    t, normal = analytic_reattach(cfg, scene, origin, direction, t,
                                  mesh_id, normal)
    if tri is not None:
        hit_m = tri >= 0
        if not cfg.mesh_vertex_grads:
            tvs = tvs.detach()
            tns = tns.detach()
        tm, u, v = tri_reattach(tvs, tri, origin, direction)
        nm = normalize(bvh_smooth_normal(tns, tri, u, v))
        t = torch.where(hit_m, tm, t)
        mesh_id = torch.where(hit_m, cfg.n_objects, mesh_id)
        normal = torch.where(hit_m[..., None], nm, normal)

    pos = origin + direction * t[..., None]

    # backside resolve: flip the normal against the ray unless the material
    # is purely transmissive dielectric
    mat_t = material_type_of(cfg, scene, mesh_id)
    n_trans = (mat_t & ~(DIEL | ROUGH_DIEL)) != 0
    backside = torch.sum(normal * direction, dim=-1) > 0.0
    flip = n_trans & backside
    normal = torch.where(flip[..., None], -normal, normal)
    tri_out = (torch.full(t.shape, -1, dtype=torch.int32, device=t.device)
               if tri is None else torch.where(tri >= 0, tri, -1))
    return Hit(t, mesh_id, pos, normal, backside, tri_out)


def _shadow_analytic(cfg: SceneConfig, scene: SceneData, origin, direction,
                     max_dist, active=None, early_exit: bool = True):
    """Analytic occlusion tests -> (blocked [N] bool, limit [N]); SDFs
    march with the shadow budget."""
    n = origin.shape[0]
    limit = max_dist * (1.0 - 1e-3)
    blocked = torch.zeros((n,), dtype=torch.bool, device=origin.device)
    s0, s1 = 0, cfg.n_spheres
    d0, d1 = s1, s1 + cfg.n_sdfs
    b0, b1 = d1, d1 + cfg.n_boxes
    q0, q1 = b1, b1 + cfg.n_quads
    if cfg.n_spheres:
        ts = torch.amin(sphere_hits(origin, direction, scene.position[s0:s1],
                                    scene.params[s0:s1, 0]), dim=-1)
        blocked = blocked | (ts < limit)
    if cfg.n_sdfs:
        _, _, hit_s = sdf_march(origin, direction, limit,
                                scene.position[d0:d1], scene.geom_type[d0:d1],
                                scene.params[d0:d1],
                                cfg.shadow_marching_steps, active=active,
                                early_exit=early_exit)
        blocked = blocked | hit_s
    if cfg.n_boxes:
        tb, _, _ = box_hits(origin, direction, scene.position[b0:b1],
                            scene.params[b0:b1, :3])
        blocked = blocked | (torch.amin(tb, dim=-1) < limit)
    if cfg.n_quads:
        tq = torch.amin(quad_hits(origin, direction, scene.quad_base[q0:q1],
                                  scene.quad_edge0[q0:q1],
                                  scene.quad_edge1[q0:q1],
                                  scene.quad_normal[q0:q1]), dim=-1)
        blocked = blocked | (tq < limit)
    return blocked, limit


class DetachedHits(NamedTuple):
    """The detached half of one merged dispatch, about ten words a lane:
    the analytic closest hit, the validated mesh winner and the shadow
    verdicts.  Nothing in it carries a gradient."""
    t: torch.Tensor  # [N] analytic closest t (RAY_INF on miss)
    mesh_id: torch.Tensor  # [N] int32 analytic winner, -1 on miss
    normal: torch.Tensor  # [N,3] analytic winner's normal
    tri: torch.Tensor | None  # [N] int32 mesh winner (-1: none); None without a mesh
    visible: list  # one [N] bool per shadow batch


@spanned("prt.intersect")
@torch.no_grad()
def intersect_and_shadow_detached(cfg: SceneConfig, scene: SceneData,
                                  origin, direction, active, shadow_batches,
                                  exclude_tri=None, early_exit: bool = True
                                  ) -> DetachedHits:
    """Closest hit for one ray batch + occlusion for K shadow batches, with
    the mesh backend invoked ONCE on the concatenated (K+1)N-ray batch
    (per-lane any-hit flag).  Runs without autograd.

    ``shadow_batches``: list of (origin, direction, max_dist, active).
    ``exclude_tri`` may be one [N] row (the same exclusion for every
    segment) or a list of K+1 rows ([closest] + one per shadow batch).
    ``early_exit`` lets the SDF marches stop when every lane is done (a
    host sync every MARCH_EXIT_EVERY steps; the result is the same).
    """
    n = origin.shape[0]
    dev = origin.device
    act_c = (active if active is not None
             else torch.ones((n,), dtype=torch.bool, device=dev))
    t, mesh_id, normal = _closest_analytic(cfg, scene, origin, direction,
                                           active=act_c, early_exit=early_exit)
    blocked, limits, acts = [], [], []
    for (o_s, d_s, dist_s, a_s) in shadow_batches:
        b, lim = _shadow_analytic(cfg, scene, o_s, d_s, dist_s, active=a_s,
                                  early_exit=early_exit)
        a_s = (a_s if a_s is not None
               else torch.ones((o_s.shape[0],), dtype=torch.bool, device=dev))
        blocked.append(b)
        limits.append(lim)
        acts.append(a_s)

    tri = None
    if cfg.has_mesh:
        o_all = torch.cat([origin] + [b[0] for b in shadow_batches])
        d_all = torch.cat([direction] + [b[1] for b in shadow_batches])
        t_all = torch.cat([t] + limits)
        ah_all = torch.cat(
            [torch.zeros((n,), dtype=torch.bool, device=dev)]
            + [torch.ones((b.shape[0],), dtype=torch.bool, device=dev)
               for b in blocked])
        act_all = torch.cat([act_c] + [a & ~b for a, b in zip(acts, blocked)])
        if exclude_tri is None:
            ex_all = None
        elif isinstance(exclude_tri, (list, tuple)):
            if len(exclude_tri) != len(shadow_batches) + 1:
                raise ValueError("exclude_tri list needs one row per segment")
            ex_all = torch.cat(list(exclude_tri))
        else:
            ex_all = exclude_tri.repeat(len(shadow_batches) + 1)
        _, tri_all, _, _ = mesh_closest(cfg, scene, o_all, d_all, t_all,
                                        any_hit=ah_all, active=act_all,
                                        exclude_tri=ex_all)
        tri = tri_all[:n]
        off = n
        for i, b in enumerate(blocked):
            m = b.shape[0]
            blocked[i] = b | (tri_all[off:off + m] >= 0)
            off += m
    return DetachedHits(t, mesh_id, normal, tri, [~b for b in blocked])


@spanned("prt.intersect")
def finish_hit(cfg: SceneConfig, scene: SceneData, origin, direction,
               rec: DetachedHits) -> Hit:
    """The differentiable half: the detached winners reattached to
    ``origin``/``direction`` and the scene tables (analytic_reattach,
    tri_reattach, bvh_smooth_normal)."""
    if rec.tri is None:
        return _finish_hit(cfg, scene, origin, direction, rec.t, rec.mesh_id,
                           rec.normal)
    return _finish_hit(cfg, scene, origin, direction, rec.t, rec.mesh_id,
                       rec.normal, rec.tri, *mesh_tables(cfg, scene))


def intersect_scene(cfg: SceneConfig, scene: SceneData, origin, direction,
                    active=None, exclude_tri=None) -> Hit:
    """Closest hit of one ray batch: the detached dispatch with no shadow
    batch, then ``finish_hit``."""
    rec = intersect_and_shadow_detached(cfg, scene, origin, direction, active,
                                        [], exclude_tri=exclude_tri)
    return finish_hit(cfg, scene, origin, direction, rec)


def intersect_and_shadow(cfg: SceneConfig, scene: SceneData, origin,
                         direction, active, shadow_batches, exclude_tri=None):
    """The reference's merged dispatch in one piece -> (Hit of the closest
    batch, [visible [N] bool per shadow batch])."""
    rec = intersect_and_shadow_detached(cfg, scene, origin, direction, active,
                                        shadow_batches,
                                        exclude_tri=exclude_tri)
    return finish_hit(cfg, scene, origin, direction, rec), rec.visible


@torch.no_grad()
def traversal_cost(cfg: SceneConfig, scene: SceneData, origin, direction):
    """Per-ray traversal work estimate for the debug AOV (the reference's
    VIEW_STACK_INDEX heatmap) -> [N] int32: for the brute backend the
    number of tiles the ray enters (``mesh_brute.ray_cluster_count``), for
    the walk its node visits; 0 without a mesh."""
    n = origin.shape[0]
    if not cfg.has_mesh:
        return torch.zeros((n,), dtype=torch.int32, device=origin.device)
    if cfg.mesh_accel == "bvh":
        return bvh_traverse(scene, origin, direction, RAY_INF,
                            count_steps=True)[4]
    return mesh_brute.ray_cluster_count(scene.bf_clusters, origin, direction,
                                        RAY_INF)


@torch.no_grad()
def shadow_visible(cfg: SceneConfig, scene: SceneData, origin, direction,
                   max_dist, active=None, exclude_tri=None) -> torch.Tensor:
    """True where the segment [origin, origin + direction * max_dist] is
    unoccluded.  The mesh runs last, over only the lanes that are active
    and that no analytic object blocks."""
    blocked, limit = _shadow_analytic(cfg, scene, origin, direction,
                                      max_dist, active=active)
    if cfg.has_mesh:
        act = (active if active is not None
               else torch.ones_like(blocked))
        _, tri, _, _ = mesh_closest(cfg, scene, origin, direction, limit,
                                    any_hit=True, active=act & ~blocked,
                                    exclude_tri=exclude_tri)
        blocked = blocked | (tri >= 0)
    return ~blocked
