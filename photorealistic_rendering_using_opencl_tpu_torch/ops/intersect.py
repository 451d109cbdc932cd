"""Scene intersection for the render path: analytic spheres and quads, and
the triangle mesh through the brute backend (ops/mesh_brute.py).

Port of the slice's subset of
``photorealistic_rendering_using_opencl_tpu/ops/intersect.py``.  The whole
ray batch is intersected against each primitive class with broadcasting
([rays x objects]); the mesh runs once per call on the merged closest-hit +
shadow batch.  Selection is detached; the winner is reattached with
zero-in-primal corrections, ``t_det - (f - f.detach()) / dfdt``, so that
gradients only need autograd switched on.  The merged dispatch comes in two
halves so the differentiable render loops can keep the expensive one out
of their recomputed regions: ``intersect_and_shadow_detached`` (analytic
sweep, shadow tests, the mesh kernel, winner validation; no gradient) and
``finish_hit`` (the reattach functions; every gradient of the geometry
enters here).  The reference's one-piece entry points are those halves in
a row: ``intersect_scene`` (a closest-hit batch alone),
``intersect_and_shadow`` (closest hits and shadow batches), and
``shadow_visible`` (one shadow batch, the mesh last).

SDFs and boxes are ROADMAP M10, the BVH walk M12: a scene with them never
reaches this module (scene/loader.py raises).

Object order is [spheres | sdfs | boxes | quads]; the OBJ triangle mesh
is a virtual object with id == cfg.n_objects.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    EPS, RAY_INF, copysign, cross, fetch_float_rows, normalize,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    DIEL, QUAD, ROUGH_DIEL, SceneConfig, SceneData, SPHERE,
)


class Hit(NamedTuple):
    t: torch.Tensor  # [N] distance (RAY_INF on miss)
    mesh_id: torch.Tensor  # [N] int32; object index, cfg.n_objects for the OBJ
    pos: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3] (shading normal, backside-resolved)
    backside: torch.Tensor  # [N] bool
    # winning triangle index in the brute tables' index space, -1 for
    # analytic/miss; fed back as the next dispatch's self-exclusion
    tri: torch.Tensor = None

    @property
    def valid(self):
        return self.t < RAY_INF


def _check_ported(cfg: SceneConfig) -> None:
    if cfg.n_sdfs or cfg.n_boxes:
        raise NotImplementedError("SDFs and boxes are ROADMAP M10")
    if cfg.has_mesh and cfg.mesh_accel != "brute":
        raise NotImplementedError("the BVH walk (mesh_accel='bvh') is "
                                  "ROADMAP M12")


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
    the surface (spheres and quads; SDFs and boxes are ROADMAP M10)."""
    rel = p - c
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    if cfg.n_quads:
        anchor = qb - (qe0 + qe1) * 0.5
        out = torch.where((gt & QUAD) != 0,
                          torch.sum(qn * (p - anchor), dim=-1), out)
    if cfg.n_spheres:
        out = torch.where((gt & SPHERE) != 0,
                          torch.sum(rel * rel, dim=-1) - prm[:, 0] * prm[:, 0],
                          out)
    return out


def _surface_dfdt(cfg, gt, p, c, qn, d):
    """dF/dt along the ray for ``_surface_f`` (detached)."""
    out = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    if cfg.n_quads:
        out = torch.where((gt & QUAD) != 0, torch.sum(qn * d, dim=-1), out)
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
    dfdt = _surface_dfdt(cfg, gt, p_sg, c.detach(), qn.detach(),
                         direction.detach())
    dfdt = torch.where(torch.abs(dfdt) < 1e-6, copysign(1e-6, dfdt), dfdt)

    t_re = t_det - torch.where(analytic, f - f.detach(), 0.0) / dfdt

    n_dif = normal_det.detach()
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


def mesh_closest(cfg: SceneConfig, scene: SceneData, origin, direction,
                 t_init, any_hit=False, active=None, exclude_tri=None):
    """Mesh intersection through the brute backend.

    Returns (t_detached [N], tri [N], tri_verts, tri_normals), tables in
    ``tri``'s index space; tri == -1 where nothing beats ``t_init``.
    ``exclude_tri`` ([N] int32, -1 = none) removes one triangle per lane
    (self-exclusion for rays leaving a mesh surface).

    With ``cfg.mesh_sort_rays`` and rays for the kernel
    (``mesh_brute.uses_kernel``), the batch goes to K1 sorted by
    ``ray_sort_key``, so that a warp's rays need the same tiles, and the
    outputs come back in lane order: every per-lane input is permuted, and
    the results are bitwise the unsorted ones, since the tile prune is
    conservative per lane.  The sort is stable (``torch.argsort`` is not by
    default; ``jnp.argsort`` is): camera rays share one origin cell, and
    only a stable sort keeps them in pixel order within an octant.  The
    reference's other TPU-only backstop, ``mesh_second_pass``, is not
    ported: it repairs the TPU kernel's reduced-precision matmul, which K1
    does not have.
    """
    _check_ported(cfg)
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
                      active=None):
    """Closest hit over the analytic classes, detached -> (t, mesh_id,
    normal).  Every class keeps only a strictly closer hit."""
    _check_ported(cfg)
    origin = origin.detach()
    direction = direction.detach()
    n = origin.shape[0]
    dev = origin.device
    t = torch.full((n,), RAY_INF, dtype=torch.float32, device=dev)
    mesh_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    normal = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    s0, s1 = 0, cfg.n_spheres
    q0 = s1 + cfg.n_sdfs + cfg.n_boxes
    q1 = q0 + cfg.n_quads
    position = scene.position.detach()
    if cfg.n_spheres:
        ts = sphere_hits(origin, direction, position[s0:s1],
                         scene.params.detach()[s0:s1, 0])
        best, arg = torch.min(ts, dim=-1)
        arg = arg.to(torch.int32)
        better = best < t
        t = torch.where(better, best, t)
        mesh_id = torch.where(better, s0 + arg, mesh_id)
        pos = origin + direction * t[..., None]
        ns = normalize(pos - position[s0 + torch.clamp(arg, min=0).long()])
        normal = torch.where(better[..., None], ns, normal)

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
                     max_dist, active=None):
    """Analytic occlusion tests -> (blocked [N] bool, limit [N])."""
    _check_ported(cfg)
    n = origin.shape[0]
    limit = max_dist * (1.0 - 1e-3)
    blocked = torch.zeros((n,), dtype=torch.bool, device=origin.device)
    s0, s1 = 0, cfg.n_spheres
    q0 = s1 + cfg.n_sdfs + cfg.n_boxes
    q1 = q0 + cfg.n_quads
    if cfg.n_spheres:
        ts = torch.amin(sphere_hits(origin, direction, scene.position[s0:s1],
                                    scene.params[s0:s1, 0]), dim=-1)
        blocked = blocked | (ts < limit)
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


@torch.no_grad()
def intersect_and_shadow_detached(cfg: SceneConfig, scene: SceneData,
                                  origin, direction, active, shadow_batches,
                                  exclude_tri=None) -> DetachedHits:
    """Closest hit for one ray batch + occlusion for K shadow batches, with
    the mesh backend invoked ONCE on the concatenated (K+1)N-ray batch
    (per-lane any-hit flag).  Runs without autograd.

    ``shadow_batches``: list of (origin, direction, max_dist, active).
    ``exclude_tri`` may be one [N] row (the same exclusion for every
    segment) or a list of K+1 rows ([closest] + one per shadow batch).
    """
    n = origin.shape[0]
    dev = origin.device
    act_c = (active if active is not None
             else torch.ones((n,), dtype=torch.bool, device=dev))
    t, mesh_id, normal = _closest_analytic(cfg, scene, origin, direction,
                                           active=act_c)
    blocked, limits, acts = [], [], []
    for (o_s, d_s, dist_s, a_s) in shadow_batches:
        b, lim = _shadow_analytic(cfg, scene, o_s, d_s, dist_s, active=a_s)
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


def finish_hit(cfg: SceneConfig, scene: SceneData, origin, direction,
               rec: DetachedHits) -> Hit:
    """The differentiable half: the detached winners reattached to
    ``origin``/``direction`` and the scene tables (analytic_reattach,
    tri_reattach, bvh_smooth_normal)."""
    if rec.tri is None:
        return _finish_hit(cfg, scene, origin, direction, rec.t, rec.mesh_id,
                           rec.normal)
    return _finish_hit(cfg, scene, origin, direction, rec.t, rec.mesh_id,
                       rec.normal, rec.tri, scene.bf_tri_verts,
                       scene.bf_tri_normals)


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
    VIEW_STACK_INDEX heatmap) -> [N] int32: the number of tiles the ray
    enters (``mesh_brute.ray_cluster_count``), 0 without a mesh.  The bvh
    backend's node-visit count needs the BVH walk, ROADMAP M12."""
    n = origin.shape[0]
    if not cfg.has_mesh:
        return torch.zeros((n,), dtype=torch.int32, device=origin.device)
    if cfg.mesh_accel != "brute":
        raise NotImplementedError("traversal_cost for mesh_accel="
                                  f"{cfg.mesh_accel!r} needs the BVH walk, "
                                  "ROADMAP M12")
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
