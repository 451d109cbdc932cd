"""Bidirectional path tracing: batched camera and light subpaths, every
(s, t) connection accumulated in-lane.

Port of ``photorealistic_rendering_using_opencl_tpu/models/bidirectional.py``
(``SubPath``, ``_a``, ``_light_area_and_emission``, ``sample_light_point``,
``gen_camera_subpath``, ``gen_light_subpath``, ``_stack``, ``_remap0``,
``_mis_weight``, ``trace``).  Every lane owns one pixel sample; the camera
and light subpaths are fixed-depth [N, D, ...] arrays; the strategies are
s = 0 (the camera subpath hits a light), s = 1 (a camera vertex connected
to a uniform-area sample of the NEE light) and s >= 2 (a camera vertex
connected to a light-subpath vertex), weighted by the balance heuristic
over the included strategies.  The lens strategies t = 0 and t = 1 are
excluded, as in the reference, and so is the global medium.

One change of schedule, none of result: the reference tests each
strategy's connection with its own ``shadow_visible`` call (21 mesh
dispatches at depth 6).  Here ``trace`` first computes every connection's
contribution and MIS weight, then tests all of them in ONE
``shadow_visible`` call on the concatenated lanes (``connection_visible``;
a lane's verdict depends on that lane alone), then accumulates in the
reference's (t, s) order, so the sum is bitwise the per-strategy one.  On
a mesh scene a sample runs the mesh backend (K1 or W1 on the card) for
each camera vertex, each light vertex past the first and the one merged
connection batch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photorealistic_rendering_using_opencl_tpu_torch.models.integrator import (
    CAMERA_DIMS, DIMS_PER_BOUNCE, gather_material,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops import bsdf as bsdf_ops
from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import (
    intersect_scene, shadow_visible,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    PI, to_global, to_local,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.ops.sampling import (
    cosine_hemisphere, uniform_sphere,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    LIGHT, SceneConfig, SceneData, SPECULAR_LOBE, SPHERE,
)

_LIGHT_DIM0 = 4096  # RNG dim window for the light subpath (4-aligned)
DEFAULT_DEPTH_CAP = 6


class SubPath(NamedTuple):
    """Fixed-depth vertex arrays; index 0 = first stored vertex."""
    pos: torch.Tensor      # [N,D,3]
    normal: torch.Tensor   # [N,D,3] shading normal (faces the arriving ray)
    wi: torch.Tensor       # [N,D,3] unit vector toward the PREVIOUS vertex
    beta: torch.Tensor     # [N,D,3] throughput up to (and incl.) this vertex
    pdf_fwd: torch.Tensor  # [N,D] area pdf of sampling this vertex forward
    pdf_rev: torch.Tensor  # [N,D] area pdf of this vertex from the NEXT one
    mesh_id: torch.Tensor  # [N,D]
    spec: torch.Tensor     # [N,D] sampled lobe here was Dirac
    is_light: torch.Tensor  # [N,D] vertex lies on an emitter
    valid: torch.Tensor    # [N,D]


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _a(pdf_solid, from_pos, to_pos, to_normal):
    """Solid-angle pdf at from_pos -> area pdf at to_pos."""
    seg = to_pos - from_pos
    d2 = torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-12)
    w = seg / torch.sqrt(d2)[..., None]
    return pdf_solid * torch.abs(torch.sum(w * to_normal, dim=-1)) / d2


def _light_area_and_emission(cfg: SceneConfig, scene: SceneData):
    li = scene.light_indices[0].long()
    gt = scene.geom_type[li]
    r = scene.params[li, 0]
    sphere_area = 4.0 * PI * r * r
    is_sphere = (gt & SPHERE) != 0
    area = torch.where(is_sphere, sphere_area, scene.quad_area[li])
    return li, is_sphere, area, scene.color[li]


def sample_light_point(cfg: SceneConfig, scene: SceneData, u1, u2):
    """Uniform-area point on the NEE light -> (pos, normal, pdf_A, Le)."""
    li, is_sphere, area, le = _light_area_and_emission(cfg, scene)
    sd = uniform_sphere(u1, u2)
    sp = scene.position[li] + sd * scene.params[li, 0]
    anchor = (scene.quad_base[li]
              - (scene.quad_edge0[li] + scene.quad_edge1[li]) * 0.5)
    qp = (anchor + u1[..., None] * scene.quad_edge0[li]
          + u2[..., None] * scene.quad_edge1[li])
    pos = torch.where(is_sphere, sp, qp)
    nrm = torch.where(is_sphere, sd,
                      torch.broadcast_to(scene.quad_normal[li], sd.shape))
    pdf_a = torch.ones(u1.shape, dtype=torch.float32, device=u1.device) / area
    return pos, nrm, pdf_a, le


def gen_camera_subpath(cfg, scene, origin, direction, sampler_fn, depth):
    """Trace ``depth`` camera-side vertices (the lens vertex is implicit).

    sampler_fn(bounce) -> Sampler for that vertex's decisions.
    """
    n = origin.shape[0]
    dev = origin.device
    recs = []
    pdf_rev = [torch.zeros((n,), dtype=torch.float32, device=dev)
               for _ in range(depth)]
    o, d = origin, direction
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    pdf_next_solid = torch.ones((n,), dtype=torch.float32, device=dev)
    prev_pos = origin

    for i in range(depth):
        hit = intersect_scene(cfg, scene, o, d, active=alive)
        mat = gather_material(cfg, scene, hit.mesh_id)
        v_light = (mat.mat_type & LIGHT) != 0
        valid = alive & hit.valid

        pdf_fwd = (torch.ones((n,), dtype=torch.float32, device=dev) if i == 0
                   else _a(pdf_next_solid, prev_pos, hit.pos, hit.normal))

        smp = sampler_fn(i)
        u0, u1, u2 = smp.nextnd(3)
        wi_l = to_local(hit.normal, -d)
        samp = bsdf_ops.sample(cfg, mat, wi_l, hit.backside, hit.t,
                               u0, u1, u2)
        new_dir = to_global(hit.normal, samp.wo)
        spec = ((samp.lobe & SPECULAR_LOBE) != 0) & ~v_light

        if i > 0:
            # reverse pdf of the PREVIOUS vertex given this scatter
            pdf_rev_solid = bsdf_ops.pdf(cfg, mat, samp.wo, wi_l)
            pdf_rev[i - 1] = _a(pdf_rev_solid, hit.pos, prev_pos,
                                recs[i - 1][1])

        recs.append((hit.pos, hit.normal, -d, beta, pdf_fwd,
                     hit.mesh_id, spec, v_light, valid))

        beta = beta * torch.where(valid[..., None], samp.weight, 1.0)
        alive = valid & ~v_light & samp.valid
        pdf_next_solid = samp.pdf
        prev_pos = o = hit.pos
        d = new_dir

    return _stack(recs, pdf_rev)


def gen_light_subpath(cfg, scene, pixel_idx, sample_idx, seed, rng_scheme,
                      depth):
    n = pixel_idx.shape[0]
    dev = pixel_idx.device
    smp0 = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                   dim=_LIGHT_DIM0)
    u1, u2, ud1, ud2 = smp0.nextnd(4)
    lpos, lnrm, pdf_a, le = sample_light_point(cfg, scene, u1, u2)

    recs = []
    pdf_rev = [torch.zeros((n,), dtype=torch.float32, device=dev)
               for _ in range(depth)]
    beta = torch.broadcast_to(le, (n, 3)) / pdf_a[..., None]
    ones_b = torch.ones((n,), dtype=torch.bool, device=dev)
    recs.append((lpos, lnrm, lnrm, beta, pdf_a,
                 torch.broadcast_to(scene.light_indices[0], (n,)),
                 torch.zeros((n,), dtype=torch.bool, device=dev), ones_b,
                 ones_b))

    # cosine emission direction (diffuse emitter)
    wo = cosine_hemisphere(ud1, ud2)
    d = to_global(lnrm, wo)
    pdf_dir = torch.clamp(wo[..., 2], min=1e-9) / PI
    # transport: Le picked up in beta[0]; directional term cos/pdf_dir
    beta = beta * (wo[..., 2] / torch.clamp(pdf_dir, min=1e-12))[..., None]
    o = lpos
    prev_pos = lpos
    pdf_next_solid = pdf_dir
    alive = ones_b

    for i in range(1, depth):
        hit = intersect_scene(cfg, scene, o, d, active=alive)
        mat = gather_material(cfg, scene, hit.mesh_id)
        v_light = (mat.mat_type & LIGHT) != 0
        valid = alive & hit.valid & ~v_light  # light-path re-hit: drop

        pdf_fwd = _a(pdf_next_solid, prev_pos, hit.pos, hit.normal)

        smp = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                      dim=_LIGHT_DIM0 + i * 4)
        u0, u1, u2 = smp.nextnd(3)
        wi_l = to_local(hit.normal, -d)
        samp = bsdf_ops.sample(cfg, mat, wi_l, hit.backside, hit.t,
                               u0, u1, u2)
        new_dir = to_global(hit.normal, samp.wo)
        spec = (samp.lobe & SPECULAR_LOBE) != 0

        pdf_rev_solid = bsdf_ops.pdf(cfg, mat, samp.wo, wi_l)
        prev_n = recs[i - 1][1]
        pdf_rev[i - 1] = _a(pdf_rev_solid, hit.pos, prev_pos, prev_n)

        recs.append((hit.pos, hit.normal, -d, beta, pdf_fwd,
                     hit.mesh_id, spec, v_light, valid))

        beta = beta * torch.where(valid[..., None], samp.weight, 1.0)
        alive = valid & samp.valid
        pdf_next_solid = samp.pdf
        prev_pos = o = hit.pos
        d = new_dir

    return _stack(recs, pdf_rev)


def _stack(recs, pdf_rev):
    cols = list(zip(*recs))
    (pos, normal, wi, beta, pdf_fwd, mesh_id, spec, is_light,
     valid) = (torch.stack(c, dim=1) for c in cols)
    return SubPath(pos, normal, wi, beta, pdf_fwd,
                   torch.stack(pdf_rev, dim=1), mesh_id, spec, is_light,
                   valid)


def _remap0(x):
    return torch.where(x > 0.0, x, 1.0)


def _mis_weight(cam: SubPath, lig: SubPath, s: int, t: int,
                pdf_rev_pt, pdf_rev_ptm, pdf_rev_qs, pdf_rev_qsm):
    """Balance-heuristic weight for strategy (s light, t camera vertices).

    pdf_rev_* are the junction patches (area pdfs); arrays [N].  Stored
    per-vertex pdf_rev entries hold "pdf of THIS vertex as seen from the
    next one along its own subpath"; patches replace the four entries
    adjacent to the junction.
    """
    sum_ri = torch.zeros(pdf_rev_pt.shape, dtype=torch.float32,
                         device=pdf_rev_pt.device)

    # camera side: splits moving the junction toward the camera
    ri = torch.ones_like(sum_ri)
    for i in range(t - 1, 0, -1):
        rev = pdf_rev_pt if i == t - 1 else (
            pdf_rev_ptm if i == t - 2 else cam.pdf_rev[:, i])
        ri = ri * _remap0(rev) / _remap0(cam.pdf_fwd[:, i])
        ok = ~cam.spec[:, i] & ~cam.spec[:, i - 1]
        sum_ri = sum_ri + torch.where(ok, ri, 0.0)

    # light side: splits moving the junction toward the light
    ri = torch.ones_like(sum_ri)
    for i in range(s - 1, -1, -1):
        rev = pdf_rev_qs if i == s - 1 else (
            pdf_rev_qsm if i == s - 2 else lig.pdf_rev[:, i])
        ri = ri * _remap0(rev) / _remap0(lig.pdf_fwd[:, i])
        prev_spec = (lig.spec[:, i - 1] if i > 0
                     else torch.zeros(sum_ri.shape, dtype=torch.bool,
                                      device=sum_ri.device))
        ok = ~lig.spec[:, i] & ~prev_spec
        sum_ri = sum_ri + torch.where(ok, ri, 0.0)

    return 1.0 / (1.0 + sum_ri)


class Connection(NamedTuple):
    """One (s, t) strategy's connection, before its visibility test."""
    origin: torch.Tensor  # [N,3] the camera vertex
    direction: torch.Tensor  # [N,3] unit, toward the light-side vertex
    dist: torch.Tensor  # [N]
    cand: torch.Tensor  # [N] bool: the connection can carry light
    value: torch.Tensor  # [N,3] contribution times its MIS weight


@torch.no_grad()
def connection_visible(cfg: SceneConfig, scene: SceneData, conns) -> list:
    """Every connection's visibility from ONE ``shadow_visible`` call on the
    concatenated lanes -> one [N] bool per connection, each bitwise what
    ``shadow_visible`` gives that connection alone."""
    if not conns:
        return []
    vis = shadow_visible(cfg, scene,
                         torch.cat([c.origin for c in conns]),
                         torch.cat([c.direction for c in conns]),
                         torch.cat([c.dist for c in conns]),
                         active=torch.cat([c.cand for c in conns]))
    return list(torch.split(vis, [c.cand.shape[0] for c in conns]))


def trace(cfg: SceneConfig, scene: SceneData, origin, direction,
          pixel_idx, sample_idx, seed=0, rng_scheme: str = "pcg4d",
          max_depth: int | None = None):
    """BDPT estimate per lane -> radiance [N,3].

    Paths with 1..b surface vertices ending on the light, where
    b = min(cfg.max_bounces, DEFAULT_DEPTH_CAP) unless ``max_depth``
    overrides it: scenes with deeper budgets (cornell.json: 32) render a
    TRUNCATED path space by default (``pathtracer.render_sample`` warns).
    The cost is quadratic in the depth: b * (b + 1) / 2 connections.
    """
    b = int(min(cfg.max_bounces, DEFAULT_DEPTH_CAP)
            if max_depth is None else max_depth)
    t_max = b + 1  # allow the s=0 strategy to reach the light
    s_max = b      # q0 on the light + up to b-1 surface vertices
    n = origin.shape[0]
    dev = origin.device

    def cam_sampler(i):
        return Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                       dim=CAMERA_DIMS + i * DIMS_PER_BOUNCE)

    cam = gen_camera_subpath(cfg, scene, origin, direction, cam_sampler,
                             t_max)
    lig = gen_light_subpath(cfg, scene, pixel_idx, sample_idx, seed,
                            rng_scheme, s_max)
    li, is_sphere, area, le = _light_area_and_emission(cfg, scene)
    pdf_a_light = 1.0 / area
    ones = torch.ones((n,), dtype=torch.float32, device=dev)
    zeros_b = torch.zeros((n,), dtype=torch.bool, device=dev)

    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    # ---------------- s = 0: camera path hits the light ------------------
    for t in range(2, t_max + 1):
        vi = t - 1
        on_light = cam.valid[:, vi] & cam.is_light[:, vi]
        # patches: pt.rev = area pdf of sampling this light point;
        # ptMinus.rev = emission-direction pdf at the light -> area at ptm
        pdf_rev_pt = torch.broadcast_to(pdf_a_light, (n,))
        seg = cam.pos[:, vi - 1] - cam.pos[:, vi]
        dist = torch.clamp(_norm(seg), min=1e-9)
        wdir = seg / dist[..., None]
        cos_l = torch.abs(torch.sum(wdir * cam.normal[:, vi], dim=-1))
        pdf_dir = cos_l / PI
        pdf_rev_ptm = _a(pdf_dir, cam.pos[:, vi], cam.pos[:, vi - 1],
                         cam.normal[:, vi - 1])
        w = _mis_weight(cam, lig, 0, t, pdf_rev_pt, pdf_rev_ptm, ones, ones)
        # a path ending on a light other than the NEE light is samplable by
        # NO other included strategy: its weight is exactly 1
        is_nee_light = cam.mesh_id[:, vi] == li
        w = torch.where(is_nee_light, w, 1.0)
        le_hit = gather_material(cfg, scene, cam.mesh_id[:, vi]).color
        contrib = cam.beta[:, vi] * le_hit
        acc = acc + torch.where(on_light[..., None],
                                contrib * w[..., None], 0.0)

    # ---------------- s >= 1 connections ---------------------------------
    conns = []
    for t in range(1, t_max + 1):
        vi = t - 1
        p_ok = cam.valid[:, vi] & ~cam.is_light[:, vi] & ~cam.spec[:, vi]
        p_pos = cam.pos[:, vi]
        p_n = cam.normal[:, vi]
        p_mat = gather_material(cfg, scene, cam.mesh_id[:, vi])
        p_wi = to_local(p_n, cam.wi[:, vi])

        for s in range(1, s_max + 1):
            if (t - 1) + (s - 1) + 1 > b:  # surface-vertex budget
                continue
            qi = s - 1
            q_ok = lig.valid[:, qi] & (True if s == 1 else ~lig.spec[:, qi])
            q_pos = lig.pos[:, qi]
            q_n = lig.normal[:, qi]

            seg = q_pos - p_pos
            d2 = torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-12)
            dist = torch.sqrt(d2)
            wdir = seg / dist[..., None]

            f_p = bsdf_ops.evaluate(cfg, p_mat, p_wi, to_local(p_n, wdir),
                                    zeros_b, ones)
            cos_q = torch.sum(-wdir * q_n, dim=-1)
            if s == 1:
                # emitter: radiance only into its front hemisphere
                f_q = torch.where(cos_q[..., None] > 0.0, 1.0, 0.0)
                f_q_scale = torch.abs(cos_q) / d2
            else:
                q_mat = gather_material(cfg, scene, lig.mesh_id[:, qi])
                q_wi = to_local(q_n, lig.wi[:, qi])
                f_q = bsdf_ops.evaluate(cfg, q_mat, q_wi,
                                        to_local(q_n, -wdir), zeros_b, ones)
                f_q_scale = 1.0 / d2  # both cosines live in the two evals

            cand = p_ok & q_ok & (torch.sum(f_p * f_p, dim=-1) > 0.0)
            contrib = (cam.beta[:, vi] * f_p * f_q * lig.beta[:, qi]
                       * f_q_scale[..., None])

            # --- junction pdf patches (area measure) ---
            if s == 1:
                pdf_q_to_p = torch.clamp(cos_q, min=0.0) / PI
            else:
                pdf_q_to_p = bsdf_ops.pdf(cfg, q_mat, q_wi,
                                          to_local(q_n, -wdir))
            pdf_rev_pt = _a(pdf_q_to_p, q_pos, p_pos, p_n)
            if t >= 2:
                pdf_p_back = bsdf_ops.pdf(cfg, p_mat, to_local(p_n, wdir),
                                          p_wi)
                pdf_rev_ptm = _a(pdf_p_back, p_pos, cam.pos[:, vi - 1],
                                 cam.normal[:, vi - 1])
            else:
                pdf_rev_ptm = ones
            pdf_p_to_q = bsdf_ops.pdf(cfg, p_mat, p_wi, to_local(p_n, wdir))
            pdf_rev_qs = _a(pdf_p_to_q, p_pos, q_pos, q_n)
            if s >= 2:
                pdf_q_back = bsdf_ops.pdf(cfg, q_mat, to_local(q_n, -wdir),
                                          q_wi)
                pdf_rev_qsm = _a(pdf_q_back, q_pos, lig.pos[:, qi - 1],
                                 lig.normal[:, qi - 1])
            else:
                pdf_rev_qsm = ones

            w = _mis_weight(cam, lig, s, t, pdf_rev_pt, pdf_rev_ptm,
                            pdf_rev_qs, pdf_rev_qsm)
            conns.append(Connection(p_pos, wdir, dist, cand,
                                    contrib * w[..., None]))

    for c, vis in zip(conns, connection_visible(cfg, scene, conns)):
        acc = acc + torch.where((c.cand & vis)[..., None], c.value, 0.0)
    return acc
