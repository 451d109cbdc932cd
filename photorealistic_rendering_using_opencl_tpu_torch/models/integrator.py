"""Path-tracing integrator: one shading event for every lane of a batch.

Port of the render-path parts of
``photorealistic_rendering_using_opencl_tpu/models/integrator.py``:
``PathState``, ``init_state``, ``gather_material``, ``NeeBatch``,
``accumulate_nee``, ``shade_step``, ``_self_exclusion``, ``_sanitize_grad``
and ``SCAN_CHUNK``.  The reference's ``tag_hit`` names the intersection
results for its rematerialisation policy; here the render loop splits the
intersection into a detached half, which no checkpoint recomputes, and a
differentiable half (models/pathtracer.py), so nothing needs a name.
All lanes advance together under masks.  Light hits found by BSDF sampling
are weighted by the power heuristic against the carried previous pdf, and
NEE shadow rays are returned deferred so the render loop can merge them
into one mesh dispatch.  The medium and environment-map branches of the reference
are ROADMAP M11; ``shade_step`` raises on a scene that needs them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import bsdf as bsdf_ops, lights
from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import Hit
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    fetch_float_rows, fmax3, power_heuristic, to_global, to_local,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    DIFFUSE_REFLECTION_LOBE, GLOSSY_REFLECTION_LOBE, LIGHT,
    SceneConfig, SceneData, SPECULAR_LOBE, SPECULAR_REFLECTION_LOBE,
    TRANSMISSIVE_LOBE,
)

# random-dimension layout: dims [0,8) belong to the camera; each bounce
# consumes a fixed window so streams are schedule-invariant
CAMERA_DIMS = 8
DIMS_PER_BOUNCE = 16

# iterations per chunk of the differentiable regeneration loop: a budget
# above one chunk is rounded up to a whole number of chunks, as the
# reference's nested scan does (its sweep chose 8)
SCAN_CHUNK = 8


class PathState(NamedTuple):
    origin: torch.Tensor  # [N,3]
    direction: torch.Tensor  # [N,3]
    mask: torch.Tensor  # [N,3] throughput
    acc: torch.Tensor  # [N,3] accumulated radiance
    alpha: torch.Tensor  # [N]
    alive: torch.Tensor  # [N] bool
    prev_pdf: torch.Tensor  # [N] pdf of the strategy that chose dir
    prev_specular: torch.Tensor  # [N] bool (Dirac lobe -> no MIS)
    prev_did_nee: torch.Tensor  # [N] bool (light sampling ran at prev vertex)
    n_diff: torch.Tensor  # [N] int32 lobe-class bounce counters
    n_spec: torch.Tensor
    n_trans: torch.Tensor
    n_scatter: torch.Tensor
    n_total: torch.Tensor


def init_state(origin, direction) -> PathState:
    n = origin.shape[0]
    dev = origin.device
    f1 = torch.ones((n,), dtype=torch.float32, device=dev)
    i0 = torch.zeros((n,), dtype=torch.int32, device=dev)
    return PathState(
        origin=origin, direction=direction,
        mask=torch.ones((n, 3), dtype=torch.float32, device=dev),
        acc=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        alpha=f1,
        alive=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_pdf=f1,
        prev_specular=torch.ones((n,), dtype=torch.bool, device=dev),
        prev_did_nee=torch.zeros((n,), dtype=torch.bool, device=dev),
        n_diff=i0, n_spec=i0, n_trans=i0, n_scatter=i0, n_total=i0,
    )


def gather_material(cfg: SceneConfig, scene: SceneData, mesh_id
                    ) -> bsdf_ops.MatProps:
    """Per-ray material fetch; the OBJ mesh (id == n_objects) uses the obj_*
    slots, packed as the last row of one [K(+1), 10] float table."""
    k_obj = scene.mat_type.shape[0]
    idx = torch.clamp(mesh_id, 0, k_obj - 1).long()
    rows = torch.cat(
        [scene.color, scene.eta, scene.k, scene.roughness[:, None]], dim=1)
    fidx = idx
    if cfg.has_mesh:
        obj_row = torch.cat(
            [scene.obj_color, scene.obj_eta, scene.obj_k,
             scene.obj_roughness[None]])
        rows = torch.cat([rows, obj_row[None]], dim=0)
        fidx = torch.where(mesh_id == cfg.n_objects, k_obj, idx)
    vals = fetch_float_rows(rows, fidx)  # [N,10]
    props = bsdf_ops.MatProps(
        color=vals[:, 0:3], eta=vals[:, 3:6], k=vals[:, 6:9],
        roughness=vals[:, 9],
        mat_type=scene.mat_type[idx], lobes=scene.lobes[idx],
        dist=scene.dist[idx],
    )
    if cfg.has_mesh:
        is_obj = mesh_id == cfg.n_objects
        props = props._replace(
            mat_type=torch.where(is_obj, scene.obj_mat_type, props.mat_type),
            lobes=torch.where(is_obj, scene.obj_lobes, props.lobes),
            dist=torch.where(is_obj, scene.obj_dist, props.dist),
        )
    return props


class NeeBatch(NamedTuple):
    """A deferred next-event-estimation shadow batch: ``weighted`` is the
    throughput-premultiplied contribution, added where active & visible."""
    origin: torch.Tensor  # [N,3]
    direction: torch.Tensor  # [N,3]
    dist: torch.Tensor  # [N]
    active: torch.Tensor  # [N] bool (pre-visibility take mask)
    weighted: torch.Tensor  # [N,3]


def accumulate_nee(state: PathState, nee_batches, vis_list) -> PathState:
    acc = state.acc
    for b, vis in zip(nee_batches, vis_list):
        acc = acc + torch.where((b.active & vis)[..., None], b.weighted, 0.0)
    return state._replace(acc=acc)


def _where_i(cond, a, b):
    return torch.where(cond, a, b).to(torch.int32)


def shade_step(cfg: SceneConfig, scene: SceneData, state: PathState,
               hit: Hit, sampler: Sampler):
    """Advance every live path by one surface event.

    Takes the intersection of ``state``'s current ray and returns
    ``(state, nee_batches)``: the state holds the NEXT ray, and the NEE
    shadow batches wait for the render loop's merged dispatch and
    ``accumulate_nee``.
    """
    if cfg.has_global_medium or cfg.has_env_map:
        raise NotImplementedError("media and environment maps are "
                                  "ROADMAP M11")
    mat = gather_material(cfg, scene, hit.mesh_id)
    alive = state.alive
    nee_batches = []
    acc = state.acc
    mask = state.mask
    alpha = state.alpha

    surface = alive

    # ---------------- miss ----------------
    missed = surface & ~hit.valid
    if cfg.alpha_testing:
        # coverage alpha: transparent only when the PRIMARY ray escapes
        primary = (state.n_total == 0) & (state.n_scatter == 0)
        alpha = torch.where(missed & primary, 0.0, alpha)

    # ---------------- light hit (+ BSDF-sampling MIS) ----------------
    is_light = surface & hit.valid & ((mat.mat_type & LIGHT) != 0)
    if cfg.n_lights > 0:
        if cfg.pick_random_light and cfg.n_lights > 1:
            # the light strategy's pdf includes the uniform pick probability
            d_pdf = lights.direct_pdf(
                cfg, scene,
                torch.clamp(hit.mesh_id, 0, scene.mat_type.shape[0] - 1).long(),
                state.origin, state.direction) / cfg.n_lights
            nee_able = is_light
        else:
            # only light_indices[0] is ever NEE-sampled: other lights get
            # full BSDF weight
            li0 = scene.light_indices[:1].long()
            d_pdf = lights.direct_pdf(cfg, scene, li0, state.origin,
                                      state.direction)
            nee_able = is_light & (hit.mesh_id == li0)
        w_mis = torch.where(state.prev_specular | ~state.prev_did_nee
                            | ~nee_able,
                            1.0,
                            power_heuristic(state.prev_pdf, d_pdf))
        if not cfg.enable_light_sampling:
            w_mis = torch.ones_like(w_mis)
        acc = acc + torch.where(is_light[..., None],
                                mask * mat.color * w_mis[..., None], 0.0)

    # ---------------- surface scatter ----------------
    shade = surface & hit.valid & ~is_light
    wi = to_local(hit.normal, -state.direction)

    u_pick, ul1, ul2 = sampler.nextnd(3)
    did_nee = torch.zeros_like(shade)
    if cfg.enable_light_sampling and cfg.n_lights > 0:
        li, pick_pdf = lights.pick_light(cfg, scene, u_pick)
        rec = lights.sample_direct(cfg, scene, li, hit.pos, ul1, ul2)
        nee_ok = shade & bsdf_ops.nee_capable(mat) & rec.valid
        wo_l = to_local(hit.normal, rec.d)
        f = bsdf_ops.evaluate(cfg, mat, wi, wo_l, hit.backside, hit.t)
        b_pdf = bsdf_ops.pdf(cfg, mat, wi, wo_l)
        nonzero = torch.sum(f * f, dim=-1) > 0.0
        light_col = scene.color[li]
        contrib = light_col * f
        pdf_safe = torch.where(rec.valid, torch.clamp(rec.pdf, min=1e-12), 1.0)
        contrib = contrib * (power_heuristic(rec.pdf, b_pdf)
                             / pdf_safe)[..., None]
        contrib = contrib / pick_pdf
        take = nee_ok & nonzero
        nee_batches.append(NeeBatch(origin=hit.pos, direction=rec.d,
                                    dist=rec.dist, active=take,
                                    weighted=mask * contrib))
        did_nee = shade & bsdf_ops.nee_capable(mat)

    u0, u1, u2 = sampler.nextnd(3)
    samp = bsdf_ops.sample(cfg, mat, wi, hit.backside, hit.t, u0, u1, u2)
    new_dir = to_global(hit.normal, samp.wo)
    bsdf_dead = shade & ~samp.valid

    mask = torch.where(shade[..., None], mask * samp.weight, mask)
    state = state._replace(
        origin=torch.where(shade[..., None], hit.pos, state.origin),
        direction=torch.where(shade[..., None], new_dir, state.direction),
        prev_pdf=torch.where(shade, samp.pdf, state.prev_pdf),
        prev_specular=torch.where(shade, (samp.lobe & SPECULAR_LOBE) != 0,
                                  state.prev_specular),
        prev_did_nee=torch.where(shade, did_nee, state.prev_did_nee),
        n_diff=state.n_diff + _where_i(
            shade & ((samp.lobe & (DIFFUSE_REFLECTION_LOBE
                                   | GLOSSY_REFLECTION_LOBE)) != 0), 1, 0),
        n_spec=state.n_spec + _where_i(
            shade & ((samp.lobe & SPECULAR_REFLECTION_LOBE) != 0), 1, 0),
        n_trans=state.n_trans + _where_i(
            shade & ((samp.lobe & TRANSMISSIVE_LOBE) != 0), 1, 0),
        n_scatter=_where_i(shade, 0, state.n_scatter),
        n_total=state.n_total + _where_i(shade, 1, 0),
    )

    # ---------------- russian roulette ----------------
    u_rr = sampler.next1d()
    # survival probability is a discrete decision: detached
    roulette_pdf = fmax3(mask).detach()
    do_rr = (state.n_total > 2) & (roulette_pdf < 0.1) & shade
    rr_survive = u_rr < roulette_pdf
    mask = torch.where((do_rr & rr_survive)[..., None],
                       mask / torch.clamp(roulette_pdf, min=1e-20)[..., None],
                       mask)
    rr_dead = do_rr & ~rr_survive

    # ---------------- termination ----------------
    over_budget = (
        (state.n_total >= cfg.max_bounces)
        | (state.n_diff >= cfg.max_diff_bounces)
        | (state.n_spec >= cfg.max_spec_bounces)
        | (state.n_trans >= cfg.max_trans_bounces)
    )
    alive = (alive & ~missed & ~is_light & ~bsdf_dead & ~rr_dead
             & ~(surface & over_budget))
    return (state._replace(mask=mask, acc=acc, alpha=alpha, alive=alive),
            nee_batches)


def _self_exclusion(cfg, hit, state_after, n_scatter_before):
    """Per-lane triangle to exclude from the NEXT dispatch: a ray leaving a
    mesh hit must not re-test the planar triangle it sits on (lanes that
    scattered in a medium are not excluded)."""
    if not cfg.has_mesh or hit.tri is None:
        return None
    scattered_now = state_after.n_scatter > n_scatter_before
    return torch.where((hit.tri >= 0) & ~scattered_now, hit.tri, -1)


class _SanitizeGrad(torch.autograd.Function):
    """Identity whose backward replaces non-finite cotangents with zero."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return tuple(None if g is None
                     else torch.nan_to_num(g, nan=0.0, posinf=0.0, neginf=0.0)
                     for g in gs)


def _sanitize_grad(tree):
    """Identity on a nested tuple/list/NamedTuple of tensors whose backward
    zeroes non-finite cotangents of its floating leaves.

    The backward pass evaluates every op's partial derivative on every
    lane, masked-out (dead) lanes included, whose primal values are
    arbitrary: a zero cotangent times an overflowing partial gives NaN,
    which would poison the whole parameter gradient.  Where-gating makes
    the true cotangent of those lanes exactly zero, so zeroing non-finite
    entries recovers the right gradient (held against finite differences
    in tests/test_torch_grad.py).  Leaves that carry no gradient pass
    through untouched.
    """
    leaves = []

    def collect(x):
        if isinstance(x, torch.Tensor):
            if x.requires_grad:
                leaves.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                collect(y)

    collect(tree)
    if not leaves or not torch.is_grad_enabled():
        return tree
    clean = iter(_SanitizeGrad.apply(*leaves))

    def rebuild(x):
        if isinstance(x, torch.Tensor):
            return next(clean) if x.requires_grad else x
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rebuild(y) for y in x))
        if isinstance(x, (tuple, list)):
            return type(x)(rebuild(y) for y in x)
        return x

    return rebuild(tree)


def n_steps_for(cfg: SceneConfig, scatter_cap: int = 16) -> int:
    extra = (min(cfg.max_scattering_events, scatter_cap)
             if cfg.has_global_medium else 0)
    return cfg.max_bounces + extra
