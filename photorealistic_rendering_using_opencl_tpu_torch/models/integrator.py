"""Path-tracing integrator: one shading event for every lane of a batch,
and the reference's per-sample bounce loops.

Port of ``photorealistic_rendering_using_opencl_tpu/models/integrator.py``:
``PathState``, ``init_state``, ``gather_material``, ``NeeBatch``,
``accumulate_nee``, ``shade_step``, ``_self_exclusion``, ``bounce_step``,
``_sanitize_grad``, ``n_steps_for``, ``SCAN_CHUNK`` and ``trace`` (methods
``scan`` and ``while``).  The reference's ``tag_hit`` names the
intersection results for its rematerialisation policy; here the loops
split the intersection into a detached half, which no checkpoint
recomputes, and a differentiable half, so nothing needs a name.
All lanes advance together under masks.  Light hits found by BSDF sampling
are weighted by the power heuristic against the carried previous pdf, and
NEE shadow rays are returned deferred so the loops can merge them into
one mesh dispatch.  With a global medium, each event first samples a
distance in the medium: a lane that scatters takes volumetric NEE and a
phase-function continuation instead of a surface bounce (scatter events
do not count as bounces, so the loops run ``max_bounces`` plus a scatter
budget).  An environment map lights rays that miss, weighted by MIS
against its importance sampler, which also gives every surface vertex a
second NEE shadow ray.  Random dimensions are drawn in the reference's
order (medium 2, volumetric NEE and phase 5, surface NEE 3, env NEE 2,
BSDF 3, roulette 1), so every stream is the reference's.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from photorealistic_rendering_using_opencl_tpu_torch.ops import (
    bsdf as bsdf_ops, envmap, intersect, lights, media, phase as phase_ops,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import (
    Hit, intersect_scene, shadow_visible,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import (
    RAY_INF, fetch_float_rows, fmax3, power_heuristic, to_global, to_local,
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
# reference's nested scan does, and remat="segment" checkpoints a chunk at
# a time.  Read once at import from PRT_SCAN_CHUNK, the reference's knob
# (its sweep chose 8; tools/regen_scan_probe.py sweeps it)
SCAN_CHUNK = int(os.environ.get("PRT_SCAN_CHUNK", "8"))


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


def _medium_transmittance(cfg, scene, origin, direction, dist):
    """Shadow-segment transmittance of the static medium type."""
    if cfg.medium_type == "exponential":
        return media.exponential_transmittance(scene.medium_sigma_t, origin,
                                               direction, dist)
    return media.homogeneous_transmittance(scene.medium_sigma_t, dist)


def _medium_sample_distance(cfg, scene, origin, direction, max_t,
                            u_chan, u_dist):
    sample = (media.exponential_sample_distance
              if cfg.medium_type == "exponential"
              else media.homogeneous_sample_distance)
    return sample(scene.medium_sigma_s, scene.medium_sigma_t,
                  cfg.medium_absorption_only, origin, direction, max_t,
                  u_chan, u_dist)


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
    """Advance every live path by one event (surface bounce or scatter).

    Takes the intersection of ``state``'s current ray and returns
    ``(state, nee_batches)``: the state holds the NEXT ray, and the NEE
    shadow batches wait for the render loop's merged dispatch and
    ``accumulate_nee``.
    """
    p_eval, p_pdf, p_sample = phase_ops.get(cfg.phase_function)
    g = scene.phase_g
    mat = gather_material(cfg, scene, hit.mesh_id)
    alive = state.alive
    nee_batches = []
    acc = state.acc
    mask = state.mask
    alpha = state.alpha

    # ---------------- global medium ----------------
    scattered = torch.zeros_like(alive)
    vol_rec = None
    if cfg.has_global_medium:
        u_chan, u_dist = sampler.next2d()
        ms = _medium_sample_distance(cfg, scene, state.origin,
                                     state.direction, hit.t, u_chan, u_dist)
        mask = torch.where(alive[..., None], mask * ms.weight, mask)
        scattered = (alive & ~ms.exited
                     & (state.n_scatter < cfg.max_scattering_events))

        # volumetric NEE, visibility deferred
        vol_nee = (cfg.enable_volume_light_sampling
                   and cfg.n_lights > 0 and cfg.enable_light_sampling)
        u_pick, ul1, ul2, up1, up2 = sampler.nextnd(5)
        if vol_nee:
            li, pick_pdf = lights.pick_light(cfg, scene, u_pick)
            rec = lights.sample_direct(cfg, scene, li, ms.p, ul1, ul2)
            do_nee = scattered & rec.valid
            if not cfg.low_order_scattering:
                do_nee = do_nee & (state.n_scatter > 0)
            f_ph = p_eval(state.direction, rec.d, g)
            trans = _medium_transmittance(cfg, scene, ms.p, rec.d, rec.dist)
            light_col = scene.color[li]
            # invalid lanes carry pdf 0: 1 keeps the division's partial
            # finite (do_nee gates the result)
            pdf_safe = torch.where(rec.valid, torch.clamp(rec.pdf, min=1e-12),
                                   1.0)
            contrib = (light_col * trans * f_ph[..., None]
                       * (power_heuristic(rec.pdf,
                                          p_pdf(state.direction, rec.d, g))
                          / pdf_safe)[..., None]) / pick_pdf
            vol_rec = NeeBatch(origin=ms.p, direction=rec.d, dist=rec.dist,
                               active=do_nee, weighted=mask * contrib)

        # phase sampling continues the path
        w_new, ph_pdf = p_sample(state.direction, up1, up2, g)
        state = state._replace(
            origin=torch.where(scattered[..., None], ms.p, state.origin),
            direction=torch.where(scattered[..., None], w_new,
                                  state.direction),
            n_scatter=_where_i(scattered, state.n_scatter + 1,
                               state.n_scatter),
            prev_pdf=torch.where(scattered, ph_pdf, state.prev_pdf),
            prev_specular=torch.where(scattered, not vol_nee,
                                      state.prev_specular),
            prev_did_nee=torch.where(scattered, vol_nee, state.prev_did_nee),
        )

    surface = alive & ~scattered

    # ---------------- miss -> environment ----------------
    missed = surface & ~hit.valid
    if cfg.alpha_testing:
        # coverage alpha: transparent only when the PRIMARY ray escapes
        primary = (state.n_total == 0) & (state.n_scatter == 0)
        alpha = torch.where(missed & primary, 0.0, alpha)
    elif cfg.has_env_map:
        env = envmap.radiance(scene.env_map, state.direction)
        w_env = 1.0
        if cfg.env_nee:
            # MIS against the env importance sampler at the previous vertex
            e_pdf = envmap.env_pdf(scene.env_dist, state.direction)
            w_env = torch.where(state.prev_specular | ~state.prev_did_nee,
                                1.0,
                                power_heuristic(state.prev_pdf, e_pdf))[..., None]
        acc = acc + torch.where(missed[..., None], mask * env * w_env, 0.0)

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
        if cfg.has_global_medium:
            contrib = contrib * _medium_transmittance(cfg, scene, hit.pos,
                                                      rec.d, rec.dist)
        pdf_safe = torch.where(rec.valid, torch.clamp(rec.pdf, min=1e-12), 1.0)
        contrib = contrib * (power_heuristic(rec.pdf, b_pdf)
                             / pdf_safe)[..., None]
        contrib = contrib / pick_pdf
        take = nee_ok & nonzero
        surf_nee = NeeBatch(origin=hit.pos, direction=rec.d, dist=rec.dist,
                            active=take, weighted=mask * contrib)
        if vol_rec is not None:
            # a lane either scattered (volumetric NEE) or reached a surface
            # (surface NEE) this event: the two shadow rays share one slot
            s1 = scattered[..., None]
            surf_nee = NeeBatch(
                origin=torch.where(s1, vol_rec.origin, surf_nee.origin),
                direction=torch.where(s1, vol_rec.direction,
                                      surf_nee.direction),
                dist=torch.where(scattered, vol_rec.dist, surf_nee.dist),
                active=torch.where(scattered, vol_rec.active,
                                   surf_nee.active),
                weighted=torch.where(s1, vol_rec.weighted,
                                     surf_nee.weighted),
            )
        nee_batches.append(surf_nee)
        did_nee = shade & bsdf_ops.nee_capable(mat)
    elif vol_rec is not None:
        nee_batches.append(vol_rec)

    # ---------------- env-map NEE ----------------
    if cfg.env_nee:
        ue1, ue2 = sampler.next2d()
        e_dir, e_pdf = envmap.sample_env(scene.env_dist, ue1, ue2)
        e_ok = shade & bsdf_ops.nee_capable(mat) & (e_pdf > 1e-12)
        wo_e = to_local(hit.normal, e_dir)
        f_e = bsdf_ops.evaluate(cfg, mat, wi, wo_e, hit.backside, hit.t)
        b_pdf_e = bsdf_ops.pdf(cfg, mat, wi, wo_e)
        nz_e = torch.sum(f_e * f_e, dim=-1) > 0.0
        e_rad = envmap.radiance(scene.env_map, e_dir)
        pdf_safe_e = torch.where(e_ok, torch.clamp(e_pdf, min=1e-12), 1.0)
        contrib_e = e_rad * f_e * (power_heuristic(e_pdf, b_pdf_e)
                                   / pdf_safe_e)[..., None]
        e_dist = torch.full_like(e_pdf, RAY_INF)
        if cfg.has_global_medium:
            contrib_e = contrib_e * _medium_transmittance(
                cfg, scene, hit.pos, e_dir, e_dist)
        nee_batches.append(NeeBatch(
            origin=hit.pos, direction=e_dir, dist=e_dist,
            active=e_ok & nz_e, weighted=mask * contrib_e))
        did_nee = did_nee | (shade & bsdf_ops.nee_capable(mat))

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


def bounce_step(cfg: SceneConfig, scene: SceneData, state: PathState,
                sampler: Sampler, bounce=0) -> PathState:
    """Advance every live path by one event, one dispatch per phase:
    intersect, shade, then one ``shadow_visible`` per NEE batch.

    ``trace`` instead pipelines ``shade_step`` with one merged dispatch and
    threads the previous bounce's self-exclusion into it, which a single
    bounce cannot, so the two can differ at grazing self-hits.  For tools
    and tests; ``shadow_visible`` is looked up in this module at call time
    (``tools/barrier_test.py`` swaps it).  ``bounce`` is unused, as in the
    reference.
    """
    hit = intersect_scene(cfg, scene, state.origin, state.direction,
                          active=state.alive)
    was_scatter = state.n_scatter
    state, nee = shade_step(cfg, scene, state, hit, sampler)
    excl = _self_exclusion(cfg, hit, state, was_scatter)
    vis = [shadow_visible(cfg, scene, b.origin, b.direction, b.dist,
                          active=b.active, exclude_tri=excl) for b in nee]
    return accumulate_nee(state, nee, vis)


class _SanitizeGrad(torch.autograd.Function):
    """Identity whose backward replaces non-finite cotangents with zero.
    Under ``PRT_GRAD_DEBUG`` (read at each backward, as the reference reads
    it) the backward also prints, for each floating cotangent, how many
    entries it zeroed, in the reference's words, so that a real NaN cannot
    hide behind the masked-lane cleanup."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if os.environ.get("PRT_GRAD_DEBUG"):
            for g in gs:
                if g is not None and g.is_floating_point():
                    rows = g.shape[0] if g.dim() else 1
                    print(f"sanitize_grad: zeroed "
                          f"{int((~torch.isfinite(g)).sum())} non-finite "
                          f"cotangents in {rows}x{g.numel() // max(rows, 1)} "
                          "leaf", flush=True)
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


def _trace_shade(cfg: SceneConfig, scene: SceneData, pixel_idx, sample_idx,
                 seed, rng_scheme: str, carry, bounce: int):
    """The differentiable half of one bounce of ``trace``: reattach the
    previous dispatch's winners, bank its NEE light, shade -> (state, NEE
    batches, self-exclusion row)."""
    state, nee, rec = carry
    hit = intersect.finish_hit(cfg, scene, state.origin, state.direction, rec)
    state = accumulate_nee(state, nee, rec.visible)
    sampler = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                      dim=CAMERA_DIMS + bounce * DIMS_PER_BOUNCE)
    was_scatter = state.n_scatter
    state, nee = shade_step(cfg, scene, state, hit, sampler)
    return state, nee, _self_exclusion(cfg, hit, state, was_scatter)


def _trace_dispatch(cfg: SceneConfig, scene: SceneData, shaded, last: bool,
                    early_exit: bool):
    """The detached half: ONE merged dispatch of the next closest-hit rays
    and this vertex's NEE shadow rays.  On the last bounce the closest
    batch is never shaded, so its lanes go in inactive."""
    state, nee, excl = shaded
    active = torch.zeros_like(state.alive) if last else state.alive
    rec = intersect.intersect_and_shadow_detached(
        cfg, scene, state.origin, state.direction, active,
        [(b.origin, b.direction, b.dist, b.active) for b in nee],
        exclude_tri=excl, early_exit=early_exit)
    return state, nee, rec


def trace(cfg: SceneConfig, scene: SceneData, origin, direction,
          pixel_idx, sample_idx, seed=0, rng_scheme: str = "pcg4d",
          scatter_cap: int = 16, method: str = "scan"):
    """Trace one sample per ray to termination -> (radiance [N,3], alpha
    [N]).

    The reference's software-pipelined bounce loop: one closest-hit
    dispatch up front, then per bounce ``k`` shade the hit of ``k - 1`` and
    launch ONE merged dispatch (next closest rays + this vertex's NEE
    shadow rays), so the mesh kernel runs ``n_steps + 1`` times a sample.

    ``method="scan"``: every one of the ``n_steps`` bounces, differentiable.
    Each bounce's shading half runs in its own ``torch.utils.checkpoint``
    segment whose boundary is the detached dispatch result (the
    reference's ``save_only_these_names("hit")`` policy), and its output
    passes ``_sanitize_grad``, so the backward recomputes the shading and
    never the mesh kernel.  The reference nests its scan in ``SCAN_CHUNK``
    segments to bound compile time; the padded bounces shade nothing, so
    a flat loop gives the same result without their dispatches.

    ``method="while"``: forward only (runs under ``torch.no_grad()``); it
    stops once no lane is alive, at one host sync per bounce, and its SDF
    marches stop early too.  The RNG is keyed on the bounce index, so both
    methods give the same radiance.
    """
    if method not in ("scan", "while"):
        raise ValueError(f"trace: unknown method {method!r}")
    n_steps = n_steps_for(cfg, scatter_cap)
    grad = method == "scan" and torch.is_grad_enabled()
    early_exit = method == "while"
    with torch.set_grad_enabled(grad):
        state = init_state(origin, direction)
        rec = intersect.intersect_and_shadow_detached(
            cfg, scene, origin, direction, state.alive, [],
            early_exit=early_exit)
        carry = (state, [], rec)

        def shade(c, bounce):
            return _trace_shade(cfg, scene, pixel_idx, sample_idx, seed,
                                rng_scheme, c, bounce)

        for bounce in range(n_steps):
            last = bounce + 1 >= n_steps
            if method == "while":
                if not bool(carry[0].alive.any()):
                    break
                shaded = shade(carry, bounce)
            elif grad:
                shaded = _sanitize_grad(checkpoint(
                    shade, carry, bounce, use_reentrant=False,
                    preserve_rng_state=False))
            else:
                shaded = shade(carry, bounce)
            carry = _trace_dispatch(cfg, scene, shaded, last, early_exit)
        state, nee, rec = carry
        state = accumulate_nee(state, nee, rec.visible)
    return state.acc, state.alpha
