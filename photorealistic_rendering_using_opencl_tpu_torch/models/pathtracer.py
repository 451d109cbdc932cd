"""Renderer front-end: the path-regeneration render of a full frame, its
differentiable form, and that form's iteration budget.

Port of the regeneration loop of
``photorealistic_rendering_using_opencl_tpu/models/pathtracer.py``:
``pixel_grid``, ``camera_rays_for_sample``, ``_regen_carry0``,
``_regen_step`` (as the two halves below), ``trace_regen``,
``trace_regen_scan``, ``calibrate_regen_iters`` and
``render(method="regen" | "regen_scan")``.
Each lane owns one pixel and traces its samples back to back; a lane whose
path dies starts its next sample in the same iteration, and one merged
mesh dispatch per iteration carries every lane's next ray and NEE shadow
ray.  The RNG is keyed on (pixel, sample, dim, seed), so the image does not
depend on the schedule.

An iteration is two halves.  ``_regen_shade`` reattaches the previous
dispatch's winners (``intersect.finish_hit``), banks its NEE light, shades
and regenerates: plain tensor code, differentiable.  ``_regen_dispatch``
is the merged intersection (``intersect.intersect_and_shadow_detached``,
the mesh kernel K1 included): detached, about ten words a lane.  The
differentiable loop checkpoints each ``_regen_shade`` on its own, with
the dispatch's result as the segment's boundary, so the backward pass
recomputes the shading and never the traversal (the reference saves its
named "hit" records for the same reason).

The other methods (``scan``, ``while``: ROADMAP M9; ``bdpt``: M13), AOVs
and progressive rendering (M8) are not ported yet.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
from photorealistic_rendering_using_opencl_tpu_torch.ops import camera_rays, intersect
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import RAY_INF
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SceneConfig, SceneData,
)

_OTHER_METHODS = {"scan": "M9", "while": "M9", "bdpt": "M13"}


def pixel_grid(width: int, height: int, device):
    px = torch.arange(width, dtype=torch.int64, device=device).repeat(height)
    py = torch.arange(height, dtype=torch.int64,
                      device=device).repeat_interleave(width)
    return px, py


def camera_rays_for_sample(cam_pytree, width, height, px, py, pixel_idx,
                           sample_idx, seed, rng_scheme="pcg4d",
                           jitter=True):
    sampler = Sampler(pixel_idx, sample_idx, seed=seed, scheme=rng_scheme,
                      dim=0)  # camera owns dims [0, 8)
    jx, jy = sampler.next2d()
    a1, a2 = sampler.next2d()
    return camera_rays.generate_rays(cam_pytree, width, height, px, py,
                                     (jx, jy), (a1, a2), jitter=jitter)


def render(cfg: SceneConfig, scene: SceneData, cam_pytree,
           width: int, height: int, spp: int, seed=0,
           rng_scheme: str = "pcg4d", jitter: bool = True,
           method: str = "scan", regen_iters: int = 0,
           bdpt_max_depth: int | None = None):
    """Full render -> (hdr [H,W,3], alpha [H,W]) on the scene's device.

    ``method="regen"`` renders without autograd (the reference's fastest
    forward method); ``method="regen_scan"`` is the differentiable loop
    and needs ``regen_iters`` (from ``calibrate_regen_iters``).  Where the
    reference returns a partial image when that budget is too small, this
    raises.  The signature is the reference's.
    """
    if method not in ("regen", "regen_scan"):
        item = _OTHER_METHODS.get(method)
        if item is None:
            raise ValueError(f"unknown render method {method!r}")
        raise NotImplementedError(
            f"render(method={method!r}) is ROADMAP {item}; the port has "
            "method='regen' and 'regen_scan'")
    if method == "regen_scan" and regen_iters <= 0:
        raise ValueError("method='regen_scan' needs regen_iters > 0 "
                         "(see calibrate_regen_iters)")
    px, py = pixel_grid(width, height, scene.device)
    if method == "regen":
        with torch.no_grad():
            acc, alpha = trace_regen(cfg, scene, cam_pytree, width, height,
                                     spp, px, py, seed, rng_scheme, jitter)
    else:
        acc, alpha, completed = trace_regen_scan(
            cfg, scene, cam_pytree, width, height, spp, px, py, seed,
            regen_iters, rng_scheme, jitter)
        completed = int(completed)
        if completed < spp:
            raise RuntimeError(
                f"render(method='regen_scan'): some pixels finished only "
                f"{completed} of {spp} samples in {regen_iters} iterations; "
                "calibrate regen_iters with a larger margin")
    return acc.reshape(height, width, 3), alpha.reshape(height, width)


def _regen_carry0(cfg: SceneConfig, n: int, device):
    """Initial regeneration-loop carry over ``n`` lanes: no lane has a path
    yet, and the dummy dispatch result reattaches to a miss that shades as
    a no-op on iteration 0."""
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=device)
    state0 = integrator.init_state(zeros3, zeros3)
    state0 = state0._replace(
        alive=torch.zeros((n,), dtype=torch.bool, device=device))
    rec0 = intersect.DetachedHits(
        t=torch.full((n,), RAY_INF, dtype=torch.float32, device=device),
        mesh_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        normal=zeros3,
        tri=(torch.full((n,), -1, dtype=torch.int32, device=device)
             if cfg.has_mesh else None),
        visible=[],
    )
    return (
        state0,
        [],  # NEE batches waiting for the dispatch's shadow verdicts
        rec0,
        torch.zeros((n,), dtype=torch.int64, device=device),  # cur_sample
        torch.ones((n,), dtype=torch.bool, device=device),  # pending
        torch.zeros((n,), dtype=torch.int64, device=device),  # bounce index
        torch.zeros((n,), dtype=torch.float32, device=device),  # alpha bank
    )


def _regen_shade(cfg: SceneConfig, scene: SceneData, cam_pytree,
                 width: int, height: int, spp: int, px, py, pixel_idx,
                 seed, rng_scheme: str, jitter: bool, carry):
    """The differentiable half of one regeneration iteration: reattach the
    previous dispatch's winners, bank its NEE light (acc is cumulative
    across samples), then ``_shade_regenerate``."""
    state, nee, rec, cur, pending, bounce, alpha_sum = carry
    hit = intersect.finish_hit(cfg, scene, state.origin, state.direction, rec)
    state = integrator.accumulate_nee(state, nee, rec.visible)
    return _shade_regenerate(cfg, scene, cam_pytree, width, height, spp, px,
                             py, pixel_idx, seed, rng_scheme, jitter,
                             (state, hit, cur, pending, bounce, alpha_sum))


def _shade_regenerate(cfg: SceneConfig, scene: SceneData, cam_pytree,
                      width: int, height: int, spp: int, px, py, pixel_idx,
                      seed, rng_scheme: str, jitter: bool, carry):
    """Shade every lane's current vertex and regenerate freed lanes
    (functional: returns new tensors and leaves its input untouched).
    Takes the reference's carry (state, hit, cur, pending, bounce,
    alpha_sum); returns (state, nee, exclude, cur, pending, bounce,
    alpha_sum) for ``_regen_dispatch``."""
    state, hit, cur, pending, bounce, alpha_sum = carry
    n = pixel_idx.shape[0]
    dev = pixel_idx.device

    # 1. shade the current vertex (no-op for lanes without a path)
    sampler = Sampler(pixel_idx, cur, seed=seed, scheme=rng_scheme,
                      dim=integrator.CAMERA_DIMS
                      + bounce * integrator.DIMS_PER_BOUNCE)
    was_alive = state.alive
    was_scatter = state.n_scatter
    state, nee = integrator.shade_step(cfg, scene, state, hit, sampler)
    excl = integrator._self_exclusion(cfg, hit, state, was_scatter)
    bounce = torch.where(was_alive, bounce + 1, bounce)
    died = was_alive & ~state.alive
    alpha_sum = alpha_sum + torch.where(died, state.alpha, 0.0)
    cur = torch.where(died, cur + 1, cur)
    pending = pending | died

    # 2. regenerate: a freed lane starts its next sample THIS iteration
    regen = pending & (cur < spp)
    o, d = camera_rays_for_sample(cam_pytree, width, height, px, py,
                                  pixel_idx, cur, seed, rng_scheme, jitter)
    r1 = regen[..., None]
    f1 = torch.ones((n,), dtype=torch.float32, device=dev)
    i0 = torch.zeros((n,), dtype=torch.int32, device=dev)
    state = state._replace(
        origin=torch.where(r1, o, state.origin),
        direction=torch.where(r1, d, state.direction),
        mask=torch.where(r1, 1.0, state.mask),
        alpha=torch.where(regen, f1, state.alpha),
        alive=state.alive | regen,
        prev_pdf=torch.where(regen, f1, state.prev_pdf),
        prev_specular=state.prev_specular | regen,
        prev_did_nee=state.prev_did_nee & ~regen,
        n_diff=torch.where(regen, i0, state.n_diff),
        n_spec=torch.where(regen, i0, state.n_spec),
        n_trans=torch.where(regen, i0, state.n_trans),
        n_scatter=torch.where(regen, i0, state.n_scatter),
        n_total=torch.where(regen, i0, state.n_total),
    )
    pending = pending & ~regen
    bounce = torch.where(regen, 0, bounce)
    if excl is not None:
        # a regenerated lane's camera ray excludes nothing, but its NEE
        # shadow ray leaves the OLD path's terminal vertex and still
        # excludes the triangle it sits on
        excl = ([torch.where(regen, -1, excl)] + [excl] * len(nee)
                if nee else torch.where(regen, -1, excl))
    return (state, nee, excl, cur, pending, bounce, alpha_sum)


def _regen_dispatch(cfg: SceneConfig, scene: SceneData, shaded):
    """The detached half: ONE merged dispatch of the next/camera closest-hit
    rays and the NEE shadow rays.  Returns the next iteration's carry."""
    state, nee, excl, cur, pending, bounce, alpha_sum = shaded
    rec = intersect.intersect_and_shadow_detached(
        cfg, scene, state.origin, state.direction, state.alive,
        [(b.origin, b.direction, b.dist, b.active) for b in nee],
        exclude_tri=excl)
    return (state, nee, rec, cur, pending, bounce, alpha_sum)


def _bank_last_nee(carry) -> integrator.PathState:
    """The final state: the last dispatch's NEE light banked."""
    state, nee, rec = carry[:3]
    return integrator.accumulate_nee(state, nee, rec.visible)


def trace_regen(cfg: SceneConfig, scene: SceneData, cam_pytree,
                width: int, height: int, spp: int, px, py, seed,
                rng_scheme: str = "pcg4d", jitter: bool = True,
                return_iters: bool = False):
    """Path-regeneration render loop (forward only) over a pixel slice.

    The reference's ``while_loop`` becomes a Python loop that asks the
    device "any work left?" once per iteration (one host sync each; CUDA
    graphs are later work).  It stops at the reference's bound of
    ``spp * n_steps + 64`` iterations and raises if lanes are then still
    unfinished, instead of returning a partial image.

    Returns per-lane (radiance_mean [N,3], alpha [N]), plus the iteration
    count when ``return_iters``.
    """
    pixel_idx = py * width + px
    n = px.shape[0]
    max_iters = spp * integrator.n_steps_for(cfg) + 64
    carry = _regen_carry0(cfg, n, px.device)
    it = 0
    while True:
        state, _, _, cur, pending, _, _ = carry
        work = state.alive | (pending & (cur < spp))
        if not bool(work.any()):
            break
        if it >= max_iters:
            raise RuntimeError(
                f"trace_regen: {int(work.sum())} of {n} lanes unfinished "
                f"after the {max_iters}-iteration bound")
        carry = _regen_dispatch(cfg, scene, _regen_shade(
            cfg, scene, cam_pytree, width, height, spp, px, py, pixel_idx,
            seed, rng_scheme, jitter, carry))
        it += 1
    state = _bank_last_nee(carry)
    alpha_sum = carry[-1]
    if return_iters:
        return state.acc / spp, alpha_sum / spp, it
    return state.acc / spp, alpha_sum / spp


def scan_iterations(n_iters: int) -> int:
    """Iterations ``trace_regen_scan`` runs for a budget of ``n_iters``: a
    budget above one ``SCAN_CHUNK`` rounds up to whole chunks, as the
    reference's nested scan does."""
    chunk = integrator.SCAN_CHUNK
    return n_iters if n_iters <= chunk else -(-n_iters // chunk) * chunk


def trace_regen_scan(cfg: SceneConfig, scene: SceneData, cam_pytree,
                     width: int, height: int, spp: int, px, py, seed,
                     n_iters: int, rng_scheme: str = "pcg4d",
                     jitter: bool = True, remat: str = "body"):
    """Reverse-differentiable path regeneration: ``trace_regen``'s
    iteration run a FIXED number of times under autograd.

    ``scan_iterations(n_iters)`` iterations, with no "any work left?" sync;
    size ``n_iters`` with ``calibrate_regen_iters``.  With a sufficient
    budget the result is the same estimator as ``trace_regen`` (the forward
    is bitwise equal); surplus iterations are no-ops (every lane idle; the
    mesh kernel skips every tile).  Each iteration's differentiable half
    runs in its own ``torch.utils.checkpoint`` segment whose boundary is
    the detached dispatch result, so the backward pass re-runs one
    iteration's shading at a time and never the mesh kernel: one K1 launch
    per iteration in the forward pass, none in the backward.  After every
    iteration the carry passes through ``integrator._sanitize_grad``.

    ``remat`` is the reference's option; its ``"segment"`` mode (one
    checkpoint around a whole chunk) is ROADMAP M6b and raises.

    Returns (radiance_mean [N,3], alpha [N], completed [] int64): the
    fewest samples any lane finished, capped at ``spp``.  If the budget is
    too small, unfinished samples' partial radiance is still banked, as in
    the reference; callers check ``completed``.
    """
    if remat != "body":
        raise NotImplementedError(
            f"trace_regen_scan(remat={remat!r}) is ROADMAP M6b; the port "
            "checkpoints each iteration (remat='body')")
    pixel_idx = py * width + px
    n = px.shape[0]
    carry = _regen_carry0(cfg, n, px.device)

    def shade(c):
        return _regen_shade(cfg, scene, cam_pytree, width, height, spp, px,
                            py, pixel_idx, seed, rng_scheme, jitter, c)

    for _ in range(scan_iterations(n_iters)):
        shaded = checkpoint(shade, carry, use_reentrant=False,
                            preserve_rng_state=False)
        carry = _regen_dispatch(cfg, scene, integrator._sanitize_grad(shaded))
    state = _bank_last_nee(carry)
    cur, alpha_sum = carry[3], carry[-1]
    completed = torch.min(torch.clamp(cur, max=spp))
    return state.acc / spp, alpha_sum / spp, completed


def calibrate_regen_iters(cfg: SceneConfig, scene: SceneData, cam_pytree,
                          width: int, height: int, spp: int, seed=0,
                          rng_scheme: str = "pcg4d", jitter: bool = True,
                          margin: float = 1.05, px=None, py=None) -> int:
    """Measured iteration budget for ``trace_regen_scan``: run the forward
    loop once and return its trip count (x margin, rounded up to a
    ``SCAN_CHUNK`` multiple).  Stable across seeds and steps for a fixed
    scene: calibrate once, reuse for a whole optimisation run."""
    if px is None:
        px, py = pixel_grid(width, height, scene.device)
    with torch.no_grad():
        it = trace_regen(cfg, scene, cam_pytree, width, height, spp, px, py,
                         seed, rng_scheme, jitter, return_iters=True)[2]
    chunk = integrator.SCAN_CHUNK
    return -(-max(int(it * margin), 1) // chunk) * chunk
