"""Renderer front-end: full-frame renders by the reference's four methods.

Port of ``photorealistic_rendering_using_opencl_tpu/models/pathtracer.py``:
``pixel_grid``, ``camera_rays_for_sample``, ``render_sample``,
``_regen_carry0``, ``_regen_step`` (as the two halves below),
``trace_regen``, ``trace_regen_scan``, ``calibrate_regen_iters``,
``render(method="scan" | "while" | "regen" | "regen_scan" | "bdpt")``, the
progressive API (``ProgressiveState``, ``progressive_init`` / ``reset`` /
``step`` / ``image``) and the debug AOVs (``render_aov``).

``scan`` (the default, differentiable) and ``while`` (forward only) loop
over the samples, each one ``integrator.trace`` of every pixel; ``bdpt``
loops the same way over ``bidirectional.trace`` (differentiable too).  The
regeneration methods instead let each lane own one pixel and trace its
samples back to back; a lane whose path dies starts its next sample in
the same iteration, and one merged mesh dispatch per iteration carries
every lane's next ray and NEE shadow ray.  The RNG is keyed on (pixel,
sample, dim, seed), so the image does not depend on the schedule.

An iteration is two halves.  ``_regen_shade`` reattaches the previous
dispatch's winners (``intersect.finish_hit``), banks its NEE light, shades
and regenerates: plain tensor code, differentiable.  ``_regen_dispatch``
is the merged intersection (``intersect.intersect_and_shadow_detached``,
the mesh kernel included): detached, about ten words a lane.  The
differentiable loop's default (``remat="body"``) checkpoints each
``_regen_shade`` on its own, with the dispatch's result as the segment's
boundary; ``remat="segment"`` checkpoints a whole chunk of iterations,
dispatches included, and a ``HitTape`` replays the chunk's dispatch
results in its recompute.  Either way the backward pass recomputes the
shading and never the traversal (the reference saves its named "hit"
records for the same reason).
"""
from __future__ import annotations

import contextlib
import warnings
from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from photorealistic_rendering_using_opencl_tpu_torch.models import bidirectional, integrator
from photorealistic_rendering_using_opencl_tpu_torch.ops import camera_rays, intersect
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import RAY_INF
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import MASK32, Sampler
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SceneConfig, SceneData,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import (
    TRACER, spanned,
)

_SAMPLE_METHODS = ("scan", "while", "bdpt")


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


def render_sample(cfg: SceneConfig, scene: SceneData, cam_pytree,
                  width: int, height: int, sample_idx, seed=0,
                  rng_scheme: str = "pcg4d", jitter: bool = True,
                  method: str = "scan", bdpt_max_depth: int | None = None):
    """One sample per pixel -> (radiance [N,3], alpha [N]).  ``method`` is
    "scan", "while" or "bdpt"; BDPT traces ``bdpt_max_depth`` surface
    vertices (default ``bidirectional.DEFAULT_DEPTH_CAP``) and warns when
    that truncates the scene's ``max_bounces``."""
    if method not in _SAMPLE_METHODS:
        raise ValueError(f"render_sample: unknown method {method!r}")
    px, py = pixel_grid(width, height, scene.device)
    pixel_idx = py * width + px
    origin, direction = camera_rays_for_sample(
        cam_pytree, width, height, px, py, pixel_idx, sample_idx, seed,
        rng_scheme, jitter)
    if method == "bdpt":
        eff = (bidirectional.DEFAULT_DEPTH_CAP if bdpt_max_depth is None
               else bdpt_max_depth)
        if eff < cfg.max_bounces:
            warnings.warn(
                f"BDPT depth {eff} truncates the scene's max_bounces="
                f"{cfg.max_bounces} path space (cost is quadratic in "
                f"depth); pass bdpt_max_depth to go deeper",
                stacklevel=2)
        rad = bidirectional.trace(cfg, scene, origin, direction, pixel_idx,
                                  sample_idx, seed=seed,
                                  rng_scheme=rng_scheme,
                                  max_depth=bdpt_max_depth)
        return rad, torch.ones(rad.shape[:1], dtype=torch.float32,
                               device=rad.device)
    return integrator.trace(cfg, scene, origin, direction, pixel_idx,
                            sample_idx, seed=seed, rng_scheme=rng_scheme,
                            method=method)


def render(cfg: SceneConfig, scene: SceneData, cam_pytree,
           width: int, height: int, spp: int, seed=0,
           rng_scheme: str = "pcg4d", jitter: bool = True,
           method: str = "scan", regen_iters: int = 0,
           bdpt_max_depth: int | None = None):
    """Full render -> (hdr [H,W,3], alpha [H,W]) on the scene's device.

    ``method="scan"`` (differentiable), ``method="while"`` (forward
    only, early exit) and ``method="bdpt"`` (bidirectional, differentiable,
    ``bdpt_max_depth`` surface vertices) trace all pixels one sample at a
    time;
    ``method="regen"`` renders without autograd (the reference's fastest
    forward method); ``method="regen_scan"`` is the differentiable
    regeneration loop and needs ``regen_iters`` (from
    ``calibrate_regen_iters``).  Where the reference returns a partial
    image when that budget is too small, this raises.  The RNG is keyed on
    (pixel, sample), so all four agree per pixel up to float summation
    order.  The signature is the reference's.
    """
    if method not in _SAMPLE_METHODS + ("regen", "regen_scan"):
        raise ValueError(f"unknown render method {method!r}")
    if method in _SAMPLE_METHODS:
        n = width * height
        acc = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
        aac = torch.zeros((n,), dtype=torch.float32, device=scene.device)
        for s in range(spp):
            rad, alpha = render_sample(cfg, scene, cam_pytree, width, height,
                                       s, seed, rng_scheme, jitter, method,
                                       bdpt_max_depth)
            acc = acc + rad
            aac = aac + alpha
        return ((acc / spp).reshape(height, width, 3),
                (aac / spp).reshape(height, width))
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
    if TRACER.on:
        TRACER.shaded("regen", "iterations", was_alive)
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


def _regen_dispatch(cfg: SceneConfig, scene: SceneData, shaded,
                    early_exit: bool = True, tape: HitTape | None = None):
    """The detached half: ONE merged dispatch of the next/camera closest-hit
    rays and the NEE shadow rays.  Returns the next iteration's carry.
    ``early_exit`` lets its SDF marches stop once every lane is done (host
    syncs; the differentiable loop passes False).  With a ``tape`` the
    result is recorded, or replayed in a recompute."""
    state, nee, excl, cur, pending, bounce, alpha_sum = shaded

    def search():
        return intersect.intersect_and_shadow_detached(
            cfg, scene, state.origin, state.direction, state.alive,
            [(b.origin, b.direction, b.dist, b.active) for b in nee],
            exclude_tri=excl, early_exit=early_exit)

    rec = search() if tape is None else tape.hits(search)
    return (state, nee, rec, cur, pending, bounce, alpha_sum)


class HitTape:
    """The dispatch results of one checkpointed chunk of
    ``trace_regen_scan(remat="segment")``: the port's counterpart of the
    reference's ``save_only_these_names("hit")``.

    The mesh kernels are ctypes calls, which no selective-checkpoint policy
    sees, so a plain checkpoint of a chunk would launch them again in the
    backward.  Instead the chunk's forward records each iteration's
    detached ``DetachedHits`` (``hits`` runs the search and keeps its
    result), and each recompute replays them in order: the tape is the
    checkpoint's recompute context, and entering it rewinds the replay.
    When a recompute ends (early stop included) the records are freed,
    unless the backward retains the graph, whose next backward replays
    them again.
    """

    def __init__(self):
        self.records: list[intersect.DetachedHits] = []
        self._replay = None

    def hits(self, search) -> intersect.DetachedHits:
        if self._replay is None:
            rec = search()
            self.records.append(rec)
            return rec
        rec = next(self._replay, None)
        if rec is None:
            raise RuntimeError("HitTape: a recompute asked for more dispatch "
                               "results than the forward recorded")
        return rec

    def __enter__(self):
        self._replay = iter(self.records)
        return self

    def __exit__(self, *exc):
        self._replay = None
        if not torch._C._autograd._get_current_graph_task_keep_graph():
            self.records.clear()


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
    graphs are later work).  It stops at ``spp * max_path_events(cfg) +
    64`` iterations and raises if lanes are then still unfinished, instead
    of returning a partial image.

    Returns per-lane (radiance_mean [N,3], alpha [N]), plus the iteration
    count when ``return_iters``.
    """
    pixel_idx = py * width + px
    n = px.shape[0]
    max_iters = spp * max_path_events(cfg) + 64
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


def max_path_events(cfg: SceneConfig) -> int:
    """The most events one regenerated path can take.  Without a medium
    that is the bounce budget (``n_steps_for``), the reference's bound.  In
    a medium, each of the ``max_bounces`` surface events (and the last
    event) can follow up to ``max_scattering_events`` scatters, since the
    scatter count restarts at every surface: the reference's bound of
    ``n_steps_for`` (scatters capped at 16) is shorter than such a path and
    cuts a frame short, which it returns partial (ROADMAP F13)."""
    if not cfg.has_global_medium:
        return integrator.n_steps_for(cfg)
    return (cfg.max_bounces + 1) * (cfg.max_scattering_events + 1)


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

    ``scan_iterations(n_iters)`` iterations, with no "any work left?" sync
    (its SDF marches run their whole budgets);
    size ``n_iters`` with ``calibrate_regen_iters``.  With a sufficient
    budget the result is the same estimator as ``trace_regen`` (the forward
    is bitwise equal); surplus iterations are no-ops (every lane idle; the
    mesh kernel skips every tile).  After every iteration the carry passes
    through ``integrator._sanitize_grad``.  The mesh kernel launches once
    per iteration in the forward pass and never in the backward, in either
    ``remat`` mode:

    - ``"body"`` (the default): each iteration's differentiable half runs
      in its own ``torch.utils.checkpoint`` segment whose boundary is the
      detached dispatch result, so the backward re-runs one iteration's
      shading at a time.
    - ``"segment"``: above one ``SCAN_CHUNK`` of iterations, one segment
      per chunk, its dispatches inside it: the autograd graph keeps one
      carry per chunk instead of one per iteration, and a recompute
      re-runs a whole chunk's shading at once, its dispatches replayed
      from the chunk's ``HitTape``.  With ``n_iters <= SCAN_CHUNK`` it
      runs as ``"body"``, as in the reference.

    Both modes build the same autograd graph from the same values, so
    their images and gradients are bitwise equal.  The reference treats
    any ``remat`` but ``"segment"`` as ``"body"``; here another value
    raises ``ValueError``.

    Returns (radiance_mean [N,3], alpha [N], completed [] int64): the
    fewest samples any lane finished, capped at ``spp``.  If the budget is
    too small, unfinished samples' partial radiance is still banked, as in
    the reference; callers check ``completed``.
    """
    if remat not in ("body", "segment"):
        raise ValueError(f"trace_regen_scan: unknown remat {remat!r} "
                         "(body or segment)")
    pixel_idx = py * width + px
    n = px.shape[0]
    carry = _regen_carry0(cfg, n, px.device)
    chunk = integrator.SCAN_CHUNK
    request = TRACER.request

    def shade(c):
        return _regen_shade(cfg, scene, cam_pytree, width, height, spp, px,
                            py, pixel_idx, seed, rng_scheme, jitter, c)

    def shade_segment(c):
        with TRACER.recompute(request):
            return shade(c)

    def run_chunk(c, tape):
        with TRACER.recompute(request):
            for _ in range(chunk):
                c = _regen_dispatch(cfg, scene,
                                    integrator._sanitize_grad(shade(c)),
                                    early_exit=False, tape=tape)
        return c

    if remat == "segment" and n_iters > chunk:
        for _ in range(scan_iterations(n_iters) // chunk):
            tape = HitTape()
            carry = checkpoint(
                run_chunk, carry, tape, use_reentrant=False,
                preserve_rng_state=False,
                context_fn=lambda t=tape: (contextlib.nullcontext(), t))
    else:
        for _ in range(scan_iterations(n_iters)):
            shaded = checkpoint(shade_segment, carry, use_reentrant=False,
                                preserve_rng_state=False)
            carry = _regen_dispatch(cfg, scene,
                                    integrator._sanitize_grad(shaded),
                                    early_exit=False)
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


# ---------------------------------------------------------------------------
# Progressive (interactive-parity) API
# ---------------------------------------------------------------------------

class ProgressiveState(NamedTuple):
    acc: torch.Tensor  # [H,W,3] radiance sum
    alpha: torch.Tensor  # [H,W] alpha sum
    samples: torch.Tensor  # [] int64: accumulated sample count (a uint32)
    seed: torch.Tensor  # [] int64 holding the uint32 seed


def progressive_init(width: int, height: int, seed: int = 0, *,
                     device=DEFAULT_DEVICE) -> ProgressiveState:
    """An empty accumulation on ``device`` (the card unless the caller asks
    for the CPU); ``seed`` wraps to uint32, as the reference's does."""
    dev = resolve_device(device)
    return ProgressiveState(
        acc=torch.zeros((height, width, 3), dtype=torch.float32, device=dev),
        alpha=torch.zeros((height, width), dtype=torch.float32, device=dev),
        samples=torch.zeros((), dtype=torch.int64, device=dev),
        seed=torch.tensor(int(seed) & MASK32, dtype=torch.int64, device=dev),
    )


def progressive_reset(state: ProgressiveState) -> ProgressiveState:
    """Camera-moved reset (the reference's buffer_reset): the sums and the
    count go to zero, the seed stays."""
    return ProgressiveState(
        acc=torch.zeros_like(state.acc), alpha=torch.zeros_like(state.alpha),
        samples=torch.zeros_like(state.samples), seed=state.seed)


@spanned("prt.pass", request=True)
@torch.no_grad()
def progressive_step(cfg: SceneConfig, scene: SceneData, cam_pytree,
                     state: ProgressiveState, rng_scheme: str = "pcg4d"
                     ) -> ProgressiveState:
    """One more sample of every pixel, added to the state (functional: the
    input state is left untouched).  Interactive accumulation never
    differentiates, so it takes the early-exit ``while`` bounce loop: on the
    card K1 launches once per dispatch, 1 + the bounces run."""
    height, width = state.acc.shape[0], state.acc.shape[1]
    rad, alpha = render_sample(cfg, scene, cam_pytree, width, height,
                               state.samples, state.seed, rng_scheme,
                               method="while")
    return ProgressiveState(
        acc=state.acc + rad.reshape(height, width, 3),
        alpha=state.alpha + alpha.reshape(height, width),
        samples=(state.samples + 1) & MASK32,
        seed=state.seed,
    )


def progressive_image(state: ProgressiveState):
    """The running mean -> (hdr [H,W,3], alpha [H,W]).  The count is read
    to the host and divides as ``render``'s spp does (on CUDA a division
    by a host number is a product with its reciprocal), so the mean of n
    steps is bitwise ``render(method="while")`` at n spp."""
    s = max(int(state.samples), 1)
    return state.acc / s, state.alpha / s


# ---------------------------------------------------------------------------
# Debug AOVs (the reference's VIEW_NORMAL / VIEW_ALBEDO / VIEW_BVH_HIT)
# ---------------------------------------------------------------------------

AOV_MODES = ("normal", "albedo", "depth", "mesh_id", "traversal")


@torch.no_grad()
def render_aov(cfg: SceneConfig, scene: SceneData, cam_pytree,
               width: int, height: int, mode: str = "normal", seed=0):
    """One unjittered primary ray a pixel -> [H,W,3]; ``mode`` in
    AOV_MODES.  Misses are 0 in every mode but ``traversal``: a heatmap of
    the tiles each ray enters, normalised by the frame's largest count (red
    hot, green cold)."""
    if mode not in AOV_MODES:
        raise ValueError(mode)
    px, py = pixel_grid(width, height, scene.device)
    pixel_idx = py * width + px
    origin, direction = camera_rays_for_sample(
        cam_pytree, width, height, px, py, pixel_idx, 0, seed, jitter=False)
    if mode == "traversal":
        steps = intersect.traversal_cost(cfg, scene, origin, direction)
        h = steps.to(torch.float32) / torch.clamp(
            steps.max().to(torch.float32), min=1.0)
        out = torch.stack([h, 1.0 - h, torch.zeros_like(h)], dim=-1)
        return out.reshape(height, width, 3)
    hit = intersect.intersect_scene(cfg, scene, origin, direction)
    if mode == "normal":
        out = hit.normal * 0.5 + 0.5
    elif mode == "albedo":
        out = integrator.gather_material(cfg, scene, hit.mesh_id).color
    elif mode == "depth":
        out = torch.broadcast_to(hit.t[..., None], hit.normal.shape)
    else:  # mesh_id
        out = torch.broadcast_to(
            (hit.mesh_id[..., None].to(torch.float32) + 1.0)
            / (cfg.n_objects + 2), hit.normal.shape)
    out = torch.where(hit.valid[..., None], out, 0.0)
    return out.reshape(height, width, 3)
