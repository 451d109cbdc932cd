"""Rendering over several devices: pixels sharded over the ranks of a
process group, the scene replicated on each.

Port of ``photorealistic_rendering_using_opencl_tpu/parallel/render.py``.
A rank renders its slice of the frame's pixels, padded with the pixel
(0, 0) up to a multiple of the world size; the RNG is keyed on the global
pixel id ``py * width + px``, so a pixel's value does not depend on how
many ranks render.  The collectives:

  * ``render_sharded``: one ``all_gather`` of the ranks' (radiance, alpha)
    blocks, so that every rank holds the frame.  (The reference's output
    stays sharded on its devices until it is fetched, and its audit counts
    no collective.)
  * a step of ``make_train_step``: two ``all_reduce`` (SUM), the loss and
    ONE flat buffer of every parameter's gradient.  The gradient reduction
    is explicit, as in the reference, whose round-3 bug published one
    shard's local gradient as the step.

Over gloo a CUDA tensor is reduced where it lies, but gathered through host
memory (gloo gathers CPU tensors only).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from photorealistic_rendering_using_opencl_tpu_torch.models import (
    integrator, pathtracer,
)
from photorealistic_rendering_using_opencl_tpu_torch.parallel.distributed import (
    RAYS_AXIS, global_mesh, rank_world,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SceneConfig, SceneData,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import DEFAULT_DEVICE

PARAM_LEAVES = ("color", "obj_color", "medium_sigma_a", "medium_sigma_s",
                "medium_sigma_t")


def default_mesh(device=DEFAULT_DEVICE):
    """The 1-D ``("rays",)`` mesh over every rank of the default group
    (``distributed.global_mesh``): the reference's mesh over its devices,
    here one rank a device."""
    return global_mesh(device)


def _pad_to(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """x with zero rows appended up to n_pad rows."""
    return torch.cat([x, x.new_zeros((n_pad - x.shape[0],) + x.shape[1:])])


def pixel_slice(width: int, height: int, rank: int, world: int, device):
    """Rank ``rank``'s (px, py) of ``world`` equal slices of the frame's
    pixels, padded with the pixel (0, 0) up to a multiple of ``world``."""
    n_pad = _pad_to(width * height, world)
    per = n_pad // world
    px, py = pathtracer.pixel_grid(width, height, device)
    sl = slice(rank * per, (rank + 1) * per)
    return _pad_rows(px, n_pad)[sl], _pad_rows(py, n_pad)[sl]


def _gather(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's [per, k] block in rank order, by one all_gather."""
    world = dist.get_world_size(group)
    via_host = block.is_cuda and dist.get_backend(group) == "gloo"
    x = block.cpu() if via_host else block.contiguous()
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts).to(block.device)


def render_sharded(cfg: SceneConfig, scene: SceneData, cam, width: int,
                   height: int, spp: int, seed=0, rng_scheme: str = "pcg4d",
                   group=None):
    """The frame over the group's ranks -> (hdr [H,W,3], alpha [H,W]) on
    every rank, on the scene's device.  Each rank runs
    ``pathtracer.trace_regen`` on its pixel slice; outside a process group
    this is one rank's whole frame."""
    rank, world = rank_world(group)
    n = width * height
    px, py = pixel_slice(width, height, rank, world, scene.device)
    with torch.no_grad():
        rad, alpha = pathtracer.trace_regen(cfg, scene, cam, width, height,
                                            spp, px, py, seed, rng_scheme)
    block = torch.cat([rad, alpha[:, None]], dim=1)
    if world > 1:
        block = _gather(block, group)
    block = block[:n]
    return (block[:, :3].reshape(height, width, 3),
            block[:, 3].reshape(height, width))


def _render_block(cfg: SceneConfig, width, height, spp, rng_scheme,
                  scene: SceneData, cam, px, py, seed, method: str = "scan"):
    """A rank's pixels, ``spp`` samples each, by ``integrator.trace``."""
    pixel_idx = py * width + px
    n = px.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=px.device)
    aac = torch.zeros((n,), dtype=torch.float32, device=px.device)
    for s in range(spp):
        origin, direction = pathtracer.camera_rays_for_sample(
            cam, width, height, px, py, pixel_idx, s, seed, rng_scheme, True)
        rad, alpha = integrator.trace(cfg, scene, origin, direction,
                                      pixel_idx, s, seed=seed,
                                      rng_scheme=rng_scheme, method=method)
        acc = acc + rad
        aac = aac + alpha
    return acc / spp, aac / spp


def make_train_step(cfg: SceneConfig, width: int, height: int, spp: int,
                    rng_scheme: str = "pcg4d", lr: float = 1e-2,
                    param_leaves=PARAM_LEAVES, group=None):
    """Build ``step(scene, cam, target_flat, seed) -> (loss, new_scene)``:
    each rank renders its pixels (``_render_block``, ``method="scan"``),
    the loss is the all-reduced sum of squared errors over ``n_pad * 3``
    (the zero-target padding counts, as in the reference), the gradients of
    ``param_leaves`` are all-reduced in one flat buffer, and a plain SGD
    update replaces each leaf, the same on every rank.  Outside a process
    group the step runs on one rank with no collective."""
    n = width * height

    def step(scene: SceneData, cam, target_flat, seed):
        rank, world = rank_world(group)
        n_pad = _pad_to(n, world)
        per = n_pad // world
        px, py = pixel_slice(width, height, rank, world, scene.device)
        tgt = _pad_rows(target_flat, n_pad)[rank * per:(rank + 1) * per]
        params = {k: getattr(scene, k).detach().requires_grad_()
                  for k in param_leaves}
        with torch.enable_grad():
            rad, _ = _render_block(cfg, width, height, spp, rng_scheme,
                                   dataclasses.replace(scene, **params),
                                   cam, px, py, seed)
            local = torch.sum(torch.square(rad - tgt))
            grads = torch.autograd.grad(local / (n_pad * 3),
                                        list(params.values()),
                                        allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for g, p in zip(grads, params.values())])
        loss = local.detach().reshape(1)
        if dist.is_available() and dist.is_initialized():
            dist.all_reduce(loss, group=group)
            dist.all_reduce(flat, group=group)
        new_scene, off = scene, 0
        for k, p in params.items():
            g = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            new_scene = _replace_leaf(new_scene, k, p.detach() - lr * g)
        return loss[0] / (n_pad * 3), new_scene

    return step


def _replace_leaf(scene: SceneData, name: str, value) -> SceneData:
    return dataclasses.replace(scene, **{name: value})
