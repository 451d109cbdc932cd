"""Inverse rendering: optimise differentiable scene parameters toward a
target image.

Port of ``photorealistic_rendering_using_opencl_tpu/diff/inverse.py``, on
one device: render -> L2 image loss -> Adam on float leaves of SceneData,
through either differentiable render method: ``"scan"`` (the default, one
``integrator.trace`` per sample) or ``"regen_scan"`` (the path-regeneration
loop, with a calibrated iteration budget).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, NamedTuple

import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SceneConfig, SceneData,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import spanned

DEFAULT_PARAM_LEAVES = ("color", "obj_color")


class FitResult(NamedTuple):
    scene: SceneData
    losses: torch.Tensor  # [steps], each before its step's update


def image_loss(cfg: SceneConfig, scene: SceneData, cam, width: int,
               height: int, spp: int, target, seed=0,
               method: str = "scan", regen_iters: int = 0) -> torch.Tensor:
    img, _ = pathtracer.render(cfg, scene, cam, width, height, spp,
                               seed=seed, method=method,
                               regen_iters=regen_iters)
    return torch.mean(torch.square(img - target))


def make_loss_fn(cfg: SceneConfig, scene: SceneData, cam, width: int,
                 height: int, spp: int, target,
                 param_leaves: Iterable[str] = DEFAULT_PARAM_LEAVES,
                 method: str = "scan", regen_iters: int = 0):
    """Returns loss(params_dict, seed) closing over the rest of the scene;
    each call is a step's forward (span ``prt.forward``)."""

    @spanned("prt.forward", request=True)
    def loss(params, seed):
        s = dataclasses.replace(scene, **params)
        return image_loss(cfg, s, cam, width, height, spp, target, seed,
                          method=method, regen_iters=regen_iters)

    return loss


def fit_scene(cfg: SceneConfig, scene: SceneData, cam, width: int,
              height: int, spp: int, target, steps: int = 50,
              lr: float = 5e-2,
              param_leaves: Iterable[str] = DEFAULT_PARAM_LEAVES,
              optimizer: Callable | None = None, method: str = "scan",
              regen_margin: float = 1.25) -> FitResult:
    """Gradient-descend the selected scene leaves toward ``target``.

    ``optimizer`` builds a ``torch.optim.Optimizer`` from the parameter
    list; the default is ``torch.optim.Adam(lr)``, whose defaults (beta
    0.9/0.999, eps 1e-8 added to the root of the second moment) are
    ``optax.adam``'s, the reference's optimizer.  After each step the
    parameters are clipped at >= 0 (colours stay non-negative).  Step i
    renders with seed i + 1, a fresh RNG stream per step.

    ``method="scan"`` traces every bounce of every sample and needs no
    budget.  The iteration budget of ``regen_scan`` is calibrated once, on
    the initial scene with seed 1 and ``regen_margin`` headroom; a
    trajectory that lengthens paths past it makes ``render`` raise rather
    than return a partial image.
    """
    if method not in ("scan", "regen_scan"):
        raise ValueError(f"fit_scene needs a differentiable render method "
                         f"('scan' or 'regen_scan'), not {method!r}")
    param_leaves = tuple(param_leaves)
    params = {k: getattr(scene, k).detach().clone().requires_grad_()
              for k in param_leaves}
    regen_iters = 0
    if method == "regen_scan":
        regen_iters = pathtracer.calibrate_regen_iters(
            cfg, scene, cam, width, height, spp, seed=1, margin=regen_margin)
    loss_fn = make_loss_fn(cfg, scene, cam, width, height, spp, target,
                           param_leaves, method=method,
                           regen_iters=regen_iters)
    if optimizer is None:
        opt = torch.optim.Adam(list(params.values()), lr=lr)
    else:
        opt = optimizer(list(params.values()))

    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, i + 1)
        loss.backward()
        opt.step()
        with torch.no_grad():
            for p in params.values():
                p.clamp_(min=0.0)
        losses.append(loss.detach())
    return FitResult(
        dataclasses.replace(scene, **{k: v.detach() for k, v in params.items()}),
        torch.stack(losses))
