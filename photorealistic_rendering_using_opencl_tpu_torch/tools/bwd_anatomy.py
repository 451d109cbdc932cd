"""The regen_scan backward's cost by parameter group, with the gradient
sanitiser on and off.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.bwd_anatomy \\
        [width] [spp] [variant|all-variants|mat|geom|cam|groups] [--reps 3] [--device cpu]

Port of ``tools/bwd_anatomy.py``: the loss mean(image) of
``pathtracer.trace_regen_scan`` (seed 3, the budget from
``calibrate_regen_iters``) on ``scenes/cornell.json`` (``tools.northstar.
load``: bench.py's icosphere where the teapot is absent) at width^2 x spp
(default 512^2 x 4), differentiated by variant:

- ``all``: every float leaf of ``SceneData`` (the reference's bench
  configuration); ``one``: ``obj_color`` alone;
- ``nosan``: every float leaf with ``integrator._sanitize_grad`` replaced
  by the identity (the port's sanitiser is a ``torch.autograd.Function``
  whose backward zeroes non-finite cotangents; the reference's a
  ``custom_vjp``);
- ``chunk4``: every float leaf at ``integrator.SCAN_CHUNK`` 4;
- ``vgrads``: every float leaf with ``mesh_vertex_grads`` on;
- the groups ``mat`` (material tables), ``geom`` (geometry tables), the
  reference's two, and ``cam``, the camera's leaves.

``all-variants`` (the default) runs the four variants and the three
groups; ``groups`` runs the groups.  The reference runs each variant in a
child process, since XLA compiles one program a process; here each runs in
this process with its knob set and put back, as ``trace_regen_scan`` reads
``integrator.SCAN_CHUNK`` and ``integrator._sanitize_grad`` when it runs.
A variant runs once from cold (``compile``: the reference's compile time;
here the first run's seconds), then ``--reps`` times: ``best`` is the best
fwd+bwd seconds (host clock ending in a sync), ``fwd`` and ``bwd`` that
run's forward to the loss and its backward (``torch.autograd.grad``), each
ending in a sync; ``rate`` samples/s; ``temp`` the peak memory above the
variant's start in GB (``torch.cuda.max_memory_allocated``; the reference
reports XLA's temp size; None on the CPU).

JSON lines: one ``{"variant", "iters", "chunk", "best", "fwd", "bwd",
"rate", "temp", "compile"}`` a variant, then the device's name and power
limit.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import sys
import time

import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.tools import _common, northstar

SEED = 3
VARIANTS = ("all", "one", "nosan", "chunk4")
GROUPS = {
    "mat": ("color", "eta", "k", "roughness", "obj_color", "obj_eta",
            "obj_k", "obj_roughness"),
    "geom": ("position", "params", "quad_base", "quad_edge0", "quad_edge1",
             "quad_normal", "quad_area"),
    "cam": None,  # every leaf of the camera
}


@contextlib.contextmanager
def knobs(variant: str):
    """``integrator``'s sanitiser and chunk as ``variant`` has them, put
    back on the way out."""
    san, chunk = integrator._sanitize_grad, integrator.SCAN_CHUNK
    if variant == "nosan":
        integrator._sanitize_grad = lambda tree: tree
    if variant == "chunk4":
        integrator.SCAN_CHUNK = 4
    try:
        yield
    finally:
        integrator._sanitize_grad, integrator.SCAN_CHUNK = san, chunk


def leaves_of(variant: str, scene, cam) -> dict:
    """The variant's leaves by name (``scene.<field>``, ``camera.<key>``)."""
    every = northstar.grad_leaves(scene, cam)
    if variant == "one":
        return {"scene.obj_color": scene.obj_color}
    if variant == "cam":
        return {k: v for k, v in every.items() if k.startswith("camera.")}
    if variant in GROUPS:
        return {f"scene.{f}": getattr(scene, f) for f in GROUPS[variant]}
    return {k: v for k, v in every.items() if k.startswith("scene.")}


def run_one(cfg, scene, cam, width: int, spp: int, variant: str, dev,
            reps: int) -> dict:
    if variant == "vgrads":
        cfg = dataclasses.replace(cfg, mesh_vertex_grads=True)
    with knobs(variant):
        n_iters = pathtracer.calibrate_regen_iters(cfg, scene, cam, width,
                                                   width, spp, seed=SEED)
        px, py = pathtracer.pixel_grid(width, width, dev)
        base = leaves_of(variant, scene, cam)

        def fwd_bwd():
            p = {k: v.detach().clone().requires_grad_() for k, v in
                 base.items()}
            sc = dataclasses.replace(scene, **{
                k[len("scene."):]: v for k, v in p.items()
                if k.startswith("scene.")})
            c = dict(cam, **{k[len("camera."):]: v for k, v in p.items()
                             if k.startswith("camera.")})
            _common.sync(dev)
            t0 = time.perf_counter()
            acc, _, done = pathtracer.trace_regen_scan(
                cfg, sc, c, width, width, spp, px, py, SEED, n_iters)
            loss = torch.mean(acc)
            _common.sync(dev)
            t1 = time.perf_counter()
            torch.autograd.grad(loss, list(p.values()), allow_unused=True)
            _common.sync(dev)
            t2 = time.perf_counter()
            if int(done) != spp:
                raise RuntimeError(f"bwd_anatomy: completed {int(done)} of "
                                   f"{spp} samples")
            return t2 - t0, t1 - t0, t2 - t1

        before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        first = fwd_bwd()[0]
        best = min((fwd_bwd() for _ in range(reps)), key=lambda r: r[0])
        temp = ((torch.cuda.max_memory_allocated(dev) - before) / 1e9
                if dev.type == "cuda" else None)
        chunk = integrator.SCAN_CHUNK
    return dict(variant=variant, iters=n_iters, chunk=chunk, best=best[0],
                fwd=best[1], bwd=best[2], rate=width * width * spp / best[0],
                temp=temp, compile=first, leaves=len(base))


def run(width: int, spp: int, which: str, dev, reps: int = 3) -> list:
    if which == "all-variants":
        variants = VARIANTS + tuple(GROUPS)
    elif which == "groups":
        variants = tuple(GROUPS)
    else:
        variants = (which,)
    cfg, scene, fallback = northstar.load(device=dev)
    cam = default_camera(width, width).pytree(dev)
    rows = [_common.emit(run_one(cfg, scene, cam, width, spp, v, dev, reps))
            for v in variants]
    rows.append(_common.emit(dict(width=width, spp=spp, fallback=fallback,
                                  mesh_accel=cfg.mesh_accel,
                                  **_common.device_info(
                                      dev, "host clock ending in a sync (s)"))))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("width", type=int, nargs="?", default=512)
    ap.add_argument("spp", type=int, nargs="?", default=4)
    ap.add_argument("which", nargs="?", default="all-variants",
                    choices=("all-variants", "groups", "vgrads") + VARIANTS
                    + tuple(GROUPS))
    ap.add_argument("--reps", type=int, default=3)
    _common.device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.open_device("bwd_anatomy", args.device)
    if dev is None:
        return 1
    run(args.width, args.spp, args.which, dev, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
