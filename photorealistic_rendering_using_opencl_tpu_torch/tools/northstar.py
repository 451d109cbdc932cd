"""BASELINE's north-star shape: cornell at 1024^2, fwd+bwd at full depth.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.northstar \\
        [spp] [tiles] [width] [--scene PATH]

Port of ``tools/northstar.py`` (defaults 4 spp, 4 tiles, 1024, the
reference's ``scenes/cornell.json``; where its teapot is absent,
``bench.py``'s icosphere stands in, and the tool says so).  The loss is
the reference's mean-image loss, ``sum(acc) / (3 n)`` over the frame's
``n`` pixels through ``pathtracer.trace_regen_scan`` (seed 3), with
gradients over every float leaf of ``SceneData`` and of the camera, in two
variants:

- tiled: the frame in ``tiles`` contiguous bands of pixels (whole rows
  where ``tiles`` divides the width), each band its own fwd+bwd.  The
  loss is a sum over pixels, so the bands' gradients sum to the whole
  frame's: the tool adds them into one set and holds it against the
  direct variant's (``check_tiled``);
- direct: the whole frame in one call.

The iteration budget is calibrated once and serves every band and the
direct frame.  The reference calibrates on band 0 alone; on cornell_hi at
1024^2 x 4 spp that budget left the other bands short (completed 3, 2 and
3 of 4 samples on an H100), so here the calibration runs over the whole
frame and the budget is the one its slowest lane needs.  Each variant
runs once from cold, then REPEATS more times: the first run's seconds and
the best of the rest, each ending in ``torch.cuda.synchronize``;
samples/s; ``completed`` (it raises unless every band finished every
sample); peak memory (``torch.cuda.max_memory_allocated``, reset for each
variant); the mesh kernels' launches (K1, W1) in the forward and in the
backward; and the projection to 256 spp.  The last line is one JSON
object with those numbers and the card's name and power limit.  Needs a
CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import nvidia_smi_line

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENE = os.path.join(_REPO, "scenes", "cornell.json")
SEED = 3
REPEATS = 2
PROJECTED_SPP = 256
# bench.py's stand-in for the teapot
FALLBACK_MESH = dict(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
# the bands' summed gradients against the direct ones: each leaf within
# TILED_GRAD_REL of the direct leaf's largest entry, the losses within
# TILED_LOSS_REL of each other (relative).  A camera leaf is a scalar
# whose gradient sums a term from every lane through the same ray
# generation as the others; where those terms cancel
# (camera.focal_distance under the small aperture: on an H100 at 1024^2
# its gap read 5.5e-4 of its own entry, and the direct frame against
# itself with the pixels reversed 1.0e-4) float32 rounding is measured
# against the terms' size, so a camera leaf past its own bound is held
# within TILED_GRAD_REL of the largest entry of any camera leaf
TILED_GRAD_REL = 1e-5
TILED_LOSS_REL = 1e-6


def load(path: str = SCENE, device="cuda"):
    """The scene -> (cfg, scene, whether bench.py's icosphere stood in for
    a mesh file that is absent)."""
    try:
        return (*load_scene(path, device=device), False)
    except FileNotFoundError:
        return (*load_scene(path, mesh_override=make_icosphere(
            **FALLBACK_MESH), device=device), True)


def grad_leaves(scene, cam) -> dict:
    """Every float leaf of the scene and of the camera, by name
    (``scene.<field>``, ``camera.<key>``)."""
    out = {f"scene.{f.name}": getattr(scene, f.name)
           for f in dataclasses.fields(scene)
           if getattr(scene, f.name).is_floating_point()}
    out.update({f"camera.{k}": v for k, v in cam.items()})
    return out


def bands(width: int, tiles: int, device):
    """The frame's pixels in ``tiles`` contiguous bands -> [(px, py)]."""
    n = width * width
    if n % tiles:
        raise ValueError(f"{tiles} tiles do not divide {width}^2 pixels")
    px, py = pathtracer.pixel_grid(width, width, device)
    return list(zip(px.reshape(tiles, -1), py.reshape(tiles, -1)))


def calibrate(cfg, scene, cam, width: int, spp: int) -> int:
    """The iteration budget, calibrated once over the whole frame: it
    serves every band and the direct frame."""
    return pathtracer.calibrate_regen_iters(cfg, scene, cam, width, width,
                                            spp, seed=SEED)


def _launches():
    return dict(K1=mesh_brute.mesh_brute_kernel.launches,
                W1=bvh_walk.bvh_walk_kernel.launches)


def value_and_grads(cfg, scene, cam, width: int, spp: int, n_iters: int,
                    tiles: int = 1) -> dict:
    """The north-star loss and its gradients over ``grad_leaves``, by
    ``tiles`` bands (1: the direct variant) -> dict(loss: float, the
    bands' losses summed in float64; grads: {name: tensor}, the bands'
    gradients summed, zeros for a leaf the render does not reach;
    completed: [int] a band; launches: {"forward"|"backward": {K1, W1}},
    the mesh kernels' launches over all bands)."""
    n = width * width
    names = list(grad_leaves(scene, cam))
    loss_sum = 0.0
    grads = None
    completed = []
    fwd = dict(K1=0, W1=0)
    bwd = dict(K1=0, W1=0)
    for px, py in bands(width, tiles, scene.device):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in grad_leaves(scene, cam).items()}
        sc = dataclasses.replace(scene, **{
            k[len("scene."):]: v for k, v in leaves.items()
            if k.startswith("scene.")})
        camg = {k[len("camera."):]: v for k, v in leaves.items()
                if k.startswith("camera.")}
        before = _launches()
        acc, _, done = pathtracer.trace_regen_scan(
            cfg, sc, camg, width, width, spp, px, py, SEED, n_iters)
        loss = torch.sum(acc) / (3.0 * n)
        mid = _launches()
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
        after = _launches()
        for k in fwd:
            fwd[k] += mid[k] - before[k]
            bwd[k] += after[k] - mid[k]
        got = [torch.zeros_like(x) if g is None else g
               for x, g in zip(leaves.values(), got)]
        grads = got if grads is None else [a + b for a, b in zip(grads, got)]
        loss_sum += float(loss.detach())
        completed.append(int(done))
    return dict(loss=loss_sum, grads=dict(zip(names, grads)),
                completed=completed, launches=dict(forward=fwd, backward=bwd))


def tiled_gap(tiled: dict, direct: dict) -> dict:
    """How far the bands' sum is from the direct variant: the losses'
    relative gap; each leaf's largest gap over the direct leaf's largest
    entry (0 where both are all zeros), and for the camera's leaves also
    over the largest entry of any camera leaf."""
    def gap(k, top):
        err = float((tiled["grads"][k] - direct["grads"][k]).abs().max())
        return err / top if top > 0.0 else (0.0 if err == 0.0
                                            else float("inf"))

    tops = {k: float(g.abs().max()) for k, g in direct["grads"].items()}
    cam_top = max(v for k, v in tops.items() if k.startswith("camera."))
    return dict(
        loss=abs(tiled["loss"] - direct["loss"])
        / max(abs(direct["loss"]), 1e-30),
        grads={k: gap(k, top) for k, top in tops.items()},
        camera={k: gap(k, cam_top) for k in tops if k.startswith("camera.")})


def check_tiled(gap: dict):
    """Raise unless ``tiled_gap``'s readings are within the bounds: the
    loss within TILED_LOSS_REL, each leaf within TILED_GRAD_REL of its own
    largest entry or, for a camera leaf, of the camera's."""
    def held(k, v):
        return (v <= TILED_GRAD_REL
                or gap["camera"].get(k, float("inf")) <= TILED_GRAD_REL)

    bad = {k: v for k, v in gap["grads"].items() if not held(k, v)}
    if not gap["loss"] <= TILED_LOSS_REL or bad:
        raise RuntimeError(
            f"northstar: the bands' sum parts from the direct variant: loss "
            f"{gap['loss']:.3g} (bound {TILED_LOSS_REL}), leaves past "
            f"{TILED_GRAD_REL}: {bad}")


def run_variant(cfg, scene, cam, width: int, spp: int, n_iters: int,
                tiles: int) -> tuple[dict, dict]:
    """One variant timed on the card: a cold run, then REPEATS more;
    raises unless every band completed ``spp`` samples -> (its readings,
    the last run's ``value_and_grads``)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(1 + REPEATS):
        t0 = time.perf_counter()
        res = value_and_grads(cfg, scene, cam, width, spp, n_iters, tiles)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if min(res["completed"]) != spp:
            raise RuntimeError(
                f"northstar: a band finished {res['completed']} of {spp} "
                f"samples in {n_iters} iterations")
    best = min(secs[1:])
    return dict(
        tiles=tiles, iterations=n_iters, first_s=secs[0], best_s=best,
        seconds=secs,
        samples_per_s=width * width * spp / best, completed=spp,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        launches=res["launches"], loss=res["loss"],
        projected_256spp_s=best * PROJECTED_SPP / spp), res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("spp", type=int, nargs="?", default=4)
    ap.add_argument("tiles", type=int, nargs="?", default=4)
    ap.add_argument("width", type=int, nargs="?", default=1024)
    ap.add_argument("--scene", default=SCENE)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("northstar: no CUDA device", file=sys.stderr)
        return 1
    cfg, scene, fallback = load(args.scene)
    if fallback:
        print(f"northstar: {args.scene}'s mesh is absent; bench.py's "
              f"icosphere {FALLBACK_MESH} stands in", flush=True)
    w, spp = args.width, args.spp
    cam = default_camera(w, w).pytree("cuda")
    n_iters = calibrate(cfg, scene, cam, w, spp)
    out = dict(scene=os.path.relpath(args.scene, _REPO), fallback=fallback,
               width=w, spp=spp, mesh_accel=cfg.mesh_accel,
               n_triangles=cfg.n_triangles, iterations=n_iters)
    results = {}
    for label, tiles in ((f"tiled x{args.tiles}", args.tiles),
                         ("direct", 1)):
        v, results[label] = run_variant(cfg, scene, cam, w, spp, n_iters,
                                        tiles)
        out[label] = v
        print(f"{label}: {w}^2 x {spp} spp fwd+bwd, {n_iters} iterations: "
              f"first {v['first_s']:.3f} s, best {v['best_s']:.3f} s, "
              f"{v['samples_per_s']:.0f} samples/s, completed {spp}/{spp} "
              f"on every band, peak {v['peak_gib']:.2f} GiB, launches "
              f"forward {v['launches']['forward']}, backward "
              f"{v['launches']['backward']} -> {PROJECTED_SPP} spp "
              f"projection {v['projected_256spp_s']:.1f} s", flush=True)
    gap = tiled_gap(results[f"tiled x{args.tiles}"], results["direct"])
    out["tiled_vs_direct"] = gap
    worst = max(gap["grads"], key=gap["grads"].get)
    print(f"tiled sum against direct: loss {gap['loss']:.3g}, largest leaf "
          f"gap {gap['grads'][worst]:.3g} of its largest entry ({worst}"
          + (f"; {gap['camera'][worst]:.3g} of the camera's"
             if worst in gap["camera"] else "") + ")", flush=True)
    check_tiled(gap)
    out["device"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = nvidia_smi_line()
    out["torch"] = torch.__version__
    out["cuda"] = torch.version.cuda
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
