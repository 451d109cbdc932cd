"""Graft hooks of the port: a one-device forward step and a multi-device
dry run.

The port's twin of the repo's ``__graft_entry__.py``.  ``entry()`` returns
``(fn, example_args)``: ``fn(scene, cam)`` is ``pathtracer.render_sample``
(one sample a pixel, the default method ``"scan"``, seed 0) of
``scenes/cornell.json`` with an 80-triangle icosphere (``make_icosphere(
subdiv=1, radius=0.6, center=(0, -1, 0))``) in place of its OBJ, at 64^2,
and returns the radiance [64*64, 3].  The scene and camera are on the card
unless the caller passes a CPU device; on the card the mesh goes through
the loader's pick, the BVH walk W1 (``scene/loader._pick_mesh_accel``),
and on the CPU through the brute twin, as the reference's rule has it.
``dryrun_multichip(n)`` is ``parallel/dryrun.py``'s.

    python -m photorealistic_rendering_using_opencl_tpu_torch.graft [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from photorealistic_rendering_using_opencl_tpu_torch.parallel.dryrun import (  # noqa: F401
    dryrun_multichip,
)
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)

SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes", "cornell.json")
WIDTH = HEIGHT = 64
MESH = dict(subdiv=1, radius=0.6, center=(0.0, -1.0, 0.0))


def tiny_scene(device=DEFAULT_DEVICE):
    """cornell.json with the icosphere in place of its OBJ -> (cfg,
    scene) on ``device``."""
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
    return load_scene(SCENE, mesh_override=make_icosphere(**MESH),
                      device=resolve_device(device))


def entry(device=DEFAULT_DEVICE):
    """(fn, example_args): the one-device forward render step."""
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera

    dev = resolve_device(device)
    cfg, scene = tiny_scene(dev)
    cam = default_camera(WIDTH, HEIGHT).pytree(dev)

    def fn(scene, cam):
        rad, _ = pathtracer.render_sample(cfg, scene, cam, WIDTH, HEIGHT,
                                          sample_idx=0, seed=0)
        return rad

    return fn, (scene, cam)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args()
    fn, args = entry(a.device)
    out = fn(*args)
    print(f"entry(): radiance {tuple(out.shape)} on {out.device}, mean "
          f"{float(out.mean()):.6f}")
