"""One sharded render and one train step over n ranks on a tiny scene.

The port's twin of the JAX package's ``__graft_entry__.dryrun_multichip``:
``dryrun_multichip(n)`` spawns n ranks (one per card over NCCL; gloo on the
CPU or when there are fewer cards than ranks), each renders its slice of a
16^2 frame of ``scenes/cornell.json`` with a 320-triangle icosphere in place
of its OBJ, then takes one step of ``make_train_step`` (render, loss,
backward, the gradients' all-reduce, SGD).  Rank 0 prints the loss.

    python -m photorealistic_rendering_using_opencl_tpu_torch.parallel.dryrun 2 [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)

SCENE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scenes", "cornell.json")


def _tiny_scene(device):
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
    mesh = make_icosphere(subdiv=1, radius=0.6, center=(0.0, -1.0, 0.0))
    return load_scene(SCENE, mesh_override=mesh, device=device)


def _rank(rank: int, world: int, init: str, device: str) -> None:
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed
    from photorealistic_rendering_using_opencl_tpu_torch.parallel.render import (
        make_train_step, render_sharded,
    )
    distributed.initialize(init, world, rank, device=device)
    try:
        dev = distributed.rank_device(device)
        width = height = 16
        cfg, scene = _tiny_scene(dev)
        cam = default_camera(width, height).pytree(dev)
        img, _ = render_sharded(cfg, scene, cam, width, height, 1)
        assert img.shape == (height, width, 3)
        assert not bool(torch.isnan(img).any())
        step = make_train_step(cfg, width, height, 1)
        target = torch.zeros((width * height, 3), dtype=torch.float32,
                             device=dev)
        loss, new_scene = step(scene, cam, target, 0)
        assert bool(torch.isfinite(loss))
        assert new_scene.color.shape == scene.color.shape
        if rank == 0:
            print(f"dryrun_multichip({world}): loss={float(loss):.5f} "
                  f"backend={dist.get_backend()} ok", flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE) -> None:
    """One sharded render and one train step over ``n_devices`` ranks,
    spawned here; raises if a rank fails."""
    resolve_device(device)
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        torch.multiprocessing.spawn(_rank, args=(n_devices, init, str(device)),
                                    nprocs=n_devices)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=2)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args()
    dryrun_multichip(a.n, a.device)
