"""Rank body of tests/test_torch_parallel.py's process groups (no JAX).

``run(rank, world, init, out_dir, jobs)`` joins a gloo group through a
``file://`` store, runs the named jobs on the CPU with every collective of
``torch.distributed`` counted, and pickles each rank's results to
``out_dir/rank<r>.pkl``.  Spawned by ``torch.multiprocessing``.
"""
import functools
import os
import pickle

import torch
import torch.distributed as dist

from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed
from photorealistic_rendering_using_opencl_tpu_torch.parallel.render import (
    make_train_step, render_sharded,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = os.path.join(REPO, "scenes", "cornell_simple.json")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "broadcast", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "gather", "scatter",
               "reduce", "all_gather_object", "broadcast_object_list")
# (width, height, spp, seed) of the render jobs, the train step's side and
# target
RENDERS = {"frame": (24, 24, 2, 5), "padded": (15, 15, 2, 5),
           "padded3": (16, 16, 1, 5)}
TRAIN_SIDE, TRAIN_TARGET = 16, 0.2
BOUNDS_N = (0, 1, 2, 5, 100, 101)


class Census:
    """Counts every call of the collectives above: (name, numel) each."""

    def __init__(self):
        self.calls = []
        for name in COLLECTIVES:
            fn = getattr(dist, name, None)
            if fn is not None:
                setattr(dist, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def counted(*a, **k):
            t = a[1] if name == "all_gather" else a[0]
            self.calls.append((name, int(t.numel())
                               if isinstance(t, torch.Tensor) else -1))
            return fn(*a, **k)
        return counted

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def run(rank, world, init, out_dir, jobs):
    torch.set_num_threads(1)
    census = Census()
    distributed.initialize(init, world, rank, device="cpu")
    distributed.initialize()  # idempotent
    out = {"rank_world": distributed.rank_world(), "init": census.take()}
    cfg, scene = load_scene(SCENE, device="cpu")
    for job in jobs:
        if job in RENDERS:
            w, h, spp, seed = RENDERS[job]
            cam = default_camera(w, h).pytree("cpu")
            img, alpha = render_sharded(cfg, scene, cam, w, h, spp, seed=seed)
            out[job] = (img.numpy(), alpha.numpy(), census.take())
        elif job.startswith("train"):
            lr = 1.0 if job == "train_lr1" else 1e-2
            side = TRAIN_SIDE
            cam = default_camera(side, side).pytree("cpu")
            step = make_train_step(cfg, side, side, 1, lr=lr)
            target = torch.full((side * side, 3), TRAIN_TARGET)
            loss, s2 = step(scene, cam, target, 0)
            out[job] = (float(loss), s2.color.numpy(),
                        s2.medium_sigma_t.numpy(), census.take())
        elif job == "bounds":
            out[job] = [distributed.local_shard_bounds(n) for n in BOUNDS_N]
        elif job == "mesh":
            mesh = distributed.global_mesh("cpu")
            out[job] = (mesh.mesh_dim_names, mesh.size(),
                        mesh.get_local_rank(distributed.RAYS_AXIS))
            census.take()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def spawn(world, out_dir, jobs):
    """Start ``world`` ranks running ``jobs`` (returns the context to
    join)."""
    init = "file://" + os.path.join(out_dir, "store")
    return torch.multiprocessing.start_processes(
        run, args=(world, init, out_dir, jobs), nprocs=world, join=False,
        start_method="spawn")


def results(world, out_dir):
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out

