"""Weak scaling of the sharded render: the pixels a rank held fixed while
the ranks grow.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.scaling_bench \\
        [--max-ranks 8] [--device cpu]

Port of ``tools/scaling_bench.py``: ``scenes/cornell_simple.json``,
64 x 64 pixels a rank at 4 spp, the frame 64 pixels wide and 64 x ranks
high, rendered by ``parallel.render.render_sharded`` over 1, 2, 4 and 8
ranks as far as the devices go: one warm-up frame (seed 1), then the best
of 3 (seed 2), each ending in a sync, timed by rank 0 on the host clock.
Ideal weak scaling keeps the time flat: ``parallel_speedup`` is n t(1) /
t(n) and ``vs_core_ceiling`` that over min(n, host cores), the
reference's measures.

On the card a rank is a card, over NCCL, so the ranks go up to
``torch.cuda.device_count()``: with one card the tool runs 1 rank, says
that more ranks need more cards, and prints no scaling number.  On the
CPU the ranks are gloo processes sharing the host's cores, as the
reference's virtual CPU mesh was, up to ``--max-ranks``.

JSON line: ``{"metric", "per_device_pixels", "spp", "host_cores",
"points": [{"n_devices", "seconds"[, "parallel_speedup",
"vs_core_ceiling"]}]}`` with the device's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import pickle
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from photorealistic_rendering_using_opencl_tpu_torch.tools import _common

PER_DEV_SIDE = 64
SPP = 4
RANKS = (1, 2, 4, 8)
REPS = 3


def time_rank(rank: int, world: int, init: str, device: str,
              side: int = PER_DEV_SIDE, spp: int = SPP) -> float:
    """This rank's part of the frame over ``world`` ranks -> the best
    seconds of REPS frames (after a warm-up), every rank ending in a sync
    and a barrier."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed
    from photorealistic_rendering_using_opencl_tpu_torch.parallel.render import render_sharded
    distributed.initialize(init, world, rank, device=device)
    try:
        dev = distributed.rank_device(device)
        cfg, scene = _common.load(_common.CORNELL_SIMPLE, dev)
        w, h = side, side * world
        cam = default_camera(w, h).pytree(dev)

        def frame(seed):
            render_sharded(cfg, scene, cam, w, h, spp, seed=seed)
            _common.sync(dev)
            dist.barrier()

        frame(1)
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            frame(2)
            best = min(best, time.perf_counter() - t0)
        return best
    finally:
        dist.destroy_process_group()


def _spawned_rank(rank, world, init, out_dir, device, side, spp):
    secs = time_rank(rank, world, init, device, side, spp)
    if rank == 0:
        with open(os.path.join(out_dir, "rank0.pkl"), "wb") as f:
            pickle.dump(secs, f)


def max_ranks(dev: torch.device, cap: int) -> int:
    """Ranks this host can hold: a card each, or ``cap`` CPU processes."""
    if dev.type == "cuda":
        return torch.cuda.device_count()
    return cap


def run(dev: torch.device, cap: int = RANKS[-1]) -> list:
    side, spp = PER_DEV_SIDE, SPP
    limit = max_ranks(dev, cap)
    points = []
    for world in RANKS:
        if world > limit:
            break
        with tempfile.TemporaryDirectory() as d:
            init = "file://" + os.path.join(d, "store")
            device = "cuda" if dev.type == "cuda" else "cpu"
            if world == 1:
                secs = time_rank(0, 1, init, str(dev), side, spp)
            else:
                torch.multiprocessing.spawn(
                    _spawned_rank, nprocs=world,
                    args=(world, init, d, device, side, spp))
                with open(os.path.join(d, "rank0.pkl"), "rb") as f:
                    secs = pickle.load(f)
        points.append(dict(n_devices=world, seconds=secs))
        print(f"n_dev {world}: {secs * 1e3:8.1f} ms ({side * side * world} "
              f"px, {side * side}/dev)", flush=True)
    cores = os.cpu_count() or 1
    note = None
    if len(points) > 1:
        t1 = points[0]["seconds"]
        for p in points:
            n = p["n_devices"]
            p["parallel_speedup"] = n * t1 / p["seconds"]
            p["vs_core_ceiling"] = n * t1 / p["seconds"] / min(n, cores)
    else:
        note = (f"{limit} device(s): more ranks need more cards (a rank a "
                "card over NCCL); no scaling number" if dev.type == "cuda"
                else f"--max-ranks {cap}: no scaling number")
        print(note, flush=True)
    return [_common.emit(dict(
        metric="weak_scaling", per_device_pixels=side * side, spp=spp,
        host_cores=cores, points=points, note=note,
        **_common.device_info(dev, "host clock of rank 0 ending in a sync "
                                   "and a barrier (s)")))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-ranks", type=int, default=RANKS[-1],
                    help="the most CPU ranks (the card: one a card)")
    _common.device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.open_device("scaling_bench", args.device)
    if dev is None:
        return 1
    run(dev, args.max_ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
