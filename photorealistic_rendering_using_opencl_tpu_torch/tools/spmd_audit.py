"""The collectives a sharded render and a train step issue, and their bytes.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.spmd_audit \\
        [--ranks 1 2] [--scene scenes/cornell.json] [--device cpu]

Port of ``tools/spmd_audit.py``.  The reference counts the collective ops
in the HLO its SPMD partitioner compiled, on a virtual CPU mesh of 1 and 8
devices.  The port has no compiled program to read: each rank is a process
that calls ``torch.distributed``, so the tool counts those calls, as
``tests/test_torch_parallel.py`` does, by wrapping every collective of
``torch.distributed`` for the length of the run.  For each world size in
``--ranks`` it runs, on every rank, ``parallel.render.render_sharded``
(16^2 x 2 spp, seed 0) and one step of ``make_train_step`` (1 spp, a zero
target), on the reference's scene (``scenes/cornell.json`` with
``graft.entry``'s 80-triangle icosphere in place of its OBJ) unless
``--scene`` names another.  One rank runs in this process over NCCL on a
card (gloo on the CPU); more ranks are spawned processes over gloo, which
is what ranks that share one card take (NCCL needs a card a rank), so
timings would not be scaling numbers and none are printed.

Expected, as the port is designed: a render issues one ``all_gather`` of
the ranks' (radiance, alpha) blocks on more than one rank and nothing on
one (the reference's render issues no collective: its output stays
sharded); a step issues two ``all_reduce``: the loss and one flat buffer
of the parameters' gradients (``param_gradient_bytes``).

JSON lines: one ``{"counts", "bytes", "total_collectives", "program",
"n_devices", "padded_pixels", "backend"}`` a program and world size (the
step's with ``param_gradient_bytes``), rank 0's; the tool raises if
another rank counted otherwise.  ``bytes`` are each call's result bytes,
as the reference reads them off the result shapes.  Last, the device's
name and power limit.
"""
from __future__ import annotations

import argparse
import functools
import os
import pickle
import sys
import tempfile

import torch
import torch.distributed as dist

from photorealistic_rendering_using_opencl_tpu_torch.tools import _common

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "all-to-all",
                    "collective-permute", "reduce-scatter")
# torch.distributed's calls -> the reference's HLO kinds (the rest under
# their own names)
KIND_OF = {"all_reduce": "all-reduce", "all_gather": "all-gather",
           "all_gather_into_tensor": "all-gather",
           "all_to_all": "all-to-all", "all_to_all_single": "all-to-all",
           "send": "collective-permute", "recv": "collective-permute",
           "isend": "collective-permute", "irecv": "collective-permute",
           "reduce_scatter": "reduce-scatter",
           "reduce_scatter_tensor": "reduce-scatter",
           "broadcast": "broadcast", "reduce": "reduce", "gather": "gather",
           "scatter": "scatter", "all_gather_object": "all-gather-object",
           "broadcast_object_list": "broadcast-object-list"}
WIDTH = 16
RENDER_SPP = 2


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


class Census:
    """Every collective of ``torch.distributed`` called under it, as
    (kind, result bytes); the functions are put back on exit."""

    def __init__(self):
        self.calls = []
        self._real = {}

    def __enter__(self):
        for name in KIND_OF:
            fn = getattr(dist, name, None)
            if fn is not None:
                self._real[name] = fn
                setattr(dist, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._real.items():
            setattr(dist, name, fn)

    def _wrap(self, name, fn):
        @functools.wraps(fn)
        def counted(*a, **k):
            # the result: all_gather's and all_gather_into_tensor's first
            # argument, every other call's tensor in place
            self.calls.append((KIND_OF[name], _tensor_bytes(a[0])))
            return fn(*a, **k)
        return counted

    def take(self) -> dict:
        calls, self.calls = self.calls, []
        kinds = list(COLLECTIVE_KINDS) + sorted(
            {k for k, _ in calls} - set(COLLECTIVE_KINDS))
        counts = {k: sum(1 for c, _ in calls if c == k) for k in kinds}
        nbytes = {k: sum(b for c, b in calls if c == k) for k in kinds}
        return dict(counts=counts, bytes=nbytes, total_collectives=len(calls))


def _scene(scene_path, dev):
    from photorealistic_rendering_using_opencl_tpu_torch import graft
    if scene_path is None:
        return graft.tiny_scene(dev)
    return _common.load(scene_path, dev)


def audit_rank(rank: int, world: int, init: str, device: str,
               scene_path: str | None) -> list:
    """This rank's rows: join the group, render, take a step, leave."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed
    from photorealistic_rendering_using_opencl_tpu_torch.parallel.render import (
        PARAM_LEAVES, make_train_step, render_sharded,
    )
    with Census() as census:
        distributed.initialize(init, world, rank, device=device)
        try:
            census.take()
            dev = distributed.rank_device(device)
            cfg, scene = _scene(scene_path, dev)
            width = WIDTH
            cam = default_camera(width, width).pytree(dev)
            pad = -(width * width) % world
            backend = dist.get_backend()
            with torch.no_grad():
                render_sharded(cfg, scene, cam, width, width, RENDER_SPP,
                               seed=0)
            fwd = dict(census.take(), program="render_sharded",
                       n_devices=world, padded_pixels=pad, backend=backend)
            step = make_train_step(cfg, width, width, 1)
            target = torch.zeros((width * width, 3), dtype=torch.float32,
                                 device=dev)
            step(scene, cam, target, 0)
            bwd = dict(census.take(), program="train_step", n_devices=world,
                       param_gradient_bytes=4 * sum(
                           getattr(scene, k).numel() for k in PARAM_LEAVES),
                       padded_pixels=pad, backend=backend)
        finally:
            dist.destroy_process_group()
    return [fwd, bwd]


def _spawned_rank(rank, world, init, out_dir, device, scene_path):
    rows = audit_rank(rank, world, init, device, scene_path)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(rows, f)


def audit(world: int, dev: torch.device, scene_path: str | None = None
          ) -> list:
    """The rows of ``world`` ranks (rank 0's); raises if the ranks'
    counts differ."""
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "store")
        if world == 1:
            return audit_rank(0, 1, init, str(dev), scene_path)
        torch.multiprocessing.spawn(
            _spawned_rank, nprocs=world,
            args=(world, init, d, str(dev), scene_path))
        ranks = []
        for r in range(world):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    for r, rows in enumerate(ranks[1:], 1):
        if [(x["counts"], x["bytes"]) for x in rows] != [
                (x["counts"], x["bytes"]) for x in ranks[0]]:
            raise RuntimeError(f"spmd_audit: rank {r} of {world} counted "
                               f"{rows}, rank 0 {ranks[0]}")
    return ranks[0]


def run(ranks, dev, scene_path=None) -> list:
    rows = []
    for world in ranks:
        rows += [_common.emit(r) for r in audit(world, dev, scene_path)]
    rows.append(_common.emit(dict(
        scene=scene_path or "scenes/cornell.json + graft's icosphere",
        width=WIDTH, **_common.device_info(
            dev, "counts of torch.distributed's calls; no times"))))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2])
    ap.add_argument("--scene", default=None)
    _common.device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.open_device("spmd_audit", args.device)
    if dev is None:
        return 1
    run(args.ranks, dev, args.scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
