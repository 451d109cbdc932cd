"""Sweep the differentiable regeneration loop's knobs on the card.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.regen_scan_probe \\
        [width] [spp] [mode]

Port of ``tools/regen_scan_probe.py``: at 512^2 x 4 spp on
``scenes/cornell.json`` (``tools.northstar.load``: bench.py's icosphere
where the teapot is absent), the full bounce budget, the loss mean(image)
over every float leaf of the scene (as the reference's):

- forward only (``trace_regen_scan`` under ``torch.no_grad()``): the
  fixed-length loop's cost without autograd;
- fwd+bwd with ``remat="segment"`` at ``SCAN_CHUNK`` 8, 16 and 32, and
  ``remat="body"`` at 8.

``SCAN_CHUNK`` is read once at import from ``PRT_SCAN_CHUNK``, so each
variant runs in a child process of its own with that variable set.  A
variant reports the best of 3 runs' seconds, its rate, its peak memory
(``torch.cuda.max_memory_allocated``; the reference reports XLA's temp
size) and its first run's seconds (where the reference reports its
compile time), each run ending in ``torch.cuda.synchronize``.  ``mode``
is ``all`` (default), ``fwd`` or ``sweep``.  The last line is one JSON
object holding every variant and the card's name and power limit.  Needs
a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.tools import northstar
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import nvidia_smi_line

SEED = 3
REPS = 3
# (SCAN_CHUNK, remat, forward only), in the reference's order
FORWARD = [(8, "segment", True)]
SWEEP = [(8, "segment", False), (8, "body", False), (16, "segment", False),
         (32, "segment", False)]
_CHILD = "PRT_PROBE_CHILD"
_MODULE = "photorealistic_rendering_using_opencl_tpu_torch.tools.regen_scan_probe"
# the directory that holds the package: the children import it from there
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_one(width: int, spp: int, remat: str, fwd_only: bool) -> dict:
    """One variant in this process, at the ``SCAN_CHUNK`` it was imported
    with."""
    cfg, scene, fallback = northstar.load()
    cam = default_camera(width, width).pytree("cuda")
    n_iters = pathtracer.calibrate_regen_iters(cfg, scene, cam, width, width,
                                               spp, seed=SEED)
    px, py = pathtracer.pixel_grid(width, width, scene.device)
    names = [f.name for f in dataclasses.fields(scene)
             if getattr(scene, f.name).is_floating_point()]

    def run():
        with torch.set_grad_enabled(not fwd_only):
            p = {k: getattr(scene, k).detach().clone().requires_grad_(
                not fwd_only) for k in names}
            acc, _, done = pathtracer.trace_regen_scan(
                cfg, dataclasses.replace(scene, **p), cam, width, width, spp,
                px, py, SEED, n_iters, remat=remat)
            loss = torch.mean(acc)
            if not fwd_only:
                torch.autograd.grad(loss, list(p.values()), allow_unused=True)
        torch.cuda.synchronize()
        if int(done) != spp:
            raise RuntimeError(f"regen_scan_probe: completed {int(done)} of "
                               f"{spp} samples")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(1 + REPS):
        t0 = time.perf_counter()
        run()
        secs.append(time.perf_counter() - t0)
    best = min(secs[1:])
    return dict(mode="fwd-only" if fwd_only else "fwd+bwd",
                chunk=integrator.SCAN_CHUNK, remat=remat, iterations=n_iters,
                scan_iterations=pathtracer.scan_iterations(n_iters),
                best_s=best, rate=width * width * spp / best,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                first_s=secs[0], seconds=secs, fallback=fallback,
                mesh_accel=cfg.mesh_accel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("width", type=int, nargs="?", default=512)
    ap.add_argument("spp", type=int, nargs="?", default=4)
    ap.add_argument("mode", nargs="?", default="all",
                    choices=("all", "fwd", "sweep"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("regen_scan_probe: no CUDA device", file=sys.stderr)
        return 1
    if os.environ.get(_CHILD):
        r = run_one(args.width, args.spp, os.environ["PRT_PROBE_REMAT"],
                    os.environ["PRT_PROBE_FWD"] == "1")
        print("RESULT " + json.dumps(r), flush=True)
        return 0
    variants = ((FORWARD if args.mode in ("all", "fwd") else [])
                + (SWEEP if args.mode in ("all", "sweep") else []))
    results = []
    for chunk, remat, fwd in variants:
        env = dict(os.environ, PRT_SCAN_CHUNK=str(chunk),
                   PRT_PROBE_REMAT=remat, PRT_PROBE_FWD="1" if fwd else "0",
                   **{_CHILD: "1"})
        res = subprocess.run(
            [sys.executable, "-m", _MODULE, str(args.width), str(args.spp),
             args.mode],
            env=env, cwd=_ROOT, capture_output=True, text=True, check=False)
        lines = [ln for ln in res.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if res.returncode or not lines:
            sys.stderr.write(res.stdout + res.stderr)
            raise RuntimeError(f"regen_scan_probe: the variant chunk={chunk} "
                               f"remat={remat} fwd_only={fwd} failed "
                               f"({res.returncode})")
        r = json.loads(lines[-1][len("RESULT "):])
        results.append(r)
        print(f"{r['mode']:8s} chunk={r['chunk']:2d} remat={r['remat']:7s} "
              f"iters={r['iterations']} ({r['scan_iterations']} run): best "
              f"{r['best_s']:.3f} s, {r['rate']:.0f} samples/s, peak "
              f"{r['peak_gib']:.2f} GiB, first run {r['first_s']:.3f} s",
              flush=True)
    print(json.dumps(dict(width=args.width, spp=args.spp, variants=results,
                          device=torch.cuda.get_device_name(0),
                          nvidia_smi=nvidia_smi_line(),
                          torch=torch.__version__, cuda=torch.version.cuda)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
