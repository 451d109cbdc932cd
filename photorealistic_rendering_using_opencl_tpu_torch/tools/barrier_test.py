"""What one more kernel launch costs inside the shading chain: the
pass-through probe of the fusion-barrier test.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.barrier_test \\
        [--rays 262144] [--reps 10] [--rounds 3]

Port of ``tools/pallas_barrier_test.py:main``.  ``integrator.bounce_step``
on the analytic ``cornell_simple`` scene at ``--rays`` lanes, in four
forms: the baseline, then with ``integrator.shadow_visible`` wrapped so
that it also sends ``origin + direction`` through one T2a copy
(``ops/passthrough.py``), through two, or through one T2b copy of the
flattened array.  The copies do not change the step's result.  On the TPU
the question was whether a custom call breaks XLA's fusion of the chain
around it; in an eager PyTorch chain there is no fusion to break, so the
difference to the baseline is the cost of one more launch.

Each form is timed with CUDA events around ``--reps`` steps launched back
to back (the card's time including the gaps the host leaves), in
``--rounds`` rounds that take the forms in turn; the median per step is
reported.  Needs a CUDA device and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
from photorealistic_rendering_using_opencl_tpu_torch.ops.passthrough import (
    passthrough, passthrough_flat,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCENE = os.path.join(_REPO, "scenes", "cornell_simple.json")
RAYS = 262144
FORMS = ("baseline", "one T2a copy", "two T2a copies", "one T2b copy")


def _probe(copies):
    """A ``shadow_visible`` that also runs ``copies(origin + direction)``
    and folds the copy into its result without changing it."""
    real = integrator.shadow_visible

    def shadow(cfg, scene, origin, direction, max_dist, active=None,
               exclude_tri=None):
        v = real(cfg, scene, origin, direction, max_dist, active=active,
                 exclude_tri=exclude_tri)
        return v & (copies(origin, direction).sum(dim=-1) > -1e30)

    return shadow


_COPIES = {
    "one T2a copy": lambda o, d: passthrough(o + d),
    "two T2a copies": lambda o, d: passthrough(passthrough(o + d) + d),
    "one T2b copy": lambda o, d: passthrough_flat(
        (o + d).reshape(-1)).reshape(-1, 3),
}


@contextlib.contextmanager
def form(name: str):
    """``integrator.shadow_visible`` swapped for the form's probe, and
    restored on the way out."""
    real = integrator.shadow_visible
    if name != "baseline":
        integrator.shadow_visible = _probe(_COPIES[name])
    try:
        yield
    finally:
        integrator.shadow_visible = real


def setup(n: int = RAYS, device="cuda", seed: int = 0):
    """cornell_simple and ``n`` lanes of random rays through the box ->
    (cfg, scene, state, pixel index)."""
    cfg, scene = load_scene(SCENE, device=device)
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    state = integrator.init_state(torch.from_numpy(o).to(device),
                                  torch.from_numpy(d).to(device))
    pix = torch.arange(n, dtype=torch.int64, device=device)
    return cfg, scene, state, pix


@torch.no_grad()
def step(cfg, scene, state, pix, i: int) -> integrator.PathState:
    """One ``bounce_step`` of every lane, sample index ``i``."""
    sampler = Sampler(pix, i, seed=0, scheme="pcg4d",
                      dim=integrator.CAMERA_DIMS)
    return integrator.bounce_step(cfg, scene, state, sampler, 0)


def check_forms(cfg, scene, state, pix) -> dict:
    """Every form's step against the baseline's: the largest difference
    over all float fields (0.0 when the copies change nothing)."""
    with form("baseline"):
        want = step(cfg, scene, state, pix, 0)
    out = {}
    for name in FORMS[1:]:
        with form(name):
            got = step(cfg, scene, state, pix, 0)
        diff = 0.0
        for g, w in zip(got, want):
            if g.is_floating_point():
                diff = max(diff, float((g - w).abs().max()))
            elif not torch.equal(g, w):
                diff = float("inf")
        out[name] = diff
    return out


def run(n: int = RAYS, reps: int = 10, rounds: int = 3,
        device="cuda") -> dict:
    """Per-step milliseconds of each form (median over rounds), and each
    form's difference to the baseline's result."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("barrier_test times kernels: it needs a CUDA device")
    cfg, scene, state, pix = setup(n, dev)
    diffs = check_forms(cfg, scene, state, pix)
    times = {name: [] for name in FORMS}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(rounds):
        for name in FORMS:
            with form(name):
                step(cfg, scene, state, pix, 0)  # warm-up
                torch.cuda.synchronize()
                start.record()
                for i in range(reps):
                    step(cfg, scene, state, pix, i)
                end.record()
                torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / reps)
    ms = {name: statistics.median(v) for name, v in times.items()}
    return dict(rays=n, reps=reps, rounds=rounds, ms=ms, all_ms=times,
                extra_ms={k: ms[k] - ms["baseline"] for k in FORMS[1:]},
                max_diff=diffs, device=torch.cuda.get_device_name(dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rays", type=int, default=RAYS)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("barrier_test: no CUDA device", file=sys.stderr)
        return 1
    r = run(args.rays, args.reps, args.rounds)
    print(f"{r['device']}: bounce_step on cornell_simple, {r['rays']} lanes",
          flush=True)
    for name in FORMS:
        extra = ("" if name == "baseline" else
                 f"  (+{r['extra_ms'][name]:.3f} ms, result diff "
                 f"{r['max_diff'][name]:.3g})")
        print(f"  {name:16s} {r['ms'][name]:9.3f} ms per step{extra}",
              flush=True)
    print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
