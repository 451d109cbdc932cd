"""What the bounce-level tools share: their scenes and rays, timing and
profiling on the card (CUDA events, ``torch.profiler``) or, where the caller
asks for the CPU, on the host clock, and their JSON lines.

A number from a CPU run is a host time and says so: every line carries
``device`` and ``timed_by``.  On the card every time ends in a
synchronisation, and the profiler's device time is the CUDA kernels' summed
time; on the CPU ``device_ms`` is None and ``kernels`` counts the ATen
operations dispatched (one CPU kernel each).
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    nvidia_smi_line, resolve_device,
)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CORNELL_HI = os.path.join(REPO, "scenes", "cornell_hi.json")
CORNELL_SIMPLE = os.path.join(REPO, "scenes", "cornell_simple.json")
MODELS = os.path.join(REPO, "scenes", "assets")
# bench.py's stand-in where a scene's OBJ is absent (tools/northstar.py's)
FALLBACK_MESH = dict(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
REPS = 3


def load(path: str, device):
    """The scene at ``path`` on ``device`` (its OBJ from the file's name
    or ``scenes/assets``; bench.py's icosphere where it is absent) ->
    (cfg, scene)."""
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
    try:
        return load_scene(path, models_dir=MODELS, device=device)
    except FileNotFoundError:
        return load_scene(path, mesh_override=make_icosphere(**FALLBACK_MESH),
                          device=device)


def random_rays(n: int, device, seed: int = 0):
    """The reference tools' lanes: origins uniform in [-1.2, 1.2]^3,
    directions normal and normalised, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(device), torch.from_numpy(d).to(device))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def best_ms(fn, dev: torch.device) -> float:
    """``fn()`` once to warm up, then the best of REPS calls in ms: CUDA
    events around each call on the card, the host clock on the CPU."""
    fn()
    sync(dev)
    best = float("inf")
    for _ in range(REPS):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(dev)
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def wall_ms(fn, dev: torch.device) -> float:
    """One call of ``fn`` in ms by the host clock, ending in a sync."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3


class _OpCount(TorchDispatchMode):
    """Counts the ATen operations dispatched under it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def profiled(fn, dev: torch.device):
    """``fn()`` once under ``torch.profiler`` on the card -> (the profiler,
    dict(device_ms: the CUDA kernels' summed time, kernels: their count));
    on the CPU -> (None, dict(device_ms=None, kernels: ATen operations))."""
    if dev.type != "cuda":
        with _OpCount() as c:
            fn()
        return None, dict(device_ms=None, kernels=c.ops)
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        sync(dev)
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return prof, dict(
        device_ms=sum(e.self_device_time_total for e in rows) / 1e3,
        kernels=sum(e.count for e in rows))


def part(name: str, fn, dev: torch.device, **keys) -> dict:
    """One timed and profiled call site -> its JSON row: ``name``, ``ms``
    (best_ms), ``device_ms`` and ``kernels`` (profiled), and ``keys``."""
    ms = best_ms(fn, dev)
    _, prof = profiled(fn, dev)
    return dict(keys, name=name, ms=ms, **prof)


def device_info(dev: torch.device, timed_by: str | None = None) -> dict:
    """The device a tool ran on and how it was timed (``timed_by``, else
    ``part``'s way): the card's name and ``nvidia-smi``'s name and power
    limit, or the CPU."""
    if dev.type == "cuda":
        return dict(device=torch.cuda.get_device_name(dev),
                    nvidia_smi=nvidia_smi_line(),
                    timed_by=timed_by or "CUDA events (ms); torch.profiler "
                                         "(device_ms, kernels)")
    return dict(device="cpu", nvidia_smi=None,
                timed_by=timed_by or "host clock (ms); ATen operations "
                                     "(kernels); no device time (device_ms "
                                     "None)")


def emit(row: dict) -> dict:
    print(json.dumps(row), flush=True)
    return row


def device_arg(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; no fallback) or cpu")


def open_device(tool: str, device):
    """The tool's device, the card unless the caller asks for the CPU; None
    (with the reason on stderr) where the card is asked for and absent."""
    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"{tool}: {e}", file=sys.stderr)
        return None
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
