"""The top kernels of ``bounce_step`` by device time, and the gaps the host
leaves on the device between them.

    python -m photorealistic_rendering_using_opencl_tpu_torch.tools.trace_bounce \\
        [--lanes 262144] [--steps 8] [--top 30] [--scene scenes/cornell_hi.json] \\
        [--device cpu]

Port of ``tools/trace_bounce.py``: ``--steps`` bounce_steps of the
reference tools' random rays (seed 0), the k-th with sample index k, as
the reference's scan of 8, once to warm up and once under
``torch.profiler`` (CUDA activity).  Its kernels are summed by name; the
``--top`` names by device time are printed with their call counts.  The
reference's ``jax.profiler`` trace has no host-side gaps to show (one XLA
program); an eager step launches each kernel from the host, so the tool
also walks the kernels in start order and sums the device's idle time
between one kernel's end and the next one's start (``idle_ms``, the
largest gaps, and their share of the traced span).  On the CPU there is no
device timeline: the ATen operations stand in for kernels (their self
times) and the idle figures are None.

JSON lines: ``{"total_traced_op_us", "kernels", "span_ms", "wall_ms",
"idle_ms", "idle_share", "largest_gaps_us"}``, then one ``{"ms", "name",
"calls"}`` a kernel name, then the device's name and power limit.
"""
from __future__ import annotations

import argparse
import sys

import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.tools import _common

LANES = 262144
STEPS = 8
TOP = 30
GAPS = 10
TIMED_BY = ("torch.profiler's CPU operations (self times, calls); host "
            "clock (wall_ms)",
            "torch.profiler's CUDA kernels (times, calls, gaps); host clock "
            "ending in a sync (wall_ms)")


def device_gaps(events) -> dict:
    """The idle time between kernels on the device timeline: ``events`` are
    (start_us, end_us) of each kernel; overlapping kernels merge."""
    spans = sorted(events)
    idle, gaps, end = 0.0, [], None
    for s, e in spans:
        if end is not None and s > end:
            idle += s - end
            gaps.append(s - end)
        end = e if end is None else max(end, e)
    span = (end - spans[0][0]) if spans else 0.0
    return dict(span_ms=span / 1e3, idle_ms=idle / 1e3,
                idle_share=idle / span if span else None,
                largest_gaps_us=sorted(gaps, reverse=True)[:GAPS])


@torch.no_grad()
def run(n: int, steps: int, top: int, scene_path: str, dev: torch.device
        ) -> list:
    cfg, scene = _common.load(scene_path, dev)
    o, d = _common.random_rays(n, dev)
    pix = torch.arange(n, dtype=torch.int64, device=dev)
    state = integrator.init_state(o, d)

    def run_steps():
        st = state
        for i in range(steps):
            sampler = Sampler(pix, i, seed=0, scheme="pcg4d",
                              dim=integrator.CAMERA_DIMS)
            st = integrator.bounce_step(cfg, scene, st, sampler, 0)
        return st.acc.sum()

    run_steps()
    _common.sync(dev)
    agg = {}
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = _common.wall_ms(run_steps, dev)
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        for e in kernels:
            us, calls = agg.get(e.name, (0.0, 0))
            agg[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
        gaps = device_gaps([(e.time_range.start, e.time_range.end)
                            for e in kernels])
    else:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            wall = _common.wall_ms(run_steps, dev)
        for e in prof.key_averages():
            if e.self_cpu_time_total > 0:
                agg[e.key] = (e.self_cpu_time_total, e.count)
        kernels = [None] * sum(c for _, c in agg.values())
        gaps = dict(span_ms=None, idle_ms=None, idle_share=None,
                    largest_gaps_us=None)
    total = sum(us for us, _ in agg.values())
    rows = [_common.emit(dict(total_traced_op_us=total, kernels=len(kernels),
                              wall_ms=wall, lanes=n, steps=steps, **gaps))]
    for name, (us, calls) in sorted(agg.items(), key=lambda kv: -kv[1][0]
                                    )[:top]:
        rows.append(_common.emit(dict(ms=us / 1e3, name=name[:110],
                                      calls=calls)))
    rows.append(_common.emit(dict(scene=scene_path, mesh_accel=cfg.mesh_accel,
                                  **_common.device_info(dev, TIMED_BY[
                                      dev.type == "cuda"]))))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=LANES)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--top", type=int, default=TOP)
    ap.add_argument("--scene", default=_common.CORNELL_HI)
    _common.device_arg(ap)
    args = ap.parse_args(argv)
    dev = _common.open_device("trace_bounce", args.device)
    if dev is None:
        return 1
    run(args.lanes, args.steps, args.top, args.scene, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
