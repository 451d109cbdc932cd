"""Profiling and metrics: wall-time spans, throughput counters, device
traces.

Port of ``photorealistic_rendering_using_opencl_tpu/utils/profiling.py``:
``Metrics`` and ``samples_per_sec`` as they are; the reference's
``xla_trace`` (a ``jax.profiler`` scope) becomes ``torch_trace``, a
``torch.profiler`` scope that writes a Chrome trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


@dataclass
class Metrics:
    """Accumulates named wall-time spans and throughput counters."""

    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            total, count = self.spans.get(name, (0.0, 0))
            self.spans[name] = (total + dt, count + 1)

    def count(self, name: str, n: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + n

    def rate(self, counter: str, span: str) -> float:
        total, _ = self.spans.get(span, (0.0, 0))
        return self.counters.get(counter, 0.0) / max(total, 1e-12)

    def report(self) -> str:
        lines = []
        for name, (total, count) in sorted(self.spans.items()):
            lines.append(f"{name}: {total:.3f}s over {count} calls "
                         f"({total / max(count, 1) * 1e3:.1f} ms/call)")
        for name, v in sorted(self.counters.items()):
            lines.append(f"{name}: {v:,.0f}")
        return "\n".join(lines)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def torch_trace(logdir: str | None):
    """The port's ``xla_trace``: a ``torch.profiler`` scope over the host
    and, where a card is present, its CUDA kernels; on exit it writes the
    Chrome trace ``logdir/trace.json`` (open it in Perfetto or
    chrome://tracing).  A no-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:  # an interrupted render keeps its trace, as the reference's
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def samples_per_sec(width: int, height: int, spp: int, seconds: float
                    ) -> float:
    return width * height * spp / max(seconds, 1e-12)
