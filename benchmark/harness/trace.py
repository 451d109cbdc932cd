"""The device trace of a short steady part of a run: kernel intervals, their
union, the idle share and the breakdown, read from ``torch.profiler``'s
raw event list (no Chrome trace is written: one render pass is tens of
thousands of kernels)."""
from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

REGION = "bench.traced"


@dataclass
class TraceData:
    """What one profiled region holds, times in nanoseconds."""

    region: tuple  # host clock (start, end)
    # device operations: (start, end, name, is_kernel, correlation id)
    device: list = field(default_factory=list)
    # host operations (aten ops, autograd nodes): (start, end, name, thread)
    host: list = field(default_factory=list)
    # launches: correlation id -> (host start, thread)
    launches: dict = field(default_factory=dict)

    @property
    def span_s(self) -> float:
        return (self.region[1] - self.region[0]) / 1e9

    @property
    def kernels(self) -> int:
        return sum(1 for d in self.device if d[3])

    def kernel_seconds(self, name_part: str) -> float:
        return sum(d[1] - d[0] for d in self.device
                   if d[3] and name_part in d[2]) / 1e9


def union(intervals, lo: int, hi: int) -> list:
    """The union of (start, end, ...) intervals clipped to [lo, hi], as
    sorted disjoint (start, end) pairs."""
    out = []
    for s, e in sorted((max(i[0], lo), min(i[1], hi)) for i in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_s(data: TraceData) -> float:
    """Seconds in which some operation ran on the device, in the region."""
    lo, hi = data.region
    return sum(e - s for s, e in union(data.device, lo, hi)) / 1e9


def idle_share(data: TraceData, untraced_s: float,
               units: int = 1) -> float | None:
    """1 - (union of the device intervals in the region / ``units`` times
    ``untraced_s``), where the region holds ``units`` passes or steps and
    ``untraced_s`` is the span of an untraced one.  The profiler's own
    host cost stretches the region itself, so its span is not the
    denominator: the work's device time is, over the time it takes
    unprofiled."""
    if not data.device or untraced_s <= 0.0 or units < 1:
        return None
    return 1.0 - busy_s(data) / (units * untraced_s)


def gaps(data: TraceData) -> list:
    """The idle stretches of the device in the region: (start, end)."""
    lo, hi = data.region
    out, t = [], lo
    for s, e in union(data.device, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def innermost(host: list, queries: list) -> list:
    """For each (time, thread) query, the name of the innermost host
    operation open on that thread at that time (None where none is).
    Operations of one thread nest."""
    by_thread = {}
    for s, e, n, th in sorted(host):
        by_thread.setdefault(th, []).append((s, e, n))
    order = sorted(range(len(queries)), key=lambda i: queries[i])
    out = [None] * len(queries)
    state = {}
    for i in order:
        t, th = queries[i]
        evs = by_thread.get(th, [])
        pos, stack = state.get(th, (0, []))
        while pos < len(evs) and evs[pos][0] <= t:
            while stack and stack[-1][1] <= evs[pos][0]:
                stack.pop()
            stack.append(evs[pos])
            pos += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        state[th] = (pos, stack)
        out[i] = stack[-1][2] if stack else None
    return out


def breakdown(data: TraceData, top: int = 10) -> dict:
    """The device operations that took the most time, summed by name, and
    the idle time summed by what the host was doing: each gap goes to the
    host operation that launched the device operation ending it ("end"
    for the gap before the region's closing synchronisation).  At most
    ``top`` entries each, [name, seconds]."""
    ops = {}
    for d in data.device:
        ops[d[2]] = ops.get(d[2], 0) + (d[1] - d[0])
    first = {}
    for d in sorted(data.device):
        first.setdefault(d[0], d)
    starts = sorted(first)
    queries, spans = [], []
    for s, e in gaps(data):
        i = bisect.bisect_left(starts, e)
        if i < len(starts) and starts[i] == e and first[e][4] in data.launches:
            queries.append(data.launches[first[e][4]])
        else:
            queries.append(None)
        spans.append(e - s)
    asked = [q for q in queries if q is not None]
    names = iter(innermost(data.host, asked))
    idle = {}
    for q, span in zip(queries, spans):
        name = "end" if q is None else (next(names) or "python")
        idle[name] = idle.get(name, 0) + span

    def ranked(d):
        return [[k[:120], v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(ops), "idle_gaps": ranked(idle)}


def _read(prof) -> TraceData:
    from torch.autograd import DeviceType
    data = TraceData(region=None)
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if name == REGION:
            if ev.device_type() != DeviceType.CUDA:
                data.region = (s, e)
            continue
        if ev.is_user_annotation():
            continue
        if ev.device_type() == DeviceType.CUDA:
            # copies and fills are device operations but no kernels (the
            # profiler of torch 2.11 names them and gives no activity type)
            kernel = not name.startswith(("Memcpy", "Memset"))
            data.device.append((s, e, name, kernel, ev.correlation_id()))
        elif name.startswith("cuda"):
            data.launches[ev.correlation_id()] = (s, ev.start_thread_id())
        else:
            data.host.append((s, e, name, ev.start_thread_id()))
    if data.region is None:
        raise RuntimeError(f"the profile holds no {REGION!r} region")
    return data


class Profiled(contextlib.AbstractContextManager):
    """``with Profiled(device) as p: <work>``: the work under
    ``torch.profiler`` (host and CUDA), between two synchronisations;
    ``p.data`` afterwards.  On the CPU (the CPU tests) the host alone."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.data: TraceData | None = None

    def _sync(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._rf = record_function(REGION)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        self._sync()
        self._rf.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.data = _read(self._prof)
        self._prof = None
        return False
