"""The program's own spans and counters in a traced region.

The port's tracer (``utils/profiling.TRACER``) records while the profiler
records: its spans are the profiler's own ranges, named ``prt.*``, and
``trace._read`` keeps them among the host operations, on the clock of the
device operations beside them.  Its counters stay in the program and are
read after the region.  A program without the tracer (an older commit)
gives no span and no counter: every function here then returns None.
"""
from __future__ import annotations

import bisect

from benchmark.harness.trace import TraceData, gaps, innermost

PREFIX = "prt."


def count(data: TraceData, name: str) -> int:
    """The spans named ``name`` in the region."""
    return sum(1 for h in data.host if h[2] == name)


def _spans(data: TraceData, among) -> list:
    return [h for h in data.host if h[2] in among]


def launched_in(data: TraceData, among) -> list:
    """Each device operation whose launch the trace holds, with the
    innermost of the spans named in ``among`` open at its launch on the
    launching thread (None where none is): [(operation, span name)]."""
    ops = [d for d in data.device if d[4] in data.launches]
    names = innermost(_spans(data, among),
                      [data.launches[d[4]] for d in ops])
    return list(zip(ops, names))


def device_ms(data: TraceData, span: str, among, per: str) -> float | None:
    """Device time, ms, of the operations launched inside ``span`` (as the
    innermost of ``among``), per ``per`` span.  None without device
    operations or without a ``per`` span."""
    n = count(data, per)
    if not data.device or n == 0:
        return None
    ns = sum(d[1] - d[0] for d, s in launched_in(data, among) if s == span)
    return ns / 1e6 / n


def wait_ms(data: TraceData, span: str, among, per: str) -> float | None:
    """Device idle time, ms, per ``per`` span, of the gaps whose ending
    operation was launched inside ``span`` (as the innermost of
    ``among``): how long the device waited on that span's launches."""
    n = count(data, per)
    if not data.device or n == 0:
        return None
    first = {}
    for d in sorted(data.device):
        first.setdefault(d[0], d)
    starts = sorted(first)
    waits, queries = [], []
    for s, e in gaps(data):
        i = bisect.bisect_left(starts, e)
        if i < len(starts) and starts[i] == e and first[e][4] in data.launches:
            waits.append(e - s)
            queries.append(data.launches[first[e][4]])
    names = innermost(_spans(data, among), queries)
    return sum(w for w, s in zip(waits, names) if s == span) / 1e6 / n


def counter(name: str) -> int | None:
    """The program tracer's counter ``name`` after the traced region (None
    where the program has no tracer)."""
    try:
        from photorealistic_rendering_using_opencl_tpu_torch.utils import (
            profiling)
    except ImportError:
        return None
    tracer = getattr(profiling, "TRACER", None)
    return None if tracer is None else tracer.value(name)


def share(part: str, whole: str) -> float | None:
    """Counter ``part`` over counter ``whole`` (None where either is
    missing or ``whole`` is 0)."""
    a, b = counter(part), counter(whole)
    if a is None or not b:
        return None
    return a / b
