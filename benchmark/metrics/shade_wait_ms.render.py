"""How long the device waits on shading's launches in a pass, ms: the idle
gaps whose ending operation was launched inside a ``prt.shade`` span, per
``prt.pass`` span, in the traced passes (the profiler's host cost widens
the gaps: compare it between traced runs only)."""
from benchmark.harness.spans import wait_ms

SPANS = ("prt.shade", "prt.intersect")


def read(data):
    if "trace" not in data:
        return None
    return wait_ms(data["trace"], "prt.shade", SPANS, "prt.pass")
