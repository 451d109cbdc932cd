"""Device time of a pass's intersections, ms: the device operations
launched inside the program's ``prt.intersect`` spans (each merged
dispatch, ``intersect.intersect_and_shadow_detached``: W1, the analytic
hits, the shadow rays; and each reattachment of its winners,
``intersect.finish_hit``), per ``prt.pass`` span, in the traced passes."""
from benchmark.harness.spans import device_ms

SPANS = ("prt.shade", "prt.intersect")


def read(data):
    if "trace" not in data:
        return None
    return device_ms(data["trace"], "prt.intersect", SPANS, "prt.pass")
