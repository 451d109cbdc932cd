"""Device time of shading a pass, ms: the device operations launched inside
the program's ``prt.shade`` spans (``integrator.shade_step``; of the
render cell's spans ``prt.shade`` and ``prt.intersect``, the innermost
open at the launch), per ``prt.pass`` span, in the traced passes."""
from benchmark.harness.spans import device_ms

SPANS = ("prt.shade", "prt.intersect")


def read(data):
    if "trace" not in data:
        return None
    return device_ms(data["trace"], "prt.shade", SPANS, "prt.pass")
