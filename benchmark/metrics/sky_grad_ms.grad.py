"""Device time of the sky map's gradient scatter in a step, ms: the device
operations launched inside the program's ``prt.sky_grad`` spans (the
backward nodes of ``envmap.sample_bilinear``'s four taps; of the grad
cell's spans ``prt.sky_grad`` and ``prt.recompute``, the innermost open at
the launch), per ``prt.forward`` span, in the traced step."""
from benchmark.harness.spans import device_ms

SPANS = ("prt.sky_grad", "prt.recompute")


def read(data):
    if "trace" not in data:
        return None
    return device_ms(data["trace"], "prt.sky_grad", SPANS, "prt.forward")
