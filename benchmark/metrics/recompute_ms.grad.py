"""Device time of the checkpoints' recompute in a step, ms: the device
operations launched inside the program's ``prt.recompute`` spans (each
re-run of a checkpointed segment by the backward), per ``prt.forward``
span, in the traced step."""
from benchmark.harness.spans import device_ms

SPANS = ("prt.sky_grad", "prt.recompute")


def read(data):
    if "trace" not in data:
        return None
    return device_ms(data["trace"], "prt.recompute", SPANS, "prt.forward")
