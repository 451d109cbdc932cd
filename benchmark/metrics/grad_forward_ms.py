"""The median over the untraced steps of the forward (the loss function's
call), ms, by CUDA events at the step's boundaries."""
from benchmark.harness.stats import percentile


def read(data):
    ms = data.get("forward_ms")
    return percentile(ms, 50) if ms else None
