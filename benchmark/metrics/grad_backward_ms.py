"""The median over the untraced steps of ``loss.backward()``, Adam's step
and the clip at zero, ms, by CUDA events at the step's boundaries."""
from benchmark.harness.stats import percentile


def read(data):
    ms = data.get("backward_ms")
    return percentile(ms, 50) if ms else None
