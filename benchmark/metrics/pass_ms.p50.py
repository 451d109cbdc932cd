"""The 50th percentile of the untraced passes' times (CUDA events at the
pass boundaries, read after the window), ms."""
from benchmark.harness.stats import percentile


def read(data):
    return percentile(data["pass_ms"], 50) if data.get("pass_ms") else None
