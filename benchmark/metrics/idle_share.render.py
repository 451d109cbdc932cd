"""The device's idle share of a pass: 1 - (the union of the device
operations' intervals in the traced passes / as many times the median
span of the untraced passes, by CUDA events at their boundaries)."""
from benchmark.harness.stats import percentile
from benchmark.harness.trace import idle_share


def read(data):
    if "trace" not in data or not data.get("pass_ms"):
        return None
    return idle_share(data["trace"], percentile(data["pass_ms"], 50) / 1e3,
                      data["traced_passes"])
