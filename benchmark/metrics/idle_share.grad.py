"""The device's idle share of a step: 1 - (the union of the device
operations' intervals in the traced step / the median span of the
untraced steps, by CUDA events at their boundaries)."""
from benchmark.harness.stats import percentile
from benchmark.harness.trace import idle_share


def read(data):
    if "trace" not in data or not data.get("step_ms"):
        return None
    return idle_share(data["trace"], percentile(data["step_ms"], 50) / 1e3,
                      data["traced_steps"])
