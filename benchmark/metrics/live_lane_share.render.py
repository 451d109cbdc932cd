"""The share of the lanes the bounce loop shades that are alive: the
program's ``loop.live_lanes`` over ``loop.lanes`` (every lane, every bounce
run) in the traced passes.  The loop runs its kernels over all lanes, so
1 - this share is the work that compacting the lanes would save."""
from benchmark.harness.spans import share


def read(data):
    if "trace" not in data:
        return None
    return share("loop.live_lanes", "loop.lanes")
