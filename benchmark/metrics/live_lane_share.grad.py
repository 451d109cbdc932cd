"""The share of the lanes the regeneration loop shades that are alive: the
program's ``regen.live_lanes`` over ``regen.lanes`` (every lane, every
iteration) in the traced step's forward.  The loop runs its kernels over
all lanes, its backward too, so 1 - this share is the work that
compacting the lanes would save."""
from benchmark.harness.spans import share


def read(data):
    if "trace" not in data:
        return None
    return share("regen.live_lanes", "regen.lanes")
