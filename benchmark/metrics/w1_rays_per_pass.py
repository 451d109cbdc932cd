"""Rays the BVH walk W1 is asked to walk in a pass: the program's
``w1.rays`` (the active lanes of each ``intersect.bvh_traverse`` call,
summed after the traced passes) per ``prt.pass`` span."""
from benchmark.harness.spans import count, counter


def read(data):
    if "trace" not in data:
        return None
    rays, passes = counter("w1.rays"), count(data["trace"], "prt.pass")
    if rays is None or passes == 0:
        return None
    return rays / passes
