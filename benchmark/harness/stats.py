"""Rates, windows and percentiles: the benchmark's arithmetic."""
from __future__ import annotations

import math
import statistics


def rate(work: float, seconds: float) -> float:
    """Work done over the whole window, per second."""
    if seconds <= 0.0:
        raise ValueError(f"window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics, numpy's default ("linear") method."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def leaf_norm_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between two norms: |prog - ref| over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(ref.values())
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in ref)
