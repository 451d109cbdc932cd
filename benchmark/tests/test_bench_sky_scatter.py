"""CPU tests of ``sky_grad_write_share.grad``, the share of the sky
lookups' taps that the sky map's gradient kernel writes, and of the
tracer's ``count_tensor``, which keeps a kernel's counts a block and sums
them after the traced region.  Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import core
from photorealistic_rendering_using_opencl_tpu_torch.utils import profiling
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import TRACER

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = "sky_grad_write_share.grad"


def _reader():
    return core.load_reader(NAME, ROOT)


def test_the_share_reads_writes_over_taps():
    read = _reader()
    with profile(activities=[ProfilerActivity.CPU]):
        TRACER.reset()
        TRACER.count("sky_grad.taps", 4 * 600)
        TRACER.count_tensor("sky_grad.writes",
                            torch.tensor([40, 0, 8], dtype=torch.int32))
    assert read({"trace": None}) == pytest.approx(48 / 2400)
    # an untraced run reports no per-layer metric
    assert read({}) is None


def test_the_share_reads_none_where_a_counter_is_missing(monkeypatch):
    read = _reader()
    with profile(activities=[ProfilerActivity.CPU]):
        TRACER.reset()  # a program whose sky lookups never ran backward
    assert read({"trace": None}) is None
    with profile(activities=[ProfilerActivity.CPU]):
        TRACER.count_tensor("sky_grad.writes",
                            torch.ones(3, dtype=torch.int32))
    assert read({"trace": None}) is None  # writes without taps
    monkeypatch.delattr(profiling, "TRACER")  # a program without a tracer
    assert read({"trace": None}) is None


def test_count_tensor_sums_a_block_buffer_after_the_region():
    counts = torch.empty(4, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]):
        TRACER.reset()
        TRACER.count_tensor("sky_grad.writes", counts)
        # the kernel fills the buffer by its pointer, after the count: no
        # change of the tensor's version
        version = counts._version
        counts.data.copy_(torch.tensor([3, 1, 4, 1], dtype=torch.int32))
        assert counts._version == version
    assert TRACER.value("sky_grad.writes") == 9
    counts.add_(1)  # a change in place after the count is refused
    with pytest.raises(RuntimeError, match="changed in place"):
        TRACER.value("sky_grad.writes")


def test_count_tensor_records_nothing_while_off():
    assert not TRACER.on
    TRACER.reset()
    TRACER.count_tensor("sky_grad.writes", torch.ones(5, dtype=torch.int32))
    TRACER.count("sky_grad.taps", 20)
    assert TRACER.value("sky_grad.writes") == 0
    assert TRACER.value("sky_grad.taps") == 0
