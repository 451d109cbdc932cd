"""CPU tests of the readers of the program's own spans and counters
(``harness/spans.py`` and the metrics that use it): their arithmetic on a
made-up trace, and a traced run of each tiny cell, in which the counters
read, the device times are None (the CPU has no device trace), and the
metrics the benchmark had before read the same with the program's spans in
the trace as without them.  Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import dataclasses

import pytest

from benchmark.harness import core, spans, trace
from benchmark.tests.tiny import TINY_CELLS, tiny_tree

# the cells' metrics that read the program's spans or counters
NEW = {"tiny_mesh.tiny_render": {
           "counters": ("live_lane_share.render", "w1_rays_per_pass"),
           "device": ("shade_ms.render", "intersect_ms.render",
                      "shade_wait_ms.render")},
       "tiny_env.tiny_grad": {
           "counters": ("live_lane_share.grad",),
           "device": ("sky_grad_ms.grad", "recompute_ms.grad")}}
RENDER = ("prt.shade", "prt.intersect")


def _trace():
    # one pass 0-100 on thread 7 holding shade 10-40 and intersect 50-90;
    # kernels launched at 12 (shade), 55 (intersect), 95 (the pass alone)
    # and by thread 8 at 20 (no span there); k5's launch is not traced
    return trace.TraceData(
        region=(0, 200),
        device=[(30, 50, "k1", True, 1), (60, 100, "k2", True, 2),
                (120, 130, "k3", True, 3), (140, 150, "k4", True, 4),
                (170, 175, "k5", True, 5)],
        host=[(0, 100, "prt.pass", 7), (10, 40, "prt.shade", 7),
              (50, 90, "prt.intersect", 7), (11, 14, "aten::mul", 7)],
        launches={1: (12, 7), 2: (55, 7), 3: (95, 7), 4: (20, 8)})


def test_each_operation_goes_to_the_innermost_span_at_its_launch():
    d = _trace()
    got = {op[2]: s for op, s in spans.launched_in(d, RENDER)}
    # k5 has no launch in the trace and is left out
    assert got == {"k1": "prt.shade", "k2": "prt.intersect", "k3": None,
                   "k4": None}
    assert spans.count(d, "prt.pass") == 1
    assert spans.device_ms(d, "prt.shade", RENDER, "prt.pass") == \
        pytest.approx(20e-6)
    assert spans.device_ms(d, "prt.intersect", RENDER, "prt.pass") == \
        pytest.approx(40e-6)
    # the pass holds them: innermost among all three, k3 goes to the pass
    every = RENDER + ("prt.pass",)
    assert spans.device_ms(d, "prt.pass", every, "prt.pass") == \
        pytest.approx(10e-6)
    assert spans.device_ms(d, "prt.shade", RENDER, "prt.forward") is None
    assert spans.device_ms(dataclasses.replace(d, device=[]), "prt.shade",
                           RENDER, "prt.pass") is None


def test_a_wait_goes_to_the_span_that_launched_the_gap_s_end():
    d = _trace()
    # gaps: 0-30 (ends at k1, shade), 50-60 (k2, intersect), 100-120 (k3,
    # the pass alone), 130-140 (k4, thread 8), 150-170 (k5, no launch),
    # 175-200 (the end)
    assert spans.wait_ms(d, "prt.shade", RENDER, "prt.pass") == \
        pytest.approx(30e-6)
    assert spans.wait_ms(d, "prt.intersect", RENDER, "prt.pass") == \
        pytest.approx(10e-6)


def test_counters_of_a_program_without_a_tracer_read_none(monkeypatch):
    from photorealistic_rendering_using_opencl_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "TRACER")
    assert spans.counter("w1.rays") is None
    assert spans.share("loop.live_lanes", "loop.lanes") is None


def _without_program_spans(layer: dict) -> dict:
    data = layer["trace"]
    bare = dataclasses.replace(data, host=[
        h for h in data.host if not h[2].startswith(spans.PREFIX)])
    return dict(layer, trace=bare)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS.values()))
def test_a_traced_tiny_run_reads_the_program_s_spans_and_counters(
        cell, tmp_path, monkeypatch):
    monkeypatch.setenv("PRT_MESH_ACCEL", "bvh")
    root = tiny_tree(str(tmp_path))
    res = core.run(root, cell, 2**31 + 907, 0.01, True, device="cpu")
    assert res["correct"], res["checks"]
    layer = res["layer"]
    assert [h for h in layer["trace"].host
            if h[2].startswith(spans.PREFIX)]
    for name in NEW[cell]["counters"]:
        assert name in res["metrics"], name
        assert res["metrics"][name]["value"] > 0.0
    for name in NEW[cell]["device"]:
        assert name not in res["metrics"], name
        assert core.load_reader(name, root)(layer) is None
    share = [m for m in res["metrics"] if m.startswith("live_lane_share")]
    assert share and res["metrics"][share[0]]["value"] < 1.0
    # the metrics that read no span read the same without the spans
    spec = core.load_spec(root)
    bare = _without_program_spans(layer)
    new = set(NEW[cell]["counters"] + NEW[cell]["device"])
    old = [m["name"] for m in core.metrics_for(spec, cell, True)
           if m["name"] not in new]
    assert len(old) in (4, 5)
    for name in old:
        read = core.load_reader(name, root)
        assert read(bare) == read(layer), name
