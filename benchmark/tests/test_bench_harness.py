"""CPU tests of the benchmark's harness: its arithmetic, the trace reading,
that cells, configurations, traffic mixes and metrics are found by name
from files alone, and that a dry run of each cell on the CPU loads nothing
of JAX.  Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark.harness import core, inputs, roofline, stats, trace
from benchmark.tests.tiny import REPO, TINY_CELLS, tiny_tree


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(30 * 2_073_600, 40.0) == pytest.approx(1_555_200.0)
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
def test_percentile_is_numpys_linear_one(q):
    xs = np.random.default_rng(3).gamma(2.0, 300.0, size=37)
    assert stats.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


def test_leaf_norm_gap_is_the_worst_leaf_against_the_median_floor():
    ref = {"env_map": 2.0, "color": 1e-6, "obj_color": 4.0}
    prog = {"env_map": 2.02, "color": 2e-6, "obj_color": 4.0}
    # color's own norm is all but zero: its gap counts against the median
    assert stats.leaf_norm_gap(prog, ref) == pytest.approx(0.01)


def test_w1_bytes_on_a_tiny_mesh():
    verts, _ = inputs.icosphere(0, 1.0, (0.0, 0.0, 0.0))
    t = verts.shape[0]
    assert t == 20
    got = roofline.w1_bytes(t, launches=3, rays=1000)
    assert got == 3 * t * 36 + 1000 * (30 + 16)
    assert roofline.least_seconds(got) == pytest.approx(got / 3.35e12)


def test_icosphere_recipe_is_the_programs():
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import (
        make_icosphere)
    for sub, r, c in ((0, 1.0, (0, 0, 0)), (3, 1.2, (0.0, -0.8, 0.0))):
        v, n = inputs.icosphere(sub, r, c)
        pv, pn = make_icosphere(sub, r, c)
        np.testing.assert_array_equal(v, pv)
        np.testing.assert_array_equal(n, pn)


def test_w1_rays_are_counted_after_the_traced_passes():
    import torch
    from benchmark.kinds import render
    o = torch.zeros(6, 3)
    mask = torch.tensor([1, 0, 1, 1, 0, 0], dtype=torch.bool)
    calls = [render._w1_rays(None, None, None, o, o, None),
             render._w1_rays(None, None, None, o, o, None, active=False),
             render._w1_rays(None, None, None, o, o, None, active=mask)]
    assert render._count_rays(calls) == 6 + 0 + 3
    mask[1] = True  # changed in place after its launch: not countable
    with pytest.raises(RuntimeError):
        render._count_rays(calls)


def _trace():
    # kernels at 10-30, 20-40, 60-70 and a copy at 95-120 in a region 0-100;
    # host: aten::add (0-8) launched kernel 1 at 5, aten::mul (44-50)
    # launched kernel 3 at 47, both on thread 7
    return trace.TraceData(
        region=(0, 100),
        device=[(10, 30, "a", True, 1), (20, 40, "b", True, 2),
                (60, 70, "a", True, 3), (95, 120, "Memcpy", False, 4)],
        host=[(0, 8, "aten::add", 7), (44, 50, "aten::mul", 7),
              (46, 49, "aten::empty", 8)],
        launches={1: (5, 7), 2: (15, 7), 3: (47, 7), 4: (80, 7)})


def test_interval_union_and_idle_share():
    d = _trace()
    assert trace.union(d.device, 0, 100) == [(10, 40), (60, 70), (95, 100)]
    assert trace.busy_s(d) == pytest.approx(45e-9)
    # against an untraced unit of 90 (the region's 100 holds the profiler's
    # own cost), one unit and two
    assert trace.idle_share(d, 90e-9) == pytest.approx(0.5)
    assert trace.idle_share(d, 45e-9, units=2) == pytest.approx(0.5)
    assert trace.idle_share(d, 0.0) is None
    assert trace.gaps(d) == [(0, 10), (40, 60), (70, 95)]
    assert d.kernels == 3
    assert d.kernel_seconds("a") == pytest.approx(30e-9)


def test_breakdown_names_each_gap_by_the_op_that_launched_its_end():
    b = trace.breakdown(_trace())
    assert b["device_ops"][0] == ["a", pytest.approx(30e-9)]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    # 0-10 ends with kernel 1 (launched inside aten::add), 40-60 with
    # kernel 3 (aten::mul, thread 7; thread 8's op is not the launcher's),
    # 70-95 with the copy, launched where no op was open
    assert idle == {"aten::add": pytest.approx(10e-9),
                    "aten::mul": pytest.approx(20e-9),
                    "python": pytest.approx(25e-9)}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    stub = types.ModuleType("stub")
    monkeypatch.setitem(sys.modules,
                        "photorealistic_rendering_using_opencl_tpu_torchx.a",
                        stub)
    assert "photorealistic_rendering_using_opencl_tpu" not in \
        core.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", stub)
    assert "jaxlib" in core.forbidden_loaded()


def test_a_config_traffic_mix_and_metric_added_as_files_are_found(tmp_path):
    root = tiny_tree(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "tiny_mesh.json")) as fh:
        cfg = json.load(fh)
    cfg["camera"]["yaw"] = 0.4
    with open(os.path.join(bench, "configs", "yawed.json"), "w") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(bench, "traffic", "tiny_render.json")) as fh:
        mix = json.load(fh)
    mix.update(width=12, height=8)
    with open(os.path.join(bench, "traffic", "small.json"), "w") as fh:
        json.dump(mix, fh)
    with open(os.path.join(bench, "metrics", "passes_run.py"), "w") as fh:
        fh.write("def read(data):\n    return data['passes']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "yawed", "source": "tests",
                            "file": "benchmark/configs/yawed.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "yawed.small", "config": "yawed",
                              "traffic": "small", "chips": 1, "why": "t"})
    for m in spec["end_to_end"]:
        if "cornell_mesh.render" in m.get("workloads", []):
            m["workloads"].append("yawed.small")
    spec["per_layer"].append({
        "name": "passes_run", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "CLI / progressive step",
        "moves": "render_samples_per_s", "workloads": ["yawed.small"]})
    # a metric without a cell list goes to every cell that reports the
    # end-to-end metric it moves
    spec["per_layer"].append({
        "name": "passes_everywhere", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "CLI / progressive step",
        "moves": "render_samples_per_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)

    spec = core.load_spec(root)
    found = core.find_cell(spec, root, "yawed.small")
    assert found["config"]["camera"]["yaw"] == 0.4
    assert found["traffic"]["width"] == 12
    assert core.load_kind(found["traffic"]["kind"]).__name__.endswith(
        "kinds.render")
    names = [m["name"] for m in core.metrics_for(spec, "yawed.small", True)]
    assert names == ["passes_run", "passes_everywhere"]
    assert "passes_everywhere" in [
        m["name"] for m in core.metrics_for(spec, "cornell_mesh.render", True)]
    assert "passes_everywhere" not in [
        m["name"] for m in core.metrics_for(spec, "env_lens.grad", True)]
    assert core.load_reader("passes_run", root)({"passes": 7}) == 7
    e2e = [m["name"] for m in core.metrics_for(spec, "yawed.small", False)]
    assert sorted(e2e) == ["render_samples_per_s", "setup_s"]


_DRY = """
import json, sys
sys.path.insert(0, {repo!r})
from benchmark.harness import core
res = core.run({root!r}, {cell!r}, 2**31 + 905, 0.01, False, device="cpu")
print(json.dumps({{"correct": res["correct"], "checks": res["checks"],
                  "metrics": sorted(res["metrics"]),
                  "loaded": core.forbidden_loaded()}}))
"""


@pytest.mark.parametrize("cell", sorted(TINY_CELLS.values()))
def test_a_cpu_dry_run_is_correct_and_loads_no_jax(cell, tmp_path):
    root = tiny_tree(str(tmp_path))
    env = dict(os.environ, PRT_MESH_ACCEL="bvh")
    out = subprocess.run([sys.executable, "-c",
                          _DRY.format(repo=REPO, root=root, cell=cell)],
                         capture_output=True, text=True, timeout=900,
                         env=env, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == []
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"]
