"""The port's graft hook (``graft.entry``) against the JAX package's
``__graft_entry__.entry``, and the bounce-level and several-rank tools
(``tools.bounces``, ``bounce_parts``, ``trace_bounce``, ``bisect_bounce``,
``profile_floor``, ``bwd_anatomy``, ``spmd_audit``, ``scaling_bench``) run
through their ``main`` on the CPU at tiny sizes: each prints the reference
tool's names as JSON lines, and each exits 1 when the card it defaults to
is absent.

Both hooks load their scene with the same BVH builder (``same_bvh_build``):
the native and the Python builders order the triangles differently, and a
test process can be without the JAX package's native library (its build is
shared by every process that builds it at once, and a process that loses
that race keeps none).

The hook's radiance is held to the jitted JAX fn at the render-parity
bound of the 32-bounce budget, rtol = atol = 5e-4 (tests/test_torch_render.py:
ulp differences between the frameworks' transcendental functions grow
through deep bouncing), both on the brute mesh path, the CPU's pick for the
80-triangle icosphere.  ``spmd_audit``'s counts are
tests/test_torch_parallel.py's.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.runtime import native as j_native
from photorealistic_rendering_using_opencl_tpu_torch import graft
from photorealistic_rendering_using_opencl_tpu_torch.parallel import render
from photorealistic_rendering_using_opencl_tpu_torch.runtime import native as p_native
from photorealistic_rendering_using_opencl_tpu_torch.tools import (
    bisect_bounce, bounce_parts, bounces, bwd_anatomy, profile_floor,
    scaling_bench, spmd_audit, trace_bounce,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER_TOL = 5e-4  # tests/test_torch_render.py's bound at 32 bounces
SMALL = os.path.join(REPO, "scenes", "cornell.json")  # 320-triangle stand-in
SIMPLE = os.path.join(REPO, "scenes", "cornell_simple.json")
TOOLS = {"bounces": bounces, "bounce_parts": bounce_parts,
         "trace_bounce": trace_bounce, "bisect_bounce": bisect_bounce,
         "profile_floor": profile_floor, "bwd_anatomy": bwd_anatomy,
         "spmd_audit": spmd_audit, "scaling_bench": scaling_bench}
CPU_LINE_KEYS = {"device", "nvidia_smi", "timed_by"}


def same_bvh_build(monkeypatch):
    """Both packages build BVHs the same way for the rest of the test:
    natively when both native libraries load in this process, else both
    in Python (PRT_NO_NATIVE, which each package reads at every call)."""
    if j_native.get_lib() is None or p_native.get_lib() is None:
        monkeypatch.setenv("PRT_NO_NATIVE", "1")


def lose_jax_library(monkeypatch):
    """The JAX package's native library made unavailable in this process,
    as a process that lost its build race is left."""
    monkeypatch.setattr(j_native, "_lib_tried", True)
    monkeypatch.setattr(j_native, "_lib", None)


def _jax_entry():
    spec = importlib.util.spec_from_file_location(
        "graft_entry_jax", os.path.join(REPO, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


def test_entry_matches_jax_entry(monkeypatch):
    _entry_matches(monkeypatch)


def test_entry_matches_jax_entry_with_the_jax_library_lost(monkeypatch):
    """The same with the JAX package's native library made unavailable in
    this process (a lost build race): both hooks build in Python."""
    lose_jax_library(monkeypatch)
    assert j_native.get_lib() is None
    _entry_matches(monkeypatch)
    assert os.environ.get("PRT_NO_NATIVE") == "1"


def _entry_matches(monkeypatch):
    same_bvh_build(monkeypatch)
    monkeypatch.chdir(REPO)  # the JAX hook loads scenes/cornell.json
    j_fn, (j_scene, j_cam) = _jax_entry()
    want = np.asarray(jax.jit(j_fn)(j_scene, j_cam))
    fn, (scene, cam) = graft.entry("cpu")
    cfg, _ = graft.tiny_scene("cpu")
    assert cfg.mesh_accel == "brute" and cfg.n_triangles == 80
    assert scene.device.type == "cpu"
    for k, v in cam.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j_cam[k]))
    for name in ("color", "position", "params", "quad_base", "bf_tri_verts"):
        np.testing.assert_array_equal(getattr(scene, name).numpy(),
                                      np.asarray(getattr(j_scene, name)))
    got = fn(scene, cam)
    assert got.shape == (graft.WIDTH * graft.HEIGHT, 3)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=RENDER_TOL,
                               atol=RENDER_TOL)
    assert float(got.mean()) > 0


def test_entry_defaults_to_the_card():
    """No card here: the default device raises, with no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft.entry()


def test_dryrun_multichip_is_the_parallel_one():
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import dryrun
    assert graft.dryrun_multichip is dryrun.dryrun_multichip


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _last_is_cpu(rows):
    assert CPU_LINE_KEYS <= set(rows[-1]) and rows[-1]["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_exits_without_a_card(name, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = {"bwd_anatomy": ["8", "1"]}.get(name, [])
    assert TOOLS[name].main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_bounces_keys(capsys):
    assert bounces.main(["--width", "8", "--scene", SMALL,
                         "--device", "cpu"]) == 0
    rows = _lines(capsys)
    assert {"lanes", "bounces_budget"} <= set(rows[0]) and rows[0]["lanes"] == 64
    per = rows[1:-1]
    assert per and all(set(r) == {"bounce", "ms", "alive", "alive_frac"}
                       for r in per)
    assert [r["bounce"] for r in per] == list(range(len(per)))
    assert all(0 <= r["alive"] <= 64 for r in per)
    assert "total_s" in rows[-1]
    _last_is_cpu(rows)


def test_bounce_parts_keys(capsys):
    assert bounce_parts.main(["--lanes", "32", "64", "--scene", SMALL,
                              "--device", "cpu"]) == 0
    rows = _lines(capsys)
    parts = rows[:-1]
    assert all({"lanes", "name", "ms", "device_ms", "kernels"} == set(r)
               for r in parts)
    names = {r["name"] for r in parts}
    for want in ("shade_step", "rng", "analytic sweep", "ray sort",
                 "mesh kernel (all active)", "validate + reattach",
                 "bounce_step (all alive)", "intersect_scene (all)",
                 "shadow_visible (all)", "tri_reattach + smooth normal",
                 "bounce_step analytic scene"):
        assert want in names, want
    assert {r["lanes"] for r in parts} == {32, 64}
    assert all(r["kernels"] > 0 and r["device_ms"] is None for r in parts)
    _last_is_cpu(rows)


def test_trace_bounce_keys(capsys):
    assert trace_bounce.main(["--lanes", "64", "--steps", "2", "--top", "5",
                              "--scene", SMALL, "--device", "cpu"]) == 0
    rows = _lines(capsys)
    assert {"total_traced_op_us", "kernels", "wall_ms", "idle_ms",
            "largest_gaps_us"} <= set(rows[0])
    assert len(rows[1:-1]) == 5
    assert all(set(r) == {"ms", "name", "calls"} for r in rows[1:-1])
    _last_is_cpu(rows)


def test_device_gaps():
    got = trace_bounce.device_gaps([(10, 20), (0, 5), (15, 30), (40, 41)])
    assert got["idle_ms"] == pytest.approx((5 + 10) / 1e3)
    assert got["largest_gaps_us"] == [10, 5]
    assert got["idle_share"] == pytest.approx(15 / 41)


@pytest.mark.parametrize("isect", [False, True])
def test_bisect_bounce_keys(capsys, isect):
    argv = ["--lanes", "64", "--scene", SMALL, "--device", "cpu"] + (
        ["--isect"] if isect else [])
    assert bisect_bounce.main(argv) == 0
    rows = _lines(capsys)
    names = [r["name"] for r in rows[:-1]]
    assert names == (["isect t only", "isect all outputs", "mesh kernel t+tri",
                      "kernel + reattach + normal"] if isect
                     else list(bisect_bounce.FORMS))
    assert all({"ms", "device_ms", "kernels"} <= set(r) for r in rows[:-1])
    _last_is_cpu(rows)


def test_bisect_stubs_are_put_back():
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    real = integrator.intersect_scene, integrator.shadow_visible
    with bisect_bounce.stubbed("both stubbed"):
        assert integrator.intersect_scene is bisect_bounce.fake_isect
        assert integrator.shadow_visible is bisect_bounce.fake_shadow
    assert (integrator.intersect_scene, integrator.shadow_visible) == real


def test_profile_floor_keys(capsys):
    assert profile_floor.main(["--lanes", "32", "64", "--scene", SMALL,
                               "--device", "cpu"]) == 0
    rows = _lines(capsys)
    names = {r.get("name") for r in rows}
    for want in ("block_relevance alone", "mesh kernel (all active)",
                 "intersect_scene", "bounce_step full",
                 "bounce_step analytic-only scene", "bsdf sample (full set)",
                 "bsdf evaluate (full set)"):
        assert want in names, want
    assert [r["lanes"] for r in rows if set(r) == {"lanes"}] == [32, 64]
    _last_is_cpu(rows)


def test_bwd_anatomy_keys(capsys):
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    san = integrator._sanitize_grad
    assert bwd_anatomy.main(["8", "1", "nosan", "--reps", "1", "--device",
                             "cpu"]) == 0
    assert integrator._sanitize_grad is san
    rows = _lines(capsys)
    (r,) = rows[:-1]
    assert {"variant", "iters", "chunk", "best", "fwd", "bwd", "rate", "temp",
            "compile"} <= set(r)
    assert r["variant"] == "nosan" and r["temp"] is None
    assert r["best"] == pytest.approx(r["fwd"] + r["bwd"])
    _last_is_cpu(rows)


def test_bwd_anatomy_leaves():
    fn, (scene, cam) = graft.entry("cpu")
    cam_leaves = bwd_anatomy.leaves_of("cam", scene, cam)
    assert set(cam_leaves) == {f"camera.{k}" for k in cam}
    assert set(bwd_anatomy.leaves_of("mat", scene, cam)) == {
        f"scene.{f}" for f in bwd_anatomy.GROUPS["mat"]}
    every = bwd_anatomy.leaves_of("all", scene, cam)
    assert "scene.obj_color" in every and not any(
        k.startswith("camera.") for k in every)
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    chunk = integrator.SCAN_CHUNK
    with bwd_anatomy.knobs("chunk4"):
        assert integrator.SCAN_CHUNK == 4
    assert integrator.SCAN_CHUNK == chunk


def test_spmd_audit_counts_are_the_parallel_tests(capsys):
    """tests/test_torch_parallel.py's counts: a render 1 all_gather on 2
    ranks and none on 1; a step 2 all_reduces, the loss and the 132-byte
    gradient buffer of cornell_simple, on 1 and 2 ranks."""
    assert spmd_audit.main(["--ranks", "1", "2", "--scene", SIMPLE,
                            "--device", "cpu"]) == 0
    rows = _lines(capsys)
    by = {(r["program"], r["n_devices"]): r for r in rows[:-1]}
    assert set(by) == {("render_sharded", 1), ("train_step", 1),
                       ("render_sharded", 2), ("train_step", 2)}
    for world in (1, 2):
        fwd, bwd = by["render_sharded", world], by["train_step", world]
        assert fwd["counts"]["all-gather"] == (world > 1)
        assert fwd["total_collectives"] == (world > 1)
        assert bwd["counts"]["all-reduce"] == bwd["total_collectives"] == 2
        assert bwd["param_gradient_bytes"] == 132
        assert bwd["bytes"]["all-reduce"] == 4 + 132
        assert fwd["backend"] == "gloo"
    # the gathered (radiance, alpha) blocks: 16^2 pixels of 4 floats
    assert by["render_sharded", 2]["bytes"]["all-gather"] == 16 * 16 * 4 * 4
    _last_is_cpu(rows)
    assert set(spmd_audit.COLLECTIVE_KINDS) <= set(by["train_step", 1]["counts"])
    assert render.RAYS_AXIS == "rays"


def test_spmd_audit_census_puts_functions_back():
    real = torch.distributed.all_reduce
    with spmd_audit.Census():
        assert torch.distributed.all_reduce is not real
    assert torch.distributed.all_reduce is real


@pytest.mark.parametrize("ranks", [1, 2])
def test_scaling_bench_keys(capsys, monkeypatch, ranks):
    """Weak scaling on the CPU's gloo ranks (8^2 pixels a rank at 1 spp);
    one rank prints no scaling number, as one card does."""
    monkeypatch.setattr(scaling_bench, "PER_DEV_SIDE", 8)
    monkeypatch.setattr(scaling_bench, "SPP", 1)
    assert scaling_bench.main(["--max-ranks", str(ranks), "--device",
                               "cpu"]) == 0
    (row,) = _lines(capsys)
    assert {"metric", "per_device_pixels", "spp", "host_cores",
            "points"} <= set(row)
    assert [p["n_devices"] for p in row["points"]] == list(range(1, ranks + 1))
    assert row["per_device_pixels"] == 64 and row["spp"] == 1
    if ranks == 1:
        assert row["note"] and set(row["points"][0]) == {"n_devices",
                                                         "seconds"}
    else:
        assert row["note"] is None
        assert all({"parallel_speedup", "vs_core_ceiling"} <= set(p)
                   for p in row["points"])
    assert row["device"] == "cpu"
