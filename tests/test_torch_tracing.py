"""The port's tracer (``utils/profiling``): its spans under ``torch.profiler``
on a small mesh Cornell box (progressive passes, the bounce loop and the
BVH walk's CPU twin) and a small inverse-rendering step under a sky with a
thin lens (``regen_scan``, checkpoints, the sky map's gradient scatter).

The spans must nest as the program runs, on the profiler's own clock;
backward spans must carry their forward's step; the counters must equal
counts made directly; and the tracer must change no result and record
nothing while no profiler records.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photorealistic_rendering_using_opencl_tpu_torch.diff import inverse
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.utils import profiling
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDE = 8
LEAVES = ("env_map", "color")


def _doc(name: str, **settings) -> dict:
    with open(os.path.join(REPO, "scenes", name)) as fh:
        doc = json.load(fh)
    doc.setdefault("settings", {}).update(settings)
    return doc


def _events(prof) -> list:
    """(start, end, name, thread, request) of every host event."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != torch.autograd.DeviceType.CPU:
            continue
        s = ev.start_ns()
        out.append((s, s + ev.duration_ns(), ev.name(), ev.start_thread_id(),
                    ev.kwinputs().get("request")))
    return out


def _inside(e, spans) -> bool:
    return any(s[0] <= e[0] and e[1] <= s[1] and s[3] == e[3] for s in spans)


def _named(events, name):
    return [e for e in events if e[2] == name]


class _Direct:
    """Counts made directly, by wrapping the counted functions: the alive
    lanes entering each forward ``shade_step`` and the lanes each
    ``bvh_traverse`` call asks to walk."""

    def __init__(self, mp):
        self.shades, self.lanes, self.alive = 0, 0, 0
        self.walks, self.rays = 0, 0
        shade, walk = integrator.shade_step, intersect.bvh_traverse

        def counted_shade(cfg, scene, state, hit, sampler):
            if not profiling.in_backward():
                self.shades += 1
                self.lanes += state.alive.shape[0]
                self.alive += int(state.alive.sum())
            return shade(cfg, scene, state, hit, sampler)

        def counted_walk(scene, origin, direction, t_init, any_hit=False,
                         active=None, count_steps=False):
            self.walks += 1
            self.rays += (origin.shape[0] if active is None
                          else int(active.sum()))
            return walk(scene, origin, direction, t_init, any_hit, active,
                        count_steps)

        mp.setattr(integrator, "shade_step", counted_shade)
        mp.setattr(intersect, "bvh_traverse", counted_walk)


@pytest.fixture(scope="module")
def render_run():
    """One pass of a small mesh Cornell box (BVH walk), untraced with the
    counted functions wrapped, then under the profiler (with Python
    stacks, so that shade_step's own calls show)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRT_MESH_ACCEL", "bvh")
        cfg, scene = build_scene(
            _doc("cornell.json"),
            mesh_override=make_icosphere(1, 0.8, (0.0, -0.8, 0.0)),
            device="cpu")
    assert cfg.mesh_accel == "bvh"
    cam = default_camera(SIDE, SIDE).pytree("cpu")
    state = pathtracer.progressive_init(SIDE, SIDE, seed=5, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        direct = _Direct(mp)
        plain = pathtracer.progressive_step(cfg, scene, cam, state)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                 with_stack=True) as prof:
        traced = pathtracer.progressive_step(cfg, scene, cam, state)
    counters = {k: TRACER.value(k) for k in (
        "loop.bounces", "loop.lanes", "loop.live_lanes", "w1.launches",
        "w1.rays")}
    return dict(plain=plain, traced=traced, events=_events(prof),
                request=TRACER.request, counters=counters, direct=direct,
                cfg=cfg, scene=scene, cam=cam, state=state)


@pytest.fixture(scope="module")
def grad_run():
    """A small fit step (regen_scan under a 16x8 sky, thin lens, 3
    bounces): one untraced with the counted functions wrapped, the same
    step again under the profiler."""
    env = np.random.default_rng(4).uniform(0.2, 2.0, (8, 16, 3))
    cfg, scene = build_scene(_doc("materials.json", MAX_BOUNCES=3),
                             env_map=env.astype(np.float32), device="cpu")
    cam = dataclasses.replace(default_camera(SIDE, SIDE),
                              aperture_radius=0.05,
                              focal_distance=4.0).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, scene, cam, SIDE, SIDE, 1,
                                         seed=2, margin=2.0)
    with torch.no_grad():
        target = pathtracer.render(cfg, scene, cam, SIDE, SIDE, 1, seed=9,
                                   method="regen")[0]
    loss_fn = inverse.make_loss_fn(cfg, scene, cam, SIDE, SIDE, 1, target,
                                   LEAVES, method="regen_scan",
                                   regen_iters=n)

    def step():
        params = {k: getattr(scene, k).clone().requires_grad_()
                  for k in LEAVES}
        loss = loss_fn(params, 2)
        loss.backward()
        return loss.detach(), {k: p.grad for k, p in params.items()}

    with pytest.MonkeyPatch.context() as mp:
        direct = _Direct(mp)
        plain = step()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        traced = step()
        forward = TRACER.request
    counters = {k: TRACER.value(k) for k in (
        "regen.iterations", "regen.lanes", "regen.live_lanes")}
    return dict(plain=plain, traced=traced, events=_events(prof),
                request=forward, counters=counters, direct=direct,
                iters=pathtracer.scan_iterations(n))


def test_render_spans_nest_and_hold_every_op_of_shade_step(render_run):
    ev = render_run["events"]
    passes = _named(ev, "prt.pass")
    shades, isects = _named(ev, "prt.shade"), _named(ev, "prt.intersect")
    assert len(passes) == 1
    assert shades and isects
    assert all(_inside(e, passes) for e in shades + isects)
    assert {e[4] for e in passes + shades + isects} == {render_run["request"]}
    # every ATen op that shade_step issues lies inside a prt.shade span:
    # its Python frames (the profiler's own events, on the same clock)
    # hold them
    frames = [e for e in ev if e[2].endswith(": shade_step")
              and "integrator.py" in e[2]]
    assert len(frames) == len(shades)
    ops = [e for e in ev if e[2].startswith("aten::") and _inside(e, frames)]
    assert ops
    assert all(_inside(e, shades) for e in ops)
    # and the merged dispatch's walk runs inside prt.intersect
    walks = [e for e in ev if e[2].endswith(": _bvh_traverse_chunk")]
    assert walks and all(_inside(e, isects) for e in walks)


def test_backward_spans_carry_their_forward_step(grad_run):
    ev, req = grad_run["events"], grad_run["request"]
    forwards = _named(ev, "prt.forward")
    recomputes, sky = _named(ev, "prt.recompute"), _named(ev, "prt.sky_grad")
    assert len(forwards) == 1 and forwards[0][4] == req
    assert len(recomputes) == grad_run["iters"]
    # two sky lookups a shading step (a miss, the sky's NEE), four taps each
    assert len(sky) == 8 * grad_run["iters"]
    assert {e[4] for e in recomputes + sky} == {req}
    # both run in the backward, after the forward
    assert all(e[0] >= forwards[0][1] for e in recomputes + sky)
    # each tap's span holds its scatter (the colour table's lookups
    # scatter too, outside them)
    puts = [e for e in ev if e[2] == "aten::_index_put_impl_"]
    assert all(sum(_inside(p, [s]) for p in puts) == 1 for s in sky)
    # a recompute's shading carries the forward's step too
    reshade = [e for e in _named(ev, "prt.shade") if _inside(e, recomputes)]
    assert len(reshade) == grad_run["iters"]
    assert {e[4] for e in reshade} == {req}
    fwd_shade = [e for e in _named(ev, "prt.shade") if _inside(e, forwards)]
    assert len(fwd_shade) == grad_run["iters"]


def test_tracer_off_records_nothing(render_run, monkeypatch):
    assert not TRACER.on
    assert TRACER.span("prt.shade") is TRACER.recompute(1)
    monkeypatch.setattr(profiling.Metrics, "on", property(lambda _: False))
    TRACER.reset()
    r = render_run
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = pathtracer.progressive_step(r["cfg"], r["scene"], r["cam"],
                                          r["state"])
    assert not [e for e in _events(prof) if e[2].startswith("prt.")]
    assert TRACER.counters == {} and TRACER.value("w1.rays") == 0
    assert torch.equal(out.acc, r["plain"].acc)


def test_images_and_gradients_bitwise_equal_traced_or_not(render_run,
                                                          grad_run):
    assert torch.equal(render_run["traced"].acc, render_run["plain"].acc)
    assert torch.equal(render_run["traced"].alpha, render_run["plain"].alpha)
    (l0, g0), (l1, g1) = grad_run["plain"], grad_run["traced"]
    assert torch.equal(l0, l1)
    for k in LEAVES:
        assert g0[k] is not None and torch.equal(g0[k], g1[k]), k


def test_loop_and_walk_counters_equal_direct_counts(render_run):
    c, d = render_run["counters"], render_run["direct"]
    assert c["loop.bounces"] == d.shades > 0
    assert c["loop.lanes"] == d.lanes == d.shades * SIDE * SIDE
    assert c["loop.live_lanes"] == d.alive
    assert 0 < c["loop.live_lanes"] < c["loop.lanes"]
    assert c["w1.launches"] == d.walks > 0
    assert c["w1.rays"] == d.rays > 0


def test_regen_counters_equal_direct_counts(grad_run):
    c, d = grad_run["counters"], grad_run["direct"]
    assert c["regen.iterations"] == d.shades == grad_run["iters"]
    assert c["regen.lanes"] == d.lanes == d.shades * SIDE * SIDE
    assert c["regen.live_lanes"] == d.alive
    assert 0 < c["regen.live_lanes"] < c["regen.lanes"]


def test_a_mask_changed_in_place_makes_the_read_raise():
    t = profiling.Metrics()
    mask = torch.tensor([True, False, True])
    with profile(activities=[ProfilerActivity.CPU]):
        t.count_mask("m", mask)
        t.count("m", 4)
    assert t.value("m") == 6
    mask[1] = True
    with pytest.raises(RuntimeError, match="changed in place"):
        t.value("m")


def test_torch_trace_switches_the_tracer_only_while_it_records(
        render_run, tmp_path):
    r = render_run
    with profiling.torch_trace(str(tmp_path)):
        assert TRACER.on
        pathtracer.progressive_step(r["cfg"], r["scene"], r["cam"], r["state"])
    assert not TRACER.on
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    spans = [e for e in trace["traceEvents"] if e.get("name") == "prt.pass"]
    assert len(spans) == 1 and spans[0]["args"]["request"] == TRACER.request
    with pytest.raises(ValueError):
        with profiling.torch_trace(str(tmp_path / "raised")):
            assert TRACER.on
            raise ValueError("the work inside raised")
    assert not TRACER.on
    assert (tmp_path / "raised" / profiling.TRACE_FILE).is_file()
