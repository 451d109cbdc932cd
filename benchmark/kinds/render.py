"""Traffic kind "render": a closed loop of progressive passes, one sample of
every pixel a pass, accumulated into one state as the CLI's ``run_batch``
accumulates them, synchronising only where it does (every ``sync_every``
passes) and at the window's end.

Correct: after the window, a sample of pixels drawn from the seed is
traced again by the plain reference, every sample the window added, and
the sums compared.  The limits are set from sound runs and from the
control (PERF.md, "How correct is decided").
"""
from __future__ import annotations

import sys
import time

from benchmark.harness.core import card_state

# a checked pixel has parted from the reference when its sum lies further
# from the reference's than this share of the larger of the reference's
# value and a floor of 0.01 a sample (every channel)
PIXEL_TOL = 1e-4
PIXEL_FLOOR = 1e-2
# the limits, each between the highest reading of sound runs and the lowest
# of the control (PERF.md, section 2, gives both)
LIMITS = {"parted_share": 0.02, "sum_gap": 1e-4}


def compare(prog, ref, passes: int, prog_samples: int) -> dict:
    """The compared numbers, each with its limit: the share of checked
    pixels that parted, the relative gap of their summed radiance, and the
    state's sample count against the passes run."""
    import torch
    prog, ref = prog.double(), ref.double()
    scale = torch.clamp(ref.abs().amax(-1), min=PIXEL_FLOOR * passes)
    gap = (prog - ref).abs().amax(-1) / scale
    parted = float((gap > PIXEL_TOL).double().mean())
    sum_gap = float((prog.sum() - ref.sum()).abs() / ref.sum().abs())
    return {"parted_share": {"value": parted,
                             "limit": LIMITS["parted_share"]},
            "sum_gap": {"value": sum_gap, "limit": LIMITS["sum_gap"]},
            "samples_minus_passes": {"value": prog_samples - passes,
                                     "limit": 0}}


def passed(checks: dict) -> bool:
    return all(abs(c["value"]) <= c["limit"] for c in checks.values())


def run(found, seed, seconds, trace, device, since_start):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        pytree_from_numpy)
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import (
        build_scene)

    from benchmark.harness import inputs, stats, timing, trace as tr

    traffic = found["traffic"]
    w, h = int(traffic["width"]), int(traffic["height"])
    if int(traffic.get("spp_per_pass", 1)) != 1:
        raise ValueError("a progressive pass adds one sample a pixel")
    dev = torch.device(device)
    ins = inputs.build(found["config"], seed, w, h)
    cfg, scene = build_scene(ins["doc"], env_map=ins["env"],
                             mesh_override=ins["mesh"], device=dev)
    cam = pytree_from_numpy(ins["camera"], dev)
    run_seed = inputs.mix(seed, 1)

    # warm-up: every shape of the window, on an accumulation thrown away
    warm = pathtracer.progressive_init(w, h, seed=inputs.mix(seed, 2),
                                       device=dev)
    for _ in range(int(traffic["warmup_passes"])):
        warm = pathtracer.progressive_step(cfg, scene, cam, warm)
    timing.sync(dev)
    del warm

    sync_every = int(traffic["sync_every"])
    traced_from = int(traffic["traced_after"])
    traced = range(traced_from, traced_from + int(traffic["traced_passes"]))
    marks = timing.Marks(dev)
    prof = rays = None
    state = pathtracer.progressive_init(w, h, seed=run_seed, device=dev)
    setup_s = since_start()
    t0 = time.perf_counter()
    passes = 0
    spans = []  # each pass's (start, end) marks
    while (passes == 0 or time.perf_counter() - t0 < seconds
           or (trace and passes < traced.stop)):
        if trace and passes == traced.start:
            prof = tr.Profiled(dev).__enter__()
            rays = timing.CallCounter(bvh_walk, "walk", _w1_rays).__enter__()
        a = marks.mark()
        state = pathtracer.progressive_step(cfg, scene, cam, state)
        spans.append((a, marks.mark()))
        passes += 1
        if trace and passes == traced.stop:
            rays.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        if passes % sync_every == 0:
            timing.sync(dev)
    timing.sync(dev)
    window = time.perf_counter() - t0
    card = card_state(dev)

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    pass_ms = [marks.ms(a, b) for i, (a, b) in enumerate(spans)
               if i not in traced]
    n_pix = w * h
    gen = torch.Generator().manual_seed(inputs.mix(seed, 3))
    pick = torch.randperm(n_pix, generator=gen)[:int(traffic["check_pixels"])]
    pick = pick.to(dev)
    prog = state.acc.reshape(-1, 3)[pick].clone()
    prog_samples = int(state.samples)
    layer = {"pass_ms": pass_ms, "passes": passes}
    if trace:
        data = prof.data
        layer.update(
            trace=data, traced_passes=len(traced),
            w1_launches=len(rays.calls),
            w1_rays=_count_rays(rays.calls),
            n_triangles=0 if ins["mesh"] is None else ins["mesh"][0].shape[0])
    del state, scene, cfg, cam
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_sums(ins, w, h, pick, passes, run_seed, dev)
    print(f"phase set-up {setup_s:.3f} s, window {window:.3f} s "
          f"({passes} passes; untraced passes, ms: "
          f"{[round(x, 1) for x in pass_ms]}), card after the window "
          f"{card}, reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    checks = compare(prog, ref, passes, prog_samples)
    res = {
        "correct": passed(checks), "attempted": passes, "failed": 0,
        "checks": checks, "memory_peak_bytes": peak, "layer": layer,
        "metrics_e2e": {"render_samples_per_s": stats.rate(passes * n_pix,
                                                           window),
                        "setup_s": setup_s},
    }
    if trace:
        res.update(busy_s=tr.busy_s(data), window_s=data.span_s,
                   breakdown=tr.breakdown(data))
    return res


def reference_sums(ins, w, h, pick, passes, seed, dev, dtype=None):
    """The plain reference's sums of the checked pixels over the window's
    samples, in ``dtype`` (float32 unless the control asks for less)."""
    import torch
    from benchmark.reference import frames
    from benchmark.reference.scene import Scene
    dtype = dtype or torch.float32
    sc = Scene(ins["doc"], ins["mesh"], ins["env"], device=dev, dtype=dtype)
    cam = {k: torch.as_tensor(v, device=dev).to(dtype)
           for k, v in ins["camera"].items()}
    return frames.pixel_sums(sc, cam, w, h, pick, passes, seed)


def _planted(sums, fault):
    """The checked pixels' sums as each fault would leave them: a pass that
    leaves its state unchanged, half the pixels left out with the rest
    doubled, every answer altered by 0.1%."""
    import torch
    if fault == "unchanged":
        return torch.zeros_like(sums)
    if fault == "half_batch":
        keep = torch.arange(sums.shape[0], device=sums.device) % 2 == 0
        return torch.where(keep[:, None], sums * 2.0, 0.0)
    return sums * 1.001


VARIANTS = ("control", "unchanged", "half_batch", "altered")


def control(found, seed, device, passes, dtype, variants=VARIANTS):
    """The compared numbers of each variant put in the program's place, over
    ``passes`` passes of the cell's checked pixels: "control", the
    reference computed in ``dtype``; the faults, the float32 reference's
    sums as each leaves them (``_planted``) -> {variant: checks}."""
    import torch
    from benchmark.harness import inputs
    traffic = found["traffic"]
    w, h = int(traffic["width"]), int(traffic["height"])
    dev = torch.device(device)
    ins = inputs.build(found["config"], seed, w, h)
    gen = torch.Generator().manual_seed(inputs.mix(seed, 3))
    pick = torch.randperm(w * h, generator=gen)[:int(traffic["check_pixels"])]
    pick = pick.to(dev)
    run_seed = inputs.mix(seed, 1)
    ref = reference_sums(ins, w, h, pick, passes, run_seed, dev)
    out = {}
    for v in variants:
        low = (reference_sums(ins, w, h, pick, passes, run_seed, dev, dtype)
               if v == "control" else _planted(ref, v))
        out[v] = compare(low.float(), ref, passes, passes)
    return out


def _w1_rays(nodes, links, leaf_verts, origin, direction, t_init,
             any_hit=False, active=None, count_steps=False):
    """The rays one W1 launch walks: its lane count where every lane or none
    is active, else its active mask and the mask's version, summed after
    the traced passes (``_count_rays``), so that the count adds no kernel
    to them."""
    if active is None or active is True:
        return origin.shape[0]
    if active is False:
        return 0
    return active, active._version


def _count_rays(calls) -> int:
    n = 0
    for c in calls:
        if isinstance(c, int):
            n += c
            continue
        mask, version = c
        if mask._version != version:
            raise RuntimeError("a W1 launch's active mask was changed in "
                               "place after the launch: its rays cannot be "
                               "counted from it")
        n += int(mask.sum())
    return n
