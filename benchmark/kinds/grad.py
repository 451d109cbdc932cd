"""Traffic kind "grad": a closed loop of inverse-rendering steps as
``diff.inverse.fit_scene`` runs them: the image loss of a differentiable
render against a target, ``loss.backward()``, Adam, the clip at zero.

Set-up renders the target from the scene as loaded, perturbs the fitted
leaves from the seed, calibrates the regeneration budget once on the
perturbed scene, and drives the same optimiser through one warm step; the
window carries on from step two.  Correct: after the window the plain
reference renders its own target and follows the first three steps from
the same start, with its own tracer, gradients and Adam, so that two of
the steps it follows are the window's; the losses, the first gradient's
norm and the parameters' change after three steps (kept at the window's
step boundary, read after it) are compared leaf by leaf (PERF.md, "How
correct is decided").
"""
from __future__ import annotations

import dataclasses
import sys
import time

from benchmark.harness.core import card_state
from benchmark.kinds.render import PIXEL_FLOOR, PIXEL_TOL, passed

FOLLOWED = 3  # steps the reference follows
LIMITS = {"loss_gap": 2e-5, "grad_norm_gap": 3e-4, "change_norm_gap": 3e-5,
          "target_parted_share": 0.02}


def perturb(scene, leaves: dict, seed: int, device):
    """Each fitted leaf times a uniform factor per entry in [lo, hi), drawn
    on the device from the seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name in sorted(leaves):
        lo, hi = leaves[name]
        base = getattr(scene, name).detach()
        u = torch.rand(base.shape, generator=gen, device=device,
                       dtype=base.dtype)
        out[name] = base * (lo + (hi - lo) * u)
    return out


def norms(tensors: dict) -> dict:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def compare(prog: dict, ref: dict) -> dict:
    from benchmark.harness.stats import leaf_norm_gap
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    out = {"loss_gap": loss,
           "grad_norm_gap": leaf_norm_gap(prog["grad"], ref["grad"]),
           "change_norm_gap": leaf_norm_gap(prog["change"], ref["change"]),
           "target_parted_share": prog["target_parted"]}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in out.items()}


def parted_share(prog, ref) -> float:
    import torch
    prog, ref = prog.double(), ref.double()
    scale = torch.clamp(ref.abs().amax(-1), min=PIXEL_FLOOR)
    return float(((prog - ref).abs().amax(-1) / scale > PIXEL_TOL)
                 .double().mean())


# the faults a training cell can have, planted in the reference put in the
# program's place: (pixel stride of the loss, gain on the image)
FAULTS = {"half_batch": (2, 1.0), "altered": (1, 1.001)}


def reference_steps(ins, traffic, spp, seed, start, dev, dtype=None,
                    fault=None):
    """The plain reference's target and its first ``FOLLOWED`` steps from
    ``start`` (its own tracer, gradients and Adam), in ``dtype`` (float32
    unless the control asks for less), with ``fault`` planted: the
    target, the losses, the first gradient's norms, the norms of the
    change."""
    import torch
    from benchmark.harness import inputs
    from benchmark.reference import frames
    from benchmark.reference.scene import Scene
    dtype = dtype or torch.float32
    w, h = int(traffic["width"]), int(traffic["height"])
    sc = Scene(ins["doc"], ins["mesh"], ins["env"], device=dev, dtype=dtype)
    cam = {k: torch.as_tensor(v, device=dev).to(dtype)
           for k, v in ins["camera"].items()}
    target = frames.image(sc, cam, w, h, int(traffic["target_spp"]),
                          inputs.mix(seed, 4))
    start = {k: v.to(dtype) for k, v in start.items()}
    adam = frames.Adam(start, lr=float(traffic["lr"]))
    out = {"loss": [], "target": target}
    for i in range(1, FOLLOWED + 1):
        stride, gain = FAULTS.get(fault, (1, 1.0))
        loss, grads = frames.loss_and_grads(sc, cam, w, h, spp,
                                            inputs.mix(seed, 100 + i),
                                            target, adam.p, stride=stride,
                                            gain=gain)
        out["loss"].append(loss)
        if i == 1:
            out["grad"] = norms(grads)
        adam.step(grads)
    out["change"] = norms({k: adam.p[k] - start[k] for k in start})
    return out


VARIANTS = ("control", "half_batch", "altered")


def control(found, seed, device, dtype, variants=VARIANTS, **_):
    """The compared numbers of each variant put in the program's place:
    "control", the reference computed in ``dtype``; a fault of FAULTS, the
    float32 reference with it planted -> {variant: checks}.  ("unchanged",
    a step that leaves the state as it was, reads 1 on the change by its
    definition and needs no run.)  The reference's steps fix its length,
    so the window's (``passes``) is not asked for."""
    import torch
    from benchmark.harness import inputs
    from benchmark.reference.scene import Scene
    traffic, config = found["traffic"], found["config"]
    w, h = int(traffic["width"]), int(traffic["height"])
    spp = int(config.get("spp", traffic["spp"]))
    dev = torch.device(device)
    ins = inputs.build(config, seed, w, h)
    leaves = {k: tuple(v) for k, v in config["fit"]["leaves"].items()}
    base = Scene(ins["doc"], ins["mesh"], ins["env"], device=dev)
    start = perturb(base, leaves, inputs.mix(seed, 5), dev)
    ref = reference_steps(ins, traffic, spp, seed, start, dev)
    target = ref.pop("target")
    out = {}
    for v in variants:
        low = (reference_steps(ins, traffic, spp, seed, start, dev, dtype)
               if v == "control" else
               reference_steps(ins, traffic, spp, seed, start, dev, fault=v))
        low["target_parted"] = parted_share(low.pop("target").float(),
                                            target)
        out[v] = compare(low, ref)
    return out


def run(found, seed, seconds, trace, device, since_start):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.diff import inverse
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        pytree_from_numpy)
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import (
        build_scene)

    from benchmark.harness import inputs, stats, timing, trace as tr
    from benchmark.reference.scene import Scene

    traffic, config = found["traffic"], found["config"]
    w, h = int(traffic["width"]), int(traffic["height"])
    spp = int(config.get("spp", traffic["spp"]))
    target_spp = int(traffic["target_spp"])
    dev = torch.device(device)
    ins = inputs.build(config, seed, w, h)
    leaves = {k: tuple(v) for k, v in config["fit"]["leaves"].items()}
    cfg, scene = build_scene(ins["doc"], env_map=ins["env"],
                             mesh_override=ins["mesh"], device=dev)
    cam = pytree_from_numpy(ins["camera"], dev)
    target_seed = inputs.mix(seed, 4)

    def step_seed(i):
        return inputs.mix(seed, 100 + i)

    # seconds since the process started, at the end of each part of set-up
    phases = [("scene", since_start())]
    with torch.no_grad():
        target = pathtracer.render(cfg, scene, cam, w, h, target_spp,
                                   seed=target_seed, method="regen")[0]
    phases.append(("target", since_start()))
    # the start, from the inputs as the benchmark reads them, for both sides
    start = perturb(Scene(ins["doc"], ins["mesh"], ins["env"], device=dev),
                    leaves, inputs.mix(seed, 5), dev)
    regen_iters = 0
    if traffic["method"] == "regen_scan":
        regen_iters = pathtracer.calibrate_regen_iters(
            cfg, dataclasses.replace(scene, **start), cam, w, h, spp,
            seed=step_seed(1), margin=float(traffic["regen_margin"]))
    phases.append(("calibration", since_start()))
    loss_fn = inverse.make_loss_fn(cfg, scene, cam, w, h, spp, target,
                                   tuple(leaves), method=traffic["method"],
                                   regen_iters=regen_iters)
    params = {k: v.clone().requires_grad_() for k, v in start.items()}
    opt = torch.optim.Adam(list(params.values()), lr=float(traffic["lr"]))
    marks = timing.Marks(dev)

    def step(i):
        a = marks.mark()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, step_seed(i))
        b = marks.mark()
        loss.backward()
        opt.step()
        with torch.no_grad():
            for p in params.values():
                p.clamp_(min=0.0)
        c = marks.mark()
        return loss.detach(), (a, b, c)

    # one warm step, the first that the reference follows
    loss, _ = step(1)
    losses = [loss]
    beta1 = opt.param_groups[0]["betas"][0]
    # an optimiser that kept no state got no gradient
    first = {"grad": norms({k: opt.state[p].get(
        "exp_avg", torch.zeros_like(p)) / (1.0 - beta1)
                            for k, p in params.items()})}
    phases.append(("step 1", since_start()))
    timing.sync(dev)
    setup_peak = (torch.cuda.max_memory_allocated(dev)
                  if dev.type == "cuda" else 0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    traced = int(traffic["traced_after"])
    prof = after = None
    setup_s = since_start()
    t0 = time.perf_counter()
    steps, spans = 0, []
    # the window's first steps are the rest of what the reference follows:
    # their losses stay on the device, and the parameters as the next step
    # finds them are copied there, all read after the window
    while (steps < FOLLOWED - 1 or time.perf_counter() - t0 < seconds
           or (trace and steps <= traced)):
        if trace and steps == traced:
            prof = tr.Profiled(dev).__enter__()
        loss, ms = step(2 + steps)
        if trace and steps == traced:
            prof.__exit__(None, None, None)
        else:
            spans.append(ms)
        steps += 1
        if steps < FOLLOWED:
            losses.append(loss)
        if steps == FOLLOWED - 1:
            after = {k: p.detach().clone() for k, p in params.items()}
    timing.sync(dev)
    window = time.perf_counter() - t0
    card = card_state(dev)

    window_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    layer = {"forward_ms": [marks.ms(a, b) for a, b, _ in spans],
             "backward_ms": [marks.ms(b, c) for _, b, c in spans],
             "step_ms": [marks.ms(a, c) for a, _, c in spans],
             "steps": steps}
    if trace:
        layer.update(trace=prof.data, traced_steps=1)
    first["loss"] = [float(x) for x in losses]
    first["change"] = norms({k: after[k] - start[k] for k in after})
    prog_target = target.reshape(-1, 3).clone()
    del loss_fn, params, opt, scene, cfg, cam, target, after, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_steps(ins, traffic, spp, seed, start, dev)
    first["target_parted"] = parted_share(prog_target, ref.pop("target"))
    print(f"phase set-up {setup_s:.3f} s, window {window:.3f} s ({steps} "
          f"steps, untraced ms {[round(marks.ms(a, c)) for a, _, c in spans]}"
          f", regen budget {regen_iters}; set-up reached "
          f"{', '.join(f'{n} {t:.1f}' for n, t in phases)} s), card after "
          f"the window {card}, reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    checks = compare(first, ref)
    pix = w * h * spp
    res = {
        "correct": passed(checks), "attempted": steps, "failed": 0,
        "checks": checks, "memory_peak_bytes": max(setup_peak, window_peak),
        "layer": layer,
        "metrics_e2e": {"grad_samples_per_s": stats.rate(steps * pix, window),
                        "grad_peak_gib": window_peak / 2**30,
                        "setup_s": setup_s},
    }
    if trace:
        res.update(busy_s=tr.busy_s(prof.data), window_s=prof.data.span_s,
                   breakdown=tr.breakdown(prof.data))
    return res
