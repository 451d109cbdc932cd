#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports nothing of JAX.  Phases, in
order, none of them optional and none wrapped in a fallback:

  1. device: the card's name and power limit (nvidia-smi), torch/CUDA
     versions; TF32 off for matmuls and cuDNN.
  2. build: nvcc builds the kernels from csrc/ (seconds printed).
  3. K1 (csrc/mesh_brute.cu) against its plain twin on the card, on the
     cornell_hi tables (81,920 triangles): three populations of 262,144
     rays (random, camera rays of a 512^2 frame, rays leaving the mesh
     surface with their triangle excluded), each as one merged 524,288-ray
     batch of closest + any-hit lanes with inactive lanes mixed in; plus a
     600-ray icosphere case for padding.  Times of both at that shape.
  4. K2 (csrc/tonemap.cu) against its plain twin: a seeded 512^2 HDR image,
     vignette on/off, brightness 1.0/1.7.
  5. Anchors: the cornell_simple, mesh_icosphere and cornell_hi_bvh configs
     of tests/golden_tool.py rendered by the port on the card against the
     stored goldens (rendered by the JAX package on the CPU).
  6. The forward slice at size: cornell_hi.json, 512^2 x 8 spp, seed 0,
     render(method="regen") -> tonemap -> write_png, with launch counts.
  7. K3 (csrc/block_scan.cu) against its plain version: 262,144 flags (a
     512^2 frame's lanes) and ragged sizes at five densities, 0 mismatches
     allowed; compact_indices driven once on a frame's lanes; times of the
     kernel, the plain version and torch.cumsum.
  8. The fwd+bwd slice at size: cornell_hi.json, 512^2 x 4 spp, seed 3,
     value-and-grad of mean(image) through render(method="regen_scan") over
     every float leaf of the scene and the camera, with the calibrated
     budget: completed == spp, finite gradients, non-zero colour and camera
     gradients, K1 launches == iterations.  Then the same run instrumented
     (where the backward time goes), a device profile, and 32^2 x 2 spp
     fwd+bwd runs of cornell.json + a 320-triangle icosphere on the card
     against the CPU (K1 against its twin): at 4 bounces with every pixel
     compared, at 32 bounces on two seeds with each left-out pixel's path
     traced on both devices.
  9. Inverse rendering: 4 Adam steps of fit_scene(method="regen_scan") at
     128^2 x 4 spp on cornell_hi with the red wall's colour perturbed.

Prints the kernels' JSON line (with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the H100 SXM's
HBM3 rate and FP32 peak), the nvidia-smi line, and last the result line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result line
when there is no CUDA device or when the port is not beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "photorealistic_rendering_using_opencl_tpu_torch"

# tests/golden_tool.py's render configs (32^2, seed 9, default camera)
GOLDEN_SIZE = 32
GOLDEN_SEED = 9
GOLDENS = {
    "cornell_simple": dict(scene="scenes/cornell_simple.json", spp=8),
    "mesh_icosphere": dict(scene="scenes/cornell_simple.json", spp=4,
                           mesh=dict(subdiv=1, radius=0.7,
                                     center=(0.0, 0.8, 0.0))),
    "cornell_hi_bvh": dict(scene="scenes/cornell_hi.json", spp=2),
}
# tests/test_golden.py's tolerance for the 4-bounce anchors
GOLDEN_RTOL, GOLDEN_ATOL = 1e-4, 1e-5
# cornell_hi_bvh: the JAX BVH walk against K1 over 32 bounces, mean only
HI_MEAN_REL = 5e-3
FLIP_LIMIT = 1e-5  # winner / occlusion disagreements per ray
K1_T_RTOL = 1e-5
T_CANCEL = 4e-7  # ~3.4 float32 ulps at 1: t*den's cancellation, see k1_compare
K2_ATOL = 1e-6
RAYS = 262144

# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# K1's FP32 operations (an FMA counts 2) per ray-triangle test: den 5,
# t*den 6, u*den 11, v*den 11, den^2 1, the three barycentric products 5,
# t*den*den 1, EPS*den^2 1; and per (ray, tile) AABB slab test: the pad 7,
# six slab distances 18, entry/exit 11, the t test 2
K1_PAIR_FLOPS = 41
K1_SLAB_FLOPS = 38
K1_BLOCK_RAYS = 128  # csrc/mesh_brute.cu's RAYS: rays (threads) per block
# tests/test_torch_grad.py's 32-bounce gradient bound: rtol, and the same
# fraction of the leaf's largest gradient entry as atol
DEEP_GRAD_REL = 5e-4
# card vs CPU: the forward bounds of tests/test_torch_grad.py at <= 4 and
# at 32 bounces, and its gradient bounds at <= 4 bounces
FWD_SHALLOW, FWD_DEEP = 1e-5, 5e-4
SHALLOW_GRAD_RTOL, SHALLOW_GRAD_ATOL = 1e-4, 1e-6
# card vs CPU at 32 bounces: pixels allowed to take another path decision,
# each backed by its traced divergence, on each of these seeds
FLIP_PIXELS = 0.01
CVC_SEEDS = (3, 7)
# the card-vs-CPU input: cornell.json + this icosphere (320 triangles),
# CVC_SIZE^2 x CVC_SPP spp
CVC_MESH = dict(subdiv=2, radius=0.6, center=(0.0, 1.0, 0.0))
CVC_SIZE, CVC_SPP = 32, 2
# At 4 bounces on that input, rtol 1e-4 / atol 1e-6 (the bound of
# tests/test_torch_grad.py's 8x8 frames) is out of reach of any two float32
# implementations: grazing hits make some leaves' gradients ill-conditioned.
# The yardstick there is how far the JAX package's CPU gradients are from
# the port's CPU gradients on the same input (seed 3): max |JAX - port| over
# the leaf's largest |entry|, rounded up.  Measured, and held as an upper
# bound, by tests/test_torch_grad.py::test_grad_spread_of_two_cpu_implementations.
GRAD_SPREAD_4 = {
    "scene.color": 1.7e-7, "scene.position": 1.1e-6, "scene.params": 6.7e-8,
    "scene.quad_base": 1.3e-4, "scene.quad_edge0": 1.3e-4,
    "scene.quad_edge1": 1.3e-4, "scene.quad_normal": 1.2e-4,
    "scene.obj_color": 6.8e-7, "scene.obj_eta": 8.9e-7, "scene.obj_k": 1.2e-6,
    "scene.obj_roughness": 2.4e-3, "camera.position": 5.8e-5,
    "camera.view": 5.0e-5, "camera.up": 1.9e-4, "camera.fov": 3.2e-4,
    "camera.aperture_radius": 1.7e-4, "camera.focal_distance": 1.1e-3,
}
# a leaf beyond rtol 1e-4 / atol 1e-6 passes if the card is no farther from
# the CPU than this many times the two CPU implementations' spread
SPREAD_FACTOR = 2.0
# how every kernel's ms, plain_ms and library_ms are timed
TIMED_BY = "torch.profiler device time, summed over the call's kernels"


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke.py: FAILED: {msg}")


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the FP32 peak."""
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


def device_ms(fn, reps: int) -> float:
    """Mean device time in milliseconds of the kernels ``fn()`` launches, by
    torch.profiler: for kernels short enough that back-to-back launches
    from Python leave the card idle between them, where CUDA events around
    the loop would time the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / reps / 1e3


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch
    fn()  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 3: K1 against its twin
# ---------------------------------------------------------------------------

def k1_populations(scene, dev):
    """Three [RAYS] ray populations on the cornell_hi mesh."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    rng = np.random.default_rng(1234)
    cl = scene.bf_clusters.cpu().numpy()
    live = cl[:, 0] < 1e37
    lo, hi = cl[live, 0:3].min(0), cl[live, 3:6].max(0)
    mid, half = (lo + hi) / 2, (hi - lo) / 2

    def unit(n):
        d = rng.normal(size=(n, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=1, keepdims=True)

    pops = {}
    o = (mid + rng.uniform(-1.5, 1.5, (RAYS, 3)) * half).astype(np.float32)
    pops["random"] = (o, unit(RAYS), None)

    w = int(round(RAYS ** 0.5))  # RAYS is a square frame's pixel count
    cam = default_camera(w, w).pytree(dev)
    px, py = pathtracer.pixel_grid(w, w, dev)
    o_c, d_c = pathtracer.camera_rays_for_sample(
        cam, w, w, px, py, py * w + px, 0, 0)
    pops["camera"] = (o_c.cpu().numpy(), d_c.cpu().numpy(), None)

    tv = scene.bf_tri_verts.cpu().numpy()
    n_live = int((np.abs(tv).sum(axis=(1, 2)) > 0).sum())
    tri = rng.integers(0, n_live, RAYS).astype(np.int32)
    uv = rng.uniform(0, 1, (RAYS, 2)).astype(np.float32)
    flip = uv.sum(1) > 1
    uv[flip] = 1 - uv[flip]
    v = tv[tri]
    o_s = (v[:, 0] * (1 - uv[:, 0:1] - uv[:, 1:2]) + v[:, 1] * uv[:, 0:1]
           + v[:, 2] * uv[:, 1:2]).astype(np.float32)
    pops["surface"] = (o_s, unit(RAYS), tri)

    out = {}
    for name, (o, d, ex) in pops.items():
        # merged batch: [closest lanes | any-hit lanes], as the integrator
        # sends it; 10% inactive lanes in both halves
        o2 = np.concatenate([o, o])
        d2 = np.concatenate([d, d])
        t_init = np.concatenate([
            np.full(RAYS, 20.0, np.float32),
            rng.uniform(0.05, 3.0, RAYS).astype(np.float32)])
        any_hit = np.arange(2 * RAYS) >= RAYS
        active = rng.uniform(size=2 * RAYS) >= 0.1
        exclude = (np.full(2 * RAYS, -1, np.int32) if ex is None
                   else np.concatenate([ex, ex]))
        out[name] = dict(
            origin=torch.from_numpy(o2).to(dev),
            direction=torch.from_numpy(d2).to(dev),
            t_init=torch.from_numpy(t_init).to(dev),
            any_hit=torch.from_numpy(any_hit).to(dev),
            active=torch.from_numpy(active).to(dev),
            exclude=torch.from_numpy(exclude).to(dev))
    return out


def k1_compare(name, feat, clusters, tri_verts, b, problems,
               t_rtol=K1_T_RTOL):
    """One merged batch through K1 and the twin; returns the worst t error
    and the flip counts, and appends every broken limit to ``problems``."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import (
        _tri_intersect,
    )
    t_k, i_k = mesh_brute.mesh_intersect(
        feat, clusters, b["origin"], b["direction"], b["t_init"],
        active=b["active"], any_hit=b["any_hit"], exclude=b["exclude"])
    t_x, i_x = mesh_brute._intersect_xla(
        feat, clusters, b["origin"], b["direction"], b["t_init"],
        b["active"], exclude=b["exclude"])
    torch.cuda.synchronize()
    n = i_k.shape[0]
    act, ah = b["active"], b["any_hit"]
    closest = act & ~ah
    anyhit = act & ah
    inactive = ~act
    # inactive lanes: exactly (t_init, -1)
    if not (bool((i_k[inactive] == -1).all())
            and torch.equal(t_k[inactive], b["t_init"][inactive])):
        problems.append(f"K1 {name}: an inactive lane recorded a hit")
    # any-hit lanes: t is t_init, occlusion flags against the twin's
    if not torch.equal(t_k[anyhit], b["t_init"][anyhit]):
        problems.append(f"K1 {name}: any-hit lanes must return t_init")
    occ_flips = int(((i_k >= 0) != (i_x >= 0))[anyhit].sum())
    win_flips_mask = (i_k != i_x) & closest
    win_flips = int(win_flips_mask.sum())
    n_closest = int(closest.sum())
    n_any = int(anyhit.sum())
    for lane in torch.nonzero(win_flips_mask).flatten()[:8].tolist():
        o = b["origin"][lane:lane + 1]
        d = b["direction"][lane:lane + 1]
        row = []
        for label, tri in (("kernel", int(i_k[lane])), ("twin", int(i_x[lane]))):
            if tri < 0:
                row.append(f"{label} miss")
                continue
            v = tri_verts[tri].reshape(1, 9)
            ok, t, _, _ = _tri_intersect(v[:, 0:3], v[:, 3:6], v[:, 6:9], o, d,
                                         b["t_init"][lane:lane + 1])
            row.append(f"{label} tri {tri} exact t {float(t):.9g} "
                       f"exact-hit {bool(ok)}")
        log(f"  K1 {name} flip lane {lane}: " + "; ".join(row)
            + f"; kernel t {float(t_k[lane]):.9g} twin t {float(t_x[lane]):.9g}")
    same = closest & (i_k == i_x) & (i_k >= 0)
    err = (t_k[same] - t_x[same]).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    max_rel = float((err / t_x[same].abs()).max()) if err.numel() else 0.0
    # t = (t*den)/den cancels two terms of size |o| + |p0| before dividing
    # by den, so beside the relative bound each lane may differ by a few
    # ulps of that size over |den| (grazing rays, hits next to the origin)
    v = tri_verts[i_k[same].long()]
    nrm = torch.linalg.cross(v[:, 0] - v[:, 1], v[:, 2] - v[:, 0])
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    den = (nrm * b["direction"][same]).sum(1).abs().clamp(min=1e-12)
    scale = 1.0 + b["origin"][same].norm(dim=1) + v[:, 0].norm(dim=1)
    tol = t_rtol * t_x[same].abs() + T_CANCEL * scale / den
    worst = float((err / tol).max()) if err.numel() else 0.0
    hits = int(same.sum())
    log(f"  K1 {name}: {n} lanes, closest {n_closest} ({hits} agreeing "
        f"hits) winner flips {win_flips}; any-hit {n_any} "
        f"({int((i_x[anyhit] >= 0).sum())} occluded) occlusion flips "
        f"{occ_flips}; t max abs err {max_abs:.3g} max rel {max_rel:.3g} "
        f"worst err/tolerance {worst:.3g}")
    if win_flips > FLIP_LIMIT * n_closest:
        problems.append(f"K1 {name}: {win_flips} winner flips > {FLIP_LIMIT} "
                        "per ray")
    if occ_flips > FLIP_LIMIT * n_any:
        problems.append(f"K1 {name}: {occ_flips} occlusion flips > "
                        f"{FLIP_LIMIT} per ray")
    if worst > 1.0:
        problems.append(f"K1 {name}: t error {worst:.3g}x its tolerance")
    return max_abs, win_flips, occ_flips


def k1_bound(feat, clusters, b):
    """K1's bound on one batch, from the work this batch needs: the kernel's
    own counters give the (ray, tile) pairs whose ray passed the tile's
    slab test (each 128 ray-triangle tests) and the live rays' slab tests.
    The thread slots of the (block, tile) pairs the kernel staged, which
    it occupies whether or not their ray needed the tile, are logged
    beside it as the block granularity's waste, not counted as work."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    counters = torch.zeros(3, dtype=torch.int64, device=feat.device)
    mesh_brute.mesh_brute_kernel(feat, clusters, b["origin"], b["direction"],
                                 b["t_init"], b["active"], b["any_hit"],
                                 b["exclude"], counters=counters)
    block_tiles, ray_tiles, slabs = (int(x) for x in counters.cpu())
    n = b["origin"].shape[0]
    n_bytes = (feat.numel() * 4 + clusters.numel() * 4
               + n * (12 + 12 + 4 + 1 + 1 + 4)  # o, d, t_init, flags, exclude
               + n * (4 + 4))  # t, tri
    flops = (ray_tiles * mesh_brute.TILE * K1_PAIR_FLOPS
             + slabs * K1_SLAB_FLOPS)
    slots = block_tiles * K1_BLOCK_RAYS
    log(f"    K1 work: {ray_tiles} (ray, tile) pairs tested, {slabs} slab "
        f"tests; {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP.  Block "
        f"granularity: {block_tiles} (block, tile) pairs staged of "
        f"{-(-n // K1_BLOCK_RAYS) * clusters.shape[0]}, {slots} thread slots, "
        f"{ray_tiles / max(slots, 1):.1%} of them testing")
    return bound_ms(n_bytes, flops)


def phase_k1(dev):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.scene.bvh_build import build_bvh
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    log("[3] K1 mesh_brute.cu against its plain twin")
    t0 = time.perf_counter()
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    log(f"  cornell_hi loaded: {cfg.n_triangles} triangles, "
        f"{scene.bf_clusters.shape[0]} tiles, {time.perf_counter() - t0:.2f} s")
    feat, clusters = scene.bf_feat, scene.bf_clusters
    worst = 0.0
    timings = {}
    problems = []
    for name, b in k1_populations(scene, dev).items():
        err, _, _ = k1_compare(name, feat, clusters, scene.bf_tri_verts, b,
                               problems)
        worst = max(worst, err)
        args = (feat, clusters, b["origin"], b["direction"], b["t_init"])

        def launch():
            mesh_brute.mesh_brute_kernel(*args, b["active"], b["any_hit"],
                                         b["exclude"])

        k_ms = device_ms(launch, 5)
        k_one = min(cuda_ms(launch, 1) for _ in range(3))
        x_ms = device_ms(lambda: mesh_brute._intersect_xla(
            *args, b["active"], exclude=b["exclude"]), 1)
        bound, by = k1_bound(feat, clusters, b)
        timings[name] = (k_ms, x_ms, bound, by)
        log(f"  K1 {name}: N={b['origin'].shape[0]}, device time: kernel "
            f"{k_ms:.3f} ms, twin {x_ms:.3f} ms (all its kernels), bound "
            f"{bound:.4f} ms ({by}); one launch by CUDA events {k_one:.3f} "
            "ms (best of 3)")

    # padding: 600 rays (not a multiple of the 128-ray block)
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    order = build_bvh(tv).order
    bp = mesh_brute.pack_brute(tv[order], tn[order])
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    d = rng.normal(size=(600, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    small = dict(
        origin=torch.from_numpy(o).to(dev), direction=torch.from_numpy(d).to(dev),
        t_init=torch.full((600,), 20.0, device=dev),
        any_hit=torch.from_numpy(np.arange(600) % 3 == 0).to(dev),
        active=torch.from_numpy(np.arange(600) % 7 != 0).to(dev),
        exclude=torch.full((600,), -1, dtype=torch.int32, device=dev))
    k1_compare("icosphere-600", torch.from_numpy(bp.feat).to(dev),
               torch.from_numpy(bp.clusters).to(dev),
               torch.from_numpy(bp.tri_verts).to(dev), small, problems)
    if problems:
        fail("; ".join(problems))
    return worst, timings


# ---------------------------------------------------------------------------
# phase 4: K2 against its twin
# ---------------------------------------------------------------------------

def phase_k2(dev):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm

    log("[4] K2 tonemap.cu against its plain twin")
    rng = np.random.default_rng(42)
    img = torch.from_numpy(rng.uniform(0.0, 3.0, (512, 512, 3))
                           .astype(np.float32)).to(dev)
    worst = 0.0
    for vignette in (True, False):
        for brightness in (1.0, 1.7):
            got = tm.tonemap(img, vignette=vignette, brightness=brightness)
            want = tm.tonemap_plain(img, vignette=vignette,
                                    brightness=brightness)
            diff = float((got - want).abs().max())
            worst = max(worst, diff)
            log(f"  K2 vignette={vignette} brightness={brightness}: "
                f"max abs diff {diff:.3g}")
            if diff > K2_ATOL:
                fail(f"K2: max abs diff {diff:.3g} > {K2_ATOL}")
    k_ev = cuda_ms(lambda: tm.tonemap(img), 50)
    k_ms = device_ms(lambda: tm.tonemap(img), 50)
    p_ms = device_ms(lambda: tm.tonemap_plain(img), 50)
    # 12 B read and 12 B written per pixel; ~25 FP32 operations per channel
    bound, by = bound_ms(img.numel() * 4 * 2, img.numel() * 25)
    log(f"  K2 512x512, device time: kernel {k_ms:.4f} ms, twin {p_ms:.4f} "
        f"ms (all its kernels), bound {bound:.5f} ms ({by}); the kernel "
        f"launched back to back from Python: {k_ev:.4f} ms per launch")
    return worst, k_ms, p_ms, bound, by


# ---------------------------------------------------------------------------
# phase 5: goldens
# ---------------------------------------------------------------------------

def phase_goldens(dev):
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    log("[5] port on the card against the goldens (JAX package, CPU)")
    for name, c in GOLDENS.items():
        mesh = make_icosphere(**c["mesh"]) if "mesh" in c else None
        cfg, scene = load_scene(os.path.join(REPO, c["scene"]),
                                models_dir=os.path.join(REPO, "scenes/assets"),
                                mesh_override=mesh, device=dev)
        cam = default_camera(GOLDEN_SIZE, GOLDEN_SIZE).pytree(dev)
        img, alpha = pathtracer.render(cfg, scene, cam, GOLDEN_SIZE,
                                       GOLDEN_SIZE, c["spp"], seed=GOLDEN_SEED,
                                       method="regen")
        img, alpha = img.cpu().numpy(), alpha.cpu().numpy()
        with np.load(os.path.join(REPO, "tests/golden", f"{name}.npz")) as z:
            ref, ref_alpha = z["img"], z["alpha"]
        if not np.isfinite(img).all():
            fail(f"golden {name}: non-finite pixels")
        diff = np.abs(img - ref)
        p99 = float(np.quantile(diff, 0.99))
        rel_mean = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
        log(f"  {name}: mean {img.mean():.6f} vs golden {ref.mean():.6f} "
            f"(rel {rel_mean:.3g}), max abs diff {diff.max():.3g}, "
            f"p99 {p99:.3g}")
        if name == "cornell_hi_bvh":
            if rel_mean > HI_MEAN_REL:
                fail(f"golden {name}: mean off by {rel_mean:.3g}")
            continue
        bad = diff > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(ref)
        if bad.any() or not np.allclose(alpha, ref_alpha, rtol=GOLDEN_RTOL,
                                        atol=GOLDEN_ATOL):
            fail(f"golden {name}: {int(bad.sum())} values outside "
                 f"rtol {GOLDEN_RTOL} atol {GOLDEN_ATOL}")


# ---------------------------------------------------------------------------
# phase 6: the slice at size
# ---------------------------------------------------------------------------

def phase_slice(dev, gpu_line, spp):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.ops._cuda import BUILD_DIR
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import write_png

    w = h = 512
    log(f"[6] slice: cornell_hi.json {w}x{h} x {spp} spp, seed 0, regen")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    cam = default_camera(w, h).pytree(dev)

    # warm-up through the render loop itself, which also reports the iteration
    # count of this (deterministic) schedule
    t0 = time.perf_counter()
    px, py = pathtracer.pixel_grid(w, h, dev)
    with torch.no_grad():
        _, _, iters = pathtracer.trace_regen(cfg, scene, cam, w, h, spp,
                                             px, py, 0, return_iters=True)
    torch.cuda.synchronize()
    log(f"  warm-up: {iters} iterations, {time.perf_counter() - t0:.2f} s")

    mesh_brute.mesh_brute_kernel.launches = 0
    tm.tonemap_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, alpha = pathtracer.render(cfg, scene, cam, w, h, spp, seed=0,
                                   method="regen")
    torch.cuda.synchronize()
    t_render = time.perf_counter() - t0
    ldr = tm.tonemap(img)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    launches = {"K1": mesh_brute.mesh_brute_kernel.launches,
                "K2": tm.tonemap_kernel.launches}
    png = os.path.join(BUILD_DIR, "chip_smoke_cornell_hi.png")
    write_png(png, ldr.cpu().numpy())

    a = img.cpu().numpy()
    if not np.isfinite(a).all():
        fail("slice: NaN or Inf in the image")
    if a.shape != (h, w, 3):
        fail(f"slice: image shape {a.shape}")
    if launches["K1"] != iters or iters <= 0:
        fail(f"slice: K1 launches {launches['K1']} != iterations {iters}")
    if launches["K2"] != 1:
        fail(f"slice: K2 launches {launches['K2']} != 1")
    rate = w * h * spp / t_render
    log(f"  render {t_render:.3f} s (+tonemap {t_total - t_render:.4f} s), "
        f"{rate:.0f} samples/s, {iters} iterations "
        f"(every lane finished {spp} samples: the loop only exits then), "
        f"mean radiance {a.mean():.6f}, launches {launches}, on {gpu_line}")
    log(f"  wrote {os.path.relpath(png, REPO)}")
    return launches, t_render


# ---------------------------------------------------------------------------
# phase 7: K3 against its plain version
# ---------------------------------------------------------------------------

def phase_k3(dev):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import compaction

    log("[7] K3 block_scan.cu against its plain version")
    rng = np.random.default_rng(77)
    mismatches = 0
    cases = 0
    for block in (256, 1024):
        for n in (1, 1023, 1025, 3000, RAYS):
            for density in (0.0, 0.03, 0.5, 0.97, 1.0):
                f = torch.from_numpy((rng.uniform(size=n) < density)
                                     .astype(np.int32)).to(dev)
                scan, total = compaction.exclusive_prefix_sum(f, block)
                pad = torch.cat([f, torch.zeros((-n) % block, dtype=torch.int32,
                                                device=dev)])
                s_p, t_p = compaction.block_scan_plain(pad, block)
                offsets = torch.cumsum(t_p, 0, dtype=torch.int32) - t_p
                want = (s_p + torch.repeat_interleave(offsets, block))[:n]
                s_k, t_k = compaction.block_scan(pad, block)
                mismatches += int((scan != want).sum()) + int(
                    int(total) != int(t_p.sum()))
                mismatches += int((s_k != s_p).sum()) + int((t_k != t_p).sum())
                cases += 1
    alive = torch.from_numpy(rng.uniform(size=RAYS) < 0.5).to(dev)
    perm_c, n_c = compaction.compact_indices(alive.cpu())
    torch.cuda.synchronize()
    log(f"  {cases} cases (blocks 256/1024, N up to {RAYS}, densities "
        f"0-1): {mismatches} mismatches")
    if mismatches:
        fail(f"K3: {mismatches} mismatches against the plain version")

    # the op driven on its own, as a caller would: compact a frame's lanes
    compaction.block_scan_kernel.launches = 0
    perm, n_alive = compaction.compact_indices(alive)
    torch.cuda.synchronize()
    launches = compaction.block_scan_kernel.launches
    if not (torch.equal(perm.cpu(), perm_c) and int(n_alive) == int(n_c)):
        fail("K3: compact_indices on the card disagrees with the CPU")
    if launches != 2:
        fail(f"K3: compact_indices launched K3 {launches} times, not 2")

    f = alive.to(torch.int32)
    nb = RAYS // 1024
    k_ms = device_ms(lambda: compaction.block_scan_kernel(f, 1024), 200)
    p_ms = device_ms(lambda: compaction.block_scan_plain(f, 1024), 200)
    lib_ms = device_ms(lambda: torch.cumsum(f, 0, dtype=torch.int32), 200)
    eps_ms = device_ms(lambda: compaction.exclusive_prefix_sum(f, 1024), 200)
    k_ev = cuda_ms(lambda: compaction.block_scan_kernel(f, 1024), 200)
    # 4 B read and 4 B written per flag, 4 B per block total
    bound, by = bound_ms(RAYS * 8 + nb * 4, 0)
    log(f"  K3 N={RAYS}, block 1024, device time: kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, torch.cumsum {lib_ms:.4f} ms, whole "
        f"exclusive_prefix_sum {eps_ms:.4f} ms, bound {bound:.5f} ms ({by}); "
        f"the kernel launched back to back from Python: {k_ev:.4f} ms per "
        f"launch; compact_indices launches {launches}")
    return dict(launches=launches, err=float(mismatches), ms=k_ms,
                plain_ms=p_ms, library_ms=lib_ms, bound=bound, by=by)


# ---------------------------------------------------------------------------
# phase 8: the fwd+bwd slice at size
# ---------------------------------------------------------------------------

def _grad_leaves(scene, cam):
    """Every float leaf of the scene and of the camera, as fresh leaves."""
    import dataclasses
    params = {f.name: getattr(scene, f.name).detach().clone().requires_grad_()
              for f in dataclasses.fields(scene)
              if getattr(scene, f.name).is_floating_point()}
    camg = {k: v.detach().clone().requires_grad_() for k, v in cam.items()}
    return dataclasses.replace(scene, **params), camg, params


def phase_fwd_bwd(dev, gpu_line):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    w, spp, seed = 512, 4, 3
    log(f"[8] fwd+bwd slice: cornell_hi.json {w}x{w} x {spp} spp, seed {seed}, "
        "regen_scan, value-and-grad over every float leaf + camera")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    cam = default_camera(w, w).pytree(dev)
    t0 = time.perf_counter()
    n_iters = pathtracer.calibrate_regen_iters(cfg, scene, cam, w, w, spp,
                                               seed=seed)
    torch.cuda.synchronize()
    log(f"  calibrate_regen_iters: {n_iters} iterations, "
        f"{time.perf_counter() - t0:.2f} s")

    # a first fwd+bwd pays one-time costs (lazy loading of the backward's
    # CUDA kernels, the caching allocator's growth): timed apart
    t0 = time.perf_counter()
    sc, camg, params = _grad_leaves(scene, cam)
    img, _ = pathtracer.render(cfg, sc, camg, w, w, spp, seed=seed,
                               method="regen_scan", regen_iters=n_iters)
    torch.autograd.grad(img.mean(), [*params.values(), *camg.values()],
                        allow_unused=True)
    torch.cuda.synchronize()
    log(f"  first fwd+bwd (warm-up): {time.perf_counter() - t0:.3f} s")
    del img, sc, camg, params

    mesh_brute.mesh_brute_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc, camg, params = _grad_leaves(scene, cam)
    # render raises unless every pixel completed its spp samples
    img, _ = pathtracer.render(cfg, sc, camg, w, w, spp, seed=seed,
                               method="regen_scan", regen_iters=n_iters)
    loss = img.mean()
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    leaves = [*params.values(), *camg.values()]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    k1 = mesh_brute.mesh_brute_kernel.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(img).all()) or img.shape != (w, w, 3):
        fail(f"fwd+bwd: image of shape {tuple(img.shape)} is not all finite")
    names = [f"scene.{k}" for k in params] + [f"camera.{k}" for k in camg]
    bad = [k for k, g in zip(names, grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"fwd+bwd: non-finite gradients in {bad}")
    by_name = dict(zip(names, grads))
    for k in ("scene.color", "scene.obj_color", "camera.position"):
        g = by_name[k]
        if g is None or float(g.abs().max()) == 0.0:
            fail(f"fwd+bwd: the gradient of {k} is zero")
    if k1 != n_iters:
        fail(f"fwd+bwd: K1 launches {k1} != iterations {n_iters}")
    rate = w * w * spp / t_total
    log(f"  fwd+bwd {t_total:.3f} s (forward {t_fwd:.3f} s, backward "
        f"{t_total - t_fwd:.3f} s), {rate:.0f} samples/s, {n_iters} "
        f"iterations, K1 launches {k1} (none in the backward), every pixel "
        f"completed {spp} samples, loss {float(loss.detach()):.6f}, peak memory "
        f"{peak:.2f} GiB, on {gpu_line}")
    log("  |grad| max: " + ", ".join(
        f"{k} {float(g.abs().max()):.3g}" for k, g in zip(names, grads)
        if g is not None))
    del grads, img, loss, sc, camg, params

    breakdown = fwd_bwd_breakdown(cfg, scene, cam, w, spp, seed, n_iters)
    fwd_bwd_profile(cfg, scene, cam, w, spp, seed, n_iters)
    cvc = card_vs_cpu(dev)
    return dict(k1=k1, n_iters=n_iters, seconds=t_total, rate=rate,
                peak_gib=peak, **breakdown, card_vs_cpu=cvc)


def fwd_bwd_breakdown(cfg, scene, cam, w, spp, seed, n_iters):
    """One more fwd+bwd, instrumented: every shading segment is bracketed by
    synchronisations, so its calls during the backward pass (the
    checkpoint's recompute) are timed on the host clock, and every K1
    launch by CUDA events.  The syncs slow this run down a little; its
    shares, not its total, are what it is for."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute

    real_shade = pathtracer._regen_shade
    real_k1 = mesh_brute.mesh_brute_kernel
    spent = {"shade_fwd": 0.0, "shade_bwd": 0.0}
    k1_events = []
    phase = {"now": "fwd"}

    def timed_shade(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            return real_shade(*a, **k)
        finally:
            # the checkpoint's recompute stops by an exception raised inside
            # the segment once it has the tensors it needs: time it anyway
            torch.cuda.synchronize()
            spent["shade_" + phase["now"]] += time.perf_counter() - t

    def timed_k1(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_k1(*a, **k)
        end.record()
        k1_events.append((start, end))
        return out

    pathtracer._regen_shade = timed_shade
    mesh_brute.mesh_brute_kernel = timed_k1
    try:
        sc, camg, params = _grad_leaves(scene, cam)
        px, py = pathtracer.pixel_grid(w, w, scene.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc, _, _ = pathtracer.trace_regen_scan(cfg, sc, camg, w, w, spp, px,
                                                py, seed, n_iters)
        loss = acc.mean()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        phase["now"] = "bwd"
        torch.autograd.grad(loss, [*params.values(), *camg.values()],
                            allow_unused=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    finally:
        pathtracer._regen_shade = real_shade
        mesh_brute.mesh_brute_kernel = real_k1
    k1_ms = sum(a.elapsed_time(b) for a, b in k1_events)
    fwd, bwd = t1 - t0, t2 - t1
    rec = spent["shade_bwd"]
    out = dict(fwd_s=fwd, bwd_s=bwd, recompute_s=rec, autograd_s=bwd - rec,
               k1_fwd_ms=k1_ms, k1_bwd_launches=0, shade_fwd_s=spent["shade_fwd"])
    log(f"  instrumented run: forward {fwd:.3f} s (shading {spent['shade_fwd']:.3f}"
        f" s, K1 {k1_ms / 1e3:.3f} s device time over {len(k1_events)} "
        f"launches); backward {bwd:.3f} s = recompute {rec:.3f} s "
        f"({rec / bwd:.1%}) + autograd {bwd - rec:.3f} s "
        f"({(bwd - rec) / bwd:.1%}) + K1 0 s (no launch)")
    return out


def fwd_bwd_profile(cfg, scene, cam, w, spp, seed, n_iters):
    """Device kernels of one fwd+bwd (torch.profiler, CUDA activity only):
    their summed device time against the wall clock gives the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer

    sc, camg, params = _grad_leaves(scene, cam)
    px, py = pathtracer.pixel_grid(w, w, scene.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        acc, _, _ = pathtracer.trace_regen_scan(cfg, sc, camg, w, w, spp, px,
                                                py, seed, n_iters)
        torch.autograd.grad(acc.mean(), [*params.values(), *camg.values()],
                            allow_unused=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = [(e.key, e.count, e.self_device_time_total)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows) / 1e3
    kernels = sum(r[1] for r in rows)
    k1_ms = sum(r[2] for r in rows if "mesh_brute" in r[0]) / 1e3
    log(f"  profile: wall {wall:.3f} s (profiled), {kernels} device kernels, "
        f"device busy {busy_ms:.1f} ms, idle share {1 - busy_ms / 1e3 / wall:.3f}, "
        f"K1 {k1_ms:.1f} ms ({k1_ms / max(busy_ms, 1e-9):.1%} of busy); "
        f"summarised in {time.perf_counter() - t0:.1f} s")
    for key, count, us in rows[:12]:
        log(f"    {us / 1e3:9.1f} ms  {count:7d}x  {key[:90]}")


def _cvc_runs(dev, bounces, seed, w=CVC_SIZE, spp=CVC_SPP):
    """fwd+bwd through regen_scan of cornell.json + a 320-triangle
    icosphere on the card (K1) and on the CPU (K1's twin); ``bounces``
    caps the scene's 32-bounce budget when given."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    mesh = make_icosphere(**CVC_MESH)
    runs = {}
    for kind, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell.json"),
                                mesh_override=mesh, device=d)
        if bounces is not None:
            cfg = dataclasses.replace(cfg, max_bounces=bounces)
        cam = default_camera(w, w).pytree(d)
        n = pathtracer.calibrate_regen_iters(cfg, scene, cam, w, w, spp,
                                             seed=seed)
        sc, camg, params = _grad_leaves(scene, cam)
        img, _ = pathtracer.render(cfg, sc, camg, w, w, spp, seed=seed,
                                   method="regen_scan", regen_iters=n)
        names = [("scene", k) for k in params] + [("camera", k) for k in camg]
        runs[kind] = dict(cfg=cfg, scene=scene, cam=cam, n=n, img=img,
                          names=names,
                          leaves=[*params.values(), *camg.values()])
    if runs["cuda"]["n"] != runs["cpu"]["n"]:
        fail(f"card vs CPU: {runs['cuda']['n']} != {runs['cpu']['n']} "
             "calibrated iterations")
    return runs


def _cvc_grads(runs, keep):
    """Each device's gradients of the mean over the pixels ``keep`` [H,W]
    (on the CPU), None -> zeros."""
    import torch
    out = {}
    for kind, r in runs.items():
        k = keep.to(r["img"].device)[..., None]
        loss = (r["img"] * k).sum() / (k.sum() * 3)
        g = torch.autograd.grad(loss, r["leaves"], allow_unused=True)
        out[kind] = [torch.zeros_like(x.cpu()) if y is None else y.cpu()
                     for x, y in zip(r["leaves"], g)]
    return out


def _grad_errors(names, grads, rtol, atol_of):
    """Per leaf: finite, the worst |card - CPU| / (atol + rtol |CPU|) (0/0
    counts 0, x/0 inf), the worst |card - CPU| and that over the leaf's
    largest |CPU| entry (inf where the CPU's leaf is all zero and the
    card's is not)."""
    from math import inf

    import torch
    rows = []
    for name, got, want in zip(names, grads["cuda"], grads["cpu"]):
        err = (got - want).abs()
        tol = atol_of(want) + rtol * want.abs()
        top = float(want.abs().max()) if want.numel() else 0.0
        e = float(err.max()) if err.numel() else 0.0
        rows.append(dict(
            name=f"{name[0]}.{name[1]}", finite=bool(torch.isfinite(got).all()),
            ratio=float(torch.where(err == 0, 0.0, err / tol).max())
            if err.numel() else 0.0,
            err=e, of_max=e / top if top > 0 else (0.0 if e == 0 else inf)))
    return rows


def lane_trace(cfg, scene, cam, w, spp, seed, lanes):
    """The forward loop's carry for some lanes after every iteration's
    dispatch (trace_regen, the same iteration regen_scan runs): a list of
    {field: CPU tensor [len(lanes), ...]}."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer

    rows = []
    real = pathtracer._regen_dispatch
    idx = lanes.to(scene.device)

    def recording(cfg_, scene_, shaded):
        out = real(cfg_, scene_, shaded)
        state, nee, rec, cur, pending, bounce, alpha_sum = out
        row = {f"state.{f}": getattr(state, f) for f in state._fields}
        row.update({f"hit.{f}": getattr(rec, f)
                    for f in ("t", "mesh_id", "normal", "tri")
                    if getattr(rec, f) is not None})
        for i, v in enumerate(rec.visible):
            row[f"nee{i}.visible"] = v
        for i, nb in enumerate(nee):
            row.update({f"nee{i}.{f}": getattr(nb, f) for f in nb._fields})
        row.update(cur=cur, pending=pending, bounce=bounce,
                   alpha_sum=alpha_sum)
        rows.append({k: v[idx].cpu() for k, v in row.items()})
        return out

    pathtracer._regen_dispatch = recording
    try:
        px, py = pathtracer.pixel_grid(w, w, scene.device)
        with torch.no_grad():
            pathtracer.trace_regen(cfg, scene, cam, w, w, spp, px, py, seed)
    finally:
        pathtracer._regen_dispatch = real
    return rows


def trace_parting(card_rows, cpu_rows, bound):
    """Per lane of two lane traces: the first iteration at which a discrete
    field (a path decision: a hit, a lobe counter, alive, a shadow verdict,
    the sample index) differs, -1 if none does; the float fields' worst
    |card - CPU| / (bound + bound |CPU|) over the iterations before it,
    with its field; and that worst ratio per iteration [iterations, lanes]."""
    import torch
    n = next(iter(cpu_rows[0].values())).shape[0]
    parted_at = torch.full((n,), -1, dtype=torch.int64)
    drift = torch.zeros(n)
    field = [None] * n
    series = []
    for i, (g, c) in enumerate(zip(card_rows, cpu_rows)):
        flip = torch.zeros(n, dtype=torch.bool)
        worst = torch.zeros(n)
        worst_k = [None] * n
        for k, y in c.items():
            x = g[k]
            if y.is_floating_point():
                r = ((x - y).abs() / (bound + bound * y.abs())).reshape(
                    n, -1).amax(1)
                for j in torch.nonzero(r > worst).flatten().tolist():
                    worst_k[j] = k
                worst = torch.maximum(worst, r)
            else:
                flip |= (x != y).reshape(n, -1).any(1)
        series.append(worst)
        open_ = parted_at < 0
        parted_at[open_ & flip] = i
        for j in torch.nonzero(open_ & ~flip & (worst > drift)).flatten().tolist():
            drift[j], field[j] = worst[j], worst_k[j]
    return parted_at, drift, field, torch.stack(series)


def _cvc_leg(dev, bounces, seed, fwd_bound, rtol, atol_of, problems,
             spread=None, w=CVC_SIZE, spp=CVC_SPP):
    """One card-vs-CPU comparison; appends every broken limit to
    ``problems``.  With ``spread``, a leaf beyond the gradient bound still
    passes if its error over its largest entry is within SPREAD_FACTOR x
    its spread."""
    import torch
    runs = _cvc_runs(dev, bounces, seed, w, spp)
    label = f"{bounces or 32} bounces, seed {seed}"
    img_g = runs["cuda"]["img"].detach().cpu()
    img_c = runs["cpu"]["img"].detach()
    diff = (img_g - img_c).abs()
    beyond = (diff > fwd_bound + fwd_bound * img_c.abs()).any(-1).flatten()
    lanes = torch.arange(w * w)
    traces = {kind: lane_trace(r["cfg"], r["scene"], r["cam"], w, spp, seed,
                               lanes)
              for kind, r in runs.items()}
    parted_at, drift, field, series = trace_parting(
        traces["cuda"], traces["cpu"], fwd_bound)
    parted = parted_at >= 0
    stray = beyond & ~parted
    keep = ~parted
    rows = _grad_errors(runs["cpu"]["names"],
                        _cvc_grads(runs, keep.reshape(w, w)), rtol, atol_of)
    worst = max(r["ratio"] for r in rows)
    log(f"  card vs CPU, {label}, {w}^2 x {spp} spp, {runs['cpu']['n']} "
        f"iterations: {int(beyond.sum())} of {w * w} pixels beyond "
        f"{fwd_bound} (max diff {float(diff.max()):.3g}); "
        f"{int(parted.sum())} pixels whose path took another decision on the "
        f"card (traced, left out), {int(stray.sum())} beyond the bound "
        f"without one (max diff of the kept {float(diff.flatten(0, 1)[keep].max()):.3g}); "
        f"the kept pixels' carries (every float field, dead lanes' too) "
        f"within {float(drift[keep].max()):.3g} of the bound at every "
        f"iteration, at most in "
        f"{field[int(torch.argmax(torch.where(keep, drift, -1.0)))]}")
    log(f"    gradients of the mean over the kept pixels, worst "
        f"{worst:.3g} of the bound (rtol {rtol}, atol "
        f"{'1e-6' if rtol == SHALLOW_GRAD_RTOL else f'{rtol} x its largest entry'}"
        "); per leaf err/bound, err/max: " + ", ".join(
            f"{r['name']} {r['ratio']:.2g} {r['of_max']:.2g}" for r in rows
            if r["err"] > 0))
    for p in torch.nonzero(parted).flatten()[:4].tolist():
        i = int(parted_at[p])
        g, c = traces["cuda"][i], traces["cpu"][i]
        flips = [f"{k} {g[k][p].tolist()} (card) vs {y[p].tolist()}"
                 for k, y in c.items() if not y.is_floating_point()
                 and not torch.equal(g[k][p], y[p])]
        log(f"    pixel ({p % w}, {p // w}), image diff "
            f"{float(diff.flatten(0, 1)[p].max()):.3g}: floats per iteration "
            "as a fraction of the bound [" + ", ".join(
                f"{float(r):.2g}" for r in series[:i, p]) + f"]; at iteration "
            f"{i} (sample {int(c['cur'][p])}, bounce {int(c['bounce'][p])}) "
            + "; ".join(flips[:4]))
    if parted.sum() > FLIP_PIXELS * w * w:
        problems.append(f"{label}: {int(parted.sum())} pixels took another "
                        "decision")
    if stray.any():
        problems.append(f"{label}: {int(stray.sum())} pixels beyond "
                        f"{fwd_bound} whose paths took the same decisions")
    bad = [f"{r['name']} {r['ratio']:.3g}" for r in rows
           if not r["finite"] or (r["ratio"] > 1.0 and (
               spread is None
               or r["of_max"] > SPREAD_FACTOR * spread.get(r["name"], 0.0)))]
    if spread is not None:
        log("    leaves beyond it, err/max against the two CPU "
            "implementations' spread: " + (", ".join(
                f"{r['name']} {r['of_max']:.2g} ("
                f"{r['of_max'] / spread[r['name']]:.2g}x of "
                f"{spread[r['name']]:.2g})" for r in rows
                if r["ratio"] > 1.0 and r["name"] in spread) or "none"))
    if bad:
        problems.append(f"{label}: gradients beyond the bound: "
                        + ", ".join(bad))
    return dict(beyond=int(beyond.sum()), parted=int(parted.sum()),
                stray=int(stray.sum()), grad_worst=worst)


def card_vs_cpu(dev):
    """fwd+bwd of cornell.json + a 320-triangle icosphere, 32^2 x 2 spp, on
    the card (K1) and on the CPU (K1's twin), every gradient compared.

    Every pixel's path is traced iteration by iteration on both devices
    (trace_regen, the same iterations regen_scan runs).  An ulp of
    difference between the two devices' float32 math can flip a discrete
    decision of a path (roulette, lobe choice, a near-tie between two
    hits), after which that pixel's later samples differ entirely.  Only
    pixels whose trace shows such a decision parting are left out (at most
    FLIP_PIXELS of them, each printed with where it parts); every other
    pixel must agree within the forward bound, and the gradients of the
    mean over them within the gradient bound: at the scene's 32 bounces,
    on two seeds, tests/test_torch_grad.py's 32-bounce bound; at 4 bounces
    its <= 4-bounce bound, or, for a leaf beyond it, no farther from the
    CPU than SPREAD_FACTOR x the JAX package's CPU gradient is from the
    port's on the same input (GRAD_SPREAD_4)."""
    problems = []
    out = {"4 bounces, seed 3": _cvc_leg(
        dev, 4, 3, FWD_SHALLOW, SHALLOW_GRAD_RTOL,
        lambda want: SHALLOW_GRAD_ATOL, problems, spread=GRAD_SPREAD_4)}
    for seed in CVC_SEEDS:
        out[f"32 bounces, seed {seed}"] = _cvc_leg(
            dev, None, seed, FWD_DEEP, DEEP_GRAD_REL,
            lambda want: DEEP_GRAD_REL * float(want.abs().max()), problems)
    if problems:
        fail("card vs CPU: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 9: inverse rendering
# ---------------------------------------------------------------------------

def phase_inverse(dev, gpu_line):
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.diff import fit_scene
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    w, spp, steps = 128, 4, 4
    log(f"[9] inverse rendering: fit_scene(method='regen_scan'), {steps} Adam "
        f"steps at {w}^2 x {spp} spp on cornell_hi, red wall perturbed")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    cam = default_camera(w, w).pytree(dev)
    target, _ = pathtracer.render(cfg, scene, cam, w, w, spp, seed=11,
                                  method="regen")
    wall = 5  # objects are [sphere | 6 quads]; quad 4 is the red wall
    color = scene.color.clone()
    color[wall] = torch.tensor([0.2, 0.6, 0.9], device=dev)
    wrong = dataclasses.replace(scene, color=color)
    mesh_brute.mesh_brute_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_scene(cfg, wrong, cam, w, w, spp, target, steps=steps, lr=0.05,
                    param_leaves=("color",), method="regen_scan")
    losses = res.losses.cpu().numpy()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1 = mesh_brute.mesh_brute_kernel.launches
    rec = res.scene.color[wall].cpu().numpy()
    log(f"  losses {np.array2string(losses, precision=6)}, wall colour "
        f"{np.array2string(rec, precision=3)} (truth [0.8 0.1 0.1]), "
        f"{secs:.2f} s, K1 launches {k1}, on {gpu_line}")
    if not np.isfinite(losses).all():
        fail("inverse rendering: non-finite loss")
    if not losses[-1] < losses[0]:
        fail(f"inverse rendering: loss did not fall ({losses[0]} -> {losses[-1]})")
    if k1 == 0:
        fail("inverse rendering: K1 never launched")
    return k1


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, PKG)):
        fail(f"the port package {PKG}/ is not beside this script")
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    dev = torch.device("cuda", 0)

    log("[1] device")
    gpu_line = nvidia_smi_line()
    log(f"  nvidia-smi: {gpu_line}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    log("[2] build")
    _cuda.LIBRARY.get()
    secs = _cuda.LIBRARY.build_seconds
    log(f"  nvcc {'(already built)' if secs is None else f'{secs:.2f} s'} "
        f"({len(_cuda.LIBRARY.sources())} sources)")
    for line in _cuda.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())

    k1_err, k1_times = phase_k1(dev)
    k2_err, k2_ms, k2_plain_ms, k2_bound, k2_by = phase_k2(dev)
    phase_goldens(dev)
    launches, _ = phase_slice(dev, gpu_line, spp=8)
    k3 = phase_k3(dev)
    fb = phase_fwd_bwd(dev, gpu_line)
    k1_fit = phase_inverse(dev, gpu_line)

    cam_ms = k1_times["camera"]
    k1_paths = {"forward 512^2 x 8 spp": launches["K1"],
                "fwd+bwd 512^2 x 4 spp": fb["k1"],
                "fit_scene 4 steps 128^2 x 4 spp": k1_fit}
    kernels = [
        {"name": "K1 mesh_brute", "route": "cuda",
         "source": f"{PKG}/csrc/mesh_brute.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py:301",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
         "max_abs_err": k1_err, "ms": cam_ms[0], "plain_ms": cam_ms[1],
         "bound_ms": cam_ms[2], "bound_by": cam_ms[3], "library_ms": None,
         "timed_by": TIMED_BY},
        {"name": "K2 tonemap", "route": "cuda",
         "source": f"{PKG}/csrc/tonemap.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/pallas_kernels.py:39",
         "launches": launches["K2"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None,
         "timed_by": TIMED_BY},
        {"name": "K3 block_scan", "route": "cuda",
         "source": f"{PKG}/csrc/block_scan.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/pallas_kernels.py:98",
         "launches": k3["launches"], "max_abs_err": k3["err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound"],
         "bound_by": k3["by"], "library_ms": k3["library_ms"],
         "timed_by": TIMED_BY},
    ]
    log("fwd+bwd: " + json.dumps({k: v for k, v in fb.items()}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
