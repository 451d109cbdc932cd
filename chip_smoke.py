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
     batch of closest + any-hit lanes with inactive lanes mixed in; the
     render population, the merged batch phase 6's regen forward sends to
     mesh_closest at its RENDER_CALL-th call (captured from the port's own
     call, which is also run with the ray sort on and off, bitwise equal,
     and timed: the call, K1 and the sort's own device time); each of the
     four in lane order and sorted by the reference's key
     (intersect.ray_sort_key), the sorted results bitwise the unsorted
     ones; plus a 600-ray icosphere case for padding.  Per population:
     flips, K1's time by CUDA events over 10 launches and by the profiler,
     the twin's, the bound and the share of lane slots doing triangle
     work; and K1 on both render batches with their warps launched in a
     random grid order.
  4. K2 (csrc/tonemap.cu) against its plain twin: a seeded 512^2 HDR image,
     the edge set (K2_EDGES on images with sides of 1, 3, 33 and 47) and a
     16-byte misaligned view, vignette on/off, brightness 1.0/1.7: NaN in
     the same channels, the rest within K2_ATOL; the same images launched
     in bands of 4,100 pixels (bands that start mid-row); a 26755^2 image
     (3*H*W > 2^31 - 1, two bands) against the plain version on rows at
     its ends and around the band boundary; K2's time warm and with the L2
     flushed before each launch.
  5. Anchors: the cornell_simple, mesh_icosphere and cornell_hi_bvh configs
     of tests/golden_tool.py rendered by the port on the card against the
     stored goldens (rendered by the JAX package on the CPU).
  6. The forward slice at size: cornell_hi.json, 512^2 x 8 spp, seed 0,
     render(method="regen") -> tonemap -> write_png, with launch counts;
     then the frame with the ray sort off and on, in turns, bitwise equal.
  7. K3 (csrc/block_scan.cu) against its plain version: every block from
     32 to 1024, 262,144 flags (a 512^2 frame's lanes) and ragged sizes at
     five densities, an int32 wrap-around and a misaligned view, 0
     mismatches allowed; compact_indices driven once on a frame's lanes;
     K3 at 262,144 and 16,777,216 flags (a 4096^2 frame's), warm and with
     the L2 flushed, in turns with x.clone() of the flags and with the
     per-block torch.cumsum; the plain version, and the whole
     exclusive_prefix_sum against a torch.cumsum of the whole array.
  8. The fwd+bwd slice at size: cornell_hi.json, 512^2 x 4 spp, seed 3,
     value-and-grad of mean(image) through render(method="regen_scan") over
     every float leaf of the scene and the camera, with the calibrated
     budget: completed == spp, finite gradients, non-zero colour and camera
     gradients, K1 launches == iterations.  Then a device profile (of the
     same at 1 spp), and a
     32^2 x 2 spp fwd+bwd run of cornell.json + a 320-triangle icosphere
     on the card against the CPU (K1 against its twin) at 4 bounces with
     every pixel compared (the 32-bounce legs, each left-out pixel's path
     traced on both devices, are tests/test_torch_cuda.py's).
  9. Inverse rendering: 2 Adam steps of fit_scene(method="regen_scan") at
     128^2 x 4 spp on cornell_hi with the red wall's colour perturbed.
 10. T1 (csrc/matmul_only.cu, K1's compute-only ablation) against its plain
     version on the cornell_hi tables and phase 3's random population at
     128 and 256 rays a block, within 1e-5 of each ray's sum of absolute
     terms; the opcode counts of its inner loop (cuobjdump -sass); its time
     at both blocks against its FLOP bound and its FP32 issue floor; the
     (ray, tile) pairs it adds against those K1 tests; times of its plain
     version and the relevance pass, and K1 / T1 on that batch; then the K1
     microbenchmark (tools/bench_kernel.py) as a user runs it.
 11. T2a / T2b (csrc/passthrough.cu) bitwise against x.clone() on
     262,144 x 3 floats, each timed against x.clone() in turns inside one
     profiler window, warm and with the L2 flushed before each call; T2a
     bitwise on a ragged N at each float offset; then the barrier probe
     (tools/barrier_test.py):
     bounce_step on cornell_simple at 262,144 lanes with 0, 1 or 2 extra
     copies in shadow_visible.
 12. render(method="scan") and (method="while") of cornell_hi at 512^2 x 8
     spp under torch.no_grad(), tonemapped to PNG, every pixel held against
     phase 6's regen image; K1 launches spp x (n_steps + 1) for scan.
 13. scan fwd+bwd: value-and-grad of mean(image) through render's default
     method, cornell_hi 512^2 x 4 spp, over every float leaf + camera:
     finite gradients, non-zero colour and camera gradients, no K1 launch
     in the backward, peak memory.
 14. Goldens through render's default method: phase 5's three plus
     multi_light_pick, alpha_test, coat_grazing and materials, on the card
     and on the CPU.
 15. materials.json (every BSDF family) at 512^2 x 8 spp through scan.
 16. The CLI (python -m the port) on cornell_hi at 1024^2, its default
     size, as a user runs it: 8 spp (its default 64 cut to fit) with a
     checkpoint every 4; resumed at 8 (re-export only) and to 12; the
     12-spp render through app.main in this process with K1 (bounces run +
     one camera dispatch a sample), K2 (once, at export) counted, its
     state bitwise the resumed one and its image bitwise
     render(method="while"); the five --aov modes (mesh_id and the
     traversal tile counts bitwise the CPU's on a 64^2 centre crop);
     -encoder 1 read back within RGBE's rounding; the interactive viewer
     with piped commands and an ANSI preview; --profile on one sample
     (K1's records in the trace, the card's idle share); K1 against its twin
     on the merged batch of the app.main run's CLI_K1_CALL-th mesh dispatch
     as launched (phase 3's limits), K2 against its plain version on that
     run's exported image and on the five AOV images.  Then threefry2x32 and
     mwc_hash words and Sampler streams on the card bitwise the CPU's, and
     cornell_simple 512^2 x 2 spp frames by each scheme, in turns, against
     pcg4d (and 48^2 frames against the CPU).
 17. Path A (BASELINE config 3): sdf_demo.json (3 SDFs, a box, 8 bounces)
     with icosphere_hi (81,920 triangles) as its mesh, 512^2 x 8 spp by
     regen (profiled at 1 spp for the idle share), while and scan (each
     tonemapped, K2), all three equal; fwd+bwd regen_scan 512^2 x 4 spp
     over every float leaf (SDF params and position non-zero, K1 none in
     the backward, peak memory); one SDF march step's kernels; K1 against
     its twin on the regen frame's SDF_K1_CALL-th merged batch; card
     against CPU at 64^2 with a 1,280-triangle icosphere: one bounce on
     identical camera rays every pixel within FWD_SHALLOW, the 8-bounce
     image mean within SDF_DEEP_MEAN_REL.
 18. Path B (BASELINE config 4): cornell_media.json (homogeneous, 12
     bounces, 64 scatter events) and its height fog (tests/golden_tool.py's
     exponential medium), each with icosphere_hi, under HG and Rayleigh:
     regen 512^2 x 8 spp; under HG fwd+bwd regen_scan 512^2 x 4 spp over
     the sigmas, phase_g and the colours; card against CPU at 64^2, 4
     bounces, every lane traced: parted pixels left out, the rest within
     FWD_MEDIUM.
 19. Path C (BASELINE config 5): materials.json lit by a 2048 x 1024
     equirect map made from the seed, written by write_hdr and read back,
     thin-lens camera: the CLI -hdr at 1024^2 x 16 spp as a process and
     through app.main (K2 at export counted); fwd+bwd regen_scan at 1024^2
     x 4 spp (the spp cut from BASELINE's 256 to fit) over env_map, the
     colours and the lens, peak memory; K2 on the frame against its plain
     version; the idle share of a 1-spp regen frame; the env_map
     gradient's scatter against index_add_ (CUDA events); card against CPU
     at 64^2 with a 128 x 64 map, 4 bounces, traced lanes, FWD_SHALLOW.
 20. The goldens sdf_demo, cornell_media, envmap and exponential_fog
     through render's default method on the card and the CPU.

Prints the kernels' JSON line (with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the H100 SXM's
HBM3 rate and FP32 peak), the nvidia-smi line, and last the result line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result line
when there is no CUDA device or when the port is not beside it.

    python3 chip_smoke.py --kernels-only

runs phases 1-3, 10 and 11 alone (the kernels' checks and times) and
prints no result line.

    python3 chip_smoke.py --k1-sweep

runs phases 1-3, then builds csrc/mesh_brute.cu once for each K1
configuration of K1_SWEEP (its PRT_K1_* macros) and times each on phase
3's populations, held bitwise against the kernel library's build; no
result line.

    python3 chip_smoke.py --op-census

runs phase 1, then for each sampler the progressive frame of
tests/test_torch_cuda.py::test_progressive_on_card_matches_cpu on the card
and on the CPU with every ATen call recorded: the ops whose outputs differ
from bitwise-equal inputs (ulps, the port's lines that call them), and the
card's run again with those ops evaluated on the CPU; no result line.

    python3 chip_smoke.py --paths

runs phases 1-2 and 17-20 alone; no result line.

    python3 chip_smoke.py --kernel-times [--port-root DIR]

runs phases 1-2 and only the times of K2, K3, T2a and T2b (phases 4, 7
and 11, warm and L2-flushed) and of T1 (phase 10's, with its inner loop's
SASS) on the port in DIR (a checkout of another commit; this one's by
default), as one JSON line; no result line.  Two commits compare in one
call: run it for each, in turns.
"""
from __future__ import annotations

import json
import os
import re
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
# K2's edge set: non-finite, negative, zero, tiny and huge radiance (at
# 1e20 the curve overflows to NaN), written over seeded channels of images
# with every side of 1, 3, 33 and 47 pixels; tests/test_torch_tonemap.py
# and tests/test_torch_cuda.py use it too
K2_EDGES = (np.nan, np.inf, -np.inf, -1.0, -1e4, -1e-8, 0.0, 1e-8, 1e4,
            1e20, -1e20)
K2_EDGE_SIZES = ((1, 1), (1, 47), (3, 33), (33, 3), (47, 1), (47, 33))
# written between launches for the L2-flushed readings (the H100's L2 holds
# 50 MB; the microsecond kernels' 3-6 MB stay in it between launches)
L2_FLUSH_BYTES = 256 << 20
# a profiler window that keeps no device record at all (seen once in a
# proof run, phase 7) is run again, up to this many windows
PROFILER_ATTEMPTS = 3
RAYS = 262144
FRAME = 512  # the side of the frames rendered at size (phases 12, 13, 15)

# the H100 SXM's published peaks (NVIDIA data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# K1's FP32 operations (an FMA counts 2) per ray-triangle test: den 5,
# t*den 6, u*den 11, v*den 11, den^2 1, the three barycentric products 5,
# t*den*den 1, EPS*den^2 1; and per (ray, tile) AABB slab test: the pad 7,
# six slab distances 18, entry/exit 11, the t test 2
K1_PAIR_FLOPS = 41
K1_SLAB_FLOPS = 38
# --k1-sweep's grid of K1 configurations, each a build of csrc/mesh_brute.cu:
# (rays per block, the popcount from which a warp runs per-thread mode (33:
# never), triangles a lane per spread-mode pass)
K1_SWEEP = [(b, p, u) for b in (64, 128, 256) for u in (1, 2, 4)
            for p in (1, 16, 24, 28, 32, 33)]
# the render population: the merged batch that the cornell_hi 512^2 x 8 spp
# regen forward (phase 6's render) sends to mesh_closest at this call
RENDER_CALL = 10
# records of K1's first design (one thread per ray, a tile staged per
# block) on NVIDIA H100 80GB HBM3, 700.00 W, logged beside this run's: its
# profiler time a launch on phase 3's populations (a mean over launches of
# which the profiler kept only some: they read low); K1 / T1 in
# tools/bench_kernel.py (8.116 / 11.999 ms)
K1_FIRST_DESIGN_MS = {"random": 10.339, "camera": 1.370, "surface": 18.239}
K1_T1_FIRST_DESIGN = 0.68
# phase 6's regen forward mean radiance with K1's first design (the image
# cannot move: K1 is bitwise its twin, sorted or not), and how far it may be
REGEN_MEAN_RECORD, REGEN_MEAN_REL = 0.362928, 1e-4
# card vs CPU: the forward bounds of tests/test_torch_grad.py at <= 4 and
# at 32 bounces, and its gradient bounds at <= 4 bounces
FWD_SHALLOW = 1e-5
SHALLOW_GRAD_RTOL, SHALLOW_GRAD_ATOL = 1e-4, 1e-6
# card vs CPU: pixels allowed to take another path decision, each backed
# by its traced divergence
FLIP_PIXELS = 0.01
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


def k2_edge_image(h: int, w: int, seed: int) -> np.ndarray:
    """[h, w, 3] float32: uniform(0, 3) radiance with K2_EDGES, cycled,
    written over a seeded third of its channels (all of them on a 1x1)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 3.0, (h, w, 3)).astype(np.float32)
    flat = img.reshape(-1)
    idx = rng.permutation(flat.size)[:max(len(K2_EDGES), flat.size // 3)]
    flat[idx] = np.resize(np.array(K2_EDGES, np.float32), idx.size)
    return img


def k2_compare(got, want) -> tuple[int, float]:
    """K2 against its plain version -> (channels where exactly one of the
    two is NaN, max abs difference over the channels where neither is)."""
    import torch
    got_nan, want_nan = torch.isnan(got), torch.isnan(want)
    both = ~(got_nan | want_nan)
    diff = float((got - want)[both].abs().max()) if bool(both.any()) else 0.0
    return int((got_nan != want_nan).sum()), diff


def l2_flush(dev):
    """A call that writes L2_FLUSH_BYTES of device memory (one fill kernel),
    so that the next launch finds none of its data in the L2."""
    import torch
    scratch = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                          device=dev)
    return lambda: scratch.fill_(1.0)


def _profile(fn, reps: int, flush=None):
    """torch.profiler's rows (CUDA activity) of ``reps`` calls of ``fn()``,
    after one warm-up call: the rows with device time.  With ``flush``
    (``l2_flush``), each call follows a ``flush()``, whose rows are left
    out by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    skip = record_names(flush) if flush else set()
    fn()  # warm-up
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush:
                    flush()
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.self_device_time_total > 0 and e.key not in skip]
        if rows:
            break
        log(f"  the profiler kept no device record (window {attempt + 1} "
            f"of {PROFILER_ATTEMPTS})")
    return rows


def record_names(fn) -> set:
    """The names of the device records calls of ``fn()`` make (ten calls a
    window, up to five windows: a window may keep none of the records)."""
    for _ in range(5):
        names = {e.key for e in _profile(fn, 10)}
        if names:
            return names
    fail("record_names: five profiler windows kept no device record")


def device_ms(fn, reps: int) -> tuple[float, int]:
    """Device milliseconds a call of ``fn()``, by torch.profiler: the
    device time of every kernel the ``reps`` calls launched, over ``reps``
    -> (ms a call, kernel records kept).  For calls of several kernels
    (plain versions, library calls) and for kernels short enough that
    back-to-back launches from Python leave the card idle between them,
    where CUDA events around the loop would time the host."""
    rows = _profile(fn, reps)
    return (sum(e.self_device_time_total for e in rows) / reps / 1e3,
            sum(e.count for e in rows))


def kernel_ms(fn, reps: int, flush=None) -> tuple[float, int]:
    """Device milliseconds of the one kernel ``fn()`` launches, by
    torch.profiler over ``reps`` calls (each after ``flush()``, where
    given): the mean over the kernel records it kept -> (ms, records
    kept).  On the H100 the profiler has kept fewer records than launches
    of long kernels; a mean over the records kept is a launch's time only
    where each call is one kernel."""
    rows = _profile(fn, reps, flush)
    n = sum(e.count for e in rows)
    return sum(e.self_device_time_total for e in rows) / max(n, 1) / 1e3, n


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


def profiled(fn):
    """``fn()`` once under torch.profiler -> (its result, the device
    milliseconds of the kernels it launched)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, sum(e.self_device_time_total
                    for e in prof.key_averages()) / 1e3


def k1_compare(name, feat, clusters, tri_verts, b, problems,
               t_rtol=K1_T_RTOL):
    """One merged batch through K1 and the twin (timed by the profiler on
    this run); returns the worst t error, the flip counts, the twin's
    device ms and K1's outputs, and appends every broken limit to
    ``problems``."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import (
        _tri_intersect,
    )
    t_k, i_k = mesh_brute.mesh_intersect(
        feat, clusters, b["origin"], b["direction"], b["t_init"],
        active=b["active"], any_hit=b["any_hit"], exclude=b["exclude"])
    (t_x, i_x), twin_ms = profiled(lambda: mesh_brute._intersect_xla(
        feat, clusters, b["origin"], b["direction"], b["t_init"],
        b["active"], exclude=b["exclude"]))
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
        f"worst err/tolerance {worst:.3g}"
        + (" (t bitwise)" if max_abs == 0.0 else ""))
    if win_flips > FLIP_LIMIT * n_closest:
        problems.append(f"K1 {name}: {win_flips} winner flips > {FLIP_LIMIT} "
                        "per ray")
    if occ_flips > FLIP_LIMIT * n_any:
        problems.append(f"K1 {name}: {occ_flips} occlusion flips > "
                        f"{FLIP_LIMIT} per ray")
    if worst > 1.0:
        problems.append(f"K1 {name}: t error {worst:.3g}x its tolerance")
    return dict(err=max_abs, win_flips=win_flips, occ_flips=occ_flips,
                twin_ms=twin_ms, t=t_k, tri=i_k)


def k1_counters(feat, clusters, b):
    """K1's work counters on one batch (csrc/mesh_brute.cu): (warp, tile)
    pairs processed, (ray, tile) pairs whose ray needed the tile's
    triangles, (ray, tile) slab tests, and of the first two those run in
    per-thread mode.  The launch that fills them is a measurement, outside
    any path's count."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    counters = torch.zeros(mesh_brute.K1_COUNTERS, dtype=torch.int64,
                           device=feat.device)
    mesh_brute.mesh_brute_kernel(feat, clusters, b["origin"], b["direction"],
                                 b["t_init"], b["active"], b["any_hit"],
                                 b["exclude"], counters=counters)
    return tuple(int(x) for x in counters.cpu())


def k1_bound(feat, clusters, b):
    """K1's bound on one batch, from the work this batch needs: the kernel's
    own counters give the (ray, tile) pairs whose ray passed the tile's
    slab test (each 128 ray-triangle tests) and the live rays' slab tests.
    Beside it, the share of the lane slots K1 spends on triangle tests that
    do such work: in spread mode every lane of the warp tests triangles of
    a needing ray; in per-thread mode the warp's 32 lanes run 128 tests
    each, of which only the needing lanes' count.  -> (bound ms, what
    bounds it, lane-slot share, counters)."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    counts = k1_counters(feat, clusters, b)
    warp_tiles, ray_tiles, slabs, pt_warp_tiles, pt_ray_tiles = counts
    n = b["origin"].shape[0]
    tile = mesh_brute.TILE
    n_bytes = (feat.numel() * 4 + clusters.numel() * 4
               + n * (12 + 12 + 4 + 1 + 1 + 4)  # o, d, t_init, flags, exclude
               + n * (4 + 4))  # t, tri
    flops = ray_tiles * tile * K1_PAIR_FLOPS + slabs * K1_SLAB_FLOPS
    spent = (ray_tiles - pt_ray_tiles) * tile + pt_warp_tiles * 32 * tile
    share = ray_tiles * tile / max(spent, 1)
    warps = -(-n // 32)
    idle = int((~b["active"]).reshape(-1, 32).all(1).sum()) if n % 32 == 0 else 0
    log(f"    K1 work: {ray_tiles} (ray, tile) pairs tested, {slabs} slab "
        f"tests; {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP.  Warp "
        f"granularity: {idle} of {warps} warps have no active lane; "
        f"{warp_tiles} (warp, tile) pairs processed of "
        f"{warps * clusters.shape[0]}, {pt_warp_tiles} of them per-thread "
        f"({pt_ray_tiles} (ray, tile) pairs); {share:.1%} of the lane slots "
        "spent on triangle tests test a needing ray's triangle")
    bound, by = bound_ms(n_bytes, flops)
    return bound, by, share, counts


def k1_warps_shuffled(feat, clusters, b, out, problems):
    """K1 on batch ``b`` with its 32-lane warps launched in a random order
    (seeded): what a warp holds stays, where it sits in the grid moves.
    Its results must be ``out`` (the batch's own) moved the same way ->
    CUDA-event ms a launch over 10 launches."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    n = b["origin"].shape[0]
    warps = torch.randperm(n // 32, generator=torch.Generator().manual_seed(0))
    lanes = (warps[:, None] * 32 + torch.arange(32)).reshape(-1).to(
        b["origin"].device)
    s = {k: v[lanes] for k, v in b.items()}
    args = (feat, clusters, s["origin"], s["direction"], s["t_init"],
            s["active"], s["any_hit"], s["exclude"])
    t, tri = mesh_brute.mesh_brute_kernel(*args)
    if not (torch.equal(t, out[0][lanes]) and torch.equal(tri, out[1][lanes])):
        problems.append("K1: a batch's results moved with its warps differ")
    return cuda_ms(lambda: mesh_brute.mesh_brute_kernel(*args), 10)


def k1_sorted(b, clusters):
    """A batch's lanes in the order of the reference's ray sort (stable)
    -> (sorted batch, the permutation)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import (
        ray_sort_key,
    )
    key = ray_sort_key(b["origin"], b["direction"], clusters)
    perm = torch.sort(key, stable=True).indices
    return {k: v[perm] for k, v in b.items()}, perm


def k1_batch(origin, direction, t_init, any_hit, active, exclude):
    """``mesh_closest``'s arguments as K1's wrapper receives them: every
    lane argument a tensor of its own [N]."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops.mesh_brute import (
        _lane_tensor,
    )
    n, dev = origin.shape[0], origin.device
    return dict(origin=origin.contiguous(), direction=direction.contiguous(),
                t_init=_lane_tensor(t_init, n, torch.float32, dev, None),
                any_hit=_lane_tensor(any_hit, n, torch.bool, dev, False),
                active=_lane_tensor(active, n, torch.bool, dev, True),
                exclude=_lane_tensor(exclude, n, torch.int32, dev, -1))


def k1_render_population(cfg, scene, dev, problems, spp=8, w=FRAME):
    """The merged closest + shadow batch that the regen forward of
    cornell_hi at w^2 x spp, seed 0 (phase 6's render) sends to
    ``mesh_closest`` at its RENDER_CALL-th call, captured from the port's
    own call, as K1's wrapper receives it (lane order).  The captured call
    is also run through ``mesh_closest`` with the scene's ray sort on and
    off, whose outputs must be bitwise equal."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )

    class Captured(Exception):
        pass

    real = intersect.mesh_closest
    calls = []

    def capture(cfg_, scene_, origin, direction, t_init, any_hit=False,
                active=None, exclude_tri=None):
        calls.append(None)
        if len(calls) == RENDER_CALL:
            raise Captured(origin, direction, t_init, any_hit, active,
                           exclude_tri)
        return real(cfg_, scene_, origin, direction, t_init, any_hit=any_hit,
                    active=active, exclude_tri=exclude_tri)

    cam = default_camera(w, w).pytree(dev)
    intersect.mesh_closest = capture
    try:
        with torch.no_grad():
            pathtracer.render(cfg, scene, cam, w, w, spp, seed=0,
                              method="regen")
        fail(f"the regen render made fewer than {RENDER_CALL} mesh calls")
    except Captured as got:
        o, d, t_init, any_hit, active, exclude = got.args
    finally:
        intersect.mesh_closest = real
    n = o.shape[0]
    b = k1_batch(o, d, t_init, any_hit, active, exclude)

    def closest(on):
        return real(dataclasses.replace(cfg, mesh_sort_rays=on), scene, o, d,
                    t_init, any_hit=any_hit, active=active,
                    exclude_tri=exclude)

    with torch.no_grad():
        outs = [closest(on) for on in (True, False)]
        cost = k1_sort_cost(closest)
    same = all(torch.equal(x, y) for x, y in zip(outs[0][:2], outs[1][:2]))
    log(f"  render population: mesh_closest call {RENDER_CALL} of the regen "
        f"forward, {n} lanes ({int(b['any_hit'].sum())} any-hit, "
        f"{int(b['active'].sum())} active); mesh_closest with the ray sort "
        f"on and off: t and tri {'bitwise equal' if same else 'DIFFER'}")
    if not same:
        problems.append("mesh_closest: sorted and unsorted dispatches differ")
    return b, cost


def k1_sort_cost(closest, reps=10):
    """What the ray sort costs ``mesh_closest`` on one batch: ``closest(on)``
    calls it with the sort on or off.  CUDA-event ms a call over ``reps``
    back-to-back calls, on and off in turns (on, off, off, on); and, in a
    profiler window of ``reps`` calls each, K1's device ms (a mean over its
    records kept) and the device ms a call of every other kernel, whose
    difference on less off is the sort's own device time (key, sort,
    gathers and the scatters back); and the operations of one call that
    synchronise the host with the card (torch.cuda's sync debug mode)."""
    import warnings

    import torch
    ev = {True: [], False: []}
    for on in (True, False, False, True):
        ev[on].append(cuda_ms(lambda: closest(on), reps))
    out = {}
    for on in (True, False):
        rows = _profile(lambda: closest(on), reps)
        k1 = [e for e in rows if "mesh_brute" in e.key]
        rest = [e for e in rows if "mesh_brute" not in e.key]
        k1_n = sum(e.count for e in k1)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                closest(on)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        # where each synchronising operation was called from
        syncs = [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]
        out["on" if on else "off"] = dict(
            syncs=len(syncs), sync_ops=sorted(set(syncs)),
            call_ms=sum(ev[on]) / len(ev[on]),
            k1_ms=sum(e.self_device_time_total for e in k1) / max(k1_n, 1) / 1e3,
            k1_records=k1_n,
            other_ms=sum(e.self_device_time_total for e in rest) / reps / 1e3,
            other_kernels=sum(e.count for e in rest) / reps)
    on, off = out["on"], out["off"]
    out["sort_ms"] = on["other_ms"] - off["other_ms"]
    log(f"  mesh_closest on it, sort on / off: {on['call_ms']:.3f} / "
        f"{off['call_ms']:.3f} ms a call (CUDA events, {reps} calls back to "
        f"back, in turns); device time: K1 {on['k1_ms']:.3f} / "
        f"{off['k1_ms']:.3f} ms (a record; {on['k1_records']} / "
        f"{off['k1_records']} of {reps} kept), the other kernels "
        f"{on['other_ms']:.4f} / {off['other_ms']:.4f} ms a call "
        f"({on['other_kernels']:.0f} / {off['other_kernels']:.0f} kernels): "
        f"the sort's own device time {out['sort_ms']:.4f} ms a call; "
        f"synchronising operations a call {on['syncs']} / {off['syncs']} "
        f"(on: {on['sync_ops'][:4]})")
    return out


def k1_variants(configs):
    """csrc/mesh_brute.cu built once for each configuration, through its
    PRT_K1_* macros, into a directory of this process under _build/ (one
    nvcc a build, as many at once as there are cores) -> {configuration:
    (its prt_mesh_brute, registers a thread)}."""
    import ctypes
    import re
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    out_dir = os.path.join(_cuda.BUILD_DIR, f"k1_sweep.{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_cuda.CSRC_DIR, "mesh_brute.cu")
    todo, running, built = list(configs), [], {}
    t0 = time.perf_counter()
    while todo or running:
        while todo and len(running) < (os.cpu_count() or 4):
            b, p, u = cfg = todo.pop(0)
            so = os.path.join(out_dir, f"k1_{b}_{p}_{u}.so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                   f"-DPRT_K1_BLOCK_RAYS={b}", f"-DPRT_K1_PER_THREAD_FROM={p}",
                   f"-DPRT_K1_PASS={u}", "-o", so, src]
            running.append((cfg, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        cfg, so, proc = running.pop(0)
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"K1 sweep: nvcc failed for {cfg}:\n{out}")
        fn = ctypes.CDLL(so).prt_mesh_brute
        fn.argtypes = _cuda._SIGNATURES["prt_mesh_brute"]
        fn.restype = ctypes.c_int
        regs = re.findall(r"Used (\d+) registers", out)
        built[cfg] = (fn, int(regs[0]) if regs else -1)
    log(f"  K1 sweep: {len(built)} builds of mesh_brute.cu, "
        f"{time.perf_counter() - t0:.1f} s")
    return built


def k1_sweep(feat, clusters, pops, reps=5):
    """Every configuration of K1_SWEEP, each its own build of K1, on every
    population: CUDA-event ms a launch over ``reps`` back-to-back launches,
    logged; each configuration's outputs held bitwise against the kernel
    library's (the render path's build) -> the (configuration, population)
    pairs that disagreed."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    variants = k1_variants(K1_SWEEP)
    table, wrong = {}, []
    for name, b in pops.items():
        n = b["origin"].shape[0]
        t0, i0 = mesh_brute.mesh_brute_kernel(
            feat, clusters, b["origin"], b["direction"], b["t_init"],
            b["active"], b["any_hit"], b["exclude"])
        t = torch.empty_like(t0)
        i = torch.empty_like(i0)
        for cfg, (fn, _) in variants.items():
            def launch(fn=fn):
                code = fn(feat.data_ptr(), feat.stride(0), clusters.shape[0],
                          clusters.data_ptr(), b["origin"].data_ptr(),
                          b["direction"].data_ptr(), b["t_init"].data_ptr(),
                          b["active"].data_ptr(), b["any_hit"].data_ptr(),
                          b["exclude"].data_ptr(), n, t.data_ptr(),
                          i.data_ptr(), None,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    fail(f"K1 sweep: {cfg} returned CUDA error {code}")
            launch()
            if not (torch.equal(t, t0) and torch.equal(i, i0)):
                wrong.append((cfg, name))
            table.setdefault(cfg, {})[name] = cuda_ms(launch, reps)
    names = list(pops)
    log("  K1 sweep (CUDA events, ms a launch over "
        f"{reps} launches; rays per block, per-thread from popcount, "
        "triangles a lane per spread-mode pass; registers): "
        + " | ".join(names))
    for cfg, row in sorted(table.items(), key=lambda kv: kv[1]["render sorted"]):
        log(f"    {cfg} {variants[cfg][1]}: "
            + " ".join(f"{row[k]:.3f}" for k in names))
    return wrong


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
        f"{scene.bf_clusters.shape[0]} tiles, mesh_sort_rays "
        f"{cfg.mesh_sort_rays}, {time.perf_counter() - t0:.2f} s")
    feat, clusters = scene.bf_feat, scene.bf_clusters
    problems = []
    if not cfg.mesh_sort_rays:
        problems.append("cornell_hi: the loader did not set mesh_sort_rays")
    base = k1_populations(scene, dev)
    base["render"], sort_cost = k1_render_population(cfg, scene, dev,
                                                     problems)
    pops, perms = {}, {}
    for name, b in base.items():
        pops[name] = b
        pops[f"{name} sorted"], perms[name] = k1_sorted(b, clusters)
    worst = 0.0
    timings = {}
    outs = {}
    for name, b in pops.items():
        r = k1_compare(name, feat, clusters, scene.bf_tri_verts, b, problems)
        outs[name] = (r["t"], r["tri"])
        worst = max(worst, r["err"])
        if name.endswith(" sorted"):
            # the sorted batch's results, put back in lane order, are the
            # unsorted batch's, bit for bit
            unsorted = name[:-len(" sorted")]
            perm = perms[unsorted]
            t_u, i_u = outs[unsorted]
            if not (torch.equal(t_u[perm], r["t"])
                    and torch.equal(i_u[perm], r["tri"])):
                problems.append(f"K1 {name}: results differ from the "
                                "unsorted batch's")
        args = (feat, clusters, b["origin"], b["direction"], b["t_init"],
                b["active"], b["any_hit"], b["exclude"])

        def launch():
            mesh_brute.mesh_brute_kernel(*args)

        k_prof, records = kernel_ms(launch, 10)
        k_ev = cuda_ms(launch, 10)
        bound, by, share, counts = k1_bound(feat, clusters, b)
        timings[name] = dict(ms=k_ev, profiler_ms=k_prof, records=records,
                             plain_ms=r["twin_ms"], bound=bound, by=by,
                             share=share, win_flips=r["win_flips"],
                             occ_flips=r["occ_flips"], counters=counts)
        first = K1_FIRST_DESIGN_MS.get(name)
        log(f"  K1 {name}: N={b['origin'].shape[0]}, kernel {k_ev:.3f} ms "
            f"(CUDA events, 10 back-to-back launches), {k_prof:.3f} ms "
            f"(profiler device time over the {records} of 10 launches it "
            "recorded" + (f"; first design {first} ms" if first else "")
            + f"), twin "
            f"{r['twin_ms']:.3f} ms (profiler, all its kernels), bound "
            f"{bound:.4f} ms ({by}, kernel {k_ev / bound:.1f}x it), lane-slot "
            f"share {share:.1%}")

    timings["render"]["warps_shuffled_ms"] = {
        name: k1_warps_shuffled(feat, clusters, pops[name], outs[name],
                                problems)
        for name in ("render", "render sorted")}
    log("  K1 on the render batches with their warps in a random grid "
        "order (the same 32 lanes a warp; CUDA events, 10 launches): "
        + ", ".join(f"{k} {v:.3f} ms (in order {timings[k]['ms']:.3f})"
                    for k, v in timings["render"]["warps_shuffled_ms"].items()))

    # padding: 600 rays (not a multiple of any block)
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
    return worst, timings, sort_cost, pops


# ---------------------------------------------------------------------------
# phase 4: K2 against its twin
# ---------------------------------------------------------------------------

def k2_image(dev):
    """Phase 4's seeded 512^2 HDR image."""
    import torch
    rng = np.random.default_rng(42)
    return torch.from_numpy(rng.uniform(0.0, 3.0, (512, 512, 3))
                            .astype(np.float32)).to(dev)


def k2_times(tm, img, flush, reps=50):
    """K2's device time on ``img`` (vignette on, brightness 1), by the
    profiler: warm (back-to-back launches) and with the L2 flushed before
    each launch; and by CUDA events around back-to-back launches."""
    def kernel():
        return tm.tonemap(img)
    ms, n = kernel_ms(kernel, reps)
    flushed_ms, flushed_n = kernel_ms(kernel, reps, flush)
    if not n or not flushed_n:
        fail(f"K2: the profiler kept {n} and {flushed_n} of {reps} records")
    return dict(ms=ms, records=n, flushed_ms=flushed_ms,
                flushed_records=flushed_n, events_ms=cuda_ms(kernel, reps))


# bands of this many pixels (a multiple of 4, not of any side here) make
# phase 4's images launch in several bands that start inside rows
K2_SMALL_BAND = 4100
# an image with 3*H*W just above 2^31 - 1 (8.6 GB in, 8.6 GB out), and the
# rows of it held against the plain version
K2_HUGE_SIDE = 26755


def k2_banded(tm, cases):
    """Phase 4's images with BAND_PIXELS cut to K2_SMALL_BAND, so that each
    launches in bands starting mid-row, vignette on and off: NaN in the
    same channels as the plain version, the rest within K2_ATOL -> the
    worst difference."""
    saved, tm.BAND_PIXELS = tm.BAND_PIXELS, K2_SMALL_BAND
    worst, launches = 0.0, 0
    try:
        for name, x in cases.items():
            for vignette in (True, False):
                before = tm.tonemap_kernel.launches
                got = tm.tonemap(x, vignette=vignette, brightness=1.7)
                launches += tm.tonemap_kernel.launches - before
                want = tm.tonemap_plain(x, vignette=vignette, brightness=1.7)
                nan_diff, diff = k2_compare(got, want)
                worst = max(worst, diff)
                if nan_diff or diff > K2_ATOL:
                    fail(f"K2 {name} in bands of {K2_SMALL_BAND} pixels, "
                         f"vignette={vignette}: {nan_diff} channels NaN in "
                         f"only one, max abs diff {diff:.3g}")
    finally:
        tm.BAND_PIXELS = saved
    log(f"  K2 in bands of {K2_SMALL_BAND} pixels (every image above, "
        f"vignette on/off, {launches} launches): max abs diff {worst:.3g}, "
        "NaN in the same channels")
    return worst


def k2_huge(tm, dev):
    """K2 on a K2_HUGE_SIDE^2 image (3*H*W > 2^31 - 1: two bands), vignette
    off, rows at the ends and around the band boundary against the plain
    version of those rows -> the worst difference."""
    import torch
    h = w = K2_HUGE_SIDE
    gen = torch.Generator(device=dev).manual_seed(11)
    img = torch.rand((h, w, 3), generator=gen, device=dev).mul_(3.0)
    img[h // 2, :7] = torch.tensor(K2_EDGES[:7], device=dev)[:, None]
    before = tm.tonemap_kernel.launches
    out = tm.tonemap(img, vignette=False)
    launches = tm.tonemap_kernel.launches - before
    edge = tm.BAND_PIXELS // w
    rows = torch.tensor(sorted({0, 1, edge - 1, edge, edge + 1, h // 2,
                                h - 2, h - 1}), device=dev)
    nan_diff, diff = k2_compare(out[rows], tm.tonemap_plain(img[rows],
                                                            vignette=False))
    del img, out
    torch.cuda.empty_cache()
    log(f"  K2 {h}x{w} (3*H*W = {3 * h * w} > 2^31 - 1), vignette off: "
        f"{launches} launches, rows {rows.tolist()} against the plain "
        f"version: max abs diff {diff:.3g}, {nan_diff} channels NaN in only "
        "one")
    if nan_diff or diff > K2_ATOL or launches != len(tm.bands(h, w)):
        fail(f"K2 {h}x{w}: {nan_diff} NaN differences, max abs diff "
             f"{diff:.3g}, {launches} launches")
    return diff


def phase_k2(dev):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm

    log("[4] K2 tonemap.cu against its plain twin")
    img = k2_image(dev)
    base = torch.from_numpy(k2_edge_image(5, 33, 533)).to(dev)
    cases = {"512x512": img, "[5,33,3][1:], misaligned": base[1:]}
    for h, w in K2_EDGE_SIZES:
        cases[f"edge set {h}x{w}"] = torch.from_numpy(
            k2_edge_image(h, w, 100 * h + w)).to(dev)
    if base[1:].data_ptr() % 16 == 0:
        fail("K2: the misaligned view is 16-byte aligned")
    worst = 0.0
    for name, x in cases.items():
        case_worst, nans = 0.0, 0
        for vignette in (True, False):
            for brightness in (1.0, 1.7):
                got = tm.tonemap(x, vignette=vignette, brightness=brightness)
                want = tm.tonemap_plain(x, vignette=vignette,
                                        brightness=brightness)
                nan_diff, diff = k2_compare(got, want)
                case_worst = max(case_worst, diff)
                nans += int(torch.isnan(want).sum())
                if nan_diff or diff > K2_ATOL:
                    fail(f"K2 {name} vignette={vignette} brightness="
                         f"{brightness}: {nan_diff} channels NaN in only one "
                         f"of kernel and plain; max abs diff {diff:.3g} "
                         f"(limit {K2_ATOL})")
        worst = max(worst, case_worst)
        log(f"  K2 {name}, vignette on/off x brightness 1.0/1.7: max abs "
            f"diff {case_worst:.3g}, NaN in the same {nans} channels")
    worst = max(worst, k2_banded(tm, cases))
    worst = max(worst, k2_huge(tm, dev))
    flush = l2_flush(dev)
    t = k2_times(tm, img, flush)
    p_ms, p_n = device_ms(lambda: tm.tonemap_plain(img), 50)
    # 12 B read and 12 B written per pixel; ~25 FP32 operations per channel
    bound, by = bound_ms(img.numel() * 4 * 2, img.numel() * 25)
    log(f"  K2 512x512, device time: kernel {t['ms']:.4f} ms warm, "
        f"{t['flushed_ms']:.4f} ms with the L2 flushed (a record, over the "
        f"{t['records']} / {t['flushed_records']} of 50 launches the "
        f"profiler recorded), twin {p_ms:.4f} ms a call ({p_n} kernel "
        f"records over 50 calls), bound {bound:.5f} ms ({by}): "
        f"{bound / t['ms']:.2f} / {bound / t['flushed_ms']:.2f} of it; "
        f"back to back from Python: {t['events_ms']:.4f} ms per launch")
    timed_by = (f"ms: profiler device time, mean over the {t['records']} "
                "kernel records kept of 50 back-to-back launches (one kernel "
                "a call; the 3 MB in and out stay in the L2 between them); "
                f"ms_l2_flushed: the same over the {t['flushed_records']} "
                f"records kept of 50 launches, each after a "
                f"{L2_FLUSH_BYTES >> 20} MB fill whose records are left out "
                f"by name; plain_ms: profiler device time of all {p_n} kernel "
                "records of 50 calls, over 50")
    return dict(err=worst, ms=t["ms"], flushed_ms=t["flushed_ms"],
                plain_ms=p_ms, bound=bound, by=by, timed_by=timed_by)


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
    rel = abs(float(a.mean()) - REGEN_MEAN_RECORD) / REGEN_MEAN_RECORD
    log(f"  render {t_render:.3f} s (+tonemap {t_total - t_render:.4f} s), "
        f"{rate:.0f} samples/s, {iters} iterations "
        f"(every lane finished {spp} samples: the loop only exits then), "
        f"mean radiance {a.mean():.6f} (recorded {REGEN_MEAN_RECORD}, rel "
        f"{rel:.3g}), "
        f"launches {launches}, mesh_sort_rays {cfg.mesh_sort_rays}, on "
        f"{gpu_line}")
    if rel > REGEN_MEAN_REL:
        fail(f"slice: mean radiance {a.mean():.6f} is {rel:.3g} from the "
             f"recorded {REGEN_MEAN_RECORD}")
    log(f"  wrote {os.path.relpath(png, REPO)}")
    sort = regen_sort_on_off(cfg, scene, cam, w, h, spp, img)
    return launches, t_render, img, sort


def regen_sort_on_off(cfg, scene, cam, w, h, spp, img):
    """The regen frame with the loader's ray sort off and on (as loaded),
    in turns (off, on, on, off, twice): host seconds of each, and every
    image bitwise ``img``."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    secs = {True: [], False: []}
    for on in (False, True, True, False):
        c = dataclasses.replace(cfg, mesh_sort_rays=on)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, _ = pathtracer.render(c, scene, cam, w, h, spp, seed=0,
                                   method="regen")
        torch.cuda.synchronize()
        secs[on].append(time.perf_counter() - t0)
        if not torch.equal(got, img):
            fail(f"slice: the frame with the ray sort {'on' if on else 'off'} "
                 "differs from the first")
    on, off = (sum(secs[k]) / len(secs[k]) for k in (True, False))
    log(f"  the frame with the ray sort off / on, in turns, mean of "
        f"{len(secs[True])} each: {off:.3f} / "
        f"{on:.3f} s (every run {secs[False]} / {secs[True]}), images "
        "bitwise equal")
    return dict(on_s=on, off_s=off, on_runs=secs[True], off_runs=secs[False])


# ---------------------------------------------------------------------------
# phase 7: K3 against its plain version
# ---------------------------------------------------------------------------

# K3's timed sizes: a 512^2 frame's lanes (the flags compact_indices scans
# in this phase) and a 4096^2 frame's (134 MB moved, 0.040 ms of bytes:
# the size at which the byte bound means something)
K3_SIZES = (RAYS, 4096 * 4096)
K3_BLOCKS = (32, 64, 128, 256, 512, 1024)


def k3_flags(n, dev, density=0.5, seed=None):
    """[n] int32 0/1 flags, seeded by ``n`` unless given."""
    import torch
    rng = np.random.default_rng(n if seed is None else seed)
    return torch.from_numpy((rng.uniform(size=n) < density)
                            .astype(np.int32)).to(dev)


def k3_times(compaction, f, flush, block=1024, reps=200):
    """K3 on the flags ``f`` at ``block``, by the profiler, each reading in
    turns with a yardstick in one window: ``x.clone()`` of the flags (a
    copy of the same bytes) and the per-block ``torch.cumsum`` (the one
    PyTorch call that computes K3's function, to a subtraction); warm and
    with the L2 flushed before every call -> the times, records and bound."""
    import torch
    n = f.shape[0]

    def kernel():
        return compaction.block_scan_kernel(f, block)

    def per_block_cumsum():
        return torch.cumsum(f.view(-1, block), dim=1, dtype=torch.int32)

    out = dict(n=n, block=block)
    for key, fl in (("warm", None), ("flushed", flush)):
        k_ms, c_ms, k_n, c_n = turns_ms(kernel, "block_scan_kernel", f.clone,
                                        reps, fl)
        k2_ms, s_ms, k2_n, s_n = turns_ms(kernel, "block_scan_kernel",
                                          per_block_cumsum, reps, fl,
                                          per_call=True)
        out[key] = dict(ms=k_ms, clone_ms=c_ms, ms_beside_cumsum=k2_ms,
                        cumsum_ms=s_ms, records=[k_n, c_n, k2_n, s_n])
    # 4 B read and 4 B written per flag, 4 B per block total
    out["bound"], out["by"] = bound_ms(n * 8 + n // block * 4, 0)
    return out


def k3_log(t, label):
    w, f = t["warm"], t["flushed"]
    log(f"  K3 {label} N={t['n']}, block {t['block']} (profiler, in turns, "
        f"records {w['records']} / {f['records']}): warm {w['ms']:.5f} ms "
        f"against x.clone() {w['clone_ms']:.5f} ({w['ms'] / w['clone_ms']:.3f}x)"
        f", {w['ms_beside_cumsum']:.5f} against the per-block torch.cumsum "
        f"{w['cumsum_ms']:.5f} a call; L2 flushed {f['ms']:.5f} against "
        f"x.clone() {f['clone_ms']:.5f} ({f['ms'] / f['clone_ms']:.3f}x), "
        f"{f['ms_beside_cumsum']:.5f} against the per-block cumsum "
        f"{f['cumsum_ms']:.5f}; bound {t['bound']:.5f} ms ({t['by']}): "
        f"{t['bound'] / w['ms']:.2f} warm, {t['bound'] / f['ms']:.2f} flushed")


def phase_k3(dev):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import compaction

    log("[7] K3 block_scan.cu against its plain version")
    rng = np.random.default_rng(77)
    mismatches = 0
    cases = 0

    def check(f, block):
        nonlocal mismatches, cases
        s_p, t_p = compaction.block_scan_plain(f, block)
        s_k, t_k = compaction.block_scan(f, block)
        mismatches += int((s_k != s_p).sum()) + int((t_k != t_p).sum())
        cases += 1

    for block in K3_BLOCKS:
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
                mismatches += int((scan != want).sum()) + int(
                    int(total) != int(t_p.sum()))
                check(pad, block)
        # int32 wrap-around: values near 2^30 sum past 2^31 in every block
        big = torch.from_numpy(rng.integers(2**29, 2**30, 3 * block,
                                            dtype=np.int64).astype(np.int32))
        check(big.to(dev), block)
        # a view that does not start on a 16-byte boundary
        check(k3_flags(4 * block + 1, dev)[1:], block)
    alive = torch.from_numpy(rng.uniform(size=RAYS) < 0.5).to(dev)
    perm_c, n_c = compaction.compact_indices(alive.cpu())
    torch.cuda.synchronize()
    log(f"  {cases} cases (blocks {K3_BLOCKS}, N up to {RAYS}, densities "
        f"0-1, int32 wrap-around, a misaligned view): {mismatches} "
        "mismatches")
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

    flush = l2_flush(dev)
    f = alive.to(torch.int32)
    sizes = [k3_times(compaction, f, flush)]
    sizes += [k3_times(compaction, k3_flags(n, dev), flush)
              for n in K3_SIZES[1:]]
    for t in sizes:
        k3_log(t, "")
    t = sizes[0]
    p_ms, p_n = device_ms(lambda: compaction.block_scan_plain(f, 1024), 200)
    # the whole exclusive_prefix_sum call (K3, then the offsets added outside
    # the kernel) against a scan of the whole array, which is not K3's
    # function: both several kernels a call, timed a call
    eps_ms, _ = device_ms(lambda: compaction.exclusive_prefix_sum(f, 1024),
                          200)
    whole_ms, whole_n = device_ms(
        lambda: torch.cumsum(f, 0, dtype=torch.int32), 200)
    log(f"  K3 N={RAYS}: plain {p_ms:.4f} ms a call ({p_n} kernel records over "
        f"200 calls); the whole exclusive_prefix_sum {eps_ms:.4f} ms a call "
        f"against torch.cumsum of the whole array {whole_ms:.4f} ms a call "
        f"({whole_n} kernel records over 200 calls); compact_indices "
        f"launches {launches}")
    timed_by = ("ms: profiler device time, mean over the kernel records kept "
                "of 200 launches in turns with x.clone() of the flags in one "
                "window (plain_ms's clone_ms); ms_l2_flushed: the same, each "
                f"call after a {L2_FLUSH_BYTES >> 20} MB fill whose records "
                "are left out by name; library_ms: the per-block "
                "torch.cumsum(f.view(-1, block), dim=1) in turns with K3 in "
                "another window, all its records over its calls; plain_ms: "
                "profiler device time of all kernel records of 200 calls of "
                "block_scan_plain, over 200; exclusive_prefix_sum_ms and "
                "whole_array_cumsum_ms: the whole call against a scan of the "
                "whole array (not K3's function), the same way; by_size: "
                "every reading at each size")
    return dict(launches=launches, err=float(mismatches),
                ms=t["warm"]["ms"], flushed_ms=t["flushed"]["ms"],
                plain_ms=p_ms, library_ms=t["warm"]["cumsum_ms"],
                library_flushed_ms=t["flushed"]["cumsum_ms"],
                exclusive_prefix_sum_ms=eps_ms, whole_array_cumsum_ms=whole_ms,
                bound=t["bound"], by=t["by"], by_size=sizes, timed_by=timed_by)


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

    # profiled at 1 spp: the profiler takes ~50 s to summarise a 4-spp run
    fwd_bwd_profile(cfg, scene, cam, w, 1, seed,
                    pathtracer.calibrate_regen_iters(cfg, scene, cam, w, w, 1,
                                                     seed=seed))
    cvc = card_vs_cpu(dev)
    return dict(k1=k1, n_iters=n_iters, seconds=t_total, rate=rate,
                peak_gib=peak, card_vs_cpu=cvc)


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

    def recording(cfg_, scene_, shaded, **kw):
        out = real(cfg_, scene_, shaded, **kw)
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
    """fwd+bwd of cornell.json + a 320-triangle icosphere at 4 bounces,
    32^2 x 2 spp, on the card (K1) and on the CPU (K1's twin), every
    gradient compared.

    Every pixel's path is traced iteration by iteration on both devices
    (trace_regen, the same iterations regen_scan runs).  An ulp of
    difference between the two devices' float32 math can flip a discrete
    decision of a path (roulette, lobe choice, a near-tie between two
    hits), after which that pixel's later samples differ entirely.  Only
    pixels whose trace shows such a decision parting are left out (at most
    FLIP_PIXELS of them, each printed with where it parts); every other
    pixel must agree within the forward bound, and the gradients of the
    mean over them within the gradient bound: at 4 bounces
    tests/test_torch_grad.py's <= 4-bounce bound, or, for a leaf beyond it,
    no farther from the CPU than SPREAD_FACTOR x the JAX package's CPU
    gradient is from the port's on the same input (GRAD_SPREAD_4).  (Its
    legs at the scene's 32 bounces are tests/test_torch_cuda.py's
    test_fwd_bwd_on_card_matches_cpu.)"""
    problems = []
    out = {"4 bounces, seed 3": _cvc_leg(
        dev, 4, 3, FWD_SHALLOW, SHALLOW_GRAD_RTOL,
        lambda want: SHALLOW_GRAD_ATOL, problems, spread=GRAD_SPREAD_4)}
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

    w, spp, steps = 128, 4, 2
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

# ---------------------------------------------------------------------------
# phase 10: T1 against its plain version, and the K1 microbenchmark
# ---------------------------------------------------------------------------

T1_BLOCK = 128  # the relevance block of phase 3's comparison and the table
T1_BLOCKS = (128, 256)  # the blocks the reference's tool runs
# T1 and its plain version sum in other orders: the bound is this fraction
# of each ray's sum of absolute terms
T1_REL = 1e-5
# T1's FP32 operations per (ray, triangle) of a relevant tile: the four dot
# product chains 33 (den 5, t*den 6, u*den 11, v*den 11), three adds and
# the running sum 4
T1_PAIR_FLOPS = 37
# ... and its FP32 instructions (FFMA, FMUL, FADD: den 3, t*den 4, u*den 6,
# v*den 6, the adds 4), which issue at one warp instruction a clock a
# scheduler: half the FLOP rate, an FFMA being 2 FLOPs
T1_PAIR_INSTRUCTIONS = 23
FP32_INSTRUCTIONS_PER_S = FP32_FLOP_PER_S / 2


def sass_inner_loop(so_path, function):
    """Opcode counts of the inner loop of the kernel whose name holds
    ``function`` in the library ``so_path``, read with ``cuobjdump -sass``:
    among the innermost loops (a backward branch whose address range holds
    no other), the one with the most FFMA -> dict, or {"note": why not}."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"note": "no cuobjdump on this machine: the SASS is not read"}
    res = subprocess.run([tool, "-sass", so_path], capture_output=True,
                         text=True, timeout=300)
    if res.returncode != 0:
        return {"note": f"cuobjdump -sass failed ({res.returncode}): "
                        f"{res.stderr.strip()[:200]}"}
    body = next((part for part in res.stdout.split("Function : ")[1:]
                 if function in part.split("\n", 1)[0]), None)
    if body is None:
        return {"note": f"no function named {function} in the SASS"}
    ins = [(int(m.group(1), 16), m.group(2).split())
           for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    ops = [(a, t[1] if t[0].startswith("@") else t[0], t) for a, t in ins if t]
    loops = []
    for a, op, t in ops:
        target = re.match(r"0x([0-9a-f]+)$", t[-1]) if op == "BRA" else None
        if target and int(target.group(1), 16) <= a:
            loops.append((int(target.group(1), 16), a))
    inner = [lp for lp in loops if not any(
        o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
    if not inner:
        return {"note": "no loop found in the SASS"}

    def counts(lp):
        c = {}
        for a, op, _ in ops:
            if lp[0] <= a <= lp[1]:
                c[op] = c.get(op, 0) + 1
        return c

    best = max(inner, key=lambda lp: counts(lp).get("FFMA", 0))
    c = counts(best)
    fp32 = sum(v for k, v in c.items() if k.split(".")[0] in
               ("FFMA", "FMUL", "FADD"))
    return dict(loop=[hex(best[0]), hex(best[1])],
                instructions=sum(c.values()), fp32=fp32,
                ops=dict(sorted(c.items(), key=lambda kv: -kv[1])))


def t1_pairs(words, n, block):
    """(block, tile) and (ray, tile) pairs T1 adds (every ray of a block
    with a tile's bit set; words from relevance_words at ``block``), and
    the tiles of each block."""
    import torch
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w[..., None] >> torch.arange(32, device=w.device)) & 1
    per_block = bits.sum((1, 2))
    rays_in = torch.clamp(n - torch.arange(per_block.shape[0],
                                           device=w.device) * block,
                          max=block)
    return int(per_block.sum()), int((per_block * rays_in).sum()), per_block


def t1_time(mesh_brute, b, feat, clusters, block, reps=5):
    """T1 on phase 3's batch ``b`` at ``block``: CUDA events around
    ``reps`` back-to-back launches, with its bounds and the (min, mean,
    max) relevant tiles of a block -> dict."""
    o, d, t_init, act = b["origin"], b["direction"], b["t_init"], b["active"]
    n = o.shape[0]
    words = mesh_brute.relevance_words(clusters, o, d, t_init, act, block)
    pack = mesh_brute.matmul_only_pack(o, d, t_init)
    block_tiles, pairs, per_block = t1_pairs(words, n, block)

    def kernel():
        return mesh_brute.matmul_only_kernel(words, pack, feat, block)

    n_bytes = (words.numel() * 4 + pack.numel() * 4 + feat.numel() * 4
               + n * 8)
    flops = pairs * mesh_brute.TILE * T1_PAIR_FLOPS
    bound, by = bound_ms(n_bytes, flops)
    floor = (pairs * mesh_brute.TILE * T1_PAIR_INSTRUCTIONS
             / FP32_INSTRUCTIONS_PER_S * 1e3)
    return dict(block=block, ms=cuda_ms(kernel, reps), reps=reps,
                block_tiles=block_tiles, pairs=pairs, bound=bound, by=by,
                issue_floor=floor, gflop=flops / 1e9, mb=n_bytes / 1e6,
                tiles_per_block=[int(per_block.min()), float(per_block.float()
                                 .mean()), int(per_block.max())])


def phase_t1(dev, b, k1_ms):
    """T1 on the cornell_hi tables and phase 3's random population, against
    its plain version at both blocks; its work against K1's; its times at
    both blocks and its inner loop's SASS; then the K1 microbenchmark
    (tools/bench_kernel.py) driven as a user runs it."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.tools import bench_kernel

    log(f"[10] T1 matmul_only.cu against its plain version (blocks "
        f"{T1_BLOCKS}); the K1 microbenchmark")
    _, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                          models_dir=os.path.join(REPO, "scenes/assets"),
                          device=dev)
    feat, clusters = scene.bf_feat, scene.bf_clusters
    o, d, t_init, act = b["origin"], b["direction"], b["t_init"], b["active"]
    n = o.shape[0]
    pack = mesh_brute.matmul_only_pack(o, d, t_init)
    max_abs, rel = 0.0, 0.0
    for block in T1_BLOCKS:
        words = mesh_brute.relevance_words(clusters, o, d, t_init, act, block)
        t_k, i_k = mesh_brute.matmul_only_kernel(words, pack, feat, block)
        t_p, _ = mesh_brute.matmul_only_plain(words, pack, feat, block)
        scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(), feat.abs(),
                                                block)
        torch.cuda.synchronize()
        err = (t_k - t_p).abs()
        b_rel = float((err / scale.clamp(min=1e-30)).max())
        if bool(i_k.any()):
            fail(f"T1 block {block}: the index output is not all zero")
        if b_rel > T1_REL:
            fail(f"T1 block {block}: {b_rel:.3g} of the sum of absolute "
                 f"terms > {T1_REL}")
        max_abs, rel = max(max_abs, float(err.max())), max(rel, b_rel)
        log(f"  T1 vs plain, block {block}: {n} rays, max abs diff "
            f"{float(err.max()):.3g}, {b_rel:.3g} of the sum of absolute "
            f"terms (limit {T1_REL}); index output all zero")

    sass = sass_inner_loop(_cuda.LIBRARY._so_path(), "matmul_only_kernel")
    log(f"  T1 inner loop, SASS (cuobjdump -sass of the kernel library): "
        f"{json.dumps(sass)}")
    times = {blk: t1_time(mesh_brute, b, feat, clusters, blk)
             for blk in T1_BLOCKS}
    for t in times.values():
        log(f"  T1 block {t['block']}: {t['ms']:.3f} ms (CUDA events, "
            f"{t['reps']} launches back to back); {t['block_tiles']} (block, "
            f"tile) pairs = {t['pairs']} (ray, tile) pairs, relevant tiles a "
            f"block min / mean / max {t['tiles_per_block']}; FLOP bound "
            f"{t['bound']:.4f} ms ({t['by']}: {t['gflop']:.2f} GFLOP, "
            f"{t['mb']:.1f} MB), {t['bound'] / t['ms']:.2f} of it; issue "
            f"floor {t['issue_floor']:.4f} ms, {t['issue_floor'] / t['ms']:.2f} "
            "of it")
    t = times[T1_BLOCK]

    # the work: T1 adds every (ray, tile) pair of a block whose bit is set;
    # K1 tests only the pairs its per-thread slab test lets through
    k1_warps, k1_pairs, k1_slabs, _, _ = k1_counters(feat, clusters, b)
    words = mesh_brute.relevance_words(clusters, o, d, t_init, act, T1_BLOCK)

    def kernel():
        return mesh_brute.matmul_only_kernel(words, pack, feat, T1_BLOCK)

    def relevance():
        return mesh_brute.relevance_words(clusters, o, d, t_init, act,
                                          T1_BLOCK)

    # the profiler keeps only some records of long kernels on the H100
    # (kernel_ms): T1 is timed by CUDA events (t1_time)
    t_prof, t_n = kernel_ms(kernel, 5)
    p_ms, p_n = device_ms(lambda: mesh_brute.matmul_only_plain(
        words, pack, feat, T1_BLOCK), 1)
    r_ms, _ = device_ms(relevance, 3)
    log(f"  work: T1 {t['pairs']} (ray, tile) pairs from the bits at block "
        f"{T1_BLOCK}; K1 {k1_warps} (warp, tile) pairs processed, {k1_pairs} "
        f"(ray, tile) pairs tested, {k1_slabs} slab tests (T1 adds "
        f"{t['pairs'] / max(k1_pairs, 1):.1f}x the pairs K1 tests)")
    log(f"  T1 block {T1_BLOCK}: {t['ms']:.3f} ms (the profiler's device time "
        f"{t_prof:.3f} ms over the {t_n} of 5 launches it recorded), "
        f"{t['ms'] / k1_ms:.2f}x K1's {k1_ms:.3f} ms on this batch (phase 3): "
        f"K1 / T1 {k1_ms / t['ms']:.3f}; device time: plain {p_ms:.3f} ms, "
        f"relevance pass {r_ms:.3f} ms")

    # the microbenchmark as a user runs it, with the counts set to 0 first
    mesh_brute.matmul_only_kernel.launches = 0
    mesh_brute.mesh_brute_kernel.launches = 0
    bench = bench_kernel.run(RAYS, block=T1_BLOCK, reps=10)
    launches = mesh_brute.matmul_only_kernel.launches
    k1_launches = mesh_brute.mesh_brute_kernel.launches
    if launches == 0 or k1_launches == 0:
        fail(f"bench_kernel: T1 launched {launches}, K1 {k1_launches} times")
    log(f"  bench_kernel ({bench['rays']} rays, CUDA events over "
        f"{bench['reps']} launches): K1 {bench['k1_ms']:.3f} ms, T1 "
        f"{bench['t1_ms']:.3f} ms ({bench['t1_ms'] / bench['k1_ms']:.1%} of "
        f"K1; K1 / T1 {bench['k1_ms'] / bench['t1_ms']:.3f}, first design "
        f"{K1_T1_FIRST_DESIGN}), relevance pass {bench['relevance_ms']:.3f} "
        "ms; "
        f"{bench['block_tiles']} (block, tile) pairs; launches T1 {launches}, "
        f"K1 {k1_launches}")
    timed_by = (f"ms: CUDA events around 5 back-to-back launches at block "
                f"{T1_BLOCK} (the profiler kept {t_n} of 5 kernel records); "
                "ms_by_block: the same at each block; plain_ms: profiler "
                f"device time of all {p_n} kernel records of one call")
    return dict(launches=launches, k1_launches=k1_launches, err=max_abs,
                rel=rel, ms=t["ms"], plain_ms=p_ms, relevance_ms=r_ms,
                bound=t["bound"], by=t["by"], issue_floor=t["issue_floor"],
                by_block={str(k): v for k, v in times.items()}, sass=sass,
                bench=bench, k1_over_t1=k1_ms / t["ms"], timed_by=timed_by)


# ---------------------------------------------------------------------------
# phase 11: T2a and T2b against x.clone(), and the barrier probe
# ---------------------------------------------------------------------------

def turns_ms(kernel, match, other, reps, flush=None, per_call=False):
    """Device ms a call of ``kernel`` (one kernel) and of ``other``, run in
    turns (other, kernel, kernel, other, ...) inside one torch.profiler
    window, each call after ``flush()`` where given: the device time of
    kernels whose name holds ``match`` is ``kernel``'s, ``flush()``'s
    records are left out by name, the rest is ``other``'s -> (kernel ms,
    other ms, and the records the profiler kept of each).  Each is a mean
    over the records kept (one kernel a call), or, for ``other`` with
    ``per_call``, all its records' time over its calls (a call of several
    kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    skip = record_names(flush) if flush else set()
    kernel(), other()  # warm-up
    torch.cuda.synchronize()
    for attempt in range(PROFILER_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps // 2):
                for fn in (other, kernel, kernel, other):
                    if flush:
                        flush()
                    fn()
            torch.cuda.synchronize()
        time, count = {True: 0.0, False: 0.0}, {True: 0, False: 0}
        for e in prof.key_averages():
            if e.self_device_time_total > 0 and e.key not in skip:
                time[match in e.key] += e.self_device_time_total
                count[match in e.key] += e.count
        if count[True] and count[False]:
            break
        log(f"  turns_ms: the profiler kept {count[True]} records named "
            f"'{match}' and {count[False]} others (window {attempt + 1} of "
            f"{PROFILER_ATTEMPTS})")
    if not count[True] or not count[False]:
        fail(f"turns_ms: the profiler kept {count[True]} records named "
             f"'{match}' and {count[False]} others")
    # a mean over the records the profiler kept (see kernel_ms)
    other_n = 2 * (reps // 2) if per_call else count[False]
    return (time[True] / count[True] / 1e3, time[False] / other_n / 1e3,
            count[True], count[False])


def t2_inputs(dev):
    """Phase 11's input: the barrier probe's 262,144 x 3 floats, and T2b's
    flat view of them."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import passthrough as pt
    x = torch.from_numpy(np.random.default_rng(31).normal(
        size=(RAYS, 3)).astype(np.float32)).to(dev)
    return (("T2a", pt.passthrough, x),
            ("T2b", pt.passthrough_flat, x.reshape(-1)))


def t2_times(fn, arg, flush, reps=200):
    """``fn(arg)`` (a kernel named passthrough) against ``arg.clone()`` in
    turns, warm and with the L2 flushed before every call -> the times and
    records of each."""
    out = {}
    for key, fl in (("warm", None), ("flushed", flush)):
        k_ms, c_ms, k_n, c_n = turns_ms(lambda: fn(arg), "passthrough",
                                        arg.clone, reps, fl)
        out[key] = dict(ms=k_ms, clone_ms=c_ms, records=[k_n, c_n])
    return out


def phase_t2(dev):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import passthrough as pt
    from photorealistic_rendering_using_opencl_tpu_torch.tools import barrier_test

    log("[11] T2a / T2b passthrough.cu against x.clone(); the barrier probe")
    flush = l2_flush(dev)
    out = {}
    inputs = t2_inputs(dev)
    for name, fn, arg in inputs:
        y = fn(arg)
        torch.cuda.synchronize()
        same = torch.equal(y.view(torch.int32), arg.clone().view(torch.int32))
        if not same:
            fail(f"{name}: the copy is not bitwise equal to its input")
        # the plain version and the library call are the same call
        t = t2_times(fn, arg, flush)
        w, f = t["warm"], t["flushed"]
        bound, by = bound_ms(arg.numel() * 4 * 2, 0)
        timed_by = ("ms, plain_ms and library_ms: profiler device time in one "
                    "window, the kernel and x.clone() called 200 times each "
                    "in turns, the mean over the records kept of each "
                    f"({w['records'][0]} and {w['records'][1]}); each call is "
                    "one kernel (x.clone(): one device-to-device copy); "
                    "ms_l2_flushed and library_ms_l2_flushed: the same in "
                    f"another window, each call after a {L2_FLUSH_BYTES >> 20}"
                    " MB fill whose records are left out by name (records "
                    f"kept: {f['records'][0]} and {f['records'][1]})")
        out[name] = dict(err=0.0, ms=w["ms"], plain_ms=w["clone_ms"],
                         library_ms=w["clone_ms"], flushed_ms=f["ms"],
                         library_flushed_ms=f["clone_ms"], bound=bound, by=by,
                         timed_by=timed_by)
        log(f"  {name} {tuple(arg.shape)}: bitwise equal; device time in one "
            f"profiler window, in turns, kernel against x.clone() (plain "
            f"version and library call): warm {w['ms']:.5f} against "
            f"{w['clone_ms']:.5f} ms, {w['ms'] / w['clone_ms']:.3f}x; L2 "
            f"flushed before each call {f['ms']:.5f} against "
            f"{f['clone_ms']:.5f} ms, {f['ms'] / f['clone_ms']:.3f}x (records "
            f"kept {w['records']}, {f['records']} of 200 each); bound "
            f"{bound:.5f} ms ({by})")
    # T2a on a ragged N (3N % 4 = 1) at each float offset modulo 16 bytes
    flat, n = inputs[1][2], RAYS - 1
    for offset in range(4):
        v = flat[offset:offset + 3 * n].view(n, 3)
        if not torch.equal(pt.passthrough(v).view(torch.int32),
                           v.clone().view(torch.int32)):
            fail(f"T2a: [{n}, 3] at float offset {offset}: not bitwise equal")
    log(f"  T2a [{n}, 3] (3N % 4 = 1) at float offsets 0-3: bitwise equal")

    # the probe as a user runs it, with the counts set to 0 first
    pt.passthrough_kernel.launches = 0
    pt.passthrough_flat_kernel.launches = 0
    r = barrier_test.run(RAYS, reps=10, rounds=3)
    out["T2a"]["launches"] = pt.passthrough_kernel.launches
    out["T2b"]["launches"] = pt.passthrough_flat_kernel.launches
    if not out["T2a"]["launches"] or not out["T2b"]["launches"]:
        fail("barrier probe: T2a or T2b never launched")
    if any(v != 0.0 for v in r["max_diff"].values()):
        fail(f"barrier probe: a form changed bounce_step's result "
             f"{r['max_diff']}")
    log(f"  barrier probe, bounce_step on cornell_simple at {r['rays']} lanes, "
        f"median of {r['rounds']} rounds x {r['reps']} steps (CUDA events): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in r["ms"].items())
        + "; extra over the baseline: "
        + ", ".join(f"{k} {v:+.3f} ms" for k, v in r["extra_ms"].items())
        + f"; every round {json.dumps(r['all_ms'])}; launches T2a "
        f"{out['T2a']['launches']}, T2b {out['T2b']['launches']}")
    out["probe"] = r
    return out


# ---------------------------------------------------------------------------
# phase 12: scan and while forward at size
# ---------------------------------------------------------------------------

def phase_scan_while(dev, gpu_line, regen_img, t_regen, spp=8):
    """cornell_hi 512^2 x spp through render(method="scan" | "while"),
    tonemapped to PNG, each pixel held against phase 6's regen image (the
    same estimator: only the order of each pixel's sums differs)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.ops._cuda import BUILD_DIR
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import write_png

    w = h = FRAME
    log(f"[12] scan and while forward: cornell_hi.json {w}x{h} x {spp} spp, "
        "seed 0, under torch.no_grad(), against phase 6's regen image")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    cam = default_camera(w, h).pytree(dev)
    n_steps = integrator.n_steps_for(cfg)
    want = regen_img.cpu().numpy()
    out = {}
    for method in ("scan", "while"):
        mesh_brute.mesh_brute_kernel.launches = 0
        tm.tonemap_kernel.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            img, _ = pathtracer.render(cfg, scene, cam, w, h, spp, seed=0,
                                       method=method)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ldr = tm.tonemap(img)
        torch.cuda.synchronize()
        k1, k2 = (mesh_brute.mesh_brute_kernel.launches,
                  tm.tonemap_kernel.launches)
        png = os.path.join(BUILD_DIR, f"chip_smoke_cornell_hi_{method}.png")
        write_png(png, ldr.cpu().numpy())
        a = img.cpu().numpy()
        if a.shape != (h, w, 3) or not np.isfinite(a).all():
            fail(f"{method}: image of shape {a.shape} is not all finite")
        diff = np.abs(a - want)
        beyond = diff > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(want)
        if method == "scan" and k1 != spp * (n_steps + 1):
            fail(f"scan: K1 launches {k1} != spp x (n_steps + 1) = "
                 f"{spp * (n_steps + 1)}")
        if method == "while" and not 0 < k1 <= spp * (n_steps + 1):
            fail(f"while: K1 launches {k1}")
        if beyond.any():
            fail(f"{method}: {int(beyond.any(-1).sum())} pixels differ from "
                 f"regen beyond rtol {GOLDEN_RTOL} atol {GOLDEN_ATOL} (max "
                 f"{diff.max():.3g})")
        out[method] = dict(seconds=secs, k1=k1, k2=k2,
                           max_diff=float(diff.max()))
        log(f"  {method}: {secs:.3f} s ({w * h * spp / secs:.0f} samples/s; "
            f"regen {t_regen:.3f} s), K1 launches {k1} (spp x (n_steps + 1) "
            f"= {spp * (n_steps + 1)}), K2 {k2}, mean radiance {a.mean():.6f}, "
            f"max |{method} - regen| {diff.max():.3g}, wrote "
            f"{os.path.relpath(png, REPO)}, on {gpu_line}")
    return out


# ---------------------------------------------------------------------------
# phase 13: scan fwd+bwd at size
# ---------------------------------------------------------------------------

def phase_scan_fwd_bwd(dev, gpu_line, spp=4, seed=3):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    w = FRAME
    log(f"[13] scan fwd+bwd: cornell_hi.json {w}x{w} x {spp} spp, seed {seed}, "
        "value-and-grad of mean(image) through render's default method over "
        "every float leaf + camera")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    cam = default_camera(w, w).pytree(dev)
    n_steps = integrator.n_steps_for(cfg)
    mesh_brute.mesh_brute_kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sc, camg, params = _grad_leaves(scene, cam)
    img, _ = pathtracer.render(cfg, sc, camg, w, w, spp, seed=seed)
    loss = img.mean()
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    k1_fwd = mesh_brute.mesh_brute_kernel.launches
    leaves = [*params.values(), *camg.values()]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    torch.cuda.synchronize()
    t_total = time.perf_counter() - t0
    k1_bwd = mesh_brute.mesh_brute_kernel.launches - k1_fwd
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(img).all()) or img.shape != (w, w, 3):
        fail(f"scan fwd+bwd: image of shape {tuple(img.shape)} is not all "
             "finite")
    names = [f"scene.{k}" for k in params] + [f"camera.{k}" for k in camg]
    bad = [k for k, g in zip(names, grads)
           if g is not None and not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"scan fwd+bwd: non-finite gradients in {bad}")
    by_name = dict(zip(names, grads))
    for k in ("scene.color", "scene.obj_color", "camera.position"):
        g = by_name[k]
        if g is None or float(g.abs().max()) == 0.0:
            fail(f"scan fwd+bwd: the gradient of {k} is zero")
    if k1_fwd != spp * (n_steps + 1) or k1_bwd != 0:
        fail(f"scan fwd+bwd: K1 launches forward {k1_fwd} (want "
             f"{spp * (n_steps + 1)}), backward {k1_bwd} (want 0)")
    rate = w * w * spp / t_total
    log(f"  fwd+bwd {t_total:.3f} s (forward {t_fwd:.3f} s, backward "
        f"{t_total - t_fwd:.3f} s), {rate:.0f} samples/s, {spp * n_steps} "
        f"checkpointed bounces, K1 launches forward {k1_fwd}, backward "
        f"{k1_bwd}, loss {float(loss.detach()):.6f}, peak memory {peak:.2f} "
        f"GiB, on {gpu_line}")
    log("  |grad| max: " + ", ".join(
        f"{k} {float(g.abs().max()):.3g}" for k, g in zip(names, grads)
        if g is not None))
    return dict(k1=k1_fwd, k1_bwd=k1_bwd, seconds=t_total, fwd_s=t_fwd,
                rate=rate, peak_gib=peak)


# ---------------------------------------------------------------------------
# phase 14: goldens through render's default method
# ---------------------------------------------------------------------------

GOLDENS_DEFAULT = dict(
    GOLDENS,
    multi_light_pick=dict(scene="scenes/multilight_pick.json", spp=8),
    alpha_test=dict(scene="scenes/cornell_simple.json", spp=8, alpha=True),
    coat_grazing=dict(scene="scenes/coat_grazing.json", spp=8),
    materials=dict(scene="scenes/materials.json", spp=4))
# card against CPU: pixels allowed to differ by more than the goldens'
# bound (a path decision an ulp flipped, or ulps grown through deep glass
# paths); the share of pixels tests/test_torch_goldens.py allows to miss
GOLDEN_PARTED = 0.07


def phase_goldens_default(dev):
    """Each golden config rendered by render's default method (scan) on the
    card and, but for the 81,920-triangle cornell_hi_bvh, on the CPU.  A
    pixel of the card may miss the golden only where the port's CPU render
    misses it too (tests/test_torch_goldens.py: only where the JAX
    package's own un-jitted render misses it) or where the card's float
    path leaves the CPU's by more than 1e-5; and at most GOLDEN_PARTED of
    the pixels may differ between card and CPU by more than the goldens'
    own bound (a path decision flipped by an ulp)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    log("[14] goldens through render's default method (scan), on the card "
        "and on the CPU")
    mesh_brute.mesh_brute_kernel.launches = 0
    cpu = torch.device("cpu")
    for name, c in GOLDENS_DEFAULT.items():
        mesh = make_icosphere(**c["mesh"]) if "mesh" in c else None
        devices = {"card": dev, "cpu": cpu}
        if name == "cornell_hi_bvh":
            del devices["cpu"]
        imgs = {}
        for label, d in devices.items():
            cfg, scene = load_scene(os.path.join(REPO, c["scene"]),
                                    models_dir=os.path.join(REPO, "scenes/assets"),
                                    mesh_override=mesh,
                                    alpha_testing=c.get("alpha", False),
                                    device=d)
            cam = default_camera(GOLDEN_SIZE, GOLDEN_SIZE).pytree(d)
            img, alpha = pathtracer.render(cfg, scene, cam, GOLDEN_SIZE,
                                           GOLDEN_SIZE, c["spp"],
                                           seed=GOLDEN_SEED)
            imgs[label] = (img.detach().cpu().numpy(),
                           alpha.detach().cpu().numpy())
        with np.load(os.path.join(REPO, "tests/golden", f"{name}.npz")) as z:
            ref, ref_alpha = z["img"], z["alpha"]
        img, alpha = imgs["card"]
        if not np.isfinite(img).all():
            fail(f"golden {name} (default method): non-finite pixels")
        rel_mean = abs(float(img.mean()) - float(ref.mean())) / float(ref.mean())
        if name == "cornell_hi_bvh":
            log(f"  {name}: mean {img.mean():.6f} vs golden {ref.mean():.6f} "
                f"(rel {rel_mean:.3g})")
            if rel_mean > HI_MEAN_REL:
                fail(f"golden {name} (default method): mean off by "
                     f"{rel_mean:.3g}")
            continue

        def beyond(a, b):
            return (np.abs(a - b) > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(b)).any(-1)

        cpu_img = imgs["cpu"][0]
        card_out = beyond(img, ref)
        cpu_out = beyond(cpu_img, ref)
        parted = beyond(img, cpu_img)
        near = (np.abs(img - cpu_img) > 1e-5 * (1 + np.abs(cpu_img))).any(-1)
        stray = card_out & ~cpu_out & ~near
        log(f"  {name}: {int(card_out.sum())} of {card_out.size} pixels beyond "
            f"the golden's rtol {GOLDEN_RTOL} atol {GOLDEN_ATOL} on the card, "
            f"{int(cpu_out.sum())} on the CPU; card vs CPU: {int(parted.sum())} "
            f"pixels beyond that bound ({int(near.sum())} beyond 1e-5, max "
            f"{np.abs(img - cpu_img).max():.3g}); unexplained "
            f"{int(stray.sum())}; mean rel {rel_mean:.3g}")
        if stray.any() or parted.mean() > GOLDEN_PARTED:
            fail(f"golden {name} (default method): {int(stray.sum())} pixels "
                 f"beyond the golden where the CPU is not and the card is "
                 f"within 1e-5 of it, {int(parted.sum())} beyond the golden's "
                 "bound from the CPU")
        if not np.allclose(alpha, ref_alpha, rtol=GOLDEN_RTOL,
                           atol=GOLDEN_ATOL):
            fail(f"golden {name} (default method): alpha off")
    return mesh_brute.mesh_brute_kernel.launches


# ---------------------------------------------------------------------------
# phase 15: every BSDF family at size
# ---------------------------------------------------------------------------

def phase_materials(dev, gpu_line, spp=8):
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.ops._cuda import BUILD_DIR
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import write_png

    w = FRAME
    log(f"[15] materials.json (every BSDF family) {w}x{w} x {spp} spp through "
        "scan, under torch.no_grad()")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/materials.json"),
                            device=dev)
    cam = default_camera(w, w).pytree(dev)
    tm.tonemap_kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        img, _ = pathtracer.render(cfg, scene, cam, w, w, spp, seed=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ldr = tm.tonemap(img)
    png = os.path.join(BUILD_DIR, "chip_smoke_materials.png")
    write_png(png, ldr.cpu().numpy())
    a = img.cpu().numpy()
    if a.shape != (w, w, 3) or not np.isfinite(a).all():
        fail(f"materials: image of shape {a.shape} is not all finite")
    log(f"  {secs:.3f} s ({w * w * spp / secs:.0f} samples/s), mean radiance "
        f"{a.mean():.6f}, active materials {cfg.active_mats:#x}, wrote "
        f"{os.path.relpath(png, REPO)}, on {gpu_line}")
    return tm.tonemap_kernel.launches


# ---------------------------------------------------------------------------
# phase 16: the command-line renderer at size
# ---------------------------------------------------------------------------

# the CLI's default resolution; its default 64 spp is cut to CLI_SPP, then
# resumed to CLI_RESUME_SPP, to fit the script's time
CLI_SIDE = 1024
CLI_SPP, CLI_RESUME_SPP, CLI_INTERVAL = 8, 12, 4
CLI_SCENE = "scenes/cornell_hi.json"
# the AOVs' centre crop that the CPU renders too (mesh_id, traversal)
CLI_CROP = 64
# the straight run's mesh dispatch whose merged batch K1 is held on against
# its twin: the first sample's first bounce (next closest rays and the
# primary hits' shadow rays)
CLI_K1_CALL = 2
# the samplers: words on a grid, card against CPU; cornell_simple frames
# with each scheme, timed in turns at SCHEME_SIDE^2, held against the CPU
# at SCHEME_CHECK_SIDE^2
SCHEME_WORDS = 65536
SCHEME_SIDE, SCHEME_SPP, SCHEME_CHECK_SIDE = 512, 2, 48
# a scheme's mean radiance against pcg4d's at SCHEME_SIDE^2 x SCHEME_SPP:
# the same estimator with other random numbers
SCHEME_MEAN_REL = 0.05
_REPORT = re.compile(r"(\d+)x(\d+) @ (\d+) spp in ([\d.]+)s -> "
                     r"([\d.]+)M pixel-samples/s")


def run_cli(args, stdin=None, env=None):
    """``python -m <the port> args`` from the checkout's root, as a user
    runs it -> (stdout, wall seconds); fails on a non-zero exit."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", PKG, *args], cwd=REPO,
                         capture_output=True, text=True, timeout=900,
                         input=stdin, env=dict(os.environ, **(env or {})))
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"CLI {' '.join(args)} exited {res.returncode}:\n"
             f"{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    return res.stdout, secs


def cli_report(out: str, spp: int) -> dict:
    """The CLI's closing report line -> its seconds (printed to 0.01 s; its
    clock ends in torch.cuda.synchronize()) and the samples/s they give."""
    m = _REPORT.search(out)
    if m is None or int(m.group(3)) != spp:
        fail(f"CLI: no report of {spp} spp in its output:\n{out[-2000:]}")
    w, h, secs = int(m.group(1)), int(m.group(2)), float(m.group(4))
    return dict(seconds=secs, samples_per_s=w * h * spp / secs)


def app_main(app, args):
    """``app.main(args)`` in this process, from the checkout's root, its
    output captured -> (exit code, output, seconds to its return)."""
    import contextlib
    import io

    import torch
    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.chdir(REPO), contextlib.redirect_stdout(buf):
        rc = app.main(args)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def phase_cli(dev, gpu_line):
    """The CLI at the size a user runs it: a batch render with checkpoints
    (a subprocess), two resumes, the same render in this process with the
    kernels counted, the five AOVs, HDR export, the interactive viewer; then
    the threefry and mwc samplers on the card."""
    import shutil
    import tempfile

    from photorealistic_rendering_using_opencl_tpu_torch.ops._cuda import BUILD_DIR
    from photorealistic_rendering_using_opencl_tpu_torch.runtime.camera import (
        InteractiveCamera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    side = CLI_SIDE
    size = ["-scene", CLI_SCENE, "-width", str(side), "-height", str(side)]
    log(f"[16] the CLI: {CLI_SCENE} {side}x{side} (its default size), "
        f"{CLI_SPP} spp with a checkpoint every {CLI_INTERVAL}, resumed to "
        f"{CLI_SPP} and {CLI_RESUME_SPP}, seed 0, on {gpu_line}")
    tmp = tempfile.mkdtemp(prefix="prt_cli_")
    try:
        res = _cli_batch(dev, size, tmp)
        cfg, scene = load_scene(os.path.join(REPO, CLI_SCENE),
                                models_dir=os.path.join(REPO, "scenes/assets"),
                                device=dev)
        cam = InteractiveCamera(resolution=(side, side)).build_render_camera()
        _cli_straight(cfg, scene, cam.pytree(dev), res)
        res["k1_err"] = _cli_k1(cfg, scene, res.pop("k1_batch"))
        res["aov"] = _cli_aovs(dev, size, tmp, cfg, scene, cam)
        res["hdr"] = _cli_hdr(size, tmp, res["resumed_state"])
        res["interactive"] = _cli_interactive(size, tmp)
        res["profile"] = _cli_profile(size, tmp)
        shutil.copy(os.path.join(tmp, "cli.png"),
                    os.path.join(BUILD_DIR, "chip_smoke_cli.png"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del res["resumed_state"]
    res["schemes"] = _schemes(dev, gpu_line)
    return res


def _cli_batch(dev, size, tmp):
    """The batch render as a user runs it, its two resumes, and the same
    24-spp render through app.main here, with K1, K2 and the bounces
    counted."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    from photorealistic_rendering_using_opencl_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import read_png
    ck, png = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "cli.png")
    out, wall = run_cli(size + ["-spp", str(CLI_SPP), "--checkpoint", ck,
                                "--checkpoint-interval", str(CLI_INTERVAL),
                                "-o", png])
    first = cli_report(out, CLI_SPP)
    state, _, _ = load_checkpoint(ck, device=dev)
    image = read_png(png)
    if int(state.samples) != CLI_SPP or image.shape != (CLI_SIDE, CLI_SIDE, 3):
        fail(f"CLI: checkpoint at {int(state.samples)} samples, PNG "
             f"{image.shape}")
    log(f"  CLI {CLI_SPP} spp: {first['seconds']} s in its report, "
        f"{first['samples_per_s']:.0f} samples/s, {wall:.2f} s with the "
        "process's start, load and export")

    out, wall_16 = run_cli(size + ["-spp", str(CLI_SPP), "--checkpoint", ck,
                                   "-o", png])
    if f"resumed {ck} at {CLI_SPP} samples" not in out:
        fail(f"CLI: the resume at its target did not say so:\n{out[-1000:]}")
    if not np.array_equal(read_png(png), image):
        fail("CLI: the resume at its target exported another image")
    out, wall_24 = run_cli(size + ["-spp", str(CLI_RESUME_SPP),
                                   "--checkpoint", ck, "-o", png])
    if f"resumed {ck} at {CLI_SPP} samples" not in out:
        fail(f"CLI: the resume to {CLI_RESUME_SPP} did not resume")
    resumed = cli_report(out, CLI_RESUME_SPP)
    # the report counts every sample of the state, the clock only the
    # samples this run added
    resumed["samples_per_s"] = (CLI_SIDE ** 2 * (CLI_RESUME_SPP - CLI_SPP)
                                / resumed["seconds"])
    resumed_state, _, _ = load_checkpoint(ck, device=dev)
    log(f"  resumed at {CLI_SPP} (re-export only): {wall_16:.2f} s; resumed "
        f"to {CLI_RESUME_SPP}: {resumed['seconds']} s in its report for the "
        f"{CLI_RESUME_SPP - CLI_SPP} samples it added "
        f"({resumed['samples_per_s']:.0f} samples/s), {wall_24:.2f} s with "
        "the process")

    # the straight render in this process, the kernels counted
    bounces = [0]
    real_shade = integrator._trace_shade

    def counted_shade(*a, **k):
        bounces[0] += 1
        return real_shade(*a, **k)

    real_closest = intersect.mesh_closest
    calls = []

    def recorded_closest(cfg_, scene_, origin, direction, t_init,
                         any_hit=False, active=None, exclude_tri=None):
        calls.append(None)
        if len(calls) == CLI_K1_CALL:
            calls[-1] = k1_batch(origin.clone(), direction.clone(), t_init,
                                 any_hit, active, exclude_tri)
        return real_closest(cfg_, scene_, origin, direction, t_init,
                            any_hit=any_hit, active=active,
                            exclude_tri=exclude_tri)

    ck_d, png_d = os.path.join(tmp, "straight.npz"), os.path.join(tmp, "d.png")
    integrator._trace_shade = counted_shade
    intersect.mesh_closest = recorded_closest
    try:
        mesh_brute.mesh_brute_kernel.launches = 0
        tm.tonemap_kernel.launches = 0
        rc, out, wall_d = app_main(app, size + [
            "-spp", str(CLI_RESUME_SPP), "--checkpoint", ck_d, "-o", png_d])
        k1, k2 = (mesh_brute.mesh_brute_kernel.launches,
                  tm.tonemap_kernel.launches)
    finally:
        integrator._trace_shade = real_shade
        intersect.mesh_closest = real_closest
    if rc != 0:
        fail(f"app.main exited {rc}")
    straight = cli_report(out, CLI_RESUME_SPP)
    if k1 != bounces[0] + CLI_RESUME_SPP or bounces[0] < CLI_RESUME_SPP:
        fail(f"app.main: K1 launches {k1} != bounces run {bounces[0]} + one "
             f"camera dispatch a sample ({CLI_RESUME_SPP})")
    if k2 != 1:
        fail(f"app.main: K2 launches {k2} != 1 (the export)")
    straight_state, _, _ = load_checkpoint(ck_d, device=dev)
    for f in ("acc", "alpha", "samples", "seed"):
        if not torch.equal(getattr(resumed_state, f),
                           getattr(straight_state, f)):
            fail(f"CLI: the resumed {CLI_RESUME_SPP}-spp state's {f} is not "
                 "bitwise the straight run's")
    log(f"  app.main {CLI_RESUME_SPP} spp straight: {straight['seconds']} s "
        f"in its report ({straight['samples_per_s']:.0f} samples/s), "
        f"{wall_d:.2f} s to its return; K1 {k1} = {bounces[0]} bounces + "
        f"{CLI_RESUME_SPP} camera dispatches, K2 {k2}; the resumed "
        f"{CLI_RESUME_SPP}-spp state bitwise the straight one")
    if len(calls) < CLI_K1_CALL:
        fail(f"app.main made {len(calls)} mesh dispatches")
    return dict(first=first, first_wall_s=wall, resume_16_wall_s=wall_16,
                resumed=resumed, resume_24_wall_s=wall_24, straight=straight,
                straight_wall_s=wall_d, k1=k1, k2=k2, bounces=bounces[0],
                resumed_state=resumed_state, straight_state=straight_state,
                k1_batch=calls[CLI_K1_CALL - 1])


def _cli_straight(cfg, scene, cam, res):
    """render(method="while") at the straight run's spp and seed: its
    progressive image must be bitwise this."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        want, want_a = pathtracer.render(cfg, scene, cam, CLI_SIDE, CLI_SIDE,
                                         CLI_RESUME_SPP, seed=0,
                                         method="while")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    img, alpha = pathtracer.progressive_image(res["straight_state"])
    del res["straight_state"]
    if not (torch.equal(img, want) and torch.equal(alpha, want_a)):
        fail("app.main: the image is not bitwise render(method='while')")
    a = want.cpu().numpy()
    if not np.isfinite(a).all():
        fail("CLI: NaN or Inf in the image")
    res["render_while_s"] = secs
    res["mean_radiance"] = float(a.mean())
    res["k2_err"] = cli_k2("export", img)
    log(f"  render(method='while') {CLI_RESUME_SPP} spp: {secs:.3f} s "
        f"({CLI_SIDE ** 2 * CLI_RESUME_SPP / secs:.0f} samples/s), bitwise "
        f"the CLI's image, mean radiance {a.mean():.6f}")


def cli_k2(name, img):
    """K2 on an image the CLI exports against its plain version: NaN in the
    same channels, the rest within K2_ATOL -> the max abs difference.  A
    comparison, outside the paths' counts."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    nan_diff, diff = k2_compare(tm.tonemap(img), tm.tonemap_plain(img))
    if nan_diff or diff > K2_ATOL:
        fail(f"K2 on the CLI's {name} image {tuple(img.shape)}: {nan_diff} "
             f"channels NaN in only one of kernel and plain; max abs diff "
             f"{diff:.3g} (limit {K2_ATOL})")
    log(f"  K2 on the CLI's {name} image {tuple(img.shape)}: max abs diff "
        f"{diff:.3g} from the plain version, NaN in the same "
        f"{int(torch.isnan(img).sum())} channels")
    return diff


def _cli_k1(cfg, scene, batch):
    """K1 on the merged batch of the straight run's CLI_K1_CALL-th mesh
    dispatch, as its wrapper received it (sorted by the scene's ray sort),
    against its twin within phase 3's flip and t limits -> the worst t
    error.  A comparison, outside the paths' counts."""
    problems = []
    sort = cfg.mesh_sort_rays
    b = k1_sorted(batch, scene.bf_clusters)[0] if sort else batch
    r = k1_compare(f"CLI dispatch {CLI_K1_CALL} "
                   f"({'sorted, ' if sort else ''}as launched)",
                   scene.bf_feat, scene.bf_clusters, scene.bf_tri_verts, b,
                   problems)
    if problems:
        fail("; ".join(problems))
    return r["err"]


def _cli_aovs(dev, size, tmp, cfg, scene, cam):
    """The five --aov modes through app.main, K1 and K2 counted; mesh_id
    and the traversal counts bitwise the CPU's on a centre crop."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import read_png
    k1 = k2 = 0
    secs = {}
    for mode in pathtracer.AOV_MODES:
        png = os.path.join(tmp, f"aov_{mode}.png")
        mesh_brute.mesh_brute_kernel.launches = 0
        tm.tonemap_kernel.launches = 0
        rc, _, secs[mode] = app_main(app, size + ["--aov", mode, "-o", png])
        n1, n2 = (mesh_brute.mesh_brute_kernel.launches,
                  tm.tonemap_kernel.launches)
        if rc != 0 or read_png(png).shape != (CLI_SIDE, CLI_SIDE, 3):
            fail(f"--aov {mode}: exit {rc}")
        if n1 != (0 if mode == "traversal" else 1) or n2 != 1:
            fail(f"--aov {mode}: K1 {n1}, K2 {n2} launches")
        k1, k2 = k1 + n1, k2 + n2

    side, c = CLI_SIDE, CLI_CROP
    y0 = x0 = (side - c) // 2
    cam_d = cam.pytree(dev)
    with torch.no_grad():
        imgs = {m: pathtracer.render_aov(cfg, scene, cam_d, side, side, m)
                for m in pathtracer.AOV_MODES}
        k2_err = max(cli_k2(f"--aov {m}", x) for m, x in imgs.items())
        mesh_img, trav_img = imgs["mesh_id"], imgs["traversal"]
        px, py = pathtracer.pixel_grid(side, side, dev)
        o, d = pathtracer.camera_rays_for_sample(
            cam_d, side, side, px, py, py * side + px, 0, 0, jitter=False)
        counts = intersect.traversal_cost(cfg, scene, o, d)
        h = counts.to(torch.float32) / torch.clamp(
            counts.max().to(torch.float32), min=1.0)
        if not torch.equal(trav_img, torch.stack(
                [h, 1.0 - h, torch.zeros_like(h)], -1).reshape(side, side, 3)):
            fail("traversal AOV is not the frame's normalised tile counts")

        cfg_c, scene_c = load_scene(os.path.join(REPO, CLI_SCENE),
                                    models_dir=os.path.join(REPO, "scenes/assets"),
                                    device="cpu")
        ys, xs = torch.meshgrid(torch.arange(y0, y0 + c),
                                torch.arange(x0, x0 + c), indexing="ij")
        pxc, pyc = xs.reshape(-1), ys.reshape(-1)
        oc, dc = pathtracer.camera_rays_for_sample(
            cam.pytree("cpu"), side, side, pxc, pyc, pyc * side + pxc, 0, 0,
            jitter=False)
        hit = intersect.intersect_scene(cfg_c, scene_c, oc, dc)
        mesh_cpu = torch.where(
            hit.valid, (hit.mesh_id.to(torch.float32) + 1.0)
            / (cfg_c.n_objects + 2), 0.0)
        counts_cpu = intersect.traversal_cost(cfg_c, scene_c, oc, dc)
    mesh_card = mesh_img[y0:y0 + c, x0:x0 + c, 0].cpu().reshape(-1)
    counts_card = counts.reshape(side, side)[y0:y0 + c, x0:x0 + c].cpu()
    if not torch.equal(mesh_card, mesh_cpu):
        fail(f"mesh_id AOV: {int((mesh_card != mesh_cpu).sum())} of {c * c} "
             "crop pixels differ from the CPU's")
    if not torch.equal(counts_card.reshape(-1), counts_cpu):
        fail("traversal counts differ from the CPU's on the crop")
    mesh_val = float(cfg.n_objects + 1) / float(cfg.n_objects + 2)
    on_mesh = int((hit.mesh_id == cfg.n_objects).sum())
    if on_mesh == 0 or int(counts_cpu.max()) == 0:
        fail("the AOV crop misses the mesh")
    log(f"  --aov {', '.join(pathtracer.AOV_MODES)} through app.main: "
        + ", ".join(f"{m} {s:.3f} s" for m, s in secs.items())
        + f" to each return; K1 {k1}, K2 {k2}; on the {c}x{c} centre crop "
        f"({on_mesh} pixels on the mesh, id value {mesh_val:.6f}) mesh_id and "
        f"the tile counts (max {int(counts_cpu.max())}, frame max "
        f"{int(counts.max())}) bitwise the CPU's")
    return dict(seconds=secs, k1=k1, k2=k2, crop_on_mesh=on_mesh,
                k2_err=k2_err)


def _cli_hdr(size, tmp, resumed_state):
    """-encoder 1 on the finished checkpoint: the linear image read back
    within RGBE's rounding, no kernel launched."""
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import read_hdr
    mesh_brute.mesh_brute_kernel.launches = 0
    tm.tonemap_kernel.launches = 0
    rc, out, secs = app_main(app, size + [
        "-spp", str(CLI_RESUME_SPP), "--checkpoint",
        os.path.join(tmp, "ck.npz"), "-encoder", "1", "-o",
        os.path.join(tmp, "cli.png")])
    path = os.path.join(tmp, "cli.hdr")
    if rc != 0 or "resumed" not in out or not os.path.exists(path):
        fail(f"-encoder 1: exit {rc}, output {out[-500:]}")
    launched = (mesh_brute.mesh_brute_kernel.launches,
                tm.tonemap_kernel.launches)
    if launched != (0, 0):
        fail(f"-encoder 1 at the target launched K1/K2 {launched}")
    img = pathtracer.progressive_image(resumed_state)[0].cpu().numpy()
    back = read_hdr(path)
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    step = np.ldexp(1.0, np.frexp(img.max(axis=2))[1] - 8)[..., None]
    err = np.abs(back - img)
    if back.shape != img.shape or (err > step).any():
        fail(f"-encoder 1: {int((err > step).any(-1).sum())} pixels beyond "
             "RGBE's rounding")
    rel = float((err / step).max())
    log(f"  -encoder 1 (resumed at its target): {secs:.3f} s; read_hdr within "
        f"{rel:.3f} of a mantissa step of the image")
    return dict(seconds=secs, max_err_in_steps=rel)


def _cli_interactive(size, tmp):
    """The viewer as a user drives it: piped commands, the preview forced
    on (ANSI half-blocks, so K2 runs for each preview frame)."""
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import read_png
    png = os.path.join(tmp, "viewer.png")
    out, wall = run_cli(size + ["--interactive", "--preview", "-o", png],
                        stdin="orbit 10 5\np\nq\n",
                        env={"PRT_TERM_GRAPHICS": "ansi"})
    if (out.count(f"saved {png}") != 2 or "\x1b[38;2;" not in out
            or read_png(png).shape != (CLI_SIDE, CLI_SIDE, 3)):
        fail(f"interactive viewer: output {out[-800:]!r}")
    frames = out.count("spp] >")
    log(f"  interactive viewer (orbit 10 5, p, q): {wall:.2f} s with the "
        f"process, {frames} preview frames, 2 exports")
    return dict(wall_s=wall, preview_frames=frames)


def _cli_profile(size, tmp):
    """--profile DIR on one sample: the torch.profiler trace holds K1's
    records; the card's idle share over the traced loop (kernel time
    against the trace's span; records the profiler dropped read as idle)."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    trace_dir = os.path.join(tmp, "prof")
    mesh_brute.mesh_brute_kernel.launches = 0
    rc, _, secs = app_main(app, size + ["-spp", "1", "--profile", trace_dir,
                                        "-o", os.path.join(tmp, "p.png")])
    launched = mesh_brute.mesh_brute_kernel.launches
    path = os.path.join(trace_dir, "trace.json")
    if rc != 0 or not os.path.exists(path):
        fail(f"--profile: exit {rc}, no {path}")
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = sum("mesh_brute_kernel" in e["name"] for e in kernels)
    if not kernels or k1 == 0:
        fail(f"--profile: {len(kernels)} kernel records, {k1} of K1")
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events))
    busy = sum(e["dur"] for e in kernels)
    idle = 1.0 - busy / span
    log(f"  --profile, 1 spp: {secs:.2f} s to the return; the trace holds "
        f"{len(kernels)} kernel records ({k1} of K1's {launched} launches), "
        f"{busy / 1e3:.1f} ms busy in a {span / 1e3:.1f} ms span: idle share "
        f"{idle:.3f}")
    return dict(seconds=secs, kernel_records=len(kernels), k1_records=k1,
                k1_launches=launched, busy_ms=busy / 1e3, span_ms=span / 1e3,
                idle_share=idle)


def _schemes(dev, gpu_line):
    """threefry and mwc on the card: words and streams bitwise the CPU's;
    cornell_simple frames by each scheme against pcg4d (times in turns, the
    profiler's device share) and against the CPU."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import rng
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    r = np.random.default_rng(16)
    w = r.integers(0, 2 ** 32, (SCHEME_WORDS, 4), dtype=np.uint64)
    edges = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                     np.uint64)
    e = np.stack(np.meshgrid(edges, edges, indexing="ij"), -1).reshape(-1, 2)
    w[:len(e), :2] = e
    w[len(e):2 * len(e), 2:] = e
    cols = [torch.from_numpy(w[:, i].astype(np.int64)) for i in range(4)]
    card = [x.to(dev) for x in cols]
    words = list(rng.threefry2x32(*cols)) + [rng.mwc_hash(cols[0], cols[1])]
    words_d = list(rng.threefry2x32(*card)) + [rng.mwc_hash(card[0], card[1])]
    for a, b in zip(words, words_d):
        if not torch.equal(a, b.cpu()):
            fail("threefry2x32 / mwc_hash words differ between card and CPU")
    draws = 0
    for scheme in ("threefry", "mwc"):
        for seed in (0, 12345, 0xFFFFFFFF):
            dim = torch.from_numpy((w[:, 2] % 2 ** 30 * 4).astype(np.int64))
            s_c = rng.Sampler(cols[0], cols[1], seed=seed, scheme=scheme,
                              dim=dim)
            s_d = rng.Sampler(card[0], card[1], seed=seed, scheme=scheme,
                              dim=dim.to(dev))
            for _ in range(6):
                if s_c.next1d().numpy().tobytes() != s_d.next1d().cpu().numpy().tobytes():
                    fail(f"Sampler({scheme!r}, seed {seed}): card and CPU "
                         "draws differ")
                draws += 1

    path = os.path.join(REPO, "scenes/cornell_simple.json")
    cfg, scene = load_scene(path, device=dev)
    cfg_c, scene_c = load_scene(path, device="cpu")
    side, spp = SCHEME_SIDE, SCHEME_SPP
    cam = default_camera(side, side).pytree(dev)
    small = SCHEME_CHECK_SIDE
    cam_s, cam_sc = (default_camera(small, small).pytree(x) for x in (dev, "cpu"))
    secs = {s: [] for s in rng.SCHEMES}
    means, out = {}, {}

    def frame(scheme):
        with torch.no_grad():
            return pathtracer.render(cfg, scene, cam, side, side, spp, seed=0,
                                     rng_scheme=scheme, method="while")[0]

    for scheme in rng.SCHEMES:  # warm-up, and the card against the CPU
        frame(scheme)
        with torch.no_grad():
            a = pathtracer.render(cfg, scene, cam_s, small, small, spp, seed=0,
                                  rng_scheme=scheme, method="while")[0]
            b = pathtracer.render(cfg_c, scene_c, cam_sc, small, small, spp,
                                  seed=0, rng_scheme=scheme, method="while")[0]
        diff = float((a.cpu() - b).abs().max())
        if diff > FWD_SHALLOW:
            fail(f"{scheme}: card {small}^2 frame {diff:.3g} from the CPU's")
        out[scheme] = dict(card_vs_cpu=diff)
    for scheme in ("pcg4d", "threefry", "mwc", "mwc", "threefry", "pcg4d"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img = frame(scheme)
        torch.cuda.synchronize()
        secs[scheme].append(time.perf_counter() - t0)
        a = img.cpu().numpy()
        if not np.isfinite(a).all():
            fail(f"{scheme}: NaN or Inf in the frame")
        means[scheme] = float(a.mean())
    for scheme in rng.SCHEMES:
        rel = abs(means[scheme] - means["pcg4d"]) / means["pcg4d"]
        if rel > SCHEME_MEAN_REL:
            fail(f"{scheme}: mean radiance {means[scheme]:.6f} is {rel:.3g} "
                 f"from pcg4d's {means['pcg4d']:.6f}")
        dev_ms, kernels = device_ms(lambda: frame(scheme), 1)
        wall = sum(secs[scheme]) / len(secs[scheme])
        out[scheme].update(seconds=secs[scheme], mean_s=wall,
                           mean_radiance=means[scheme], device_ms=dev_ms,
                           kernels=kernels,
                           idle_share=1.0 - dev_ms / 1e3 / wall)
    log(f"  samplers: threefry2x32 / mwc_hash words ({SCHEME_WORDS} x 4 "
        f"with 2^32-1 edges) and {draws} Sampler draws of each, card bitwise "
        "the CPU's; cornell_simple "
        f"{small}^2 x {spp} card vs CPU: "
        + ", ".join(f"{s} {out[s]['card_vs_cpu']:.3g}" for s in rng.SCHEMES))
    for s in rng.SCHEMES:
        o = out[s]
        log(f"  {s}: cornell_simple {side}^2 x {spp} spp (while) "
            f"{o['mean_s']:.3f} s mean of {o['seconds']} in turns "
            f"({o['mean_s'] / out['pcg4d']['mean_s']:.2f}x pcg4d), device "
            f"{o['device_ms']:.1f} ms in {o['kernels']} kernels, idle share "
            f"{o['idle_share']:.3f}, mean radiance {o['mean_radiance']:.6f}, "
            f"on {gpu_line}")
    return out


# ---------------------------------------------------------------------------
# --op-census: which operations give the card and the CPU other bits
# ---------------------------------------------------------------------------

# tests/test_torch_cuda.py::test_progressive_on_card_matches_cpu's frame
CENSUS_SCENE, CENSUS_W, CENSUS_H, CENSUS_STEPS = "scenes/cornell_simple.json", 32, 24, 3
CENSUS_SEED = 0xFFFFFFF0
CENSUS_SCHEMES = ("pcg4d", "threefry", "mwc")
# what the census finds on an H100 (torch 2.11, CUDA 12.8): the ATen ops
# whose card results differ from the CPU's on bitwise-equal inputs in that
# frame.  sin, cos, tan and sqrt are 1 ulp apart; the card divides by a
# Python number as a product with its reciprocal (camera_rays' pixel
# coordinates); a 3-term sum (math.dot) adds in another order.  With these
# on the CPU, the card's progressive sum is bitwise the CPU's
# (tests/test_torch_cuda.py holds that).
CARD_OTHER_BITS_OPS = ("aten.cos.default", "aten.div.Tensor",
                       "aten.sin.default", "aten.sqrt.default",
                       "aten.sum.dim_IntList", "aten.tan.default")


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_flatten
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _ulps(a, b):
    """Float32 values between a and b, elementwise (int64)."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return (ordered(a) - ordered(b)).abs()


def op_record(run):
    """``run()`` with every ATen call recorded -> (its result, [(op, digest
    of its inputs, its tensor outputs on the CPU, the innermost line of the
    port that made it)]).  Devices are left out of the digest, so a call
    has the same digest on both devices exactly when its inputs are bitwise
    equal."""
    import hashlib

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    calls = []

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            h = hashlib.sha1()
            for x in tree_flatten((args, kwargs))[0]:
                if isinstance(x, torch.Tensor):
                    t = x.detach().cpu().contiguous()
                    h.update(f"{t.dtype}{tuple(t.shape)}".encode())
                    h.update(t.numpy().tobytes())
                elif not isinstance(x, torch.device):
                    h.update(repr(x).encode())
            out = func(*args, **kwargs)
            where, f = "?", sys._getframe()
            while f is not None:
                if f"{os.sep}{PKG}{os.sep}" in f.f_code.co_filename:
                    where = (f"{os.path.relpath(f.f_code.co_filename, REPO)}"
                             f":{f.f_lineno}")
                    break
                f = f.f_back
            calls.append((str(func), h.hexdigest(),
                          [t.detach().cpu().clone() for t in _tensors(out)],
                          where))
            return out

    with Recorder():
        result = run()
    return result, calls


def ops_on_cpu(run, ops):
    """``run()`` with every call of an ATen op in ``ops`` evaluated on the
    CPU, its results moved back to its inputs' device (the moves bypass
    any mode beneath, such as op_record's)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
    from torch.utils._pytree import tree_map

    def move(tree, d):
        with _disable_current_modes():
            return tree_map(lambda x: x.to(d) if isinstance(x, torch.Tensor)
                            else x, tree)

    class OnCpu(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if str(func) not in ops:
                return func(*args, **kwargs)
            if func._schema.is_mutable:
                fail(f"--op-census: {func} writes its inputs")
            dev = _tensors((args, kwargs))[0].device
            a, k = move((args, kwargs), "cpu")
            return move(func(*a, **k), dev)

    with OnCpu():
        return run()


def census_run(dev, scheme):
    """tests/test_torch_cuda.py's progressive frame on ``dev`` -> a closure
    returning the state after CENSUS_STEPS steps."""
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    cfg, sc = load_scene(os.path.join(REPO, CENSUS_SCENE), device=dev)
    cam = default_camera(CENSUS_W, CENSUS_H).pytree(dev)

    def run():
        st = pathtracer.progressive_init(CENSUS_W, CENSUS_H, seed=CENSUS_SEED,
                                         device=dev)
        for _ in range(CENSUS_STEPS):
            st = pathtracer.progressive_step(cfg, sc, cam, st,
                                             rng_scheme=scheme)
        return st
    return run


def _census_sources(rec_d, rec_c):
    """Two op records -> (calls aligned (the same op at the same place),
    {op: its calls, those with equal inputs, of those the ones with other
    bits, their worst ulps and the lines that made them}, the first such
    call)."""
    from collections import Counter, defaultdict

    import torch
    aligned = min(len(rec_d), len(rec_c))
    for i in range(aligned):
        if rec_d[i][0] != rec_c[i][0]:
            aligned = i
            break
    stats = defaultdict(lambda: dict(calls=0, equal_inputs=0, other_bits=0,
                                     max_ulps=0, lines=Counter()))
    first = None
    for i in range(aligned):
        (op, dig_d, o_d, _), (_, dig_c, o_c, where) = rec_d[i], rec_c[i]
        r = stats[op]
        r["calls"] += 1
        if dig_d != dig_c:
            continue
        r["equal_inputs"] += 1
        if all(torch.equal(a, b) for a, b in zip(o_d, o_c)):
            continue
        r["other_bits"] += 1
        r["lines"][where] += 1
        for a, b in zip(o_d, o_c):
            if a.dtype == torch.float32 and a.shape == b.shape:
                r["max_ulps"] = max(r["max_ulps"], int(_ulps(a, b).max()))
        if first is None:
            first = (i, op, where)
    return aligned, {op: dict(r, lines=dict(r["lines"].most_common(4)))
                     for op, r in stats.items() if r["other_bits"]}, first


def op_census(dev, cpu="cpu", rounds=6):
    """For each sampler: the progressive frame of
    tests/test_torch_cuda.py::test_progressive_on_card_matches_cpu on the
    card and on the CPU with every ATen call recorded.  The two runs make
    the same calls in the same order; a call whose inputs are bitwise equal
    on both devices and whose outputs are not is a source of the
    difference.  Once the first sources part the runs, later ops rarely see
    equal inputs, so the card's run is repeated with every source found so
    far evaluated on the CPU (ops_on_cpu), until its sum is bitwise the
    CPU's (the sources found are the whole cause) or a round finds none."""
    import torch
    out = {}
    for scheme in CENSUS_SCHEMES:
        run_d = census_run(dev, scheme)
        st_c, rec_c = op_record(census_run(torch.device(cpu), scheme))
        pinned, history = set(), []
        for rnd in range(rounds):
            st_d, rec_d = op_record(lambda: ops_on_cpu(run_d, pinned))
            diff = (st_d.acc.cpu() - st_c.acc).abs()
            rel = diff / st_c.acc.abs().clamp(min=1e-30)
            worst = int(torch.argmax(diff.amax(-1)))
            bitwise = torch.equal(st_d.acc.cpu(), st_c.acc)
            aligned, sources, first = _census_sources(rec_d, rec_c)
            log(f"  {scheme}, round {rnd} (on the CPU: "
                f"{sorted(pinned) or 'none'}): {len(rec_d)} / {len(rec_c)} "
                f"ATen calls (card / CPU), {aligned} aligned; 3-sample sum "
                f"max abs diff {float(diff.max()):.3g} (rel "
                f"{float(rel.max()):.3g}) at pixel ({worst % CENSUS_W}, "
                f"{worst // CENSUS_W}), {int((rel > 1e-5).any(-1).sum())} "
                f"pixels past rel 1e-5; image max abs diff "
                f"{float(diff.max()) / CENSUS_STEPS:.3g}"
                + (" (bitwise the CPU's)" if bitwise else
                   f"; first call with equal inputs and other bits: {first}"))
            for op, r in sorted(sources.items(),
                                key=lambda kv: -kv[1]["other_bits"]):
                log(f"    {op}: {r['calls']} calls, {r['equal_inputs']} with "
                    f"equal inputs, {r['other_bits']} of them with other "
                    f"bits (max {r['max_ulps']} ulps) at {r['lines']}")
            history.append(dict(on_cpu=sorted(pinned),
                                sum_max_abs=float(diff.max()),
                                sum_max_rel=float(rel.max()),
                                worst_pixel=worst, bitwise=bitwise,
                                calls=[len(rec_d), len(rec_c)],
                                aligned=aligned, first=first, sources=sources))
            if bitwise or not set(sources) - pinned:
                break
            pinned |= set(sources)
        out[scheme] = history
    return out


# ---------------------------------------------------------------------------
# phases 17-20: SDFs + mesh, participating media, env-lit thin lens
# (BASELINE configs 3-5), and their goldens
# ---------------------------------------------------------------------------

HI_MESH = "scenes/assets/icosphere_hi.obj"  # 81,920 triangles
# the CPU legs of the card-vs-CPU holds take this icosphere instead (K1's
# twin on the CPU), at CVC8_SIDE^2
CVC8_MESH = dict(subdiv=3, radius=0.6, center=(0.0, 1.0, 0.0))
CVC8_SIDE = 64
# BASELINE config 4's exponential variant: the height fog of
# tests/golden_tool.py's exponential_fog
MEDIUM_EXP = {"type": "exponential", "density": 0.4, "sigmaA": 0.1,
              "sigmaS": 0.6}
# config 5: the equirect map's size (made from the seed) and the frame
ENV_H, ENV_W, ENV_SEED = 1024, 2048, 5
ENV_SIDE, ENV_CLI_SPP, ENV_FB_SPP = 1024, 16, 4
THIN_LENS = dict(aperture_radius=0.05, focal_distance=4.0)
# an SDF normal is a central difference at 2e-5: an ulp of the card's
# camera rays or sampled directions (sin, cos, tan, sqrt are 1 ulp from the
# CPU's) is ~1e-3 of a normal after an SDF bounce.  Card against CPU on
# sdf_demo is therefore held on identical rays at one bounce (FWD_SHALLOW)
# and on the image mean at the scene's depth:
SDF_DEEP_MEAN_REL = 2e-3
# card vs CPU on the medium and env paths (at 4 bounces): pixels whose
# traced path takes another decision, left out, at most this share
PATH_FLIP_PIXELS = 0.03
# materials.json (path C): refraction and Fresnel at grazing angles magnify
# an ulp of a direction, as on phase 14's materials golden: parted pixels
# up to GOLDEN_PARTED, the kept ones (measured 4e-4 apart on an H100)
# within
FWD_MATERIALS = 1e-3
# ... and the other pixels' bound in a medium: up to 16 scatter events a
# surface, and volumetric NEE from scatter points next to the sphere light,
# whose cone (cos = sqrt(1 - r^2 / d^2) as d -> r) magnifies an ulp of the
# point; the kept pixels measured 5.9e-4 apart on an H100
FWD_MEDIUM = 2e-3
# the four goldens of this slice (tests/golden_tool.py's configs); the SDF
# and medium ones are held on the mean, as cornell_hi_bvh is (the goldens
# are XLA's FMA-contracted renders: tests/test_torch_goldens.py)
GOLDENS_SLICE8 = {
    "sdf_demo": dict(scene="scenes/sdf_demo.json", spp=4),
    "cornell_media": dict(scene="scenes/cornell_media.json", spp=4),
    "envmap": dict(scene="scenes/cornell_simple.json", spp=4, env=True),
    "exponential_fog": dict(scene="scenes/cornell_simple.json", spp=4,
                            medium=MEDIUM_EXP),
}
# path A's regen forward: the mesh dispatch whose merged batch K1 is held
# on against its twin
SDF_K1_CALL = 6


def _hi_mesh():
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import load_obj
    return load_obj(os.path.join(REPO, HI_MESH))


def _doc(path, bounces=None, medium=None):
    with open(os.path.join(REPO, path)) as fh:
        doc = json.load(fh)
    if bounces is not None:
        doc["settings"]["MAX_BOUNCES"] = bounces
    if medium is not None:
        doc["global_medium"] = medium
    return doc


def golden_env_map():
    """tests/golden_tool.py's 16 x 8 gradient map."""
    u = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    gx, gy = np.meshgrid(u, u[:8], indexing="xy")
    return np.stack([gx, gy, np.full((8, 16), 0.5, np.float32)],
                    axis=-1).astype(np.float32)


def seeded_env_map(h=ENV_H, w=ENV_W, seed=ENV_SEED):
    """An equirect HDR sky from the seed: a smooth gradient, noise, and a
    small bright sun (what importance sampling is for)."""
    rng = np.random.default_rng(seed)
    v = (np.arange(h, dtype=np.float32) + 0.5)[:, None] / h
    u = (np.arange(w, dtype=np.float32) + 0.5)[None, :] / w
    sky = np.stack([0.4 + 0.3 * (1 - v) + 0 * u, 0.5 + 0.3 * (1 - v) + 0 * u,
                    0.9 - 0.2 * v + 0 * u], axis=-1)
    sky = sky * (0.8 + 0.4 * rng.random((h, w, 1)))
    sy, sx = int(0.22 * h), int(0.3 * w)
    sky[sy - 4:sy + 4, sx - 8:sx + 8] = 200.0
    return sky.astype(np.float32)


def reset_counts():
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    mesh_brute.mesh_brute_kernel.launches = 0
    tm.tonemap_kernel.launches = 0
    intersect.sdf_march.calls = 0
    intersect.sdf_march.steps = 0


def read_counts():
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    return dict(K1=mesh_brute.mesh_brute_kernel.launches,
                K2=tm.tonemap_kernel.launches,
                sdf_marches=intersect.sdf_march.calls,
                sdf_march_steps=intersect.sdf_march.steps)


def idle_share(fn):
    """``fn()`` once under torch.profiler (CUDA activity): its kernels'
    summed device time against the wall -> (idle share, kernels, busy ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows) / 1e6
    return 1.0 - busy / wall, sum(r[0] for r in rows), busy * 1e3


def path_forward(label, cfg, scene, cam, w, spp, method, gpu_line,
                 profile=False):
    """One forward frame, counted and timed (host clock to a sync),
    tonemapped to a PNG in _build/ (K2); with ``profile``, the same frame at
    1 spp profiled for the idle share."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.ops._cuda import BUILD_DIR
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import write_png
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        img, _ = pathtracer.render(cfg, scene, cam, w, w, spp, seed=0,
                                   method=method)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ldr = tm.tonemap(img)
    counts = read_counts()
    os.makedirs(BUILD_DIR, exist_ok=True)
    write_png(os.path.join(BUILD_DIR, "chip_smoke_" + re.sub(
        r"\W+", "_", label).strip("_") + ".png"), ldr.cpu().numpy())
    a = img.cpu().numpy()
    if a.shape != (w, w, 3) or not np.isfinite(a).all():
        fail(f"{label}: image of shape {a.shape} is not all finite")
    if counts["K2"] != 1:
        fail(f"{label}: K2 launched {counts['K2']} times, not once")
    if cfg.has_mesh and counts["K1"] == 0:
        fail(f"{label}: K1 never launched")
    if cfg.n_sdfs and counts["sdf_marches"] == 0:
        fail(f"{label}: no SDF march")

    out = dict(seconds=secs, samples_per_s=w * w * spp / secs,
               mean_radiance=float(a.mean()), **counts)
    note = ""
    if profile:
        def one():
            with torch.no_grad():
                pathtracer.render(cfg, scene, cam, w, w, 1, seed=0,
                                  method=method)

        idle, kernels, busy = idle_share(one)
        out.update(idle_share_1spp=idle, kernels_1spp=kernels,
                   busy_ms_1spp=busy)
        note = (f"; 1 spp profiled: {kernels} kernels, {busy:.1f} ms busy, "
                f"idle share {idle:.3f}")
    log(f"  {label}: {w}^2 x {spp} spp by {method}: {secs:.3f} s, "
        f"{out['samples_per_s']:.0f} samples/s, mean radiance "
        f"{a.mean():.6f}; K1 {counts['K1']}, K2 {counts['K2']}, SDF marches "
        f"{counts['sdf_marches']} ({counts['sdf_march_steps']} steps){note}; "
        f"on {gpu_line}")
    return img, out


def path_fwd_bwd(label, cfg, scene, cam, w, spp, leaves, gpu_line, seed=3,
                 required=None):
    """value-and-grad of mean(image) through regen_scan over ``leaves``
    (scene leaves by name, ``camera.*`` for the camera's): calibrated,
    every pixel complete, finite gradients, those of ``required`` (all
    ``leaves`` by default) non-zero; seconds, peak memory and counts."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    n_iters = pathtracer.calibrate_regen_iters(cfg, scene, cam, w, w, spp,
                                               seed=seed)
    sc_leaves = {k: getattr(scene, k).detach().clone().requires_grad_()
                 for k in leaves if not k.startswith("camera.")}
    cam_leaves = {k: v.detach().clone().requires_grad_() for k, v in cam.items()
                  if f"camera.{k}" in leaves}
    camg = dict(cam, **cam_leaves)
    sc = dataclasses.replace(scene, **sc_leaves)
    params = list(sc_leaves.values()) + list(cam_leaves.values())
    names = list(sc_leaves) + [f"camera.{k}" for k in cam_leaves]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    img, _ = pathtracer.render(cfg, sc, camg, w, w, spp, seed=seed,
                               method="regen_scan", regen_iters=n_iters)
    loss = img.mean()
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t0
    counts_fwd = read_counts()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counts["K1"] != counts_fwd["K1"]:
        fail(f"{label} fwd+bwd: K1 launched in the backward")
    if cfg.has_mesh and counts["K1"] != pathtracer.scan_iterations(n_iters):
        fail(f"{label} fwd+bwd: K1 {counts['K1']} != iterations")
    required = names if required is None else required
    for k, g in zip(names, grads):
        if g is not None and not bool(torch.isfinite(g).all()):
            fail(f"{label} fwd+bwd: non-finite gradient of {k}")
        if k in required and (g is None or float(g.abs().max()) == 0.0):
            fail(f"{label} fwd+bwd: the gradient of {k} is zero")
    out = dict(seconds=secs, forward_s=t_fwd, samples_per_s=w * w * spp / secs,
               iterations=n_iters, peak_gib=peak,
               grad_max={k: float(g.abs().max()) for k, g in zip(names, grads)
                         if g is not None}, **counts)
    log(f"  {label} fwd+bwd {w}^2 x {spp} spp (regen_scan, {n_iters} "
        f"iterations): {secs:.3f} s (forward {t_fwd:.3f} s), "
        f"{out['samples_per_s']:.0f} samples/s, peak {peak:.2f} GiB, K1 "
        f"{counts['K1']} (none in the backward), SDF marches "
        f"{counts['sdf_marches']} ({counts['sdf_march_steps']} steps); "
        "|grad| max " + ", ".join(f"{k} {v:.3g}"
                                  for k, v in out["grad_max"].items())
        + f"; on {gpu_line}")
    return out


def capture_mesh_batch(run, call):
    """``run()`` with the merged batch of its ``call``-th mesh dispatch kept,
    as K1's wrapper receives it (lane order) -> (run's result, the scene
    tables of that dispatch, the batch)."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect

    real = intersect.mesh_closest
    calls = []

    def capture(cfg_, scene_, origin, direction, t_init, any_hit=False,
                active=None, exclude_tri=None):
        calls.append(None)
        if len(calls) == call:
            calls.append((scene_, k1_batch(origin, direction, t_init, any_hit,
                                           active, exclude_tri)))
        return real(cfg_, scene_, origin, direction, t_init, any_hit=any_hit,
                    active=active, exclude_tri=exclude_tri)

    intersect.mesh_closest = capture
    try:
        out = run()
    finally:
        intersect.mesh_closest = real
    kept = [c for c in calls if c is not None]
    if not kept:
        fail(f"fewer than {call} mesh dispatches")
    return out, kept[0][0], kept[0][1]


def march_step_kernels(scene, cfg, n=RAYS, steps=16):
    """The kernels and device time of one SDF march step over ``n`` camera-
    like rays at the scene's SDFs (torch.profiler, ``steps`` steps, no
    early exit)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
    dev = scene.device
    g = torch.Generator(device="cpu").manual_seed(1)
    o = torch.tensor([0.0, 1.2, 4.0]).expand(n, 3).to(dev)
    d = torch.nn.functional.normalize(
        torch.rand((n, 3), generator=g) - torch.tensor([0.5, 0.6, 1.5]),
        dim=1).to(dev)
    d0, d1 = cfg.n_spheres, cfg.n_spheres + cfg.n_sdfs
    args = (o, d, torch.full((n,), 20.0, device=dev), scene.position[d0:d1],
            scene.geom_type[d0:d1], scene.params[d0:d1], steps)
    intersect.sdf_march(*args)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        intersect.sdf_march(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.count, e.self_device_time_total) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    kernels = sum(r[0] for r in rows)
    busy = sum(r[1] for r in rows) / 1e3
    out = dict(rays=n, steps=steps, kernels_per_step=kernels / steps,
               device_ms_per_step=busy / steps,
               wall_ms_per_step=wall * 1e3 / steps)
    log(f"  one SDF march step over {n} rays and {cfg.n_sdfs} SDFs: "
        f"{out['kernels_per_step']:.1f} kernels, "
        f"{out['device_ms_per_step']:.4f} ms of device time, "
        f"{out['wall_ms_per_step']:.3f} ms of wall (profiled)")
    return out


def path_traced_vs_cpu(dev, label, build, w, spp, seed, bound,
                       parted_limit=PATH_FLIP_PIXELS):
    """A frame of ``build(device) -> (cfg, scene, cam)`` rendered by the
    regen loop on the card and on the CPU, every lane traced iteration by
    iteration on both (lane_trace): pixels whose path takes another
    decision are left out (at most ``parted_limit`` of them), every other
    pixel within ``bound``."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    runs = {}
    for kind, d in (("card", dev), ("cpu", torch.device("cpu"))):
        cfg, scene, cam = build(d)
        with torch.no_grad():
            img, _ = pathtracer.render(cfg, scene, cam, w, w, spp, seed=seed,
                                       method="regen")
        runs[kind] = (cfg, scene, cam, img.cpu())
    lanes = torch.arange(w * w)
    traces = [lane_trace(*runs[k][:3], w, spp, seed, lanes)
              for k in ("card", "cpu")]
    parted_at = trace_parting(*traces, bound)[0]
    parted = (parted_at >= 0).reshape(w, w)
    g, c = runs["card"][3], runs["cpu"][3]
    diff = (g - c).abs()
    beyond = (diff > bound + bound * c.abs()).any(-1)
    stray = beyond & ~parted
    log(f"  card vs CPU, {label}, {w}^2 x {spp} spp: {int(beyond.sum())} "
        f"pixels beyond {bound} (max diff {float(diff.max()):.3g}); "
        f"{int(parted.sum())} pixels whose traced path took another decision "
        f"(left out); {int(stray.sum())} beyond without one; the kept pixels' "
        f"max diff {float(diff[~parted].max()):.3g}")
    if stray.any() or parted.float().mean() > parted_limit:
        fail(f"card vs CPU, {label}: {int(stray.sum())} pixels beyond {bound} "
             f"whose paths took the same decisions, {int(parted.sum())} "
             "parted")
    return dict(beyond=int(beyond.sum()), parted=int(parted.sum()),
                kept_max_diff=float(diff[~parted].max()))


def sdf_scene(d, mesh, bounces=None, side=FRAME):
    """Path A's scene on device ``d``: sdf_demo.json with ``mesh`` as its
    OBJ, and the default camera."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
    cfg, scene = build_scene(_doc("scenes/sdf_demo.json", bounces),
                             mesh_override=mesh, device=d)
    return cfg, scene, default_camera(side, side).pytree(d)


def phase_sdf(dev, gpu_line, spp=8, fb_spp=4):
    """Path A (BASELINE config 3): sdf_demo.json (3 SDFs, a box, 8 bounces)
    with icosphere_hi as its mesh."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    w = FRAME
    log(f"[17] path A: sdf_demo.json + {HI_MESH} ({w}^2), forward by regen, "
        f"while and scan x {spp} spp, fwd+bwd regen_scan x {fb_spp} spp")
    mesh = _hi_mesh()
    cfg, scene, cam = sdf_scene(dev, mesh)
    with torch.no_grad():  # warm-up: lazy CUDA modules, the allocator
        pathtracer.render(cfg, scene, cam, 64, 64, 1, method="regen")
    out = {"triangles": cfg.n_triangles, "forward": {}}
    imgs = {}
    (imgs["regen"], out["forward"]["regen"]), sc, batch = capture_mesh_batch(
        lambda: path_forward("A regen", cfg, scene, cam, w, spp, "regen",
                             gpu_line, profile=True), SDF_K1_CALL)
    for method in ("while", "scan"):
        imgs[method], out["forward"][method] = path_forward(
            f"A {method}", cfg, scene, cam, w, spp, method, gpu_line)
    for method in ("while", "scan"):
        diff = float((imgs[method] - imgs["regen"]).abs().max())
        if diff > 1e-4:
            fail(f"A: {method} differs from regen by {diff:.3g}")
    leaves = [f.name for f in dataclasses.fields(scene)
              if getattr(scene, f.name).is_floating_point()]
    out["fwd_bwd"] = path_fwd_bwd(
        "A", cfg, scene, cam, w, fb_spp, leaves, gpu_line,
        required=["params", "position", "color", "obj_color"])

    out["march_step"] = march_step_kernels(scene, cfg)
    # K1 against its twin on the regen frame's merged batch (a comparison,
    # outside the paths' counts)
    problems = []
    b = k1_sorted(batch, sc.bf_clusters)[0] if cfg.mesh_sort_rays else batch
    r = k1_compare(f"path A dispatch {SDF_K1_CALL} (as launched)",
                   sc.bf_feat, sc.bf_clusters, sc.bf_tri_verts, b, problems)
    if problems:
        fail("; ".join(problems))
    out["k1_err"], out["k1_flips"] = r["err"], r["win_flips"] + r["occ_flips"]

    # card against CPU at 64^2 with a CPU-sized mesh: identical camera rays
    # at one bounce, every pixel; the image mean at the scene's 8 bounces
    small = make_icosphere(**CVC8_MESH)
    s = CVC8_SIDE
    got = {}
    for kind, d in (("card", dev), ("cpu", torch.device("cpu"))):
        c1, sc1, cam1 = sdf_scene(d, small, bounces=1, side=s)
        px, py = pathtracer.pixel_grid(s, s, "cpu")
        o, dr = pathtracer.camera_rays_for_sample(
            sdf_scene("cpu", small, 1, s)[2], s, s, px, py, py * s + px, 0, 0)
        with torch.no_grad():
            rad, _ = integrator.trace(c1, sc1, o.to(d), dr.to(d),
                                      (py * s + px).to(d), 0, method="while")
            cd, scd, camd = sdf_scene(d, small, side=s)
            deep, _ = pathtracer.render(cd, scd, camd, s, s, 1, seed=1,
                                        method="regen")
        got[kind] = (rad.cpu(), deep.cpu())
    one = float((got["card"][0] - got["cpu"][0]).abs().max())
    rel = abs(float(got["card"][1].mean()) / float(got["cpu"][1].mean()) - 1)
    log(f"  card vs CPU, path A at {s}^2 ({small[0].shape[0]} triangles): "
        f"one bounce on identical rays max diff {one:.3g} (limit "
        f"{FWD_SHALLOW}); 8 bounces x 1 spp image mean rel {rel:.3g} (limit "
        f"{SDF_DEEP_MEAN_REL})")
    if one > FWD_SHALLOW or rel > SDF_DEEP_MEAN_REL:
        fail(f"card vs CPU, path A: one bounce {one:.3g}, mean rel {rel:.3g}")
    out["card_vs_cpu"] = dict(one_bounce_max_diff=one, deep_mean_rel=rel)
    return out


def media_scene(d, mesh, medium, phase, bounces=None, side=FRAME):
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
    cfg, scene = build_scene(_doc("scenes/cornell_media.json", bounces, medium),
                             mesh_override=mesh, phase_function=phase,
                             device=d)
    return cfg, scene, default_camera(side, side).pytree(d)


def phase_media(dev, gpu_line, spp=8, fb_spp=4):
    """Path B (BASELINE config 4): cornell_media.json (homogeneous, 12
    bounces, 64 scatter events) and its height-fog variant, each with
    icosphere_hi, under HG and Rayleigh."""
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    w = FRAME
    log(f"[18] path B: cornell_media.json (homogeneous, exponential) + "
        f"{HI_MESH} ({w}^2), HG and Rayleigh, forward regen x {spp} spp, "
        f"fwd+bwd regen_scan x {fb_spp} spp")
    mesh = _hi_mesh()
    out = {}
    for medium, doc_medium in (("homogeneous", None),
                               ("exponential", MEDIUM_EXP)):
        for phase in ("hg", "rayleigh"):
            label = f"B {medium} {phase}"
            cfg, scene, cam = media_scene(dev, mesh, doc_medium, phase)
            first = (medium, phase) == ("homogeneous", "hg")
            res = {"forward": path_forward(label, cfg, scene, cam, w, spp,
                                           "regen", gpu_line,
                                           profile=first)[1]}
            if phase == "hg":
                # the height fog's paths are ~5x longer: half the spp
                res["fwd_bwd"] = path_fwd_bwd(
                    label, cfg, scene, cam, w,
                    fb_spp if medium == "homogeneous" else fb_spp // 2,
                    ["medium_sigma_s", "medium_sigma_t", "phase_g", "color"],
                    gpu_line)
            out[f"{medium} {phase}"] = res
    small = make_icosphere(**CVC8_MESH)
    out["card_vs_cpu"] = path_traced_vs_cpu(
        dev, "path B homogeneous hg, 4 bounces",
        lambda d: media_scene(d, small, None, "hg", 4, CVC8_SIDE),
        CVC8_SIDE, 1, 5, FWD_MEDIUM)
    return out


def env_scene(d, env, side, bounces=None):
    import dataclasses

    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
    cfg, scene = build_scene(_doc("scenes/materials.json", bounces),
                             env_map=env, device=d)
    cam = dataclasses.replace(default_camera(side, side), **THIN_LENS)
    return cfg, scene, cam.pytree(d)


def phase_env(dev, gpu_line):
    """Path C (BASELINE config 5): materials.json lit by a seeded
    ENV_W x ENV_H equirect map (written by write_hdr, read back), a
    thin-lens camera: the CLI with -hdr at ENV_SIDE^2 x ENV_CLI_SPP (K2 at
    export), and fwd+bwd regen_scan at ENV_SIDE^2 x ENV_FB_SPP with the
    env_map gradient; the map's gradient is an indexed accumulation, timed
    against index_add_ on the frame's taps."""
    import shutil
    import tempfile

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import (
        read_hdr, write_hdr,
    )

    log(f"[19] path C: materials.json, a {ENV_W}x{ENV_H} equirect map from "
        f"seed {ENV_SEED}, thin lens {THIN_LENS}: the CLI -hdr at "
        f"{ENV_SIDE}^2 x {ENV_CLI_SPP} spp, fwd+bwd regen_scan at "
        f"{ENV_SIDE}^2 x {ENV_FB_SPP} spp")
    tmp = tempfile.mkdtemp(prefix="prt_env_")
    out = {}
    try:
        sky = os.path.join(tmp, "sky.hdr")
        write_hdr(sky, seeded_env_map())
        env = read_hdr(sky)
        png = os.path.join(tmp, "env.png")
        args = ["-scene", "scenes/materials.json", "-width", str(ENV_SIDE),
                "-height", str(ENV_SIDE), "-spp", str(ENV_CLI_SPP), "-hdr",
                sky, "-o", png]
        reset_counts()
        rc, stdout, secs = app_main(app, args)  # counted, in this process
        counts = read_counts()
        rep = cli_report(stdout, ENV_CLI_SPP)
        if rc != 0 or counts["K2"] != 1 or not os.path.exists(png):
            fail(f"path C CLI: exit {rc}, K2 {counts['K2']}, wrote "
                 f"{os.path.exists(png)}")
        out["cli"] = dict(rep, app_main_s=secs, **counts)
        log(f"  CLI -hdr {ENV_SIDE}^2 x {ENV_CLI_SPP} spp through app.main: "
            f"{rep['seconds']:.2f} s in its report ({rep['samples_per_s']:.0f} "
            f"samples/s), {secs:.2f} s to its return; K2 {counts['K2']} (at "
            f"export), K1 {counts['K1']} (no mesh), on {gpu_line}")
        cfg, scene, cam = env_scene(dev, env, ENV_SIDE)
        out["fwd_bwd"] = path_fwd_bwd(
            "C", cfg, scene, cam, ENV_SIDE, ENV_FB_SPP,
            ["env_map", "color", "camera.aperture_radius",
             "camera.focal_distance"], gpu_line)
        out["k2"] = _env_export_k2(cfg, scene, cam)

        def one():
            with torch.no_grad():
                pathtracer.render(cfg, scene, cam, ENV_SIDE, ENV_SIDE, 1,
                                  method="regen")

        idle, kernels, busy = idle_share(one)
        out["regen_1spp"] = dict(idle_share=idle, kernels=kernels,
                                 busy_ms=busy)
        log(f"  C regen {ENV_SIDE}^2 x 1 spp profiled: {kernels} kernels, "
            f"{busy:.1f} ms busy, idle share {idle:.3f}")
        out["index_add"] = _env_taps_timing(scene, cam)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    small = env[::16, ::16].copy()
    out["card_vs_cpu"] = path_traced_vs_cpu(
        dev, "path C, 4 bounces, a 128x64 map",
        lambda d: env_scene(d, small, CVC8_SIDE, 4), CVC8_SIDE, 1, 5,
        FWD_MATERIALS, GOLDEN_PARTED)
    return out


def _env_export_k2(cfg, scene, cam):
    """K2 on path C's frame as the CLI exports it, against its plain
    version (a comparison, outside the paths' counts)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    with torch.no_grad():
        img, _ = pathtracer.render(cfg, scene, cam, ENV_SIDE, ENV_SIDE, 1,
                                   method="regen")
    return cli_k2("path C", img)


def _env_taps_timing(scene, cam, reps=10):
    """The env_map gradient's scatter on one frame's bilinear taps: the
    autograd backward of the port's lookup (index_put_ with accumulate)
    against index_add_ of the same cotangents, CUDA events."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import envmap
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    w = ENV_SIDE
    px, py = pathtracer.pixel_grid(w, w, scene.device)
    _, d = pathtracer.camera_rays_for_sample(cam, w, w, px, py, py * w + px,
                                             0, 0)
    em = scene.env_map.detach().clone().requires_grad_()
    rad = envmap.radiance(em, d)
    g = torch.ones_like(rad)
    h, wm = em.shape[:2]
    u, v = envmap.equirect_uv(d)
    x0 = torch.remainder(torch.floor(u * wm - 0.5).to(torch.int32), wm).long()
    y0 = torch.clamp(torch.floor(v * h - 0.5).to(torch.int32), 0, h - 1).long()
    idx = torch.cat([y0 * wm + x0] * 4)
    src = torch.cat([g] * 4)
    flat = torch.zeros(h * wm, 3, device=scene.device)

    def backward():
        torch.autograd.grad(rad, em, g, retain_graph=True)

    def index_add():
        flat.zero_().index_add_(0, idx, src)

    res = {"taps": int(idx.numel()),
           "autograd_backward_ms": cuda_ms(backward, reps),
           "index_add_ms": cuda_ms(index_add, reps)}
    log(f"  env_map gradient's scatter, {res['taps']} taps into a "
        f"{wm}x{h} map: the lookup's autograd backward "
        f"{res['autograd_backward_ms']:.3f} ms, index_add_ "
        f"{res['index_add_ms']:.3f} ms (CUDA events)")
    return res


def phase_goldens_slice8(dev):
    """tests/golden_tool.py's sdf_demo, cornell_media, envmap and
    exponential_fog through render's default method on the card and the
    CPU: envmap and exponential_fog at the goldens' bound (a pixel may
    miss only where the CPU does too or where card and CPU part by more
    than 1e-5); sdf_demo and cornell_media on the image mean, against the
    golden and the CPU (HI_MEAN_REL: the goldens hold XLA's FMA-rounded
    SDF normals and medium decisions, and at 8 bounces an ulp of a
    direction moves an SDF normal ~1e-3)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene

    log("[20] this slice's goldens through render's default method (scan), "
        "on the card and on the CPU")
    out = {}
    for name, c in GOLDENS_SLICE8.items():
        imgs = {}
        for label, d in (("card", dev), ("cpu", torch.device("cpu"))):
            cfg, scene = build_scene(
                _doc(c["scene"], medium=c.get("medium")),
                env_map=golden_env_map() if c.get("env") else None, device=d)
            cam = default_camera(GOLDEN_SIZE, GOLDEN_SIZE).pytree(d)
            img, _ = pathtracer.render(cfg, scene, cam, GOLDEN_SIZE,
                                       GOLDEN_SIZE, c["spp"], seed=GOLDEN_SEED)
            imgs[label] = img.detach().cpu().numpy()
        with np.load(os.path.join(REPO, "tests/golden", f"{name}.npz")) as z:
            ref = z["img"]
        img, cpu_img = imgs["card"], imgs["cpu"]
        if not np.isfinite(img).all():
            fail(f"golden {name}: non-finite pixels on the card")

        def beyond(a, b):
            return (np.abs(a - b) > GOLDEN_ATOL + GOLDEN_RTOL * np.abs(b)).any(-1)

        rel = abs(float(img.mean()) / float(ref.mean()) - 1)
        rel_cpu = abs(float(img.mean()) / float(cpu_img.mean()) - 1)
        card_out, cpu_out = beyond(img, ref), beyond(cpu_img, ref)
        near = (np.abs(img - cpu_img) > 1e-5 * (1 + np.abs(cpu_img))).any(-1)
        stray = card_out & ~cpu_out & ~near
        log(f"  {name}: {int(card_out.sum())} of {card_out.size} pixels beyond "
            f"the golden's bound on the card, {int(cpu_out.sum())} on the CPU; "
            f"{int(near.sum())} part card from CPU by > 1e-5 (max "
            f"{np.abs(img - cpu_img).max():.3g}); unexplained "
            f"{int(stray.sum())}; mean rel to the golden {rel:.3g}, to the "
            f"CPU {rel_cpu:.3g}")
        if name in ("sdf_demo", "cornell_media"):
            if rel > HI_MEAN_REL or rel_cpu > HI_MEAN_REL:
                fail(f"golden {name}: mean off by {rel:.3g} (golden), "
                     f"{rel_cpu:.3g} (CPU)")
        elif stray.any() or near.mean() > GOLDEN_PARTED:
            fail(f"golden {name}: {int(stray.sum())} unexplained pixels, "
                 f"{int(near.sum())} beyond 1e-5 of the CPU")
        out[name] = dict(card_beyond=int(card_out.sum()),
                         cpu_beyond=int(cpu_out.sum()), mean_rel=rel)
    return out


def phase_k1_sweep(dev, pops):
    """--k1-sweep: K1_SWEEP's configurations on phase 3's populations."""
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    log("[3b] K1's configurations, each its own build (K1_SWEEP)")
    _, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                          models_dir=os.path.join(REPO, "scenes/assets"),
                          device=dev)
    wrong = k1_sweep(scene.bf_feat, scene.bf_clusters, pops)
    if wrong:
        fail(f"K1 sweep: configurations whose outputs differ from the "
             f"kernel library's: {wrong[:6]}")


def kernel_times(dev, root):
    """--kernel-times: K2 (phase 4's image), T2a and T2b (phase 11's
    inputs, each in turns with x.clone()), K3 (phase 7's sizes, in turns
    with x.clone() and the per-block torch.cumsum), all warm and with the
    L2 flushed, and T1 (phase 10's batch at both blocks, CUDA events, with
    its inner loop's SASS), on the port found at ``root``; one JSON line."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda, compaction, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    log(f"[4, 7, 10, 11] kernel times of the port at {root}")
    flush = l2_flush(dev)
    res = {"port_root": root, "K2": k2_times(tm, k2_image(dev), flush)}
    for name, fn, arg in t2_inputs(dev):
        res[name] = t2_times(fn, arg, flush)
    res["K3"] = [k3_times(compaction, k3_flags(n, dev), flush)
                 for n in K3_SIZES]
    for t in res["K3"]:
        k3_log(t, "")
    _, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                          models_dir=os.path.join(REPO, "scenes/assets"),
                          device=dev)
    b = k1_populations(scene, dev)["random"]
    res["T1"] = {str(blk): t1_time(mesh_brute, b, scene.bf_feat,
                                   scene.bf_clusters, blk)
                 for blk in T1_BLOCKS}
    res["T1_sass"] = sass_inner_loop(_cuda.LIBRARY._so_path(),
                                     "matmul_only_kernel")
    log("kernel times: " + json.dumps(res))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels_only = argv == ["--kernels-only"]
    sweep = argv == ["--k1-sweep"]
    census = argv == ["--op-census"]
    paths = argv == ["--paths"]
    times = argv[:1] == ["--kernel-times"] and (
        len(argv) == 1 or (len(argv) == 3 and argv[1] == "--port-root"))
    if argv and not (kernels_only or sweep or census or times or paths):
        fail(f"unknown arguments {argv}: none, --kernels-only, --k1-sweep, "
             "--op-census, --paths or --kernel-times [--port-root DIR]")
    root = os.path.abspath(argv[2]) if times and len(argv) == 3 else REPO
    if not os.path.isdir(os.path.join(root, PKG)):
        fail(f"the port package {PKG}/ is not in {root}")
    sys.path.insert(0, root)
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

    if census:
        log("[op census] card against CPU, progressive_step on "
            f"{CENSUS_SCENE} {CENSUS_W}x{CENSUS_H} x {CENSUS_STEPS} steps")
        log("op census: " + json.dumps(op_census(dev)))
        log("partial run (--op-census: phase 1 and the census); no result "
            "line")
        return 0

    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    log("[2] build")
    _cuda.LIBRARY.get()
    secs = _cuda.LIBRARY.build_seconds
    log(f"  nvcc {'(already built)' if secs is None else f'{secs:.2f} s'} "
        f"({len(_cuda.LIBRARY.sources())} sources)")
    for line in _cuda.LIBRARY.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())
    if times:
        kernel_times(dev, root)
        log("partial run (--kernel-times: phases 1-2 and the times of K2, "
            "K3, T1, T2a and T2b); no result line")
        return 0

    t_start = time.perf_counter()

    def done(phase):
        log(f"  ({phase} done at {time.perf_counter() - t_start:.1f} s)")

    if paths:
        for phase, run in ((17, phase_sdf), (18, phase_media), (19, phase_env)):
            log(f"path: {json.dumps(run(dev, gpu_line))}")
            done(phase)
        log("slice goldens: " + json.dumps(phase_goldens_slice8(dev)))
        done(20)
        log("partial run (--paths: phases 1-2 and 17-20); no result line")
        return 0
    k1_err, k1_times, k1_sort_cost, k1_pops = phase_k1(dev)
    k1_random = k1_pops["random"]
    done(3)
    if sweep:
        phase_k1_sweep(dev, k1_pops)
        log(f"partial run (--k1-sweep: phases 1-3 and the sweep), "
            f"{time.perf_counter() - t_start:.1f} s after the build; no "
            "result line")
        return 0
    if kernels_only:
        phase_t1(dev, k1_random, k1_times["random"]["ms"])
        phase_t2(dev)
        log(f"partial run (--kernels-only: phases 1-3, 10, 11), "
            f"{time.perf_counter() - t_start:.1f} s after the build; no "
            "result line")
        return 0
    k2 = phase_k2(dev)
    phase_goldens(dev)
    done(5)
    launches, t_regen, regen_img, regen_sort = phase_slice(dev, gpu_line,
                                                           spp=8)
    done(6)
    k3 = phase_k3(dev)
    fb = phase_fwd_bwd(dev, gpu_line)
    done(8)
    k1_fit = phase_inverse(dev, gpu_line)
    done(9)
    t1 = phase_t1(dev, k1_random, k1_times["random"]["ms"])
    done(10)
    t2 = phase_t2(dev)
    done(11)
    sw = phase_scan_while(dev, gpu_line, regen_img, t_regen, spp=8)
    done(12)
    sfb = phase_scan_fwd_bwd(dev, gpu_line)
    done(13)
    k1_goldens = phase_goldens_default(dev)
    done(14)
    k2_materials = phase_materials(dev, gpu_line)
    done(15)
    cli = phase_cli(dev, gpu_line)
    done(16)
    sdf = phase_sdf(dev, gpu_line)
    done(17)
    med = phase_media(dev, gpu_line)
    done(18)
    envp = phase_env(dev, gpu_line)
    done(19)
    g8 = phase_goldens_slice8(dev)
    done(20)

    cam = k1_times["camera"]
    k1_paths = {"forward 512^2 x 8 spp (regen)": launches["K1"],
                "fwd+bwd 512^2 x 4 spp (regen_scan)": fb["k1"],
                "fit_scene 2 steps 128^2 x 4 spp": k1_fit,
                "bench_kernel": t1["k1_launches"],
                "forward 512^2 x 8 spp (scan)": sw["scan"]["k1"],
                "forward 512^2 x 8 spp (while)": sw["while"]["k1"],
                "fwd+bwd 512^2 x 4 spp (scan)": sfb["k1"],
                "goldens (scan)": k1_goldens,
                f"CLI {CLI_SIDE}^2 x {CLI_RESUME_SPP} spp (app.main, while)":
                    cli["k1"],
                f"CLI --aov, 5 modes at {CLI_SIDE}^2 (app.main)":
                    cli["aov"]["k1"],
                **{f"A {m} 512^2 x 8 spp": r["K1"]
                   for m, r in sdf["forward"].items()},
                "A fwd+bwd 512^2 x 4 spp (regen_scan)": sdf["fwd_bwd"]["K1"],
                **{f"B {k} 512^2 x 8 spp (regen)": r["forward"]["K1"]
                   for k, r in med.items() if k != "card_vs_cpu"},
                **{f"B {k} fwd+bwd 512^2 x 4 spp (regen_scan)":
                   r["fwd_bwd"]["K1"] for k, r in med.items()
                   if "fwd_bwd" in r}}
    k2_paths = {"forward 512^2 x 8 spp (regen)": launches["K2"],
                "forward 512^2 x 8 spp (scan)": sw["scan"]["k2"],
                "forward 512^2 x 8 spp (while)": sw["while"]["k2"],
                "materials 512^2 x 8 spp (scan)": k2_materials,
                f"CLI export {CLI_SIDE}^2 (app.main)": cli["k2"],
                f"CLI --aov, 5 modes at {CLI_SIDE}^2 (app.main)":
                    cli["aov"]["k2"],
                **{f"A {m} 512^2 x 8 spp": r["K2"]
                   for m, r in sdf["forward"].items()},
                **{f"B {k} 512^2 x 8 spp (regen)": r["forward"]["K2"]
                   for k, r in med.items() if k != "card_vs_cpu"},
                f"C CLI -hdr {ENV_SIDE}^2 export (app.main)":
                    envp["cli"]["K2"]}
    kernels = [
        {"name": "K1 mesh_brute", "route": "cuda",
         "source": f"{PKG}/csrc/mesh_brute.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py:301",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
         "max_abs_err": max(k1_err, cli["k1_err"], sdf["k1_err"]),
         "ms": cam["ms"],
         "plain_ms": cam["plain_ms"],
         "bound_ms": cam["bound"], "bound_by": cam["by"], "library_ms": None,
         "library_note": "no PyTorch call computes a closest hit: a "
                         "torch.matmul of the rays against the table gives "
                         "den, t*den, u*den and v*den, and the hit test, the "
                         "division and the per-ray minimum are more calls",
         "timed_by": "ms: CUDA events around 10 back-to-back launches "
                     "(camera rays, unsorted; profiler_ms: the profiler's "
                     "device time, mean over the kernel records it kept of "
                     "10 launches); plain_ms: profiler device time of all "
                     "kernel records of one call of the twin",
         **{f"{key}_by_population": {k: v[field] for k, v in k1_times.items()}
            for key, field in (("ms", "ms"), ("profiler_ms", "profiler_ms"),
                               ("plain_ms", "plain_ms"),
                               ("bound_ms", "bound"),
                               ("lane_slot_share", "share"))},
         "ray_sort_on_render_population": k1_sort_cost,
         "render_warps_shuffled_ms": k1_times["render"]["warps_shuffled_ms"],
         "regen_frame_sort_on_off_s": regen_sort},
        {"name": "K2 tonemap", "route": "cuda",
         "source": f"{PKG}/csrc/tonemap.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/pallas_kernels.py:39",
         "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
         "max_abs_err": max(k2["err"], cli["k2_err"], cli["aov"]["k2_err"],
                            envp["k2"]),
         "ms": k2["ms"],
         "ms_l2_flushed": k2["flushed_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound"], "bound_by": k2["by"], "library_ms": None,
         "timed_by": k2["timed_by"]},
        {"name": "K3 block_scan", "route": "cuda",
         "source": f"{PKG}/csrc/block_scan.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/pallas_kernels.py:98",
         "launches": k3["launches"],
         "launches_by_path": {"compact_indices": k3["launches"]},
         "max_abs_err": k3["err"], "ms": k3["ms"],
         "ms_l2_flushed": k3["flushed_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound"], "bound_by": k3["by"],
         "library_ms": k3["library_ms"],
         "library_ms_l2_flushed": k3["library_flushed_ms"],
         "library_call": "torch.cumsum(f.view(-1, block), dim=1) (per block)",
         "exclusive_prefix_sum_ms": k3["exclusive_prefix_sum_ms"],
         "whole_array_cumsum_ms": k3["whole_array_cumsum_ms"],
         "by_size": k3["by_size"], "timed_by": k3["timed_by"]},
        {"name": "T1 matmul_only", "route": "cuda",
         "source": f"{PKG}/csrc/matmul_only.cu",
         "replaces": "tools/bench_kernel.py:55",
         "launches": t1["launches"],
         "launches_by_path": {"bench_kernel": t1["launches"]},
         "max_abs_err": t1["err"], "ms": t1["ms"], "plain_ms": t1["plain_ms"],
         "bound_ms": t1["bound"], "bound_by": t1["by"],
         "issue_floor_ms": t1["issue_floor"], "library_ms": None,
         "library_note": "no single PyTorch call computes it: its one-call "
                         "form, torch.matmul of the pack against the whole "
                         "table then a masked sum, would materialise "
                         "N x 4*Tpad floats (343 GB at 262,144 rays on "
                         "cornell_hi)",
         "by_block": t1["by_block"], "inner_loop_sass": t1["sass"],
         "timed_by": t1["timed_by"]},
    ]
    for name, line in (("T2a", 57), ("T2b", 112)):
        k = t2[name]
        kernels.append(
            {"name": f"{name} passthrough", "route": "cuda",
             "source": f"{PKG}/csrc/passthrough.cu",
             "replaces": f"tools/pallas_barrier_test.py:{line}",
             "launches": k["launches"],
             "launches_by_path": {"barrier_test": k["launches"]},
             "max_abs_err": k["err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
             "bound_ms": k["bound"], "bound_by": k["by"],
             "library_ms": k["library_ms"],
             "ms_l2_flushed": k["flushed_ms"],
             "library_ms_l2_flushed": k["library_flushed_ms"],
             "timed_by": k["timed_by"]})
    log("fwd+bwd: " + json.dumps({k: v for k, v in fb.items()}))
    log("scan fwd+bwd: " + json.dumps(sfb))
    log("scan / while forward: " + json.dumps(sw))
    log("CLI: " + json.dumps(cli))
    log("path A (SDFs + mesh): " + json.dumps(sdf))
    log("path B (media): " + json.dumps(med))
    log("path C (env-lit thin lens): " + json.dumps(envp))
    log("slice goldens: " + json.dumps(g8))
    log(f"total {time.perf_counter() - t_start:.1f} s after the build")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
