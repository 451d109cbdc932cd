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
     random grid order.  Then PRT_MESH_TILE's other sizes (K1_TILES, 256
     and 512): K1 on the tables packed at each tile against the twin on
     the same tables, the four populations in lane order, the closest
     lanes bitwise the 128-triangle tables' results; flips, t error,
     CUDA-event ms and the bound.
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
     terms, on the 128-triangle tables and on the same packed at T1_TILE
     (256); the opcode counts of its inner loop (cuobjdump -sass); its
     time at both blocks and both tiles against its FLOP bound and its
     FP32 issue floor; the
     (ray, tile) pairs it adds against those K1 tests; times of its plain
     version and the relevance pass, and K1 / T1 on that batch; then the K1
     microbenchmark (tools/bench_kernel.py) as a user runs it, with its
     precision sweep (each PRT_MESH_PRECISION name's time, index agreement
     and hit/miss flips against highest) and its bf16-table leg.
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
     method, cornell_hi 512^2 x SCAN_FB_SPP (2) spp, over every float leaf
     + camera:
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
     with icosphere_hi (81,920 triangles) as its mesh, 512^2 x SDF_SPP (2)
     spp by regen (profiled at 1 spp for the idle share), while and scan (each
     tonemapped, K2), all three equal; fwd+bwd regen_scan 512^2 x
     SDF_FB_SPP (2) spp
     over every float leaf (SDF params and position non-zero, K1 none in
     the backward, peak memory); one SDF march step's kernels; K1 against
     its twin on the regen frame's SDF_K1_CALL-th merged batch; card
     against CPU at 64^2 with a 1,280-triangle icosphere: one bounce on
     identical camera rays every pixel within FWD_SHALLOW, the 8-bounce
     image mean within SDF_DEEP_MEAN_REL.
 18. Path B (BASELINE config 4): cornell_media.json (homogeneous, 12
     bounces, 64 scatter events) and its height fog (tests/golden_tool.py's
     exponential medium), each with icosphere_hi, under HG and Rayleigh:
     regen 512^2 x 4 spp (the fog at 1); under HG fwd+bwd regen_scan
     512^2 x 4 spp (the fog at 1) over the sigmas, phase_g and the
     colours; card against CPU at 64^2, 4 bounces, every lane traced:
     parted pixels left out, the rest within FWD_MEDIUM.
 19. Path C (BASELINE config 5): materials.json lit by a 2048 x 1024
     equirect map made from the seed, written by write_hdr and read back,
     thin-lens camera: the CLI -hdr at 1024^2 x ENV_CLI_SPP (8) spp as a
     process and through app.main (K2 at export counted); fwd+bwd
     regen_scan at 1024^2 x ENV_FB_SPP (2) spp (the spp cut from
     BASELINE's 256 to fit) over env_map, the
     colours and the lens, peak memory, E1's launches counted in it (the
     forward, the recompute, the backward); E1 (csrc/envmap.cu, the sky
     lookup and its gradient) on the lanes and cotangents of that run's
     E1_CALLS (2) backward calls with the most live lanes (the count
     syncs the host each call): the lookup bitwise the plain one's,
     the map's gradient within 1e-6 of the plain autograd backward's
     relative to its norm and 1e-5 a large texel, the gradients of u and v
     within 1e-5, and its times and bounds (CUDA events); K2 on the frame
     against its plain version; the idle share of a 1-spp regen frame;
     card against CPU at 64^2 with a 128 x 64 map, 4 bounces, traced
     lanes, FWD_SHALLOW.
 20. The goldens sdf_demo, cornell_media, envmap and exponential_fog
     through render's default method on the card and the CPU.

Phases 3-20 load their meshes with the brute backend (PRT_MESH_ACCEL=brute,
inherited by the CLI's subprocesses), so K1 stays on every path they
drove before the walk was ported; phases 21-24 take the card's own pick.

 21. W1 (csrc/bvh_walk.cu, the BVH walk) against its plain twin on the
     card, on the cornell_hi tables: phase 3's random, camera and surface
     populations (merged closest + any-hit batches of 524,288 lanes with
     inactive lanes and capped t_init) and the render population (the
     regen forward's RENDER_CALL-th merged batch through the walk): 0
     mismatches in t, tri, u, v and node visits, W1's visit, leaf and test
     counters the twin's; W1's time by CUDA events over 10 launches and by
     event pairs behind a sleep, warm and L2-flushed (event_ms), its bound
     from its work counters, node visits a ray, the SIMT efficiency of its
     node loop and leaf branch (w1_simt), its registers; the same checks
     on the edge batches of w1_edge_batches; the refill sweep (a build of
     bvh_walk.cu for each threshold of W1_REFILL_SWEEP, timed on the four
     populations).
 22. The backend crossover: the whole mesh_closest call by each backend
     (brute: the ray sort, K1 and the winner's validation; bvh: W1) on
     icospheres of 320 to 327,680 triangles as cornell.json's mesh, for a
     512^2 frame's camera rays and a regen dispatch's merged batch, CUDA
     events, the backends in turns; brute up to 262,144 triangles.  The
     loader's card rule (scene/loader.py: _pick_mesh_accel, the walk for
     every mesh) is set from this table, and the phase logs whether it
     agrees.
 23. cornell_hi with the card's pick at full width: regen 512^2 x 8 spp
     (the mesh kernel counted, the 1-spp idle share), held against phase
     6's brute frame: pixels whose path met another winner than K1's in a
     dispatch (each dispatch also run through K1) are counted, every other
     pixel bitwise; fwd+bwd regen_scan 512^2 x 4 spp over every float leaf
     (the mesh kernel never in the backward); the traversal AOV at 512^2,
     the node visits of a 64^2 centre crop bitwise the CPU's; a regen
     512^2 x 2 spp of phase 22's 327,680-triangle icosphere through W1.
 24. BDPT: cornell_hi 512^2 x 8 spp at the default depth (13 mesh
     dispatches a sample, tonemapped by K2, the 1-spp idle share); the same
     through K1 at 256^2 x 2 spp; cornell_simple and multilight converged
     against the unidirectional tracer at tests/test_bdpt.py's sizes, spp,
     seeds and bounds (each estimate one batch of pixel x sample lanes);
     card against CPU at 32^2 x 2 spp, depth 3, cornell.json with a
     5,120-triangle icosphere, every decision recorded on both: pixels
     that took another one left out (at most FLIP_PIXELS), the rest within
     FWD_BDPT.
 25. Several ranks (parallel/), cornell_hi with the card's pick: (a) one
     rank over NCCL, render_sharded at 512^2 x 8 spp bitwise trace_regen of
     the whole frame in this process (both timed, W1 counted), and one
     make_train_step step at 256^2 x 1 spp (its seconds, peak memory and
     the bytes of its gradient all-reduce); (b) two subprocess ranks on
     this one card over gloo (NCCL refuses two ranks on one GPU), the same
     frame bitwise (a)'s; (c) their train step's updated colour and
     medium_sigma_t bitwise the 1-rank update, the losses within 1e-6.  The
     two ranks share the card: their times are not a scaling number.
 26. trace_regen_scan(remat="segment") on cornell_hi, after an untimed
     64^2 fwd+bwd by each mode: (a) with the card's pick (W1) at 512^2 x
     REMAT_SPP (2) spp, one fwd+bwd by remat="body" then one by
     "segment" over every float leaf and the camera: completed == spp,
     the walk launched once an iteration in each forward and never in
     either backward (the segment's dispatches replayed from its
     HitTape), the images and every gradient leaf bitwise equal, seconds
     and peak memory of each;
     (b) the same with K1 pinned (PRT_MESH_ACCEL=brute) at 256^2 x 2 spp;
     (c) the north star by tools.northstar.value_and_grads at 1024^2 x
     NORTH_SPP (1) spp, its budget calibrated over the frame, by 4 bands
     and direct, once each: seconds, peak memory, W1 launches, completed
     == spp, the bands' summed gradients held to the direct ones
     (northstar.check_tiled).
 27. The graft hook and the bounce-level tools, with the card's pick:
     graft.entry()'s fn (cornell.json with an 80-triangle icosphere, 64^2
     x 1 spp, render_sample by "scan") on the card, W1 counted, against the
     same fn on the CPU (the brute twin): every pixel within GRAFT_TOL but
     at most GOLDEN_PARTED of them (a path an ulp parted), the means within
     HI_MEAN_REL; then each of the port's tools bounces, bounce_parts,
     trace_bounce, bisect_bounce (both modes), profile_floor, bwd_anatomy,
     spmd_audit (1 rank over NCCL: a render issues no collective, a step
     two all-reduces, 132 bytes of gradient) and scaling_bench (1 rank:
     no scaling number) run in this process at a small size (TOOL_SIZES),
     its JSON lines logged and its keys checked, W1 counted.
 28. K1's reduced-precision forms: the tensor-core kernel
     (csrc/mesh_brute_tc.cu) in each of TC_FORMS (PRT_MESH_PRECISION
     default, bf16x3, bf16x6; the table cast to bf16) against its plain
     version (mesh_brute.intersect_reduced_plain) on the card, on the
     cornell_hi tables and phase 3's random, camera and surface
     populations and phase 21's render population: winner and occlusion
     flips (at most FLIP_LIMIT a ray), the t difference where winners
     agree (at most TC_DT_REL of max(|t|, 1)), CUDA-event ms warm and
     L2-flushed (event_ms), the bound, and
     the lanes PRT_MESH_NOREL moves (none in bf16x6); K1 under
     PRT_MESH_NOREL bitwise; PRT_MESH_FORCE_XLA: no kernel, bitwise the
     twin; each of TC_SIZE_FORMS at each (tile, relevance block) of
     TC_SIZES ((256, 256), (128, 128), (128, 512): PRT_MESH_TILE and
     PRT_MESH_BLOCK) on the tables packed at the tile, against its plain
     version at the same sizes on the four populations (flips, t error,
     CUDA-event ms, the bound); one brute-pinned cornell_hi regen frame at
     TC_SIDE^2 x TC_SPP spp in each form, its mean radiance against
     highest's (printed; only finiteness gates), and bf16x3's again with
     mesh_second_pass (two launches a mesh call); the same frame through
     K1 on the tables at tiles 256 and 512 (at most FLIP_PIXELS of the
     pixels off highest's: an any-hit lane's winner, which validation
     re-tests, is its first occluding tile's) and in TC_SIZE_FRAME_FORM at
     each of TC_SIZES.

Prints the kernels' JSON line (with each kernel's bound: the larger of its
bytes over 3.35 TB/s and its operations over 67 TFLOP/s, the H100 SXM's
HBM3 rate and FP32 peak; the tensor-core kernel's bf16 products over 989
TFLOP/s, its dense bf16 peak), the nvidia-smi line, and last the result line
``{"ok": true, "device": {...}}``.  Exits non-zero without a result line
when there is no CUDA device or when the port is not beside it.

    python3 chip_smoke.py --kernels-only

runs phases 1-3, 10 and 11 alone (the kernels' checks and times) and
prints no result line.

    python3 chip_smoke.py --k1-sweep

runs phases 1-3, then builds csrc/mesh_brute.cu once for each K1
configuration of K1_SWEEP and K1_TILE_SWEEP (its PRT_K1_* macros) and
times each on phase 3's populations, K1_SWEEP's on the 128-triangle
tables and K1_TILE_SWEEP's (the reference's round-5 grid: tiles 128, 256
and 512 x 128, 256 and 512 rays a block) on the tables packed at each
tile, held bitwise against the kernel library's build at the same tile;
no result line.

    python3 chip_smoke.py --op-census

runs phase 1, then for each sampler the progressive frame of
tests/test_torch_cuda.py::test_progressive_on_card_matches_cpu on the card
and on the CPU with every ATen call recorded: the ops whose outputs differ
from bitwise-equal inputs (ulps, the port's lines that call them), and the
card's run again with those ops evaluated on the CPU; no result line.

    python3 chip_smoke.py --paths

runs phases 1-2 and 17-20 alone; no result line.

    python3 chip_smoke.py --walk

runs phases 1-2 and 21-24 alone (phase 23 renders its own brute frame);
no result line.

    python3 chip_smoke.py --sharded

runs phases 1-2 and 25 alone; no result line.

    python3 chip_smoke.py --regen-scan

runs phases 1-2 and 26, then the two tools at their defaults, each as a
process of its own (python -m ...tools.regen_scan_probe: forward only and
fwd+bwd by remat x SCAN_CHUNK, a child process a variant; python -m
...tools.northstar: 1024^2 x 4 spp, tiled x 4 and direct, a cold run and
the best of 2 more); no result line.

    python3 chip_smoke.py --tools

runs phases 1-2 and 27, then each of phase 27's tools at its defaults as
a process of its own (python -m ...tools.<name>; bisect_bounce also with
--isect); no result line.

    python3 chip_smoke.py --tc

runs phases 1-2 and 28 alone (~70 s after the build); no result line.

    python3 chip_smoke.py --bdpt-bound

runs phases 1-2 and phase 24's card-vs-CPU BDPT comparison on
BDPT_BOUND_SEEDS under both backends, then with each of BDPT_FAULTS planted
in the card's leg: the readings FWD_BDPT sits between; no result line.

    python3 chip_smoke.py --kernel-times [--port-root DIR]

runs phases 1-2 and only the times of K2, K3, T2a and T2b (phases 4, 7
and 11, warm and L2-flushed), of W1 (phase 21's populations, warm and
L2-flushed, W1_TURN_REPEATS readings each, with a digest of its outputs'
bits), of K1tc (each reduced form at the default tile and block on
phase 28's populations, warm and L2-flushed, TC_TURN_REPEATS readings
each, with a digest of its outputs' bits) and of T1 (phase 10's, with its
inner loop's SASS) on the port in DIR (a checkout of another commit; this
one's by default), as one JSON line; no result line.  Two commits compare
in one call: run it for each, in turns.
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
# never), triangles a lane per spread-mode pass), on 128-triangle tiles
K1_SWEEP = [(b, p, u) for b in (64, 128, 256) for u in (1, 2, 4)
            for p in (1, 16, 24, 28, 32, 33)]
# ... and the reference's round-5 grid (ops/mesh_brute.py:56-67): tiles
# (PRT_MESH_TILE) x rays per block, at the default popcount and pass
K1_TILE_SWEEP = [(t, (b, 32, 2)) for t in (128, 256, 512)
                 for b in (128, 256, 512)]
# PRT_MESH_TILE's sizes beside the default 128 at which phase 3 holds K1 to
# its twin and phase 28 renders a frame through it, and T1's in phase 10
K1_TILES = (256, 512)
T1_TILE = 256
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


def tables_at(scene, tile):
    """The scene's brute tables packed again at ``tile`` triangles a tile
    (what the loader packs under PRT_MESH_TILE=tile: the triangles in the
    same BVH order), on the scene's device -> (feat, clusters,
    tri_verts, tri_normals)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    bp = mesh_brute.pack_brute(scene.bf_tri_verts.cpu().numpy(),
                               scene.bf_tri_normals.cpu().numpy(), tile=tile)
    return tuple(torch.from_numpy(x).to(scene.bf_feat.device) for x in bp)


def scene_at(scene, tile):
    """``scene`` with its brute tables packed at ``tile`` (tables_at)."""
    import dataclasses
    feat, clusters, tv, tn = tables_at(scene, tile)
    return dataclasses.replace(scene, bf_feat=feat, bf_clusters=clusters,
                               bf_tri_verts=tv, bf_tri_normals=tn)


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
    tile = mesh_brute.table_tile(feat, clusters)
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


def nvcc_variants(source, entry, configs, tag):
    """csrc/``source`` built once for each configuration (a key -> its
    -D flags) into a directory of this process under _build/ (one nvcc a
    build, as many at once as there are cores) -> {key: (its ``entry``
    with the kernel library's argtypes, the build's ptxas log)}."""
    import ctypes
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    out_dir = os.path.join(_cuda.BUILD_DIR, f"{tag}.{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_cuda.CSRC_DIR, source)
    todo, running, built = list(configs), [], {}
    t0 = time.perf_counter()
    while todo or running:
        while todo and len(running) < (os.cpu_count() or 4):
            key = todo.pop(0)
            so = os.path.join(out_dir, f"{tag}_{len(built) + len(running)}.so")
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared",
                   *configs[key], "-o", so, src]
            running.append((key, so, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        key, so, proc = running.pop(0)
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            fail(f"{tag}: nvcc failed for {key}:\n{out}")
        fn = getattr(ctypes.CDLL(so), entry)
        fn.argtypes = _cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        built[key] = (fn, out)
    log(f"  {tag}: {len(built)} builds of {source}, "
        f"{time.perf_counter() - t0:.1f} s")
    return built


def k1_variants(configs):
    """csrc/mesh_brute.cu built once for each configuration, through its
    PRT_K1_* macros (nvcc_variants) -> {configuration: (its
    prt_mesh_brute, registers a thread)}."""
    built = nvcc_variants(
        "mesh_brute.cu", "prt_mesh_brute",
        {(b, p, u): [f"-DPRT_K1_BLOCK_RAYS={b}",
                     f"-DPRT_K1_PER_THREAD_FROM={p}", f"-DPRT_K1_PASS={u}"]
         for b, p, u in configs}, "k1_sweep")
    out = {}
    for cfg, (fn, text) in built.items():
        regs = re.findall(r"Used (\d+) registers", text)
        out[cfg] = (fn, int(regs[0]) if regs else -1)
    return out


def k1_sweep(scene, pops, reps=5):
    """Every configuration of K1_SWEEP on the scene's 128-triangle tables
    and every (tile, configuration) pair of K1_TILE_SWEEP on its tables
    packed at that tile (tables_at), each configuration its own build of
    K1, on every population: CUDA-event ms a launch over ``reps``
    back-to-back launches, logged; each run's outputs held bitwise against
    the kernel library's (the render path's build) at the same tile -> the
    (tile, configuration, population) triples that disagreed."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    grid = list(dict.fromkeys([(128, cfg) for cfg in K1_SWEEP]
                              + K1_TILE_SWEEP))
    variants = k1_variants(sorted({cfg for _, cfg in grid}))
    tables = {128: (scene.bf_feat, scene.bf_clusters)}
    for tile in sorted({t for t, _ in grid} - {128}):
        tables[tile] = tables_at(scene, tile)[:2]
    table, wrong = {}, []
    for name, b in pops.items():
        n = b["origin"].shape[0]
        for tile, (feat, clusters) in tables.items():
            t0, i0 = mesh_brute.mesh_brute_kernel(
                feat, clusters, b["origin"], b["direction"], b["t_init"],
                b["active"], b["any_hit"], b["exclude"])
            t = torch.empty_like(t0)
            i = torch.empty_like(i0)
            for cfg in [c for tl, c in grid if tl == tile]:
                fn = variants[cfg][0]

                def launch(fn=fn, feat=feat, clusters=clusters, tile=tile,
                           cfg=cfg):
                    code = fn(feat.data_ptr(), feat.stride(0),
                              clusters.shape[0], tile, clusters.data_ptr(),
                              b["origin"].data_ptr(),
                              b["direction"].data_ptr(),
                              b["t_init"].data_ptr(), b["active"].data_ptr(),
                              b["any_hit"].data_ptr(), b["exclude"].data_ptr(),
                              n, t.data_ptr(), i.data_ptr(), None, 0,
                              torch.cuda.current_stream().cuda_stream)
                    if code:
                        fail(f"K1 sweep: tile {tile} {cfg} returned CUDA "
                             f"error {code}")
                launch()
                if not (torch.equal(t, t0) and torch.equal(i, i0)):
                    wrong.append((tile, cfg, name))
                table.setdefault((tile, cfg), {})[name] = cuda_ms(launch,
                                                                  reps)
    names = list(pops)
    log("  K1 sweep (CUDA events, ms a launch over "
        f"{reps} launches; tile, (rays per block, per-thread from popcount, "
        "triangles a lane per spread-mode pass); registers): "
        + " | ".join(names))
    for (tile, cfg), row in sorted(table.items(),
                                   key=lambda kv: kv[1]["render sorted"]):
        log(f"    {tile} {cfg} {variants[cfg][1]}: "
            + " ".join(f"{row[k]:.3f}" for k in names))
    log("  the reference's grid (tile x rays per block, K1_TILE_SWEEP), ms "
        "a launch, camera / render sorted: " + "; ".join(
            f"{tile} x {cfg[0]} {table[(tile, cfg)]['camera']:.3f} / "
            f"{table[(tile, cfg)]['render sorted']:.3f}"
            for tile, cfg in K1_TILE_SWEEP))
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
    by_tile = k1_tiles(scene, base, outs, timings, problems)

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
    return worst, timings, sort_cost, pops, by_tile


def k1_tiles(scene, base, outs, timings, problems):
    """PRT_MESH_TILE's other sizes: K1 on the scene's tables packed at each
    tile of K1_TILES (tables_at) against the twin on the same tables, on
    the four populations in lane order (k1_compare's limits); the closest
    lanes' (t, tri) bitwise the 128-triangle tables' (the least t, the
    lowest index on ties, whatever the tiles); CUDA-event ms over 10
    launches and the bound -> {tile: {population: numbers}}."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    out = {}
    for tile in K1_TILES:
        feat, clusters, tv, _ = tables_at(scene, tile)
        out[tile] = {}
        for name, b in base.items():
            r = k1_compare(f"{name} at tile {tile}", feat, clusters, tv, b,
                           problems)
            closest = b["active"] & ~b["any_hit"]
            t0, i0 = outs[name]
            same = (torch.equal(r["t"][closest], t0[closest])
                    and torch.equal(r["tri"][closest], i0[closest]))
            if not same:
                problems.append(f"K1 {name} at tile {tile}: closest lanes "
                                "differ from the 128-triangle tables'")
            args = (feat, clusters, b["origin"], b["direction"], b["t_init"],
                    b["active"], b["any_hit"], b["exclude"])
            ms = cuda_ms(lambda: mesh_brute.mesh_brute_kernel(*args), 10)
            bound, by, share, _ = k1_bound(feat, clusters, b)
            out[tile][name] = dict(
                ms=ms, ms_tile_128=timings[name]["ms"],
                plain_ms=r["twin_ms"], bound=bound, by=by, share=share,
                win_flips=r["win_flips"], occ_flips=r["occ_flips"],
                err=r["err"], closest_as_tile_128=same)
            log(f"  K1 {name} at tile {tile}: {clusters.shape[0]} tiles, "
                f"kernel {ms:.3f} ms (CUDA events, 10 launches; tile 128 "
                f"{timings[name]['ms']:.3f} ms, {ms / timings[name]['ms']:.2f}x"
                f"), twin {r['twin_ms']:.3f} ms (profiler), bound "
                f"{bound:.4f} ms ({by}), lane-slot share {share:.1%}; "
                f"closest lanes {'bitwise' if same else 'NOT'} the tile-128 "
                "results")
    return out


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

# the mangled name's part that picks T1's instance for 128-triangle tiles
# out of the library's SASS (cuobjdump -sass)
T1_SASS_FUNCTION = "matmul_only_kernelILi128E"
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
    """T1 on phase 3's batch ``b`` at ``block`` on the table ``feat`` (its
    tile read from it and ``clusters``): CUDA events around ``reps``
    back-to-back launches, with its bounds and the (min, mean, max)
    relevant tiles of a block -> dict."""
    o, d, t_init, act = b["origin"], b["direction"], b["t_init"], b["active"]
    n = o.shape[0]
    tile = feat.shape[1] // (4 * clusters.shape[0])
    # the tile is passed only where it is not the default 128, so that
    # --kernel-times also times ports from before the tile was an argument
    other = () if tile == 128 else (tile,)
    words = mesh_brute.relevance_words(clusters, o, d, t_init, act, block)
    pack = mesh_brute.matmul_only_pack(o, d, t_init)
    block_tiles, pairs, per_block = t1_pairs(words, n, block)

    def kernel():
        return mesh_brute.matmul_only_kernel(words, pack, feat, block, *other)

    n_bytes = (words.numel() * 4 + pack.numel() * 4 + feat.numel() * 4
               + n * 8)
    flops = pairs * tile * T1_PAIR_FLOPS
    bound, by = bound_ms(n_bytes, flops)
    floor = (pairs * tile * T1_PAIR_INSTRUCTIONS
             / FP32_INSTRUCTIONS_PER_S * 1e3)
    return dict(block=block, tile=tile, ms=cuda_ms(kernel, reps), reps=reps,
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
    # the scene's 128-triangle tables, and the same packed at T1_TILE
    # (PRT_MESH_TILE's other sizes)
    tile_feat, tile_cl = tables_at(scene, T1_TILE)[:2]
    for tile, (tf, tc) in ((128, (feat, clusters)),
                           (T1_TILE, (tile_feat, tile_cl))):
        for block in T1_BLOCKS:
            words = mesh_brute.relevance_words(tc, o, d, t_init, act, block)
            t_k, i_k = mesh_brute.matmul_only_kernel(words, pack, tf, block,
                                                     tile)
            t_p, _ = mesh_brute.matmul_only_plain(words, pack, tf, block,
                                                  tile)
            scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(),
                                                    tf.abs(), block, tile)
            torch.cuda.synchronize()
            err = (t_k - t_p).abs()
            b_rel = float((err / scale.clamp(min=1e-30)).max())
            if bool(i_k.any()):
                fail(f"T1 tile {tile} block {block}: the index output is not "
                     "all zero")
            if b_rel > T1_REL:
                fail(f"T1 tile {tile} block {block}: {b_rel:.3g} of the sum "
                     f"of absolute terms > {T1_REL}")
            max_abs, rel = max(max_abs, float(err.max())), max(rel, b_rel)
            log(f"  T1 vs plain, tile {tile}, block {block}: {n} rays, max "
                f"abs diff {float(err.max()):.3g}, {b_rel:.3g} of the sum of "
                f"absolute terms (limit {T1_REL}); index output all zero")

    sass = sass_inner_loop(_cuda.LIBRARY._so_path(), T1_SASS_FUNCTION)
    log(f"  T1 inner loop, SASS (cuobjdump -sass of the kernel library): "
        f"{json.dumps(sass)}")
    times = {blk: t1_time(mesh_brute, b, feat, clusters, blk)
             for blk in T1_BLOCKS}
    tile_times = {blk: t1_time(mesh_brute, b, tile_feat, tile_cl, blk)
                  for blk in T1_BLOCKS}
    for t in list(times.values()) + list(tile_times.values()):
        log(f"  T1 tile {t['tile']} block {t['block']}: {t['ms']:.3f} ms "
            "(CUDA events, "
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
    mesh_brute.mesh_brute_tc_kernel.launches = 0
    bench = bench_kernel.run(RAYS, block=T1_BLOCK, reps=10)
    launches = mesh_brute.matmul_only_kernel.launches
    k1_launches = mesh_brute.mesh_brute_kernel.launches
    tc_launches = mesh_brute.mesh_brute_tc_kernel.launches
    if launches == 0 or k1_launches == 0 or tc_launches == 0:
        fail(f"bench_kernel: T1 launched {launches}, K1 {k1_launches}, "
             f"K1tc {tc_launches} times")
    log("  bench_kernel's precision sweep (mesh_intersect on the f32 table "
        "under each PRT_MESH_PRECISION name, CUDA events): " + "; ".join(
            f"{k} {v['ms']:.3f} ms" + (
                f", index agreement vs highest {v['index_agreement']:.6f}, "
                f"hit/miss flips {v['hit_miss_flips']}/{bench['rays']}"
                if k != "highest" else "")
            for k, v in bench["precision"].items()))
    bt = bench["bf16_table"]
    log(f"  bench_kernel's bf16 table: {bt['ms']:.3f} ms; against the f32 "
        f"table under highest: hit rate (f32) {bt['hit_rate_f32']:.4f}, index "
        f"agreement {bt['index_agreement']:.6f}, hit/miss flips "
        f"{bt['hit_miss_flips']}/{bench['rays']}, kernel t max |d| where both "
        f"hit {bt['t_max_abs_both_hit']:.3g}; launches K1tc {tc_launches}")
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
    return dict(launches=launches, k1_launches=k1_launches,
                tc_launches=tc_launches, err=max_abs,
                rel=rel, ms=t["ms"], plain_ms=p_ms, relevance_ms=r_ms,
                bound=t["bound"], by=t["by"], issue_floor=t["issue_floor"],
                by_block={str(k): v for k, v in times.items()},
                by_tile={str(T1_TILE): {str(k): v
                                        for k, v in tile_times.items()}},
                sass=sass,
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

# phase 13's spp (cut from 4 for the script's time)
SCAN_FB_SPP = 2


def phase_scan_fwd_bwd(dev, gpu_line, spp=SCAN_FB_SPP, seed=3):
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
# path C's fwd+bwd: E1 is held on the lanes of its backward calls with the
# most live lanes
E1_CALLS = 2
ENV_SIDE, ENV_CLI_SPP, ENV_FB_SPP = 1024, 8, 2
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
# path A's forward frames by regen, while and scan (8 before phase 27
# took their time)
SDF_SPP, SDF_FB_SPP = 2, 2


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
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk, envmap, intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    mesh_brute.mesh_brute_kernel.launches = 0
    envmap.bilinear_kernel.launches = 0
    envmap.bilinear_kernel.grad_launches = 0
    bvh_walk.bvh_walk_kernel.launches = 0
    tm.tonemap_kernel.launches = 0
    intersect.sdf_march.calls = 0
    intersect.sdf_march.steps = 0


def read_counts():
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk, envmap, intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    return dict(K1=mesh_brute.mesh_brute_kernel.launches,
                W1=bvh_walk.bvh_walk_kernel.launches,
                K2=tm.tonemap_kernel.launches,
                E1=envmap.bilinear_kernel.launches,
                E1_grad=envmap.bilinear_kernel.grad_launches,
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
    mesh_kernel = "W1" if cfg.mesh_accel == "bvh" else "K1"
    if cfg.has_mesh and counts[mesh_kernel] == 0:
        fail(f"{label}: {mesh_kernel} never launched")
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
        f"{a.mean():.6f}; K1 {counts['K1']}, W1 {counts['W1']}, K2 "
        f"{counts['K2']}, SDF marches "
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
    mk = "W1" if cfg.mesh_accel == "bvh" else "K1"
    if (counts["K1"], counts["W1"]) != (counts_fwd["K1"], counts_fwd["W1"]):
        fail(f"{label} fwd+bwd: a mesh kernel launched in the backward")
    if cfg.has_mesh and counts[mk] != pathtracer.scan_iterations(n_iters):
        fail(f"{label} fwd+bwd: {mk} {counts[mk]} != iterations")
    required = names if required is None else required
    for k, g in zip(names, grads):
        if g is not None and not bool(torch.isfinite(g).all()):
            fail(f"{label} fwd+bwd: non-finite gradient of {k}")
        if k in required and (g is None or float(g.abs().max()) == 0.0):
            fail(f"{label} fwd+bwd: the gradient of {k} is zero")
    out = dict(seconds=secs, forward_s=t_fwd, samples_per_s=w * w * spp / secs,
               iterations=n_iters, peak_gib=peak, forward_counts=counts_fwd,
               grad_max={k: float(g.abs().max()) for k, g in zip(names, grads)
                         if g is not None}, **counts)
    log(f"  {label} fwd+bwd {w}^2 x {spp} spp (regen_scan, {n_iters} "
        f"iterations): {secs:.3f} s (forward {t_fwd:.3f} s), "
        f"{out['samples_per_s']:.0f} samples/s, peak {peak:.2f} GiB, K1 "
        f"{counts['K1']}, W1 {counts['W1']} (none in the backward), SDF "
        "marches "
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


def phase_sdf(dev, gpu_line, spp=None, fb_spp=SDF_FB_SPP):
    """Path A (BASELINE config 3): sdf_demo.json (3 SDFs, a box, 8 bounces)
    with icosphere_hi as its mesh."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    w = FRAME
    spp = SDF_SPP if spp is None else spp
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


def phase_media(dev, gpu_line, spp=4, fb_spp=4):
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
            # the height fog's forward frames at a quarter of the spp, for
            # time (half before phase 27 took it; spp 4, was 8, since phase
            # 28)
            res = {"forward": path_forward(
                label, cfg, scene, cam, w,
                spp if medium == "homogeneous" else spp // 4, "regen",
                gpu_line, profile=first)[1]}
            if phase == "hg":
                # the height fog's paths are ~5x longer: a quarter of the
                # spp (its fwd+bwd is the script's longest step)
                res["fwd_bwd"] = path_fwd_bwd(
                    label, cfg, scene, cam, w,
                    fb_spp if medium == "homogeneous" else fb_spp // 4,
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
    env_map gradient, E1's launches counted in it and E1 held on the
    lanes of its E1_CALLS backward calls with the most live lanes
    (``e1_check``)."""
    import shutil
    import tempfile

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import envmap
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
        k = envmap.bilinear_kernel
        kept = []

        def keep(img, u, v, grad_out, need_map, need_uv):
            # the calls whose cotangents reach the most lanes (most are
            # dead: the count syncs the host each backward call)
            live = int((grad_out != 0).any(-1).sum())
            kept[:] = sorted(kept + [(live, (img, u, v, grad_out))],
                             key=lambda c: -c[0])[:E1_CALLS]
            return type(k).grad(k, img, u, v, grad_out, need_map, need_uv)

        k.grad = keep
        try:
            out["fwd_bwd"] = path_fwd_bwd(
                "C", cfg, scene, cam, ENV_SIDE, ENV_FB_SPP,
                ["env_map", "color", "camera.aperture_radius",
                 "camera.focal_distance"], gpu_line)
        finally:
            del k.grad
        fb = out["fwd_bwd"]
        out["e1"] = e1_check([c for _, c in kept], dict(
            forward=fb["forward_counts"]["E1"],
            recompute=fb["E1"] - fb["forward_counts"]["E1"],
            backward=fb["E1_grad"], cli=out["cli"]["E1"]))
        del kept
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


def e1_check(calls, launches, reps=20):
    """E1 (csrc/envmap.cu) on the lanes of path C's fwd+bwd, each kept call
    (the map, u, v and the cotangents its backward received): the lookup
    bit for bit the plain one's (``envmap.lookup_plain``); the map's
    gradient within 1e-6 of the plain autograd backward's, relative to its
    norm, and within 1e-5 per texel where the texel's gradient exceeds 1e-3
    of the largest; the gradients of u and v within 1e-5 of theirs plus
    1e-5 of their largest (tests/test_torch_cuda.py's limits).  Times by
    CUDA events on the call with the most live lanes: the lookup, the map's
    gradient (the zero fill and the kernel, as the grad cell asks), and
    the plain forward and backward; their bounds.  ``launches``: E1's
    launches counted in the fwd+bwd, by part."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import envmap
    k = envmap.bilinear_kernel
    if len(calls) != E1_CALLS or launches["backward"] == 0 or not all(
            bool((g != 0).any()) for *_, g in calls):
        fail(f"E1: {len(calls)} backward calls kept, {launches['backward']} "
             "backward launches counted, or a kept call with no live lane")
    res = dict(launches=launches, calls=[])
    for img, u, v, g in calls:
        img, u, v = (t.detach() for t in (img, u, v))
        if not torch.equal(k(img, u, v), envmap.lookup_plain(img, u, v)):
            fail("E1: the lookup is not the plain one's bit for bit")
        gm, gu, gv = k.grad(img, u, v, g, True, True)
        leaves = [t.clone().requires_grad_() for t in (img, u, v)]
        envmap.lookup_plain(*leaves).backward(g)
        wm, wu, wv = (t.grad for t in leaves)
        live = int((g != 0).any(-1).sum())
        if float(wm.norm()) == 0.0:
            norm_err = texel_err = float(gm.abs().max())
        else:
            norm_err = float((gm - wm).norm() / wm.norm())
            big = wm.abs() > 1e-3 * wm.abs().max()
            texel_err = float(((gm - wm).abs() / wm.abs())[big].max())
        uv_err = max(float(((a - b).abs() / (b.abs() + b.abs().max()))
                           .nan_to_num(0.0).max()) for a, b in ((gu, wu),
                                                                (gv, wv)))
        call = dict(lanes=int(u.shape[0]), live=live, map_norm_err=norm_err,
                    map_texel_err=texel_err, uv_err=uv_err)
        res["calls"].append(call)
        log(f"  E1 on a kept call, {call['lanes']} lanes ({live} live): the "
            f"lookup bit for bit; the map's gradient {norm_err:.2e} of its "
            f"norm (1e-6), {texel_err:.2e} a texel (1e-5); u and v "
            f"{uv_err:.2e} (1e-5)")
        if norm_err > 1e-6 or texel_err > 1e-5 or uv_err > 1e-5:
            fail(f"E1 against the plain lookup's autograd backward: {call}")
    img, u, v, g = max(calls, key=lambda c: int((c[3] != 0).any(-1).sum()))
    img, u, v = (t.detach() for t in (img, u, v))
    n, live, texels = u.shape[0], int((g != 0).any(-1).sum()), img.numel() // 3
    leaf = img.clone().requires_grad_()

    def plain():
        envmap.lookup_plain(leaf, u, v).backward(g)
        leaf.grad = None

    # bytes: (u, v) in and [N,3] out a lane, the map once; the gradient a
    # lane, a live lane's (u, v) and four taps' 12 B, the map zeroed
    res.update(
        lanes=n, live=live,
        ms=cuda_ms(lambda: k(img, u, v), reps),
        grad_ms=cuda_ms(lambda: k.grad(img, u, v, g, True, False), reps),
        plain_ms=cuda_ms(plain, 3))
    res["bound"], res["by"] = bound_ms(20 * n + 12 * texels, 0)
    res["grad_bound"], res["grad_by"] = bound_ms(
        12 * n + 56 * live + 12 * texels, 0)
    log(f"  E1 on {n} lanes ({live} live) of a {img.shape[1]}x{img.shape[0]} "
        f"map: lookup {res['ms']:.4f} ms (bound {res['bound']:.4f}), the "
        f"map's gradient {res['grad_ms']:.4f} ms (bound "
        f"{res['grad_bound']:.4f}), the plain forward and backward "
        f"{res['plain_ms']:.3f} ms (CUDA events); launches in the fwd+bwd "
        f"{launches}")
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


# ---------------------------------------------------------------------------
# phases 21-24: the BVH walk W1, the backend rule, the default path, BDPT
# ---------------------------------------------------------------------------

# W1's FP32 operations (an FMA counts 2): a slab test, the 6 slab distances
# (a difference and a product each) 12, the 6 per-axis min/max 6, entry and
# exit 6, the test 1; a triangle test, the 9 differences of e1, e2 and c,
# two crosses (3 products, 3 FMAs) 18, four dot products (a product, 2
# FMAs) 20, the reciprocal and its guard 4, u, v and t 3, w 2, the tests 5
W1_SLAB_FLOPS = 25
W1_TRI_FLOPS = 61
# a node visit reads its 32-byte row and its octant's 8-byte links; a leaf
# entered, its 144-byte row; a ray, its origin, direction, t_init and two
# flags, and writes t, tri, u and v
W1_VISIT_BYTES, W1_LEAF_BYTES, W1_RAY_BYTES = 40, 144, 46
# W1's CTA size (csrc/bvh_walk.cu THREADS) and a warp's lanes, for the
# occupancy and SIMT readings
W1_THREADS, W1_WARP = 128, 32
# W1's event timings (event_ms): launches a reading, and the sleep
# (~10 ms at the H100's clock) that keeps the card busy while the host
# queues them
W1_EVENT_REPS = 20
EVENT_SLEEP_CYCLES = 20_000_000
# --kernel-times: readings of each population, warm and flushed, a port
W1_TURN_REPEATS = 3
# phase 21's refill sweep: thresholds of idle lanes at which a warp
# refills, each a build of csrc/bvh_walk.cu (PRT_W1_REFILL)
W1_REFILL_SWEEP = (1, 2, 4, 8, 12, 16, 20, 24, 28, 32)
# the render path's instance of W1 (no counters) in ptxas's log
W1_RENDER_INSTANCE = "bvh_walk_kernelILb0"
# phase 21's edge batches: fewer rays than the lanes of one wave of CTAs
# (one CTA of 128 on each of the H100's 132 SMs is 16,896), and a batch
# past 2^21
W1_UNDER_WAVE = 5000
W1_HUGE = 2_000_003
# W1's bound has three terms, the largest of which it is: the bytes only
# device memory can give (the walk's tables once, the rays' own bytes) at
# HBM_BYTES_PER_S; every byte a visit, a leaf and a ray move, which the
# tables' re-reads take from the 50 MB L2, at the L2's read rate, which
# this run measures (L2_PROBE_SRC); the FP32 operations at
# FP32_FLOP_PER_S.  The probe reads a warm L2_PROBE_BYTES buffer
# L2_PROBE_PASSES times in one launch, 16 bytes a load cached in the L2
# alone (ld.global.cg, past the SMs' L1), from every SM; the rate is its
# bytes over its time, CUDA events over L2_PROBE_REPS launches
L2_PROBE_BYTES = 8 << 20
L2_PROBE_PASSES = 64
L2_PROBE_REPS = 20
L2_PROBE_SRC = r"""
#include <cuda_runtime.h>
__global__ void l2_probe_kernel(const float4* __restrict__ buf, int n4,
                                int passes, float* __restrict__ out) {
  int stride = gridDim.x * blockDim.x;
  int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.f;
#pragma unroll 4
  for (int p = 0; p < passes; ++p)
    for (int i = i0; i < n4; i += stride) {
      float4 v = __ldcg(buf + i);
      acc += v.x + v.y + v.z + v.w;
    }
  out[i0] = acc;
}
extern "C" int prt_l2_probe(const void* buf, int n4, int passes,
                            void* out, int blocks, void* stream) {
  l2_probe_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const float4*)buf, n4, passes, (float*)out);
  return (int)cudaGetLastError();
}
"""
# the crossover sweep: icosphere subdivisions (320 to 327,680 triangles),
# placed as cornell_hi's icosphere_hi.obj, as cornell.json's mesh
SWEEP_SUBDIVS = (2, 3, 4, 5, 6, 7)
SWEEP_MESH = dict(radius=1.2, center=(0.0, -0.8, 0.0))
SWEEP_REPS = 5
# phase 23: pixels of the walk's frame whose path met another winner than
# K1's (den-multiplied ties at grazing angles) may differ from phase 6's
# brute frame; at most this share of them
WALK_PARTED_PIXELS = 0.01
# phase 24: tests/test_bdpt.py's converged comparisons (scene, side, spp,
# seeds of the unidirectional and of the bidirectional estimate, bounds on
# the mean and on a pixel)
BDPT_CONVERGED = {
    "cornell_simple": ("scenes/cornell_simple.json", 10, 512, 3, 7, 0.03,
                       0.12),
    "multilight": ("scenes/multilight.json", 8, 1024, 3, 7, 0.06, None),
}
# phase 24: card against CPU, the bound on BDPT pixels that took the same
# decisions (|card - CPU| <= FWD_BDPT * (1 + |CPU|)).  A connection divides
# by the squared distance between the two vertices it joins and is weighted
# by ratios of area pdfs, which magnify an ulp of a ray.  Read by
# --bdpt-bound on an H100 (cornell.json + 5,120 triangles, 32^2 x 2 spp,
# depth 3): on seeds 3, 11 and 29 under each backend the largest clean
# reading was 8.64e-5 (seed 11, both backends; the others 3.5e-6 to
# 3.8e-6); with a fault planted in the card's leg, 0.32 (the far MIS patch
# dropped) and 0.35 (the near one), and a dropped strategy parted 516 of
# 1,024 pixels.  The bound sits 5.8x above the first and 650x below the
# second; it is the bound of tests/test_torch_grad.py's 32-bounce frames.
FWD_BDPT = 5e-4
# phase 24: camera, light and connection dispatches of one BDPT sample at
# the default depth cap 6: 7 camera vertices, 5 light vertices past the
# first, one merged connection batch
BDPT_DISPATCHES = 7 + 5 + 1


def same_bits(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def l2_rate(dev) -> dict:
    """The L2's read rate on this card, in bytes a second, by the probe of
    L2_PROBE_SRC (built here by nvcc) -> {"rate", "probe_ms", "bytes"}."""
    import ctypes

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    out_dir = os.path.join(_cuda.BUILD_DIR, f"l2_probe.{os.getpid()}")
    os.makedirs(out_dir, exist_ok=True)
    src, so = (os.path.join(out_dir, f"l2_probe.{x}") for x in ("cu", "so"))
    with open(src, "w") as fh:
        fh.write(L2_PROBE_SRC)
    res = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o",
                          so, src], capture_output=True, text=True,
                         timeout=600)
    if res.returncode != 0:
        fail(f"L2 probe: nvcc failed:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(so).prt_l2_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n4 = L2_PROBE_BYTES // 16
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count * 8
    buf = torch.rand(n4 * 4, device=dev)
    out = torch.empty(blocks * 256, device=dev)

    def launch():
        code = fn(buf.data_ptr(), n4, L2_PROBE_PASSES, out.data_ptr(),
                  blocks, torch.cuda.current_stream(dev).cuda_stream)
        if code:
            fail(f"L2 probe: launch failed ({code})")

    ms = cuda_ms(launch, L2_PROBE_REPS)
    if not torch.isfinite(out).all():
        fail("L2 probe: its sums are not finite")
    moved = L2_PROBE_BYTES * L2_PROBE_PASSES
    return dict(rate=moved / (ms * 1e-3), probe_ms=ms, bytes=moved)


def w1_bound(scene, b, counters, l2) -> dict:
    """W1's bound on batch ``b`` from its work counters (visits, leaves
    entered, triangle tests) and ``l2``'s rate: the largest of the HBM,
    L2 and FP32 terms (see L2_PROBE_BYTES), in ms."""
    import torch
    visits, leaf_visits, tests = counters
    n = b["origin"].shape[0]
    ray_bytes = n * W1_RAY_BYTES
    # the links of the octants this batch's active lanes walk, every node
    # and leaf row (which of them the walk reads is not counted)
    d = b["direction"][b["active"]] if b["active"] is not None \
        else b["direction"]
    octants = torch.unique(((d[:, 0] < 0).int() | ((d[:, 1] < 0).int() << 1)
                            | ((d[:, 2] < 0).int() << 2))).numel()
    n_nodes = scene.bvh_nodes.shape[0]
    table_bytes = (scene.bvh_nodes.numel() * 4 + octants * n_nodes * 8
                   + scene.leaf_verts.numel() * 4)
    terms = {
        "hbm": (table_bytes + ray_bytes) / HBM_BYTES_PER_S * 1e3,
        "l2": (visits * W1_VISIT_BYTES + leaf_visits * W1_LEAF_BYTES
               + ray_bytes) / l2["rate"] * 1e3,
        "fp32": (visits * W1_SLAB_FLOPS + tests * W1_TRI_FLOPS)
                / FP32_FLOP_PER_S * 1e3}
    top = max(terms, key=terms.get)
    return dict(bound=terms[top], by="operations" if top == "fp32"
                else "bytes", term=top, terms_ms=terms)


def ptxas_usage(build_log, function) -> dict:
    """``function``'s registers a thread and spill bytes from an nvcc
    ``-Xptxas=-v`` log ({} when the log holds no such entry; ptxas_entry),
    with the warps an SM holds at W1_THREADS a CTA by those registers (an
    SM's 65,536 registers, allocated 256 a warp at a time; at most 64
    warps)."""
    out = ptxas_entry(build_log, function)
    if "registers" in out:
        warp_regs = -(-out["registers"] * 32 // 256) * 256
        warps = W1_THREADS // 32
        ctas = 65536 // (warp_regs * warps)
        out["warps_per_sm"] = min(64, ctas * warps)
    return out


def ptxas_entry(build_log, function) -> dict:
    """``function``'s registers and spill bytes from ptxas's -v log ({}
    when the log holds no such entry)."""
    lines = build_log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and function in line:
            out = {}
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", nxt)
                if m:
                    out["spill_stores"], out["spill_loads"] = (int(m[1]),
                                                               int(m[2]))
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m[1])
                    break
            return out
    return {}


def event_ms(fn, reps: int, flush=None) -> dict:
    """Device milliseconds of one call of ``fn()``: a CUDA event pair
    around each of ``reps`` calls (each after ``flush()``, where given),
    all queued behind a ``torch.cuda._sleep`` of EVENT_SLEEP_CYCLES, so
    that the card never waits for the host's enqueue between them ->
    {"ms": mean, "min", "max"}.  One warm-up call first."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(EVENT_SLEEP_CYCLES)
    for start, end in pairs:
        if flush:
            flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    ms = [start.elapsed_time(end) for start, end in pairs]
    return dict(ms=sum(ms) / reps, min=min(ms), max=max(ms))


def warp_lockstep_steps(steps) -> int:
    """Sum over warps (W1_WARP consecutive lanes) of the warp's longest
    walk: the node steps a warp of one-thread-a-ray lanes issues."""
    import torch
    s = steps.to(torch.int64)
    pad = (-s.numel()) % W1_WARP
    if pad:
        s = torch.cat([s, s.new_zeros(pad)])
    return int(s.view(-1, W1_WARP).amax(dim=1).sum())


def w1_simt(got_steps, counters) -> dict:
    """SIMT efficiencies of W1's node loop and leaf branch on one launch:
    visits over W1_WARP x the warp node steps, and leaves entered over
    W1_WARP x the warp steps in which a lane entered a leaf.  "lockstep":
    the warp steps of W1_WARP consecutive lanes that each walk one ray
    (from the node visits a lane); "issued": the kernel's own counters of
    the warp steps it ran."""
    visits, leaves, _, wsteps, wleaf = counters
    lock = warp_lockstep_steps(got_steps)
    return dict(node_lockstep=visits / max(W1_WARP * lock, 1),
                node_issued=visits / max(W1_WARP * wsteps, 1),
                leaf_issued=leaves / max(W1_WARP * wleaf, 1),
                warp_steps_lockstep=lock, warp_steps_issued=wsteps,
                warp_leaf_steps_issued=wleaf)


def w1_check(name, scene, groups, problems):
    """W1 on ``groups``, a list of (batches, stream): each group's batches
    launched back to back (node visits and work counters on; on its
    stream where it names one, else the current one); then the twin once,
    on the card, over every batch of every group laid end to end (a lane's
    walk is its own: tests/test_torch_bvh.py holds the twin to that), so
    that its host syncs a node step are paid once.  0 mismatches in t,
    tri, u, v and visits per batch, and W1's visit, leaf and test counters
    summed over the batches equal to the twin's counts -> [(W1's outputs,
    its counters as ints, mismatches)] a batch, and the twin's host-clock
    ms."""
    import contextlib

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk, intersect
    nodes, links, leaves = scene.bvh_nodes, scene.bvh_links, scene.leaf_verts
    batches, runs = [], []
    for group, stream in groups:
        with torch.cuda.stream(stream) if stream else contextlib.nullcontext():
            for b in group:
                counters = torch.zeros(bvh_walk.W1_COUNTERS,
                                       dtype=torch.int64, device=scene.device)
                runs.append((bvh_walk.bvh_walk_kernel(
                    nodes, links, leaves, b["origin"], b["direction"],
                    b["t_init"], b["active"], b["any_hit"], count_steps=True,
                    counters=counters), counters))
                batches.append(b)
    torch.cuda.synchronize()
    twin_counters = torch.zeros(3, dtype=torch.int64, device=scene.device)
    cat = {k: torch.cat([b[k] for b in batches])
           for k in ("origin", "direction", "t_init", "any_hit", "active")}
    t0 = time.perf_counter()
    want = intersect._bvh_traverse_chunk(
        scene, cat["origin"], cat["direction"], cat["t_init"],
        cat["any_hit"], cat["active"], count_steps=True,
        counters=twin_counters)
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    sizes = [b["origin"].shape[0] for b in batches]
    want = [torch.split(x, sizes) for x in want]
    out, total = [], [0, 0, 0]
    for i, (got, counters) in enumerate(runs):
        bad = {k: int((x.view(torch.int32) != y[i].view(torch.int32)).sum())
               if x.dtype == torch.float32 else int((x != y[i]).sum())
               for k, x, y in zip(("t", "tri", "u", "v", "steps"), got, want)}
        if any(bad.values()):
            problems.append(f"W1 {name} batch {i}: mismatches against the "
                            f"twin {bad}")
        cnt = [int(x) for x in counters.tolist()]
        total = [a + b for a, b in zip(total, cnt)]
        out.append((got, cnt, bad))
    twin_cnt = [int(x) for x in twin_counters.tolist()]
    if total != twin_cnt:
        out[-1][2]["counters"] = 1
        problems.append(f"W1 {name}: counters {total} (visits, leaves, "
                        f"tests), the twin's {twin_cnt}")
    return out, twin_ms


def w1_compare(name, scene, b, problems, l2, flush=None):
    """One batch through W1 and the twin on the card (w1_check); W1's time
    by CUDA events over 10 launches of the render path's form, by event
    pairs behind a sleep (event_ms), warm and after an L2 flush, the
    twin's by the host clock (it syncs at every node step; under the
    profiler its ~10^5 launches take minutes), the SIMT efficiencies
    (w1_simt) and W1's bound from this batch's counters (w1_bound)."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk
    nodes, links, leaves = scene.bvh_nodes, scene.bvh_links, scene.leaf_verts
    args = (b["origin"], b["direction"], b["t_init"], b["active"],
            b["any_hit"])
    [(got, cnt, bad)], twin_ms = w1_check(name, scene, [([b], None)],
                                          problems)

    def launch():
        bvh_walk.bvh_walk_kernel(nodes, links, leaves, *args)

    ms = cuda_ms(launch, 10)
    ev = event_ms(launch, W1_EVENT_REPS)
    fl = event_ms(launch, W1_EVENT_REPS, flush) if flush else None
    n = b["origin"].shape[0]
    visits, leaf_visits, tests = cnt[:3]
    simt = w1_simt(got[4], cnt)
    wb = w1_bound(scene, b, (visits, leaf_visits, tests), l2)
    bound, by = wb["bound"], wb["by"]
    active = max(int(b["active"].sum()), 1)
    out = dict(n=n, ms=ms, events_ms=ev, flushed_ms=fl, simt=simt,
               plain_ms=twin_ms, bound=bound, by=by,
               bound_term=wb["term"], bound_terms_ms=wb["terms_ms"],
               visits_per_ray=visits / active,
               leaf_visits_per_ray=leaf_visits / active,
               tri_tests_per_ray=tests / active,
               max_visits=int(got[4].max()), hits=int((got[1] >= 0).sum()),
               mismatches=sum(bad.values()))
    log(f"  W1 {name}: N={n}, {ms:.4f} ms (CUDA events, 10 launches), twin "
        f"{twin_ms:.3f} ms (host clock, one call), bound {bound:.4f} ms "
        f"({wb['term']}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                        wb["terms_ms"].items())
        + f"; W1 {ms / bound:.2f}x it); {out['visits_per_ray']:.1f} node "
        f"visits, {out['leaf_visits_per_ray']:.2f} leaves entered, "
        f"{out['tri_tests_per_ray']:.2f} triangle tests an active ray (worst "
        f"lane {out['max_visits']} visits); {out['hits']} hits; mismatches "
        f"{bad}")
    log(f"    events behind a sleep: {ev['ms']:.4f} ms ({ev['min']:.4f}-"
        f"{ev['max']:.4f})" + (f", L2 flushed {fl['ms']:.4f} ms "
                               f"({fl['min']:.4f}-{fl['max']:.4f})"
                               if fl else "")
        + f"; SIMT node loop {simt['node_lockstep']:.3f} lockstep, "
        f"{simt['node_issued']:.3f} issued; leaf branch "
        f"{simt['leaf_issued']:.3f} issued ({simt['warp_steps_issued']} "
        f"warp steps, {simt['warp_leaf_steps_issued']} with a leaf)")
    return out, got


def w1_design() -> dict:
    """W1's refill threshold and rays a lane, as csrc/bvh_walk.cu sets
    them."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    with open(os.path.join(_cuda.CSRC_DIR, "bvh_walk.cu")) as fh:
        src = fh.read()
    return dict(
        refill_threshold=int(re.search(r"#define PRT_W1_REFILL (\d+)",
                                       src)[1]),
        block_rays_a_lane=int(re.search(r"BLOCK_RAYS = (\d+);", src)[1]))


def w1_edge_batches(scene, dev) -> dict:
    """W1's edge batches on ``scene``'s walk tables (phase 21: cornell_hi):
    {name: (the batches launched back to back, whether on a side stream)}.
    Rays start in the mesh's box at 1.5x its half size, 10% inactive, half
    of them any-hit, a fifth of t_init capped; the sizes 1, 31, 33, fewer
    rays than the lanes of one wave (W1_UNDER_WAVE), W1_HUGE; 90%
    inactive; a mix of any-hit lanes, NaN origins, directions and t_init,
    an infinite t_init and rays from the mesh's centre (inside it); two
    launches of other sizes back to back; a launch on a stream that is not
    the default."""
    import torch
    root = scene.bvh_nodes[0].cpu().numpy()
    mid, half = (root[0:3] + root[3:6]) / 2, (root[3:6] - root[0:3]) / 2
    rng = np.random.default_rng(2026)

    def batch(n, inactive=0.1):
        o = (mid + rng.uniform(-1.5, 1.5, (n, 3)) * half).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        t_init = np.where(rng.uniform(size=n) < 0.2,
                          rng.uniform(0.05, 3.0, n), 20.0).astype(np.float32)
        any_hit = rng.uniform(size=n) < 0.5
        active = rng.uniform(size=n) >= inactive
        if n <= 33:
            active[:] = True
            o[0] = mid  # from inside the mesh
        return dict(o=o, d=d, t_init=t_init, any_hit=any_hit, active=active)

    def mixed(n=65536):
        b = batch(n)
        i = np.arange(n)
        b["any_hit"] = i % 3 == 1
        b["o"][i % 8 == 2] = mid  # inside the icosphere
        b["o"][i % 64 == 5, 0] = np.nan
        b["d"][i % 64 == 9, 1] = np.nan
        b["d"][i % 64 == 13] = np.inf
        b["t_init"][i % 64 == 17] = np.nan
        b["t_init"][i % 64 == 21] = np.inf
        b["t_init"][i % 64 == 25] = 0.0
        return b

    def dev_batch(b):
        return dict(origin=torch.from_numpy(b["o"]).to(dev),
                    direction=torch.from_numpy(b["d"]).to(dev),
                    t_init=torch.from_numpy(b["t_init"]).to(dev),
                    any_hit=torch.from_numpy(b["any_hit"]).to(dev),
                    active=torch.from_numpy(b["active"]).to(dev))

    cases = {"n=1": ([batch(1)], False), "n=31": ([batch(31)], False),
             "n=33": ([batch(33)], False),
             f"n={W1_UNDER_WAVE} (under one wave)": ([batch(W1_UNDER_WAVE)],
                                                    False),
             f"n={W1_HUGE}": ([batch(W1_HUGE)], False),
             "90% inactive": ([batch(2 * RAYS, inactive=0.9)], False),
             "any-hit, NaN, inf, inside": ([mixed()], False),
             "back to back 100,003 then 37": ([batch(100003), batch(37)],
                                              False),
             "side stream": ([batch(65536)], True)}
    return {k: ([dev_batch(b) for b in bs], side)
            for k, (bs, side) in cases.items()}


def w1_edges(scene, dev, problems) -> dict:
    """W1 against the twin on w1_edge_batches (w1_check, one twin call for
    them all): mismatches a case."""
    import torch
    cases = w1_edge_batches(scene, dev)
    runs, twin_ms = w1_check("edges", scene, [
        (batches, torch.cuda.Stream(dev) if side else None)
        for batches, side in cases.values()], problems)
    out = {}
    for name, (batches, _) in cases.items():
        mine, runs = runs[:len(batches)], runs[len(batches):]
        out[name] = dict(n=[b["origin"].shape[0] for b in batches],
                         mismatches=sum(sum(r[2].values()) for r in mine),
                         hits=[int((r[0][1] >= 0).sum()) for r in mine])
        log(f"  W1 edge {name}: N={out[name]['n']}, hits {out[name]['hits']}, "
            f"mismatches {out[name]['mismatches']}")
    log(f"  W1 edges: the twin on all of them at once, {twin_ms:.1f} ms")
    return out


def w1_refill_sweep(scene, pops, reps=W1_EVENT_REPS) -> dict:
    """csrc/bvh_walk.cu built for each threshold of W1_REFILL_SWEEP (its
    PRT_W1_REFILL macro), the render path's instance (no counters) timed by
    event_ms on ``pops``, warm, each one's t, tri, u, v held bitwise against
    the kernel library's -> {threshold: {"registers", population: ms}}."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk
    built = nvcc_variants("bvh_walk.cu", "prt_bvh_walk",
                          {r: [f"-DPRT_W1_REFILL={r}"]
                           for r in W1_REFILL_SWEEP}, "w1_sweep")
    nodes, links, leaves = scene.bvh_nodes, scene.bvh_links, scene.leaf_verts
    table, wrong = {}, []
    for r, (fn, text) in built.items():
        table[r] = {"registers": ptxas_usage(text, W1_RENDER_INSTANCE)}
        for name, b in pops.items():
            n = b["origin"].shape[0]
            want = bvh_walk.bvh_walk_kernel(
                nodes, links, leaves, b["origin"], b["direction"],
                b["t_init"], b["active"], b["any_hit"])
            got = [torch.empty_like(x) for x in want]

            def launch(fn=fn, b=b, n=n, got=got):
                code = fn(nodes.data_ptr(), links.data_ptr(),
                          leaves.data_ptr(), nodes.shape[0],
                          b["origin"].data_ptr(), b["direction"].data_ptr(),
                          b["t_init"].data_ptr(), b["active"].data_ptr(),
                          b["any_hit"].data_ptr(), n,
                          *(x.data_ptr() for x in got), None, None,
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    fail(f"W1 sweep: REFILL {r} returned CUDA error {code}")
            launch()
            if not all(same_bits(g, w) for g, w in zip(got, want)):
                wrong.append((r, name))
            table[r][name] = event_ms(launch, reps)["ms"]
    log("  W1 refill sweep (event_ms, warm, ms a launch; registers): "
        + " | ".join(pops))
    for r, row in table.items():
        log(f"    REFILL {r:2d} {row['registers'].get('registers')}: "
            + " ".join(f"{row[k]:.4f}" for k in pops))
    if wrong:
        fail(f"W1 sweep: thresholds whose outputs differ {wrong}")
    return table


def regen_dispatch(cfg, scene, w, spp, call):
    """The merged batch the regen forward of ``scene`` at w^2 x spp, seed 0,
    sends to ``mesh_closest`` at its ``call``-th call (the render stops
    there), as a kernel's wrapper receives it."""
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
        if len(calls) == call:
            raise Captured(k1_batch(origin, direction, t_init, any_hit,
                                    active, exclude_tri))
        return real(cfg_, scene_, origin, direction, t_init, any_hit=any_hit,
                    active=active, exclude_tri=exclude_tri)

    intersect.mesh_closest = capture
    try:
        with torch.no_grad():
            pathtracer.render(cfg, scene, default_camera(w, w).pytree(
                scene.device), w, w, spp, seed=0, method="regen")
        fail(f"the regen render made fewer than {call} mesh calls")
    except Captured as got:
        return got.args[0]
    finally:
        intersect.mesh_closest = real


def phase_walk(dev):
    """Phase 21: W1 against its twin on the card, on the cornell_hi tables:
    phase 3's random, camera and surface populations (each a merged
    closest + any-hit batch of 524,288 lanes with inactive lanes and capped
    t_init) and the render population (the regen forward's RENDER_CALL-th
    merged batch through the walk)."""
    import dataclasses
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    log("[21] W1 bvh_walk.cu against its plain twin")
    t0 = time.perf_counter()
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    log(f"  cornell_hi loaded: {cfg.n_triangles} triangles, "
        f"{cfg.n_bvh_nodes} nodes, {scene.leaf_verts.shape[0]} leaves, "
        f"{time.perf_counter() - t0:.2f} s")
    pops = k1_populations(scene, dev)
    pops["render"] = regen_dispatch(
        dataclasses.replace(cfg, mesh_accel="bvh"), scene, FRAME, 8,
        RENDER_CALL)
    l2 = l2_rate(dev)
    log(f"  L2 probe: a warm {L2_PROBE_BYTES >> 20} MB buffer read "
        f"{L2_PROBE_PASSES} times in {l2['probe_ms']:.4f} ms: "
        f"{l2['rate']:.4g} B/s")
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    usage = {inst: ptxas_usage(_cuda.LIBRARY.build_log,
                               f"bvh_walk_kernelILb{i}")
             for i, inst in enumerate(("render", "counting"))}
    log(f"  W1's build, each instance: {usage}")
    flush = l2_flush(dev)
    problems, times = [], {}
    for name, b in pops.items():
        times[name], _ = w1_compare(name, scene, b, problems, l2, flush)
    edges = w1_edges(scene, dev, problems)
    if problems:
        fail("; ".join(problems))
    sweep = w1_refill_sweep(scene, pops)
    return times, dict(l2=l2, ptxas=usage, edges=edges, refill_sweep=sweep)


def phase_crossover(dev, gpu_line):
    """Phase 22: the whole ``mesh_closest`` call by each backend (brute: the
    ray sort where the loader sets it, K1, the winner's validation; bvh:
    W1) on icospheres of SWEEP_SUBDIVS as cornell.json's mesh, for a 512^2
    frame's camera rays and for the regen forward's RENDER_CALL-th merged
    batch; CUDA events over SWEEP_REPS calls, the backends in turns
    (brute, bvh, bvh, brute).  The regen batch is the one phase 3's render
    population is on cornell_hi (512^2 x 8 spp).  Brute runs up to 262,144
    triangles.  Returns the table and the 327,680-triangle scene for phase
    23."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene import loader
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

    log(f"[22] backend crossover: mesh_closest by K1 and by W1, on {gpu_line}")
    w = FRAME
    rows, big = [], None
    for sub in SWEEP_SUBDIVS:
        t0 = time.perf_counter()
        mesh = make_icosphere(sub, **SWEEP_MESH)
        cfg, scene = loader.build_scene(_doc("scenes/cornell.json"),
                                        mesh_override=mesh, device=dev)
        t_load = time.perf_counter() - t0
        n_tris = cfg.n_triangles
        backends = (("brute", "bvh")
                    if n_tris <= mesh_brute.BRUTE_STREAM_MAX_TRIS
                    else ("bvh",))
        cam = default_camera(w, w).pytree(dev)
        px, py = pathtracer.pixel_grid(w, w, dev)
        o, d = pathtracer.camera_rays_for_sample(cam, w, w, px, py,
                                                 py * w + px, 0, 0)
        batches = {
            "camera": k1_batch(o, d, 20.0, False, None, None),
            "regen dispatch": regen_dispatch(
                dataclasses.replace(cfg, mesh_accel=backends[0]), scene, w,
                8, RENDER_CALL)}
        for pop, b in batches.items():
            ms = {k: [] for k in backends}
            outs = {}

            def call(accel):
                return intersect.mesh_closest(
                    dataclasses.replace(cfg, mesh_accel=accel), scene,
                    b["origin"], b["direction"], b["t_init"],
                    any_hit=b["any_hit"], active=b["active"],
                    exclude_tri=b["exclude"] if accel == "brute" else None)

            with torch.no_grad():
                for accel in backends:
                    outs[accel] = call(accel)
                for accel in backends + tuple(reversed(backends)):
                    ms[accel].append(cuda_ms(lambda: call(accel),
                                             SWEEP_REPS))
            hits = {k: int((v[1] >= 0).sum()) for k, v in outs.items()}
            row = dict(triangles=n_tris, population=pop,
                       lanes=b["origin"].shape[0], hits=hits,
                       **{f"{k}_ms": sum(v) / len(v) for k, v in ms.items()})
            row["faster"] = (min(backends, key=lambda k: row[f"{k}_ms"])
                             if len(backends) > 1 else "bvh")
            rows.append(row)
            log(f"  {n_tris} triangles ({t_load:.1f} s to load), {pop}, "
                f"{row['lanes']} lanes: "
                + ", ".join(f"{k} {row[f'{k}_ms']:.4f} ms" for k in backends)
                + f" (hits {hits}); faster: {row['faster']}")
        if sub == SWEEP_SUBDIVS[-1]:
            big = (cfg, scene)
        else:
            del scene
    brute_wins = [r["triangles"] for r in rows if r["faster"] == "brute"]
    walk_wins = [r["triangles"] for r in rows if r["faster"] == "bvh"
                 and "brute_ms" in r]
    rule = {n: loader._pick_mesh_accel(n, dev)
            for n in sorted({r["triangles"] for r in rows})}
    agrees = all(rule[r["triangles"]] == r["faster"] for r in rows
                 if "brute_ms" in r)
    log(f"  brute faster at {sorted(set(brute_wins))} triangles, the walk at "
        f"{sorted(set(walk_wins))}; the loader's card rule ({rule}) "
        f"{'agrees' if agrees else 'DISAGREES'} with this sweep")
    return dict(rows=rows, rule=rule, rule_agrees=agrees), big


def walk_to_brute_index(scene):
    """[4L] int64: the brute tables' index of each leaf-major slot (-1 for a
    padding slot).  Both tables hold the triangles in BVH order, the leaves
    in preorder, each leaf a contiguous run."""
    import torch
    meta = scene.bvh_nodes[:, 7].contiguous().view(torch.int32).long()
    count = meta & 7
    count = count[count > 0]
    first = torch.cumsum(count, 0) - count
    slot = torch.arange(4, device=count.device)
    idx = first[:, None] + slot[None, :]
    return torch.where(slot[None, :] < count[:, None], idx, -1).reshape(-1)


def parted_pixels(cfg_walk, scene, cam, w, spp):
    """The walk's regen frame with every mesh dispatch also run through the
    brute backend on the same lanes (its exclusion mapped to the brute
    tables, as the brute frame would pass it) -> (the walk's image, a
    [w*w] mask of pixels whose path met another winner or occlusion in
    some dispatch).  A lane of the regen loop is a pixel; a merged batch
    is its pixels' closest lanes and then each shadow batch's."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
    from photorealistic_rendering_using_opencl_tpu_torch.ops.mesh_brute import (
        _lane_tensor,
    )
    n = w * w
    to_bf = walk_to_brute_index(scene)
    cfg_b = dataclasses.replace(cfg_walk, mesh_accel="brute")
    parted = torch.zeros(n, dtype=torch.bool, device=scene.device)
    real = intersect.mesh_closest

    def mapped(tri):
        return torch.where(tri >= 0, to_bf[tri.clamp(min=0).long()],
                           -1).to(torch.int32)

    def both(cfg_, scene_, origin, direction, t_init, any_hit=False,
             active=None, exclude_tri=None):
        out = real(cfg_, scene_, origin, direction, t_init, any_hit=any_hit,
                   active=active, exclude_tri=exclude_tri)
        ex = None if exclude_tri is None else mapped(exclude_tri)
        _, tri_b, _, _ = real(cfg_b, scene_, origin, direction, t_init,
                              any_hit=any_hit, active=active, exclude_tri=ex)
        tri_w = mapped(out[1])
        ah = _lane_tensor(any_hit, origin.shape[0], torch.bool,
                          origin.device, False)
        differ = torch.where(ah, (tri_w >= 0) != (tri_b >= 0), tri_w != tri_b)
        parted.logical_or_(differ.reshape(-1, n).any(0))
        return out

    intersect.mesh_closest = both
    try:
        with torch.no_grad():
            img, _ = pathtracer.render(cfg_walk, scene, cam, w, w, spp,
                                       seed=0, method="regen")
    finally:
        intersect.mesh_closest = real
    return img, parted


def phase_default_path(dev, gpu_line, brute_img, big):
    """Phase 23: cornell_hi with the card's backend pick at full width:
    forward regen 512^2 x 8 spp (the mesh kernel counted), held against
    phase 6's brute frame; fwd+bwd regen_scan 512^2 x 4 spp over every
    float leaf (the mesh kernel never in the backward); the traversal AOV
    (bitwise the CPU's on a 64^2 centre crop); and a forward regen of
    phase 22's 327,680-triangle icosphere."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    w = FRAME
    path = os.path.join(REPO, "scenes/cornell_hi.json")
    cfg, scene = load_scene(path, models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    log(f"[23] default path: cornell_hi ({cfg.n_triangles} triangles) with "
        f"the card's pick, mesh_accel={cfg.mesh_accel!r}")
    cam = default_camera(w, w).pytree(dev)
    out = {"mesh_accel": cfg.mesh_accel}
    img, out["forward"] = path_forward("default regen", cfg, scene, cam, w, 8,
                                       "regen", gpu_line, profile=True)
    if brute_img is None:
        with torch.no_grad():
            brute_img, _ = pathtracer.render(
                dataclasses.replace(cfg, mesh_accel="brute"), scene, cam, w,
                w, 8, seed=0, method="regen")
    if cfg.mesh_accel == "bvh":
        img2, parted = parted_pixels(cfg, scene, cam, w, 8)
        if not same_bits(img2, img):
            fail("the walk's frame changed when its dispatches were shadowed "
                 "by the brute backend")
        differ = (img.view(torch.int32) != brute_img.view(torch.int32)
                  ).any(-1).reshape(-1)
        stray = differ & ~parted
        out["against_brute"] = dict(
            pixels_differ=int(differ.sum()), parted=int(parted.sum()),
            unexplained=int(stray.sum()),
            max_diff=float((img - brute_img).abs().max()))
        log(f"  against phase 6's brute frame: {int(differ.sum())} pixels "
            f"differ, {int(parted.sum())} pixels met another winner than "
            f"K1's in some dispatch, {int(stray.sum())} differ without one; "
            f"every other pixel bitwise")
        if stray.any() or parted.float().mean() > WALK_PARTED_PIXELS:
            fail(f"default path: {int(stray.sum())} pixels differ from the "
                 f"brute frame with the same winners, {int(parted.sum())} "
                 "parted")
    elif not same_bits(img, brute_img):
        fail("default path (brute): the frame differs from phase 6's")
    leaves = [f.name for f in dataclasses.fields(scene)
              if getattr(scene, f.name).is_floating_point()]
    leaves += [f"camera.{k}" for k in cam]
    out["fwd_bwd"] = path_fwd_bwd("default", cfg, scene, cam, w, 4, leaves,
                                  gpu_line, required=("color", "obj_color"))

    # the traversal AOV: the frame through the entry point, and the counts
    # on a centre crop against the CPU's
    side, c = w, min(w, 64)
    y0 = x0 = (side - c) // 2
    reset_counts()
    with torch.no_grad():
        aov = pathtracer.render_aov(cfg, scene, cam, side, side, "traversal")
        px, py = pathtracer.pixel_grid(side, side, dev)
        o, d = pathtracer.camera_rays_for_sample(
            cam, side, side, px, py, py * side + px, 0, 0, jitter=False)
        counts = intersect.traversal_cost(cfg, scene, o, d)
    aov_counts = read_counts()
    cfg_c, scene_c = load_scene(path, models_dir=os.path.join(
        REPO, "scenes/assets"), device="cpu")
    ys, xs = torch.meshgrid(torch.arange(y0, y0 + c),
                            torch.arange(x0, x0 + c), indexing="ij")
    pxc, pyc = xs.reshape(-1), ys.reshape(-1)
    with torch.no_grad():
        oc, dc = pathtracer.camera_rays_for_sample(
            default_camera(side, side).pytree("cpu"), side, side, pxc, pyc,
            pyc * side + pxc, 0, 0, jitter=False)
        counts_cpu = intersect.traversal_cost(cfg_c, scene_c, oc, dc)
    crop = counts.reshape(side, side)[y0:y0 + c, x0:x0 + c].cpu().reshape(-1)
    if cfg_c.mesh_accel != cfg.mesh_accel:
        log(f"  (the CPU picks {cfg_c.mesh_accel!r} for this mesh)")
    if not torch.equal(crop, counts_cpu) or int(counts_cpu.max()) == 0:
        fail("traversal AOV: the crop's counts differ from the CPU's")
    if not bool(torch.isfinite(aov).all()):
        fail("traversal AOV: non-finite pixels")
    out["traversal"] = dict(frame_max=int(counts.max()),
                            crop_max=int(counts_cpu.max()), **aov_counts)
    log(f"  traversal AOV at {side}^2: counts max {int(counts.max())} "
        f"(W1 {aov_counts['W1']}, K1 {aov_counts['K1']} launches); the "
        f"{c}x{c} centre crop bitwise the CPU's (max {int(counts_cpu.max())})")

    cfg_big, scene_big = big
    _, out["big_mesh"] = path_forward(
        f"icosphere {cfg_big.n_triangles} triangles regen", cfg_big,
        scene_big, cam, w, 2, "regen", gpu_line)
    if cfg_big.mesh_accel != "bvh" or out["big_mesh"]["W1"] == 0:
        fail("the 327,680-triangle frame did not run through W1")
    return out, (cfg, scene)


def lanes_estimate(cfg, scene, w, spp, seed, method):
    """The image of render(method=...) at w^2 x spp from ONE batch of
    w*w*spp lanes, lane (sample, pixel): each lane's radiance is the one
    render's per-sample loop gives that (pixel, sample), the RNG being
    keyed on both; "bdpt" runs bidirectional.trace, "while"
    integrator.trace."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import (
        bidirectional, integrator, pathtracer,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    dev = scene.device
    px, py = pathtracer.pixel_grid(w, w, dev)
    pxl, pyl = px.repeat(spp), py.repeat(spp)
    sample = torch.arange(spp, device=dev).repeat_interleave(w * w)
    pixel = pyl * w + pxl
    o, d = pathtracer.camera_rays_for_sample(
        default_camera(w, w).pytree(dev), w, w, pxl, pyl, pixel, sample, seed)
    with torch.no_grad():
        if method == "bdpt":
            rad = bidirectional.trace(cfg, scene, o, d, pixel, sample,
                                      seed=seed)
        else:
            rad, _ = integrator.trace(cfg, scene, o, d, pixel, sample,
                                      seed=seed, method="while")
    return rad.reshape(spp, w, w, 3).mean(0)


def bdpt_decisions(cfg, scene, cam, w, spp, seed, depth):
    """render(method="bdpt") with every discrete decision of each sample
    recorded per pixel -> (image, [w*w, K] int64): the camera and light
    subpaths' valid flags and, at valid vertices, their mesh ids and
    specular and on-light flags, and for each connection whether it
    carries light (a candidate with a non-zero contribution) and, if so,
    its visibility.  Two runs whose rows differ at a pixel took another
    decision there."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import bidirectional, pathtracer
    rows = []
    real_stack = bidirectional._stack
    real_vis = bidirectional.connection_visible

    def stack(recs, pdf_rev):
        sp = real_stack(recs, pdf_rev)
        # a vertex past the end of its path carries whatever its dead ray
        # met, which no strategy reads: -1 there
        rows.extend([sp.valid] + [torch.where(sp.valid, x.to(torch.int64), -1)
                                  for x in (sp.mesh_id, sp.spec,
                                            sp.is_light)])
        return sp

    def vis(cfg_, scene_, conns):
        out = real_vis(cfg_, scene_, conns)
        # a connection that carries nothing (a zero contribution, e.g. the
        # back of the light) cannot change the pixel whatever its verdict
        live = [c.cand & (c.value != 0).any(-1) for c in conns]
        rows.extend([x[:, None] for x in live]
                    + [(x & v)[:, None] for x, v in zip(live, out)])
        return out

    bidirectional._stack, bidirectional.connection_visible = stack, vis
    try:
        with torch.no_grad():
            img, _ = pathtracer.render(cfg, scene, cam, w, w, spp, seed=seed,
                                       method="bdpt", bdpt_max_depth=depth)
    finally:
        bidirectional._stack = real_stack
        bidirectional.connection_visible = real_vis
    return img, torch.cat([r.to(torch.int64).cpu() for r in rows], dim=1)


def bdpt_card_vs_cpu(dev, build, w, spp, seed, depth, bound=FWD_BDPT,
                     parted_limit=FLIP_PIXELS, card_fault=None):
    """A BDPT frame of ``build(device) -> (cfg, scene, cam)`` on the card
    and on the CPU with its decisions recorded: pixels where they differ
    are left out (at most ``parted_limit`` of them), every other pixel
    within ``bound``.  ``reading`` is the least bound the kept pixels pass
    (their largest |card - CPU| / (1 + |CPU|)).  With ``card_fault`` (a
    name of BDPT_FAULTS) the card's leg runs with that fault planted and
    nothing fails: the readings are returned."""
    import contextlib

    import torch
    runs = {}
    for kind, d in (("card", dev), ("cpu", torch.device("cpu"))):
        cfg, scene, cam = build(d)
        with (plant_bdpt_fault(card_fault) if kind == "card" and card_fault
              else contextlib.nullcontext()):
            runs[kind] = bdpt_decisions(cfg, scene, cam, w, spp, seed, depth)
    (g, sig_g), (c, sig_c) = runs["card"], runs["cpu"]
    g = g.cpu()
    parted = (sig_g != sig_c).any(1).reshape(w, w)
    diff = (g - c).abs()
    beyond = (diff > bound + bound * c.abs()).any(-1)
    stray = beyond & ~parted
    kept = (diff / (1.0 + c.abs())).amax(-1)[~parted]
    out = dict(max_diff=float(diff.max()), beyond=int(beyond.sum()),
               parted=int(parted.sum()), unexplained=int(stray.sum()),
               kept_max_diff=float(diff[~parted].max()),
               reading=float(kept.max()) if kept.numel() else 0.0)
    if card_fault is None and (stray.any()
                               or parted.float().mean() > parted_limit):
        fail(f"BDPT card vs CPU: {int(stray.sum())} pixels beyond {bound} "
             f"with the same decisions, {int(parted.sum())} parted")
    return out


# --bdpt-bound: planted faults, each in the card's leg only.  "mis_patch":
# the MIS weights lose the camera-side junction patch (pdf_rev_pt read as
# 1); "mis_patch_far": the patch one vertex farther (pdf_rev_ptm);
# "strategy_dropped": the (s=1, t=2) strategy (next-event estimation at
# the first surface vertex) carries nothing
BDPT_FAULTS = ("mis_patch", "mis_patch_far", "strategy_dropped")
BDPT_BOUND_SEEDS = (3, 11, 29)


def plant_bdpt_fault(fault):
    """A context in which ``bidirectional._mis_weight`` carries ``fault``
    (one of BDPT_FAULTS)."""
    import contextlib

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import bidirectional
    real = bidirectional._mis_weight

    def faulty(cam, lig, s, t, pt, ptm, qs, qsm):
        if fault == "mis_patch":
            return real(cam, lig, s, t, torch.ones_like(pt), ptm, qs, qsm)
        if fault == "mis_patch_far":
            return real(cam, lig, s, t, pt, torch.ones_like(ptm), qs, qsm)
        w = real(cam, lig, s, t, pt, ptm, qs, qsm)
        return torch.zeros_like(w) if (s, t) == (1, 2) else w

    @contextlib.contextmanager
    def planted():
        bidirectional._mis_weight = faulty
        try:
            yield
        finally:
            bidirectional._mis_weight = real

    if fault not in BDPT_FAULTS:
        fail(f"unknown BDPT fault {fault}")
    return planted()


def bdpt_vs_cpu_scene(side):
    """phase 24's card-vs-CPU scene: cornell.json with a 5,120-triangle
    icosphere -> build(device, accel=None) -> (cfg, scene, cam), the
    backend the device's pick unless ``accel`` names one."""
    import dataclasses

    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
    from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
    mesh = make_icosphere(4, **SWEEP_MESH)

    def build(d, accel=None):
        c, sc = build_scene(_doc("scenes/cornell.json"), mesh_override=mesh,
                            device=d)
        if accel is not None:
            c = dataclasses.replace(c, mesh_accel=accel)
        return c, sc, default_camera(side, side).pytree(d)
    return build


def phase_bdpt_bound(dev):
    """--bdpt-bound: phase 24's card-vs-CPU comparison (32^2 x 2 spp, depth
    3) on BDPT_BOUND_SEEDS under both backends (the CPU leg the same
    backend), then with each of BDPT_FAULTS planted in the card's leg
    (the walk, the first seed): the readings FWD_BDPT sits between."""
    side, depth = 32, 3
    build = bdpt_vs_cpu_scene(side)
    out = {"clean": [], "faults": {}}
    log(f"[24b] BDPT card vs CPU readings (bound FWD_BDPT = {FWD_BDPT})")
    for accel in ("bvh", "brute"):
        for seed in BDPT_BOUND_SEEDS:
            t0 = time.perf_counter()
            r = bdpt_card_vs_cpu(dev, lambda d: build(d, accel), side, 2,
                                 seed, depth)
            r.update(accel=accel, seed=seed)
            out["clean"].append(r)
            log(f"  {accel} seed {seed}: reading {r['reading']:.3g}, "
                f"{r['parted']} parted, max diff {r['max_diff']:.3g} "
                f"({time.perf_counter() - t0:.1f} s)")
    for fault in BDPT_FAULTS:
        r = bdpt_card_vs_cpu(dev, lambda d: build(d, "bvh"), side, 2,
                             BDPT_BOUND_SEEDS[0], depth, card_fault=fault)
        out["faults"][fault] = r
        log(f"  planted {fault}: reading {r['reading']:.3g}, {r['parted']} "
            f"of {side * side} pixels parted, {r['beyond']} beyond the "
            f"bound, max diff {r['max_diff']:.3g}")
    clean = max(r["reading"] for r in out["clean"])
    caught = {f: r["reading"] > FWD_BDPT or r["parted"] > FLIP_PIXELS
              * side * side for f, r in out["faults"].items()}
    log(f"  largest clean reading {clean:.3g} (bound {FWD_BDPT}); faults "
        f"caught: {caught}")
    if clean > FWD_BDPT or not all(caught.values()):
        fail("FWD_BDPT does not sit between the clean and faulted readings")
    return out


def phase_bdpt(dev, gpu_line, hi):
    """Phase 24: BDPT.  cornell_hi (``hi``: phase 23's scene, the card's
    backend) at 512^2 x 8 spp with the default depth, tonemapped (K2), the
    mesh kernel counted (BDPT_DISPATCHES a sample) and the idle share of 1
    spp; the same through K1 (brute) at 256^2 x 2 spp; cornell_simple and
    multilight converged against the unidirectional tracer at
    tests/test_bdpt.py's sizes, spp, seeds and bounds (each estimate one
    batch of pixel x sample lanes); card against CPU at 32^2, depth 3, on
    cornell.json with a 5,120-triangle icosphere (the walk on both)."""
    import dataclasses
    import warnings

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    log("[24] BDPT")
    out = {}
    cfg, scene = hi
    w = FRAME
    cam = default_camera(w, w).pytree(dev)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the depth cap's truncation note
        _, out["cornell_hi"] = path_forward(
            f"BDPT cornell_hi ({cfg.mesh_accel})", cfg, scene, cam, w, 8,
            "bdpt", gpu_line, profile=True)
        mk = "W1" if cfg.mesh_accel == "bvh" else "K1"
        if out["cornell_hi"][mk] != BDPT_DISPATCHES * 8:
            fail(f"BDPT: {mk} {out['cornell_hi'][mk]} launches, not "
                 f"{BDPT_DISPATCHES} a sample")
        cfg_b = dataclasses.replace(cfg, mesh_accel="brute")
        cam_s = default_camera(256, 256).pytree(dev)
        _, out["cornell_hi_brute"] = path_forward(
            "BDPT cornell_hi (brute)", cfg_b, scene, cam_s, 256, 2, "bdpt",
            gpu_line)
        if out["cornell_hi_brute"]["K1"] != BDPT_DISPATCHES * 2:
            fail(f"BDPT (brute): K1 {out['cornell_hi_brute']['K1']} "
                 f"launches, not {BDPT_DISPATCHES} a sample")

    for name, (path, side, spp, s_pt, s_bd, mean_rel, pixel_max) in \
            BDPT_CONVERGED.items():
        c, sc = load_scene(os.path.join(REPO, path), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pt = lanes_estimate(c, sc, side, spp, s_pt, "while")
        bd = lanes_estimate(c, sc, side, spp, s_bd, "bdpt")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rel = abs(float(pt.mean()) - float(bd.mean())) / float(pt.mean())
        px_max = float((pt - bd).abs().max())
        finite = bool(torch.isfinite(bd).all()) and bool((bd >= 0).all())
        out[name] = dict(mean_pt=float(pt.mean()), mean_bdpt=float(bd.mean()),
                         rel=rel, pixel_max=px_max, seconds=secs)
        log(f"  {name} {side}^2 x {spp} spp: unidirectional mean "
            f"{float(pt.mean()):.6f} (seed {s_pt}), BDPT {float(bd.mean()):.6f} "
            f"(seed {s_bd}): rel {rel:.4f} (bound {mean_rel}), worst pixel "
            f"{px_max:.4f}" + (f" (bound {pixel_max})" if pixel_max else "")
            + f"; {secs:.2f} s for both")
        if rel >= mean_rel or not finite or (
                pixel_max is not None and px_max >= pixel_max):
            fail(f"BDPT {name}: not converged to the unidirectional tracer")

    side, depth = 32, 3
    accel = {}
    build_any = bdpt_vs_cpu_scene(side)

    def build(d):
        c, sc, cam_ = build_any(d)
        accel[d.type] = c.mesh_accel
        return c, sc, cam_

    out["card_vs_cpu"] = r = bdpt_card_vs_cpu(dev, build, side, 2, 3, depth)
    log(f"  card ({accel['cuda']}) against CPU ({accel['cpu']}), "
        f"cornell.json + 5,120 triangles, {side}^2 x 2 spp, depth {depth}, "
        f"every decision recorded: {r['parted']} pixels took another "
        f"decision (left out), {r['beyond']} beyond {FWD_BDPT}, the kept "
        f"pixels' max diff {r['kept_max_diff']:.3g}")
    return out


# ---------------------------------------------------------------------------
# phase 25: several ranks (parallel/)
# ---------------------------------------------------------------------------

# the sharded frame (a, b) and the train step (c)
SHARD_SIDE, SHARD_SPP = 512, 8
TRAIN_SIDE, TRAIN_TARGET = 256, 0.2
SHARD_RANKS = 2


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cornell_hi(dev):
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    return load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                      models_dir=os.path.join(REPO, "scenes/assets"),
                      device=dev)


def _shard_work(dev, cfg, scene):
    """This rank's part of the sharded frame and of one train step, each
    counted and timed (host clock to a sync) -> (readings, (hdr, alpha),
    (the step's loss, colour and medium_sigma_t))."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.parallel.render import (
        PARAM_LEAVES, make_train_step, render_sharded,
    )
    cam = default_camera(SHARD_SIDE, SHARD_SIDE).pytree(dev)
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    img, alpha = render_sharded(cfg, scene, cam, SHARD_SIDE, SHARD_SIDE,
                                SHARD_SPP)
    _sync(dev)
    out = dict(render_s=time.perf_counter() - t0,
               render_W1=read_counts()["W1"])
    tcam = default_camera(TRAIN_SIDE, TRAIN_SIDE).pytree(dev)
    step = make_train_step(cfg, TRAIN_SIDE, TRAIN_SIDE, 1)
    target = torch.full((TRAIN_SIDE * TRAIN_SIDE, 3), TRAIN_TARGET,
                        device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    _sync(dev)
    t0 = time.perf_counter()
    loss, s2 = step(scene, tcam, target, 0)
    _sync(dev)
    out.update(step_s=time.perf_counter() - t0, step_W1=read_counts()["W1"],
               loss=float(loss),
               grad_allreduce_bytes=4 * sum(getattr(scene, k).numel()
                                            for k in PARAM_LEAVES),
               step_peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                              if dev.type == "cuda" else float("nan")))
    return out, (img, alpha), (s2.color, s2.medium_sigma_t)


def _sharded_rank(rank, world, init, out_dir, device="cuda"):
    """One of phase 25's subprocess ranks (spawned): gloo, since its card
    is shared; its readings, step and (rank 0) frame pickled to out_dir."""
    import pickle

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize(init, world, rank, device=device)
    try:
        dev = distributed.rank_device(device)
        cfg, scene = _cornell_hi(dev)
        out, (img, alpha), (color, sigma) = _shard_work(dev, cfg, scene)
        out.update(backend=torch.distributed.get_backend(),
                   mesh_accel=cfg.mesh_accel)
        res = dict(out=out, color=color.cpu().numpy(),
                   sigma=sigma.cpu().numpy())
        if rank == 0:
            res.update(img=img.cpu().numpy(), alpha=alpha.cpu().numpy())
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        torch.distributed.destroy_process_group()


def phase_sharded(dev, gpu_line):
    """Phase 25: parallel/ on the card.  (a) One rank over NCCL: the
    sharded cornell_hi frame (W1 by the card's pick) bitwise
    ``trace_regen`` of the whole frame in this process, and one train step.
    (b) SHARD_RANKS subprocess ranks on this one card over gloo (NCCL
    refuses two ranks on one GPU; the shards go through host memory): the
    same frame, bitwise (a)'s.  (c) The train step on 1 and SHARD_RANKS
    ranks: the updated colour and medium_sigma_t bitwise, the losses within
    1e-6.  The ranks of (b) share the card: their times are not a scaling
    number."""
    import pickle
    import tempfile

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed

    cfg, scene = _cornell_hi(dev)
    log(f"[25] several ranks: cornell_hi ({cfg.n_triangles} triangles, "
        f"mesh_accel={cfg.mesh_accel!r}), {SHARD_SIDE}^2 x {SHARD_SPP} spp "
        f"sharded; train step {TRAIN_SIDE}^2 x 1 spp")
    with tempfile.TemporaryDirectory() as d:
        distributed.initialize("file://" + os.path.join(d, "one"), 1, 0,
                               device=str(dev))
        try:
            backend = torch.distributed.get_backend()
            one, (img, alpha), (color1, sigma1) = _shard_work(dev, cfg, scene)
        finally:
            torch.distributed.destroy_process_group()
        cam = default_camera(SHARD_SIDE, SHARD_SIDE).pytree(dev)
        px, py = pathtracer.pixel_grid(SHARD_SIDE, SHARD_SIDE, dev)
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad():
            rad, a = pathtracer.trace_regen(cfg, scene, cam, SHARD_SIDE,
                                            SHARD_SIDE, SHARD_SPP, px, py, 0)
        _sync(dev)
        plain_s = time.perf_counter() - t0
        plain_w1 = read_counts()["W1"]
        if not (same_bits(img, rad.reshape(img.shape))
                and same_bits(alpha, a.reshape(alpha.shape))):
            fail("sharded (1 rank): the frame is not bitwise trace_regen's")
        if min(one["render_W1"], one["step_W1"]) == 0:
            fail(f"sharded (1 rank): W1 never launched ({one})")
        log(f"  (a) 1 rank over {backend}: render_sharded {one['render_s']:.3f}"
            f" s (W1 {one['render_W1']}), trace_regen of the whole frame "
            f"{plain_s:.3f} s (W1 {plain_w1}), bitwise; train step "
            f"{one['step_s']:.3f} s (W1 {one['step_W1']}), loss "
            f"{one['loss']:.9g}, peak {one['step_peak_gib']:.2f} GiB, "
            f"gradient all-reduce {one['grad_allreduce_bytes']} bytes; on "
            f"{gpu_line}")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = torch.multiprocessing.start_processes(
            _sharded_rank, nprocs=SHARD_RANKS, join=False,
            start_method="spawn",
            args=(SHARD_RANKS, "file://" + os.path.join(d, "many"), d,
                  str(dev)))
        while not ctx.join():
            pass
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    r0 = ranks[0]
    if not (same_bits(torch.from_numpy(r0["img"]), img.cpu())
            and same_bits(torch.from_numpy(r0["alpha"]), alpha.cpu())):
        fail(f"sharded ({SHARD_RANKS} ranks): the frame is not bitwise the "
             "1-rank frame")
    for r, res in enumerate(ranks):
        o = res["out"]
        if min(o["render_W1"], o["step_W1"]) == 0 or o["mesh_accel"] != "bvh":
            fail(f"sharded rank {r}: W1 never launched ({o})")
        if not (np.array_equal(res["color"], color1.cpu().numpy())
                and np.array_equal(res["sigma"], sigma1.cpu().numpy())):
            fail(f"train step: rank {r} of {SHARD_RANKS}'s update is not "
                 "bitwise the 1-rank update")
        if abs(o["loss"] - one["loss"]) > 1e-6:
            fail(f"train step: loss {o['loss']} on {SHARD_RANKS} ranks, "
                 f"{one['loss']} on 1")
    many = [res["out"] for res in ranks]
    log(f"  (b, c) {SHARD_RANKS} ranks over {many[0]['backend']} sharing "
        f"this one card (time-shared: not a scaling number): render_sharded "
        + ", ".join(f"{o['render_s']:.3f}" for o in many)
        + " s by rank (W1 " + ", ".join(str(o["render_W1"]) for o in many)
        + "), frame bitwise (a)'s; train step "
        + ", ".join(f"{o['step_s']:.3f}" for o in many) + " s by rank, loss "
        f"{many[0]['loss']:.9g} (1 rank {one['loss']:.9g}), update bitwise the "
        f"1-rank one; {wall:.1f} s with the ranks' start; on {gpu_line}")
    return dict(one_rank=dict(backend=backend, plain_trace_regen_s=plain_s,
                              plain_W1=plain_w1, **one),
                ranks=many, ranks_wall_s=wall)


# ---------------------------------------------------------------------------
# phase 26: trace_regen_scan(remat="segment") and the north star
# ---------------------------------------------------------------------------

# (a) body against segment with the card's pick, (b) with K1 pinned, (c)
# the north star by tools.northstar (REMAT_SPP etc. set the work; widths
# are never cut; for the script's time (a) cut from 4 spp to 2, (c) from
# 4 to 2 and then to 1)
REMAT_SIDE, REMAT_SPP = 512, 2
REMAT_K1_SIDE, REMAT_K1_SPP = 256, 2
NORTH_SIDE, NORTH_SPP, NORTH_TILES = 1024, 1, 4


def _reset_peak(dev):
    import torch
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev):
    import torch
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def remat_fwd_bwd(cfg, scene, cam, w, spp, n_iters, remat, seed=3):
    """One fwd+bwd of mean(image) through trace_regen_scan(remat=...) over
    every float leaf of the scene and the camera -> the image, alpha,
    completed, the gradients by leaf, the mesh kernels' launches in each
    pass, seconds (forward and whole) and peak memory."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    dev = scene.device
    sc, camg, params = _grad_leaves(scene, cam)
    leaves = {**{f"scene.{k}": v for k, v in params.items()},
              **{f"camera.{k}": v for k, v in camg.items()}}
    px, py = pathtracer.pixel_grid(w, w, dev)
    _reset_peak(dev)
    reset_counts()
    t0 = time.perf_counter()
    acc, alpha, done = pathtracer.trace_regen_scan(
        cfg, sc, camg, w, w, spp, px, py, seed, n_iters, remat=remat)
    loss = acc.mean()
    _sync(dev)
    t_fwd = time.perf_counter() - t0
    fwd = read_counts()
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    _sync(dev)
    secs = time.perf_counter() - t0
    total = read_counts()
    return dict(img=acc.detach(), alpha=alpha.detach(), completed=int(done),
                grads={k: torch.zeros_like(x) if g is None else g
                       for (k, x), g in zip(leaves.items(), grads)},
                forward={k: fwd[k] for k in ("K1", "W1")},
                backward={k: total[k] - fwd[k] for k in ("K1", "W1")},
                seconds=secs, forward_s=t_fwd, peak_gib=_peak_gib(dev))


def remat_pair(label, cfg, scene, cam, w, spp, gpu_line, seed=3):
    """One fwd+bwd by remat="body", then one by "segment": completed ==
    spp, the mesh kernel once an iteration in the forward and never in
    the backward, the images and every gradient leaf bitwise equal."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    n_iters = pathtracer.calibrate_regen_iters(cfg, scene, cam, w, w, spp,
                                               seed=seed)
    iters = pathtracer.scan_iterations(n_iters)
    mk = "W1" if cfg.mesh_accel == "bvh" else "K1"
    runs = {}
    for remat in ("body", "segment"):
        r = runs[remat] = remat_fwd_bwd(cfg, scene, cam, w, spp, n_iters,
                                        remat, seed)
        if r["completed"] != spp:
            fail(f"{label} {remat}: completed {r['completed']} of {spp}")
        if r["forward"][mk] != iters or any(r["backward"].values()):
            fail(f"{label} {remat}: mesh launches forward {r['forward']}, "
                 f"backward {r['backward']}; want {mk} {iters} and none")
        bad = [k for k, g in r["grads"].items()
               if not bool(torch.isfinite(g).all())]
        if bad or float(r["grads"]["scene.color"].abs().max()) == 0.0:
            fail(f"{label} {remat}: gradients non-finite {bad} or zero colour")
    body, seg = runs["body"], runs["segment"]
    if not (same_bits(seg["img"], body["img"])
            and same_bits(seg["alpha"], body["alpha"])):
        fail(f"{label}: segment's image is not bitwise body's")
    parted = {k: float((seg["grads"][k] - g).abs().max())
              for k, g in body["grads"].items()
              if not same_bits(seg["grads"][k], g)}
    if parted:
        fail(f"{label}: segment's gradients are not bitwise body's: {parted}")
    out = dict(mesh_accel=cfg.mesh_accel, iterations=n_iters,
               scan_iterations=iters, width=w, spp=spp)
    for remat, r in runs.items():
        out[remat] = {k: r[k] for k in ("seconds", "forward_s", "peak_gib",
                                         "forward", "backward")}
    log(f"  {label}: {w}^2 x {spp} spp fwd+bwd, {n_iters} iterations "
        f"({iters} run), {cfg.mesh_accel}: body {body['seconds']:.3f} s "
        f"(forward {body['forward_s']:.3f}), peak {body['peak_gib']} GiB; "
        f"segment {seg['seconds']:.3f} s (forward {seg['forward_s']:.3f}), "
        f"peak {seg['peak_gib']} GiB; {mk} {iters} in each forward, none in "
        f"either backward; image and {len(body['grads'])} gradient leaves "
        f"bitwise; on {gpu_line}")
    return out


def phase_remat(dev, gpu_line, side=REMAT_SIDE, spp=REMAT_SPP,
                k1_side=REMAT_K1_SIDE, k1_spp=REMAT_K1_SPP,
                north=(NORTH_SIDE, NORTH_SPP, NORTH_TILES)):
    """Phase 26: (a) body against segment on cornell_hi with the card's
    pick; (b) the same with K1 pinned; (c) tools.northstar's value and
    gradients on cornell_hi, by NORTH_TILES bands and direct, once each,
    the bands' sum held to the direct gradients (northstar.check_tiled)."""
    from photorealistic_rendering_using_opencl_tpu_torch.models import (
        integrator, pathtracer,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.tools import northstar
    log("[26] trace_regen_scan(remat='segment') and the north star, "
        "cornell_hi")
    cfg, scene = _cornell_hi(dev)
    # a first fwd+bwd pays one-time costs (lazy loading of the backward's
    # CUDA kernels): one small one by each mode first, untimed
    warm = max(side // 8, 8)
    for remat in ("body", "segment"):
        remat_fwd_bwd(cfg, scene, default_camera(warm, warm).pytree(dev),
                      warm, 1, 3 * integrator.SCAN_CHUNK, remat)
    out = {"a": remat_pair("(a) body against segment", cfg, scene,
                           default_camera(side, side).pytree(dev), side, spp,
                           gpu_line)}
    os.environ["PRT_MESH_ACCEL"] = "brute"
    try:
        cfg_b, scene_b = _cornell_hi(dev)
    finally:
        del os.environ["PRT_MESH_ACCEL"]
    out["b"] = remat_pair("(b) K1 pinned", cfg_b, scene_b,
                          default_camera(k1_side, k1_side).pytree(dev),
                          k1_side, k1_spp, gpu_line)
    del cfg_b, scene_b
    w, nspp, tiles = north
    cam = default_camera(w, w).pytree(dev)
    n_iters = northstar.calibrate(cfg, scene, cam, w, nspp)
    mk = "W1" if cfg.mesh_accel == "bvh" else "K1"
    res, c = {}, {"mesh_accel": cfg.mesh_accel, "iterations": n_iters}
    for label, t in ((f"tiled x{tiles}", tiles), ("direct", 1)):
        _reset_peak(dev)
        reset_counts()
        t0 = time.perf_counter()
        res[label] = northstar.value_and_grads(cfg, scene, cam, w, nspp,
                                               n_iters, t)
        _sync(dev)
        r = res[label]
        c[label] = dict(seconds=time.perf_counter() - t0,
                        peak_gib=_peak_gib(dev), completed=r["completed"],
                        launches=r["launches"], loss=r["loss"])
        if min(r["completed"]) != nspp:
            fail(f"(c) north star {label}: completed {r['completed']}")
        if (r["launches"]["forward"][mk]
                != t * pathtracer.scan_iterations(n_iters)
                or any(r["launches"]["backward"].values())):
            fail(f"(c) north star {label}: launches {r['launches']}")
        log(f"  (c) north star {label}: {w}^2 x {nspp} spp fwd+bwd, "
            f"{n_iters} iterations: {c[label]['seconds']:.3f} s, peak "
            f"{c[label]['peak_gib']} GiB, {mk} {r['launches']['forward'][mk]} "
            f"forward / {r['launches']['backward'][mk]} backward, completed "
            f"{r['completed']}; on {gpu_line}")
    gap = northstar.tiled_gap(res[f"tiled x{tiles}"], res["direct"])
    worst = max(gap["grads"], key=gap["grads"].get)
    c["tiled_vs_direct"] = gap
    log(f"  (c) the bands' sum against direct: loss {gap['loss']:.3g}, "
        f"largest leaf gap {gap['grads'][worst]:.3g} of its largest entry "
        f"({worst}"
        + (f"; {gap['camera'][worst]:.3g} of the camera's"
           if worst in gap["camera"] else "")
        + f"; bounds {northstar.TILED_LOSS_REL}, {northstar.TILED_GRAD_REL})")
    try:
        northstar.check_tiled(gap)
    except RuntimeError as e:
        fail(f"(c) {e}")
    out["c"] = c
    return out


# ---------------------------------------------------------------------------
# phase 27: the graft hook (graft.py) and the bounce-level tools
# ---------------------------------------------------------------------------

# card against CPU for graft.entry()'s fn at its scene's 32 bounces:
# tests/test_torch_render.py's bound there, rtol = atol
GRAFT_TOL = 5e-4
# phase 27's sizes of the tools (their defaults are for --tools)
TOOL_SIZES = dict(bounces_width=256, lanes=(16384, 65536), trace_lanes=65536,
                  trace_steps=2, bwd_width=32, bwd_spp=1,
                  bwd_variants=("all", "nosan"))
TOOL_KEYS = {
    "bounces": {"bounce", "ms", "alive", "alive_frac"},
    "bounce_parts": {"lanes", "name", "ms", "device_ms", "kernels"},
    "trace_bounce": {"ms", "name", "calls"},
    "bisect_bounce": {"name", "ms", "device_ms", "kernels"},
    "profile_floor": {"lanes", "name", "ms", "device_ms", "kernels"},
    "bwd_anatomy": {"variant", "iters", "chunk", "best", "fwd", "bwd",
                    "rate", "temp", "compile"},
    "spmd_audit": {"counts", "bytes", "total_collectives", "program",
                   "n_devices", "padded_pixels"},
}


def tool_rows(name, run, *args):
    """A port tool's ``run`` in this process, its JSON lines logged with
    the tool's name in front -> (its rows, seconds)."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rows = run(*args)
    secs = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        log(f"  {name}: {line}")
    return rows, secs


def graft_card_vs_cpu(dev, gpu_line):
    """(a) graft.entry()'s fn on the card (W1 by the card's pick) against
    the same fn on the CPU."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch import graft
    cfg, _ = graft.tiny_scene(dev)
    if cfg.mesh_accel != "bvh":
        fail(f"graft: the card picked {cfg.mesh_accel!r}, not the walk")
    fn, args = graft.entry(dev)
    with torch.no_grad():
        fn(*args)  # warm-up
        reset_counts()
        _sync(dev)
        t0 = time.perf_counter()
        got = fn(*args)
        _sync(dev)
        secs = time.perf_counter() - t0
        counts = read_counts()
        cpu_fn, cpu_args = graft.entry("cpu")
        want = cpu_fn(*cpu_args)
    g, c = got.cpu(), want
    if g.shape != (graft.WIDTH * graft.HEIGHT, 3) or not bool(
            torch.isfinite(g).all()):
        fail(f"graft: radiance of shape {tuple(g.shape)} not all finite")
    if counts["W1"] == 0 or counts["K1"]:
        fail(f"graft: the fn did not run through W1 alone ({counts})")
    diff = (g - c).abs()
    beyond = (diff > GRAFT_TOL + GRAFT_TOL * c.abs()).any(-1)
    mean_rel = abs(float(g.mean()) / float(c.mean()) - 1.0)
    log(f"  (a) graft.entry(): {graft.WIDTH}^2 x 1 spp on the card in "
        f"{secs:.3f} s (W1 {counts['W1']}, K1 {counts['K1']}); against the "
        f"CPU's fn (brute twin): {int(beyond.sum())} of {beyond.numel()} "
        f"pixels beyond {GRAFT_TOL} (limit {GOLDEN_PARTED} of them), max diff "
        f"{float(diff.max()):.3g}, mean rel {mean_rel:.3g} (limit "
        f"{HI_MEAN_REL}); on {gpu_line}")
    if float(beyond.float().mean()) > GOLDEN_PARTED or mean_rel > HI_MEAN_REL:
        fail(f"graft: card against CPU, {int(beyond.sum())} pixels beyond "
             f"{GRAFT_TOL}, mean rel {mean_rel:.3g}")
    return dict(seconds=secs, W1=counts["W1"], beyond=int(beyond.sum()),
                max_diff=float(diff.max()), mean_rel=mean_rel)


def check_tool_rows(name, rows, keys):
    """Every row of a tool but its last (the device's) has ``keys``; the
    last names the card."""
    import torch
    body = [r for r in rows[:-1] if keys <= set(r)]
    if not body:
        fail(f"tools.{name}: no row with the keys {sorted(keys)}")
    if rows[-1].get("device") != torch.cuda.get_device_name(0):
        fail(f"tools.{name}: its last row names {rows[-1].get('device')}")
    return body


def phase_graft_tools(dev, gpu_line):
    """Phase 27: (a) the graft hook on the card against the CPU; (b) each
    bounce-level and several-rank tool at TOOL_SIZES in this process, W1
    counted over all of them."""
    from photorealistic_rendering_using_opencl_tpu_torch.tools import (
        _common, bisect_bounce, bounce_parts, bounces, bwd_anatomy,
        profile_floor, scaling_bench, spmd_audit, trace_bounce,
    )
    z = TOOL_SIZES
    hi = _common.CORNELL_HI
    log("[27] the graft hook (graft.entry) and the bounce-level tools, "
        "with the card's pick")
    out = {"graft": graft_card_vs_cpu(dev, gpu_line)}
    reset_counts()
    runs = {
        "bounces": (bounces.run, z["bounces_width"], hi, dev),
        "bounce_parts": (bounce_parts.run, z["lanes"], hi, dev),
        "trace_bounce": (trace_bounce.run, z["trace_lanes"], z["trace_steps"],
                         10, hi, dev),
        "bisect_bounce": (bisect_bounce.bisect, z["lanes"][-1], hi, dev),
        "bisect_bounce --isect": (bisect_bounce.isect_full, z["lanes"][-1],
                                  hi, dev),
        "profile_floor": (profile_floor.run, z["lanes"], hi, dev),
        "spmd_audit": (spmd_audit.run, [1], dev),
        "scaling_bench": (scaling_bench.run, dev),
    }
    rows, secs = {}, {}
    for name, (fn, *args) in runs.items():
        rows[name], secs[name] = tool_rows(name, fn, *args)
    bwd = []
    for v in z["bwd_variants"]:
        r, t = tool_rows("bwd_anatomy", bwd_anatomy.run, z["bwd_width"],
                         z["bwd_spp"], v, dev, 1)
        bwd += r[:-1]
        secs[f"bwd_anatomy {v}"] = t
    rows["bwd_anatomy"] = bwd + [r[-1]]
    counts = read_counts()
    for name, keys in TOOL_KEYS.items():
        check_tool_rows(name, rows[name], keys)
    check_tool_rows("bisect_bounce --isect", rows["bisect_bounce --isect"],
                    TOOL_KEYS["bisect_bounce"])
    if counts["W1"] == 0:
        fail(f"phase 27 tools: W1 never launched ({counts})")
    audit = {r["program"]: r for r in rows["spmd_audit"][:-1]}
    step, frame = audit["train_step"], audit["render_sharded"]
    if (frame["total_collectives"] or step["counts"]["all-reduce"] != 2
            or step["total_collectives"] != 2
            or step["param_gradient_bytes"] != 132
            or step["bytes"]["all-reduce"] != 4 + 132
            or step["backend"] != ("nccl" if dev.type == "cuda" else "gloo")):
        fail(f"spmd_audit on 1 rank: {audit}, not a render without "
             "collectives and a step of 2 all-reduces (132 bytes of "
             "gradient) over NCCL")
    (scale,) = rows["scaling_bench"]
    if len(scale["points"]) != 1 or not scale["note"] or (
            "parallel_speedup" in scale["points"][0]):
        fail(f"scaling_bench on one card printed a scaling number: {scale}")
    parts = {(r["lanes"], r["name"]): r for r in rows["bounce_parts"][:-1]}
    log("  (b) tools in this process: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in secs.items()) + f"; W1 {counts['W1']}; "
        f"spmd_audit on 1 rank over {step['backend']}: render "
        f"{frame['total_collectives']} collectives, step "
        f"{step['counts']['all-reduce']} all-reduces "
        f"({step['bytes']['all-reduce']} bytes, gradient "
        f"{step['param_gradient_bytes']}); on {gpu_line}")
    out.update(tools_W1=counts["W1"], tool_seconds=secs,
               bounce_parts={f"{n} {name}": dict(
                   ms=r["ms"], device_ms=r["device_ms"], kernels=r["kernels"])
                   for (n, name), r in parts.items()},
               spmd_audit=rows["spmd_audit"][:-1],
               bwd_anatomy=rows["bwd_anatomy"][:-1])
    return out


TOOLS_DEFAULT = (("bounces",), ("bounce_parts",), ("trace_bounce",),
                 ("bisect_bounce",), ("bisect_bounce", "--isect"),
                 ("profile_floor",), ("bwd_anatomy",), ("spmd_audit",),
                 ("scaling_bench",))


def run_tool(name, *args, timeout=900):
    """``python -m`` one of the port's tools at its defaults (a process of
    its own, so its first run is a fresh process's), its lines logged ->
    the JSON object of its last line."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"{PKG}.tools.{name}", *args],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=timeout, check=False)
    lines = res.stdout.splitlines()
    for line in lines[:-1] if res.returncode == 0 else lines:
        log(f"  {name}: {line}")
    if res.returncode:
        log(res.stderr[-4000:])
        fail(f"tools.{name} exited {res.returncode}")
    out = json.loads(res.stdout.splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 28: K1's reduced-precision forms on the tensor cores
# ---------------------------------------------------------------------------

# the forms phase 28 runs: label -> (PRT_MESH_PRECISION name, bf16 table)
TC_FORMS = {"default": ("default", False), "bf16x3": ("bf16x3", False),
            "bf16x6": ("bf16x6", False), "bf16 table": ("highest", True)}
# the brute-pinned cornell_hi regen frame of each form
TC_SIDE, TC_SPP = 256, 2
# (tile, relevance block) pairs beside the default (128, 256) at which
# phase 28 holds the tensor-core kernel in each form of TC_SIZE_FORMS to
# its plain version (PRT_MESH_TILE, PRT_MESH_BLOCK) on the populations
# named there (None: all four; for time, the split forms on the two whose
# plain version takes ~0.5 s, and the one-pass form, whose result the
# prune moves most, on all), and renders a frame in TC_SIZE_FRAME_FORM
TC_SIZES = ((256, 256), (128, 128), (128, 512))
TC_SIZE_FORMS = {"default": None, "bf16x3": ("camera", "render"),
                 "bf16x6": ("camera", "render")}
TC_SIZE_FRAME_FORM = "default"
TC_EVENT_REPS = 3
# --kernel-times: readings of each form and population, warm and flushed
TC_TURN_REPEATS = 2
# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
BF16_FLOP_PER_S = 989e12
# the tensor-core operations a (ray, triangle) pair of a term needs: the 4
# quantities, each a dot over the 10 non-zero ray features, a multiply and
# an add each (the kernel's mma runs K = 16, 6 of them on zero features)
TC_PAIR_TENSOR_OPS = 2 * 4 * 10
# the tensor-core kernel's FP32 operations a (ray, triangle) pair of its hit
# test (den^2, the three barycentric products and two differences, the two
# minima, t*den, EPS*den^2, the two sign tests) and a slab test of a ray
# against a box of its relevance pass (six differences and products, six
# minima and maxima, the t test)
TC_PAIR_FLOPS = 12
TC_SLAB_FLOPS = 20
# rays a warp of the relevance pass (consecutive rays; a word is tested
# tile by tile for every ray of a warp when one of them enters its union
# box) and rays a chunk of tc_slab_tests' [rays, words, 3] temporaries
TC_WARP_RAYS = 32
TC_SLAB_CHUNK = 65536
# how far t may part from the plain version's where the winners agree, as
# a share of max(|t|, 1): the kernel sums each quantity's products in
# another order, so the error follows the coordinates (scene units) more
# than t; ~10x the largest difference measured on an H100 (4.4e-5 at
# |t| <= 1, bf16x3 on phase 3's surface population)
TC_DT_REL = 5e-4


def tc_form(feat, label):
    """(the table, the tensor-core kernel's form) of a TC_FORMS label, with
    mesh_brute._PRECISION_NAME set to the label's name."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    name, bf16 = TC_FORMS[label]
    mesh_brute._PRECISION_NAME = name
    table = feat.to(torch.bfloat16) if bf16 else feat
    return table, mesh_brute.reduced_form(table)


def tc_launch(table, clusters, b, form, norel=False, block=None):
    """The tensor-core kernel on batch ``b``, the table's own tile, relevance
    blocks of ``block`` rays (RELEVANCE_BLOCK when None)."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    return mesh_brute.mesh_brute_tc_kernel(
        mesh_brute.form_fragments(table, form,
                                  mesh_brute.table_tile(table, clusters)),
        clusters, b["origin"], b["direction"], b["t_init"], b["active"],
        b["any_hit"], b["exclude"], form, norel=norel, block=block)


def tc_slab_tests(clusters, b):
    """The slab tests of active rays that the kernel's exact relevance
    method needs on batch ``b``: one against each word's union box (the
    union of its 32 tiles' boxes; a word holding an empty tile's inverted
    box has none), and one against each tile of a word for every active
    ray of a warp (TC_WARP_RAYS consecutive rays) of which some active ray
    enters the word's union box, or of every word without one -> the
    count."""
    import torch
    nt = clusters.shape[0]
    nwords = -(-nt // 32)
    dev = clusters.device
    lo, hi = clusters[:, 0:3], clusters[:, 3:6]
    empty = ~(lo <= hi).all(1)
    pad = nwords * 32 - nt
    inf = torch.full((pad, 3), float("inf"), device=dev)
    ulo = torch.cat([torch.where(empty[:, None], float("inf"), lo), inf]
                    ).view(nwords, 32, 3).amin(1)
    uhi = torch.cat([torch.where(empty[:, None], -float("inf"), hi), -inf]
                    ).view(nwords, 32, 3).amax(1)
    no_union = torch.cat([empty, torch.zeros(pad, dtype=torch.bool,
                                             device=dev)]
                         ).view(nwords, 32).any(1)
    tiles = torch.full((nwords,), 32, device=dev)
    tiles[-1] = nt - 32 * (nwords - 1)
    active = b["active"]
    n = active.shape[0]
    t_init = torch.broadcast_to(b["t_init"], (n,))
    enters = []
    for s in range(0, n, TC_SLAB_CHUNK):
        o, d = b["origin"][s:s + TC_SLAB_CHUNK], b["direction"][s:s + TC_SLAB_CHUNK]
        inv = 1.0 / torch.where(d.abs() < 1e-12,
                                torch.where(d >= 0.0, 1e-12, -1e-12), d)
        a = (ulo[None] - o[:, None]) * inv[:, None]
        c = (uhi[None] - o[:, None]) * inv[:, None]
        ent = torch.clamp(torch.minimum(a, c).amax(-1), min=1e-5)
        ext = torch.maximum(a, c).amin(-1)
        enters.append(ent <= torch.minimum(ext, t_init[s:s + TC_SLAB_CHUNK,
                                                       None]))
    need = torch.cat(enters) & active[:, None] & ~no_union[None]
    warps = -(-n // TC_WARP_RAYS)
    padn = warps * TC_WARP_RAYS - n
    need = torch.cat([need, need.new_zeros(padn, nwords)]).view(
        warps, TC_WARP_RAYS, nwords).any(1) | no_union[None]
    act = torch.cat([active, active.new_zeros(padn)]).view(
        warps, TC_WARP_RAYS).sum(1)
    union_tests = int(active.sum()) * int((~no_union).sum())
    tile_tests = int((need * act[:, None] * tiles[None]).sum())
    return union_tests + tile_tests


def tc_bound(table, clusters, b, form, tri, block=None):
    """The tensor-core kernel's bound on one batch, from the work this
    batch needs: each active lane tests the tiles its block's relevance
    words set, an any-hit lane (by ``tri``, the plain version's result) up
    to its first occluding tile; a (ray, triangle) pair of those costs
    TC_PAIR_TENSOR_OPS bf16 tensor-core operations a term and TC_PAIR_FLOPS
    FP32 ones; the relevance pass costs TC_SLAB_FLOPS a slab test of
    tc_slab_tests; the fragments, boxes
    and rays are read once and (t, tri) written once -> (ms, "bytes" or
    "operations", the numbers).  The table's own tile; relevance blocks of
    ``block`` rays (RELEVANCE_BLOCK when None)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    block_rays = mesh_brute.RELEVANCE_BLOCK if block is None else block
    tile = mesh_brute.table_tile(table, clusters)
    words = mesh_brute.relevance_words(clusters, b["origin"], b["direction"],
                                       b["t_init"], b["active"], block_rays)
    nt = clusters.shape[0]
    w = words.to(torch.int64) & 0xFFFFFFFF
    bits = ((w[..., None] >> torch.arange(32, device=w.device)) & 1)
    # relevant tiles of each block up to and including each tile
    upto = bits.flatten(1)[:, :nt].cumsum(1)
    n = b["origin"].shape[0]
    block_of = torch.arange(n, device=w.device) // block_rays
    tiles = upto[block_of, -1]
    stop = b["any_hit"] & (tri >= 0)
    tiles = torch.where(stop, upto[block_of, tri.clamp(min=0).long()
                                   // tile], tiles)
    pairs = int(tiles[b["active"]].sum()) * tile
    terms = len(mesh_brute.FORM_TERMS[form])
    frag = mesh_brute.form_fragments(table, form, tile)
    n_bytes = (frag.numel() * 2 + clusters.numel() * 4
               + n * (12 + 12 + 4 + 1 + 1 + 4) + n * (4 + 4))
    tensor_ops = pairs * TC_PAIR_TENSOR_OPS * terms
    slab_tests = tc_slab_tests(clusters, b)
    fp32_ops = pairs * TC_PAIR_FLOPS + slab_tests * TC_SLAB_FLOPS
    t_mem = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(tensor_ops / BF16_FLOP_PER_S, fp32_ops / FP32_FLOP_PER_S) * 1e3
    by = "bytes" if t_mem >= t_ops else "operations"
    return max(t_mem, t_ops), by, dict(
        ray_triangle_pairs=pairs, slab_tests=slab_tests,
        tensor_gop=tensor_ops / 1e9,
        fp32_gop=fp32_ops / 1e9, mb=n_bytes / 1e6,
        tensor_ms=tensor_ops / BF16_FLOP_PER_S * 1e3,
        fp32_ms=fp32_ops / FP32_FLOP_PER_S * 1e3, bytes_ms=t_mem)


def tc_dt(t_k, t_p, same):
    """(max |t_k - t_p|, max of it over max(|t_p|, 1)) on the lanes
    ``same``."""
    if not bool(same.any()):
        return 0.0, 0.0
    d = (t_k[same] - t_p[same]).abs()
    return float(d.max()), float((d / t_p[same].abs().clamp(min=1.0)).max())


def tc_compare(label, pop, table, clusters, b, form, problems, flush):
    """The tensor-core kernel against its plain version on one batch
    (tc_check); the kernel's CUDA-event ms warm and L2-flushed (event_ms),
    and the bound."""
    r = tc_check(label, pop, table, clusters, b, form, problems)
    warm = event_ms(lambda: tc_launch(table, clusters, b, form),
                    TC_EVENT_REPS)
    cold = event_ms(lambda: tc_launch(table, clusters, b, form),
                    TC_EVENT_REPS, flush)
    bound, by, work = tc_bound(table, clusters, b, form, r.pop("plain_tri"))
    return dict(r, ms=warm["ms"], flushed_ms=cold["ms"], bound=bound, by=by,
                work=work)


def tc_check(label, pop, table, clusters, b, form, problems, block=None):
    """The tensor-core kernel against its plain version on one batch, the
    table's own tile, relevance blocks of ``block`` rays (RELEVANCE_BLOCK
    when None): winner flips on closest lanes, occlusion flips on any-hit
    lanes (each at most FLIP_LIMIT a ray), inactive and any-hit lanes' t
    exactly the plain version's, the t difference where the winners agree
    (at most TC_DT_REL of max(|t|, 1)); the plain version's ms by the host
    clock -> the numbers, the kernel's outputs ("out") and the plain
    version's winners ("plain_tri")."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    t_k, i_k = tc_launch(table, clusters, b, form, block=block)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_p, i_p = mesh_brute.intersect_reduced_plain(
        table, clusters, b["origin"], b["direction"], b["t_init"],
        b["active"], b["any_hit"], b["exclude"], form, block=block)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    act, ah = b["active"], b["any_hit"]
    closest, anyhit = act & ~ah, act & ah
    win = (i_k != i_p) & closest
    occ = ((i_k >= 0) != (i_p >= 0)) & anyhit
    n_closest, n_any = int(closest.sum()), int(anyhit.sum())
    same = closest & (i_k == i_p) & (i_k >= 0)
    dt, dt_rel = tc_dt(t_k, t_p, same)
    rest = ~closest
    t_rest = torch.equal(t_k[rest], t_p[rest]) and torch.equal(
        i_k[~act], i_p[~act])
    for lane in torch.nonzero(win | occ).flatten()[:4].tolist():
        log(f"    {label} {pop} lane {lane}: kernel tri {int(i_k[lane])} t "
            f"{float(t_k[lane]):.9g}, plain tri {int(i_p[lane])} t "
            f"{float(t_p[lane]):.9g}")
    if int(win.sum()) > FLIP_LIMIT * n_closest:
        problems.append(f"K1tc {label} {pop}: {int(win.sum())} winner flips "
                        f"of {n_closest} > {FLIP_LIMIT} a ray")
    if int(occ.sum()) > FLIP_LIMIT * n_any:
        problems.append(f"K1tc {label} {pop}: {int(occ.sum())} occlusion "
                        f"flips of {n_any} > {FLIP_LIMIT} a ray")
    if not t_rest:
        problems.append(f"K1tc {label} {pop}: inactive or any-hit lanes "
                        "differ from the plain version")
    if dt_rel > TC_DT_REL:
        problems.append(f"K1tc {label} {pop}: t parts from the plain "
                        f"version's by {dt_rel:.3g} of max(|t|, 1) where the "
                        f"winners agree > {TC_DT_REL}")
    return dict(win_flips=int(win.sum()), occ_flips=int(occ.sum()),
                closest=n_closest, any_hit=n_any,
                hits=int((i_p[closest] >= 0).sum()), max_abs_dt=dt,
                max_rel_dt=dt_rel, plain_ms=plain_ms, out=(t_k, i_k),
                plain_tri=i_p)


def tc_frame(cfg, scene, cam, side=TC_SIDE, spp=TC_SPP):
    """The brute-pinned regen frame at side^2 x spp, seed 0, with
    K1's and the tensor-core kernel's counts set to 0 just before and read
    just after -> (image, {"K1": n, "K1tc": n}, seconds)."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    torch.cuda.synchronize()
    mesh_brute.mesh_brute_kernel.launches = 0
    mesh_brute.mesh_brute_tc_kernel.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        img, _ = pathtracer.render(cfg, scene, cam, side, side, spp,
                                   seed=0, method="regen")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = dict(K1=mesh_brute.mesh_brute_kernel.launches,
                  K1tc=mesh_brute.mesh_brute_tc_kernel.launches)
    if not bool(torch.isfinite(img).all()):
        fail(f"phase 28: a frame has non-finite pixels ({counts})")
    return img, counts, secs


def phase_tc(dev, gpu_line, side=TC_SIDE, spp=TC_SPP):
    """Phase 28: the tensor-core kernel (csrc/mesh_brute_tc.cu) in each
    reduced form of TC_FORMS against its plain version on the cornell_hi
    tables, on phase 3's random, camera and surface populations and phase
    21's render population; PRT_MESH_NOREL and PRT_MESH_FORCE_XLA; one
    brute-pinned regen frame (side^2 x spp) in each form against
    highest's, and bf16x3's again with mesh_second_pass."""
    import dataclasses

    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

    log("[28] the tensor-core kernel mesh_brute_tc.cu in each reduced form")
    t_phase = time.perf_counter()
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    feat, clusters = scene.bf_feat, scene.bf_clusters
    pops = turn_populations(cfg, scene, dev)
    flush = l2_flush(dev)
    resources = tc_resources_log()
    saved = mesh_brute._PRECISION_NAME
    saved_block = mesh_brute.RELEVANCE_BLOCK
    problems, forms, norel = [], {}, {}
    try:
        for label in TC_FORMS:
            table, form = tc_form(feat, label)
            forms[label] = {}
            for pop, b in pops.items():
                r = tc_compare(label, pop, table, clusters, b, form,
                               problems, flush)
                t_k, i_k = r.pop("out")
                # PRT_MESH_NOREL: every live lane tests every tile
                t_n, i_n = tc_launch(table, clusters, b, form, norel=True)
                r["norel_lanes_moved"] = int(
                    ((t_n != t_k) | (i_n != i_k)).sum())
                forms[label][pop] = r
                log(f"  K1tc {label} ({form}) {pop}: {b['origin'].shape[0]} "
                    f"lanes, winner flips {r['win_flips']}/{r['closest']} "
                    f"({r['hits']} hits), occlusion flips {r['occ_flips']}/"
                    f"{r['any_hit']}, max |dt| where winners agree "
                    f"{r['max_abs_dt']:.3g} ({r['max_rel_dt']:.3g} of "
                    f"max(|t|, 1)); kernel {r['ms']:.3f} ms warm, "
                    f"{r['flushed_ms']:.3f} ms L2-flushed (event_ms, "
                    f"{TC_EVENT_REPS} launches), plain {r['plain_ms']:.1f} ms "
                    f"(host clock); bound {r['bound']:.4f} ms ({r['by']}: "
                    f"{r['work']['tensor_ms']:.4f} ms of tensor work, "
                    f"{r['work']['fp32_ms']:.4f} ms of FP32, "
                    f"{r['work']['bytes_ms']:.4f} ms of bytes), "
                    f"{r['bound'] / r['ms']:.2f} of it; NOREL moves "
                    f"{r['norel_lanes_moved']} lanes")
                if form == "bf16x6" and r["norel_lanes_moved"]:
                    problems.append(f"K1tc bf16x6 {pop}: PRT_MESH_NOREL moved "
                                    f"{r['norel_lanes_moved']} lanes")
        sizes = tc_sizes(scene, pops, problems)
        mesh_brute._PRECISION_NAME = "highest"
        for pop, b in pops.items():
            args = (feat, clusters, b["origin"], b["direction"], b["t_init"],
                    b["active"], b["any_hit"], b["exclude"])
            k = mesh_brute.mesh_brute_kernel(*args)
            k_n = mesh_brute.mesh_brute_kernel(*args, norel=True)
            norel[pop] = dict(
                bitwise=all(torch.equal(x, y) for x, y in zip(k, k_n)),
                norel_ms=cuda_ms(lambda: mesh_brute.mesh_brute_kernel(
                    *args, norel=True), 3))
            if not norel[pop]["bitwise"]:
                problems.append(f"K1 {pop}: PRT_MESH_NOREL is not bitwise")
        log("  K1 under PRT_MESH_NOREL: " + "; ".join(
            f"{k} {'bitwise' if v['bitwise'] else 'DIFFERS'} "
            f"({v['norel_ms']:.3f} ms)" for k, v in norel.items()))

        # PRT_MESH_FORCE_XLA: the plain twin on the card, no kernel
        b = pops["camera"]
        mesh_brute.mesh_brute_kernel.launches = 0
        mesh_brute.mesh_brute_tc_kernel.launches = 0
        os.environ["PRT_MESH_FORCE_XLA"] = "1"
        try:
            forced = mesh_brute.mesh_intersect(
                feat, clusters, b["origin"], b["direction"], b["t_init"],
                active=b["active"], any_hit=b["any_hit"], exclude=b["exclude"])
            gate = mesh_brute.uses_kernel(b["origin"])
        finally:
            del os.environ["PRT_MESH_FORCE_XLA"]
        twin = mesh_brute._intersect_xla(feat, clusters, b["origin"],
                                         b["direction"], b["t_init"],
                                         b["active"], exclude=b["exclude"])
        force = dict(K1=mesh_brute.mesh_brute_kernel.launches,
                     K1tc=mesh_brute.mesh_brute_tc_kernel.launches,
                     uses_kernel=gate, bitwise=all(
                         torch.equal(x, y) for x, y in zip(forced, twin)))
        log(f"  PRT_MESH_FORCE_XLA on the camera population: {force}")
        if force["K1"] or force["K1tc"] or gate or not force["bitwise"]:
            problems.append(f"PRT_MESH_FORCE_XLA: {force}")
        if problems:
            fail("; ".join(problems))

        # the frames: each form's mean radiance against highest's
        cfg_b = dataclasses.replace(cfg, mesh_accel="brute")
        cam = default_camera(side, side).pytree(dev)
        frames = {}
        mesh_brute._PRECISION_NAME = "highest"
        img_h, counts, secs = tc_frame(cfg_b, scene, cam, side, spp)
        mean_h = float(img_h.mean())
        frames["highest"] = dict(mean=mean_h, seconds=secs, **counts)
        main_tc = 0
        for label in TC_FORMS:
            table, form = tc_form(feat, label)
            img, counts, secs = tc_frame(
                cfg_b, dataclasses.replace(scene, bf_feat=table), cam, side,
                spp)
            main_tc += counts["K1tc"]
            frames[label] = dict(
                mean=float(img.mean()), seconds=secs,
                bias=float(img.mean()) / mean_h - 1.0,
                pixels_moved=int((img != img_h).any(-1).sum()), **counts)
            if counts["K1tc"] == 0 or counts["K1"]:
                fail(f"phase 28: the {label} frame launched {counts}")
        # bf16x3 with the second pass: mesh_closest's calls counted
        table, form = tc_form(feat, "bf16x3")
        real, calls = intersect.mesh_closest, []

        def counted(*a, **kw):
            calls.append(None)
            return real(*a, **kw)
        intersect.mesh_closest = counted
        try:
            img, counts, secs = tc_frame(
                dataclasses.replace(cfg_b, mesh_second_pass=True), scene, cam,
                side, spp)
        finally:
            intersect.mesh_closest = real
        main_tc += counts["K1tc"]
        frames["bf16x3 second pass"] = dict(
            mean=float(img.mean()), seconds=secs,
            bias=float(img.mean()) / mean_h - 1.0, mesh_calls=len(calls),
            **counts)
        if counts["K1tc"] != 2 * len(calls) or counts["K1"]:
            fail(f"phase 28: the second-pass frame launched {counts} for "
                 f"{len(calls)} mesh calls")
        # the same frame through K1 at PRT_MESH_TILE's other sizes, and in
        # TC_SIZE_FRAME_FORM at each of TC_SIZES.  K1's closest winners do
        # not depend on the tile, but an any-hit lane's winner is its first
        # occluding tile's, which the winner's validation re-tests: a
        # grazing one may part, so at most FLIP_PIXELS of the pixels move
        mesh_brute._PRECISION_NAME = "highest"
        k1_tiles_main = 0
        for tile in K1_TILES:
            img, counts, secs = tc_frame(cfg_b, scene_at(scene, tile), cam,
                                         side, spp)
            k1_tiles_main += counts["K1"]
            moved = int((img != img_h).any(-1).sum())
            frames[f"highest, tile {tile}"] = dict(
                mean=float(img.mean()), seconds=secs,
                bias=float(img.mean()) / mean_h - 1.0, pixels_moved=moved,
                **counts)
            if (moved > FLIP_PIXELS * side * side or counts["K1tc"]
                    or not counts["K1"]):
                fail(f"phase 28: the frame at tile {tile} launched {counts} "
                     f"and moved {moved} pixels from the 128-triangle "
                     "tables' frame")
        tc_sizes_main = 0
        for tile, block in TC_SIZES:
            tiled = scene_at(scene, tile)
            table, _ = tc_form(tiled.bf_feat, TC_SIZE_FRAME_FORM)
            tiled = dataclasses.replace(tiled, bf_feat=table)
            mesh_brute.RELEVANCE_BLOCK = block
            try:
                img, counts, secs = tc_frame(cfg_b, tiled, cam, side, spp)
            finally:
                mesh_brute.RELEVANCE_BLOCK = saved_block
            tc_sizes_main += counts["K1tc"]
            frames[f"{TC_SIZE_FRAME_FORM}, tile {tile}, block {block}"] = dict(
                mean=float(img.mean()), seconds=secs,
                bias=float(img.mean()) / mean_h - 1.0,
                pixels_moved=int((img != img_h).any(-1).sum()), **counts)
            if counts["K1tc"] == 0 or counts["K1"]:
                fail(f"phase 28: the frame at tile {tile}, block {block} "
                     f"launched {counts}")
    finally:
        mesh_brute._PRECISION_NAME = saved
        mesh_brute.RELEVANCE_BLOCK = saved_block
    for label, f in frames.items():
        log(f"  frame {side}^2 x {spp} spp (regen, brute) {label}: mean "
            f"{f['mean']:.6f}"
            + (f", against highest {f['bias']:+.3%}" if "bias" in f else "")
            + (f", {f['pixels_moved']} pixels moved" if "pixels_moved" in f
               else "")
            + f"; launches K1 {f['K1']}, K1tc {f['K1tc']}"
            + (f" over {f['mesh_calls']} mesh calls" if "mesh_calls" in f
               else "") + f"; {f['seconds']:.2f} s")
    log(f"  phase 28 took {time.perf_counter() - t_phase:.1f} s; on {gpu_line}")
    cam_pop = forms["bf16x6"]["camera"]
    return dict(forms=forms, k1_norel=norel, force_xla=force, frames=frames,
                sizes=sizes, resources=resources, launches=main_tc, sizes_launches=tc_sizes_main,
                k1_tiles_launches=k1_tiles_main, ms=cam_pop["ms"],
                flushed_ms=cam_pop["flushed_ms"],
                plain_ms=cam_pop["plain_ms"], bound=cam_pop["bound"],
                by=cam_pop["by"],
                err=max(r["max_abs_dt"] for v in list(forms.values())
                        + [f for size in sizes.values()
                           for f in size.values()] for r in v.values()))


def tc_resources_log():
    """The tensor-core kernel's resources at the default (tile, block) and
    at each of TC_SIZES, each form: registers, local (spill) bytes, shared
    memory, CTAs an SM and clusters the card holds at once (the CUDA
    runtime, mesh_brute.tc_resources), and ptxas's spill bytes from the
    build's log -> {"tile x block": {form: numbers}}.  Fails where the
    build's N or stage is not the one mesh_brute's emulation takes."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda, mesh_brute
    out = {}
    for tile, block in ((128, 256),) + TC_SIZES:
        size = out[f"{tile} x {block}"] = {}
        for code, form in enumerate(("bf16", "bf16x3", "bf16x6")):
            r = mesh_brute.tc_resources(tile, block, form)
            usage = ptxas_entry(
                _cuda.LIBRARY.build_log,
                f"mesh_brute_tc_kernelILi{code}ELi{tile}ELi{block}E")
            r.update(spill_stores=usage.get("spill_stores"),
                     spill_loads=usage.get("spill_loads"))
            size[form] = r
            log(f"  K1tc {form} at tile {tile}, block {block}: "
                f"{r['registers']} registers, {r['local_bytes']} local "
                f"bytes ({r.get('spill_stores', 'no')} spill store bytes "
                f"by ptxas), {r['dynamic_smem']} B shared memory, "
                f"{r['threads']} threads and {r['ctas_per_sm']} CTAs an SM, "
                f"{r['active_clusters']} clusters at once (wgmma N "
                f"{r['wgmma_n']}, {r['stages']} stages of "
                f"{r['stage_tris']} triangles)")
            if (r["wgmma_n"], r["stage_tris"]) != (mesh_brute.TC_N,
                                                   mesh_brute.TC_STAGE_TRIS):
                fail(f"K1tc {form} at tile {tile}, block {block}: the build's "
                     f"N and stage ({r['wgmma_n']}, {r['stage_tris']}) are "
                     f"not mesh_brute's TC_N and TC_STAGE_TRIS "
                     f"({mesh_brute.TC_N}, {mesh_brute.TC_STAGE_TRIS})")
    return out


def tc_sizes(scene, pops, problems):
    """PRT_MESH_TILE / PRT_MESH_BLOCK: the tensor-core kernel in each form
    of TC_SIZE_FORMS at each (tile, relevance block) of TC_SIZES, on the
    scene's tables packed at the tile (tables_at), against its plain
    version at the same sizes on the form's populations (tc_check's limits):
    flips, t error, CUDA-event ms (event_ms, warm) and the bound ->
    {"tile x block": {label: {population: numbers}}}."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    out = {}
    for tile, block in TC_SIZES:
        feat, clusters = tables_at(scene, tile)[:2]
        size = out[f"{tile} x {block}"] = {}
        for label, only in TC_SIZE_FORMS.items():
            table, form = tc_form(feat, label)
            size[label] = {}
            for pop, b in pops.items():
                if only is not None and pop not in only:
                    continue
                r = tc_check(label, f"{pop} (tile {tile}, block {block})",
                             table, clusters, b, form, problems, block)
                r.pop("out")
                ms = event_ms(lambda: tc_launch(table, clusters, b, form,
                                                block=block),
                              TC_EVENT_REPS)["ms"]
                bound, by, _ = tc_bound(table, clusters, b, form,
                                        r.pop("plain_tri"), block)
                size[label][pop] = dict(r, ms=ms, bound=bound, by=by)
                log(f"  K1tc {label} ({form}) {pop} at tile {tile}, block "
                    f"{block}: winner flips {r['win_flips']}/{r['closest']}, "
                    f"occlusion flips {r['occ_flips']}/{r['any_hit']}, max "
                    f"|dt| {r['max_abs_dt']:.3g} ({r['max_rel_dt']:.3g} of "
                    f"max(|t|, 1)); kernel {ms:.3f} ms (event_ms, "
                    f"{TC_EVENT_REPS} launches), plain {r['plain_ms']:.1f} ms "
                    f"(host clock); bound {bound:.4f} ms ({by}), "
                    f"{bound / ms:.2f} of it")
    return out


def phase_k1_sweep(dev, pops):
    """--k1-sweep: K1_SWEEP's configurations and K1_TILE_SWEEP's (tile,
    configuration) pairs on phase 3's populations."""
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    log("[3b] K1's configurations, each its own build (K1_SWEEP)")
    _, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                          models_dir=os.path.join(REPO, "scenes/assets"),
                          device=dev)
    wrong = k1_sweep(scene, pops)
    if wrong:
        fail(f"K1 sweep: configurations whose outputs differ from the "
             f"kernel library's: {wrong[:6]}")


def bits_digest(outs, dev) -> int:
    """A digest of tensors' bits (each element's 32 bits times its place),
    equal across ports whose outputs agree bitwise."""
    import torch
    return sum(int((x.view(torch.int32).to(torch.int64)
                    * torch.arange(1, x.numel() + 1, device=dev)).sum())
               for x in outs)


def turn_populations(cfg, scene, dev):
    """Phase 21's (and 28's) four populations: phase 3's random, camera and
    surface, and the render population of a regen frame's RENDER_CALL-th
    mesh call."""
    import dataclasses
    pops = k1_populations(scene, dev)
    pops["render"] = regen_dispatch(
        dataclasses.replace(cfg, mesh_accel="bvh"), scene, FRAME, 8,
        RENDER_CALL)
    return pops


def w1_turn_times(pops, scene, dev, flush, repeats=W1_TURN_REPEATS):
    """--kernel-times' W1: phase 21's four populations through the
    wrapper's signature that W1's first design already had (so that an
    older port times the same way), each read ``repeats`` times warm and with
    the L2 flushed (event_ms over W1_EVENT_REPS launches), and a digest of
    the outputs' bits (t, tri, u, v), equal across ports that agree
    bitwise."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import bvh_walk
    out = {}
    for name, b in pops.items():
        def launch(b=b):
            return bvh_walk.bvh_walk_kernel(
                scene.bvh_nodes, scene.bvh_links, scene.leaf_verts,
                b["origin"], b["direction"], b["t_init"], b["active"],
                b["any_hit"])
        digest = bits_digest(launch(), dev)
        r = out[name] = dict(
            warm=[event_ms(launch, W1_EVENT_REPS)["ms"]
                  for _ in range(repeats)],
            flushed=[event_ms(launch, W1_EVENT_REPS, flush)["ms"]
                     for _ in range(repeats)],
            digest=digest)
        log(f"  W1 {name}: warm " + " ".join(f"{x:.4f}" for x in r["warm"])
            + " ms, flushed " + " ".join(f"{x:.4f}" for x in r["flushed"])
            + f" ms; digest {digest}")
    return out


def tc_turn_times(pops, scene, dev, flush, repeats=TC_TURN_REPEATS):
    """--kernel-times' K1tc: each reduced form (TC_FORMS' labels but the
    bf16 table, which runs form bf16 as "default" does) at the default
    tile and relevance block on the four populations, through the wrapper
    and fragments the kernel has had since it was ported (so that an older
    port times the same way), each read ``repeats`` times warm and with the
    L2 flushed (event_ms over TC_EVENT_REPS launches), a digest of the
    outputs' bits (t, tri) and the bound (tc_bound, from the plain
    version's winners)."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    feat, clusters = scene.bf_feat, scene.bf_clusters
    saved = mesh_brute._PRECISION_NAME
    out = {}
    try:
        for label in ("default", "bf16x3", "bf16x6"):
            table, form = tc_form(feat, label)
            out[form] = {}
            for name, b in pops.items():
                def launch(b=b, table=table, form=form):
                    return tc_launch(table, clusters, b, form)
                digest = bits_digest(launch(), dev)
                tri = mesh_brute.intersect_reduced_plain(
                    table, clusters, b["origin"], b["direction"], b["t_init"],
                    b["active"], b["any_hit"], b["exclude"], form)[1]
                bound, by, _ = tc_bound(table, clusters, b, form, tri)
                r = out[form][name] = dict(
                    warm=[event_ms(launch, TC_EVENT_REPS)["ms"]
                          for _ in range(repeats)],
                    flushed=[event_ms(launch, TC_EVENT_REPS, flush)["ms"]
                             for _ in range(repeats)],
                    digest=digest, bound=bound, by=by)
                log(f"  K1tc {form} {name}: warm "
                    + " ".join(f"{x:.4f}" for x in r["warm"])
                    + " ms, flushed "
                    + " ".join(f"{x:.4f}" for x in r["flushed"])
                    + f" ms; bound {bound:.4f} ms ({by}); digest {digest}")
    finally:
        mesh_brute._PRECISION_NAME = saved
    return out


def kernel_times(dev, root):
    """--kernel-times: K2 (phase 4's image), T2a and T2b (phase 11's
    inputs, each in turns with x.clone()), K3 (phase 7's sizes, in turns
    with x.clone() and the per-block torch.cumsum), all warm and with the
    L2 flushed, W1 (phase 21's populations, warm and flushed,
    w1_turn_times), K1tc (the same populations, each reduced form,
    tc_turn_times) and T1 (phase 10's batch at both blocks, CUDA events,
    with its inner loop's SASS), on the port found at ``root``; one JSON
    line."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda, compaction, mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
    log(f"[4, 7, 10, 11, 21, 28] kernel times of the port at {root}")
    flush = l2_flush(dev)
    res = {"port_root": root, "K2": k2_times(tm, k2_image(dev), flush)}
    for name, fn, arg in t2_inputs(dev):
        res[name] = t2_times(fn, arg, flush)
    res["K3"] = [k3_times(compaction, k3_flags(n, dev), flush)
                 for n in K3_SIZES]
    for t in res["K3"]:
        k3_log(t, "")
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                            models_dir=os.path.join(REPO, "scenes/assets"),
                            device=dev)
    pops = turn_populations(cfg, scene, dev)
    res["W1"] = w1_turn_times(pops, scene, dev, flush)
    res["K1tc"] = tc_turn_times(pops, scene, dev, flush)
    b = pops["random"]
    res["T1"] = {str(blk): t1_time(mesh_brute, b, scene.bf_feat,
                                   scene.bf_clusters, blk)
                 for blk in T1_BLOCKS}
    # the 128-triangle instance; a port from before the tile was a template
    # argument has the one kernel of the plain name
    res["T1_sass"] = sass_inner_loop(_cuda.LIBRARY._so_path(),
                                     T1_SASS_FUNCTION)
    if "no function" in res["T1_sass"].get("note", ""):
        res["T1_sass"] = sass_inner_loop(_cuda.LIBRARY._so_path(),
                                         "matmul_only_kernel")
    log("kernel times: " + json.dumps(res))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kernels_only = argv == ["--kernels-only"]
    sweep = argv == ["--k1-sweep"]
    census = argv == ["--op-census"]
    paths = argv == ["--paths"]
    walk = argv == ["--walk"]
    sharded = argv == ["--sharded"]
    bdpt_bound = argv == ["--bdpt-bound"]
    regen_scan = argv == ["--regen-scan"]
    tools = argv == ["--tools"]
    tc_only = argv == ["--tc"]
    times = argv[:1] == ["--kernel-times"] and (
        len(argv) == 1 or (len(argv) == 3 and argv[1] == "--port-root"))
    if argv and not (kernels_only or sweep or census or times or paths
                     or walk or bdpt_bound or sharded or regen_scan or tools
                     or tc_only):
        fail(f"unknown arguments {argv}: none, --kernels-only, --k1-sweep, "
             "--op-census, --paths, --walk, --sharded, --bdpt-bound, "
             "--regen-scan, --tools, --tc or --kernel-times "
             "[--port-root DIR]")
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
            "K3, T1, T2a, T2b, W1 and K1tc); no result line")
        return 0

    t_start = time.perf_counter()

    def done(phase):
        log(f"  ({phase} done at {time.perf_counter() - t_start:.1f} s)")

    def walk_phases(brute_img):
        """Phases 21-24 with the card's own mesh backend pick."""
        out = {}
        out["w1"], out["w1_extra"] = phase_walk(dev)
        done(21)
        out["crossover"], big = phase_crossover(dev, gpu_line)
        done(22)
        out["default"], hi = phase_default_path(dev, gpu_line, brute_img,
                                                big)
        del big
        done(23)
        out["bdpt"] = phase_bdpt(dev, gpu_line, hi)
        done(24)
        return out

    if bdpt_bound:
        log("BDPT bound: " + json.dumps(phase_bdpt_bound(dev)))
        log("partial run (--bdpt-bound: phases 1-2 and the readings of "
            "FWD_BDPT); no result line")
        return 0
    if sharded:
        log("sharded: " + json.dumps(phase_sharded(dev, gpu_line)))
        done(25)
        log("partial run (--sharded: phases 1-2 and 25); no result line")
        return 0
    if regen_scan:
        log("remat: " + json.dumps(phase_remat(dev, gpu_line)))
        done(26)
        log("[26b] tools.regen_scan_probe at its defaults")
        log("regen_scan_probe: " + json.dumps(run_tool("regen_scan_probe")))
        log("[26c] tools.northstar at its defaults")
        log("northstar: " + json.dumps(run_tool("northstar")))
        log(f"partial run (--regen-scan: phases 1-2, 26 and the two tools), "
            f"{time.perf_counter() - t_start:.1f} s after the build; no "
            "result line")
        return 0
    if tc_only:
        log("tensor-core forms: " + json.dumps(phase_tc(dev, gpu_line)))
        done(28)
        log("partial run (--tc: phases 1-2 and 28); no result line")
        return 0
    if tools:
        log("graft and tools: " + json.dumps(phase_graft_tools(dev, gpu_line)))
        done(27)
        for args in TOOLS_DEFAULT:
            log(f"[27b] tools.{' '.join(args)} at its defaults")
            log(f"{args[0]}: " + json.dumps(run_tool(*args, timeout=1200)))
        log(f"partial run (--tools: phases 1-2, 27 and the tools at their "
            f"defaults), {time.perf_counter() - t_start:.1f} s after the "
            "build; no result line")
        return 0
    if walk:
        wp = walk_phases(None)
        for key in ("w1", "w1_extra", "crossover", "default", "bdpt"):
            log(f"{key}: " + json.dumps(wp[key]))
        log("partial run (--walk: phases 1-2 and 21-24); no result line")
        return 0
    # phases 3-20 keep K1 on every path they drove before the walk was
    # ported: their scenes (and the CLI's subprocesses) load with the brute
    # backend; phases 21-24 take the card's own pick
    os.environ["PRT_MESH_ACCEL"] = "brute"
    if paths:
        for phase, run in ((17, phase_sdf), (18, phase_media), (19, phase_env)):
            log(f"path: {json.dumps(run(dev, gpu_line))}")
            done(phase)
        log("slice goldens: " + json.dumps(phase_goldens_slice8(dev)))
        done(20)
        log("partial run (--paths: phases 1-2 and 17-20); no result line")
        return 0
    k1_err, k1_times, k1_sort_cost, k1_pops, k1_by_tile = phase_k1(dev)
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
    del os.environ["PRT_MESH_ACCEL"]
    wp = walk_phases(regen_img)
    w1_times, sweep_out, default, bdpt = (
        wp["w1"], wp["crossover"], wp["default"], wp["bdpt"])
    shard = phase_sharded(dev, gpu_line)
    done(25)
    remat = phase_remat(dev, gpu_line)
    done(26)
    graft_tools = phase_graft_tools(dev, gpu_line)
    done(27)
    tc = phase_tc(dev, gpu_line)
    done(28)

    cam = k1_times["camera"]
    k1_paths = {"forward 512^2 x 8 spp (regen)": launches["K1"],
                "fwd+bwd 512^2 x 4 spp (regen_scan)": fb["k1"],
                "fit_scene 2 steps 128^2 x 4 spp": k1_fit,
                "bench_kernel": t1["k1_launches"],
                "forward 512^2 x 8 spp (scan)": sw["scan"]["k1"],
                "forward 512^2 x 8 spp (while)": sw["while"]["k1"],
                f"fwd+bwd 512^2 x {SCAN_FB_SPP} spp (scan)": sfb["k1"],
                "goldens (scan)": k1_goldens,
                f"CLI {CLI_SIDE}^2 x {CLI_RESUME_SPP} spp (app.main, while)":
                    cli["k1"],
                f"CLI --aov, 5 modes at {CLI_SIDE}^2 (app.main)":
                    cli["aov"]["k1"],
                **{f"A {m} 512^2 x {SDF_SPP} spp": r["K1"]
                   for m, r in sdf["forward"].items()},
                f"A fwd+bwd 512^2 x {SDF_FB_SPP} spp (regen_scan)":
                    sdf["fwd_bwd"]["K1"],
                **{f"B {k} 512^2 (regen)": r["forward"]["K1"]
                   for k, r in med.items() if k != "card_vs_cpu"},
                **{f"B {k} fwd+bwd 512^2 (regen_scan)":
                   r["fwd_bwd"]["K1"] for k, r in med.items()
                   if "fwd_bwd" in r},
                "BDPT cornell_hi 256^2 x 2 spp (brute)":
                    bdpt["cornell_hi_brute"]["K1"],
                **{f"remat={m} fwd+bwd {REMAT_K1_SIDE}^2 x {REMAT_K1_SPP} "
                   "spp (regen_scan, brute)": remat["b"][m]["forward"]["K1"]
                   for m in ("body", "segment")},
                f"phase 28 regen frames {TC_SIDE}^2 x {TC_SPP} spp at tiles "
                f"{' and '.join(map(str, K1_TILES))}":
                    tc["k1_tiles_launches"]}
    w1_paths = {"default forward 512^2 x 8 spp (regen)":
                    default["forward"]["W1"],
                "default fwd+bwd 512^2 x 4 spp (regen_scan)":
                    default["fwd_bwd"]["W1"],
                "traversal AOV 512^2": default["traversal"]["W1"],
                "icosphere 327,680 triangles 512^2 x 2 spp (regen)":
                    default["big_mesh"]["W1"],
                "BDPT cornell_hi 512^2 x 8 spp": bdpt["cornell_hi"]["W1"],
                f"sharded {SHARD_SIDE}^2 x {SHARD_SPP} spp, 1 rank "
                "(render_sharded)": shard["one_rank"]["render_W1"],
                f"train step {TRAIN_SIDE}^2 x 1 spp, 1 rank (scan fwd+bwd)":
                    shard["one_rank"]["step_W1"],
                **{f"remat={m} fwd+bwd {REMAT_SIDE}^2 x {REMAT_SPP} spp "
                   "(regen_scan)": remat["a"][m]["forward"]["W1"]
                   for m in ("body", "segment")},
                **{f"north star {k} {NORTH_SIDE}^2 x {NORTH_SPP} spp "
                   "fwd+bwd": remat["c"][k]["launches"]["forward"]["W1"]
                   for k in (f"tiled x{NORTH_TILES}", "direct")},
                "graft.entry() 64^2 x 1 spp (scan)":
                    graft_tools["graft"]["W1"],
                "phase 27's tools at TOOL_SIZES": graft_tools["tools_W1"]}
    w1_cam = w1_times["camera"]
    k2_paths = {"forward 512^2 x 8 spp (regen)": launches["K2"],
                "forward 512^2 x 8 spp (scan)": sw["scan"]["k2"],
                "forward 512^2 x 8 spp (while)": sw["while"]["k2"],
                "materials 512^2 x 8 spp (scan)": k2_materials,
                f"CLI export {CLI_SIDE}^2 (app.main)": cli["k2"],
                f"CLI --aov, 5 modes at {CLI_SIDE}^2 (app.main)":
                    cli["aov"]["k2"],
                **{f"A {m} 512^2 x {SDF_SPP} spp": r["K2"]
                   for m, r in sdf["forward"].items()},
                **{f"B {k} 512^2 (regen)": r["forward"]["K2"]
                   for k, r in med.items() if k != "card_vs_cpu"},
                f"C CLI -hdr {ENV_SIDE}^2 export (app.main)":
                    envp["cli"]["K2"]}
    kernels = [
        {"name": "K1 mesh_brute", "route": "cuda",
         "source": f"{PKG}/csrc/mesh_brute.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py:301",
         "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
         "max_abs_err": max(k1_err, cli["k1_err"], sdf["k1_err"],
                            *(v["err"] for pops in k1_by_tile.values()
                              for v in pops.values())),
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
         "by_tile": {str(tile): {
             f"{key}_by_population": {k: v[field] for k, v in pops.items()}
             for key, field in (("ms", "ms"), ("plain_ms", "plain_ms"),
                                ("bound_ms", "bound"),
                                ("win_flips", "win_flips"),
                                ("occ_flips", "occ_flips"),
                                ("max_abs_err", "err"))}
             for tile, pops in k1_by_tile.items()},
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
         "by_block": t1["by_block"], "by_tile": t1["by_tile"],
         "inner_loop_sass": t1["sass"],
         "timed_by": t1["timed_by"]},
    ]
    kernels.append(
        {"name": "W1 bvh_walk", "route": "cuda",
         "source": f"{PKG}/csrc/bvh_walk.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/intersect.py:293",
         "replaces_note": "no TPU kernel: the reference's lax.while_loop "
                          "walk (_bvh_traverse_chunk), which XLA keeps on the "
                          "device",
         "redesigned": True, **w1_design(),
         "registers": wp["w1_extra"]["ptxas"],
         "launches": sum(w1_paths.values()), "launches_by_path": w1_paths,
         "max_abs_err": 0.0, "mismatches": sum(
             v["mismatches"] for v in w1_times.values()) + sum(
             v["mismatches"] for v in wp["w1_extra"]["edges"].values()),
         "edge_batches": wp["w1_extra"]["edges"],
         "refill_sweep_ms": wp["w1_extra"]["refill_sweep"],
         "ms_l2_flushed": w1_cam["flushed_ms"]["ms"],
         "ms": w1_cam["ms"], "plain_ms": w1_cam["plain_ms"],
         "bound_ms": w1_cam["bound"], "bound_by": w1_cam["by"],
         "bound_term": w1_cam["bound_term"],
         "bound_terms_ms": w1_cam["bound_terms_ms"],
         "bound_note": "the largest of the tables once and the rays' bytes "
                       "over HBM's 3.35 TB/s, every visit's, leaf's and "
                       "ray's bytes over the L2 read rate this run's probe "
                       "measured (l2_rate), the FP32 operations over 67 "
                       "TFLOP/s",
         "l2_rate": wp["w1_extra"]["l2"],
         "library_ms": None,
         "library_note": "no PyTorch call walks a BVH",
         "timed_by": "ms: CUDA events around 10 back-to-back launches "
                     "(phase 3's camera population, 524,288 lanes); "
                     "events_ms and ms_l2_flushed: event_ms, an event pair "
                     "around each of 20 launches queued behind a sleep, "
                     "the latter after a 256 MB fill each; plain_ms: host "
                     "clock around one call of the twin, ending in "
                     "torch.cuda.synchronize (it syncs at every node step)",
         "events_ms_by_population": {k: v["events_ms"]["ms"]
                                     for k, v in w1_times.items()},
         "ms_l2_flushed_by_population": {k: v["flushed_ms"]["ms"]
                                         for k, v in w1_times.items()},
         **{f"{key}_by_population": {k: v[field] for k, v in w1_times.items()}
            for key, field in (("ms", "ms"), ("plain_ms", "plain_ms"),
                               ("bound_ms", "bound"), ("simt", "simt"),
                               ("visits_per_ray", "visits_per_ray"),
                               ("leaf_visits_per_ray", "leaf_visits_per_ray"),
                               ("tri_tests_per_ray", "tri_tests_per_ray"))}})
    e1 = envp["e1"]
    e1_paths = {f"C CLI -hdr {ENV_SIDE}^2 x {ENV_CLI_SPP} spp (app.main)":
                    e1["launches"]["cli"],
                **{f"C fwd+bwd {ENV_SIDE}^2 x {ENV_FB_SPP} spp (regen_scan), "
                   f"{part}": e1["launches"][part]
                   for part in ("forward", "recompute", "backward")}}
    kernels.append(
        {"name": "E1 envmap", "route": "cuda",
         "source": f"{PKG}/csrc/envmap.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/envmap.py:26",
         "replaces_note": "no TPU kernel: the reference's sample_bilinear, "
                          "four XLA gathers and a blend, its gradient XLA's "
                          "scatter-add",
         "launches": sum(e1_paths.values()), "launches_by_path": e1_paths,
         "max_abs_err": 0.0, "calls": e1["calls"], "lanes": e1["lanes"],
         "live_lanes": e1["live"], "ms": e1["ms"], "plain_ms": e1["plain_ms"],
         "bound_ms": e1["bound"], "bound_by": e1["by"],
         "grad_ms": e1["grad_ms"], "grad_bound_ms": e1["grad_bound"],
         "grad_bound_by": e1["grad_by"],
         "bound_note": "bytes over 3.35 TB/s: the lookup's (u, v) in and "
                       "12 B out a lane and the map once; the gradient's "
                       "12 B a lane, a live lane's (u, v) and four taps' "
                       "12 B, and the map zeroed",
         "library_ms": None,
         "library_note": "no PyTorch call computes a bilinear lookup with "
                         "wrap and clamp; plain_ms is the plain lookup's "
                         "gathers and blend and their autograd backward",
         "timed_by": "ms and grad_ms: CUDA events around 20 calls (the "
                     "latter the wrapper's zero fill and the kernel) on "
                     "the kept call of path C's fwd+bwd with the most live "
                     "lanes; plain_ms: CUDA events around 3 forward and "
                     "backward calls of the plain lookup"})
    tc_paths = {f"phase 28 regen frames {TC_SIDE}^2 x {TC_SPP} spp, each "
                "reduced form and bf16x3 with the second pass": tc["launches"],
                f"phase 28 regen frames {TC_SIDE}^2 x {TC_SPP} spp in "
                f"{TC_SIZE_FRAME_FORM} at (tile, block) "
                + ", ".join(f"({t}, {b})" for t, b in TC_SIZES):
                    tc["sizes_launches"],
                "bench_kernel": t1["tc_launches"]}
    kernels.append(
        {"name": "K1tc mesh_brute_tc", "route": "cuda",
         "source": f"{PKG}/csrc/mesh_brute_tc.cu",
         "replaces": "photorealistic_rendering_using_opencl_tpu/ops/mesh_brute.py:339",
         "replaces_note": "_make_kernel's split (:339-357) and bf16-table "
                          "(:366-368) branches and their dot (:396-404)",
         "launches": sum(tc_paths.values()), "launches_by_path": tc_paths,
         "max_abs_err": tc["err"], "ms": tc["ms"],
         "ms_l2_flushed": tc["flushed_ms"], "plain_ms": tc["plain_ms"],
         "bound_ms": tc["bound"], "bound_by": tc["by"], "library_ms": None,
         "library_note": "no PyTorch call computes a closest hit (see K1)",
         "bound_note": "the larger of the bytes (fragments, boxes, rays "
                       "once) over 3.35 TB/s and the operations: 80 T "
                       "tensor-core operations (4 quantities x 10 non-zero "
                       "features, multiply and add) a (ray, triangle) pair "
                       "of the active lanes of the relevant blocks, any-hit "
                       "lanes up to their first occluding tile, over 989 "
                       "TFLOP/s (bf16), or the FP32 hit and slab tests over "
                       "67 TFLOP/s, the larger",
         "timed_by": "ms and ms_l2_flushed: event_ms (an event pair around "
                     f"each of {TC_EVENT_REPS} launches behind a sleep, the "
                     "latter after a 256 MB fill), form bf16x6 on phase 3's "
                     "camera population; plain_ms: host clock around one "
                     "call of intersect_reduced_plain, ending in "
                     "torch.cuda.synchronize",
         "by_form": tc["forms"], "by_size": tc["sizes"],
         "resources": tc["resources"], "frames": tc["frames"],
         "k1_norel": tc["k1_norel"], "force_xla": tc["force_xla"]})
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
    log("crossover: " + json.dumps(sweep_out))
    log("default path: " + json.dumps(default))
    log("BDPT: " + json.dumps(bdpt))
    log("sharded: " + json.dumps(shard))
    log("remat: " + json.dumps(remat))
    log("graft and tools: " + json.dumps(graft_tools))
    log("tensor-core forms: " + json.dumps(tc))
    log(f"total {time.perf_counter() - t_start:.1f} s after the build")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(gpu_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
