"""The port's CUDA kernels against their plain twins, on the card.

Imports neither JAX nor the JAX package, so it also runs on a GPU machine
that has no JAX (tests/conftest.py imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a GPU every test here skips (decided inside the fixture).
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import (
    bvh_walk, compaction, intersect, mesh_brute, passthrough,
)
from photorealistic_rendering_using_opencl_tpu_torch.ops.intersect import ray_sort_key
from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import RAY_INF
from photorealistic_rendering_using_opencl_tpu_torch.scene.bvh_build import build_bvh
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 600  # not a multiple of the kernel's 128-ray block


@pytest.fixture
def cuda(monkeypatch):
    """The card.  Scenes load with the brute backend (K1) unless a test
    asks for the walk (W1): the card's own pick for a mesh is the walk
    above a size (scene/loader.py), and these tests hold K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setenv("PRT_MESH_ACCEL", "brute")
    return torch.device("cuda")


def _tables(dev, tile=mesh_brute.TILE):
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    order = build_bvh(tv).order
    bp = mesh_brute.pack_brute(tv[order], tn[order], tile=tile)
    return bp, [torch.from_numpy(x).to(dev) for x in bp[:3]]


def _batch(pop, bp, dev):
    """Rays of one population, even lanes closest, odd lanes any-hit with a
    short cap, every seventh lane inactive."""
    r = np.random.default_rng(("random", "camera", "surface").index(pop))
    d = r.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ex = np.full(N, -1, np.int32)
    if pop == "random":
        o = r.uniform(-2, 2, (N, 3)).astype(np.float32)
    elif pop == "camera":
        o = np.tile(np.array([0.0, 4 * np.sin(0.3), 4 * np.cos(0.3)],
                             np.float32), (N, 1))
        d = r.uniform(-0.9, 0.9, (N, 3)).astype(np.float32) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        n_live = int((np.abs(bp.tri_verts).sum(axis=(1, 2)) > 0).sum())
        ex = r.integers(0, n_live, N).astype(np.int32)
        uv = r.uniform(0, 1, (N, 2)).astype(np.float32)
        uv[uv.sum(1) > 1] = 1 - uv[uv.sum(1) > 1]
        v = bp.tri_verts[ex]
        o = (v[:, 0] * (1 - uv[:, 0:1] - uv[:, 1:2]) + v[:, 1] * uv[:, 0:1]
             + v[:, 2] * uv[:, 1:2]).astype(np.float32)
    anyh = np.arange(N) % 2 == 1
    t_init = np.where(anyh, 1.5, RAY_INF).astype(np.float32)
    act = np.arange(N) % 7 != 0
    return [torch.from_numpy(x).to(dev) for x in (o, d, t_init, act, anyh, ex)]


def _assert_like_twin(feat, clusters, o, d, t_init, act, anyh, ex, t, tri):
    """K1's outputs against the twin's on the same lanes: closest winners
    and occlusion flags equal (the 1e-5-per-ray flip limit is 0 at these
    sizes), inactive lanes (t_init, -1), any-hit lanes t_init, t of the
    closest hits within 1e-5."""
    tt, ttri = mesh_brute._intersect_xla(feat, clusters, o, d, t_init, act,
                                         exclude=ex)
    closest, anyhit = act & ~anyh, act & anyh
    assert torch.equal(tri[closest], ttri[closest])
    assert torch.equal(tri[anyhit] >= 0, ttri[anyhit] >= 0)
    assert (tri[~act] == -1).all() and torch.equal(t[~act], t_init[~act])
    assert torch.equal(t[anyhit], t_init[anyhit])
    hit = closest & (tri >= 0)
    assert hit.any()
    torch.testing.assert_close(t[hit], tt[hit], rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["unsorted", "sorted"])
@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
def test_k1_matches_twin(cuda, pop, order):
    """K1 against its twin, on the lanes in their order and sorted by the
    reference's key; the sorted batch's outputs, put back in lane order,
    are the unsorted batch's bit for bit."""
    bp, (feat, clusters, _) = _tables(cuda)
    lanes = _batch(pop, bp, cuda)
    t0, tri0 = mesh_brute.mesh_intersect(feat, clusters, *lanes[:3],
                                         active=lanes[3], any_hit=lanes[4],
                                         exclude=lanes[5])
    perm = torch.arange(N, device=cuda)
    if order == "sorted":
        perm = torch.sort(ray_sort_key(lanes[0], lanes[1], clusters),
                          stable=True).indices
        assert not torch.equal(perm, torch.arange(N, device=cuda))
    o, d, t_init, act, anyh, ex = [x[perm] for x in lanes]
    before = mesh_brute.mesh_brute_kernel.launches
    t, tri = mesh_brute.mesh_intersect(feat, clusters, o, d, t_init,
                                       active=act, any_hit=anyh, exclude=ex)
    assert mesh_brute.mesh_brute_kernel.launches == before + 1
    _assert_like_twin(feat, clusters, o, d, t_init, act, anyh, ex, t, tri)
    assert torch.equal(t, t0[perm]) and torch.equal(tri, tri0[perm])


def _tie_tables():
    """Three squares in planes z = 1 (x in [0, 2], [4, 6], [8, 10]), each
    split along its diagonal into two triangles: the first pair at indices
    5 and 130 (two tiles), the second at 60 and 61 (one tile, neighbouring
    lanes), the third at 3 and 35 (one tile, one lane's two slots).  A
    vertical ray through a diagonal's midpoint hits both triangles of its
    pair at exactly t = 1 (every coefficient and product is exact), so only
    the tie rule decides; the other slots are degenerate."""
    tv = np.zeros((256, 3, 3), np.float32)
    for x0, (a, b) in zip((0.0, 4.0, 8.0), ((5, 130), (60, 61), (3, 35))):
        p = np.array([[x0, 0, 1], [x0 + 2, 0, 1], [x0 + 2, 2, 1],
                      [x0, 2, 1]], np.float32)
        tv[a] = p[[0, 1, 2]]
        tv[b] = p[[0, 2, 3]]
    return mesh_brute.pack_brute(tv, np.zeros_like(tv))


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [32, 7])
def test_k1_ties_go_to_the_lower_index(cuda, lanes):
    """``lanes`` lanes of each warp shoot at a square, the others away from
    every square: with all 32 the warps run the squares' tiles in
    per-thread mode, with 7 in spread mode (the shuffle reduction)."""
    bp = _tie_tables()
    feat, clusters = (torch.from_numpy(x).to(cuda) for x in bp[:2])
    o = np.repeat(np.array([[1, 1, 0], [5, 1, 0], [9, 1, 0]], np.float32),
                  64, axis=0)  # two warps a square
    o[1::2, 2] = -1.0  # half of them from farther away: same t + 1
    up = np.arange(o.shape[0]) % 32 < lanes
    d = np.where(up[:, None], np.float32([0, 0, 1]), np.float32([0, 0, -1]))
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    up = torch.from_numpy(up).to(cuda)
    n = o.shape[0]
    t_init = torch.full((n,), 20.0, device=cuda)
    act = torch.ones(n, dtype=torch.bool, device=cuda)
    no = torch.zeros(n, dtype=torch.bool, device=cuda)
    ex = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    counters = torch.zeros(mesh_brute.K1_COUNTERS, dtype=torch.int64,
                           device=cuda)
    t, tri = mesh_brute.mesh_brute_kernel(feat, clusters, o, d, t_init, act,
                                          no, ex, counters=counters)
    tt, ttri = mesh_brute._intersect_xla(feat, clusters, o, d, t_init, act)
    want = torch.tensor([5, 60, 3], dtype=torch.int32,
                        device=cuda).repeat_interleave(64)
    want = torch.where(up, want, -1)
    assert torch.equal(ttri, want) and torch.equal(tri, want)
    assert torch.equal(t, tt)
    assert set(t[up].cpu().tolist()) == {1.0, 2.0}
    assert bool((t[~up] == 20.0).all())
    warp_tiles, _, _, pt_warp_tiles, _ = counters.tolist()
    assert warp_tiles > 0
    assert pt_warp_tiles == (warp_tiles if lanes == 32 else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 7, 31, 32])
def test_k1_warp_occupancy(cuda, k):
    """Warps in which exactly k lanes need the tiles on their path (k
    copies of one ray a warp, the other lanes active but far from the mesh
    and pointing away), so both sides of the popcount switch run, against
    the twin: the kernel runs a tile per thread only when all 32 lanes of
    the warp need it (PER_THREAD_FROM in csrc/mesh_brute.cu), else spread
    across the warp."""
    bp, (feat, clusters, _) = _tables(cuda)
    warps = 16
    r = np.random.default_rng(k)
    o = r.normal(size=(warps, 3)).astype(np.float32)
    o = 2.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = (np.array([0.1, -0.2, 0.3], np.float32)  # at the icosphere
         + r.uniform(-0.3, 0.3, (warps, 3)).astype(np.float32) - o)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    idx = torch.arange(warps * 32, device=cuda)
    lane, warp = idx % 32, idx // 32
    need = lane < k
    o_k = torch.where(need[:, None], o[warp], torch.tensor(
        [50.0, 50.0, 50.0], device=cuda))
    d_k = torch.where(need[:, None], d[warp], torch.tensor(
        [1.0, 0.0, 0.0], device=cuda))
    n = idx.shape[0]
    anyh = (warp % 2 == 1)  # every other warp any-hit, capped
    t_init = torch.where(anyh, 1.5, RAY_INF).to(torch.float32)
    act = torch.ones(n, dtype=torch.bool, device=cuda)
    ex = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    counters = torch.zeros(mesh_brute.K1_COUNTERS, dtype=torch.int64,
                           device=cuda)
    t, tri = mesh_brute.mesh_brute_kernel(feat, clusters, o_k, d_k, t_init,
                                          act, anyh, ex, counters=counters)
    _assert_like_twin(feat, clusters, o_k, d_k, t_init, act, anyh, ex, t, tri)
    warp_tiles, ray_tiles, _, pt_warp_tiles, pt_ray_tiles = counters.tolist()
    assert warp_tiles > 0
    assert ray_tiles == k * warp_tiles  # k lanes need each tile processed
    assert pt_warp_tiles == (warp_tiles if k == 32 else 0)
    assert pt_ray_tiles == k * pt_warp_tiles


@pytest.mark.cuda
def test_k1_large_table_matches_twin(cuda):
    """A table of 1,700 tiles (217,600 small random triangles, in grid-cell
    order), whose tile boxes take 54,400 B of shared memory a block: above
    the 48 KB a launch gets without opting in.  Two launches against the
    twin."""
    r = np.random.default_rng(17)
    n_tri = 1700 * mesh_brute.TILE
    c = r.uniform(-1, 1, (n_tri, 1, 3)).astype(np.float32)
    tv = (c + 0.03 * r.normal(size=(n_tri, 3, 3))).astype(np.float32)
    cell = np.floor((c[:, 0] + 1) * 6).astype(np.int64)
    tv = tv[np.lexsort((cell[:, 2], cell[:, 1], cell[:, 0]))]
    bp = mesh_brute.pack_brute(tv, np.zeros_like(tv))
    feat, clusters = (torch.from_numpy(x).to(cuda) for x in bp[:2])
    assert clusters.shape[0] * 32 > 48 * 1024
    lanes = _batch("random", bp, cuda)
    before = mesh_brute.mesh_brute_kernel.launches
    for _ in range(2):
        t, tri = mesh_brute.mesh_intersect(feat, clusters, *lanes[:3],
                                           active=lanes[3], any_hit=lanes[4],
                                           exclude=lanes[5])
        _assert_like_twin(feat, clusters, *lanes, t, tri)
    assert mesh_brute.mesh_brute_kernel.launches == before + 2


@pytest.mark.cuda
def test_k1_wrapper_validates_arguments(cuda):
    bp, (feat, clusters, _) = _tables(cuda)
    o, d, t_init, act, anyh, ex = _batch("random", bp, cuda)
    with pytest.raises(TypeError, match="origin"):
        mesh_brute.mesh_brute_kernel(feat, clusters, o.double(), d, t_init,
                                     act, anyh, ex)
    with pytest.raises(ValueError, match="t_init"):
        mesh_brute.mesh_brute_kernel(feat, clusters, o, d, t_init.cpu(),
                                     act, anyh, ex)


@pytest.mark.cuda
@pytest.mark.parametrize("vignette", [True, False])
def test_k2_matches_plain(cuda, vignette):
    img = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 3, (64, 48, 3)).astype(np.float32)).to(cuda)
    before = tm.tonemap_kernel.launches
    got = tm.tonemap(img, vignette=vignette, brightness=1.7)
    assert tm.tonemap_kernel.launches == before + 1
    want = tm.tonemap_plain(img, vignette=vignette, brightness=1.7)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def _k2_large(h, w, seed, cs):
    """uniform(0, 3) radiance with 10,000 seeded channels from the edge set."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 3.0, (h, w, 3)).astype(np.float32)
    img.reshape(-1)[rng.integers(0, 3 * h * w, 10000)] = np.resize(
        np.array(cs.K2_EDGES, np.float32), 10000)
    return img


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["edge set", "ragged", "misaligned",
                                  "1920x1080", "4096x4096"])
def test_k2_edges_and_sizes_match_plain(cuda, case):
    """K2 against its plain version on chip_smoke's edge set (NaN, +-inf,
    negatives, 0, 1e-8, 1e4, 1e20 on sides of 1, 3, 33 and 47), pixel
    counts that are not a multiple of 4, a view 99 floats into its storage
    (not 16-byte aligned), 1920x1080, and 4096x4096 (the grid-stride loop
    goes round more than once): NaN in the same channels, the rest within
    1e-6, at vignette on/off and brightness 1.0/1.7, one launch a call."""
    cs = _chip_smoke()
    if case == "edge set":
        imgs = [torch.from_numpy(cs.k2_edge_image(h, w, 100 * h + w))
                for h, w in cs.K2_EDGE_SIZES]
    elif case == "ragged":  # h * w % 4 = 1, 2, 3, 1, 3
        imgs = [torch.from_numpy(cs.k2_edge_image(h, w, h + w))
                for h, w in ((5, 33), (1, 2), (3, 5), (7, 7), (1, 3))]
    elif case == "misaligned":
        imgs = [torch.from_numpy(cs.k2_edge_image(5, 33, 533)).to(cuda)[1:]]
        assert imgs[0].data_ptr() % 16 and imgs[0].is_contiguous()
    else:
        w, h = map(int, case.split("x"))
        imgs = [torch.from_numpy(_k2_large(h, w, w, cs))]
    for img in imgs:
        img = img.to(cuda)
        for vignette in (True, False):
            for brightness in (1.0, 1.7):
                before = tm.tonemap_kernel.launches
                got = tm.tonemap(img, vignette=vignette, brightness=brightness)
                assert tm.tonemap_kernel.launches == before + 1
                want = tm.tonemap_plain(img, vignette=vignette,
                                        brightness=brightness)
                assert bool(torch.isnan(want).any())
                assert cs.k2_compare(got, want)[0] == 0
                assert cs.k2_compare(got, want)[1] <= 1e-6


@pytest.mark.cuda
def test_render_on_card_matches_golden(cuda):
    """The mesh_icosphere golden (tests/golden_tool.py), rendered through K1
    on the card, at tests/test_golden.py's tolerance."""
    cfg, scene = load_scene(os.path.join(REPO, "scenes/cornell_simple.json"),
                            mesh_override=make_icosphere(1, 0.7, (0.0, 0.8, 0.0)),
                            device=cuda)
    before = mesh_brute.mesh_brute_kernel.launches
    img, alpha = pathtracer.render(cfg, scene, default_camera(32, 32).pytree(cuda),
                                   32, 32, 4, seed=9, method="regen")
    assert mesh_brute.mesh_brute_kernel.launches > before
    with np.load(os.path.join(REPO, "tests/golden/mesh_icosphere.npz")) as z:
        np.testing.assert_allclose(img.cpu().numpy(), z["img"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(alpha.cpu().numpy(), z["alpha"], rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [32, 256, 1024])
def test_k3_matches_plain(cuda, block):
    """K3 bitwise against its plain version, ragged sizes and every
    density, and compact_indices against its CPU run."""
    rng = np.random.default_rng(block)
    for n in (1, 1023, 1025, 3000, 262144):
        for density in (0.0, 0.03, 0.5, 0.97, 1.0):
            f = torch.from_numpy((rng.uniform(size=n) < density)
                                 .astype(np.int32))
            before = compaction.block_scan_kernel.launches
            scan, total = compaction.exclusive_prefix_sum(f.to(cuda), block)
            assert compaction.block_scan_kernel.launches == before + 1
            want, want_total = compaction.exclusive_prefix_sum(f, block)
            assert torch.equal(scan.cpu(), want)
            assert int(total) == int(want_total)
    alive = torch.from_numpy(rng.uniform(size=5000) < 0.4)
    perm, n_alive = compaction.compact_indices(alive.to(cuda))
    want_perm, want_n = compaction.compact_indices(alive)
    assert torch.equal(perm.cpu(), want_perm) and int(n_alive) == int(want_n)


def _fwd_bwd_card_and_cpu(cuda, bounces=None):
    """value-and-grad through regen_scan of cornell + icosphere, 16^2 x 2
    spp, on the CPU (K1's twin) and on the card (K1): per device the
    image, the (colour, camera position) leaves and the (cfg, scene,
    camera) that rendered it."""
    mesh = make_icosphere(1, 0.8, (0.0, 1.0, 0.0))
    runs = {}
    for dev in ("cpu", cuda):
        cfg, sc = load_scene(os.path.join(REPO, "scenes/cornell.json"),
                             mesh_override=mesh, device=dev)
        if bounces is not None:
            cfg = dataclasses.replace(cfg, max_bounces=bounces)
        cam = default_camera(16, 16).pytree(dev)
        n = pathtracer.calibrate_regen_iters(cfg, sc, cam, 16, 16, 2, seed=3)
        color = sc.color.clone().requires_grad_()
        pos = cam["position"].clone().requires_grad_()
        before = mesh_brute.mesh_brute_kernel.launches
        img, _ = pathtracer.render(cfg, dataclasses.replace(sc, color=color),
                                   {**cam, "position": pos}, 16, 16, 2, seed=3,
                                   method="regen_scan", regen_iters=n)
        launched = mesh_brute.mesh_brute_kernel.launches - before
        assert launched == (n if dev == cuda else 0)
        runs[str(dev)] = (n, img, [color, pos], (cfg, sc, cam))
    (n0, i0, l0, s0), (n1, i1, l1, s1) = runs["cpu"], runs[str(cuda)]
    assert n0 == n1
    return (i0, l0, s0), (i1, l1, s1)


def _mean_grads(runs, keep):
    out = []
    for img, leaves in runs:
        k = keep.to(img.device)[..., None]
        loss = (img * k).sum() / (k.sum() * 3)
        out.append([g.cpu() for g in torch.autograd.grad(loss, leaves)])
    return out


@pytest.mark.cuda
def test_fwd_bwd_on_card_matches_cpu_4_bounces(cuda):
    """At 4 bounces nothing is left out: every pixel within
    tests/test_torch_grad.py's <= 4-bounce forward bound, and the gradients
    of the whole mean image within its rtol 1e-4 / atol 1e-6."""
    (i0, l0, _), (i1, l1, _) = _fwd_bwd_card_and_cpu(cuda, bounces=4)
    torch.testing.assert_close(i1.detach().cpu(), i0.detach(), rtol=1e-5,
                               atol=1e-5)
    want, got = _mean_grads([(i0, l0), (i1, l1)],
                            torch.ones(i0.shape[:2], dtype=torch.bool))
    for w, g in zip(want, got):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_fwd_bwd_on_card_matches_cpu(cuda):
    """value-and-grad through regen_scan on the card (K1) against the same
    on the CPU (K1's twin): cornell + icosphere, 32 bounces.  Every pixel's
    path is traced on both devices (chip_smoke.lane_trace); only pixels
    where an ulp of difference between the two devices' float math made a
    path decision part (at most 1%) are left out.  Every other pixel agrees
    within the 32-bounce forward bound, and the gradients of the mean over
    them at tests/test_torch_grad.py's 32-bounce bound."""
    cs = _chip_smoke()
    (i0, l0, s0), (i1, l1, s1) = _fwd_bwd_card_and_cpu(cuda)
    lanes = torch.arange(i0.shape[0] * i0.shape[1])
    traces = [cs.lane_trace(cfg, sc, cam, 16, 2, 3, lanes)
              for cfg, sc, cam in (s1, s0)]
    parted_at = cs.trace_parting(*traces, 5e-4)[0]
    keep = (parted_at < 0).reshape(i0.shape[:2])
    assert int((~keep).sum()) <= 0.01 * keep.numel()
    torch.testing.assert_close(i1.detach().cpu()[keep], i0.detach()[keep],
                               rtol=5e-4, atol=5e-4)
    for want, got in zip(*_mean_grads([(i0, l0), (i1, l1)], keep)):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=5e-4,
                                   atol=5e-4 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256])
def test_t1_matches_plain(cuda, block):
    """T1 against its plain version on the same relevance words: the two
    sum in other orders, so the bound is 1e-5 of each ray's sum of absolute
    terms; the index output is all zero."""
    bp, (feat, clusters, _) = _tables(cuda)
    o, d, t_init, act, _, _ = _batch("random", bp, cuda)
    words = mesh_brute.relevance_words(clusters, o, d, t_init, act, block)
    pack = mesh_brute.matmul_only_pack(o, d, t_init)
    before = mesh_brute.matmul_only_kernel.launches
    t, i = mesh_brute.matmul_only(words, pack, feat, block)
    assert mesh_brute.matmul_only_kernel.launches == before + 1
    want, _ = mesh_brute.matmul_only_plain(words, pack, feat, block)
    scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(), feat.abs(),
                                            block)
    assert not i.any() and (scale > 0).any()
    assert float(((t - want).abs() / scale.clamp(min=1e-30)).max()) <= 1e-5


@pytest.mark.cuda
def test_t2_copies_bitwise(cuda):
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(262144, 3)).astype(np.float32)).to(cuda)
    a0 = passthrough.passthrough_kernel.launches
    b0 = passthrough.passthrough_flat_kernel.launches
    for n in (262144, 1000):  # 1000 rows: a ragged last block
        y = passthrough.passthrough(x[:n].contiguous())
        assert torch.equal(y, x[:n]) and y.data_ptr() != x.data_ptr()
    flat = x.reshape(-1)
    assert torch.equal(passthrough.passthrough_flat(flat), flat)
    assert passthrough.passthrough_kernel.launches == a0 + 2
    assert passthrough.passthrough_flat_kernel.launches == b0 + 1
    with pytest.raises(ValueError, match="128"):
        passthrough.passthrough_flat(flat[:1000])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5, 1000, 262145, 2_000_000])
@pytest.mark.parametrize("offset", [0, 1])
def test_t2a_copies_bitwise(cuda, n, offset):
    """T2a against x.clone(), bitwise with NaN payloads, where 3N % 4 != 0
    (N = 1, 5, 262,145), past the grid's cap (2,000,000 rows: the
    grid-stride loop goes round twice on an H100), and from an [N, 3] view
    whose data starts one float past a 16-byte boundary; one launch."""
    rng = np.random.default_rng(n + offset)
    host = rng.normal(size=3 * n + 1).astype(np.float32)
    payloads = np.array([0x7FC00000, 0x7F800001, 0x7FFFFFFF, 0xFFC00001],
                        np.uint32)
    host.view(np.uint32)[::7] = np.resize(payloads, host[::7].size)
    flat = torch.from_numpy(host).to(cuda)
    x = flat[offset:offset + 3 * n].view(n, 3)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    before = passthrough.passthrough_kernel.launches
    y = passthrough.passthrough(x)
    assert passthrough.passthrough_kernel.launches == before + 1
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(y.view(torch.int32), x.clone().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128 * 12345, 128 * 50000])
def test_t2b_copies_bitwise(cuda, n):
    """T2b against x.clone(), bitwise, where the grid's last vectors are
    ragged (1,580,160 floats) and where the grid-stride loop goes round
    more than once (6,400,000 floats, past the grid's cap on an H100)."""
    x = torch.from_numpy(np.random.default_rng(n).normal(size=n).astype(
        np.float32)).to(cuda)
    x[::977] = float("nan")
    y = passthrough.passthrough_flat(x)
    assert torch.equal(y.view(torch.int32), x.clone().view(torch.int32))


@pytest.mark.cuda
def test_scan_render_on_card_matches_cpu(cuda):
    """render's default method (trace, scan) of cornell + icosphere at 4
    bounces, 16^2 x 2 spp, on the card against the CPU, within 1e-5;
    K1 runs spp * (n_steps + 1) times on the card."""
    mesh = make_icosphere(1, 0.8, (0.0, 1.0, 0.0))
    imgs = []
    for dev in ("cpu", cuda):
        cfg, sc = load_scene(os.path.join(REPO, "scenes/cornell.json"),
                             mesh_override=mesh, device=dev)
        cfg = dataclasses.replace(cfg, max_bounces=4)
        before = mesh_brute.mesh_brute_kernel.launches
        img, _ = pathtracer.render(cfg, sc, default_camera(16, 16).pytree(dev),
                                   16, 16, 2, seed=3)
        launched = mesh_brute.mesh_brute_kernel.launches - before
        assert launched == (2 * (4 + 1) if dev == cuda else 0)
        imgs.append(img.cpu())
    torch.testing.assert_close(imgs[1], imgs[0], rtol=1e-5, atol=1e-5)


def _t1_case(dev, case, block):
    """T1 inputs for one edge case -> (words, pack, feat): the icosphere
    tables (10 tiles) with random rays at several ragged N; the same
    tables with all-zero and with all-one words (bits 10-31 of the one
    word lie past the table: ignored); and a table with empty tiles (a
    300-triangle mesh, whose third tile is a third padding, and three
    all-zero tiles between the others) with every bit set."""
    bp, (feat, clusters, _) = _tables(dev)
    rng = np.random.default_rng(block)
    n = {"ragged": 1000, "zero words": 600, "all bits": 600,
         "empty tiles": 700}[case]
    o = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32)).to(dev)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=1, keepdims=True)).to(dev)
    t_init = torch.from_numpy(rng.uniform(0.5, 20, n).astype(np.float32)).to(dev)
    act = torch.from_numpy(rng.uniform(size=n) > 0.1).to(dev)
    pack = mesh_brute.matmul_only_pack(o, d, t_init)
    if case == "empty tiles":
        tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
        small = torch.from_numpy(mesh_brute.pack_brute(tv[:300], tn[:300]).feat)
        z = torch.zeros((mesh_brute.FEAT, 4 * mesh_brute.TILE))
        t = [small[:, k * 512:(k + 1) * 512] for k in range(3)]
        feat = torch.cat([t[0], z, t[1], z, z, t[2]], dim=1).contiguous().to(dev)
    nt = feat.shape[1] // (4 * mesh_brute.TILE)
    rows = -(-n // block)
    if case == "ragged":
        return [(mesh_brute.relevance_words(clusters, o[:m], d[:m],
                                            t_init[:m], act[:m], block),
                 pack[:, :m].contiguous(), feat)
                for m in (1, 100, block - 1, block + 1, 2 * block + 7, n)]
    fill = 0 if case == "zero words" else -1
    words = torch.full((rows, -(-nt // 32)), fill, dtype=torch.int32,
                       device=dev)
    return [(words, pack, feat)]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("case", ["ragged", "zero words", "all bits",
                                  "empty tiles"])
def test_t1_edge_cases_match_plain(cuda, case, block):
    """T1 against its plain version within 1e-5 of each ray's sum of
    absolute terms, one launch a call, the index output all zero: N below
    one block, ragged last warps and blocks, words with no bit (the sum is
    exactly 0), words with every bit (those past the table ignored), and
    a table with empty and part-padding tiles."""
    summed = 0
    for words, pack, feat in _t1_case(cuda, case, block):
        before = mesh_brute.matmul_only_kernel.launches
        t, i = mesh_brute.matmul_only(words, pack, feat, block)
        assert mesh_brute.matmul_only_kernel.launches == before + 1
        want, _ = mesh_brute.matmul_only_plain(words, pack, feat, block)
        scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(),
                                                feat.abs(), block)
        assert t.shape == want.shape and not i.any()
        if case == "zero words":
            assert not t.any()
            continue
        summed += int((scale > 0).sum())
        err = (t - want).abs()
        assert not err[scale == 0].any()
        assert float((err / scale.clamp(min=1e-30)).max()) <= 1e-5
    assert summed > 0 or case == "zero words"


@pytest.mark.cuda
@pytest.mark.parametrize("block", [32, 64, 128, 256, 512, 1024])
def test_k3_every_block_bitwise(cuda, block):
    """K3 bitwise against its plain version on the card and on the CPU at
    every block it takes: whole and ragged grids of 1,024-flag CTAs, flag
    densities 0, 0.5 and 1, int32 wrap-around (values near 2^30 summed
    past 2^31), and a flags view that starts off a 16-byte boundary; then
    ragged N through exclusive_prefix_sum."""
    rng = np.random.default_rng(block + 1)
    inputs = []
    for nb in (1, 2, 3, 5, 257, 1000):
        for density in (0.0, 0.5, 1.0):
            inputs.append((rng.uniform(size=nb * block) < density)
                          .astype(np.int32))
    inputs.append(rng.integers(2**29, 2**30, 7 * block).astype(np.int32))
    for f in inputs:
        f_card = torch.from_numpy(f).to(cuda)
        before = compaction.block_scan_kernel.launches
        scans, totals = compaction.block_scan(f_card, block)
        assert compaction.block_scan_kernel.launches == before + 1
        for want in (compaction.block_scan_plain(f_card, block),
                     compaction.block_scan_plain(torch.from_numpy(f), block)):
            assert torch.equal(scans.cpu(), want[0].cpu())
            assert torch.equal(totals.cpu(), want[1].cpu())
    view = torch.from_numpy(inputs[-1]).to(cuda)[1:1 + 6 * block]
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = compaction.block_scan(view, block)
    want = compaction.block_scan_plain(view.cpu(), block)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(),
                                                              want[1])
    for n in (1, block - 1, 5 * block + 3, 40000):
        f = torch.from_numpy((rng.uniform(size=n) < 0.5).astype(np.int32))
        scan, total = compaction.exclusive_prefix_sum(f.to(cuda), block)
        want, want_total = compaction.exclusive_prefix_sum(f, block)
        assert torch.equal(scan.cpu(), want) and int(total) == int(want_total)


@pytest.mark.cuda
def test_k2_bands_match_plain(cuda):
    """Images launched in bands of 4,100 pixels (chip_smoke.k2_banded cuts
    BAND_PIXELS down), so that bands start inside rows and the vignette
    needs each band's row and column: against the plain version, vignette
    on and off, NaN in the same channels and the rest within 1e-6."""
    cs = _chip_smoke()
    sides = ((512, 512), (47, 333), (101, 97))
    cases = {f"{h}x{w}": torch.from_numpy(cs.k2_edge_image(h, w, h * w))
             .to(cuda) for h, w in sides}
    before = tm.tonemap_kernel.launches
    assert cs.k2_banded(tm, cases) <= 1e-6
    # a launch a band, at vignette on and off: 64 + 4 + 3 bands
    assert tm.tonemap_kernel.launches - before == 2 * sum(
        -(-h * w // cs.K2_SMALL_BAND) for h, w in sides) == 142
    assert tm.BAND_PIXELS == 1 << 29


@pytest.mark.cuda
def test_k2_image_past_int32_matches_plain(cuda):
    """One 26755 x 26755 image (3*H*W = 2,147,490,075 > 2^31 - 1; 8.6 GB in
    and out), vignette off, launched in two bands: rows at its ends and
    around the band boundary against the plain version of those rows
    (chip_smoke.k2_huge, which fails on any NaN difference or one above
    1e-6)."""
    before = tm.tonemap_kernel.launches
    assert _chip_smoke().k2_huge(tm, cuda) <= 1e-6
    assert tm.tonemap_kernel.launches == before + 2


@pytest.mark.cuda
def test_kernels_launch_on_the_tensors_device(cuda):
    """With cuda:0 current and every tensor on cuda:1, each kernel runs on
    cuda:1 and agrees with its plain version (K1 with its twin).  Skips
    on a machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    dev = torch.device("cuda", 1)
    with torch.cuda.device(0):
        bp, (feat, clusters, _) = _tables(dev)
        lanes = _batch("random", bp, dev)
        t, tri = mesh_brute.mesh_intersect(feat, clusters, *lanes[:3],
                                           active=lanes[3], any_hit=lanes[4],
                                           exclude=lanes[5])
        _assert_like_twin(feat, clusters, *lanes, t, tri)
        img = torch.from_numpy(np.random.default_rng(2).uniform(
            0, 3, (64, 48, 3)).astype(np.float32)).to(dev)
        torch.testing.assert_close(tm.tonemap(img), tm.tonemap_plain(img),
                                   rtol=0, atol=1e-6)
        f = (torch.arange(3000, device=dev) % 3 == 0).to(torch.int32)
        scan, total = compaction.exclusive_prefix_sum(f, 256)
        want, want_total = compaction.exclusive_prefix_sum(f.cpu(), 256)
        assert torch.equal(scan.cpu(), want) and int(total) == int(want_total)
        words = mesh_brute.relevance_words(clusters, *lanes[:3], lanes[3],
                                           128)
        pack = mesh_brute.matmul_only_pack(*lanes[:3])
        got, _ = mesh_brute.matmul_only(words, pack, feat, 128)
        plain, _ = mesh_brute.matmul_only_plain(words, pack, feat, 128)
        scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(),
                                                feat.abs(), 128)
        assert float(((got - plain).abs() / scale.clamp(min=1e-30)).max()) <= 1e-5
        x = lanes[0].clone()
        assert torch.equal(passthrough.passthrough(x), x)
        flat = torch.arange(1280, dtype=torch.float32, device=dev)
        assert torch.equal(passthrough.passthrough_flat(flat), flat)
        assert torch.cuda.current_device() == 0
    torch.cuda.synchronize(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["threefry", "mwc"])
def test_other_rng_schemes_bitwise_card_vs_cpu(cuda, scheme):
    """threefry2x32 / mwc_hash words and Sampler draws: the card's are the
    CPU's, bit for bit, edges included."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import rng
    r = np.random.default_rng(71)
    w = r.integers(0, 2 ** 32, (4096, 4), dtype=np.uint64)
    w[:4] = [[0, 0, 0, 0], [0xFFFFFFFF] * 4, [0, 0xFFFFFFFF, 0, 0xFFFFFFFF],
             [0xFFFFFFFF, 0, 0xFFFFFFFF, 0]]
    cols = [torch.from_numpy(w[:, i].astype(np.int64)) for i in range(4)]
    card = [c.to(cuda) for c in cols]
    if scheme == "threefry":
        want, got = rng.threefry2x32(*cols), rng.threefry2x32(*card)
    else:
        want, got = [rng.mwc_hash(*cols[:2])], [rng.mwc_hash(*card[:2])]
    for a, b in zip(want, got):
        assert torch.equal(a, b.cpu())
    dim = cols[2] % 2 ** 28 * 4
    for seed in (0, 0xFFFFFFFF):
        s_c = rng.Sampler(cols[0], cols[1], seed=seed, scheme=scheme, dim=dim)
        s_d = rng.Sampler(card[0], card[1], seed=seed, scheme=scheme,
                          dim=dim.to(cuda))
        for _ in range(5):
            assert s_c.next1d().numpy().tobytes() == s_d.next1d().cpu().numpy().tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["pcg4d", "threefry", "mwc"])
def test_progressive_on_card_matches_cpu(cuda, scheme):
    """progressive_step on cornell_simple (4 bounces) with each scheme:
    the card's image (the running mean) within 1e-5 of the CPU's, the
    repo's <= 4-bounce bound on images; samples and seed equal.  The
    3-sample sum differs by up to 2.5e-5 of its value at one pixel (mwc;
    image 9.8e-6): 1-ulp differences of six ops, carried along its path
    (test_progressive_on_card_is_cpu_but_for_six_ops)."""
    path = os.path.join(REPO, "scenes/cornell_simple.json")
    states = {}
    for dev in (cuda, torch.device("cpu")):
        cfg, sc = load_scene(path, device=dev)
        cam = default_camera(32, 24).pytree(dev)
        st = pathtracer.progressive_init(32, 24, seed=0xFFFFFFF0, device=dev)
        for _ in range(3):
            st = pathtracer.progressive_step(cfg, sc, cam, st, rng_scheme=scheme)
        states[dev.type] = st
    card, cpu = states["cuda"], states["cpu"]
    assert card.acc.device.type == "cuda"
    assert int(card.samples) == int(cpu.samples) == 3
    assert int(card.seed) == int(cpu.seed) == 0xFFFFFFF0
    for a, b in zip(pathtracer.progressive_image(card),
                    pathtracer.progressive_image(cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["pcg4d", "threefry", "mwc"])
def test_progressive_on_card_is_cpu_but_for_six_ops(cuda, scheme):
    """The cause of the card-vs-CPU gap above: with the six ATen ops of
    chip_smoke.CARD_OTHER_BITS_OPS evaluated on the CPU (sin, cos, tan,
    sqrt, a division by a Python number, a 3-term sum), the card's
    progressive state after 3 steps is bitwise the CPU's.  Every other op
    of the frame gives the card the CPU's bits."""
    cs = _chip_smoke()
    want = cs.census_run(torch.device("cpu"), scheme)()
    got = cs.ops_on_cpu(cs.census_run(cuda, scheme),
                        set(cs.CARD_OTHER_BITS_OPS))
    assert got.acc.device.type == "cuda"
    assert torch.equal(got.acc.cpu(), want.acc)
    assert torch.equal(got.alpha.cpu(), want.alpha)
    assert int(got.samples) == int(want.samples) == cs.CENSUS_STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mesh_id", "traversal", "normal"])
def test_render_aov_on_card_matches_cpu(cuda, mode):
    """The AOVs of the icosphere scene (K1 on the card, its twin on the
    CPU): mesh_id and traversal bitwise, normal within 1e-5."""
    path = os.path.join(REPO, "scenes/cornell.json")
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cfg, sc = load_scene(path, mesh_override=mesh, device=dev)
        out[dev.type] = pathtracer.render_aov(
            cfg, sc, default_camera(40, 40).pytree(dev), 40, 40, mode=mode).cpu()
    if mode == "normal":
        torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-5, atol=1e-5)
    else:
        assert torch.equal(out["cuda"], out["cpu"])
    assert out["cuda"].any()


@pytest.mark.cuda
def test_ray_cluster_count_on_card_bitwise(cuda, monkeypatch):
    bp, (feat, clusters, _) = _tables(cuda)
    o, d = _batch("random", bp, cuda)[:2]
    want = mesh_brute.ray_cluster_count(clusters.cpu(), o.cpu(), d.cpu(), RAY_INF)
    monkeypatch.setattr(mesh_brute, "CLUSTER_COUNT_CHUNK", 77)
    got = mesh_brute.ray_cluster_count(clusters, o, d, RAY_INF)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cli_in_process_on_card(cuda, tmp_path):
    """app.main on the card: K1 once per dispatch (bounces + one camera
    dispatch a sample), K2 once at export, the image bitwise
    render(method="while"), its PNG the same quantisation of the CPU's
    tonemap within 1 LSB."""
    import contextlib
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    from photorealistic_rendering_using_opencl_tpu_torch.runtime.camera import (
        InteractiveCamera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.runtime.checkpoint import (
        load_checkpoint,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.utils.image import read_png
    bounces = [0]
    real = integrator._trace_shade

    def shade(*a, **k):
        bounces[0] += 1
        return real(*a, **k)

    ck, png = str(tmp_path / "c.npz"), str(tmp_path / "c.png")
    integrator._trace_shade = shade
    try:
        mesh_brute.mesh_brute_kernel.launches = 0
        tm.tonemap_kernel.launches = 0
        with contextlib.chdir(REPO):
            assert app.main(["-scene", "scenes/cornell_hi.json", "-width", "96",
                             "-height", "64", "-spp", "3", "--checkpoint", ck,
                             "-o", png]) == 0
        k1, k2 = mesh_brute.mesh_brute_kernel.launches, tm.tonemap_kernel.launches
    finally:
        integrator._trace_shade = real
    assert k1 == bounces[0] + 3 and k2 == 1
    state, _, _ = load_checkpoint(ck, device=cuda)
    cfg, sc = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                         models_dir=os.path.join(REPO, "scenes/assets"),
                         device=cuda)
    cam = InteractiveCamera(resolution=(96, 64)).build_render_camera().pytree(cuda)
    with torch.no_grad():
        want, want_a = pathtracer.render(cfg, sc, cam, 96, 64, 3, method="while")
    img, alpha = pathtracer.progressive_image(state)
    assert torch.equal(img, want) and torch.equal(alpha, want_a)
    plain = app.ldr_u8(tm.tonemap_plain(img.cpu())).astype(np.int32)
    assert np.abs(read_png(png).astype(np.int32) - plain).max() <= 1


# ---------------------------------------------------------------------------
# SDFs + mesh, media, env maps (BASELINE configs 3-5) at 64^2
# ---------------------------------------------------------------------------

def _slice8(cuda):
    cs = _chip_smoke()
    return cs, make_icosphere(**cs.CVC8_MESH)


@pytest.mark.cuda
def test_sdf_path_on_card_matches_cpu(cuda):
    """sdf_demo.json + an icosphere at 64^2: one bounce on the same camera
    rays within 1e-5 of the CPU on every pixel (the SDF values are bitwise
    on both devices); the 8-bounce image's mean within 2e-3 (an ulp of a
    sampled direction reaches an SDF normal magnified ~1e3)."""
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    cs, mesh = _slice8(cuda)
    s = 64
    px, py = pathtracer.pixel_grid(s, s, "cpu")
    o, d = pathtracer.camera_rays_for_sample(
        default_camera(s, s).pytree("cpu"), s, s, px, py, py * s + px, 0, 0)
    got = []
    for dev in ("cpu", cuda):
        cfg, sc, _ = cs.sdf_scene(dev, mesh, bounces=1, side=s)
        with torch.no_grad():
            rad, _ = integrator.trace(cfg, sc, o.to(dev), d.to(dev),
                                      (py * s + px).to(dev), 0, method="while")
            cfg8, sc8, cam8 = cs.sdf_scene(dev, mesh, side=s)
            deep, _ = pathtracer.render(cfg8, sc8, cam8, s, s, 2, seed=1,
                                        method="regen")
        got.append((rad.cpu(), deep.cpu()))
    torch.testing.assert_close(got[1][0], got[0][0], rtol=1e-5, atol=1e-5)
    assert abs(float(got[1][1].mean()) / float(got[0][1].mean()) - 1) < 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize("medium", ["homogeneous", "exponential"])
def test_media_path_on_card_matches_cpu(cuda, medium):
    """cornell_media.json (and its height fog) + an icosphere, HG, 4
    bounces, 64^2 x 1 spp by regen: every pixel within chip_smoke's
    FWD_MEDIUM of the CPU but those whose traced path takes another
    decision (at most 3%)."""
    cs, mesh = _slice8(cuda)
    m = None if medium == "homogeneous" else cs.MEDIUM_EXP
    cs.path_traced_vs_cpu(cuda, f"media {medium}",
                          lambda d: cs.media_scene(d, mesh, m, "hg", 4, 64),
                          64, 1, 5, cs.FWD_MEDIUM)


@pytest.mark.cuda
def test_env_path_on_card_matches_cpu(cuda):
    """materials.json lit by a 128 x 64 map through a thin lens, 4 bounces,
    64^2 x 1 spp by regen: as the medium path, at chip_smoke's
    FWD_MATERIALS with up to GOLDEN_PARTED of the pixels parted (refraction
    and Fresnel at grazing angles magnify an ulp of a direction)."""
    cs, _ = _slice8(cuda)
    env = cs.seeded_env_map(64, 128)
    cs.path_traced_vs_cpu(cuda, "env map",
                          lambda d: cs.env_scene(d, env, 64, 4), 64, 1, 5,
                          cs.FWD_MATERIALS, cs.GOLDEN_PARTED)


@pytest.mark.cuda
def test_env_map_gradient_on_card_matches_cpu(cuda):
    """d mean(image) / d env_map through regen_scan, cornell_simple lit by
    a 64 x 32 map through a thin lens, 32^2 x 2 spp, 2 bounces: every
    pixel's path traced on both devices (chip_smoke.lane_trace); the
    gradient of the mean over the pixels whose paths take the same
    decisions within rtol 1e-4 / atol 1e-6 of the CPU's.  The map's
    gradient is an indexed accumulation, whose atomic adds on the card
    come in their own order: not bitwise."""
    from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
    cs, _ = _slice8(cuda)
    env = cs.seeded_env_map(32, 64)
    runs = []
    for dev in ("cpu", cuda):
        cfg, sc = build_scene(cs._doc("scenes/cornell_simple.json", 2),
                              env_map=env, device=dev)
        cam = dataclasses.replace(default_camera(32, 32),
                                  **cs.THIN_LENS).pytree(dev)
        n = pathtracer.calibrate_regen_iters(cfg, sc, cam, 32, 32, 2, seed=3)
        em = sc.env_map.clone().requires_grad_()
        img, _ = pathtracer.render(cfg, dataclasses.replace(sc, env_map=em),
                                   cam, 32, 32, 2, seed=3,
                                   method="regen_scan", regen_iters=n)
        runs.append((cfg, sc, cam, img, em))
    traces = [cs.lane_trace(cfg, sc, cam, 32, 2, 3, torch.arange(32 * 32))
              for cfg, sc, cam, _, _ in runs[::-1]]
    keep = (cs.trace_parting(*traces, 1e-5)[0] < 0).reshape(32, 32)
    assert int((~keep).sum()) <= 0.03 * keep.numel()
    grads = []
    for _, _, _, img, em in runs:
        k = keep.to(img.device)[..., None]
        grads.append(torch.autograd.grad((img * k).sum() / (k.sum() * 3),
                                         em)[0].cpu())
    assert float(grads[0].abs().max()) > 0
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# W1, the BVH walk, and BDPT
# ---------------------------------------------------------------------------

def _walk_scene(dev, subdiv=4):
    cfg, sc = load_scene(os.path.join(REPO, "scenes/cornell.json"),
                         mesh_override=make_icosphere(subdiv, 1.2,
                                                      (0.0, -0.8, 0.0)),
                         device=dev)
    return dataclasses.replace(cfg, mesh_accel="bvh"), sc


def _walk_rays(pop, dev, n=4099):
    """A population's rays with any-hit lanes, inactive lanes and capped
    t_init mixed in; zero and axis-parallel directions among the random."""
    r = np.random.default_rng(("random", "camera", "surface").index(pop) + 40)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if pop == "random":
        o = r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
        d[:6] = 0.0
        d[0, 0], d[1, 1], d[2, 2], d[3, 0] = 1.0, -1.0, -0.0, -1e-13
    elif pop == "camera":
        o = np.tile(np.array([0.0, 4 * np.sin(0.3), 4 * np.cos(0.3)],
                             np.float32), (n, 1))
        d = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:
        tv = make_icosphere(4, 1.2, (0.0, -0.8, 0.0))[0]
        tri = r.integers(0, tv.shape[0], n)
        uv = r.uniform(0, 1, (n, 2)).astype(np.float32)
        uv[uv.sum(1) > 1] = 1 - uv[uv.sum(1) > 1]
        v = tv[tri]
        o = (v[:, 0] * (1 - uv[:, 0:1] - uv[:, 1:2]) + v[:, 1] * uv[:, 0:1]
             + v[:, 2] * uv[:, 1:2]).astype(np.float32)
    t_init = np.where(np.arange(n) % 5 == 0, 0.7, RAY_INF).astype(np.float32)
    anyh = np.arange(n) % 3 == 1
    act = np.arange(n) % 11 != 0
    return [torch.from_numpy(x).to(dev) for x in (o, d, t_init, act, anyh)]


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
def test_w1_matches_twin(cuda, pop):
    """W1's t, tri, u, v and node visits bitwise the twin's, on the card and
    on the CPU; one launch; the counters add up the visits."""
    _, sc = _walk_scene(cuda)
    o, d, t_init, act, anyh = _walk_rays(pop, cuda)
    counters = torch.zeros(bvh_walk.W1_COUNTERS, dtype=torch.int64,
                           device=cuda)
    before = bvh_walk.bvh_walk_kernel.launches
    got = bvh_walk.bvh_walk_kernel(sc.bvh_nodes, sc.bvh_links, sc.leaf_verts,
                                   o, d, t_init, act, anyh, count_steps=True,
                                   counters=counters)
    assert bvh_walk.bvh_walk_kernel.launches == before + 1
    on_card = intersect._bvh_traverse_chunk(sc, o, d, t_init, anyh, act,
                                            count_steps=True)
    on_cpu = intersect._bvh_traverse_chunk(sc.to("cpu"), o.cpu(), d.cpu(),
                                           t_init.cpu(), anyh.cpu(), act.cpu(),
                                           count_steps=True)
    for name, g, c, h in zip(("t", "tri", "u", "v", "steps"), got, on_card,
                             on_cpu):
        assert torch.equal(_bits(g), _bits(c)), name
        assert torch.equal(_bits(g).cpu(), _bits(h)), name
    assert int(counters[0]) == int(got[4].sum()) > 0
    assert int(counters[2]) >= int(counters[1]) > 0
    assert (got[1] >= 0).sum() > 100


@pytest.mark.cuda
def test_w1_wrapper_validates_arguments(cuda):
    _, sc = _walk_scene(cuda, subdiv=2)
    o, d, t_init, act, anyh = _walk_rays("random", cuda, n=64)
    args = [sc.bvh_nodes, sc.bvh_links, sc.leaf_verts, o, d, t_init, act, anyh]
    for i, bad in ((3, o.double()), (5, t_init[:10]), (1, sc.bvh_links.float()),
                   (3, o.cpu())):
        with pytest.raises((TypeError, ValueError)):
            bvh_walk.bvh_walk_kernel(*args[:i], bad, *args[i + 1:])
    with pytest.raises(ValueError):
        bvh_walk.walk(sc.bvh_nodes.cpu(), sc.bvh_links.cpu(),
                      sc.leaf_verts.cpu(), o.cpu(), d.cpu(), t_init.cpu())


@pytest.mark.cuda
def test_walk_render_on_card_matches_cpu(cuda):
    """The regen frame of cornell.json + 5,120 triangles through W1 on the
    card and the twin on the CPU at 4 bounces: every pixel within 1e-5;
    W1 once a dispatch; the brute frame on the card bitwise the walk's."""
    imgs = {}
    for dev in (cuda, torch.device("cpu")):
        cfg, sc = _walk_scene(dev)
        cfg = dataclasses.replace(cfg, max_bounces=4)
        before = bvh_walk.bvh_walk_kernel.launches
        with torch.no_grad():
            imgs[dev.type], _ = pathtracer.render(
                cfg, sc, default_camera(32, 32).pytree(dev), 32, 32, 2,
                seed=3, method="regen")
        if dev.type == "cuda":
            assert bvh_walk.bvh_walk_kernel.launches > before
            with torch.no_grad():
                brute, _ = pathtracer.render(
                    dataclasses.replace(cfg, mesh_accel="brute"), sc,
                    default_camera(32, 32).pytree(dev), 32, 32, 2, seed=3,
                    method="regen")
            assert torch.equal(brute, imgs["cuda"])
    torch.testing.assert_close(imgs["cuda"].cpu(), imgs["cpu"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("accel", ["brute", "bvh"])
def test_bdpt_on_card_matches_cpu(cuda, accel):
    """BDPT at depth 3 on cornell.json + a 320-triangle icosphere by either
    mesh backend, on the card and the CPU with every decision recorded
    (chip_smoke.bdpt_card_vs_cpu): a pixel whose decisions differ is left
    out (an ulp of a ray flips a grazing one: at most 1% of them), every
    other pixel within chip_smoke.FWD_BDPT (a connection's 1/d^2 magnifies
    an ulp); the mesh kernel launched 3 + 2 + 1 times a sample."""
    cs = _chip_smoke()
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, 1.0, 0.0))
    launched = {}

    def build(dev):
        cfg, sc = load_scene(os.path.join(REPO, "scenes/cornell.json"),
                             mesh_override=mesh, device=dev)
        launched[dev.type] = (mesh_brute.mesh_brute_kernel.launches,
                              bvh_walk.bvh_walk_kernel.launches)
        return (dataclasses.replace(cfg, mesh_accel=accel), sc,
                default_camera(24, 24).pytree(dev))

    r = cs.bdpt_card_vs_cpu(cuda, build, 24, 2, 7, 3)
    k1, w1 = launched["cpu"]  # counts when the CPU leg began
    k1_0, w1_0 = launched["cuda"]
    assert (k1 - k1_0 if accel == "brute" else w1 - w1_0) == 2 * (4 + 2 + 1)
    assert r["unexplained"] == 0


# the edge batches of chip_smoke.w1_edge_batches, in its order
W1_EDGES = ("n=1", "n=31", "n=33", "under one wave", "2,000,003 rays",
            "90% inactive", "any-hit, NaN, inf, inside", "back to back",
            "side stream")


@pytest.mark.cuda
@pytest.mark.parametrize("edge", range(len(W1_EDGES)), ids=W1_EDGES)
def test_w1_edge_batch_matches_twin(cuda, edge):
    """W1 on chip_smoke's edge batches (cornell.json + 5,120 triangles):
    t, tri, u, v and node visits bitwise the twin's, and its visit, leaf
    and test counters the twin's counts (chip_smoke.w1_check); two batches
    of other sizes launched back to back, and one on a stream that is not
    the default."""
    cs = _chip_smoke()
    _, sc = _walk_scene(cuda)
    name, (batches, side) = list(cs.w1_edge_batches(sc, cuda).items())[edge]
    problems = []
    runs, _ = cs.w1_check(name, sc, [
        (batches, torch.cuda.Stream(cuda) if side else None)], problems)
    assert problems == []
    assert [sum(r[2].values()) for r in runs] == [0] * len(batches)


def _sharded_cli_and_want(dev, tmp_path, w, h, spp, seed, launcher):
    """The PNG of ``--sharded`` run by ``launcher`` (the command before the
    CLI's flags), and the export of the single-process ``trace_regen``
    frame on ``dev`` -> (stdout, the two files' bytes)."""
    import subprocess
    import sys

    from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
    from photorealistic_rendering_using_opencl_tpu_torch.runtime.camera import (
        InteractiveCamera,
    )
    out = str(tmp_path / "sharded.png")
    r = subprocess.run(
        [sys.executable, *launcher, "-m", app.PROG, "-scene",
         "scenes/cornell_hi.json", "-width", str(w), "-height", str(h),
         "-spp", str(spp), "--seed", str(seed), "--sharded", "-o", out],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    cfg, sc = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                         device=dev)
    cam = InteractiveCamera(resolution=(w, h)).build_render_camera().pytree(dev)
    px, py = pathtracer.pixel_grid(w, h, dev)
    with torch.no_grad():
        rad, _ = pathtracer.trace_regen(cfg, sc, cam, w, h, spp, px, py, seed)
    want = str(tmp_path / "want.png")
    app._export(want, rad.reshape(h, w, 3), None, 0)
    return r.stdout, open(out, "rb").read(), open(want, "rb").read()


@pytest.mark.cuda
def test_sharded_cli_under_torchrun_shares_one_card(cuda, tmp_path):
    """``--sharded`` under torchrun with 2 ranks on the card: they share
    cuda:0 over gloo (NCCL refuses two ranks on one card), the shards go
    through host memory, and rank 0's PNG is byte for byte the export of
    the single-process ``trace_regen`` frame."""
    stdout, got, want = _sharded_cli_and_want(
        cuda, tmp_path, 40, 30, 2, 3,
        ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2"])
    if torch.cuda.device_count() == 1:
        assert "sharding 40x30 over 2 ranks (gloo)" in stdout
    assert got == want


@pytest.mark.cuda
def test_sharded_cli_spawns_a_rank_a_card(cuda, tmp_path):
    """``--sharded`` in one process on a machine with two or more cards
    spawns a rank a card over NCCL, and its PNG is byte for byte the export
    of the single-process ``trace_regen`` frame on one card.  Skips on a
    machine with one card."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two cards")
    stdout, got, want = _sharded_cli_and_want(cuda, tmp_path, 40, 30, 2, 3,
                                              [])
    assert f"sharding 40x30 over {n} ranks (nccl)" in stdout
    assert got == want


@pytest.mark.cuda
def test_dryrun_multichip_over_nccl(cuda, capfd):
    """``parallel.dryrun.dryrun_multichip`` over two cards: a rank a card,
    NCCL, a sharded render and one train step.  Skips on a machine with one
    card."""
    from photorealistic_rendering_using_opencl_tpu_torch.parallel.dryrun import (
        dryrun_multichip,
    )
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    dryrun_multichip(2)
    out = capfd.readouterr().out
    assert "dryrun_multichip(2): loss=" in out and "backend=nccl" in out


# ---------------------------------------------------------------------------
# the tensor-core kernel of K1's reduced-precision forms
# ---------------------------------------------------------------------------

def _cornell_hi_population(dev, pop):
    """cornell_hi's tables and one of chip_smoke.py's phase 3 populations
    (524,288 merged closest and any-hit lanes, inactive lanes mixed in)."""
    cs = _chip_smoke()
    _, scene = load_scene(os.path.join(REPO, "scenes/cornell_hi.json"),
                          models_dir=os.path.join(REPO, "scenes/assets"),
                          device=dev)
    return scene, cs.k1_populations(scene, dev)[pop]


def _tc_lanes(b):
    return (b["origin"], b["direction"], b["t_init"], b["active"],
            b["any_hit"], b["exclude"])


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(_chip_smoke().TC_FORMS))
def test_tc_kernel_matches_plain(cuda, monkeypatch, label):
    """The tensor-core kernel in each form, through ``mesh_intersect`` as
    the switches pick it, against ``intersect_reduced_plain`` on the card:
    at most 1e-5 winner flips a closest ray and occlusion flips an any-hit
    ray (K1's bound), t within chip_smoke.TC_DT_REL of max(|t|, 1) where
    the closest winners agree, inactive and any-hit lanes' t equal, the
    kernel launched once and K1 not at all."""
    cs = _chip_smoke()
    name, bf16 = cs.TC_FORMS[label]
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
    scene, b = _cornell_hi_population(cuda, "random")
    feat = scene.bf_feat.to(torch.bfloat16) if bf16 else scene.bf_feat
    form = mesh_brute.reduced_form(feat)
    lanes = _tc_lanes(b)
    k1, tc = mesh_brute.mesh_brute_kernel.launches, \
        mesh_brute.mesh_brute_tc_kernel.launches
    t, tri = mesh_brute.mesh_intersect(
        feat, scene.bf_clusters, *lanes[:3], active=lanes[3],
        any_hit=lanes[4], exclude=lanes[5])
    assert mesh_brute.mesh_brute_tc_kernel.launches == tc + 1
    assert mesh_brute.mesh_brute_kernel.launches == k1
    tp, trip = mesh_brute.intersect_reduced_plain(
        feat, scene.bf_clusters, *lanes, form)
    act, anyh = b["active"], b["any_hit"]
    closest, anyhit = act & ~anyh, act & anyh
    assert int(((tri != trip) & closest).sum()) <= 1e-5 * int(closest.sum())
    assert int(((tri >= 0) != (trip >= 0))[anyhit].sum()) <= \
        1e-5 * int(anyhit.sum())
    assert cs.tc_dt(t, tp, closest & (tri == trip) & (tri >= 0))[1] <= \
        cs.TC_DT_REL
    assert torch.equal(t[~closest], tp[~closest])
    assert torch.equal(tri[~act], trip[~act])
    assert int((trip[closest] >= 0).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(_chip_smoke().TC_FORMS))
def test_tc_nonfinite_t_init_as_plain(cuda, monkeypatch, label):
    """t_init = inf, or a finite value past bf16's range, on every fifth
    lane: the kernel records no hit there, as its plain version does (whose
    products turn NaN there, as the reference's do), and returns the plain
    version's t; the other lanes still hit."""
    name, bf16 = _chip_smoke().TC_FORMS[label]
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
    bp, (feat, clusters, _) = _tables(cuda)
    if bf16:
        feat = feat.to(torch.bfloat16)
    form = mesh_brute.reduced_form(feat)
    lanes = _batch("camera", bp, cuda)
    lane = torch.arange(lanes[0].shape[0], device=cuda)
    odd = lane % 5 == 0
    lanes[2] = torch.where(odd, torch.where(lane % 2 == 0, torch.inf,
                                            3.4e38), lanes[2])
    t, tri = mesh_brute.mesh_brute_tc_kernel(
        mesh_brute.form_fragments(feat, form), clusters, *lanes, form)
    tp, trip = mesh_brute.intersect_reduced_plain(feat, clusters, *lanes,
                                                  form)
    assert bool((trip[odd] == -1).all()) and bool((tri[odd] == -1).all())
    torch.testing.assert_close(t[odd], tp[odd], rtol=0, atol=0,
                               equal_nan=True)
    assert int((tri[~odd] >= 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("pop", ["camera", "surface"])
def test_tc_and_k1_norel_bitwise(cuda, monkeypatch, pop):
    """PRT_MESH_NOREL reaches both kernels: every live lane tests every
    tile, and the results are bitwise the pruned ones for K1 and for the
    tensor-core kernel in bf16x6 (f32-exact, so the prune cannot drop a
    hit)."""
    scene, b = _cornell_hi_population(cuda, pop)
    lanes = _tc_lanes(b)
    for name in ("highest", "bf16x6"):
        monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
        monkeypatch.delenv("PRT_MESH_NOREL", raising=False)
        pruned = mesh_brute.mesh_intersect(
            scene.bf_feat, scene.bf_clusters, *lanes[:3], active=lanes[3],
            any_hit=lanes[4], exclude=lanes[5])
        monkeypatch.setenv("PRT_MESH_NOREL", "1")
        every = mesh_brute.mesh_intersect(
            scene.bf_feat, scene.bf_clusters, *lanes[:3], active=lanes[3],
            any_hit=lanes[4], exclude=lanes[5])
        assert all(torch.equal(x, y) for x, y in zip(pruned, every)), name


@pytest.mark.cuda
def test_force_xla_runs_the_twin_on_card(cuda, monkeypatch):
    """PRT_MESH_FORCE_XLA: ``mesh_intersect`` runs the plain twin on the
    card, no kernel launches, ``uses_kernel`` is False, and the result is
    bitwise the twin's, in every precision."""
    bp, (feat, clusters, _) = _tables(cuda)
    lanes = _batch("random", bp, cuda)
    monkeypatch.setenv("PRT_MESH_FORCE_XLA", "1")
    assert not mesh_brute.uses_kernel(lanes[0])
    want = mesh_brute._intersect_xla(feat, clusters, *lanes[:4],
                                     exclude=lanes[5])
    for name in ("highest", "bf16x3", "default"):
        monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
        k1, tc = mesh_brute.mesh_brute_kernel.launches, \
            mesh_brute.mesh_brute_tc_kernel.launches
        got = mesh_brute.mesh_intersect(feat, clusters, *lanes[:3],
                                        active=lanes[3], any_hit=lanes[4],
                                        exclude=lanes[5])
        assert mesh_brute.mesh_brute_kernel.launches == k1
        assert mesh_brute.mesh_brute_tc_kernel.launches == tc
        assert all(torch.equal(x, y) for x, y in zip(got, want)), name


@pytest.mark.cuda
def test_tc_wrapper_validates_arguments(cuda):
    bp, (feat, clusters, _) = _tables(cuda)
    lanes = _batch("random", bp, cuda)
    frag = mesh_brute.form_fragments(feat, "bf16x3")
    with pytest.raises(TypeError, match="frag"):
        mesh_brute.mesh_brute_tc_kernel(frag.float(), clusters, *lanes,
                                        "bf16x3")
    with pytest.raises(ValueError, match="frag"):
        mesh_brute.mesh_brute_tc_kernel(frag, clusters, *lanes, "bf16x6")
    with pytest.raises(ValueError, match="form"):
        mesh_brute.mesh_brute_tc_kernel(frag, clusters, *lanes, "bf16x2")


# ---------------------------------------------------------------------------
# PRT_MESH_TILE and PRT_MESH_BLOCK: the kernels' other sizes
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
@pytest.mark.parametrize("tile", [256, 512])
def test_k1_at_tile_matches_twin(cuda, tile, pop):
    """K1 on a table of 256- or 512-triangle tiles (the 1,280-triangle
    icosphere: 5 tiles, or 2.5 padded to 3) against the twin on that
    table, one launch; the closest lanes' (t, tri) bitwise K1's on the
    128-triangle table."""
    bp, (feat, clusters, _) = _tables(cuda, tile)
    assert mesh_brute.table_tile(feat, clusters) == tile
    lanes = _batch(pop, bp, cuda)
    before = mesh_brute.mesh_brute_kernel.launches
    t, tri = mesh_brute.mesh_intersect(feat, clusters, *lanes[:3],
                                       active=lanes[3], any_hit=lanes[4],
                                       exclude=lanes[5])
    assert mesh_brute.mesh_brute_kernel.launches == before + 1
    _assert_like_twin(feat, clusters, *lanes, t, tri)
    _, (f128, c128, _) = _tables(cuda, 128)
    t0, tri0 = mesh_brute.mesh_intersect(f128, c128, *lanes[:3],
                                         active=lanes[3], any_hit=lanes[4],
                                         exclude=lanes[5])
    closest = lanes[3] & ~lanes[4]
    assert torch.equal(t[closest], t0[closest])
    assert torch.equal(tri[closest], tri0[closest])


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["default", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("tile,block", [(256, 256), (128, 128), (128, 512),
                                        (512, 512)])
def test_tc_kernel_at_sizes_matches_plain(cuda, monkeypatch, tile, block,
                                          label):
    """The tensor-core kernel through ``mesh_intersect`` with
    RELEVANCE_BLOCK (PRT_MESH_BLOCK) set to ``block``, on cornell_hi's
    tables packed at ``tile``, against ``intersect_reduced_plain`` at the
    same sizes on phase 3's random population: test_tc_kernel_matches_plain's
    limits, one launch."""
    cs = _chip_smoke()
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", label)
    monkeypatch.setattr(mesh_brute, "RELEVANCE_BLOCK", block)
    scene, b = _cornell_hi_population(cuda, "random")
    feat, clusters = cs.tables_at(scene, tile)[:2]
    form = mesh_brute.reduced_form(feat)
    lanes = _tc_lanes(b)
    tc = mesh_brute.mesh_brute_tc_kernel.launches
    t, tri = mesh_brute.mesh_intersect(
        feat, clusters, *lanes[:3], active=lanes[3], any_hit=lanes[4],
        exclude=lanes[5])
    assert mesh_brute.mesh_brute_tc_kernel.launches == tc + 1
    tp, trip = mesh_brute.intersect_reduced_plain(feat, clusters, *lanes,
                                                  form, block=block)
    act, anyh = b["active"], b["any_hit"]
    closest, anyhit = act & ~anyh, act & anyh
    assert int(((tri != trip) & closest).sum()) <= 1e-5 * int(closest.sum())
    assert int(((tri >= 0) != (trip >= 0))[anyhit].sum()) <= \
        1e-5 * int(anyhit.sum())
    assert cs.tc_dt(t, tp, closest & (tri == trip) & (tri >= 0))[1] <= \
        cs.TC_DT_REL
    assert torch.equal(t[~closest], tp[~closest])
    assert torch.equal(tri[~act], trip[~act])
    assert int((trip[closest] >= 0).sum()) > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("tile", [256, 512])
def test_t1_at_tile_matches_plain(cuda, tile, block):
    """T1 on a table of ``tile``-triangle tiles against its plain version
    at the same tile (test_t1_matches_plain's bound), one launch."""
    bp, (feat, clusters, _) = _tables(cuda, tile)
    o, d, t_init, act, _, _ = _batch("random", bp, cuda)
    words = mesh_brute.relevance_words(clusters, o, d, t_init, act, block)
    pack = mesh_brute.matmul_only_pack(o, d, t_init)
    before = mesh_brute.matmul_only_kernel.launches
    t, i = mesh_brute.matmul_only(words, pack, feat, block, tile)
    assert mesh_brute.matmul_only_kernel.launches == before + 1
    want, _ = mesh_brute.matmul_only_plain(words, pack, feat, block, tile)
    scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(), feat.abs(),
                                            block, tile)
    assert not i.any() and (scale > 0).any()
    assert float(((t - want).abs() / scale.clamp(min=1e-30)).max()) <= 1e-5


@pytest.mark.cuda
def test_unbuilt_sizes_raise_on_card(cuda, monkeypatch):
    """A tile or block with no kernel instance raises ValueError naming
    its switch, on the card, with no launch and no fallback."""
    bp, (feat, clusters, _) = _tables(cuda, 64)
    lanes = _batch("camera", bp, cuda)
    counts = (mesh_brute.mesh_brute_kernel.launches,
              mesh_brute.mesh_brute_tc_kernel.launches,
              mesh_brute.matmul_only_kernel.launches)
    for name in ("highest", "bf16x6"):
        monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
        with pytest.raises(ValueError, match="PRT_MESH_TILE"):
            mesh_brute.mesh_intersect(feat, clusters, *lanes[:3],
                                      active=lanes[3], any_hit=lanes[4],
                                      exclude=lanes[5])
    words = mesh_brute.relevance_words(clusters, *lanes[:4], 128)
    pack = mesh_brute.matmul_only_pack(*lanes[:3])
    with pytest.raises(ValueError, match="PRT_MESH_TILE"):
        mesh_brute.matmul_only(words, pack, feat, 128, 64)
    _, (f128, c128, _) = _tables(cuda, 128)
    monkeypatch.setattr(mesh_brute, "RELEVANCE_BLOCK", 1024)
    with pytest.raises(ValueError, match="PRT_MESH_BLOCK"):
        mesh_brute.mesh_intersect(f128, c128, *lanes[:3], active=lanes[3],
                                  any_hit=lanes[4], exclude=lanes[5])
    assert counts == (mesh_brute.mesh_brute_kernel.launches,
                      mesh_brute.mesh_brute_tc_kernel.launches,
                      mesh_brute.matmul_only_kernel.launches)
