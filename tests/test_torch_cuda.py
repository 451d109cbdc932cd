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
from photorealistic_rendering_using_opencl_tpu_torch.ops import compaction, mesh_brute, passthrough
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
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tables(dev):
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    order = build_bvh(tv).order
    bp = mesh_brute.pack_brute(tv[order], tn[order])
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


@pytest.mark.cuda
@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
def test_k1_matches_twin(cuda, pop):
    bp, (feat, clusters, tri_verts) = _tables(cuda)
    o, d, t_init, act, anyh, ex = _batch(pop, bp, cuda)
    before = mesh_brute.mesh_brute_kernel.launches
    t, tri = mesh_brute.mesh_intersect(feat, clusters, o, d, t_init,
                                       active=act, any_hit=anyh, exclude=ex)
    assert mesh_brute.mesh_brute_kernel.launches == before + 1
    tt, ttri = mesh_brute._intersect_xla(feat, clusters, o, d, t_init, act,
                                         exclude=ex)
    closest, anyhit = act & ~anyh, act & anyh
    # winner / occlusion flips: the 1e-5-per-ray limit is 0 at 600 rays
    assert torch.equal(tri[closest], ttri[closest])
    assert torch.equal(tri[anyhit] >= 0, ttri[anyhit] >= 0)
    assert (tri[~act] == -1).all() and torch.equal(t[~act], t_init[~act])
    assert torch.equal(t[anyhit], t_init[anyhit])
    hit = closest & (tri >= 0)
    assert hit.any()
    torch.testing.assert_close(t[hit], tt[hit], rtol=1e-5, atol=0)


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
