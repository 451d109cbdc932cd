"""Environment maps: the port's ops/envmap.py against the JAX package's on
the same numpy inputs, twins of tests/test_envmap.py, the map's gradient
against finite differences (twin of tests/test_grad.py's) and against
JAX, and env-lit renders against JAX.

Lookups are held within 1e-6 relative on the same (u, v).  The sampling
tables are cumulative sums, which XLA and
PyTorch add in other orders: held within 2e-6 of their largest entry.
``sample_env``'s row and column are held bitwise on the JAX package's own
tables carried across.  ``BilinearLookup``, the card's lookup kernel pair,
is held here through its wrappers' calls into the kernel library (the
kernels run in tests/test_torch_cuda.py).
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import envmap as j_env
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene as j_build
from photorealistic_rendering_using_opencl_tpu_torch.diff import fd
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import envmap
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.utils.profiling import TRACER

torch.set_num_threads(2)

REL = 1e-6
FWD = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PLANE = {"settings": {"MAX_BOUNCES": 2},
         "scene": {"quads": [
             {"vertices": [0.0, -1.0, 0.0, 4.0, 0.0, 0.0, 0.0, 0.0, 4.0],
              "material": {"color": [0.6, 0.6, 0.6]}}]}}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _env(seed=0, h=16, w=32):
    return np.random.default_rng(seed).uniform(
        0.05, 3.0, (h, w, 3)).astype(np.float32)


def _hotspot_env(h=16, w=32, bright=50.0):
    env = np.full((h, w, 3), 0.05, np.float32)
    env[h // 4, w // 3] = bright
    return env


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]]
    return d


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def test_equirect_uv_and_radiance_match_reference():
    """(u, v) within 1e-6; the lookup on the JAX package's (u, v) within
    1e-6 of its radiance (an ulp of atan2 or acos moves u by ~1e-7, which
    the bilinear weights scale by the map's width and contrast)."""
    env = _env()
    d = _dirs(20000, 1)
    u, v = envmap.equirect_uv(_t(d))
    ju, jv = j_env.equirect_uv(jnp.asarray(d))
    _close(u, ju)
    _close(v, jv)
    want = np.asarray(j_env.radiance(jnp.asarray(env), jnp.asarray(d)))
    _close(envmap.sample_bilinear(_t(env), _t(np.asarray(ju)),
                                  _t(np.asarray(jv))), want)
    np.testing.assert_allclose(envmap.radiance(_t(env), _t(d)).numpy(), want,
                               rtol=1e-4, atol=0)


def test_sample_bilinear_wraps_u_and_clamps_v():
    env = _env(2, 4, 8)
    u = np.asarray([-0.01, 0.0, 0.03, 0.5, 0.99, 1.0, 1.2], np.float32)
    v = np.asarray([-0.2, 0.0, 0.1, 0.5, 0.95, 1.0, 1.3], np.float32)
    _close(envmap.sample_bilinear(_t(env), _t(u), _t(v)),
           j_env.sample_bilinear(jnp.asarray(env), jnp.asarray(u),
                                 jnp.asarray(v)))


@pytest.mark.parametrize("shape", [(8, 16), (16, 32), (64, 128)])
def test_build_env_distribution_matches_reference(shape):
    env = _env(3, *shape)
    got = envmap.build_env_distribution(_t(env))
    want = j_env.build_env_distribution(jnp.asarray(env))
    for k in ("weights", "total"):
        _close(got[k], want[k])
    for k in ("cond_cdf", "marg_cdf"):  # cumulative sums: the adds' order
        _close(got[k], want[k], rel=2e-6)
    assert float(got["cond_cdf"][:, -1].min()) > 1 - 1e-6


def test_searchsorted_rows_matches_numpy_and_reference():
    rng = np.random.default_rng(3)
    table = np.sort(rng.uniform(0, 1, (8, 37)), axis=1).astype(np.float32)
    table[:, -1] = 1.0
    row = rng.integers(0, 8, 1000).astype(np.int64)
    u = rng.uniform(0, 1, 1000).astype(np.float32)
    u[:8] = table[row[:8], rng.integers(0, 37, 8)]  # exactly on an entry
    got = envmap.searchsorted_rows(_t(table), _t(row), _t(u)).numpy()
    want = np.array([np.searchsorted(table[r], x) for r, x in zip(row, u)])
    np.testing.assert_array_equal(got, np.minimum(want, 36))
    np.testing.assert_array_equal(got, np.asarray(j_env.jax_searchsorted_rows(
        jnp.asarray(table), jnp.asarray(row.astype(np.int32)),
        jnp.asarray(u))))


def _carried(env):
    """The JAX package's tables as the port's dist dict."""
    jd = j_env.build_env_distribution(jnp.asarray(env))
    return jd, {k: _t(np.asarray(v)) for k, v in jd.items()}


@pytest.mark.parametrize("kind", ["random", "hotspot"])
def test_sample_env_bitwise_cells_on_carried_tables(kind):
    """Row and column bitwise the reference's inverse CDF on its own tables
    (side='left': the first entry >= u); direction and pdf within 1e-6."""
    env = _env(4) if kind == "random" else _hotspot_env()
    jd, dist = _carried(env)
    rng = np.random.default_rng(5)
    u1 = rng.random(50000, dtype=np.float32)
    u2 = rng.random(50000, dtype=np.float32)
    h, w = env.shape[:2]
    marg = jd["marg_cdf"]
    u1[:h] = np.asarray(marg)  # exactly on the marginal CDF's entries
    row, col, _, _ = envmap.sample_env_cell(dist, _t(u1), _t(u2))
    jrow = jnp.clip(jnp.searchsorted(marg, jnp.asarray(u1)), 0, h - 1)
    jcol = jnp.clip(j_env.jax_searchsorted_rows(jd["cond_cdf"], jrow,
                                                jnp.asarray(u2)), 0, w - 1)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jrow))
    np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
    d, pdf = envmap.sample_env(dist, _t(u1), _t(u2))
    jdir, jpdf = j_env.sample_env(jd, jnp.asarray(u1), jnp.asarray(u2))
    _close(d, jdir)
    np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), rtol=1e-5)
    _close(envmap.env_pdf(dist, d), j_env.env_pdf(jd, jnp.asarray(d.numpy())),
           rel=1e-5)


def test_sample_env_hits_hotspot_and_pdf_consistent():
    env = _hotspot_env()
    dist = envmap.build_env_distribution(_t(env))
    u1 = ((np.arange(4096) + 0.5) / 4096).astype(np.float32)
    u2 = ((np.arange(4096) * 0.6180339887498949) % 1.0).astype(np.float32)
    d, pdf = envmap.sample_env(dist, _t(u1), _t(u2))
    assert torch.allclose(torch.linalg.vector_norm(d, dim=-1),
                          torch.ones(4096), atol=1e-4)
    assert float((envmap.radiance(_t(env), d)[:, 0] > 1.0).float().mean()) > 0.5
    torch.testing.assert_close(envmap.env_pdf(dist, d), pdf, rtol=1e-3,
                               atol=0.0)


def test_env_sampling_estimator_unbiased():
    rng = np.random.default_rng(0)
    env = (0.3 + 0.7 * rng.uniform(size=(8, 16, 3))).astype(np.float32)
    dist = envmap.build_env_distribution(_t(env))
    n = 200_000
    d, pdf = envmap.sample_env(dist, _t(rng.uniform(size=n).astype(np.float32)),
                               _t(rng.uniform(size=n).astype(np.float32)))
    est = (envmap.radiance(_t(env), d).double() / pdf.double()[:, None]).mean(0)
    z = 1.0 - 2.0 * rng.uniform(size=n)
    phi = 2 * np.pi * rng.uniform(size=n)
    r = np.sqrt(np.maximum(1 - z * z, 0))
    dirs = np.stack([r * np.cos(phi), z, r * np.sin(phi)], -1).astype(np.float32)
    ref = envmap.radiance(_t(env), _t(dirs)).double().mean(0) * 4 * np.pi
    torch.testing.assert_close(est, ref, rtol=0.05, atol=0.0)


def test_env_nee_reduces_variance_same_mean():
    """A hotspot map: env NEE agrees in expectation with BSDF-only sampling
    and cuts the per-pixel spread."""
    doc = {"settings": {"MAX_BOUNCES": 2},
           "scene": {"quads": [
               {"vertices": [0.0, -0.5, 0.0, 12.0, 0.0, 0.0, 0.0, 0.0, 12.0],
                "material": {"color": [0.7, 0.7, 0.7]}}]}}
    cfg_on, sc = build_scene(doc, env_map=_hotspot_env(bright=200.0),
                             device="cpu")
    cfg_off = dataclasses.replace(cfg_on, enable_env_sampling=False)
    cam = default_camera(12, 12).pytree("cpu")

    def render(cfg, spp, seed, jitter=True):
        return pathtracer.render(cfg, sc, cam, 12, 12, spp, seed=seed,
                                 jitter=jitter, method="regen")[0]

    m_on, m_off = float(render(cfg_on, 64, 1).mean()), float(
        render(cfg_off, 512, 2).mean())
    assert abs(m_on - m_off) / max(m_off, 1e-6) < 0.25, (m_on, m_off)

    def spread(cfg):
        return float(torch.stack([render(cfg, 1, s, jitter=False)
                                  for s in range(16)]).std(0).mean())

    assert spread(cfg_on) < spread(cfg_off)


def test_envmap_grad_vs_fd():
    """d mean(image) / d env_map against central differences on the first
    24 texel channels (twin of tests/test_grad.py's), < 1e-3."""
    cfg, sc = build_scene(PLANE, env_map=np.full((4, 8, 3), 0.5, np.float32),
                          device="cpu")
    cam = default_camera(8, 8).pytree("cpu")

    def f(em):
        return pathtracer.render(cfg, dataclasses.replace(sc, env_map=em),
                                 cam, 8, 8, 2)[0].mean()

    rep = fd.check_gradients(f, sc.env_map, eps=2e-3, max_coords=24)
    assert float(rep.ad.abs().max()) > 1e-5
    assert rep.max_abs_err < 1e-3, rep.max_abs_err


THIN_LENS = dict(aperture_radius=0.08, focal_distance=3.5)


def _scene_pair(path, env, bounces=2):
    import json
    with open(path) as fh:
        doc = json.load(fh)
    doc["settings"]["MAX_BOUNCES"] = bounces
    jcfg, jsc = j_build(doc, env_map=env)
    cfg, sc = build_scene(doc, env_map=env, device="cpu")
    jcam = dataclasses.replace(j_default_camera(8, 8), **THIN_LENS).pytree()
    cam = dataclasses.replace(default_camera(8, 8), **THIN_LENS).pytree("cpu")
    return jcfg, jsc, jcam, cfg, sc, cam


@pytest.mark.parametrize("method", ["while", "regen"])
def test_env_lit_thin_lens_render_matches_reference(method):
    """materials.json (every BSDF family, an open scene) lit by a random
    map through a thin-lens camera at 2 bounces, within 1e-5 of the JAX
    package's jitted render but where its un-jitted render parts from it
    too: XLA's FMAs flip a few Fresnel and lobe choices of the glass
    (measured: 6 of 64 pixels, by up to 0.57; the port is within 6e-7 of
    the un-jitted render on every pixel)."""
    jcfg, jsc, jcam, cfg, sc, cam = _scene_pair("scenes/materials.json",
                                                _env(6, 8, 16))
    with torch.no_grad():
        img = pathtracer.render(cfg, sc, cam, 8, 8, 2, seed=2,
                                method=method)[0].numpy()
    want = np.asarray(j_pt.render(jcfg, jsc, jcam, 8, 8, 2, seed=2,
                                  method=method)[0])

    def beyond(a, b):
        return (np.abs(a - b) > FWD + FWD * np.abs(b)).any(-1)

    out = beyond(img, want)
    assert out.mean() < 0.15
    if out.any():
        with jax.disable_jit():
            eager = np.asarray(j_pt.render(jcfg, jsc, jcam, 8, 8, 2, seed=2,
                                           method=method)[0])
        assert not (out & ~beyond(eager, want)).any()
        np.testing.assert_allclose(img, eager, rtol=FWD, atol=FWD)


def test_env_map_gradients_match_reference():
    """cornell_simple lit by a map through a thin-lens camera, 2 bounces:
    d mean(image) / d (env_map, colour) within rtol 1e-4 / atol 1e-6 of
    JAX through the default method."""
    jcfg, jsc, jcam, cfg, sc, cam = _scene_pair("scenes/cornell_simple.json",
                                                _env(7, 8, 16))
    leaves = ("env_map", "color")
    params = {k: getattr(sc, k).clone().requires_grad_() for k in leaves}
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, **params), cam, 8,
                               8, 2, seed=2)
    got = torch.autograd.grad(img.mean(), list(params.values()))

    def f(p):
        return j_pt.render(jcfg, dataclasses.replace(jsc, **p), jcam, 8, 8, 2,
                           seed=2)[0].mean()

    jg = jax.jit(jax.grad(f))({k: getattr(jsc, k) for k in leaves})
    for k, g in zip(leaves, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=k)
        assert float(g.abs().max()) > 1e-5, k


# ---------------------------------------------------------------------------
# BilinearLookup: the card's kernel pair, here through its wrappers
# ---------------------------------------------------------------------------

def _lookup_lanes(h, w, n, seed):
    """u, v [n] float32 whose taps cross the wrap in u and the clamps in
    v."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate([[-1, w - 1, -1, w - 1], rng.integers(-1, w, n - 4)])
    yi = np.concatenate([[-1, -1, h - 1, h - 1], rng.integers(-1, h, n - 4)])
    u = (xi + 0.5 + rng.uniform(0.1, 0.9, n)) / w
    v = (yi + 0.5 + rng.uniform(0.1, 0.9, n)) / h
    return _t(u.astype(np.float32)), _t(v.astype(np.float32))


def _graph_names(t):
    names, todo, seen = [], [t.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return names


def test_sample_bilinear_keeps_the_cpu_graph():
    """CPU tensors never take the Function: sample_bilinear builds the four
    gathers' graph (their index_put backward) as it did, and its lookup
    is the plain one's bit for bit."""
    img = _t(_env()).requires_grad_()
    u, v = _lookup_lanes(16, 32, 50, 8)
    out = envmap.sample_bilinear(img, u, v)
    names = _graph_names(out)
    assert names.count("IndexBackward0") == 4
    assert not any("BilinearLookup" in n for n in names)
    assert torch.equal(out, envmap.lookup_plain(img, u, v))


class _FakeLibrary:
    """Stands in for the kernel library: records each ``prt_*`` call."""

    def __init__(self):
        self.calls = []

    def get(self):
        return self

    def __getattr__(self, name):
        if not name.startswith("prt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("traced", [False, True])
def test_bilinear_kernel_launch_arguments(monkeypatch, traced):
    """The wrappers' C calls, with a stand-in library (CPU tensors): every
    pointer, N, H and W; the backward's zeroed map, no u and v gradients
    unless asked, a grid of 256-lane blocks capped at MAX_BLOCKS, and a
    counts buffer of one int32 a block only while the tracer is on, kept
    by counter ``sky_grad.writes``; arguments of another shape refused."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
    lib = _FakeLibrary()
    monkeypatch.setattr(_cuda, "LIBRARY", lib)
    monkeypatch.setattr(_cuda, "on_device", lambda t: contextlib.nullcontext())
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    k = envmap.bilinear_kernel
    img = torch.zeros((4, 8, 3))
    n = 600
    u, v, g = torch.zeros(n), torch.zeros(n), torch.ones((n, 3))
    out = k(img, u, v)
    [(name, args)] = lib.calls
    assert name == "prt_envmap_lookup"
    assert args == (img.data_ptr(), u.data_ptr(), v.data_ptr(),
                    out.data_ptr(), n, 4, 8, 0)
    with profile(activities=[ProfilerActivity.CPU]) if traced else \
            contextlib.nullcontext():
        TRACER.reset()
        gm, gu, gv = k.grad(img, u, v, g, True, False)
        writes = TRACER._tensors.get("sky_grad.writes", [])
    name, args = lib.calls[1]
    assert name == "prt_envmap_lookup_grad"
    assert gu is None and gv is None and torch.equal(gm, torch.zeros(4, 8, 3))
    assert args[:10] == (img.data_ptr(), u.data_ptr(), v.data_ptr(),
                         g.data_ptr(), gm.data_ptr(), None, None, n, 4, 8)
    assert args[10] == 3 and args[12] == 0
    if traced:
        [(counts, _)] = writes
        assert counts.dtype == torch.int32 and counts.shape == (3,)
        assert args[11] == counts.data_ptr()
    else:
        assert writes == [] and args[11] is None
    gm, gu, gv = k.grad(img, u, v, g, False, True)
    args = lib.calls[2][1]
    assert gm is None and args[4:7] == (None, gu.data_ptr(), gv.data_ptr())
    k.grad(img, torch.zeros(10**6), torch.zeros(10**6),
           torch.ones((10**6, 3)), True, False)
    assert lib.calls[3][1][10] == k.MAX_BLOCKS
    with pytest.raises(ValueError):
        k(img, u, v[:-1])
    with pytest.raises(TypeError):
        k(img.double(), u, v)
    assert len(lib.calls) == 4
