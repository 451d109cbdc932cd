"""Counter RNG: the port's pcg4d, threefry2x32 and mwc words and f32
uniforms are bitwise the JAX package's, over a grid of (pixel, sample, dim,
seed) with 2**32-1 edges; a sample rendered with each scheme matches the
JAX package's within the port's <= 4-bounce tolerance of 1e-5."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import rng as j_rng
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import rng
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

torch.set_num_threads(2)

EDGES = np.array([0, 1, 2, 7, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                  0xFFFFFFFF], np.uint64)


def _grid(seed_rng, n):
    words = seed_rng.integers(0, 2 ** 32, size=(n, 4), dtype=np.uint64)
    edge = np.stack(np.meshgrid(EDGES, EDGES, indexing="ij"), -1).reshape(-1, 2)
    words[:len(edge), 0:2] = edge
    words[len(edge):2 * len(edge), 2:4] = edge
    return words


def test_pcg4d_words_bitwise():
    words = _grid(np.random.default_rng(0), 4096)
    want = np.asarray(j_rng.pcg4d(jnp.asarray(words.astype(np.uint32))))
    got = rng.pcg4d(torch.from_numpy(words.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


def test_uniform_from_bits_bitwise():
    bits = _grid(np.random.default_rng(1), 4096).reshape(-1)
    want = np.asarray(j_rng.uniform_from_bits(jnp.asarray(bits.astype(np.uint32))))
    got = rng.uniform_from_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("seed", [0, 9, 0xFFFFFFFF])
@pytest.mark.parametrize("dim0", [0, 8, 8 + 16 * 31])
def test_sampler_streams_bitwise(seed, dim0):
    r = np.random.default_rng(seed % 97 + dim0)
    pixel = np.concatenate([EDGES, r.integers(0, 2 ** 32, 248, dtype=np.uint64)])
    sample = np.concatenate([EDGES[::-1],
                             r.integers(0, 2 ** 32, 248, dtype=np.uint64)])
    js = j_rng.Sampler(jnp.asarray(pixel.astype(np.uint32)),
                       jnp.asarray(sample.astype(np.uint32)), seed=seed,
                       dim=dim0)
    ts = rng.Sampler(torch.from_numpy(pixel.astype(np.int64)),
                     torch.from_numpy(sample.astype(np.int64)), seed=seed,
                     dim=dim0)
    for _ in range(11):  # crosses three 4-word windows
        want = np.asarray(js.next1d())
        got = ts.next1d().numpy()
        assert got.tobytes() == want.tobytes()


def test_sampler_per_lane_dim_bitwise():
    """The regeneration loop keys each lane's window on its own bounce."""
    r = np.random.default_rng(3)
    n = 512
    pixel = r.integers(0, 2 ** 20, n, dtype=np.uint64)
    sample = r.integers(0, 64, n, dtype=np.uint64)
    bounce = r.integers(0, 40, n, dtype=np.uint64)
    dim = 8 + bounce * 16
    js = j_rng.Sampler(jnp.asarray(pixel.astype(np.uint32)),
                       jnp.asarray(sample.astype(np.uint32)), seed=5,
                       dim=jnp.asarray(dim.astype(np.uint32)))
    ts = rng.Sampler(torch.from_numpy(pixel.astype(np.int64)),
                     torch.from_numpy(sample.astype(np.int64)), seed=5,
                     dim=torch.from_numpy(dim.astype(np.int64)))
    for _ in range(7):
        assert ts.next1d().numpy().tobytes() == np.asarray(js.next1d()).tobytes()


def _u32_np(x):
    return np.asarray(x).astype(np.int64)


def test_threefry2x32_words_bitwise():
    """Both output words over 4096 (key0, key1, x0, x1) with every pair of
    edges in (key0, key1) and in (x0, x1)."""
    w = _grid(np.random.default_rng(4), 4096)
    want = j_rng.threefry2x32(*(jnp.asarray(w[:, i].astype(np.uint32))
                                for i in range(4)))
    got = rng.threefry2x32(*(torch.from_numpy(w[:, i].astype(np.int64))
                             for i in range(4)))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _u32_np(wv))
        assert g.min() >= 0 and g.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("cols", [(0, 1), (2, 3)])
def test_mwc_hash_words_bitwise(cols):
    w = _grid(np.random.default_rng(5), 4096)
    a, b = (w[:, c] for c in cols)
    want = j_rng.mwc_hash(jnp.asarray(a.astype(np.uint32)),
                          jnp.asarray(b.astype(np.uint32)))
    got = rng.mwc_hash(torch.from_numpy(a.astype(np.int64)),
                       torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _u32_np(want))
    assert got.min() >= 0 and got.max() <= 0xFFFFFFFF


@pytest.mark.parametrize("scheme", ["threefry", "mwc"])
@pytest.mark.parametrize("seed", [0, 9, 0xFFFFFFFF])
@pytest.mark.parametrize("dim0", [0, 8, 8 + 16 * 31])
def test_other_schemes_sampler_bitwise(scheme, seed, dim0):
    """The threefry and mwc streams, draw by draw, and ``dim``."""
    r = np.random.default_rng(seed % 89 + dim0)
    pixel = np.concatenate([EDGES, r.integers(0, 2 ** 32, 120, dtype=np.uint64)])
    sample = np.concatenate([EDGES[::-1],
                             r.integers(0, 2 ** 32, 120, dtype=np.uint64)])
    js = j_rng.Sampler(jnp.asarray(pixel.astype(np.uint32)),
                       jnp.asarray(sample.astype(np.uint32)), seed=seed,
                       scheme=scheme, dim=dim0)
    ts = rng.Sampler(torch.from_numpy(pixel.astype(np.int64)),
                     torch.from_numpy(sample.astype(np.int64)), seed=seed,
                     scheme=scheme, dim=dim0)
    for k in range(6):
        assert int(ts.dim) == int(js.dim) == dim0 + k
        assert ts.next1d().numpy().tobytes() == np.asarray(js.next1d()).tobytes()
    a, b = ts.next2d()
    ja, jb = js.next2d()
    assert (a.numpy().tobytes(), b.numpy().tobytes()) == (
        np.asarray(ja).tobytes(), np.asarray(jb).tobytes())
    assert int(ts.dim) == int(js.dim) == dim0 + 8


@pytest.mark.parametrize("scheme", rng.SCHEMES)
def test_sampler_per_lane_dim_all_schemes_bitwise(scheme):
    """Per-lane dim starts (the regeneration loop's), with a uint32 wrap of
    the seed's product and of dim0 + draws."""
    r = np.random.default_rng(6)
    n = 256
    pixel = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    sample = r.integers(0, 2 ** 32, n, dtype=np.uint64)
    dim = (r.integers(0, 2 ** 30, n, dtype=np.uint64) * 4) % 2 ** 32
    dim[:2] = [0xFFFFFFFC, 0]
    js = j_rng.Sampler(jnp.asarray(pixel.astype(np.uint32)),
                       jnp.asarray(sample.astype(np.uint32)), seed=0xDEADBEEF,
                       scheme=scheme, dim=jnp.asarray(dim.astype(np.uint32)))
    ts = rng.Sampler(torch.from_numpy(pixel.astype(np.int64)),
                     torch.from_numpy(sample.astype(np.int64)), seed=0xDEADBEEF,
                     scheme=scheme, dim=torch.from_numpy(dim.astype(np.int64)))
    for _ in range(6):
        assert ts.next1d().numpy().tobytes() == np.asarray(js.next1d()).tobytes()
    np.testing.assert_array_equal(ts.dim.numpy(), _u32_np(js.dim))


def test_unknown_scheme_refused():
    with pytest.raises(ValueError, match="pcg4d"):
        rng.Sampler(torch.zeros(4, dtype=torch.int64), 0, scheme="xorshift")


SIZE = 16


@functools.cache
def _cornell_simple():
    jcfg, jsc = j_load("scenes/cornell_simple.json")
    cfg, sc = load_scene("scenes/cornell_simple.json", device="cpu")
    return jcfg, jsc, cfg, sc


@pytest.mark.parametrize("scheme", rng.SCHEMES)
@pytest.mark.parametrize("method", ["scan", "while"])
def test_render_sample_each_scheme_matches_reference(scheme, method):
    """One sample of cornell_simple (4 bounces) at 16^2 through each
    scheme, sample index 3, seed 11."""
    jcfg, jsc, cfg, sc = _cornell_simple()
    run = jax.jit(j_pt.render_sample, static_argnames=(
        "cfg", "width", "height", "rng_scheme", "method"))
    want, want_a = run(jcfg, jsc, j_default_camera(SIZE, SIZE).pytree(), SIZE,
                       SIZE, jnp.uint32(3), 11, rng_scheme=scheme,
                       method=method)
    with torch.no_grad():
        got, got_a = pathtracer.render_sample(
            cfg, sc, default_camera(SIZE, SIZE).pytree("cpu"), SIZE, SIZE, 3,
            11, rng_scheme=scheme, method=method)
    assert torch.isfinite(got).all() and float(got.mean()) > 0.01
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("scheme", ["threefry", "mwc"])
def test_render_regen_other_schemes_matches_scan(scheme):
    """The regeneration loop keys each lane's draws on its own bounce: the
    same estimator as the per-sample loop with either scheme."""
    _, _, cfg, sc = _cornell_simple()
    cam = default_camera(SIZE, SIZE).pytree("cpu")
    with torch.no_grad():
        a, aa = pathtracer.render(cfg, sc, cam, SIZE, SIZE, 2, seed=5,
                                  rng_scheme=scheme, method="regen")
        b, ba = pathtracer.render(cfg, sc, cam, SIZE, SIZE, 2, seed=5,
                                  rng_scheme=scheme, method="while")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aa.numpy(), ba.numpy(), rtol=1e-5, atol=1e-6)
