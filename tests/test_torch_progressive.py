"""The progressive API: the port's progressive_init / step / reset / image
against the JAX package's, and progressive accumulation against the port's
own ``render(method="while")``.

Scenes: cornell_simple.json (4 bounces) and cornell.json with bench.py's
icosphere for its missing teapot (the COAT mesh through K1's plain twin),
its budget cut to 4 bounces: at <= 4 bounces the port's usual 1e-5 holds
(deeper paths amplify ulp differences between the frameworks' sin, exp and
division, tests/test_torch_trace.py).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

torch.set_num_threads(2)

# bench.py's stand-in for cornell.json's teapot
BENCH_ICOSPHERE = dict(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
SCENES = {
    "cornell_simple": ("scenes/cornell_simple.json", None),
    "icosphere_coat_4": ("scenes/cornell.json", BENCH_ICOSPHERE),
}
W, H = 16, 12
STEPS = 4
TOL = 1e-5


@functools.cache
def _scenes(name):
    path, mesh = SCENES[name]
    mesh_np = None if mesh is None else make_icosphere(**mesh)
    jcfg, jsc = j_load(path, mesh_override=mesh_np)
    cfg, sc = load_scene(path, mesh_override=mesh_np, device="cpu")
    if mesh is not None:
        jcfg = dataclasses.replace(jcfg, max_bounces=4)
        cfg = dataclasses.replace(cfg, max_bounces=4)
        assert cfg.n_triangles == jcfg.n_triangles == 320
    return jcfg, jsc, cfg, sc


def _assert_state(got, want):
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(want.acc),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=TOL, atol=TOL)
    assert got.samples.dtype == got.seed.dtype == torch.int64
    assert int(got.samples) == int(want.samples)
    assert int(got.seed) == int(want.seed)


@pytest.mark.parametrize("scheme", ["pcg4d", "threefry"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_progressive_matches_reference(name, scheme):
    """init, 4 steps, image, reset and one step more, against JAX."""
    jcfg, jsc, cfg, sc = _scenes(name)
    jcam = j_default_camera(W, H).pytree()
    cam = default_camera(W, H).pytree("cpu")
    seed = 0xFFFFFFFF if scheme == "threefry" else 7
    js = j_pt.progressive_init(W, H, seed=seed)
    ts = pathtracer.progressive_init(W, H, seed=seed, device="cpu")
    _assert_state(ts, js)
    for _ in range(STEPS):
        js = j_pt.progressive_step(jcfg, jsc, jcam, js, rng_scheme=scheme)
        ts = pathtracer.progressive_step(cfg, sc, cam, ts, rng_scheme=scheme)
        _assert_state(ts, js)
    (img, alpha), (jimg, jalpha) = (pathtracer.progressive_image(ts),
                                    j_pt.progressive_image(js))
    assert img.shape == (H, W, 3) and alpha.shape == (H, W)
    assert torch.isfinite(img).all() and float(img.mean()) > 0.01
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=TOL,
                               atol=TOL)
    js, ts = j_pt.progressive_reset(js), pathtracer.progressive_reset(ts)
    _assert_state(ts, js)
    assert not ts.acc.any() and int(ts.seed) == seed
    js = j_pt.progressive_step(jcfg, jsc, jcam, js, rng_scheme=scheme)
    ts = pathtracer.progressive_step(cfg, sc, cam, ts, rng_scheme=scheme)
    _assert_state(ts, js)


def test_progressive_image_of_empty_state_is_zero():
    ts = pathtracer.progressive_init(W, H, device="cpu")
    img, alpha = pathtracer.progressive_image(ts)
    jimg, jalpha = j_pt.progressive_image(j_pt.progressive_init(W, H))
    assert not img.any() and not alpha.any()
    np.testing.assert_array_equal(img.numpy(), np.asarray(jimg))


def test_progressive_seed_wraps_to_uint32():
    """The state's seed and count are the reference's uint32s."""
    ts = pathtracer.progressive_init(W, H, seed=-1, device="cpu")
    assert int(ts.seed) == 0xFFFFFFFF == int(j_pt.progressive_init(
        W, H, seed=jnp.uint32(0xFFFFFFFF)).seed)
    full = ts._replace(samples=torch.tensor(0xFFFFFFFF))
    _, _, cfg, sc = _scenes("cornell_simple")
    nxt = pathtracer.progressive_step(cfg, sc, default_camera(W, H).pytree("cpu"),
                                      full)
    assert int(nxt.samples) == 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_progressive_accumulation_is_render_while(name):
    """Step by step, the running mean is bitwise render(method="while") at
    the same spp and seed: both add the same per-sample radiance in the
    same order and divide once by spp."""
    _, _, cfg, sc = _scenes(name)
    cam = default_camera(W, H).pytree("cpu")
    ts = pathtracer.progressive_init(W, H, seed=3, device="cpu")
    for _ in range(3):
        ts = pathtracer.progressive_step(cfg, sc, cam, ts)
    img, alpha = pathtracer.progressive_image(ts)
    with torch.no_grad():
        want, want_a = pathtracer.render(cfg, sc, cam, W, H, 3, seed=3,
                                         method="while")
    assert torch.equal(img, want) and torch.equal(alpha, want_a)


def test_progressive_step_leaves_its_input_untouched():
    _, _, cfg, sc = _scenes("cornell_simple")
    cam = default_camera(W, H).pytree("cpu")
    ts = pathtracer.progressive_init(W, H, device="cpu")
    ts1 = pathtracer.progressive_step(cfg, sc, cam, ts)
    ts2 = pathtracer.progressive_step(cfg, sc, cam, ts1)
    assert not ts.acc.any() and int(ts.samples) == 0
    assert int(ts1.samples) == 1 and int(ts2.samples) == 2
    assert not torch.equal(ts1.acc, ts2.acc)


def test_progressive_init_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pathtracer.progressive_init(W, H)
