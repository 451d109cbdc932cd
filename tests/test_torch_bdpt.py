"""Bidirectional path tracing (ROADMAP M13) on the CPU against the JAX
package's ``render(method="bdpt")``: radiance per (pixel, sample) within
the suite's 4-bounce bound (1e-5) on cornell_simple, multilight and a mesh
scene under both mesh backends; finite, non-negative images; the depth
truncation warning; the merged connection batch against per-strategy
visibility; and the gradient of mean(image) with respect to the colour
leaves against ``jax.grad`` (rtol 1e-4 / atol 1e-6).  The converged
comparison with the unidirectional tracer (tests/test_bdpt.py's bounds)
runs on the card, in chip_smoke.py phase 24.
"""
import dataclasses
import functools
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene as j_build
from photorealistic_rendering_using_opencl_tpu_torch.models import bidirectional, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

torch.set_num_threads(2)

SIDE, SPP, DEPTH, SEED = 8, 2, 3, 5
TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
MESH = dict(subdiv=2, radius=0.6, center=(0.0, 1.0, 0.0))  # 320 triangles
CASES = {
    # scene file, mesh, mesh backend
    "cornell_simple": ("scenes/cornell_simple.json", None, None),
    "multilight": ("scenes/multilight.json", None, None),
    "mesh_brute": ("scenes/cornell.json", MESH, "brute"),
    "mesh_bvh": ("scenes/cornell.json", MESH, "bvh"),
}


@functools.cache
def _scenes(case):
    path, mesh, accel = CASES[case]
    with open(path) as fh:
        doc = json.load(fh)
    kw = {} if mesh is None else {"mesh_override": make_icosphere(**mesh)}
    jcfg, jsc = j_build(doc, **kw)
    cfg, sc = build_scene(doc, device="cpu", **kw)
    if accel is not None:
        jcfg = dataclasses.replace(jcfg, mesh_accel=accel)
        cfg = dataclasses.replace(cfg, mesh_accel=accel)
    return jcfg, jsc, cfg, sc


@pytest.mark.parametrize("case", sorted(CASES))
def test_bdpt_radiance_matches_reference(case):
    """Each sample's radiance per pixel (render_sample), depth 3."""
    jcfg, jsc, cfg, sc = _scenes(case)
    j_sample = jax.jit(functools.partial(
        j_pt.render_sample, jcfg, width=SIDE, height=SIDE, seed=SEED,
        method="bdpt", bdpt_max_depth=DEPTH))
    jcam = j_default_camera(SIDE, SIDE).pytree()
    cam = default_camera(SIDE, SIDE).pytree("cpu")
    for s in range(SPP):
        want, want_a = j_sample(jsc, jcam, sample_idx=jnp.uint32(s))
        got, got_a = pathtracer.render_sample(
            cfg, sc, cam, SIDE, SIDE, s, seed=SEED, method="bdpt",
            bdpt_max_depth=DEPTH)
        assert got.shape == (SIDE * SIDE, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"sample {s}")
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        assert got.sum() > 0


def test_bdpt_nonnegative_and_finite():
    """tests/test_bdpt.py's contract at its size: 8^2 x 16 spp."""
    _, _, cfg, sc = _scenes("cornell_simple")
    img, _ = pathtracer.render(cfg, sc, default_camera(8, 8).pytree("cpu"), 8,
                               8, 16, seed=1, method="bdpt")
    assert torch.isfinite(img).all() and (img >= 0.0).all()
    assert img.mean() > 0


def test_bdpt_depth_truncation_warns():
    """The default depth cap truncates a scene deeper than it, with the
    reference's warning; a depth at the scene's budget does not warn."""
    _, _, cfg, sc = _scenes("mesh_brute")
    assert cfg.max_bounces > bidirectional.DEFAULT_DEPTH_CAP
    cam = default_camera(4, 4).pytree("cpu")
    with pytest.warns(UserWarning, match="truncates"):
        pathtracer.render_sample(cfg, sc, cam, 4, 4, 0, method="bdpt")
    shallow = dataclasses.replace(cfg, max_bounces=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pathtracer.render_sample(shallow, sc, cam, 4, 4, 0, method="bdpt",
                                 bdpt_max_depth=2)


@pytest.mark.parametrize("case", ["mesh_brute", "mesh_bvh"])
def test_merged_connections_bitwise_per_strategy(case, monkeypatch):
    """A sample tests all of its connections in one shadow_visible call,
    and each connection's verdict is bitwise what shadow_visible gives
    that connection alone (the reference's schedule)."""
    _, _, cfg, sc = _scenes(case)
    calls, seen = [], []
    real_visible = bidirectional.shadow_visible
    real_connection = bidirectional.connection_visible

    def counting(*args, **kw):
        calls.append(args[2].shape[0])
        return real_visible(*args, **kw)

    def recording(cfg_, scene, conns):
        seen.append((conns, real_connection(cfg_, scene, conns)))
        return seen[-1][1]

    monkeypatch.setattr(bidirectional, "shadow_visible", counting)
    monkeypatch.setattr(bidirectional, "connection_visible", recording)
    n = SIDE * SIDE
    pathtracer.render_sample(cfg, sc, default_camera(SIDE, SIDE).pytree("cpu"),
                             SIDE, SIDE, 0, seed=SEED, method="bdpt",
                             bdpt_max_depth=DEPTH)
    n_conn = DEPTH * (DEPTH + 1) // 2
    assert calls == [n_conn * n]
    (conns, merged), = seen
    assert len(conns) == len(merged) == n_conn
    occluded = 0
    for c, vis in zip(conns, merged):
        alone = intersect.shadow_visible(cfg, sc, c.origin, c.direction,
                                         c.dist, active=c.cand)
        assert torch.equal(vis, alone)
        occluded += int((c.cand & ~vis).sum())
    assert occluded > 0


def test_bdpt_colour_gradients_match_reference():
    """d mean(image) / d the objects' colours at 8^2 x 1 spp, depth 2, on
    cornell_simple, against jax.grad."""
    jcfg, jsc, cfg, sc = _scenes("cornell_simple")
    names = ("color",)
    jcam = j_default_camera(8, 8).pytree()

    def j_loss(p):
        img, _ = j_pt.render(jcfg, dataclasses.replace(jsc, **p), jcam, 8, 8,
                             1, seed=SEED, method="bdpt", bdpt_max_depth=2)
        return jnp.mean(img)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jax.jit(jax.grad(j_loss))({k: getattr(jsc, k) for k in names})
        p = {k: getattr(sc, k).clone().requires_grad_() for k in names}
        img, _ = pathtracer.render(cfg, dataclasses.replace(sc, **p),
                                   default_camera(8, 8).pytree("cpu"), 8, 8,
                                   1, seed=SEED, method="bdpt",
                                   bdpt_max_depth=2)
    grads = torch.autograd.grad(img.mean(), list(p.values()))
    for k, g in zip(names, grads):
        w = np.asarray(want[k])
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        assert np.abs(w).max() > 1e-4, k
