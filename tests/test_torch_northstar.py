"""The port's north-star tool (``tools/northstar.py`` of the port):
BASELINE's loss ``sum(acc) / (3 n)`` through ``trace_regen_scan`` and its
gradients over every float leaf of the scene and the camera, by pixel
bands and over the whole frame, on the tool's own scene
(``scenes/cornell.json``, bench.py's icosphere where its teapot is absent)
at 16^2 x 2 spp and the full 32-bounce budget.

- The bands' losses sum to the whole frame's within
  ``northstar.TILED_LOSS_REL`` (1e-6, relative), and their gradients,
  summed, to the whole frame's within ``northstar.TILED_GRAD_REL`` (1e-5)
  of each leaf's largest entry: the loss is a sum over pixels.  A camera
  leaf whose gradient is a sum that cancels parts by more on the card
  (float32 rounding against the terms' size): the tool's fallback, the
  camera's largest entry as that leaf's scale, is exercised with the
  bound lowered.
- The whole frame's value and gradients against the JAX package's
  value_and_grad of the same loss through its ``trace_regen_scan`` with
  the same budget: tests/test_torch_grad.py's bounds at 32 bounces (5e-4
  relative for the value; each leaf within rtol 5e-4 plus 5e-4 of its
  largest entry).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere as j_ico
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.tools import northstar

torch.set_num_threads(2)

W, SPP, TILES = 16, 2, 4
FWD_DEEP = 5e-4  # tests/test_torch_grad.py's FWD_TOL at 32 bounces
DEEP_GRAD_REL = 5e-4  # tests/test_torch_grad.py's


@functools.cache
def _port():
    cfg, sc, fallback = northstar.load(device="cpu")
    cam = default_camera(W, W).pytree("cpu")
    n_iters = northstar.calibrate(cfg, sc, cam, W, SPP)
    tiled = northstar.value_and_grads(cfg, sc, cam, W, SPP, n_iters, TILES)
    direct = northstar.value_and_grads(cfg, sc, cam, W, SPP, n_iters, 1)
    return cfg, fallback, n_iters, tiled, direct


def test_tiled_sum_is_the_direct_frame():
    cfg, _, _, tiled, direct = _port()
    assert cfg.max_bounces == 32
    assert tiled["completed"] == [SPP] * TILES and direct["completed"] == [SPP]
    gap = northstar.tiled_gap(tiled, direct)
    assert gap["loss"] <= northstar.TILED_LOSS_REL, gap["loss"]
    assert gap["grads"].keys() == direct["grads"].keys()
    for k, v in gap["grads"].items():
        assert v <= northstar.TILED_GRAD_REL, (k, v)
    northstar.check_tiled(gap)
    # the gradient reaches the colours, the geometry and the camera
    for k in ("scene.color", "scene.position", "camera.position"):
        assert float(direct["grads"][k].abs().max()) > 0.0, k
    # the CPU runs the twins: no kernel launches, in either pass
    assert direct["launches"] == dict(forward=dict(K1=0, W1=0),
                                      backward=dict(K1=0, W1=0))


def test_check_tiled_raises_past_its_bounds():
    _, _, _, tiled, direct = _port()
    moved = dict(direct, grads=dict(direct["grads"]))
    g = moved["grads"]["scene.color"]
    moved["grads"]["scene.color"] = g + 1e-3 * float(g.abs().max())
    with pytest.raises(RuntimeError, match="scene.color"):
        northstar.check_tiled(northstar.tiled_gap(tiled, moved))
    moved = dict(direct, grads=dict(direct["grads"]))
    g = moved["grads"]["camera.position"]
    moved["grads"]["camera.position"] = g + 1e-3 * float(g.abs().max())
    with pytest.raises(RuntimeError, match="camera.position"):
        northstar.check_tiled(northstar.tiled_gap(tiled, moved))
    with pytest.raises(RuntimeError, match="loss"):
        northstar.check_tiled(northstar.tiled_gap(
            tiled, dict(direct, loss=direct["loss"] * (1 + 1e-5))))


def test_check_tiled_holds_camera_leaves_to_the_camera_scale(monkeypatch):
    """Past TILED_GRAD_REL (lowered here to 1e-6, which the focal
    distance's gradient, a sum over lanes that cancels under the small
    aperture, exceeds), a camera leaf passes within the bound of the
    camera's largest gradient entry; lowered to 1e-8, scene leaves, which
    have no such fallback, fail."""
    _, _, _, tiled, direct = _port()
    gap = northstar.tiled_gap(tiled, direct)
    monkeypatch.setattr(northstar, "TILED_GRAD_REL", 1e-6)
    past = [k for k, v in gap["grads"].items() if v > 1e-6]
    assert past == ["camera.focal_distance"]
    assert gap["camera"]["camera.focal_distance"] < 1e-6
    northstar.check_tiled(gap)
    monkeypatch.setattr(northstar, "TILED_GRAD_REL", 1e-8)
    with pytest.raises(RuntimeError, match="scene.color"):
        northstar.check_tiled(gap)


def test_direct_matches_reference():
    cfg, fallback, n_iters, _, direct = _port()
    jcfg, jsc = (j_load("scenes/cornell.json",
                        mesh_override=j_ico(**northstar.FALLBACK_MESH))
                 if fallback else j_load("scenes/cornell.json"))
    jcam = j_default_camera(W, W).pytree()
    px, py = j_pt.pixel_grid(W, W)
    names = [f.name for f in dataclasses.fields(jsc)
             if jnp.issubdtype(jnp.asarray(getattr(jsc, f.name)).dtype,
                               jnp.floating)]

    def loss(p, c):
        acc, _, done = j_pt.trace_regen_scan(
            jcfg, dataclasses.replace(jsc, **p), c, W, W, SPP, px, py,
            northstar.SEED, n_iters)
        return jnp.sum(acc) / (3.0 * W * W), done

    (val, done), (gs, gc) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(
            {k: getattr(jsc, k) for k in names}, jcam)
    assert int(done) == SPP
    np.testing.assert_allclose(direct["loss"], float(val), rtol=FWD_DEEP)
    want = {f"scene.{k}": np.asarray(v) for k, v in gs.items()}
    want.update({f"camera.{k}": np.asarray(v) for k, v in gc.items()})
    assert want.keys() == direct["grads"].keys()
    for k, w in want.items():
        got = direct["grads"][k].numpy()
        assert got.shape == w.shape and np.isfinite(got).all(), k
        np.testing.assert_allclose(
            got, w, rtol=DEEP_GRAD_REL,
            atol=DEEP_GRAD_REL * float(np.abs(w).max(initial=0.0)),
            err_msg=k)
