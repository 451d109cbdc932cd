"""Inverse rendering through the port's diff/inverse.py, against the JAX
package's ``fit_scene`` (methods ``regen_scan`` and ``scan``) and against
the goal of the reference's own test: recover a wall albedo from an image
of the scene."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.diff import fit_scene as j_fit_scene
from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene as j_build
from photorealistic_rendering_using_opencl_tpu_torch.diff import (
    FitResult, fit_scene, image_loss, make_loss_fn,
)
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import pytree_from_numpy
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

W = H = 8
# tests/test_grad.py's scene
CORNELL = {
    "settings": {"MAX_BOUNCES": 3, "MAX_DIFF_BOUNCES": 3,
                 "MAX_SPEC_BOUNCES": 3, "MAX_TRANS_BOUNCES": 3},
    "scene": {
        "spheres": [{"pos": [0.0, 3.0, 0.0], "radius": 0.5,
                     "material": {"color": [5.0, 5.0, 5.0], "type": 0}}],
        "quads": [
            {"vertices": [0.0, 0.0, 0.0, 4.0, 0.0, 0.0, 0.0, 0.0, 4.0],
             "material": {"color": [0.7, 0.7, 0.7]}},
            {"vertices": [2.0, 2.0, 0.0, 0.0, 4.0, 0.0, 0.0, 0.0, 4.0],
             "material": {"color": [0.8, 0.1, 0.1]}},
        ],
    },
}
WRONG_WALL = np.array([0.2, 0.6, 0.9], np.float32)
# The first loss is a forward render of the same scene by both packages
# (1e-5 per pixel at 3 bounces); the next two follow Adam steps taken from
# gradients that agree to rtol 1e-4 (tests/test_torch_grad.py), and Adam's
# first steps are ~lr * sign(g), so the parameters, and the losses, agree
# far closer than that.  Bound: rtol 1e-4.
LOSS_RTOL = 1e-4


def _scenes():
    jcfg, jsc = j_build(CORNELL)
    jcam = j_default_camera(W, H).pytree()
    target, _ = j_pt.render(jcfg, jsc, jcam, W, H, 8, seed=11)
    wrong = dataclasses.replace(
        jsc, color=jsc.color.at[2].set(jnp.asarray(WRONG_WALL)))
    leaves = {f.name: np.asarray(getattr(wrong, f.name))
              for f in dataclasses.fields(wrong)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    cam = pytree_from_numpy({k: np.asarray(v) for k, v in jcam.items()}, "cpu")
    return (jcfg, wrong, jcam, target), (cfg, sc, cam)


def test_fit_scene_regen_scan_recovers_albedo_and_matches_reference():
    (jcfg, jwrong, jcam, jtarget), (cfg, sc, cam) = _scenes()
    # the target: the port's own forward render (the same estimator as the
    # reference's default "scan" method, keyed on (pixel, sample))
    truth = dataclasses.replace(sc, color=sc.color.clone())
    truth.color[2] = torch.tensor([0.8, 0.1, 0.1])
    target, _ = pathtracer.render(cfg, truth, cam, W, H, 8, seed=11,
                                  method="regen")
    np.testing.assert_allclose(target.numpy(), np.asarray(jtarget), rtol=1e-5,
                               atol=1e-5)

    res = fit_scene(cfg, sc, cam, W, H, 4, target, steps=16, lr=0.1,
                    param_leaves=("color",), method="regen_scan")
    assert isinstance(res, FitResult) and res.losses.shape == (16,)
    assert torch.isfinite(res.losses).all()
    assert float(res.losses[-1]) < float(res.losses[0]) * 0.6
    rec = res.scene.color[2].numpy()
    assert np.abs(rec - np.array([0.8, 0.1, 0.1])).max() < 0.3
    assert (res.scene.color >= 0).all()
    assert torch.equal(sc.color[2], torch.from_numpy(WRONG_WALL))  # untouched

    j_res = j_fit_scene(jcfg, jwrong, jcam, W, H, 4, jtarget, steps=3, lr=0.1,
                        param_leaves=("color",), method="regen_scan")
    np.testing.assert_allclose(res.losses[:3].numpy(), np.asarray(j_res.losses),
                               rtol=LOSS_RTOL)


def test_fit_scene_scan_matches_reference():
    """The reference's default method: every bounce of every sample, no
    budget to calibrate."""
    (jcfg, jwrong, jcam, jtarget), (cfg, sc, cam) = _scenes()
    target = torch.from_numpy(np.array(jtarget))
    res = fit_scene(cfg, sc, cam, W, H, 4, target, steps=3, lr=0.1,
                    param_leaves=("color",))
    j_res = j_fit_scene(jcfg, jwrong, jcam, W, H, 4, jtarget, steps=3, lr=0.1,
                        param_leaves=("color",))
    assert torch.isfinite(res.losses).all()
    np.testing.assert_allclose(res.losses.numpy(), np.asarray(j_res.losses),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.scene.color.numpy(),
                               np.asarray(j_res.scene.color), rtol=1e-4,
                               atol=1e-6)


def test_loss_fn_matches_image_loss_and_reference():
    (jcfg, jwrong, jcam, jtarget), (cfg, sc, cam) = _scenes()
    target = torch.from_numpy(np.array(jtarget))
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, W, H, 4, seed=1)
    loss = make_loss_fn(cfg, sc, cam, W, H, 4, target, ("color",),
                        method="regen_scan", regen_iters=n)
    got = loss({"color": sc.color}, 5)
    assert torch.equal(got, image_loss(cfg, sc, cam, W, H, 4, target, 5,
                                       method="regen_scan", regen_iters=n))
    img, _ = j_pt.render(jcfg, jwrong, jcam, W, H, 4, seed=5)
    want = float(jnp.mean(jnp.square(img - jtarget)))
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("method, err, match", [
    ("while", ValueError, "differentiable"),
    ("regen", ValueError, "differentiable")])
def test_fit_scene_refuses_unported_methods(method, err, match):
    _, (cfg, sc, cam) = _scenes()
    with pytest.raises(err, match=match):
        fit_scene(cfg, sc, cam, W, H, 1, torch.zeros((H, W, 3)), steps=1,
                  method=method)
