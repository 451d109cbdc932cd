"""The slice end to end: the port's render(method="regen") against the JAX
package's render(method="regen") and against the stored goldens.

Bounds are tests/test_regen_aov.py's: 1e-5 at <= 4 bounces (float noise
cannot hide an estimator difference there) and 5e-4 at the 32-bounce
budget (ulp differences between two frameworks' sin/exp/division are
amplified chaotically by deep bouncing).
"""
import dataclasses

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
from photorealistic_rendering_using_opencl_tpu_torch.ops.tonemap import tonemap
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.utils.image import write_png

torch.set_num_threads(2)

CASES = {
    # scene, mesh, size, spp, seed, tolerance
    "cornell_simple": ("scenes/cornell_simple.json", None, 24, 3, 4, 1e-5),
    "cornell_icosphere_coat": (
        "scenes/cornell.json",
        dict(subdiv=2, radius=0.6, center=(0.0, 1.0, 0.0)), 16, 2, 4, 5e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_regen_matches_reference(case):
    path, mesh, size, spp, seed, tol = CASES[case]
    mesh_np = None if mesh is None else make_icosphere(**mesh)
    jcfg, jsc = j_load(path, mesh_override=mesh_np)
    want, want_a = j_pt.render(jcfg, jsc, j_default_camera(size, size).pytree(),
                               size, size, spp, seed=seed, method="regen")
    cfg, sc = load_scene(path, mesh_override=mesh_np, device="cpu")
    if mesh is not None:
        assert cfg.mesh_accel == jcfg.mesh_accel == "brute"
        assert cfg.n_triangles == 320 and cfg.max_bounces == 32
    got, got_a = pathtracer.render(cfg, sc, default_camera(size, size).pytree("cpu"),
                                   size, size, spp, seed=seed, method="regen")
    assert got.shape == (size, size, 3) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=tol,
                               atol=tol)


# tests/golden_tool.py's configs, rendered there by the JAX package (its
# default method, "scan": the same estimator, keyed on (pixel, sample))
GOLDENS = {
    "cornell_simple": ("scenes/cornell_simple.json", None, 8),
    "mesh_icosphere": ("scenes/cornell_simple.json",
                       dict(subdiv=1, radius=0.7, center=(0.0, 0.8, 0.0)), 4),
}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_render_matches_golden(name):
    path, mesh, spp = GOLDENS[name]
    cfg, sc = load_scene(path, device="cpu",
                         mesh_override=None if mesh is None
                         else make_icosphere(**mesh))
    img, alpha = pathtracer.render(cfg, sc, default_camera(32, 32).pytree("cpu"),
                                   32, 32, spp, seed=9, method="regen")
    with np.load(f"tests/golden/{name}.npz") as z:
        ref, ref_alpha = z["img"], z["alpha"]
    np.testing.assert_allclose(img.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alpha.numpy(), ref_alpha, rtol=1e-5, atol=1e-5)


def test_library_recipe_writes_png(tmp_path):
    """load_scene -> render -> tonemap -> write_png, the user's path."""
    cfg, sc = load_scene("scenes/cornell_simple.json", device="cpu")
    img, _ = pathtracer.render(cfg, sc, default_camera(16, 16).pytree("cpu"),
                               16, 16, 1, method="regen")
    out = tmp_path / "cornell.png"
    write_png(str(out), tonemap(img).numpy())
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("method, item", [("scan", "M9"), ("while", "M9"),
                                          ("bdpt", "M13")])
def test_unported_methods_raise(method, item):
    cfg, sc = load_scene("scenes/cornell_simple.json", device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        pathtracer.render(cfg, sc, default_camera(8, 8).pytree("cpu"), 8, 8, 1,
                          method=method)


def test_regen_scan_needs_regen_iters():
    """As the reference: the differentiable loop's budget is not guessed."""
    cfg, sc = load_scene("scenes/cornell_simple.json", device="cpu")
    with pytest.raises(ValueError, match="regen_iters"):
        pathtracer.render(cfg, sc, default_camera(8, 8).pytree("cpu"), 8, 8, 1,
                          method="regen_scan")


def test_regen_raises_past_its_iteration_bound():
    """The loop stops at the reference's bound and refuses to return a
    partial image (the reference's while_loop silently stops there)."""
    cfg, sc = load_scene("scenes/cornell_simple.json", device="cpu")
    tight = dataclasses.replace(cfg, max_bounces=0)  # bound = spp*0 + 64
    cfg_hi = dataclasses.replace(cfg, max_bounces=4, max_diff_bounces=4)
    px, py = pathtracer.pixel_grid(8, 8, "cpu")
    cam = default_camera(8, 8).pytree("cpu")
    _, _, it = pathtracer.trace_regen(cfg_hi, sc, cam, 8, 8, 2, px, py, 0,
                                      return_iters=True)
    assert 0 < it <= 2 * 4 + 64
    with pytest.raises(RuntimeError, match="unfinished"):
        pathtracer.trace_regen(tight, sc, cam, 8, 8, 200, px, py, 0)
