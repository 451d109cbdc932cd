"""The port's ``render`` with its default method (``scan``) against the
stored goldens of tests/golden_tool.py (32^2, seed 9, rendered by the JAX
package's jitted ``render``), at tests/test_golden.py's rtol 1e-4 /
atol 1e-5.

Some goldens hold grazing decisions (a sphere hit near its silhouette, a
shadow ray leaving a sphere near its terminator) that an ulp of difference
in the camera ray flips.  The JAX package cannot reproduce those pixels
itself: its own un-jitted render of the same config misses the golden
there, as XLA's fusion rounds differently from op-by-op execution.  So a
pixel of the port may miss the golden only where the reference's
un-jitted render misses it too; every other pixel must meet the bound.
cornell_hi_bvh (81,920 triangles) loads with the walk on the CPU, as the
reference's does, and renders through the walk's twin.

sdf_demo's normals are central differences at 2e-5, which magnify an ulp
of the camera ray; the two packages' camera rays differ in last bits, so
there the reference's un-jitted render runs on the port's rays.
"""
import json

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
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere

torch.set_num_threads(2)

SIZE, SEED = 32, 9
RTOL, ATOL = 1e-4, 1e-5
ICO = dict(subdiv=1, radius=0.7, center=(0.0, 0.8, 0.0))
# name: (scene, spp, load_scene keywords) as tests/golden_tool.py renders it
GOLDENS = {
    "cornell_simple": ("scenes/cornell_simple.json", 8, {}),
    "mesh_icosphere": ("scenes/cornell_simple.json", 4, {"mesh": ICO}),
    "multi_light_pick": ("scenes/multilight_pick.json", 8, {}),
    "alpha_test": ("scenes/cornell_simple.json", 8, {"alpha_testing": True}),
    "coat_grazing": ("scenes/coat_grazing.json", 8, {}),
    "cornell_hi_bvh": ("scenes/cornell_hi.json", 2, {}),
    "materials": ("scenes/materials.json", 4, {}),
    "sdf_demo": ("scenes/sdf_demo.json", 4, {}),
    "cornell_media": ("scenes/cornell_media.json", 4, {}),
    "envmap": ("scenes/cornell_simple.json", 4, {"env": True}),
    "exponential_fog": ("scenes/cornell_simple.json", 4,
                        {"medium": {"type": "exponential", "density": 0.4,
                                    "sigmaA": 0.1, "sigmaS": 0.6}}),
}


def golden_env_map():
    """tests/golden_tool.py's 16 x 8 gradient map."""
    u = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    gx, gy = np.meshgrid(u, u[:8], indexing="xy")
    return np.stack([gx, gy, np.full((8, 16), 0.5, np.float32)],
                    axis=-1).astype(np.float32)


def _load(build, path, kw, **extra):
    """(cfg, scene) of a golden config through ``build`` (either package's
    build_scene), as tests/golden_tool.py loads it."""
    kw = dict(kw)
    with open(path) as fh:
        doc = json.load(fh)
    if "mesh" in kw:
        kw["mesh_override"] = make_icosphere(**kw.pop("mesh"))
    if kw.pop("env", False):
        kw["env_map"] = golden_env_map()
    if "medium" in kw:
        doc["global_medium"] = kw.pop("medium")
    return build(doc, **kw, **extra)


def _beyond(img, ref):
    return (np.abs(img - ref) > ATOL + RTOL * np.abs(ref)).any(axis=-1)


def _reference_unjitted_misses(path, spp, kw, ref, port_rays):
    """Pixels where the JAX package's own op-by-op render misses its
    golden (with ``port_rays``, on the port's camera rays)."""
    jcfg, jsc = _load(j_build, path, kw)
    with jax.disable_jit(), pytest.MonkeyPatch.context() as mp:
        if port_rays:
            cam = default_camera(SIZE, SIZE).pytree("cpu")
            px, py = pathtracer.pixel_grid(SIZE, SIZE, "cpu")

            def rays(cam_pytree, width, height, px_, py_, pixel_idx, sample,
                     seed, rng_scheme="pcg4d", jitter=True):
                s = int(np.asarray(sample).reshape(-1)[0])
                return tuple(jnp.asarray(r.numpy()) for r in
                             pathtracer.camera_rays_for_sample(
                                 cam, SIZE, SIZE, px, py, py * SIZE + px, s,
                                 int(seed), rng_scheme, jitter))

            mp.setattr(j_pt, "camera_rays_for_sample", rays)
        img, _ = j_pt.render(jcfg, jsc, j_default_camera(SIZE, SIZE).pytree(),
                             SIZE, SIZE, spp, seed=SEED)
    return _beyond(np.asarray(img), ref), np.asarray(img)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_default_method_matches_golden(name, record_property):
    path, spp, kw = GOLDENS[name]
    cfg, sc = _load(build_scene, path, kw, device="cpu")
    img, alpha = pathtracer.render(cfg, sc,
                                   default_camera(SIZE, SIZE).pytree("cpu"),
                                   SIZE, SIZE, spp, seed=SEED)
    with np.load(f"tests/golden/{name}.npz") as z:
        ref, ref_alpha = z["img"], z["alpha"]
    img = img.numpy()
    assert img.shape == ref.shape and np.isfinite(img).all()
    np.testing.assert_allclose(alpha.numpy(), ref_alpha, rtol=RTOL, atol=ATOL)
    beyond = _beyond(img, ref)
    allowed = np.zeros_like(beyond)
    share = 0.07
    if beyond.any():
        allowed, unjitted = _reference_unjitted_misses(
            path, spp, kw, ref, port_rays=cfg.n_sdfs > 0)
        # the port misses the golden no more often than the reference's
        # own un-jitted render does (sdf_demo: 91 of 1024 pixels), plus 1%
        share = max(share, allowed.mean() + 0.01)
        if cfg.n_sdfs:
            # beyond 3 bounces an ulp of a sampled direction (the two
            # packages' sin and cos) reaches an SDF normal magnified ~1e3:
            # pixels where the port parts from the un-jitted render on the
            # same camera rays are explained, at most 2% of them (measured
            # 12 of 1024 on sdf_demo; at <= 3 bounces none, in
            # tests/test_torch_sdf.py)
            parts = _beyond(img, unjitted)
            assert parts.mean() <= 0.02, int(parts.sum())
            allowed = allowed | parts
    unexplained = beyond & ~allowed
    record_property("pixels_beyond", int(beyond.sum()))
    record_property("reference_unjitted_beyond", int(allowed.sum()))
    print(json.dumps(dict(golden=name, beyond=int(beyond.sum()),
                          reference_unjitted_beyond=int(allowed.sum()))))
    assert not unexplained.any(), (
        f"{int(unexplained.sum())} pixels miss the golden where the "
        f"reference's own un-jitted render meets it: "
        f"{np.argwhere(unexplained)[:5].tolist()}")
    # the left-out pixels are a few grazing decisions
    assert beyond.mean() < share
