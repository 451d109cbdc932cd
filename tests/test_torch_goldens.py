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
(cornell_hi_bvh stays card-only: K1's twin is too slow for 81,920
triangles on the CPU.)
"""
import json

import jax
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
    "materials": ("scenes/materials.json", 4, {}),
}


def _kwargs(kw):
    kw = dict(kw)
    if "mesh" in kw:
        kw["mesh_override"] = make_icosphere(**kw.pop("mesh"))
    return kw


def _beyond(img, ref):
    return (np.abs(img - ref) > ATOL + RTOL * np.abs(ref)).any(axis=-1)


def _reference_unjitted_misses(path, spp, kw, ref):
    """Pixels where the JAX package's own op-by-op render misses its
    golden."""
    jcfg, jsc = j_load(path, **_kwargs(kw))
    with jax.disable_jit():
        img, _ = j_pt.render(jcfg, jsc, j_default_camera(SIZE, SIZE).pytree(),
                             SIZE, SIZE, spp, seed=SEED)
    return _beyond(np.asarray(img), ref)


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_default_method_matches_golden(name, record_property):
    path, spp, kw = GOLDENS[name]
    cfg, sc = load_scene(path, device="cpu", **_kwargs(kw))
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
    if beyond.any():
        allowed = _reference_unjitted_misses(path, spp, kw, ref)
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
    assert beyond.mean() < 0.07
