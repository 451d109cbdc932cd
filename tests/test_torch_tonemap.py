"""Display transform: the port's plain tonemap against the JAX package's
plain version and its Pallas kernel (interpret mode).  K2 itself is tested
on the card in tests/test_torch_cuda.py."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import pallas_kernels as j_pk
from photorealistic_rendering_using_opencl_tpu.ops.tonemap import tonemap as j_tonemap
from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
from photorealistic_rendering_using_opencl_tpu_torch.utils.image import png_bytes

torch.set_num_threads(2)

ATOL = 1e-6
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py"))
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


def _img(shape=(33, 47, 3), seed=0):
    return np.random.default_rng(seed).uniform(0, 3, shape).astype(np.float32)


@pytest.mark.parametrize("vignette", [True, False])
@pytest.mark.parametrize("brightness", [1.0, 1.7])
def test_plain_matches_reference_plain(vignette, brightness):
    img = _img()
    want = np.asarray(j_tonemap(jnp.asarray(img), vignette=vignette,
                                brightness=brightness, use_pallas=False))
    got = tm.tonemap(torch.from_numpy(img), vignette=vignette,
                     brightness=brightness).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("vignette", [True, False])
def test_plain_matches_reference_pallas_kernel(vignette):
    img = _img((40, 24, 3), seed=1)
    want = np.asarray(j_pk.tonemap_pallas(jnp.asarray(img), vignette=vignette,
                                          brightness=1.3))
    got = tm.tonemap_plain(torch.from_numpy(img), vignette=vignette,
                           brightness=1.3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", cs.K2_EDGE_SIZES)
@pytest.mark.parametrize("vignette,brightness", [(True, 1.0), (False, 1.7)])
def test_edge_set_nan_where_reference(shape, vignette, brightness):
    """Non-finite, negative, zero, tiny and huge radiance (chip_smoke's edge
    set, which K2 is held to on the card): the port's plain version is NaN
    in the same channels as the JAX package's plain version and its Pallas
    kernel (interpret), exactly the non-finite channels and those whose
    curve overflows, and within ATOL elsewhere."""
    img = cs.k2_edge_image(*shape, seed=100 * shape[0] + shape[1])
    got = tm.tonemap_plain(torch.from_numpy(img), vignette=vignette,
                           brightness=brightness).numpy()
    assert np.array_equal(np.isnan(got),
                          ~np.isfinite(img) | (np.abs(img) > 1e19))
    for want in (j_tonemap(jnp.asarray(img), vignette=vignette,
                           brightness=brightness, use_pallas=False),
                 j_pk.tonemap_pallas(jnp.asarray(img), vignette=vignette,
                                     brightness=brightness)):
        want = np.asarray(want)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_png_bytes_match_reference():
    from photorealistic_rendering_using_opencl_tpu.utils.image import (
        png_bytes as j_png_bytes,
    )
    ldr = tm.tonemap(torch.from_numpy(_img((9, 13, 3), seed=2))).numpy()
    assert png_bytes(ldr) == j_png_bytes(ldr)
