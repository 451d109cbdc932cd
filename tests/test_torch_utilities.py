"""The utilities nothing in the renderer calls (ROADMAP M16), held to the
JAX package on the same seeded numpy inputs: texture sampling, value noise,
Phong tessellation, the Blinn NDF, the motion-blur time hook and the
sampling inverses.  Each is a twin of the JAX package's own test
(tests/test_texture.py, test_noise_profiling.py, test_misc_parity.py,
test_sampling.py) plus a comparison with the JAX function: bitwise where
the arithmetic is elementwise in the same order, else within 1e-6 (a
transcendental's last bit: atan2, pow, log2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import camera_rays as j_cam
from photorealistic_rendering_using_opencl_tpu.ops import microfacet as j_mf
from photorealistic_rendering_using_opencl_tpu.ops import noise as j_noise
from photorealistic_rendering_using_opencl_tpu.ops import sampling as j_smp
from photorealistic_rendering_using_opencl_tpu.ops import texture as j_tex
from photorealistic_rendering_using_opencl_tpu.scene import phong_tess as j_pt
from photorealistic_rendering_using_opencl_tpu_torch.ops import (
    camera_rays, microfacet, noise, sampling, texture,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene import phong_tess

TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


# --------------------------------------------------------------- texture

def _checker(h=16, w=16):
    y, x = np.mgrid[0:h, 0:w]
    c = ((x + y) % 2).astype(np.float32)
    return np.stack([c, 1 - c, np.full_like(c, 0.5)], axis=-1)


def _random_tex(seed=3, h=24, w=40):
    return np.random.default_rng(seed).random((h, w, 3), dtype=np.float32)


@pytest.mark.parametrize("tex", ["checker", "random"])
def test_pyramid_shapes_and_means(tex):
    img = _checker() if tex == "checker" else _random_tex()
    pyr = texture.build_mip_pyramid(_t(img))
    want = j_tex.build_mip_pyramid(jnp.asarray(img))
    assert len(pyr) == len(want)
    for level, w in zip(pyr, want):
        _same(level, w)  # elementwise adds in the reference's order
    assert pyr[-1].shape[0] == 1
    if tex == "checker":
        assert pyr[0].shape == (16, 16, 3)
        for level in pyr:  # the box filter keeps the mean
            np.testing.assert_allclose(float(level.mean()),
                                       float(pyr[0].mean()), atol=1e-6)


def test_bilinear_interpolates_between_texels():
    tex = np.array([[[0.0], [1.0]]], np.float32)  # 1x2
    u = np.asarray([0.25, 0.5, 0.75], np.float32)
    v = np.full((3,), 0.5, np.float32)
    out = texture.sample_bilinear(_t(tex), _t(u), _t(v))[:, 0]
    np.testing.assert_allclose(out.numpy(), [0.0, 0.5, 1.0], atol=1e-6)
    # wrap addressing on a ragged texture, negative and > 1 UVs
    rng = np.random.default_rng(11)
    tex = _random_tex()
    u, v = (rng.uniform(-2.0, 3.0, 512).astype(np.float32) for _ in range(2))
    _same(texture.sample_bilinear(_t(tex), _t(u), _t(v)),
          j_tex.sample_bilinear(jnp.asarray(tex), jnp.asarray(u),
                                jnp.asarray(v)))


def test_trilinear_lod_blends_to_average():
    pyr = texture.build_mip_pyramid(_t(_checker()))
    u, v = _t([0.37]), _t([0.61])
    fine = texture.sample_trilinear(pyr, u, v, _t([0.0]))
    coarse = texture.sample_trilinear(pyr, u, v, _t([float(len(pyr) - 1)]))
    np.testing.assert_allclose(coarse[0].numpy(),
                               pyr[-1].reshape(-1)[:3].numpy(), atol=1e-5)
    assert not np.allclose(fine.numpy(), coarse.numpy())
    # against the reference on random UVs and LODs past both ends
    rng = np.random.default_rng(12)
    tex = _random_tex(h=32, w=32)
    u, v = (rng.random(256, dtype=np.float32) for _ in range(2))
    lod = rng.uniform(-1.0, 7.0, 256).astype(np.float32)
    _same(texture.sample_trilinear(texture.build_mip_pyramid(_t(tex)),
                                   _t(u), _t(v), _t(lod)),
          j_tex.sample_trilinear(j_tex.build_mip_pyramid(jnp.asarray(tex)),
                                 jnp.asarray(u), jnp.asarray(v),
                                 jnp.asarray(lod)))


def test_anisotropic_runs_and_averages():
    pyr = texture.build_mip_pyramid(_t(_checker()))
    jpyr = j_tex.build_mip_pyramid(jnp.asarray(_checker()))
    n = 8
    u = np.linspace(0.1, 0.9, n, dtype=np.float32)
    v = np.linspace(0.2, 0.8, n, dtype=np.float32)
    du = np.tile(np.asarray([[0.2, 0.0]], np.float32), (n, 1))
    dv = np.tile(np.asarray([[0.0, 0.01]], np.float32), (n, 1))
    out = texture.sample_anisotropic(pyr, _t(u), _t(v), _t(du), _t(dv))
    assert out.shape == (n, 3)
    assert torch.isfinite(out).all()
    # heavy anisotropy along x averages the checker toward 0.5
    assert (out[:, 0] - 0.5).abs().max() < 0.45
    _close(out, j_tex.sample_anisotropic(jpyr, *map(jnp.asarray,
                                                   (u, v, du, dv))))
    # random gradients: the LOD is a log2 (its last bit may differ)
    rng = np.random.default_rng(13)
    u, v = (rng.random(256, dtype=np.float32) for _ in range(2))
    du, dv = (rng.uniform(-0.3, 0.3, (256, 2)).astype(np.float32)
              for _ in range(2))
    _close(texture.sample_anisotropic(pyr, *map(_t, (u, v, du, dv))),
           j_tex.sample_anisotropic(jpyr, *map(jnp.asarray, (u, v, du, dv))))


# ----------------------------------------------------------------- noise

def _points(seed, n, lo, hi):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(
        np.float32)


def _jax_sine(monkeypatch):
    """The port's lattice sine replaced by the JAX package's: the hash
    multiplies the sine by 43758.5, so a last bit of it moves a hash by
    ~3e-3; with the same sine the rest is bitwise."""
    monkeypatch.setattr(noise, "_sin", lambda x: torch.from_numpy(
        np.array(jnp.sin(jnp.asarray(x.numpy())))))


def test_value_noise_range_and_determinism(monkeypatch):
    p = _points(0, 256, -10, 10)
    n1 = noise.value_noise(_t(p))
    n2 = noise.value_noise(_t(p))
    assert n1.shape == (256,)
    assert torch.equal(n1, n2)
    assert float(n1.min()) >= 0.0 and float(n1.max()) <= 1.0
    assert float(n1.std()) > 0.05  # non-constant
    want = np.asarray(j_noise.value_noise(jnp.asarray(p)))
    # the port's sine is correctly rounded, JAX's nearly always
    assert (n1.numpy() == want).mean() > 0.9
    np.testing.assert_allclose(n1.numpy(), want, atol=1e-2)
    _jax_sine(monkeypatch)
    _same(noise.value_noise(_t(p)), want)


def test_value_noise_continuity(monkeypatch):
    """Quintic-faded lattice interpolation: tiny step -> tiny change."""
    p = np.asarray([[0.4, 1.7, -2.3]], np.float32)
    a = noise.value_noise(_t(p))
    b = noise.value_noise(_t(p) + 1e-4)
    assert abs(float(a[0] - b[0])) < 1e-2
    _jax_sine(monkeypatch)
    _same(noise.value_noise(_t(p)), j_noise.value_noise(jnp.asarray(p)))


def test_fbm_range(monkeypatch):
    p = _points(1, 64, -5, 5)
    f = noise.value_fbm(_t(p))
    assert f.shape == (64,)
    assert float(f.min()) >= 0.0 and float(f.max()) <= 1.0
    _jax_sine(monkeypatch)
    _same(noise.value_fbm(_t(p)), j_noise.value_fbm(jnp.asarray(p)))


# ------------------------------------------------- tessellation, hooks

def test_phong_tessellate_flat_and_curved():
    p1, p2, p3 = _t([1.0, 0.0, 0.0]), _t([0.0, 1.0, 0.0]), _t([0.0, 0.0, 1.0])
    n1, n2, n3 = p1, p2, p3  # sphere normals: position on the unit sphere
    mid0 = phong_tess.phong_tessellate(p1, p2, p3, n1, n2, n3, 0.0,
                                       1 / 3, 1 / 3)
    np.testing.assert_allclose(mid0.numpy(), [1 / 3, 1 / 3, 1 / 3],
                               atol=1e-6)
    mid1 = phong_tess.phong_tessellate(p1, p2, p3, n1, n2, n3, 1.0,
                                       1 / 3, 1 / 3)
    assert float(mid1.norm()) > float(mid0.norm())
    assert float(mid1.norm()) <= 1.0 + 1e-5
    bmin, bmax = phong_tess.tessellated_aabb(p1, p2, p3, n1, n2, n3, 1.0)
    assert (bmin <= mid1 + 1e-6).all() and (bmax >= mid1 - 1e-6).all()
    # batched random patches against the reference
    rng = np.random.default_rng(21)
    ps = [rng.normal(size=(64, 3)).astype(np.float32) for _ in range(3)]
    ns = [(x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)
          for x in (rng.normal(size=(64, 3)) for _ in range(3))]
    u, v = rng.random(64, dtype=np.float32), rng.random(64, dtype=np.float32)
    for alpha in (0.0, 0.75, 1.0):
        _same(phong_tess.phong_tessellate(*map(_t, ps + ns), alpha, _t(u),
                                          _t(v)),
              j_pt.phong_tessellate(*map(jnp.asarray, ps + ns), alpha,
                                    jnp.asarray(u), jnp.asarray(v)))
        for got, want in zip(
                phong_tess.tessellated_aabb(*map(_t, ps + ns), alpha),
                j_pt.tessellated_aabb(*map(jnp.asarray, ps + ns), alpha)):
            _same(got, want)


def test_blinn_ndf_dead_parity():
    """cos theta follows u^(1/(a+1)), so E[cos theta] = (a+1)/(a+2); D
    integrates to 1 over the projected hemisphere."""
    rng = np.random.default_rng(0)
    alpha = 8.0
    u1 = rng.random(20000, dtype=np.float64).astype(np.float32)
    u2 = rng.random(20000, dtype=np.float64).astype(np.float32)
    wh = microfacet.blinn_sample(_t(u1), _t(u2), alpha)
    np.testing.assert_allclose(wh.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert abs(float(wh[:, 2].mean()) - (alpha + 1.0) / (alpha + 2.0)) < 0.01
    _close(wh, j_mf.blinn_sample(jnp.asarray(u1), jnp.asarray(u2), alpha))
    c = np.linspace(0.0, 1.0, 20001).astype(np.float32)
    d = microfacet.blinn_d(_t(c), alpha)
    integral = np.trapezoid(d.numpy() * c * 2.0 * np.pi, c)
    assert abs(integral - 1.0) < 1e-3
    _close(d, j_mf.blinn_d(jnp.asarray(c), alpha))


def test_motion_blur_time_hook():
    u = np.random.default_rng(5).random(64, dtype=np.float32)
    u[:3] = [0.0, 0.5, 1.0]
    t = camera_rays.sample_time(_t(u), 0.2, 0.6)
    np.testing.assert_allclose(t[:3].numpy(), [0.2, 0.4, 0.6], atol=1e-6)
    _same(t, j_cam.sample_time(jnp.asarray(u), 0.2, 0.6))


# --------------------------------------------------------------- sampling

N = 200_000


@pytest.fixture
def uv():
    rng = np.random.default_rng(7)
    return (rng.random(N, dtype=np.float32), rng.random(N, dtype=np.float32))


def test_spherical_cap(uv):
    u1, u2 = uv
    ctm = 0.8
    w = sampling.uniform_spherical_cap(_t(u1), _t(u2), torch.tensor(ctm))
    assert (w[:, 2] >= ctm - 1e-5).all()
    pdf = float(sampling.uniform_spherical_cap_pdf(torch.tensor(ctm)))
    assert abs(1.0 / pdf - 2.0 * np.pi * (1.0 - ctm)) < 1e-5
    valid, iu1, iu2 = sampling.invert_uniform_spherical_cap(
        w, torch.tensor(ctm), _t(u1 * 0))
    assert valid.all()
    np.testing.assert_allclose(iu2.numpy(), u2, atol=1e-4)
    jw = j_smp.uniform_spherical_cap(jnp.asarray(u1), jnp.asarray(u2),
                                     jnp.float32(ctm))
    jvalid, ju1, ju2 = j_smp.invert_uniform_spherical_cap(
        jnp.asarray(w.numpy()), jnp.float32(ctm), jnp.asarray(u1 * 0))
    _close(w, jw)
    _same(valid, jvalid)
    _close(iu1, ju1)
    _same(iu2, ju2)


def test_phong_hemisphere_normalized(uv):
    u1, u2 = uv
    n = 20.0
    w = sampling.phong_hemisphere(_t(u1), _t(u2), torch.tensor(n))
    pdf = sampling.phong_hemisphere_pdf(w, torch.tensor(n))
    wu = sampling.uniform_hemisphere(_t(u1), _t(u2))
    p = sampling.phong_hemisphere_pdf(wu, torch.tensor(n))
    est = float(p.double().mean()) / sampling.uniform_hemisphere_pdf()
    assert abs(est - 1.0) < 0.05  # the pdf integrates to 1
    # cos theta is a pow (its last bit may differ); sin theta = sqrt(1 -
    # cos^2) magnifies that by cos / sin, so x and y are held to 1e-6
    # scaled by 1 + cos / sin
    jw = np.asarray(j_smp.phong_hemisphere(jnp.asarray(u1), jnp.asarray(u2),
                                           jnp.float32(n)))
    _close(w[:, 2], jw[:, 2])
    z = w[:, 2].double().numpy()
    cond = 1.0 + z / np.maximum(np.sqrt(1.0 - z * z), 1e-12)
    assert (np.abs(w[:, :2].numpy() - jw[:, :2])
            <= TOL * cond[:, None]).all()
    _close(pdf, j_smp.phong_hemisphere_pdf(jnp.asarray(w.numpy()),
                                           jnp.float32(n)), tol=1e-5)
    _close(wu, j_smp.uniform_hemisphere(jnp.asarray(u1), jnp.asarray(u2)))
    _close(sampling.invert_phong_hemisphere(w, torch.tensor(n), _t(u1))[1],
           j_smp.invert_phong_hemisphere(jnp.asarray(w.numpy()),
                                         jnp.float32(n), jnp.asarray(u1))[1])


@pytest.mark.parametrize("name", ["uniform_sphere", "uniform_hemisphere",
                                  "cosine_hemisphere"])
def test_invert_roundtrip(uv, name):
    """invert_phi's round trip, and each sampler's inverse against the
    reference's on the port's own directions."""
    u1, u2 = (x[:1000] for x in uv)
    w = getattr(sampling, name)(_t(u1), _t(u2))
    phi = sampling.invert_phi(w, torch.zeros(1000))
    np.testing.assert_allclose(phi.numpy(), u1, atol=1e-4)
    _close(phi, j_smp.invert_phi(jnp.asarray(w.numpy()), jnp.zeros(1000)))
    inv = getattr(sampling, "invert_" + name)(w, _t(u1))
    jinv = getattr(j_smp, "invert_" + name)(jnp.asarray(w.numpy()),
                                            jnp.asarray(u1))
    for got, want in zip(inv, jinv):
        _close(got, want)
