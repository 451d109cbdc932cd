"""Participating media and phase functions: the port's ops/phase.py and
ops/media.py against the JAX package's on the same numpy inputs (within
1e-6 relative), twins of tests/test_phase_media.py's estimator checks,
renders and gradients of medium scenes against the JAX package, and a
volume-boundary material (type 5) render.  (The medium families of
tests/test_oracle.py are tests/test_torch_oracle.py.)

Render parity is held at 1e-5 at <= 4 bounces.  A medium path takes a
continuous decision at every event (scatter or reach the surface), and an
ulp can flip one: the JAX package's jitted render (XLA fuses and contracts
products into FMAs) then differs from its own un-jitted render on that
pixel.  So a pixel may miss the jitted reference only where the reference
run without jit misses it too; the port rounds as the un-jitted reference
does.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import media as j_media
from photorealistic_rendering_using_opencl_tpu.ops import phase as j_phase
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene as j_build
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import media, phase, sampling
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene

torch.set_num_threads(2)

N = 100_000
REL = 1e-6  # op-level parity: relative to the largest magnitude
# The height fog's optical depth (exp(-x) - exp(-x - dx t)) / dx and its
# inverse cancel for small dx t, and equiangular sampling takes the tan of
# an angle near pi/2: both magnify the last bit of exp, log, atan or tan,
# which XLA computes with its own polynomials (and contracts into FMAs).
# Measured: up to 6.5e-5 of an element; held per element at REL_CANCEL,
# plus REL of the largest magnitude (elements near zero):
REL_CANCEL = 1e-4


def _close_cancel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=REL_CANCEL, atol=REL * scale)
FWD = 1e-5  # renders at <= 4 bounces
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PHASES = [("isotropic", 0.0), ("hg", 0.6), ("hg", -0.4), ("rayleigh", 0.0)]


def _u(seed, n=N):
    r = np.random.default_rng(seed)
    return r.random(n, dtype=np.float32), r.random(n, dtype=np.float32)


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# phase functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,g", PHASES)
def test_phase_pdf_normalized(name, g):
    """pdf integrates to 1 over the sphere; eval and pdf are the JAX
    package's on the same directions."""
    u1, u2 = _u(1)
    wo = sampling.uniform_sphere(_t(u1), _t(u2))
    wi = torch.tensor([0.0, 0.0, 1.0]).expand(N, 3)
    ev, pd, _ = phase.get(name)
    p = pd(wi, wo, torch.tensor(g, dtype=torch.float32))
    assert abs(float(p.mean()) * 4.0 * np.pi - 1.0) < 0.02, (name, g)
    jev, jpd, _ = j_phase.get(name)
    jwo, jwi = jnp.asarray(wo.numpy()), jnp.asarray(wi.numpy())
    _close(p, jpd(jwi, jwo, jnp.float32(g)))
    _close(ev(wi, wo, torch.tensor(g, dtype=torch.float32)),
           jev(jwi, jwo, jnp.float32(g)))


@pytest.mark.parametrize("name,g", PHASES)
def test_phase_sample_matches_pdf(name, g):
    """E[(1 + cos) / pdf] = 4 pi, HG's mean cosine is g, the sampled pdf
    is pdf(sampled direction); directions and pdfs are the JAX package's
    on the same variates, for an incoming direction off the axes.
    Rayleigh's inverse CDF, cos = u - 1/u with u a cube root, and then
    sin = sqrt(1 - cos^2) near the poles magnify the last bit of the cube
    root, which XLA computes its own way (within an ulp of torch.pow's):
    its directions are held within 1e-5."""
    u1, u2 = _u(2)
    _, pd, sa = phase.get(name)
    gt = torch.tensor(g, dtype=torch.float32)
    wi = torch.tensor([0.0, 0.0, 1.0]).expand(N, 3)
    w, pdf = sa(wi, _t(u1), _t(u2), gt)
    assert torch.allclose(torch.linalg.vector_norm(w, dim=1),
                          torch.ones(N), atol=1e-4)
    cos = w[:, 2].double()
    est = float(((1.0 + cos) / pdf.double()).mean())
    assert abs(est - 4.0 * np.pi) / (4 * np.pi) < 0.03, (name, g, est)
    if name == "hg":
        assert abs(float(cos.mean()) - g) < 0.01
    torch.testing.assert_close(pd(wi, w, gt), pdf, rtol=1e-3, atol=1e-6)

    wi2 = torch.nn.functional.normalize(torch.tensor([[0.3, -0.5, 0.8]]),
                                        dim=1).expand(N, 3).contiguous()
    w2, pdf2 = sa(wi2, _t(u1), _t(u2), gt)
    _, _, jsa = j_phase.get(name)
    jw, jpdf = jsa(jnp.asarray(wi2.numpy()), jnp.asarray(u1), jnp.asarray(u2),
                   jnp.float32(g))
    _close(w2, jw, rel=1e-5 if name == "rayleigh" else REL)
    _close(pdf2, jpdf)


# ---------------------------------------------------------------------------
# media
# ---------------------------------------------------------------------------

def _medium_inputs(seed, n=4096):
    r = np.random.default_rng(seed)
    o = r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = [[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 1e-13, 1.0],
             [0.0, -1.0, 0.0]]  # dx = 0 and ~0 for the height fog
    max_t = r.uniform(0.01, 6.0, n).astype(np.float32)
    uc = r.random(n, dtype=np.float32)
    ud = r.random(n, dtype=np.float32)
    ud[:2] = [0.0, np.float32(1.0 - 2**-24)]
    return o, d, max_t, uc, ud


SIGMAS = (np.asarray([0.1, 0.2, 0.3], np.float32),
          np.asarray([0.5, 0.4, 0.3], np.float32))


@pytest.mark.parametrize("kind", ["homogeneous", "exponential"])
@pytest.mark.parametrize("absorption_only", [False, True])
def test_sample_distance_matches_reference(kind, absorption_only):
    """Every field of the MediumSample the JAX package's returns, on random
    rays (axis-parallel and dx ~ 0 ones included), and its transmittance."""
    sa, ss = SIGMAS
    if absorption_only:
        ss = np.zeros(3, np.float32)
    st = sa + ss
    o, d, max_t, uc, ud = _medium_inputs(3)
    fn = getattr(media, f"{kind}_sample_distance")
    jfn = getattr(j_media, f"{kind}_sample_distance")
    got = fn(_t(ss), _t(st), absorption_only, _t(o), _t(d), _t(max_t),
             _t(uc), _t(ud))
    want = jfn(jnp.asarray(ss), jnp.asarray(st), absorption_only,
               jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t),
               jnp.asarray(uc), jnp.asarray(ud))
    assert np.array_equal(got.exited.numpy(), np.asarray(want.exited))
    for f in ("t", "weight", "pdf", "p"):
        if kind == "exponential":
            _close_cancel(getattr(got, f), getattr(want, f))
        else:
            _close(getattr(got, f), getattr(want, f))
    if kind == "homogeneous":
        _close(media.homogeneous_transmittance(_t(st), _t(max_t)),
               j_media.homogeneous_transmittance(jnp.asarray(st),
                                                 jnp.asarray(max_t)))
    else:
        _close_cancel(
            media.exponential_transmittance(_t(st), _t(o), _t(d), _t(max_t)),
            j_media.exponential_transmittance(jnp.asarray(st), jnp.asarray(o),
                                              jnp.asarray(d),
                                              jnp.asarray(max_t)))


def test_density_integral_and_inverse_optical_depth_match_reference():
    r = np.random.default_rng(4)
    x = r.uniform(-3, 3, 2048).astype(np.float32)
    dx = r.uniform(-2, 2, 2048).astype(np.float32)
    dx[:64] = 0.0
    dx[64:128] = 1e-13
    t = r.uniform(0, 8, 2048).astype(np.float32)
    sig = r.uniform(0.01, 2.0, 2048).astype(np.float32)
    log_xi = np.log(np.maximum(r.random(2048, dtype=np.float32),
                               1e-12)).astype(np.float32)
    _close_cancel(media._density_integral(_t(x), _t(dx), _t(t)),
                  j_media._density_integral(jnp.asarray(x), jnp.asarray(dx),
                                            jnp.asarray(t)))
    got = media._inverse_optical_depth(_t(x), _t(dx), _t(sig), _t(log_xi))
    want = np.asarray(j_media._inverse_optical_depth(
        jnp.asarray(x), jnp.asarray(dx), jnp.asarray(sig), jnp.asarray(log_xi)))
    inf = want >= 1e30
    assert np.array_equal(got.numpy() >= 1e30, inf)
    _close_cancel(got.numpy()[~inf], want[~inf])


def test_equiangular_sample_matches_reference():
    o, d, t_max, xi, _ = _medium_inputs(5)
    light = np.asarray([0.3, 2.5, -0.4], np.float32)
    got = media.equiangular_sample(_t(o), _t(d), _t(t_max), _t(light), _t(xi))
    want = j_media.equiangular_sample(jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t_max), jnp.asarray(light),
                                      jnp.asarray(xi))
    for a, b in zip(got, want):
        _close_cancel(a, b)


def test_homogeneous_distance_sampling_unbiased():
    """E[weight 1{exit}] = exp(-sigma_t L) and E[weight 1{scatter}] =
    albedo (1 - exp(-sigma_t L))."""
    sa, ss = SIGMAS
    st = sa + ss
    u1, u2 = _u(6)
    o = torch.zeros(N, 3)
    d = torch.tensor([0.0, 0.0, 1.0]).expand(N, 3)
    ms = media.homogeneous_sample_distance(_t(ss), _t(st), False, o, d,
                                           torch.full((N,), 2.0), _t(u1),
                                           _t(u2))
    w = ms.weight.double().numpy()
    ex = ms.exited.numpy()
    ref = np.exp(-st.astype(np.float64) * 2.0)
    assert np.abs((w * ex[:, None]).mean(0) - ref).max() < 0.01
    assert np.abs((w * ~ex[:, None]).mean(0) - ss / st * (1.0 - ref)).max() < 0.01


def test_homogeneous_absorption_only():
    st = torch.full((3,), 0.5)
    ms = media.homogeneous_sample_distance(
        torch.zeros(3), st, True, torch.zeros(8, 3),
        torch.tensor([0.0, 0.0, 1.0]).expand(8, 3), torch.full((8,), 3.0),
        torch.zeros(8), torch.zeros(8))
    assert bool(ms.exited.all())
    assert torch.allclose(ms.weight, torch.full((8, 3), float(np.exp(-1.5))),
                          atol=1e-6)


def test_exponential_medium_transmittance_matches_quadrature():
    o = torch.tensor([[0.0, 1.0, 0.0], [0.0, -0.5, 0.0], [0.0, 0.3, 0.0]])
    dirs = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0]])
    tr = media.exponential_transmittance(torch.full((3,), 0.4), o, dirs,
                                         torch.full((3,), 2.5)).numpy()
    ts = np.linspace(0, 2.5, 20001)
    for i in range(3):
        rho = np.exp(-(o[i, 1].item() + ts * dirs[i, 1].item()))
        assert abs(tr[i, 0] - np.exp(-0.4 * np.trapezoid(rho, ts))) < 1e-3


def test_exponential_distance_sampling_unbiased():
    st = torch.full((3,), 0.5)
    ss = torch.full((3,), 0.4)
    u1, u2 = _u(7)
    o = torch.tensor([0.0, 0.5, 0.0]).expand(N, 3)
    d = torch.tensor([0.0, -0.6, 0.8]).expand(N, 3)
    ms = media.exponential_sample_distance(ss, st, False, o, d,
                                           torch.full((N,), 3.0), _t(u1),
                                           _t(u2))
    tr = media.exponential_transmittance(st, o[:1], d[:1],
                                         torch.full((1,), 3.0))[0]
    est = (ms.weight.double() * ms.exited[:, None]).mean(0)
    assert float((est - tr.double()).abs().max()) < 0.02


# ---------------------------------------------------------------------------
# renders and gradients against the JAX package
# ---------------------------------------------------------------------------

def _doc(path, bounces=None, medium=None, mat5=False):
    with open(path) as fh:
        doc = json.load(fh)
    if bounces is not None:
        doc["settings"]["MAX_BOUNCES"] = bounces
    if medium is not None:
        doc["global_medium"] = medium
    if mat5:
        doc["scene"]["spheres"].append(
            {"pos": [0.0, 0.6, 0.0], "radius": 0.45,
             "material": {"color": [0.8, 0.8, 0.8], "type": 5}})
    return doc


def _jax_render(jcfg, jsc, w, spp, seed, method, jit=True):
    cam = j_default_camera(w, w).pytree()
    if jit:
        return np.asarray(j_pt.render(jcfg, jsc, cam, w, w, spp, seed=seed,
                                      method=method)[0])
    with jax.disable_jit():
        return np.asarray(j_pt.render(jcfg, jsc, cam, w, w, spp, seed=seed,
                                      method=method)[0])


def hold_render(doc, w=8, spp=2, seed=3, method="while", phase_function=
                "isotropic", bound=FWD):
    """The port's render of ``doc`` against the JAX package's, pixels
    beyond ``bound`` allowed only where the un-jitted reference parts from
    the jitted one too; returns (port image, pixels beyond)."""
    jcfg, jsc = j_build(doc, phase_function=phase_function)
    cfg, sc = build_scene(doc, phase_function=phase_function, device="cpu")
    with torch.no_grad():
        img, _ = pathtracer.render(cfg, sc, default_camera(w, w).pytree("cpu"),
                                   w, w, spp, seed=seed, method=method)
    img = img.numpy()
    want = _jax_render(jcfg, jsc, w, spp, seed, method)
    assert img.shape == want.shape and np.isfinite(img).all()

    def beyond(a, b):
        return (np.abs(a - b) > bound + bound * np.abs(b)).any(-1)

    out = beyond(img, want)
    if out.any():
        ref_parts = beyond(_jax_render(jcfg, jsc, w, spp, seed, method,
                                       jit=False), want)
        assert not (out & ~ref_parts).any(), (
            f"{int((out & ~ref_parts).sum())} pixels beyond {bound} where "
            "the un-jitted reference agrees with the jitted one")
    return img, int(out.sum())


MEDIA = {
    "homogeneous": None,  # cornell_media.json's own
    "exponential": {"type": "exponential", "density": 0.4, "sigmaA": 0.1,
                    "sigmaS": 0.6},
    "absorbing": {"density": 0.5, "sigmaA": 0.3, "sigmaS": 0.0},
}


@pytest.mark.parametrize("phase_function", ["isotropic", "hg", "rayleigh"])
@pytest.mark.parametrize("medium", sorted(MEDIA))
def test_medium_render_matches_reference(medium, phase_function):
    """cornell_media.json at 3 bounces (its 64 scatter events capped at
    the loops' 16), by every phase function and medium type."""
    img, _ = hold_render(_doc("scenes/cornell_media.json", 3, MEDIA[medium]),
                         phase_function=phase_function)
    assert img.mean() > 0


@pytest.mark.parametrize("method", ["scan", "regen"])
def test_medium_render_methods_match_reference(method):
    hold_render(_doc("scenes/cornell_media.json", 2), method=method,
                phase_function="hg")


def test_volume_boundary_material_matches_reference():
    """A type-5 (VOL) sphere in a medium: the JAX package has no BSDF
    family for it, so a path that reaches it ends there and it takes no
    light; the port does the same."""
    doc = _doc("scenes/cornell_media.json", 3, mat5=True)
    jcfg, _ = j_build(doc)
    assert jcfg.active_mats & (1 << 5)
    img, _ = hold_render(doc)
    doc_diff = _doc("scenes/cornell_media.json", 3)
    doc_diff["scene"]["spheres"].append(
        {"pos": [0.0, 0.6, 0.0], "radius": 0.45,
         "material": {"color": [0.8, 0.8, 0.8], "type": 1}})
    diffuse, _ = hold_render(doc_diff)
    assert img.mean() < diffuse.mean()  # it reflects nothing


def _mean_grads(doc, leaves, w=8, spp=2, seed=3, phase_function="hg"):
    jcfg, jsc = j_build(doc, phase_function=phase_function)
    cfg, sc = build_scene(doc, phase_function=phase_function, device="cpu")
    params = {k: getattr(sc, k).clone().requires_grad_() for k in leaves}
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, **params),
                               default_camera(w, w).pytree("cpu"), w, w, spp,
                               seed=seed)
    got = torch.autograd.grad(img.mean(), list(params.values()),
                              allow_unused=True)

    def f(p):
        return j_pt.render(jcfg, dataclasses.replace(jsc, **p),
                           j_default_camera(w, w).pytree(), w, w, spp,
                           seed=seed)[0].mean()

    want = jax.jit(jax.grad(f))({k: getattr(jsc, k) for k in leaves})
    return {k: (torch.zeros_like(params[k]) if g is None else g,
                np.asarray(want[k])) for k, g in zip(leaves, got)}


@pytest.mark.parametrize("medium", ["homogeneous", "exponential"])
def test_medium_gradients_match_reference(medium):
    """d mean(image) / d leaves through the default method at 2 bounces and
    2 scatter events.  sigma_s and the colours are held within rtol 1e-4 /
    atol 1e-6 of JAX.  sigma_t and the HG anisotropy are held to central
    differences (eps 1e-4, the same random stream, within 1e-3): there the
    JAX package's gradient is wrong (NaN for phase_g and for the height
    fog's sigma_t; its first channel for the homogeneous medium, -0.51
    against finite differences' -0.29 here; ROADMAP F12)."""
    from photorealistic_rendering_using_opencl_tpu_torch.diff import fd
    doc = _doc("scenes/cornell_media.json", 2, MEDIA[medium])
    doc["settings"]["MAX_SCATTERING_EVENTS"] = 2
    grads = _mean_grads(doc, ("medium_sigma_s", "medium_sigma_t", "phase_g",
                              "color"))
    for k in ("medium_sigma_s", "color"):
        got, want = grads[k]
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)
        assert np.abs(want).max() > 1e-4, k

    cfg, sc = build_scene(doc, phase_function="hg", device="cpu")
    cam = default_camera(8, 8).pytree("cpu")

    def f(p):
        return pathtracer.render(cfg, dataclasses.replace(sc, **p), cam, 8, 8,
                                 2, seed=3, method="while")[0].double().mean()

    for k in ("medium_sigma_t", "phase_g"):
        want = fd.fd_gradient(f, {k: getattr(sc, k)}, eps=1e-4)[k].numpy()
        got = grads[k][0].numpy()
        assert np.isfinite(got).all(), k
        assert np.abs(got - want).max() < 1e-3, (k, got, want)
        assert np.abs(want).max() > 1e-2, k


def test_medium_sigma_grad_vs_fd():
    """Absorption-only medium: d mean(image) / d sigma_a against central
    differences (twin of tests/test_grad.py's), < 1e-3."""
    from photorealistic_rendering_using_opencl_tpu_torch.diff import fd
    doc = _doc("scenes/cornell_simple.json", 2,
               {"density": 0.5, "sigmaA": 0.3, "sigmaS": 0.0})
    cfg, sc = build_scene(doc, device="cpu")
    assert cfg.medium_absorption_only
    cam = default_camera(8, 8).pytree("cpu")

    def f(sig_a):
        s = dataclasses.replace(sc, medium_sigma_a=sig_a,
                                medium_sigma_t=sig_a + sc.medium_sigma_s)
        return pathtracer.render(cfg, s, cam, 8, 8, 2, seed=1)[0].mean()

    rep = fd.check_gradients(f, sc.medium_sigma_a, eps=1e-3)
    assert float(rep.ad.abs().max()) > 1e-4
    assert rep.max_abs_err < 1e-3, rep.max_abs_err


def test_regen_bound_covers_medium_paths():
    """A dense medium with a large scatter budget: a regenerated path can
    take (max_bounces + 1) x (max_scattering_events + 1) events, past the
    reference's loop bound of spp x n_steps + 64, where the JAX package's
    trace_regen stops with the frame unfinished (ROADMAP F13).  The port's
    bound is the longest path: it finishes every lane."""
    doc = _doc("scenes/cornell_simple.json", 1,
               {"density": 1.0, "sigmaA": 0.0, "sigmaS": 4.0})
    doc["settings"]["MAX_SCATTERING_EVENTS"] = 200
    cfg, sc = build_scene(doc, device="cpu")
    jcfg, jsc = j_build(doc)
    w, spp = 4, 1
    bound = spp * integrator.n_steps_for(cfg) + 64
    assert pathtracer.max_path_events(cfg) == 2 * 201
    px, py = pathtracer.pixel_grid(w, w, "cpu")
    with torch.no_grad():
        acc, _, it = pathtracer.trace_regen(cfg, sc, default_camera(w, w).pytree(
            "cpu"), w, w, spp, px, py, 0, return_iters=True)
    assert it > bound and bool(torch.isfinite(acc).all())
    jpx, jpy = j_pt.pixel_grid(w, w)
    _, _, jit = j_pt.trace_regen(jcfg, jsc, j_default_camera(w, w).pytree(), w,
                                 w, spp, jpx, jpy, 0, return_iters=True)
    assert int(jit) == bound  # the reference stops there, unfinished
