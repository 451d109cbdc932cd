"""The reference's default bounce loops in the port: ``intersect_scene``,
``shadow_visible``, ``bounce_step``, ``integrator.trace`` (``scan`` and
``while``) and ``render``'s default method, against the JAX package.

Bounds are tests/test_regen_aov.py's: 1e-5 at <= 4 bounces and 5e-4 at the
32-bounce budget; gradients rtol 1e-4 / atol 1e-6 at <= 4 bounces, the
bounds of the reference's test_regen_scan_grad_matches_scan.  The scenes'
only spheres are lights, so no sphere-normal gradient (ROADMAP F2) enters.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import integrator as j_int
from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import intersect as j_isect
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.ops.rng import Sampler as JSampler
from photorealistic_rendering_using_opencl_tpu.scene.loader import (
    build_scene as j_build, load_scene as j_load,
)
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import pytree_from_numpy
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

SEED = 3
ICOSPHERE = dict(subdiv=1, radius=0.8, center=(0.0, 1.0, 0.0))
# tests/test_grad.py's scene: a light sphere over a floor and a red wall
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


def _jax_scene(name, bounces=None):
    if name == "cornell_dict":
        jcfg, jsc = j_build(CORNELL)
    elif name == "cornell_simple":
        jcfg, jsc = j_load("scenes/cornell_simple.json")
    else:  # cornell.json with an icosphere: the COAT mesh, K1's twin
        jcfg, jsc = j_load("scenes/cornell.json",
                           mesh_override=make_icosphere(**ICOSPHERE))
    if bounces is not None:
        jcfg = dataclasses.replace(jcfg, max_bounces=bounces)
    return jcfg, jsc


def _to_port(jcfg, jsc, jcam=None):
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    if jcam is None:
        return cfg, sc
    cam = pytree_from_numpy({k: np.asarray(v) for k, v in jcam.items()}, "cpu")
    return cfg, sc, cam


def _np(x):
    a = x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.int64) if a.dtype == np.uint32 else a


def _assert_tree(got, want, tol, what):
    for f in want._fields:
        w, g = getattr(want, f), getattr(got, f)
        if w is None:
            assert g is None, (what, f)
            continue
        w, g = _np(w), _np(g)
        assert g.shape == w.shape, (what, f)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f}")
        else:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                       err_msg=f"{what}.{f}")


def _rays(jsc, n, seed):
    """Rays from random points of the scene's box in random directions,
    with random shadow lengths and activity."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-1.9, 0.1, -1.9], [1.9, 3.9, 1.9], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.05, 4.0, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.2
    return o, d, dist, active


@pytest.mark.parametrize("name", ["cornell_simple", "icosphere_coat"])
def test_intersect_scene_and_shadow_visible(name):
    jcfg, jsc = _jax_scene(name)
    cfg, sc = _to_port(jcfg, jsc)
    o, d, dist, active = _rays(jsc, 600, 11)
    want = j_isect.intersect_scene(jcfg, jsc, jnp.asarray(o), jnp.asarray(d),
                                   active=jnp.asarray(active))
    got = intersect.intersect_scene(cfg, sc, torch.from_numpy(o),
                                    torch.from_numpy(d),
                                    active=torch.from_numpy(active))
    for f in ("mesh_id", "backside", "tri"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      _np(getattr(want, f)), err_msg=f)
    for f in ("t", "normal", "pos"):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    assert (_np(got.mesh_id) >= 0).mean() > 0.5
    if jcfg.has_mesh:
        assert (_np(got.tri) >= 0).sum() > 20

    # shadow rays, some leaving the mesh surface with their triangle excluded
    excl = np.where(_np(want.tri) >= 0, _np(want.tri), -1).astype(np.int32)
    so = np.array(want.pos)
    vis_j = j_isect.shadow_visible(jcfg, jsc, jnp.asarray(so), jnp.asarray(d[::-1]),
                                   jnp.asarray(dist), active=jnp.asarray(active),
                                   exclude_tri=jnp.asarray(excl))
    vis_t = intersect.shadow_visible(cfg, sc, torch.from_numpy(so),
                                     torch.from_numpy(d[::-1].copy()),
                                     torch.from_numpy(dist),
                                     active=torch.from_numpy(active),
                                     exclude_tri=torch.from_numpy(excl))
    np.testing.assert_array_equal(_np(vis_t), _np(vis_j))
    assert 0.05 < _np(vis_t).mean() < 0.95

    # the merged dispatch in one piece: closest hits of the original rays
    # and the shadow batch above
    hit_j, [mvis_j] = j_isect.intersect_and_shadow(
        jcfg, jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(active),
        [(jnp.asarray(so), jnp.asarray(d[::-1]), jnp.asarray(dist),
          jnp.asarray(active))], exclude_tri=jnp.asarray(excl))
    hit_t, [mvis_t] = intersect.intersect_and_shadow(
        cfg, sc, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(active),
        [(torch.from_numpy(so), torch.from_numpy(d[::-1].copy()),
          torch.from_numpy(dist), torch.from_numpy(active))],
        exclude_tri=torch.from_numpy(excl))
    np.testing.assert_array_equal(_np(mvis_t), _np(mvis_j))
    np.testing.assert_array_equal(_np(hit_t.tri), _np(hit_j.tri))
    np.testing.assert_array_equal(_np(hit_t.mesh_id), _np(hit_j.mesh_id))
    np.testing.assert_allclose(_np(hit_t.t), _np(hit_j.t), rtol=1e-6,
                               atol=1e-6)


def test_bounce_step_matches_reference():
    """One bounce_step from camera rays (JAX's own bounce_step: it has no
    previous-bounce self-exclusion, so trace is not its yardstick)."""
    w = 16
    jcfg, jsc = _jax_scene("icosphere_coat")
    jcam = j_default_camera(w, w).pytree()
    cfg, sc, cam = _to_port(jcfg, jsc, jcam)
    px, py = j_pt.pixel_grid(w, w)
    pix = py.astype(jnp.uint32) * w + px.astype(jnp.uint32)
    smp = jnp.full(pix.shape, 1, jnp.uint32)
    o, d = j_pt.camera_rays_for_sample(jcam, w, w, px, py, pix, smp, SEED)
    want = j_int.bounce_step(jcfg, jsc, j_int.init_state(o, d),
                             JSampler(pix, smp, seed=SEED, dim=8), 0)
    state = integrator.init_state(torch.from_numpy(np.array(o)),
                                  torch.from_numpy(np.array(d)))
    tpix = torch.from_numpy(np.asarray(pix).astype(np.int64))
    got = integrator.bounce_step(cfg, sc, state,
                                 Sampler(tpix, 1, seed=SEED, dim=8), 0)
    _assert_tree(got, want, 1e-5, "bounce_step")
    assert _np(got.acc).max() > 0 and 0 < _np(got.alive).mean() < 1


# (scene, bounce cap or None for the file's 32, size, spp, tolerance)
TRACE_CASES = {
    "cornell_simple_4": ("cornell_simple", None, 16, 2, 1e-5),
    "icosphere_coat_4": ("icosphere_coat", 4, 16, 2, 1e-5),
    # 12 steps: the reference pads its nested scan to 16, the port does not
    "icosphere_coat_12": ("icosphere_coat", 12, 16, 2, 5e-4),
    "icosphere_coat_32": ("icosphere_coat", None, 16, 2, 5e-4),
}


@functools.cache
def _trace_results(case):
    name, bounces, w, spp, _ = TRACE_CASES[case]
    jcfg, jsc = _jax_scene(name, bounces)
    jcam = j_default_camera(w, w).pytree()
    cfg, sc, cam = _to_port(jcfg, jsc, jcam)
    want, want_a = j_pt.render(jcfg, jsc, jcam, w, w, spp, seed=SEED)
    out = dict(want=np.asarray(want), want_a=np.asarray(want_a))
    for method in ("scan", "while", "regen"):
        img, alpha = pathtracer.render(cfg, sc, cam, w, w, spp, seed=SEED,
                                       method=method)
        out[method] = (img, alpha)
    return out


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_matches_reference(case):
    r = _trace_results(case)
    tol = TRACE_CASES[case][-1]
    for method in ("scan", "while"):
        img, alpha = r[method]
        assert torch.isfinite(img).all()
        np.testing.assert_allclose(img.numpy(), r["want"], rtol=tol, atol=tol,
                                   err_msg=method)
        np.testing.assert_allclose(alpha.numpy(), r["want_a"], rtol=tol,
                                   atol=tol, err_msg=method)
    # while only skips bounces in which no lane is alive: the same image
    assert torch.equal(r["scan"][0], r["while"][0])
    assert r["want"].mean() > 0.01


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_scan_matches_regen(case):
    """The counter-keyed RNG makes the two loops the same estimator; they
    differ only in the order each pixel's samples are summed."""
    r = _trace_results(case)
    np.testing.assert_allclose(r["scan"][0].numpy(), r["regen"][0].numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(r["scan"][1].numpy(), r["regen"][1].numpy(),
                               rtol=1e-5, atol=1e-6)


GRAD_CASES = {"cornell_dict": ("cornell_dict", None, 8, 4),
              "icosphere_coat_4": ("icosphere_coat", 4, 8, 2)}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_scan_grad_matches_reference(case):
    name, bounces, w, spp = GRAD_CASES[case]
    jcfg, jsc = _jax_scene(name, bounces)
    jcam = j_default_camera(w, w).pytree()
    cfg, sc, cam = _to_port(jcfg, jsc, jcam)
    names = [f.name for f in dataclasses.fields(sc)
             if getattr(sc, f.name).is_floating_point()]

    def j_loss(p, c):
        img, _ = j_pt.render(jcfg, dataclasses.replace(jsc, **p), c, w, w,
                             spp, seed=SEED)
        return jnp.mean(img), img

    (_, j_img), (j_gs, j_gc) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
            {k: getattr(jsc, k) for k in names}, jcam)
    p = {k: getattr(sc, k).clone().requires_grad_() for k in names}
    c = {k: v.clone().requires_grad_() for k, v in cam.items()}
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, **p), c, w, w,
                               spp, seed=SEED)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(j_img),
                               rtol=1e-5, atol=1e-5)
    grads = torch.autograd.grad(img.mean(), [*p.values(), *c.values()],
                                allow_unused=True)
    want = [np.asarray(j_gs[k]) for k in names] + [np.asarray(j_gc[k])
                                                   for k in c]
    keys = [f"scene.{k}" for k in names] + [f"camera.{k}" for k in c]
    nonzero = 0
    for key, g, x, jv in zip(keys, grads, [*p.values(), *c.values()], want):
        got = (torch.zeros_like(x) if g is None else g).numpy()
        assert got.shape == jv.shape and np.isfinite(got).all(), key
        np.testing.assert_allclose(got, jv, rtol=1e-4, atol=1e-6, err_msg=key)
        nonzero += bool(np.abs(jv).max(initial=0.0) > 0)
    assert nonzero >= 8
    for key in ("scene.color", "camera.position"):
        assert np.abs(grads[keys.index(key)].numpy()).max() > 1e-4, key


def test_trace_launches_the_mesh_search_once_per_dispatch(monkeypatch):
    """K1's twin runs spp * (n_steps + 1) times in the forward (one camera
    dispatch, then one merged dispatch per bounce; none for the reference's
    padded bounces) and never in the backward: each bounce's checkpoint
    boundary is the detached dispatch."""
    w, spp = 4, 2
    jcfg, jsc = _jax_scene("icosphere_coat", 3)
    cfg, sc, cam = _to_port(jcfg, jsc, j_default_camera(w, w).pytree())
    calls = []
    real = mesh_brute._intersect_xla

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mesh_brute, "_intersect_xla", counting)
    color = sc.color.clone().requires_grad_()
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, color=color), cam,
                               w, w, spp, seed=SEED)
    assert len(calls) == spp * (integrator.n_steps_for(cfg) + 1) == 8
    img.mean().backward()
    assert len(calls) == 8
    assert torch.isfinite(color.grad).all() and color.grad.abs().max() > 0
    calls.clear()
    pathtracer.render(cfg, sc, cam, w, w, spp, seed=SEED, method="while")
    assert 0 < len(calls) <= 8


def test_trace_refuses_other_methods():
    cfg, sc = _to_port(*_jax_scene("cornell_simple"))
    o = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="unknown method"):
        integrator.trace(cfg, sc, o, o, torch.zeros(2, dtype=torch.int64), 0,
                         method="regen")
