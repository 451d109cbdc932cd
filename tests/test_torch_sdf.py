"""SDFs and boxes (ROADMAP M10): the port's box_hits, sd_primitive,
sdf_map, sdf_march, sdf_normal, the SDF and box reattachment and SDF-scene
renders against the JAX package on the same numpy inputs, the twins of
tests/test_intersect.py's box and sphere-tracing checks, and the
reattached distance's gradient against finite differences.

An SDF's normal is a central difference at 2e-5, which turns a last-bit
difference of a distance into ~1e-3 of the normal.  The JAX package's
jitted code has XLA contract products into FMAs, so its jitted normals
differ from its own un-jitted ones by that much (and renders by ~3e-4 at
one bounce).  The port's SDF arithmetic rounds as the un-jitted reference
does (sums in the reference's order, a correctly rounded sqrt), bitwise on
the CPU and on the card; so the SDF values are held bitwise, and normals
and SDF-scene renders within 1e-5 of the JAX package run without jit, on
the same rays.  The hit distance is well conditioned and is also held to
the jitted reference.

The JAX package's gradients with respect to the SDF tables are NaN on any
scene where a lane evaluates the box formula at a point of its core
(its sqrt at 0; ROADMAP F12), the box floor of sdf_demo.json included.
The port's 2-norm has a zero derivative there and keeps the value; its
gradients are held to the JAX package on lanes where the reference's are
finite, and the reattached distance to finite differences.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import intersect as j_int
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import build_scene as j_build
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SDF, SDF_BOX, SDF_CYLINDER, SDF_PLANE, SDF_ROUND_BOX, SDF_SPHERE,
    SDF_TORUS,
)

torch.set_num_threads(2)

REL = 1e-6
FWD = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
NORMAL_GRAD_RTOL = 3e-3
TYPES = {"sphere": SDF_SPHERE, "box": SDF_BOX, "round_box": SDF_ROUND_BOX,
         "plane": SDF_PLANE, "cylinder": SDF_CYLINDER, "torus": SDF_TORUS}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    scale = max(float(np.abs(want[np.isfinite(want)]).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _sdf_doc():
    with open("scenes/sdf_demo.json") as fh:
        return json.load(fh)


def _rays(n, seed, scale=2.5):
    r = np.random.default_rng(seed)
    o = r.uniform(-scale, scale, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.5
    tgt = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    tgt[:, 1] = r.uniform(0.0, 1.2, n)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def test_box_hit_normal_and_backside():
    """Twin of tests/test_intersect.py's: entry face from outside, the exit
    face and backside from inside."""
    o = torch.tensor([[0.0, 0.0, -5.0], [0.0, 0.0, 0.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]] * 2)
    t, n, back = intersect.box_hits(o, d, torch.zeros(1, 3), torch.ones(1, 3))
    assert abs(float(t[0, 0]) - 4.0) < 1e-5
    assert torch.allclose(n[0, 0], torch.tensor([0.0, 0.0, -1.0]), atol=1e-6)
    assert not back[0, 0]
    assert abs(float(t[1, 0]) - 1.0) < 1e-5 and back[1, 0]


def test_box_hits_match_reference():
    """Random rays (axis-parallel and ~0 direction components included)
    against three boxes: t, normal and backside bitwise."""
    o, d = _rays(4000, 1)
    d[:4] = [[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 1e-13, 1.0],
             [-1e-13, 0.0, -1.0]]
    c = np.asarray([[0.0, -0.1, 0.0], [1.0, 0.5, 0.3], [-0.7, 0.2, -0.9]],
                   np.float32)
    h = np.asarray([[3.0, 0.1, 3.0], [0.3, 0.5, 0.2], [0.4, 0.4, 0.4]],
                   np.float32)
    got = intersect.box_hits(_t(o), _t(d), _t(c), _t(h))
    want = j_int.box_hits(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c),
                          jnp.asarray(h))
    for a, b in zip(got, want):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert np.isfinite(got[0].numpy()).mean() > 0.2


@pytest.mark.parametrize("kind", sorted(TYPES))
def test_sd_primitive_matches_reference(kind):
    """Every SDF type: bitwise the un-jitted reference, within 1e-6 of the
    jitted one (its FMAs), on points around the surface."""
    r = np.random.default_rng(2)
    n = 20000
    p = r.normal(size=(n, 3)).astype(np.float32)
    prm = r.uniform(0.1, 1.0, (n, 4)).astype(np.float32)
    gt = np.full(n, SDF | TYPES[kind], np.int32)
    got = intersect.sd_primitive(_t(gt), _t(p), _t(prm)).numpy()
    with jax.disable_jit():
        eager = np.asarray(j_int.sd_primitive(jnp.asarray(gt), jnp.asarray(p),
                                              jnp.asarray(prm)))
    assert got.tobytes() == eager.tobytes()
    jit = np.asarray(jax.jit(j_int.sd_primitive)(
        jnp.asarray(gt), jnp.asarray(p), jnp.asarray(prm)))
    _close(got, jit)


def _sdf_objects():
    doc = _sdf_doc()
    jcfg, jsc = j_build(doc)
    d0, d1 = jcfg.n_spheres, jcfg.n_spheres + jcfg.n_sdfs
    c = np.asarray(jsc.position)[d0:d1]
    gt = np.asarray(jsc.geom_type)[d0:d1]
    prm = np.asarray(jsc.params)[d0:d1]
    return c, gt, prm


def test_sdf_sphere_march_matches_analytic():
    """Twin of tests/test_intersect.py's: parallel rays at an SDF sphere hit
    at the analytic distance within 5e-3."""
    n = 64
    rng = np.random.default_rng(0)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -5.0
    o[:, 0] = rng.uniform(-2, 2, n)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = 1.0
    t, obj, hit = intersect.sdf_march(
        _t(o), _t(d), torch.full((n,), 20.0), torch.zeros(1, 3),
        torch.tensor([SDF | SDF_SPHERE], dtype=torch.int32),
        torch.tensor([[1.0, 0, 0, 0]]), steps=128)
    should = np.abs(o[:, 0]) < 0.97
    assert hit.numpy()[should].all()
    exact = 5.0 - np.sqrt(np.maximum(1.0 - o[:, 0] ** 2, 1e-9))
    assert np.abs(t.numpy()[should] - exact[should]).max() < 5e-3


@pytest.mark.parametrize("early_exit", [False, True])
def test_sdf_march_and_normal_match_reference(early_exit):
    """sdf_demo's three SDFs, random rays with some inactive: t, the object
    and the hit flag bitwise the un-jitted reference's (the full budget and
    the early exit alike), t within 1e-6 of the jitted one; sdf_normal at
    the hits within 1e-6 of the un-jitted reference's."""
    c, gt, prm = _sdf_objects()
    o, d = _rays(3000, 3)
    active = np.random.default_rng(4).uniform(size=3000) < 0.9
    limit = np.full(3000, 20.0, np.float32)
    before = intersect.sdf_march.steps
    got = intersect.sdf_march(_t(o), _t(d), _t(limit), _t(c), _t(gt), _t(prm),
                              128, active=_t(active), early_exit=early_exit)
    steps = intersect.sdf_march.steps - before
    assert steps <= 128 if early_exit else steps == 128
    args = (jnp.asarray(o), jnp.asarray(d), jnp.asarray(limit),
            jnp.asarray(c), jnp.asarray(gt), jnp.asarray(prm), 128)
    with jax.disable_jit():
        eager = j_int.sdf_march(*args, active=jnp.asarray(active))
        pos = jnp.asarray(o) + jnp.asarray(d) * eager[0][:, None]
        n_eager = j_int.sdf_normal(pos, jnp.asarray(c), jnp.asarray(gt),
                                   jnp.asarray(prm), eager[1])
    for a, b in zip(got, eager):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    jit = jax.jit(j_int.sdf_march, static_argnums=6)(
        *args, active=jnp.asarray(active))
    hit = got[2].numpy() & active
    # hits only (a miss's t is wherever its last step left it); up to 128
    # steps each round their sum another way under jit (measured 1.1e-5)
    np.testing.assert_allclose(got[0].numpy()[hit], np.asarray(jit[0])[hit],
                               rtol=1e-4, atol=0)
    assert hit.mean() > 0.3 and (~got[2].numpy()).any()
    pos_t = _t(o) + _t(d) * got[0][:, None]
    n_t = intersect.sdf_normal(pos_t, _t(c), _t(gt), _t(prm), got[1])
    _close(n_t.numpy()[hit], np.asarray(n_eager)[hit])
    if early_exit:  # a short limit: every lane is done long before 128
        before = intersect.sdf_march.steps
        short = intersect.sdf_march(_t(o), _t(d), torch.full((3000,), 0.5),
                                    _t(c), _t(gt), _t(prm), 128,
                                    early_exit=True)
        assert intersect.sdf_march.steps - before < 128
        full = intersect.sdf_march(_t(o), _t(d), torch.full((3000,), 0.5),
                                   _t(c), _t(gt), _t(prm), 128)
        for a, b in zip(short, full):
            assert torch.equal(a, b)


def _reattach_lanes(sdf_only):
    """sdf_demo's camera rays at 24^2 (through the port), their detached
    closest hits, and the lanes whose winner is an SDF or the box; with
    ``sdf_only``, the SDF sphere's and the round box's (the SDF box's
    central differences sample its core, where the reference's gradient is
    NaN)."""
    doc = _sdf_doc()
    cfg, sc = build_scene(doc, device="cpu")
    jcfg, jsc = j_build(doc)
    w = 24
    px, py = pathtracer.pixel_grid(w, w, "cpu")
    o, d = pathtracer.camera_rays_for_sample(
        default_camera(w, w).pytree("cpu"), w, w, px, py, py * w + px, 0, 0,
        jitter=False)
    t, mid, nrm = intersect._closest_analytic(cfg, sc, o, d)
    gt = sc.geom_type[mid.clamp(min=0).long()]
    keep = (mid >= 0) & (((gt & (SDF_SPHERE | SDF_ROUND_BOX)) != 0)
                         if sdf_only
                         else ((gt & SDF) != 0) | (mid == cfg.n_spheres
                                                   + cfg.n_sdfs))
    idx = torch.nonzero(keep).flatten()
    return cfg, sc, jcfg, jsc, o[idx], d[idx], t[idx], mid[idx], nrm[idx]


def test_reattach_of_sdf_and_box_hits_matches_reference():
    """analytic_reattach at SDF and box hits: the primal bitwise the
    detached hit; on the SDF sphere's and round box's lanes (where the
    reference's gradients are finite) d(sum t) / d(params, position) within
    rtol 1e-4 / atol 1e-6 of the jitted reference, and the normal's within
    rtol NORMAL_GRAD_RTOL of the un-jitted one: the normal is a central
    difference over 2e-5, so its derivative is too, and the last bit of a
    distance's derivative (the port's sqrt runs in float64 and rounds once,
    the reference's backward in float32) is ~3e-3 of it (measured: 4.7e-4
    of the largest entry)."""
    cfg, sc, jcfg, jsc, o, d, t, mid, nrm = _reattach_lanes(sdf_only=False)
    t_re, n_re = intersect.analytic_reattach(cfg, sc, o, d, t, mid, nrm)
    assert torch.equal(t_re, t) and torch.equal(n_re, nrm)
    assert ((sc.geom_type[mid.long()] & SDF) == 0).any()  # the box floor

    cfg, sc, jcfg, jsc, o, d, t, mid, nrm = _reattach_lanes(sdf_only=True)
    leaves = ("params", "position")
    params = {k: getattr(sc, k).clone().requires_grad_() for k in leaves}
    t_re, n_re = intersect.analytic_reattach(
        cfg, dataclasses.replace(sc, **params), o, d, t, mid, nrm)
    got_t = torch.autograd.grad(t_re.sum(), list(params.values()),
                                retain_graph=True)
    got_n = torch.autograd.grad((n_re * torch.tensor([0.3, -0.5, 0.8])).sum(),
                                list(params.values()))
    jo, jd = jnp.asarray(o.numpy()), jnp.asarray(d.numpy())
    jt, jm, jn = (jnp.asarray(x.numpy()) for x in (t, mid, nrm))

    def f(p, which):
        tr, nr = j_int.analytic_reattach(jcfg, dataclasses.replace(jsc, **p),
                                         jo, jd, jt, jm, jn)
        return (jnp.sum(tr) if which == "t"
                else jnp.sum(nr * jnp.asarray([0.3, -0.5, 0.8])))

    p0 = {k: getattr(jsc, k) for k in leaves}
    want_t = jax.jit(jax.grad(f), static_argnums=1)(p0, "t")
    with jax.disable_jit():  # the normal's central differences: un-jitted
        want_n = jax.grad(f)(p0, "n")
    for k, gt_, gn in zip(leaves, got_t, got_n):
        for got, want, rtol in ((gt_, want_t[k], GRAD_RTOL),
                                (gn, want_n[k], NORMAL_GRAD_RTOL)):
            want = np.asarray(want)
            assert np.isfinite(want).all(), k
            np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                       atol=GRAD_ATOL, err_msg=k)
        assert float(gt_.abs().max()) > 0.1, k


@pytest.mark.parametrize("kind,radius_slot", [("sphere", 0), ("box", 2),
                                              ("round_box", 3), ("torus", 1)])
def test_reattached_distance_gradient_vs_fd(kind, radius_slot):
    """d t / d (a size parameter, the position) of one SDF hit by parallel
    rays, reattached, against central differences of the marched distance
    (eps 1e-3, within 1e-3): the implicit-function derivative, exact to
    first order."""
    base = {"sphere": [0.8, 0, 0, 0], "box": [0.5, 0.6, 0.4, 0],
            "round_box": [0.4, 0.4, 0.4, 0.1], "torus": [0.7, 0.25, 0, 0]}[kind]
    doc = {"settings": {"MAX_BOUNCES": 1, "MARCHING_STEPS": 256},
           "scene": {"sdfs": [{"type": int(np.log2(TYPES[kind])),
                               "pos": [0.1, 0.2, 0.0], "params": base}]}}
    cfg, sc = build_scene(doc, device="cpu")
    o = torch.tensor([[0.15, 0.25, -3.0], [0.05, 0.3, -3.0],
                      [0.3, 0.1, -3.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]]).expand(3, 3).contiguous()
    if kind == "torus":  # seen from above, through the ring
        o = torch.tensor([[0.8, 3.0, 0.05], [-0.5, 3.0, 0.3],
                          [0.2, 3.0, -0.75]])
        d = torch.tensor([[0.0, -1.0, 0.0]]).expand(3, 3).contiguous()

    def marched(s):
        t, mid, nrm = intersect._closest_analytic(cfg, s, o, d)
        assert (mid == 0).all()
        return t, mid, nrm

    t, mid, nrm = marched(sc)
    params = sc.params.clone().requires_grad_()
    position = sc.position.clone().requires_grad_()
    t_re, _ = intersect.analytic_reattach(
        cfg, dataclasses.replace(sc, params=params, position=position), o, d,
        t, mid, nrm)
    g_p, g_c = torch.autograd.grad(t_re.sum(), [params, position])
    eps = 1e-3
    for g, leaf, (i, j) in ((g_p, "params", (0, radius_slot)),
                            (g_c, "position", (0, 1 if kind == "torus" else 2))):
        fd = 0.0
        for sgn in (1.0, -1.0):
            val = getattr(sc, leaf).clone()
            val[i, j] += sgn * eps
            fd += sgn * float(marched(dataclasses.replace(
                sc, **{leaf: val}))[0].sum()) / (2 * eps)
        assert abs(float(g[i, j]) - fd) < 1e-3, (leaf, float(g[i, j]), fd)
        assert abs(fd) > 0.5


def _port_rays_into_reference(monkeypatch, w, cam):
    """The JAX package's render, un-jitted, takes the port's camera rays
    (the packages' rays differ in last bits, which an SDF normal
    magnifies)."""
    px, py = pathtracer.pixel_grid(w, w, "cpu")

    def rays(cam_pytree, width, height, px_, py_, pixel_idx, sample_arr, seed,
             rng_scheme="pcg4d", jitter=True):
        s = int(np.asarray(sample_arr).reshape(-1)[0])
        o, d = pathtracer.camera_rays_for_sample(cam, w, w, px, py,
                                                 py * w + px, s, int(seed),
                                                 rng_scheme, jitter)
        return jnp.asarray(o.numpy()), jnp.asarray(d.numpy())

    monkeypatch.setattr(j_pt, "camera_rays_for_sample", rays)


@pytest.mark.parametrize("bounces", [1, 3])
def test_sdf_scene_render_matches_reference(bounces, monkeypatch):
    """sdf_demo.json (three SDFs, a box) at 8^2 x 1 spp: within 1e-5 of the
    JAX package run without jit on the port's rays, every pixel; and the
    jitted reference's mean within 1e-3."""
    doc = _sdf_doc()
    doc["settings"]["MAX_BOUNCES"] = bounces
    cfg, sc = build_scene(doc, device="cpu")
    jcfg, jsc = j_build(doc)
    w = 8
    cam = default_camera(w, w).pytree("cpu")
    with torch.no_grad():
        img = pathtracer.render(cfg, sc, cam, w, w, 1, seed=4,
                                method="while")[0].numpy()
    jit = np.asarray(j_pt.render(jcfg, jsc, j_default_camera(w, w).pytree(),
                                 w, w, 1, seed=4, method="while")[0])
    _port_rays_into_reference(monkeypatch, w, cam)
    with jax.disable_jit():
        eager = np.asarray(j_pt.render(jcfg, jsc,
                                       j_default_camera(w, w).pytree(), w, w,
                                       1, seed=4, method="while")[0])
    np.testing.assert_allclose(img, eager, rtol=FWD, atol=FWD)
    assert abs(img.mean() - jit.mean()) < 1e-3 * jit.mean()
    assert img.mean() > 0


def test_sdf_scene_gradients_finite_where_reference_is_nan():
    """fwd+bwd of sdf_demo through regen_scan: every float leaf's gradient
    finite, the SDF tables' non-zero (the JAX package's are NaN there,
    ROADMAP F12)."""
    doc = _sdf_doc()
    doc["settings"]["MAX_BOUNCES"] = 2
    cfg, sc = build_scene(doc, device="cpu")
    cam = default_camera(8, 8).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, 8, 8, 1, seed=1)
    leaves = {f.name: getattr(sc, f.name).clone().requires_grad_()
              for f in dataclasses.fields(sc)
              if getattr(sc, f.name).is_floating_point()}
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, **leaves), cam, 8,
                               8, 1, seed=1, method="regen_scan",
                               regen_iters=n)
    grads = dict(zip(leaves, torch.autograd.grad(
        img.mean(), list(leaves.values()), allow_unused=True)))
    for k, g in grads.items():
        assert g is None or bool(torch.isfinite(g).all()), k
    d0, d1 = cfg.n_spheres, cfg.n_spheres + cfg.n_sdfs
    for k in ("params", "position"):
        assert float(grads[k][d0:d1].abs().max()) > 1e-4, k
