"""The port's differentiable loop, ``trace_regen_scan`` under autograd,
against its own forward loop, the JAX package and finite differences.

- Forward: bitwise equal to the port's ``trace_regen`` (the same
  estimator, the same operations in the same order), and within
  tests/test_regen_aov.py's bounds of JAX's ``trace_regen_scan``: 1e-5 at
  <= 4 bounces, 5e-4 at 32.
- Gradients of mean(image) over every float leaf of SceneData and of the
  camera, against JAX's value_and_grad through its ``trace_regen_scan``:
  rtol 1e-4 / atol 1e-6 at <= 4 bounces, the bounds of the reference's
  test_regen_scan_grad_matches_scan.  Leaves the render never reaches
  differentiably (the mesh tables, placeholders) get no gradient in torch
  and zeros in JAX: they are compared as zeros.
- Finite differences through the port's diff/fd.py: max abs err < 1e-3,
  the BASELINE bound, on edge-free scenes (FD across a silhouette measures
  the jump, not the derivative).
"""
import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import (
    build_scene as j_build, load_scene as j_load,
)
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.diff import check_gradients
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
    Camera, pytree_from_numpy,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import build_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 3
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
ICOSPHERE = dict(subdiv=1, radius=0.8, center=(0.0, 1.0, 0.0))

# case: (scene, bounce cap or None for the file's 32, size, spp, rtol, atol)
CASES = {
    "cornell_dict": ("cornell_dict", None, 8, 4),
    # cornell.json with an icosphere: the COAT mesh, K1's twin on the path
    "icosphere_coat_4": ("cornell.json", 4, 8, 2),
    "icosphere_coat_32": ("cornell.json", None, 8, 2),
}
FWD_TOL = {"cornell_dict": 1e-5, "icosphere_coat_4": 1e-5,
           "icosphere_coat_32": 5e-4}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
# At the 32-bounce budget the forward agrees to 5e-4, not 1e-5: ulp-level
# differences between two frameworks' sin/exp/division are amplified
# chaotically by deep bouncing (tests/test_regen_aov.py).  The gradient is
# a sum over the same paths' derivatives, so it gets the same relative
# bound: each leaf within rtol 5e-4, plus 5e-4 of the leaf's largest
# gradient entry.  (Measured worst case when written: 5e-5 of the largest
# entry, on the camera's view vector.)
DEEP_GRAD_REL = 5e-4


def _jax_scene(name, bounces):
    if name == "cornell_dict":
        jcfg, jsc = j_build(CORNELL)
    else:
        jcfg, jsc = j_load(f"scenes/{name}",
                           mesh_override=make_icosphere(**ICOSPHERE))
    if bounces is not None:
        jcfg = dataclasses.replace(jcfg, max_bounces=bounces)
    return jcfg, jsc


def _to_port(jcfg, jsc, jcam):
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    cam = pytree_from_numpy({k: np.asarray(v) for k, v in jcam.items()}, "cpu")
    return cfg, sc, cam


def _float_leaves(sc):
    return [f.name for f in dataclasses.fields(sc)
            if getattr(sc, f.name).is_floating_point()]


@functools.cache
def _results(case):
    """Both packages' regen_scan image and gradients for one case (one JAX
    compile gives the image, the value and the gradients)."""
    name, bounces, w, spp = CASES[case]
    jcfg, jsc = _jax_scene(name, bounces)
    jcam = j_default_camera(w, w).pytree()
    cfg, sc, cam = _to_port(jcfg, jsc, jcam)
    n_iters = pathtracer.calibrate_regen_iters(cfg, sc, cam, w, w, spp,
                                               seed=SEED)
    j_iters = j_pt.calibrate_regen_iters(jcfg, jsc, jcam, w, w, spp,
                                         seed=SEED)
    names = _float_leaves(sc)

    def j_loss(p, c):
        img, alpha = j_pt.render(jcfg, dataclasses.replace(jsc, **p), c, w, w,
                                 spp, seed=SEED, method="regen_scan",
                                 regen_iters=n_iters)
        return jnp.mean(img), (img, alpha)

    (_, (j_img, j_alpha)), (j_gs, j_gc) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
            {k: getattr(jsc, k) for k in names}, jcam)

    p = {k: getattr(sc, k).clone().requires_grad_() for k in names}
    c = {k: v.clone().requires_grad_() for k, v in cam.items()}
    img, alpha = pathtracer.render(cfg, dataclasses.replace(sc, **p), c, w, w,
                                   spp, seed=SEED, method="regen_scan",
                                   regen_iters=n_iters)
    grads = torch.autograd.grad(img.mean(), [*p.values(), *c.values()],
                                allow_unused=True)
    leaves = [("scene", k, p[k]) for k in p] + [("camera", k, c[k]) for k in c]
    got = {(kind, k): (torch.zeros_like(x) if g is None else g).numpy()
           for (kind, k, x), g in zip(leaves, grads)}
    want = {("scene", k): np.asarray(v) for k, v in j_gs.items()}
    want.update({("camera", k): np.asarray(v) for k, v in j_gc.items()})
    with torch.no_grad():
        reg, reg_alpha = pathtracer.render(cfg, sc, cam, w, w, spp, seed=SEED,
                                           method="regen")
    return dict(n_iters=n_iters, j_iters=j_iters, img=img.detach(),
                alpha=alpha, reg=reg, reg_alpha=reg_alpha,
                j_img=np.asarray(j_img), j_alpha=np.asarray(j_alpha),
                got=got, want=want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_regen_scan_forward(case):
    r = _results(case)
    assert r["n_iters"] == r["j_iters"] > 0
    assert torch.equal(r["img"], r["reg"])
    assert torch.equal(r["alpha"], r["reg_alpha"])
    tol = FWD_TOL[case]
    np.testing.assert_allclose(r["img"].numpy(), r["j_img"], rtol=tol, atol=tol)
    np.testing.assert_allclose(r["alpha"].numpy(), r["j_alpha"], rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_regen_scan_grad_matches_reference(case):
    r = _results(case)
    assert r["got"].keys() == r["want"].keys()
    nonzero = 0
    for key, want in r["want"].items():
        got = r["got"][key]
        assert got.shape == want.shape, key
        assert np.isfinite(got).all(), key
        if case == "icosphere_coat_32":
            atol = DEEP_GRAD_REL * float(np.abs(want).max(initial=0.0))
            np.testing.assert_allclose(got, want, rtol=DEEP_GRAD_REL,
                                       atol=atol, err_msg=str(key))
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=str(key))
        nonzero += bool(np.abs(want).max(initial=0.0) > 0)
    # colours, geometry and the camera all carry gradient
    assert nonzero >= 10
    for key in (("scene", "color"), ("scene", "position"),
                ("camera", "position")):
        assert np.abs(r["got"][key]).max() > 1e-4, key


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grad_spread_of_two_cpu_implementations(record_property):
    """chip_smoke.py's yardstick for the card's gradients at 4 bounces on
    its 32^2 card-vs-CPU input, where rtol 1e-4 / atol 1e-6 (the bound of
    the 8x8 cases above) is out of reach of any two float32
    implementations: grazing hits make some leaves' gradients
    ill-conditioned.  Measured here: how far the JAX package's CPU
    gradients are from the port's on that input, per leaf, as max |JAX -
    port| over the leaf's largest entry.  Every leaf must stay within
    chip_smoke.GRAD_SPREAD_4 (so the table never understates the spread it
    lets the card have), and the colour and light leaves, which are well
    conditioned, within rtol 1e-4 / atol 1e-6."""
    cs = _chip_smoke()
    w, spp = cs.CVC_SIZE, cs.CVC_SPP
    jcfg, jsc = j_load("scenes/cornell.json",
                       mesh_override=make_icosphere(**cs.CVC_MESH))
    jcfg = dataclasses.replace(jcfg, max_bounces=4)
    jcam = j_default_camera(w, w).pytree()
    cfg, sc, cam = _to_port(jcfg, jsc, jcam)
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, w, w, spp, seed=SEED)
    names = _float_leaves(sc)

    def j_loss(p, c):
        img, _ = j_pt.render(jcfg, dataclasses.replace(jsc, **p), c, w, w,
                             spp, seed=SEED, method="regen_scan",
                             regen_iters=n)
        return jnp.mean(img)

    j_gs, j_gc = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(
        {k: getattr(jsc, k) for k in names}, jcam)
    p = {k: getattr(sc, k).clone().requires_grad_() for k in names}
    c = {k: v.clone().requires_grad_() for k, v in cam.items()}
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, **p), c, w, w,
                               spp, seed=SEED, method="regen_scan",
                               regen_iters=n)
    grads = torch.autograd.grad(img.mean(), [*p.values(), *c.values()],
                                allow_unused=True)
    want = [np.asarray(j_gs[k]) for k in names] + [np.asarray(j_gc[k])
                                                   for k in c]
    keys = [f"scene.{k}" for k in names] + [f"camera.{k}" for k in c]
    lines = []
    for key, g, x, jv in zip(keys, grads, [*p.values(), *c.values()], want):
        got = (torch.zeros_like(x) if g is None else g).numpy()
        assert np.isfinite(got).all(), key
        err = float(np.abs(got - jv).max())
        top = float(np.abs(jv).max())
        if top == 0.0:
            assert err == 0.0, key
            continue
        spread = err / top
        record_property(key, spread)
        lines.append(f"{key} {spread:.3g}")
        assert spread <= cs.GRAD_SPREAD_4[key], (key, spread)
        if key in ("scene.color", "scene.obj_color", "scene.obj_eta",
                   "scene.obj_k", "scene.position", "scene.params"):
            np.testing.assert_allclose(got, jv, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL, err_msg=key)
    print("JAX vs port CPU gradients, err / leaf max: " + ", ".join(lines))


def test_completed_and_budget():
    """completed == spp with the calibrated budget, < spp with a short
    one; render raises on the short budget instead of returning a partial
    image, and wants regen_iters at all."""
    cfg, sc = build_scene(CORNELL, device="cpu")
    cam = Camera(**_default_cam_fields(8)).pytree("cpu")
    px, py = pathtracer.pixel_grid(8, 8, "cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, 8, 8, 4, seed=SEED)
    assert n % integrator.SCAN_CHUNK == 0
    _, _, done = pathtracer.trace_regen_scan(cfg, sc, cam, 8, 8, 4, px, py,
                                             SEED, n)
    assert int(done) == 4
    _, _, done = pathtracer.trace_regen_scan(cfg, sc, cam, 8, 8, 4, px, py,
                                             SEED, 3)
    assert int(done) < 4
    with pytest.raises(RuntimeError, match="of 4 samples"):
        pathtracer.render(cfg, sc, cam, 8, 8, 4, seed=SEED,
                          method="regen_scan", regen_iters=3)
    with pytest.raises(ValueError, match="regen_iters"):
        pathtracer.render(cfg, sc, cam, 8, 8, 4, method="regen_scan")
    with pytest.raises(NotImplementedError, match="M6b"):
        pathtracer.trace_regen_scan(cfg, sc, cam, 8, 8, 4, px, py, SEED, n,
                                    remat="segment")
    # a budget above one chunk rounds up to whole chunks, as the reference
    assert [pathtracer.scan_iterations(k) for k in (3, 8, 9, 17)] == [3, 8,
                                                                     16, 24]


def _default_cam_fields(w):
    c = j_default_camera(w, w)
    return dict(position=np.asarray(c.position), view=np.asarray(c.view),
                up=np.asarray(c.up), resolution=(w, w),
                fov=np.asarray(c.fov), aperture_radius=c.aperture_radius,
                focal_distance=c.focal_distance)


# ---------------------------------------------------------------------------
# finite differences
# ---------------------------------------------------------------------------

W = H = 8
SPP = 4
# edge-free scenes, one bounce: every camera ray hits the same surface and
# the only light is NEE from an off-screen sphere, so the image is smooth
# in the light, the surface and the camera
FLOOR = {
    "settings": {"MAX_BOUNCES": 1, "MAX_DIFF_BOUNCES": 1},
    "scene": {
        "spheres": [{"pos": [0.0, 3.0, 3.0], "radius": 0.5,
                     "material": {"color": [8.0, 8.0, 8.0], "type": 0}}],
        "quads": [{"vertices": [0.0, -0.5, 0.0, 12.0, 0.0, 0.0,
                                0.0, 0.0, 12.0],
                   "material": {"color": [0.6, 0.5, 0.4]}}],
    },
}
FLOOR_CAM = dict(position=np.array([0.0, 1.5, 1.0], np.float32),
                 view=np.array([0.0, -0.857493, -0.514496], np.float32),
                 up=np.array([0.0, 1.0, 0.0], np.float32), resolution=(W, H),
                 fov=np.array([45.0, 45.0], np.float32),
                 aperture_radius=0.01, focal_distance=4.0)
# a diffuse ball that fills the view (every ray hits it well inside its
# silhouette), lit by an off-screen sphere behind the camera
BALL = {
    "settings": {"MAX_BOUNCES": 1, "MAX_DIFF_BOUNCES": 1},
    "scene": {
        "spheres": [
            {"pos": [0.0, 0.0, 0.0], "radius": 1.0,
             "material": {"color": [0.7, 0.7, 0.7]}},
            {"pos": [0.0, 0.8, 3.2], "radius": 0.4,
             "material": {"color": [8.0, 8.0, 8.0], "type": 0}}],
    },
}
BALL_CAM = dict(position=np.array([0.0, 0.0, 1.8], np.float32),
                view=np.array([0.0, 0.0, -1.0], np.float32),
                up=np.array([0.0, 1.0, 0.0], np.float32), resolution=(W, H),
                fov=np.array([45.0, 45.0], np.float32),
                aperture_radius=0.01, focal_distance=4.0)


def _fd_setup(doc, cam_fields=None, mesh=None):
    cfg, sc = build_scene(doc, mesh_override=mesh, device="cpu")
    cam = Camera(**(cam_fields or _default_cam_fields(W))).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, W, H, SPP, seed=SEED,
                                         margin=1.25)

    def mean_radiance(scene=sc, camera=cam):
        img, _ = pathtracer.render(cfg, scene, camera, W, H, SPP, seed=SEED,
                                   method="regen_scan", regen_iters=n)
        return torch.mean(img)

    return cfg, sc, cam, mean_radiance


def _assert_fd(rep, floor=1e-4):
    ad = rep.ad if isinstance(rep.ad, torch.Tensor) else torch.stack(
        list(rep.ad.values()))
    assert torch.isfinite(ad).all()
    assert ad.abs().max() > floor, ad
    assert rep.ok and rep.max_abs_err < 1e-3, rep.max_abs_err


def test_fd_material_color():
    _, sc, _, f = _fd_setup(CORNELL)
    rep = check_gradients(lambda color: f(dataclasses.replace(sc, color=color)),
                          sc.color, eps=2e-3)
    _assert_fd(rep)


def test_fd_mesh_obj_color():
    _, sc, _, f = _fd_setup(CORNELL, mesh=make_icosphere(**ICOSPHERE))
    rep = check_gradients(
        lambda c: f(dataclasses.replace(sc, obj_color=c)), sc.obj_color,
        eps=2e-3)
    _assert_fd(rep)


def test_fd_camera_position():
    _, _, cam, f = _fd_setup(FLOOR, FLOOR_CAM)
    rep = check_gradients(lambda pos: f(camera={**cam, "position": pos}),
                          cam["position"], eps=1e-3)
    _assert_fd(rep)


# F2 (ROADMAP): analytic_reattach's derivatives w.r.t. the object tables,
# held against FD, with its dF/dt clamp of 1e-6 in place
F2_CASES = {
    # name: (scene, camera, leaf, row, columns)
    "floor/light_position": (FLOOR, FLOOR_CAM, "position", 0, slice(0, 3)),
    "floor/light_radius": (FLOOR, FLOOR_CAM, "params", 0, slice(0, 1)),
    "floor/quad_base_along_normal": (FLOOR, FLOOR_CAM, "quad_base", 1, None),
    "ball/ball_position": (BALL, BALL_CAM, "position", 0, slice(0, 3)),
    "ball/ball_radius": (BALL, BALL_CAM, "params", 0, slice(0, 1)),
    "ball/light_position": (BALL, BALL_CAM, "position", 1, slice(0, 3)),
}


@pytest.mark.parametrize("case", sorted(F2_CASES))
def test_fd_f2_object_tables(case):
    doc, cam_fields, leaf, row, cols = F2_CASES[case]
    _, sc, _, f = _fd_setup(doc, cam_fields)
    base = getattr(sc, leaf)
    if cols is None:
        # move the quad along its own normal by s
        normal = sc.quad_normal[row]

        def g(s):
            new = base.clone()
            new[row] = base[row] + normal * s
            return f(dataclasses.replace(sc, **{leaf: new}))

        rep = check_gradients(g, torch.zeros(()), eps=1e-3)
    else:
        def g(v):
            new = base.clone()
            new[row, cols] = v
            return f(dataclasses.replace(sc, **{leaf: new}))

        rep = check_gradients(g, base[row, cols].clone(), eps=1e-3)
    _assert_fd(rep)


# ---------------------------------------------------------------------------
# gradient hygiene, vertex gradients, the K1 count
# ---------------------------------------------------------------------------

def _sanitizer_scene(family):
    if family == "lambert":
        return build_scene(CORNELL, device="cpu")
    jcfg, jsc = _jax_scene("cornell.json", 4)
    cfg, sc, _ = _to_port(jcfg, jsc, j_default_camera(W, W).pytree())
    return cfg, sc


def _grad_color(cfg, sc, cam, n):
    color = sc.color.clone().requires_grad_()
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, color=color), cam,
                               W, H, SPP, seed=SEED, method="regen_scan",
                               regen_iters=n)
    (g,) = torch.autograd.grad(img.mean(), [color])
    return g


@pytest.mark.parametrize("family", ["lambert", "coat"])
def test_sanitizer_inert_on_live_lanes(family, monkeypatch):
    """On closed scenes of the ported families, bypassing the sanitizer
    gives the identical, finite gradient: it zeroes nothing there, so a
    genuine non-finite partial could not hide behind it."""
    cfg, sc = _sanitizer_scene(family)
    cam = Camera(**_default_cam_fields(W)).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, W, H, SPP, seed=SEED)
    g_sanitized = _grad_color(cfg, sc, cam, n)
    assert g_sanitized.abs().max() > 1e-5
    monkeypatch.setattr(integrator, "_sanitize_grad", lambda x: x)
    g_raw = _grad_color(cfg, sc, cam, n)
    assert torch.isfinite(g_raw).all(), "live-lane cotangents went non-finite"
    assert torch.equal(g_raw, g_sanitized)


class _Bomb(torch.autograd.Function):
    """Identity whose backward poisons every lane with NaN."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return torch.full_like(g, float("nan"))


def test_sanitizer_detects_planted_nan(monkeypatch):
    """The instrument of the test above works: a NaN planted in a LIVE
    lane's throughput cotangent reaches the unsanitised gradient."""
    cfg, sc = build_scene(CORNELL, device="cpu")
    cam = Camera(**_default_cam_fields(W)).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, W, H, SPP, seed=SEED)
    monkeypatch.setattr(integrator, "_sanitize_grad", lambda x: x)
    real_shade = integrator.shade_step

    def poisoned_shade(cfg2, scene2, state, hit, sampler):
        state, nee = real_shade(cfg2, scene2, state, hit, sampler)
        return state._replace(mask=_Bomb.apply(state.mask)), nee

    monkeypatch.setattr(integrator, "shade_step", poisoned_shade)
    assert not torch.isfinite(_grad_color(cfg, sc, cam, n)).all()


def test_mesh_vertex_grads_opt_in():
    """tri_reattach's d(t)/d(vertex) against FD; with mesh_vertex_grads the
    image has a finite, non-zero vertex gradient; by default none."""
    o = torch.tensor([[0.0, 0.0, -2.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    base = torch.tensor([[[-1.0, -1.0, 0.5], [1.5, -1.0, 0.5],
                          [0.0, 1.5, 0.5]]])
    tri = torch.tensor([0], dtype=torch.int32)

    def t_of(verts):
        return intersect.tri_reattach(verts, tri, o, d)[0][0]

    v = base.clone().requires_grad_()
    (g,) = torch.autograd.grad(t_of(v), [v])
    eps = 1e-3
    for (i, j) in [(0, 2), (1, 2), (2, 0)]:
        vp, vm = base.clone(), base.clone()
        vp[0, i, j] += eps
        vm[0, i, j] -= eps
        fd = (float(t_of(vp)) - float(t_of(vm))) / (2 * eps)
        assert abs(float(g[0, i, j]) - fd) < 1e-3, (i, j, float(g[0, i, j]), fd)

    mesh = make_icosphere(**ICOSPHERE)
    cfg, sc = build_scene(CORNELL, mesh_override=mesh, device="cpu")
    cam = Camera(**_default_cam_fields(W)).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, W, H, SPP, seed=SEED)

    def vertex_grad(c):
        verts = sc.bf_tri_verts.clone().requires_grad_()
        img, _ = pathtracer.render(c, dataclasses.replace(sc, bf_tri_verts=verts),
                                   cam, W, H, SPP, seed=SEED,
                                   method="regen_scan", regen_iters=n)
        if not img.requires_grad:
            return None
        return torch.autograd.grad(img.mean(), [verts])[0]

    gv = vertex_grad(dataclasses.replace(cfg, mesh_vertex_grads=True))
    assert torch.isfinite(gv).all() and gv.abs().max() > 1e-6
    assert vertex_grad(cfg) is None  # detached: JAX's documented zeros


def test_backward_never_reruns_the_mesh_kernel(monkeypatch):
    """Over one fwd+bwd, the mesh search (K1's twin on the CPU) runs once
    per iteration: the checkpoint boundary is the detached dispatch, so
    the backward recomputes shading only."""
    cfg, sc = build_scene(CORNELL, mesh_override=make_icosphere(**ICOSPHERE),
                          device="cpu")
    cam = Camera(**_default_cam_fields(W)).pytree("cpu")
    n = pathtracer.calibrate_regen_iters(cfg, sc, cam, W, H, SPP, seed=SEED)
    calls = []
    real = mesh_brute._intersect_xla

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mesh_brute, "_intersect_xla", counting)
    color = sc.color.clone().requires_grad_()
    img, _ = pathtracer.render(cfg, dataclasses.replace(sc, color=color), cam,
                               W, H, SPP, seed=SEED, method="regen_scan",
                               regen_iters=n)
    assert len(calls) == n
    img.mean().backward()
    assert len(calls) == n
    assert torch.isfinite(color.grad).all() and color.grad.abs().max() > 0


def test_f2_reference_sphere_normal_gradient_misses_the_t_term(
        record_property):
    """ROADMAP F2's outcome.  The port's analytic_reattach normalises a
    sphere's normal at the REATTACHED hit point, so its d(image)/d(radius)
    on the diffuse-ball scene agrees with FD; both packages' FD agree, so
    the scene renders the same in both.  The reference builds that normal
    from a detached hit distance, and its autograd-vs-FD error is reported
    here (``reference_fd_err`` in the JUnit report, and on stdout), not
    asserted: the port's
    parity with the reference leaves sphere-normal gradients out (ROADMAP
    F2).  The dF/dt clamp is not at fault: no lane of these scenes comes
    near it."""
    from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
        Camera as JCamera,
    )
    from photorealistic_rendering_using_opencl_tpu.diff import (
        check_gradients as j_check,
    )
    jcfg, jsc = j_build(BALL)
    jcam = JCamera(**BALL_CAM).pytree()
    n = j_pt.calibrate_regen_iters(jcfg, jsc, jcam, W, H, SPP, seed=SEED,
                                   margin=1.25)

    def j_mean(prm):
        img, _ = j_pt.render(jcfg, dataclasses.replace(jsc, params=prm), jcam,
                             W, H, SPP, seed=SEED, method="regen_scan",
                             regen_iters=n)
        return jnp.mean(img)

    j_rep = j_check(jax.jit(j_mean), jsc.params, eps=1e-3, max_coords=1)
    _, sc, _, f = _fd_setup(BALL, BALL_CAM)

    def g(r):
        new = sc.params.clone()
        new[0, 0] = r
        return f(dataclasses.replace(sc, params=new))

    rep = check_gradients(g, sc.params[0, 0].clone(), eps=1e-3)
    assert rep.max_abs_err < 1e-3
    np.testing.assert_allclose(float(np.asarray(j_rep.fd)[0, 0]),
                               float(rep.fd), rtol=1e-3)
    record_property("port_fd_err", rep.max_abs_err)
    record_property("reference_fd_err", float(j_rep.max_abs_err))
    print(f"F2 d(mean image)/d(ball radius): FD {float(rep.fd):.6f}; port "
          f"autograd err {rep.max_abs_err:.3g}, reference autograd err "
          f"{float(j_rep.max_abs_err):.3g}")
