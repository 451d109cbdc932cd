"""One regeneration iteration, piece by piece, against the JAX package:
``shade_step``, the merged dispatch (the port's detached
``intersect_and_shadow_detached`` + differentiable ``finish_hit``, against
the reference's ``intersect_and_shadow``) and the whole ``_regen_step`` (the
port's loops' halves, ``_shade_regenerate`` -> ``_regen_dispatch`` ->
``finish_hit`` + ``accumulate_nee``), all from the same mid-render carry
(cornell + icosphere with the COAT material, so every ported BSDF family
and the mesh run)."""
import dataclasses

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
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import pytree_from_numpy
from photorealistic_rendering_using_opencl_tpu_torch.ops.rng import Sampler
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

W = H = 16
SPP = 2
SEED = 3
RTOL = 1e-5
WARM_ITERS = 3  # iterations run before the compared one


def _t(x):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a.copy())


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(name, got, want):
    got, want = _np(got), np.asarray(want)
    if want.dtype == np.uint32:
        want = want.astype(np.int64)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                   err_msg=name)


@pytest.fixture(scope="module")
def setup():
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, 1.2, 0.0))
    jcfg, jsc = j_load("scenes/cornell.json", mesh_override=mesh)
    jcam = j_default_camera(W, H).pytree()
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    cam = pytree_from_numpy({k: np.asarray(v) for k, v in jcam.items()}, "cpu")
    px, py = j_pt.pixel_grid(W, H)
    pix = py.astype(jnp.uint32) * W + px.astype(jnp.uint32)
    carry = j_pt._regen_carry0(W * H)
    for _ in range(WARM_ITERS):
        carry = j_pt._regen_step(jcfg, jsc, jcam, W, H, SPP, px, py, pix,
                                 SEED, "pcg4d", True, carry)
    return dict(jcfg=jcfg, jsc=jsc, jcam=jcam, cfg=cfg, sc=sc, cam=cam,
                px=px, py=py, pix=pix, carry=carry)


def _port_carry(carry):
    state, hit, cur, pending, bounce, alpha_sum = carry
    return (integrator.PathState(*[_t(x) for x in state]),
            intersect.Hit(*[_t(x) for x in hit]),
            _t(cur), _t(pending), _t(bounce), _t(alpha_sum))


def test_shade_step_matches_reference(setup):
    s = setup
    state, hit, cur, _, bounce, _ = s["carry"]
    assert bool(np.asarray(state.alive).any())
    dim = j_int.CAMERA_DIMS + bounce * j_int.DIMS_PER_BOUNCE
    jstate, jnee = j_int.shade_step(
        s["jcfg"], s["jsc"], state, hit, JSampler(s["pix"], cur, seed=SEED,
                                                  dim=dim))
    pstate, phit = _port_carry(s["carry"])[:2]
    tstate, tnee = integrator.shade_step(
        s["cfg"], s["sc"], pstate, phit,
        Sampler(_t(s["pix"]), _t(cur), seed=SEED, dim=_t(dim)))
    for f in jstate._fields:
        _assert_same(f"state.{f}", getattr(tstate, f), getattr(jstate, f))
    assert len(tnee) == len(jnee) == 1
    for f in jnee[0]._fields:
        _assert_same(f"nee.{f}", getattr(tnee[0], f), getattr(jnee[0], f))


def test_intersect_and_shadow_matches_reference(setup):
    s = setup
    state, hit, cur, _, bounce, _ = s["carry"]
    dim = j_int.CAMERA_DIMS + bounce * j_int.DIMS_PER_BOUNCE
    jstate, jnee = j_int.shade_step(
        s["jcfg"], s["jsc"], state, hit, JSampler(s["pix"], cur, seed=SEED,
                                                  dim=dim))
    excl = j_int._self_exclusion(s["jcfg"], hit, jstate, state.n_scatter)
    # the regeneration loop's per-segment form: closest rays of some lanes
    # exclude nothing, their shadow rays still exclude their triangle
    regen = jnp.asarray(np.arange(W * H) % 5 == 0)
    ex_list = [jnp.where(regen, -1, excl), excl]
    batches = [(b.origin, b.direction, b.dist, b.active) for b in jnee]
    jh, jvis = j_isect.intersect_and_shadow(
        s["jcfg"], s["jsc"], jstate.origin, jstate.direction, jstate.alive,
        batches, exclude_tri=ex_list)
    o, d = _t(jstate.origin), _t(jstate.direction)
    rec = intersect.intersect_and_shadow_detached(
        s["cfg"], s["sc"], o, d, _t(jstate.alive),
        [tuple(_t(x) for x in b) for b in batches],
        exclude_tri=[_t(x) for x in ex_list])
    th, tvis = intersect.finish_hit(s["cfg"], s["sc"], o, d, rec), rec.visible
    for f in ("tri", "mesh_id", "backside"):
        _assert_same(f"hit.{f}", getattr(th, f), getattr(jh, f))
    for f in ("t", "pos", "normal"):
        _assert_same(f"hit.{f}", getattr(th, f), getattr(jh, f))
    assert (np.asarray(jh.tri) >= 0).any()  # the mesh was hit
    for a, b in zip(tvis, jvis):
        _assert_same("visible", a, b)


def test_regen_step_matches_reference(setup):
    s = setup
    jout = j_pt._regen_step(s["jcfg"], s["jsc"], s["jcam"], W, H, SPP,
                            s["px"], s["py"], s["pix"], SEED, "pcg4d", True,
                            s["carry"])
    px, py = pathtracer.pixel_grid(W, H, "cpu")
    # the production loops' order: shade + regenerate, the detached
    # dispatch, then (at the start of the next iteration) the reattach and
    # the NEE bank
    shaded = pathtracer._shade_regenerate(
        s["cfg"], s["sc"], s["cam"], W, H, SPP, px, py, py * W + px, SEED,
        "pcg4d", True, _port_carry(s["carry"]))
    state, nee, rec, *rest = pathtracer._regen_dispatch(s["cfg"], s["sc"],
                                                        shaded)
    thit = intersect.finish_hit(s["cfg"], s["sc"], state.origin,
                                state.direction, rec)
    tstate = integrator.accumulate_nee(state, nee, rec.visible)
    tout = (tstate, thit, *rest)
    jstate, jhit = jout[0], jout[1]
    for f in jstate._fields:
        _assert_same(f"state.{f}", getattr(tstate, f), getattr(jstate, f))
    for f in jhit._fields:
        _assert_same(f"hit.{f}", getattr(thit, f), getattr(jhit, f))
    for name, a, b in zip(("cur", "pending", "bounce", "alpha_sum"),
                          tout[2:], jout[2:]):
        _assert_same(name, a, b)
