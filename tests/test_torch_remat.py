"""``trace_regen_scan(remat="segment")``: one checkpoint around each
``SCAN_CHUNK`` iterations, dispatches included, with the chunk's dispatch
results replayed from its ``HitTape`` in the recompute.

- Against ``remat="body"`` on the same inputs: the image, alpha and
  ``completed`` bitwise, and every gradient (each float leaf of the scene
  and of the camera) bitwise, at a budget of three chunks and at one
  within a chunk (where segment runs as body), on tests/test_torch_grad.py's
  scenes: both modes build the same autograd graph from the same values.
- Against the JAX package's value_and_grad through its
  ``trace_regen_scan(remat="segment")`` with the calibrated budget:
  rtol 1e-4 / atol 1e-6 at <= 4 bounces, ``DEEP_GRAD_REL`` at 32
  (tests/test_torch_grad.py's bounds).
- Over a whole fwd+bwd the mesh search (K1's twin on the CPU) runs once
  an iteration, all in the forward, also under a second backward of a
  retained graph; every tape is empty once the backward is over.
- ``PRT_SCAN_CHUNK`` sets ``SCAN_CHUNK`` at import, as in the reference.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator, pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
from tests.test_torch_grad import (
    CASES, DEEP_GRAD_REL, GRAD_ATOL, GRAD_RTOL, SEED, _float_leaves,
    _jax_scene, _to_port,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = integrator.SCAN_CHUNK
# budgets: three chunks (segment checkpoints each chunk) and one within a
# chunk (segment runs as body)
BUDGETS = {"three_chunks": 3 * CHUNK, "one_chunk": CHUNK - 3}


@functools.cache
def _inputs(case):
    name, bounces, w, spp = CASES[case]
    jcfg, jsc = _jax_scene(name, bounces)
    jcam = j_default_camera(w, w).pytree()
    cfg, sc, cam = _to_port(jcfg, jsc, jcam)
    return jcfg, jsc, jcam, cfg, sc, cam


def _fwd_bwd(case, n_iters, remat):
    """image, alpha, completed and {leaf: gradient} of mean(image)."""
    _, _, _, cfg, sc, cam = _inputs(case)
    _, _, w, spp = CASES[case]
    px, py = pathtracer.pixel_grid(w, w, "cpu")
    p = {k: getattr(sc, k).clone().requires_grad_() for k in _float_leaves(sc)}
    c = {k: v.clone().requires_grad_() for k, v in cam.items()}
    acc, alpha, done = pathtracer.trace_regen_scan(
        cfg, dataclasses.replace(sc, **p), c, w, w, spp, px, py, SEED,
        n_iters, remat=remat)
    leaves = {**{f"scene.{k}": v for k, v in p.items()},
              **{f"camera.{k}": v for k, v in c.items()}}
    grads = torch.autograd.grad(torch.mean(acc), list(leaves.values()),
                                allow_unused=True)
    return dict(img=acc.detach(), alpha=alpha.detach(), done=int(done),
                grads={k: (torch.zeros_like(x) if g is None else g)
                       for (k, x), g in zip(leaves.items(), grads)})


@functools.cache
def _pair(case, budget):
    n_iters = BUDGETS[budget]
    return _fwd_bwd(case, n_iters, "body"), _fwd_bwd(case, n_iters, "segment")


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_forward_bitwise_body(case, budget):
    body, seg = _pair(case, budget)
    assert torch.equal(seg["img"], body["img"])
    assert torch.equal(seg["alpha"], body["alpha"])
    assert seg["done"] == body["done"]
    assert float(body["img"].abs().max()) > 0.0


@pytest.mark.parametrize("budget", sorted(BUDGETS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_grads_bitwise_body(case, budget):
    body, seg = _pair(case, budget)
    assert seg["grads"].keys() == body["grads"].keys()
    for k, g in body["grads"].items():
        assert torch.equal(seg["grads"][k], g), k
    assert float(body["grads"]["scene.color"].abs().max()) > 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_grads_match_reference(case):
    jcfg, jsc, jcam, cfg, sc, cam = _inputs(case)
    _, _, w, spp = CASES[case]
    n_iters = pathtracer.calibrate_regen_iters(cfg, sc, cam, w, w, spp,
                                               seed=SEED)
    assert n_iters > CHUNK  # the chunked checkpoints, not body's
    got = _fwd_bwd(case, n_iters, "segment")
    assert got["done"] == spp
    names = _float_leaves(sc)
    px, py = j_pt.pixel_grid(w, w)

    def j_loss(p, c):
        acc, alpha, done = j_pt.trace_regen_scan(
            jcfg, dataclasses.replace(jsc, **p), c, w, w, spp, px, py, SEED,
            n_iters, remat="segment")
        return jnp.mean(acc), done

    (_, done), (j_gs, j_gc) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
            {k: getattr(jsc, k) for k in names}, jcam)
    assert int(done) == spp
    want = {f"scene.{k}": np.asarray(v) for k, v in j_gs.items()}
    want.update({f"camera.{k}": np.asarray(v) for k, v in j_gc.items()})
    assert want.keys() == got["grads"].keys()
    for k, jv in want.items():
        g = got["grads"][k].numpy()
        assert g.shape == jv.shape and np.isfinite(g).all(), k
        if case == "icosphere_coat_32":
            np.testing.assert_allclose(
                g, jv, rtol=DEEP_GRAD_REL,
                atol=DEEP_GRAD_REL * float(np.abs(jv).max(initial=0.0)),
                err_msg=k)
        else:
            np.testing.assert_allclose(g, jv, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)


class _Tapes:
    """Every HitTape ``trace_regen_scan`` makes, kept for inspection."""

    def __init__(self, monkeypatch):
        self.made = []
        real = pathtracer.HitTape
        made = self.made

        class Kept(real):
            def __init__(self):
                super().__init__()
                made.append(self)

        monkeypatch.setattr(pathtracer, "HitTape", Kept)

    def sizes(self):
        return [len(t.records) for t in self.made]


def _counted_mesh(monkeypatch):
    calls = []
    real = mesh_brute._intersect_xla

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(mesh_brute, "_intersect_xla", counting)
    return calls


def _color_run(case, n_iters):
    _, _, _, cfg, sc, cam = _inputs(case)
    _, _, w, spp = CASES[case]
    px, py = pathtracer.pixel_grid(w, w, "cpu")
    color = sc.color.clone().requires_grad_()
    acc, _, _ = pathtracer.trace_regen_scan(
        cfg, dataclasses.replace(sc, color=color), cam, w, w, spp, px, py,
        SEED, n_iters, remat="segment")
    return torch.mean(acc), color


def test_backward_never_reruns_the_mesh_kernel(monkeypatch):
    """The mesh search runs n_iters times over a whole fwd+bwd, all in the
    forward; the tapes hold a chunk's records each until their chunk's
    recompute ends, and are empty after the backward."""
    n_iters = 3 * CHUNK
    calls = _counted_mesh(monkeypatch)
    tapes = _Tapes(monkeypatch)
    loss, color = _color_run("icosphere_coat_4", n_iters)
    assert len(calls) == n_iters
    assert tapes.sizes() == [CHUNK] * 3
    (g,) = torch.autograd.grad(loss, [color])
    assert len(calls) == n_iters
    assert tapes.sizes() == [0] * 3
    assert torch.isfinite(g).all() and g.abs().max() > 0
    # the colour's gradient is body mode's, where every leaf took one
    want = _pair("icosphere_coat_4", "three_chunks")[0]["grads"]["scene.color"]
    assert torch.equal(g, want)


def test_second_backward_replays_the_tape(monkeypatch):
    """With the graph retained, a second backward replays the same records
    (no search) to the same gradient; its tapes are freed after the last
    backward."""
    n_iters = 3 * CHUNK
    calls = _counted_mesh(monkeypatch)
    tapes = _Tapes(monkeypatch)
    loss, color = _color_run("icosphere_coat_4", n_iters)
    (g1,) = torch.autograd.grad(loss, [color], retain_graph=True)
    assert tapes.sizes() == [CHUNK] * 3
    (g2,) = torch.autograd.grad(loss, [color])
    assert len(calls) == n_iters
    assert torch.equal(g1, g2)
    assert tapes.sizes() == [0] * 3


def test_forward_without_grad_records_and_drops(monkeypatch):
    """Under torch.no_grad() no recompute follows: segment's forward is
    body's, and its mesh search runs once an iteration."""
    _, _, _, cfg, sc, cam = _inputs("icosphere_coat_4")
    _, _, w, spp = CASES["icosphere_coat_4"]
    px, py = pathtracer.pixel_grid(w, w, "cpu")
    calls = _counted_mesh(monkeypatch)
    with torch.no_grad():
        seg = pathtracer.trace_regen_scan(cfg, sc, cam, w, w, spp, px, py,
                                          SEED, 3 * CHUNK, remat="segment")
    assert len(calls) == 3 * CHUNK
    body = _pair("icosphere_coat_4", "three_chunks")[0]
    assert torch.equal(seg[0], body["img"])


def test_unknown_remat_raises():
    _, _, _, cfg, sc, cam = _inputs("cornell_dict")
    px, py = pathtracer.pixel_grid(8, 8, "cpu")
    with pytest.raises(ValueError, match="remat"):
        pathtracer.trace_regen_scan(cfg, sc, cam, 8, 8, 4, px, py, SEED, 16,
                                    remat="segments")


def test_scan_chunk_from_environment():
    """PRT_SCAN_CHUNK=16 gives both packages SCAN_CHUNK 16 at import, and
    the port's budgets round to its chunks."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from photorealistic_rendering_using_opencl_tpu.models import "
        "integrator as j\n"
        "from photorealistic_rendering_using_opencl_tpu_torch.models import "
        "integrator as t, pathtracer as p\n"
        "print(j.SCAN_CHUNK, t.SCAN_CHUNK, p.scan_iterations(17),"
        " p.scan_iterations(16))\n")
    env = dict(os.environ, PRT_SCAN_CHUNK="16", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert res.stdout.split() == ["16", "16", "32", "16"]
