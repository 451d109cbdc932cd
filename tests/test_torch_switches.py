"""The census of the JAX package's run-time switches: every ``PRT_*`` name in
its sources is honoured by the port's module of the same path, or stands
in ALLOWED with the reason the port has no use for it.  A name the JAX
module reads from the environment must be read by the port's module; a
name it only mentions (a docstring pointing at the module that reads it)
must be mentioned.  The sources are read as text, so nothing of either
package is imported for the walk.

Then the small switches held to the JAX package: PRT_GRAD_DEBUG's report
of the cotangents the sanitizer zeroes, and PRT_NO_NATIVE's Python builds
(without patching ``get_lib``).  The mesh switches (PRT_MESH_PRECISION,
PRT_MESH_DTYPE, PRT_MESH_NOREL, PRT_MESH_FORCE_XLA) are tested in
tests/test_torch_mesh_precision.py.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import integrator as j_integrator
from photorealistic_rendering_using_opencl_tpu.scene import bvh_build as j_bvh
from photorealistic_rendering_using_opencl_tpu.scene import loader as j_loader
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
from photorealistic_rendering_using_opencl_tpu_torch.runtime import native
from photorealistic_rendering_using_opencl_tpu_torch.scene import bvh_build, loader, obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "photorealistic_rendering_using_opencl_tpu"
PORT_PKG = JAX_PKG + "_torch"
NAME = re.compile(r"\bPRT_[A-Z0-9_]+\b")

# (JAX module, switch) -> why the port has no use for it
ALLOWED = {
    ("ops/mesh_brute.py", "PRT_MESH_CHUNK_TRIS"): (
        "the triangles of one VMEM chunk of the TPU kernel's streamed mode; "
        "the port's kernels read the whole table through the L2, tile by "
        "tile.  It cannot change a result: the streamed mode walks the same "
        "tiles in the same order (its global tile id pid_j * tpc + j)"),
}


def _sources(pkg):
    root = os.path.join(REPO, pkg)
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(d, f)
                out[os.path.relpath(path, root)] = open(path).read()
    return out


def _reads(src, name):
    """Whether ``src`` reads ``name`` from the environment."""
    return re.search(r"environ(?:\.get)?\s*[\(\[]\s*[\"']" + name + r"[\"']",
                     src) is not None


def _census():
    """(JAX module, switch, whether the module reads it) for every PRT_*
    name of the JAX package."""
    out = []
    for rel, src in sorted(_sources(JAX_PKG).items()):
        for name in sorted(set(NAME.findall(src))):
            out.append((rel, name, _reads(src, name)))
    return out


CENSUS = _census()


@pytest.mark.parametrize("rel,name,reads", CENSUS,
                         ids=[f"{r}:{n}" for r, n, _ in CENSUS])
def test_every_switch_is_honoured_or_allowed(rel, name, reads):
    """The port's module of the same path reads the switch where the JAX
    module reads it, and names it where the JAX module only names it; or
    ALLOWED says why not."""
    if (rel, name) in ALLOWED:
        return
    path = os.path.join(REPO, PORT_PKG, rel)
    assert os.path.isfile(path), f"{rel}: the port has no such module"
    src = open(path).read()
    if reads:
        assert _reads(src, name), f"{PORT_PKG}/{rel} does not read {name}"
    else:
        assert name in src, f"{PORT_PKG}/{rel} does not name {name}"


def test_census_finds_the_reference_switches():
    """The walk sees the twelve switches the JAX package reads."""
    read = {name for _, name, reads in CENSUS if reads}
    assert read == {
        "PRT_GRAD_DEBUG", "PRT_MESH_ACCEL", "PRT_MESH_BLOCK",
        "PRT_MESH_CHUNK_TRIS", "PRT_MESH_DTYPE", "PRT_MESH_FORCE_XLA",
        "PRT_MESH_NOREL", "PRT_MESH_PRECISION", "PRT_MESH_TILE",
        "PRT_NO_NATIVE", "PRT_SCAN_CHUNK", "PRT_TERM_GRAPHICS"}


def test_allow_list_is_current():
    """Every ALLOWED entry is a switch its JAX module still has, that the
    port's module does not read, with a reason."""
    found = {(rel, name) for rel, name, _ in CENSUS}
    port = _sources(PORT_PKG)
    for (rel, name), why in ALLOWED.items():
        assert (rel, name) in found, (rel, name)
        assert not _reads(port.get(rel, ""), name), (rel, name)
        assert why


def _cotangent():
    g = np.arange(24, dtype=np.float32).reshape(4, 6)
    g[0, 1], g[2, 3], g[3, 5], g[1, 0] = np.nan, np.inf, -np.inf, np.nan
    return g


def test_grad_debug_reports_zeroed_cotangents(monkeypatch, capfd):
    """PRT_GRAD_DEBUG, read at each backward: the sanitizer prints the
    reference's line with the count of non-finite entries it zeroed (4 in
    a 4x6 leaf), the same line the JAX package prints; unset, nothing."""
    g = _cotangent()
    x = torch.ones(4, 6, requires_grad=True)
    (y,) = integrator._SanitizeGrad.apply(x)
    y.backward(torch.from_numpy(g))
    assert capfd.readouterr().out == ""
    np.testing.assert_array_equal(x.grad.numpy(), np.nan_to_num(
        g, nan=0.0, posinf=0.0, neginf=0.0))

    monkeypatch.setenv("PRT_GRAD_DEBUG", "1")
    x = torch.ones(4, 6, requires_grad=True)
    (y,) = integrator._SanitizeGrad.apply(x)
    y.backward(torch.from_numpy(g))
    port = capfd.readouterr().out
    assert port == ("sanitize_grad: zeroed 4 non-finite cotangents in 4x6 "
                    "leaf\n")
    _, vjp = jax.vjp(j_integrator._sanitize_grad, jnp.ones((4, 6)))
    (r,) = vjp(jnp.asarray(g))
    jax.effects_barrier()
    assert capfd.readouterr().out == port
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(r))


def test_no_native_runs_the_python_builds(monkeypatch):
    """PRT_NO_NATIVE, read at each call: the native library is not used,
    and the BVH build, the OBJ import and a whole scene load run the Python
    versions, bitwise the JAX package's under the same switch."""
    monkeypatch.setenv("PRT_NO_NATIVE", "1")
    assert native.get_lib() is None
    calls = []
    real = bvh_build.build_bvh_py

    def counted(tv):
        calls.append(tv.shape[0])
        return real(tv)
    monkeypatch.setattr(bvh_build, "build_bvh_py", counted)
    tv, tn = make_icosphere(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
    got = bvh_build.build_bvh(tv)
    assert calls == [tv.shape[0]]
    for a, b in zip(got, j_bvh.build_bvh(tv)):
        np.testing.assert_array_equal(a, b)
    path = os.path.join(REPO, "scenes", "assets", "icosphere.obj")
    v, n = obj.load_obj(path)
    vp, np_ = obj.load_obj_py(path)
    assert v.tobytes() == vp.tobytes() and n.tobytes() == np_.tobytes()
    mesh = (tv, tn)
    _, jsc = j_loader.load_scene("scenes/cornell.json", mesh_override=mesh)
    _, sc = loader.load_scene("scenes/cornell.json", mesh_override=mesh,
                              device="cpu")
    assert len(calls) == 2
    for name in ("bvh_nodes", "bvh_links", "tri_verts", "bf_feat"):
        assert getattr(sc, name).numpy().tobytes() == np.asarray(
            getattr(jsc, name)).tobytes(), name
