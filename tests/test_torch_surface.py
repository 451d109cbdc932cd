"""The census of the JAX package's surface: every top-level public function,
class and constant of each JAX module has a namesake in the port's module of
the same path, or an entry in ALLOWED that names what stands in for it, or
says why the port has no use for it.  The modules are read with ``ast``, so
nothing of either package is imported for the walk.

The names the census found missing and the port now has (``ops/math.py``'s
``length``, ``fmin3``, ``lerp``, ``select_rows``, ``BIG``, ``FOUR_PI``,
``SELECT_MAX_ROWS``; ``ops/intersect.py``'s ``OBJ_MESH_ID_OFFSET``;
``parallel/render.py``'s ``default_mesh`` and ``RAYS_AXIS``) are held to
the JAX functions below.
"""
import ast
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import intersect as j_intersect
from photorealistic_rendering_using_opencl_tpu.ops import math as j_math
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, math

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = "photorealistic_rendering_using_opencl_tpu"
PORT_PKG = JAX_PKG + "_torch"

# JAX module (path in the package) -> the port's modules that stand in for
# it, where the port has no module of the same path
MODULES = {
    "ops/pallas_kernels.py": ("ops/tonemap.py", "ops/compaction.py"),
}

# (JAX module, name) -> (the port's name in the module(s) above, or None
# where the port has no use for it; why)
ALLOWED = {
    ("ops/pallas_kernels.py", "tonemap_pallas"): (
        "tonemap", "K2's wrapper, csrc/tonemap.cu"),
    ("ops/pallas_kernels.py", "LANE"): (
        None, "the TPU's 128-lane vector width that the Pallas tiles "
              "follow; K2 and K3 size their CUDA blocks themselves"),
    ("ops/envmap.py", "jax_searchsorted_rows"): (
        "searchsorted_rows", "the same bisection without the jax prefix"),
    ("ops/mesh_brute.py", "uses_pallas"): (
        "uses_kernel", "K1 (CUDA) in place of the Pallas kernel"),
    ("ops/mesh_brute.py", "BLOCK"): (
        "RELEVANCE_BLOCK", "the Pallas kernel's ray block (PRT_MESH_BLOCK), "
                           "the reduced forms' relevance block; K1's rays a "
                           "CTA are BLOCK_RAYS in csrc/mesh_brute.cu"),
    ("ops/mesh_brute.py", "CHUNK_TRIS"): (
        None, "the Pallas kernel's VMEM chunk of triangles; K1 streams tiles "
              "of TILE triangles"),
    ("ops/mesh_brute.py", "MATMUL_PRECISION"): (
        None, "the TPU kernel's MXU precision; K1 tests in FP32 FMAs"),
    ("ops/mesh_brute.py", "ROW_TINIT"): (
        None, "a row of the TPU kernel's packed ray block; K1 takes t_init "
              "as an array of its own"),
    ("ops/mesh_brute.py", "ROW_ACTIVE"): (
        None, "a row of the TPU kernel's packed ray block; K1 takes active "
              "as an array of its own"),
    ("ops/mesh_brute.py", "ROW_ANYHIT"): (
        None, "a row of the TPU kernel's packed ray block; K1 takes any_hit "
              "as an array of its own"),
    ("ops/mesh_brute.py", "ROW_EXCLUDE"): (
        None, "a row of the TPU kernel's packed ray block; K1 takes the "
              "excluded triangle as an array of its own"),
    ("ops/intersect.py", "TRAVERSE_CHUNK"): (
        None, "the lanes of one XLA while_loop of the walk; W1 and its twin "
              "take the whole batch"),
    ("scene/types.py", "tree_flatten_scene"): (
        None, "JAX pytree registration; the port's SceneData is a dataclass "
              "walked by dataclasses.fields"),
    ("scene/types.py", "tree_unflatten_scene"): (
        None, "JAX pytree registration; the port rebuilds a scene with "
              "dataclasses.replace"),
    ("models/integrator.py", "tag_hit"): (
        None, "names hits for jax.checkpoint's policy; the port's checkpoint "
              "boundary is the detached dispatch (pathtracer.HitTape)"),
    ("utils/profiling.py", "xla_trace"): (
        "torch_trace", "a torch.profiler scope in place of jax.profiler's"),
}


def _public(path):
    """The top-level public functions, classes and assigned names of the
    module at ``path``, and every name it binds."""
    tree = ast.parse(open(path).read())
    public, bound = [], set()
    for node in tree.body:
        names = []
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names = [node.name]
            public += [node.name]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            public += names
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [(a.asname or a.name).split(".")[0] for a in node.names]
        bound.update(names)
    return [n for n in public if not n.startswith("_")], bound


def _jax_modules():
    root = os.path.join(REPO, JAX_PKG)
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


def _port_bound(rel):
    bound = set()
    for port_rel in MODULES.get(rel, (rel,)):
        path = os.path.join(REPO, PORT_PKG, port_rel)
        assert os.path.isfile(path), f"{rel}: the port has no {port_rel}"
        bound |= _public(path)[1]
    return bound


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_a_counterpart(rel):
    """Each public name of the JAX module is bound in the port's module
    (defined there, or imported into it), or ALLOWED names the port's
    counterpart (which must exist) or the reason the port has none."""
    names, _ = _public(os.path.join(REPO, JAX_PKG, rel))
    bound = _port_bound(rel)
    missing = []
    for name in names:
        if name in bound:
            continue
        allowed = ALLOWED.get((rel, name))
        if allowed is None:
            missing.append(name)
        elif allowed[0] is not None:
            assert allowed[0] in bound, (rel, name, allowed)
    assert not missing, f"{rel}: no counterpart in the port for {missing}"


def test_allow_list_is_current():
    """Every ALLOWED entry names a public name its JAX module still has,
    that the port does not bind under the same name, with a reason."""
    for (rel, name), (_, why) in ALLOWED.items():
        names, _ = _public(os.path.join(REPO, JAX_PKG, rel))
        assert name in names, (rel, name)
        assert name not in _port_bound(rel), (rel, name)
        assert why


def _rng_vecs(n=257, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v[:3] = 0.0
    return v


# length's square root: PyTorch's vectorised float32 sqrt on the CPU is
# not correctly rounded (ROADMAP F14, about one input in 160 a last bit
# off), so length is held within one float32 ulp; its dot is bitwise
@pytest.mark.parametrize("name,rtol", [("length", 2.0 ** -23), ("fmin3", 0.0)])
def test_vector_helpers_match_jax(name, rtol):
    v = _rng_vecs()
    got = getattr(math, name)(torch.from_numpy(v)).numpy()
    want = np.asarray(getattr(j_math, name)(jnp.asarray(v)))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0)


def test_lerp_matches_jax():
    rng = np.random.default_rng(1)
    a, b, w = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(3))
    got = math.lerp(*(torch.from_numpy(x) for x in (a, b, w))).numpy()
    want = np.asarray(j_math.lerp(*(jnp.asarray(x) for x in (a, b, w))))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1,), (5,), (5, 3), (24, 4)])
def test_select_rows_matches_jax(shape):
    """Row by row, with out-of-range indices taking row 0, as JAX's."""
    rng = np.random.default_rng(2)
    arr = rng.normal(size=shape).astype(np.float32)
    idx = rng.integers(-2, shape[0] + 2, size=300).astype(np.int32)
    got = math.select_rows(torch.from_numpy(arr), torch.from_numpy(idx))
    want = np.asarray(j_math.select_rows(jnp.asarray(arr), jnp.asarray(idx)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32


def test_constants_match_jax():
    for name in ("BIG", "FOUR_PI", "SELECT_MAX_ROWS", "EPS", "RAY_INF"):
        assert float(getattr(math, name)) == float(getattr(j_math, name)), name
    assert intersect.OBJ_MESH_ID_OFFSET == j_intersect.OBJ_MESH_ID_OFFSET


def test_default_mesh_is_the_rays_mesh(tmp_path):
    """``parallel.render.default_mesh`` on a 1-rank gloo group: the
    reference's 1-D mesh, axis ``RAYS_AXIS``, one device a rank."""
    from photorealistic_rendering_using_opencl_tpu.parallel import render as j_render
    from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed, render
    assert render.RAYS_AXIS == j_render.RAYS_AXIS
    j_mesh = j_render.default_mesh(j_render.jax.devices()[:1])
    distributed.initialize("file://" + str(tmp_path / "store"), 1, 0,
                           device="cpu")
    try:
        mesh = render.default_mesh("cpu")
        assert mesh.mesh_dim_names == tuple(j_mesh.axis_names)
        assert mesh.size() == j_mesh.size == 1
    finally:
        torch.distributed.destroy_process_group()
