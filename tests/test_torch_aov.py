"""Debug AOVs: the port's render_aov in all five modes against the JAX
package's, its traversal metric (mesh_brute.ray_cluster_count, chunked)
bitwise, and the bvh branch's refusal.

mesh_id and traversal are integer facts of the hit (which object, how
many tiles) and must be bitwise; normal, albedo and depth within 1e-5.
Scenes: cornell_simple.json (no mesh), cornell.json with bench.py's
icosphere for its missing teapot (the mesh through K1's plain twin), and
sdf_demo.json (SDFs and a box).

Which triangle lands in which tile follows the BVH build's order, and the
JAX package builds with its native library or, where that library is
missing (it can lose a build race between test processes), with its
Python build, in another order.  So the mesh scene is loaded by the JAX
package with its Python build pinned (``PRT_NO_NATIVE``) and carried into
the port with ``scene_from_numpy``: both sides hold the same tables
whichever build either package would have taken.
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute as j_mb
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import RAY_INF
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

BENCH_ICOSPHERE = dict(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
SCENES = {"cornell_simple": None, "icosphere": BENCH_ICOSPHERE, "sdf_demo": None}
PATHS = {"cornell_simple": "scenes/cornell_simple.json",
         "icosphere": "scenes/cornell.json", "sdf_demo": "scenes/sdf_demo.json"}
SIZE = 24
BITWISE = ("mesh_id", "traversal")


@functools.cache
def _scenes(name):
    mesh = SCENES[name]
    path = PATHS[name]
    if mesh is None:
        jcfg, jsc = j_load(path)
        cfg, sc = load_scene(path, device="cpu")
        return jcfg, jsc, cfg, sc
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRT_NO_NATIVE", "1")  # the JAX package's Python build
        jcfg, jsc = j_load(path, mesh_override=make_icosphere(**mesh))
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    return jcfg, jsc, cfg, sc


@pytest.mark.parametrize("mode", pathtracer.AOV_MODES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_aov_matches_reference(name, mode, monkeypatch):
    """An SDF's normal is a central difference at 2e-5, which turns a
    last-bit difference of a distance or of the ray into ~1e-3 of the
    normal: the JAX package's jitted normals (XLA contracts its products
    into FMAs) differ from its own un-jitted ones by that much, and the two
    packages' camera rays differ in last bits.  The port's SDF arithmetic
    rounds as the un-jitted reference's does, so on sdf_demo the JAX
    package runs without jit, on the port's camera rays."""
    jcfg, jsc, cfg, sc = _scenes(name)
    with contextlib.ExitStack() as stack:
        if name == "sdf_demo":
            stack.enter_context(jax.disable_jit())
            px, py = pathtracer.pixel_grid(SIZE, SIZE, "cpu")
            rays = pathtracer.camera_rays_for_sample(
                default_camera(SIZE, SIZE).pytree("cpu"), SIZE, SIZE, px, py,
                py * SIZE + px, 0, 0, jitter=False)
            monkeypatch.setattr(j_pt, "camera_rays_for_sample",
                                lambda *a, **k: tuple(jnp.asarray(r.numpy())
                                                      for r in rays))
        want = np.asarray(j_pt.render_aov(jcfg, jsc,
                                          j_default_camera(SIZE, SIZE).pytree(),
                                          SIZE, SIZE, mode=mode))
    got = pathtracer.render_aov(cfg, sc, default_camera(SIZE, SIZE).pytree("cpu"),
                                SIZE, SIZE, mode=mode)
    assert got.shape == (SIZE, SIZE, 3) and got.dtype == torch.float32
    if mode in BITWISE:
        assert got.numpy().tobytes() == want.tobytes()
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if mode == "mesh_id" and cfg.has_mesh:  # the mesh is in the frame
        mesh_val = np.float32(cfg.n_objects + 1) / np.float32(cfg.n_objects + 2)
        assert (got[..., 0] == float(mesh_val)).any()
    if mode == "traversal" and cfg.has_mesh:
        assert float(got[..., 0].max()) == 1.0


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = 0.0  # axis-parallel and degenerate directions
    d[0, 0], d[1, 1], d[2, 2], d[3, 0], d[4, 1] = 1.0, -1.0, 1.0, -1e-13, 1e-13
    t = r.uniform(0.01, RAY_INF, n).astype(np.float32)
    return o, d, t


@pytest.mark.parametrize("chunk", [7, 64, 1 << 20])
def test_ray_cluster_count_bitwise(chunk, monkeypatch):
    """Counts over random rays (including axis-parallel and near-zero
    direction components) against the reference's broadcast, with a chunk
    smaller than N, one dividing it unevenly, and one chunk for all."""
    monkeypatch.setattr(mesh_brute, "CLUSTER_COUNT_CHUNK", chunk)
    jcfg, jsc, cfg, sc = _scenes("icosphere")
    o, d, t = _random_rays(300, 1)
    want = np.asarray(j_mb.ray_cluster_count(jsc.bf_clusters, jnp.asarray(o),
                                             jnp.asarray(d), jnp.asarray(t)))
    got = mesh_brute.ray_cluster_count(sc.bf_clusters, torch.from_numpy(o),
                                       torch.from_numpy(d), torch.from_numpy(t))
    assert got.dtype == torch.int32 and got.shape == (300,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < int(got.max()) <= sc.bf_clusters.shape[0]


def test_traversal_cost_without_mesh_is_zero():
    jcfg, jsc, cfg, sc = _scenes("cornell_simple")
    o, d, _ = _random_rays(16, 2)
    got = intersect.traversal_cost(cfg, sc, torch.from_numpy(o),
                                   torch.from_numpy(d))
    assert got.dtype == torch.int32 and not got.any()


def test_traversal_cost_bvh_branch_is_roadmap_m12():
    _, _, cfg, sc = _scenes("icosphere")
    o, d, _ = _random_rays(8, 3)
    with pytest.raises(NotImplementedError, match="M12"):
        intersect.traversal_cost(dataclasses.replace(cfg, mesh_accel="bvh"), sc,
                                 torch.from_numpy(o), torch.from_numpy(d))


def test_render_aov_refuses_unknown_mode():
    _, _, cfg, sc = _scenes("cornell_simple")
    with pytest.raises(ValueError):
        pathtracer.render_aov(cfg, sc, default_camera(4, 4).pytree("cpu"), 4, 4,
                              mode="uv")
