"""The reference's ray sort in the port: ``intersect.ray_sort_key`` against
the JAX package's key, the sorted dispatch against the unsorted one and
against JAX with its sort on, and the loader's ``mesh_sort_rays``.

The port sorts only where K1 runs (``mesh_brute.uses_kernel``), as the
reference sorts only for its TPU kernel (``mesh_brute.uses_pallas``); both
gates are forced open here, so the sort runs in front of the plain twins
on the CPU, the way tests/test_mesh_brute.py's
test_ray_sorting_is_result_invariant does it for JAX.  Every selection
output must be bitwise equal.
"""
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import intersect as j_isect
from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute as j_mb
from photorealistic_rendering_using_opencl_tpu.scene import loader as j_loader
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.scene import loader
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import scene_from_numpy

torch.set_num_threads(2)

# tests/test_mesh_brute.py's sort-invariance scene: a light over an icosphere
DOC = {"settings": {"MAX_BOUNCES": 2},
       "scene": {"spheres": [
           {"pos": [0.0, 3.0, 0.0], "radius": 0.5,
            "material": {"color": [5.0, 5.0, 5.0], "type": 0}}]}}
MESH = dict(subdiv=2, radius=0.9, center=(0.0, 0.5, 0.0))
CAMERA = np.array([0.0, 4 * np.sin(0.3), 4 * np.cos(0.3)], np.float32)


@jax.jit
def _reference_key(o_sg, d_sg, cl):
    """photorealistic_rendering_using_opencl_tpu/ops/intersect.py:591-604,
    the expression of the reference's mesh_closest -> (key, perm)."""
    lo = jnp.min(cl[:, 0:3], axis=0)
    hi = jnp.max(jnp.where(cl[:, 3:6] > -1e37, cl[:, 3:6],
                           lo[None]), axis=0)
    cell = jnp.clip(((o_sg - lo) / jnp.maximum(hi - lo, 1e-6)
                     * 31.0).astype(jnp.int32), 0, 31)
    octant = ((d_sg[:, 0] < 0).astype(jnp.int32)
              | ((d_sg[:, 1] < 0).astype(jnp.int32) << 1)
              | ((d_sg[:, 2] < 0).astype(jnp.int32) << 2))
    key = ((octant << 15) | (cell[:, 0] << 10)
           | (cell[:, 1] << 5) | cell[:, 2])
    return key, jnp.argsort(key)


@pytest.fixture(autouse=True)
def _no_reference_native(monkeypatch):
    """The JAX package's loaders take their Python BVH code here: its
    native library compiles to one shared temporary file, and a test that
    compiles it while another process does can leave that process without
    it (ROADMAP F7).  The port's loader keeps its own native library."""
    monkeypatch.setenv("PRT_NO_NATIVE", "1")


@pytest.fixture(scope="module")
def scenes():
    """(JAX cfg, JAX scene, port cfg, port scene) of DOC + MESH, brute."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PRT_NO_NATIVE", "1")  # see _no_reference_native
        jcfg, jsc = j_loader.build_scene(DOC,
                                         mesh_override=make_icosphere(**MESH))
    jcfg = dataclasses.replace(jcfg, mesh_accel="brute")
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    return jcfg, jsc, cfg, sc


def _rays(pop, n, seed, clusters):
    """Rays of one population: random rays around the mesh, camera rays
    from one origin (one cell), or random rays with some origins far
    outside the bounds, at +-inf and NaN (the cell's saturating edges)."""
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if pop == "camera":
        o = np.tile(CAMERA, (n, 1))
        d = r.uniform(-0.9, 0.9, (n, 3)).astype(np.float32) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return o, d.astype(np.float32)
    live = clusters[:, 0] < 1e37
    lo, hi = clusters[live, 0:3].min(0), clusters[live, 3:6].max(0)
    o = (lo + r.uniform(-0.5, 1.5, (n, 3)) * (hi - lo)).astype(np.float32)
    if pop == "edges":
        edge = np.array([1e30, -1e30, np.inf, -np.inf, np.nan, 3e9],
                        np.float32)
        o[::3, r.integers(0, 3)] = edge[r.integers(0, len(edge), o[::3].shape[0])]
    return o, d


@pytest.mark.parametrize("pop", ["random", "camera", "edges"])
def test_ray_sort_key_matches_reference(scenes, pop):
    _, jsc, _, sc = scenes
    cl = np.asarray(jsc.bf_clusters)
    o, d = _rays(pop, 3000, 5, cl)
    want_key, want_perm = _reference_key(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(cl))
    key = intersect.ray_sort_key(torch.from_numpy(o), torch.from_numpy(d),
                                 sc.bf_clusters)
    assert key.dtype == torch.int32
    np.testing.assert_array_equal(key.numpy(), np.asarray(want_key))
    perm = torch.sort(key, stable=True).indices
    np.testing.assert_array_equal(perm.numpy(), np.asarray(want_perm))
    if pop == "camera":  # one origin, one cell: only the octant varies
        assert np.unique(key.numpy() & 0x7FFF).size == 1


def test_stable_sort_keeps_lane_order():
    """Equal keys keep their lanes' order (torch.argsort does not promise
    it; the port's sort is stable like jnp.argsort)."""
    key = torch.from_numpy(np.random.default_rng(2).integers(
        0, 5, 20000).astype(np.int32))
    perm = torch.sort(key, stable=True).indices
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(key.numpy(), kind="stable"))
    for k in range(5):
        lanes = perm[key[perm] == k]
        assert bool((lanes[1:] > lanes[:-1]).all())


def _open_gates(monkeypatch):
    monkeypatch.setattr(mesh_brute, "uses_kernel", lambda x: True)
    monkeypatch.setattr(j_mb, "uses_pallas", lambda: True)


def test_sorted_intersect_scene_bitwise(scenes, monkeypatch):
    """intersect_scene with the sort on equals it with the sort off (tri,
    t, mesh_id bitwise), and the JAX package's with its sort on: tri and
    mesh_id bitwise, t, re-derived from the winner by each package's own
    arithmetic, within tests/test_torch_trace.py's 1e-6."""
    _open_gates(monkeypatch)
    jcfg, jsc, cfg, sc = scenes
    o, d = _rays("random", 700, 9, np.asarray(jsc.bf_clusters))
    act = np.random.default_rng(4).uniform(size=700) > 0.1
    calls = {"sorted": 0}
    real_key = intersect.ray_sort_key

    def counted(*a):
        calls["sorted"] += 1
        return real_key(*a)

    monkeypatch.setattr(intersect, "ray_sort_key", counted)
    hits = {}
    for on in (False, True):
        hits[on] = intersect.intersect_scene(
            dataclasses.replace(cfg, mesh_sort_rays=on), sc,
            torch.from_numpy(o), torch.from_numpy(d),
            active=torch.from_numpy(act))
    assert calls["sorted"] == 1
    want = j_isect.intersect_scene(
        dataclasses.replace(jcfg, mesh_sort_rays=True), jsc, jnp.asarray(o),
        jnp.asarray(d), active=jnp.asarray(act))
    for f in ("tri", "t", "mesh_id"):
        got = getattr(hits[True], f).numpy()
        np.testing.assert_array_equal(got, getattr(hits[False], f).numpy(),
                                      err_msg=f)
        _assert_like_reference(f, got, np.asarray(getattr(want, f)))
    assert (hits[True].tri.numpy() >= 0).sum() > 50


def _assert_like_reference(name, got, want):
    if name == "t":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_sorted_merged_dispatch_bitwise(scenes, monkeypatch):
    """The merged closest + shadow batch (per-lane any-hit, per-segment
    exclude_tri) with the sort on equals it with the sort off and the JAX
    package's with its sort on, as above: tri, t, mesh_id and the
    occlusion flags; and shadow_visible (any-hit for the whole batch)
    likewise."""
    _open_gates(monkeypatch)
    jcfg, jsc, cfg, sc = scenes
    r = np.random.default_rng(21)
    n = 640
    tv = np.asarray(jsc.bf_tri_verts)
    n_live = int((np.abs(tv).sum(axis=(1, 2)) > 0).sum())
    tri = r.integers(0, n_live, n).astype(np.int32)
    uv = r.uniform(0, 1, (n, 2)).astype(np.float32)
    uv[uv.sum(1) > 1] = 1 - uv[uv.sum(1) > 1]
    v = tv[tri]
    o = (v[:, 0] * (1 - uv[:, 0:1] - uv[:, 1:2]) + v[:, 1] * uv[:, 0:1]
         + v[:, 2] * uv[:, 1:2]).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    to_light = np.array([0.0, 3.0, 0.0], np.float32) - o
    dist = np.linalg.norm(to_light, axis=1).astype(np.float32)
    ds = (to_light / dist[:, None]).astype(np.float32)
    dist = dist - 0.55  # stop short of the light's surface
    act = r.uniform(size=n) > 0.1
    act_s = r.uniform(size=n) > 0.2
    ex_c = np.where(r.uniform(size=n) < 0.8, tri, -1).astype(np.int32)
    ex_s = tri

    def port(on):
        c = dataclasses.replace(cfg, mesh_sort_rays=on)
        t = torch.from_numpy
        hit, vis = intersect.intersect_and_shadow(
            c, sc, t(o), t(d), t(act), [(t(o), t(ds), t(dist), t(act_s))],
            exclude_tri=[t(ex_c), t(ex_s)])
        sv = intersect.shadow_visible(c, sc, t(o), t(ds), t(dist),
                                      active=t(act_s), exclude_tri=t(ex_s))
        return ([getattr(hit, f).numpy() for f in ("tri", "t", "mesh_id")]
                + [vis[0].numpy(), sv.numpy()])

    jc = dataclasses.replace(jcfg, mesh_sort_rays=True)
    j = jnp.asarray
    jhit, jvis = j_isect.intersect_and_shadow(
        jc, jsc, j(o), j(d), j(act), [(j(o), j(ds), j(dist), j(act_s))],
        exclude_tri=[j(ex_c), j(ex_s)])
    jsv = j_isect.shadow_visible(jc, jsc, j(o), j(ds), j(dist),
                                 active=j(act_s), exclude_tri=j(ex_s))
    want = ([np.asarray(getattr(jhit, f)) for f in ("tri", "t", "mesh_id")]
            + [np.asarray(jvis[0]), np.asarray(jsv)])
    on, off = port(True), port(False)
    for name, a, b, w in zip(("tri", "t", "mesh_id", "visible",
                              "shadow_visible"), on, off, want):
        np.testing.assert_array_equal(a, b, err_msg=name)
        _assert_like_reference(name, a, w)
    assert 0 < (~on[3]).sum() < n and 0 < (~on[4]).sum() < n


SCENE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scenes")
SCENES = sorted(os.path.basename(p)
                for p in glob.glob(os.path.join(SCENE_DIR, "*.json")))


def test_scene_list_is_the_repos():
    """The loader-flag parity below runs on every scene of the repo's
    scenes/, wherever pytest is started from."""
    assert "cornell_hi.json" in SCENES and len(SCENES) > 5


@pytest.mark.parametrize("name", SCENES)
def test_loader_sort_flag_matches_reference(name):
    """mesh_sort_rays as the JAX loader sets it, on every scene both
    packages load offline; the port refuses SDFs and media (ROADMAP M10,
    M11), and neither finds cornell.json's teapot (F1)."""
    path = os.path.join(SCENE_DIR, name)
    try:
        jcfg, _ = j_loader.load_scene(path)
    except FileNotFoundError:
        with pytest.raises(FileNotFoundError):
            loader.load_scene(path, device="cpu")
        return
    try:
        cfg, _ = loader.load_scene(path, device="cpu")
    except NotImplementedError as e:
        assert any(item in str(e) for item in ("M10", "M11")), e
        return
    assert cfg.mesh_sort_rays == jcfg.mesh_sort_rays
    if name == "cornell_hi.json":
        assert cfg.mesh_sort_rays and cfg.n_triangles == 81920
