"""Scene loading: the port's SceneConfig/SceneData against the JAX package's.

The brute tables follow the BVH build's triangle order, and the native and
the Python builds order triangles differently.  The JAX package takes its
Python build wherever its native library is missing, which happens when
that library loses a build race between test processes.  So each mesh
comparison pins the BVH build on both sides: both native (the JAX package's
library loaded again if it lost the race) or both Python.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.scene import bvh_build as j_bvh
from photorealistic_rendering_using_opencl_tpu.scene import loader as j_loader
from photorealistic_rendering_using_opencl_tpu.runtime import native as j_native
from photorealistic_rendering_using_opencl_tpu.scene.obj import (
    make_icosphere as j_icosphere,
)
from photorealistic_rendering_using_opencl_tpu_torch.runtime import native as p_native
from photorealistic_rendering_using_opencl_tpu_torch.scene import bvh_build, loader
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import (
    load_obj_py, make_icosphere,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SceneData, scene_from_numpy, scene_to_numpy,
)

torch.set_num_threads(2)

# every SceneData leaf the port's render path reads but the environment
# map's sampling tables, which the port builds itself (held to a tolerance
# in tests/test_torch_envmap.py); the BVH walk's since ROADMAP M12
SLICE_LEAVES = (
    "tri_verts", "tri_normals", "bvh_nodes", "bvh_links", "leaf_verts",
    "color", "eta", "k", "roughness", "mat_type", "lobes", "dist",
    "position", "params", "geom_type", "quad_base", "quad_edge0",
    "quad_edge1", "quad_normal", "quad_area", "light_indices",
    "bf_feat", "bf_clusters", "bf_tri_verts", "bf_tri_normals",
    "obj_color", "obj_eta", "obj_k", "obj_roughness", "obj_mat_type",
    "obj_lobes", "obj_dist", "phase_g", "medium_sigma_a", "medium_sigma_s",
    "medium_sigma_t", "env_map",
)
# SceneConfig fields the port does not carry (none: mesh_second_pass is
# ported with the reduced-precision forms)
IGNORED_CFG = ()

CASES = {
    "cornell_simple": ("scenes/cornell_simple.json", None, {}),
    "cornell_icosphere": ("scenes/cornell.json",
                          dict(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0)),
                          {}),
    "sdf_demo": ("scenes/sdf_demo.json", None, {}),
    "cornell_media": ("scenes/cornell_media.json", None,
                      {"phase_function": "hg"}),
    "envmap": ("scenes/cornell_simple.json", None,
               {"env_map": np.random.default_rng(5).uniform(
                   0.0, 2.0, (8, 16, 3)).astype(np.float32),
                "phase_function": "rayleigh"}),
}


def pin_bvh_build(monkeypatch, build):
    """Both packages build BVHs the ``build`` way: "python" (the JAX
    package's PRT_NO_NATIVE, the port's library hidden) or "native" (the
    JAX package's library loaded again if a build race in another test
    process left it without one)."""
    if build == "python":
        monkeypatch.setenv("PRT_NO_NATIVE", "1")
        monkeypatch.setattr(p_native, "get_lib", lambda: None)
        return
    monkeypatch.delenv("PRT_NO_NATIVE", raising=False)
    if j_native.get_lib() is None:
        monkeypatch.setattr(j_native, "_lib_tried", False)
    assert j_native.get_lib() is not None, "the JAX package's native library"
    assert p_native.get_lib() is not None, "the port's native library"


@pytest.mark.parametrize("build", ["native", "python"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scene_leaves_bitwise(case, build, monkeypatch):
    path, mesh, kw = CASES[case]
    pin_bvh_build(monkeypatch, build)
    mesh_np = None if mesh is None else j_icosphere(**mesh)
    jcfg, jsc = j_loader.load_scene(path, mesh_override=mesh_np, **kw)
    cfg, sc = loader.load_scene(path, mesh_override=mesh_np, device="cpu",
                                **kw)
    jd, pd = dataclasses.asdict(jcfg), dataclasses.asdict(cfg)
    for k in jd:
        if k not in IGNORED_CFG:
            assert jd[k] == pd[k], k
    for name in SLICE_LEAVES:
        want = np.asarray(getattr(jsc, name))
        got = getattr(sc, name).numpy()
        assert got.dtype == want.dtype, name
        assert got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


def test_icosphere_matches_reference():
    for a, b in zip(make_icosphere(3, 0.8, (0.1, -0.2, 0.3)),
                    j_icosphere(3, 0.8, (0.1, -0.2, 0.3))):
        assert a.tobytes() == b.tobytes()


def test_python_bvh_build_matches_reference():
    tv, tn = make_icosphere(2, 0.7, (0.0, 0.8, 0.0))
    a = bvh_build.build_bvh_py(tv)
    b = j_bvh.build_bvh_py(tv)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(bvh_build.permute_triangles(tv, tn, a),
                    j_bvh.permute_triangles(tv, tn, b)):
        assert x.tobytes() == y.tobytes()


def test_obj_loader_reads_asset():
    from photorealistic_rendering_using_opencl_tpu.scene.obj import (
        load_obj_py as j_load_obj_py,
    )
    v, n = load_obj_py("scenes/assets/icosphere.obj")
    jv, jn = j_load_obj_py("scenes/assets/icosphere.obj")
    assert v.tobytes() == jv.tobytes() and n.tobytes() == jn.tobytes()


def test_scene_from_numpy_round_trips():
    mesh = j_icosphere(1, 0.7, (0.0, 0.8, 0.0))
    jcfg, jsc = j_loader.load_scene("scenes/cornell_simple.json",
                                    mesh_override=mesh)
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    back = scene_to_numpy(sc)
    assert set(back) == {f.name for f in dataclasses.fields(SceneData)}
    for name, want in leaves.items():
        assert back[name].dtype == want.dtype, name
        assert back[name].tobytes() == want.tobytes(), name


@pytest.mark.parametrize("doc_patch, item", [
    ({"sdfs": [{"type": 4, "params": [0.5]}]}, "M10"),
    ({"boxes": [{"pos": [0, 0, 0]}]}, "M10"),
    ({"spheres": [{"radius": 0.3, "material": {"type": 5}}]}, "M11"),
])
def test_unported_features_raise(doc_patch, item):
    """Scenes the port refused until ROADMAP ``item`` (SDFs and boxes M10,
    volume boundaries M11) was ported now load as the JAX package loads
    them: the same config and leaves.  (The name is the refusal test's.)"""
    with open("scenes/cornell_simple.json") as fh:
        doc = json.load(fh)
    for k, v in doc_patch.items():
        doc["scene"][k] = doc["scene"].get(k, []) + v
    jcfg, jsc = j_loader.build_scene(doc)
    cfg, sc = loader.build_scene(doc, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for name in SLICE_LEAVES:
        assert getattr(sc, name).numpy().tobytes() == \
            np.asarray(getattr(jsc, name)).tobytes(), name


def test_medium_and_big_mesh_raise():
    """A global medium (sigmas premultiplied by density, its type, the
    absorption-only flag), which the port refused until M11, loads as the
    JAX package loads it, and an unknown medium type raises; a mesh past
    the brute backend's limit, refused until ROADMAP M12, loads with the
    walk's tables (the brute ones stay empty: K1 cannot stream it).  (The
    name is the refusal test's.)"""
    with open("scenes/cornell_simple.json") as fh:
        doc = json.load(fh)
    for medium in ({"density": 0.1},
                   {"type": "exponential", "density": 0.4, "sigmaA": 0.1,
                    "sigmaS": 0.6},
                   {"density": 0.5, "sigmaA": 0.3, "sigmaS": 0.0}):
        jcfg, jsc = j_loader.build_scene(dict(doc, global_medium=medium))
        cfg, sc = loader.build_scene(dict(doc, global_medium=medium),
                                     device="cpu")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        for name in ("medium_sigma_a", "medium_sigma_s", "medium_sigma_t"):
            assert getattr(sc, name).numpy().tobytes() == \
                np.asarray(getattr(jsc, name)).tobytes(), name
    with pytest.raises(ValueError):
        loader.build_scene(dict(doc, global_medium={"type": "fog"}),
                           device="cpu")
    r = np.random.default_rng(9)
    tv = (r.uniform(-1.5, 1.5, (262145, 1, 3))
          + r.normal(size=(262145, 3, 3)) * 0.01).astype(np.float32)
    cfg, sc = loader.build_scene(doc, mesh_override=(tv, tv), device="cpu")
    assert cfg.n_triangles == 262145 and cfg.mesh_accel == "bvh"
    assert sc.tri_verts.shape[0] == 4 * sc.leaf_verts.shape[0] >= 262145
    assert sc.bvh_links.shape == (8 * cfg.n_bvh_nodes, 2)
    assert sc.bf_tri_verts.shape[0] < 262145


def _horizon_warnings(tmp_path, spheres):
    """Load a scene of ``spheres`` (a JSON file under tmp_path) with both
    packages -> (the reference warned, the port warned) about RAY_INF."""
    import json
    import warnings
    path = tmp_path / "scene.json"
    path.write_text(json.dumps({"settings": {"MAX_BOUNCES": 2},
                                "scene": {"spheres": spheres}}))
    warned = []
    for load in (j_loader.load_scene,
                 lambda p: loader.load_scene(p, device="cpu")):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            load(str(path))
        warned.append(any("RAY_INF" in str(w.message) for w in got))
    return tuple(warned)


def test_horizon_warning_in_bounds_scene(tmp_path):
    """A radius-0.1 sphere 8.5 units out and a radius-1 sphere at the
    origin: nothing reaches past 0.45 * RAY_INF = 9 (8.6 and 1), but the
    reference adds the largest coordinate to the largest radius (8.5 + 1 =
    9.5 > 9) and warns; the port, reach per object, does not."""
    from photorealistic_rendering_using_opencl_tpu_torch.ops.math import RAY_INF
    spheres = [{"pos": [8.5, 0.0, 0.0], "radius": 0.1},
               {"pos": [0.0, 0.0, 0.0], "radius": 1.0}]
    pos = np.array([s["pos"] for s in spheres])
    radius = np.array([s["radius"] for s in spheres])
    # the reference's formula (its scene/loader.py) and the true reach
    assert np.abs(pos).max() + np.abs(radius).max() > 0.45 * RAY_INF
    assert (np.linalg.norm(pos, axis=1) + radius).max() < 0.45 * RAY_INF
    assert _horizon_warnings(tmp_path, spheres) == (True, False)


def test_horizon_warning_far_scene(tmp_path):
    """A sphere reaching 10 units out (centre 9.5, radius 0.5), past
    0.45 * RAY_INF: both packages warn."""
    spheres = [{"pos": [0.0, 0.0, 9.5], "radius": 0.5},
               {"pos": [0.0, 1.0, 0.0], "radius": 0.3}]
    assert _horizon_warnings(tmp_path, spheres) == (True, True)
