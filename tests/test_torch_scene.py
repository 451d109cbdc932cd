"""Scene loading: the port's SceneConfig/SceneData against the JAX package's.

Both packages build their BVH order with the same code here (the shared
native library when it builds, else the Python one in both), so the brute
tables must agree bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.scene import bvh_build as j_bvh
from photorealistic_rendering_using_opencl_tpu.scene import loader as j_loader
from photorealistic_rendering_using_opencl_tpu.scene.obj import (
    make_icosphere as j_icosphere,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene import bvh_build, loader
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import (
    load_obj_py, make_icosphere,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    SceneData, scene_from_numpy, scene_to_numpy,
)

torch.set_num_threads(2)

# every SceneData leaf the forward slice reads (the BVH-walk leaves wait
# for ROADMAP M12, the medium/env leaves for M11)
SLICE_LEAVES = (
    "color", "eta", "k", "roughness", "mat_type", "lobes", "dist",
    "position", "params", "geom_type", "quad_base", "quad_edge0",
    "quad_edge1", "quad_normal", "quad_area", "light_indices",
    "bf_feat", "bf_clusters", "bf_tri_verts", "bf_tri_normals",
    "obj_color", "obj_eta", "obj_k", "obj_roughness", "obj_mat_type",
    "obj_lobes", "obj_dist", "phase_g",
)
# ignored by the port (a TPU-kernel backstop in the reference)
IGNORED_CFG = ("mesh_second_pass",)

CASES = {
    "cornell_simple": ("scenes/cornell_simple.json", None),
    "cornell_icosphere": ("scenes/cornell.json",
                          dict(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scene_leaves_bitwise(case):
    path, mesh = CASES[case]
    mesh_np = None if mesh is None else j_icosphere(**mesh)
    jcfg, jsc = j_loader.load_scene(path, mesh_override=mesh_np)
    cfg, sc = loader.load_scene(path, mesh_override=mesh_np, device="cpu")
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
    import json
    with open("scenes/cornell_simple.json") as fh:
        doc = json.load(fh)
    for k, v in doc_patch.items():
        doc["scene"][k] = doc["scene"].get(k, []) + v
    with pytest.raises(NotImplementedError, match=item):
        loader.build_scene(doc, device="cpu")


def test_medium_and_big_mesh_raise():
    import json
    with open("scenes/cornell_simple.json") as fh:
        doc = json.load(fh)
    with pytest.raises(NotImplementedError, match="M11"):
        loader.build_scene(dict(doc, global_medium={"density": 0.1}),
                           device="cpu")
    big = (np.zeros((262145, 3, 3), np.float32),
           np.zeros((262145, 3, 3), np.float32))
    with pytest.raises(NotImplementedError, match="M12"):
        loader.build_scene(doc, mesh_override=big, device="cpu")


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
