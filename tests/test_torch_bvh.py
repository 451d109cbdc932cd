"""The BVH walk (ROADMAP M12) on the CPU against the JAX package: the
device layout (``pack_for_device``, ``thread_octants``) bitwise, the walk's
plain twin (``intersect._bvh_traverse_chunk``) bitwise the reference's
``bvh_traverse`` / ``_bvh_traverse_chunk`` (t, tri, u, v and node visits),
renders through the walk, the CPU's backend rule, and a scene the JAX
package loads with the walk carried across.  W1, the walk's CUDA kernel, is
held against the twin in tests/test_torch_cuda.py.

XLA's CPU backend contracts the reference's crosses and 3-term dot
products into fused multiply-adds; the twin rounds the same operations
once (``ops/math.fma32``), and ``test_jax_walk_arithmetic_is_fma`` shows
the pattern it follows.
"""
import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops import intersect as j_isect
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.scene import bvh_build as j_bvh
from photorealistic_rendering_using_opencl_tpu.scene import loader as j_loader
from photorealistic_rendering_using_opencl_tpu.scene.obj import load_obj as j_load_obj
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops import intersect, mesh_brute
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.ops.math import fma32
from photorealistic_rendering_using_opencl_tpu_torch.scene import bvh_build, loader
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    scene_from_numpy, scene_to_numpy,
)

torch.set_num_threads(2)

WALK_MESH = dict(subdiv=4, radius=0.8, center=(0.1, -0.2, 0.3))  # 5,120


def _ragged_mesh(n=1280, seed=4):
    """A soup of ``n`` random triangles of random sizes: leaves of 1 to 3
    triangles (the padded slots in use), boxes that overlap."""
    r = np.random.default_rng(seed)
    c = r.uniform(-1.5, 1.5, (n, 1, 3))
    v = (c + r.normal(size=(n, 3, 3)) * r.uniform(0.01, 0.3, (n, 1, 1)))
    v = v.astype(np.float32)
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)
    return v, np.repeat(nrm[:, None], 3, axis=1).astype(np.float32)


MESHES = {
    "icosphere_hi": lambda: j_load_obj("scenes/assets/icosphere_hi.obj"),
    "ragged_1280": _ragged_mesh,
}


def _same_bits(got, want, name):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_pack_for_device_bitwise(mesh):
    """One FlatBVH (the JAX package's build) packed by both packages: node
    rows, leaf rows, the leaf-major tables and the eight octants' links."""
    tv, tn = MESHES[mesh]()
    bvh = j_bvh.build_bvh(tv)
    want = j_bvh.pack_for_device(bvh, tv, tn)
    got = bvh_build.pack_for_device(bvh_build.FlatBVH(*bvh), tv, tn)
    for name, a, b in zip(("nodes", "leaf_verts", "tri_verts", "tri_normals",
                           "links"), got, want):
        _same_bits(a, b, name)
    _same_bits(bvh_build.thread_octants(bvh_build.FlatBVH(*bvh)),
               j_bvh.thread_octants(bvh), "thread_octants")
    counts = bvh.prim_count[bvh.prim_count > 0]
    if mesh == "ragged_1280":
        assert set(np.unique(counts).tolist()) >= {1, 2, 3}


@pytest.fixture(scope="module")
def walk_scene():
    """cornell.json with a 5,120-triangle icosphere, loaded by the JAX
    package (the walk by its CPU rule) and carried across bit for bit."""
    mesh = make_icosphere(**WALK_MESH)
    jcfg, jsc = j_loader.load_scene("scenes/cornell.json", mesh_override=mesh)
    assert jcfg.mesh_accel == "bvh"
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    return jcfg, jsc, cfg, sc


def _rays(pop, jsc, n=1536):
    r = np.random.default_rng(("random", "camera", "surface").index(pop) + 7)
    if pop == "random":
        o = r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
        d = r.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[:6] = 0.0  # axis-parallel, signed-zero and zero directions
        d[0, 0], d[1, 1], d[2, 2], d[3, 0], d[4, 1] = 1.0, -1.0, -0.0, -1e-13, 1e-13
    elif pop == "camera":
        o = np.tile(np.array([0.0, 4 * np.sin(0.3), 4 * np.cos(0.3)],
                             np.float32), (n, 1))
        target = r.uniform(-1.0, 1.0, (n, 3)).astype(np.float32) * 0.9
        d = target - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    else:  # leaving a point on a triangle of the leaf-major table
        tv = np.asarray(jsc.tri_verts)
        live = np.nonzero(np.abs(tv).sum(axis=(1, 2)) > 0)[0]
        tri = r.choice(live, n)
        uv = r.uniform(0, 1, (n, 2)).astype(np.float32)
        flip = uv.sum(1) > 1
        uv[flip] = 1 - uv[flip]
        v = tv[tri]
        o = (v[:, 0] * (1 - uv[:, 0:1] - uv[:, 1:2]) + v[:, 1] * uv[:, 0:1]
             + v[:, 2] * uv[:, 1:2])
        d = r.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_init = np.full(n, 20.0, np.float32)
    t_init[::5] = r.uniform(0.05, 3.0, t_init[::5].shape)  # a cap
    any_hit = r.uniform(size=n) < 0.35
    active = r.uniform(size=n) < 0.85
    return (o.astype(np.float32), d.astype(np.float32), t_init, any_hit,
            active)


@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
def test_walk_twin_bitwise_reference(walk_scene, pop):
    """Closest and any-hit lanes mixed, inactive lanes, capped t_init: the
    twin's t, tri, u, v bitwise the reference's bvh_traverse, and its node
    visits bitwise the reference's _bvh_traverse_chunk(count_steps=True)."""
    jcfg, jsc, cfg, sc = walk_scene
    o, d, ti, ah, act = _rays(pop, jsc)
    j = jnp.asarray
    want = j_isect.bvh_traverse(jsc, j(o), j(d), j(ti), any_hit=j(ah),
                                active=j(act))
    want_steps = j_isect._bvh_traverse_chunk(jsc, j(o), j(d), j(ti), j(ah),
                                             j(act), count_steps=True)[4]
    t = torch.from_numpy
    got = intersect.bvh_traverse(sc, t(o), t(d), t(ti), any_hit=t(ah),
                                 active=t(act), count_steps=True)
    for name, a, b in zip(("t", "tri", "u", "v", "steps"), got,
                          list(want) + [want_steps]):
        _same_bits(a.numpy(), b, name)
    tri = got[1].numpy()
    assert (tri[~act] == -1).all() and (got[4].numpy()[~act] == 0).all()
    assert (tri >= 0).sum() > 50 and ((tri >= 0) & ah).sum() > 10


@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
def test_walk_twin_lanes_independent_of_batch(walk_scene, pop):
    """What W1's schedule rests on (any lane may walk any ray, at any
    time): each lane's t, tri, u, v and node visits from the twin are
    bitwise the same when the batch is permuted, or when a subset of it
    runs with every other lane made inactive (those return t_init, -1, 0,
    0 and no visit); the work counters add up over the lanes."""
    _, jsc, _, sc = walk_scene
    o, d, ti, ah, act = (torch.from_numpy(x) for x in _rays(pop, jsc))
    r = np.random.default_rng(("random", "camera", "surface").index(pop))
    full_c = torch.zeros(3, dtype=torch.int64)
    full = intersect.bvh_traverse(sc, o, d, ti, any_hit=ah, active=act,
                                  count_steps=True)
    intersect._bvh_traverse_chunk(sc, o, d, ti, ah, act, True, full_c)
    perm = torch.from_numpy(r.permutation(o.shape[0]))
    perm_c = torch.zeros(3, dtype=torch.int64)
    permuted = intersect._bvh_traverse_chunk(
        sc, o[perm], d[perm], ti[perm], ah[perm], act[perm], True, perm_c)
    for name, a, b in zip(("t", "tri", "u", "v", "steps"), full, permuted):
        _same_bits(a[perm].numpy(), b.numpy(), name)
    assert torch.equal(full_c, perm_c) and int(full_c[0]) == int(full[4].sum())
    subset = act & torch.from_numpy(r.uniform(size=o.shape[0]) < 0.3)
    part = intersect.bvh_traverse(sc, o, d, ti, any_hit=ah, active=subset,
                                  count_steps=True)
    for name, a, b in zip(("t", "tri", "u", "v", "steps"), full, part):
        _same_bits(a[subset].numpy(), b[subset].numpy(), name)
    rest = ~subset
    _same_bits(part[0][rest].numpy(), ti[rest].numpy(), "t_init")
    assert (part[1][rest] == -1).all() and (part[4][rest] == 0).all()
    assert not part[2][rest].any() and not part[3][rest].any()


def test_mesh_closest_through_the_walk(walk_scene):
    """mesh_closest's bvh branch returns the walk's winners and the
    leaf-major tables (no validation; exclude_tri ignored).  (The bvh
    traversal_cost is tests/test_torch_aov.py's.)"""
    jcfg, jsc, cfg, sc = walk_scene
    o, d, ti, ah, act = _rays("camera", jsc, n=512)
    t = torch.from_numpy
    tm, tri, tv, tn = intersect.mesh_closest(
        cfg, sc, t(o), t(d), t(ti), any_hit=t(ah), active=t(act),
        exclude_tri=torch.zeros(512, dtype=torch.int32))
    jtm, jtri, jtv, _ = j_isect.mesh_closest(
        jcfg, jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(ti),
        any_hit=jnp.asarray(ah), active=jnp.asarray(act))
    _same_bits(tm.numpy(), jtm, "t")
    _same_bits(tri.numpy(), jtri, "tri")
    assert tv is sc.tri_verts and tn is sc.tri_normals


def test_jax_walk_arithmetic_is_fma():
    """Why the twin rounds its crosses and dot products as FMAs: XLA's CPU
    backend compiles the reference's jnp.cross and 3-term jnp.sum that way
    (the separately rounded (x0 + x1) + x2 differs on many lanes), and
    fma32 is a correctly rounded fma, also where a float64 sum would round
    twice."""
    r = np.random.default_rng(3)
    a = r.normal(size=(20000, 3)).astype(np.float32)
    b = r.normal(size=(20000, 3)).astype(np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    dot = np.asarray(jax.jit(lambda x, y: jnp.sum(x * y, axis=-1))(a, b))
    cross = np.asarray(jax.jit(jnp.cross)(a, b))
    _same_bits(intersect._fma_dot(ta, tb).numpy(), dot, "dot")
    _same_bits(intersect._fma_cross(ta, tb).numpy(), cross, "cross")
    p = a * b
    assert ((p[:, 0] + p[:, 1]) + p[:, 2] != dot).sum() > 1000
    # exact 1 + 2^-24 + 2^-70: a float64 sum rounds it to the float32
    # midpoint 1 + 2^-24, which then rounds to even, 1.0; one rounding
    # gives 1 + 2^-23 (and symmetrically downward)
    x = torch.tensor([2.0**-12 * (1 + 2.0**-23)] * 2, dtype=torch.float32)
    y = torch.tensor([-(2.0**-12) * (1 - 2.0**-23), 2.0**-12 * (1 - 2.0**-23)],
                     dtype=torch.float32)
    z = torch.tensor([1 + 2.0**-23, -(1 + 2.0**-23)], dtype=torch.float32)
    naive = (x.double() * y.double() + z.double()).float()
    assert naive.tolist() == [1.0, -1.0]
    assert fma32(x, y, z).tolist() == [1 + 2.0**-23, -(1 + 2.0**-23)]


def test_render_backends_identical():
    """The twin of tests/test_mesh_brute.py::test_render_backends_identical:
    the brute backend and the walk give bitwise the same image."""
    mesh = make_icosphere(subdiv=1, radius=0.6, center=(0.0, -1.0, 0.0))
    cfg, scene = loader.load_scene("scenes/cornell.json", mesh_override=mesh,
                                   device="cpu")
    assert cfg.mesh_accel == "brute"
    cam = default_camera(32, 32).pytree("cpu")
    img_b, _ = pathtracer.render(cfg, scene, cam, 32, 32, 1, seed=3,
                                 method="regen")
    cfg_v = dataclasses.replace(cfg, mesh_accel="bvh")
    img_v, _ = pathtracer.render(cfg_v, scene, cam, 32, 32, 1, seed=3,
                                 method="regen")
    assert torch.equal(img_b, img_v) and img_b.abs().sum() > 0


@pytest.mark.parametrize("n_tris, accel", [(2048, "brute"), (2049, "bvh")])
def test_cpu_pick_rule_matches_reference(n_tris, accel, monkeypatch):
    """On the CPU the port picks the reference's backend (brute up to 2,048
    triangles), and PRT_MESH_ACCEL overrides it in both packages; the
    card's rule is the measured crossover (the walk at every size)."""
    monkeypatch.delenv("PRT_MESH_ACCEL", raising=False)
    mesh = _ragged_mesh(n_tris, seed=n_tris)
    with open("scenes/cornell_simple.json") as fh:
        doc = json.load(fh)
    jcfg, _ = j_loader.build_scene(doc, mesh_override=mesh)
    cfg, _ = loader.build_scene(doc, mesh_override=mesh, device="cpu")
    assert cfg.mesh_accel == jcfg.mesh_accel == accel
    for forced in ("brute", "bvh"):
        monkeypatch.setenv("PRT_MESH_ACCEL", forced)
        assert loader._pick_mesh_accel(n_tris, torch.device("cpu")) == forced
        assert loader._pick_mesh_accel(n_tris,
                                       torch.device("cuda")) == forced
        assert j_loader._pick_mesh_accel(n_tris) == forced
    monkeypatch.delenv("PRT_MESH_ACCEL")
    for n in (1, n_tris):
        assert loader._pick_mesh_accel(n, torch.device("cuda")) == "bvh"


def test_brute_tables_stop_at_k1_limit(monkeypatch):
    """Past BRUTE_STREAM_MAX_TRIS the loader packs only the walk's tables:
    the walk renders the mesh, and the brute backend, forced, raises
    rather than miss every triangle."""
    monkeypatch.setattr(mesh_brute, "BRUTE_STREAM_MAX_TRIS", 100)
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
    cfg, sc = loader.load_scene("scenes/cornell.json", mesh_override=mesh,
                                device="cpu")
    assert cfg.n_triangles == 320 and sc.bf_tri_verts.shape[0] < 320
    assert sc.tri_verts.shape[0] >= 320
    cam = default_camera(8, 8).pytree("cpu")
    c = dataclasses.replace(cfg, max_bounces=2, mesh_accel="bvh")
    img, _ = pathtracer.render(c, sc, cam, 8, 8, 1, method="regen")
    assert img.abs().sum() > 0
    with pytest.raises(ValueError, match="brute backend carries at most"):
        pathtracer.render(dataclasses.replace(c, mesh_accel="brute"), sc,
                          cam, 8, 8, 1, method="regen")


def test_reference_bvh_scene_renders_to_reference(monkeypatch):
    """A scene the JAX package loads with mesh_accel="bvh" (its
    PRT_MESH_ACCEL override; the suite's 4-bounce mesh scene, cornell.json
    with bench.py's icosphere), carried across by scene_from_numpy, renders
    to the reference's image at 4 bounces within the suite's 1e-5, by regen
    and by scan.  (The 5,120-triangle scene: the next test.)"""
    monkeypatch.setenv("PRT_MESH_ACCEL", "bvh")
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
    jcfg, jsc = j_loader.load_scene("scenes/cornell.json", mesh_override=mesh)
    assert jcfg.mesh_accel == "bvh"
    jcfg = dataclasses.replace(jcfg, max_bounces=4)
    leaves = {f.name: np.asarray(getattr(jsc, f.name))
              for f in dataclasses.fields(jsc)}
    cfg, sc = scene_from_numpy(dataclasses.asdict(jcfg), leaves, "cpu")
    side, spp = 16, 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, _ = j_pt.render(jcfg, jsc, j_default_camera(side, side).pytree(),
                              side, side, spp, seed=4, method="regen")
    cam = default_camera(side, side).pytree("cpu")
    got, _ = pathtracer.render(cfg, sc, cam, side, side, spp, seed=4,
                               method="regen")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        scan, _ = pathtracer.render(cfg, sc, cam, side, side, spp, seed=4)
    np.testing.assert_allclose(scan.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert got.mean() > 0


# The 5,120-triangle scene at 4 bounces, 16^2 x 2 spp, seed 4: the
# reference is not one image there.  Its jitted render and its un-jitted
# one (jax.disable_jit) part by ~2.4e-5 of a value, because under jit XLA
# rewrites 1/sqrt (the Beckmann sample's cos theta, ops/microfacet.py)
# into an approximate rsqrt, and a grazing exit from the coat (cos ~0.05)
# magnifies that last bit ~1e3.  The port's CPU sqrt (PyTorch's vectorised
# one) is itself a last bit off on ~1 input in 160 (ops/math.py:sqrt_rn),
# so the port meets neither execution within 1e-5; with a correctly
# rounded sqrt it meets the un-jitted one.  Rounding only the Beckmann
# sample's 1/sqrt does that too, but it moves the port's CPU gradient of
# camera.focal_distance past chip_smoke.GRAD_SPREAD_4, so the port keeps
# PyTorch's sqrt there (ROADMAP F14, closed with the readings).  The bound
# on the jitted image: the reference's own spread, rounded up, which the
# test measures.
REFERENCE_JIT_SPREAD = 3e-5


def _rel_gap(a, b):
    """max |a - b| / (1 + |b|): the least tol with a within rtol = atol =
    tol of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def test_reference_bvh_scene_renders_to_reference_5120(walk_scene,
                                                       monkeypatch,
                                                       record_property):
    """The previous test on the 5,120-triangle scene (the reference's walk
    by its own CPU rule), carried across: the port's regen image within
    REFERENCE_JIT_SPREAD of the reference's jitted one, which is itself
    beyond 1e-5 but within REFERENCE_JIT_SPREAD of the reference's
    un-jitted image; the port with a correctly rounded float32 sqrt within
    the suite's 1e-5 of that un-jitted image; the scan image within 1e-5
    of the regen one.  (The un-jitted reference runs its brute backend,
    ~2x faster than its walk there; the port's two backends give bitwise
    one image on this scene, the next test.)"""
    jcfg, jsc, cfg, sc = walk_scene
    jcfg = dataclasses.replace(jcfg, max_bounces=4)
    cfg = dataclasses.replace(cfg, max_bounces=4)
    side, spp = 16, 2
    jcam = j_default_camera(side, side).pytree()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, _ = j_pt.render(jcfg, jsc, jcam, side, side, spp, seed=4,
                              method="regen")
        with jax.disable_jit():
            ieee, _ = j_pt.render(dataclasses.replace(jcfg,
                                                      mesh_accel="brute"),
                                  jsc, jcam, side, side, spp, seed=4,
                                  method="regen")
    cam = default_camera(side, side).pytree("cpu")
    got, _ = pathtracer.render(cfg, sc, cam, side, side, spp, seed=4,
                               method="regen")
    gaps = {"port_vs_jit": _rel_gap(got, want),
            "jit_vs_unjit": _rel_gap(want, ieee),
            "port_vs_unjit": _rel_gap(got, ieee)}
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda x: sqrt(x.double()).float()
                        if x.dtype == torch.float32 else sqrt(x))
    rounded, _ = pathtracer.render(cfg, sc, cam, side, side, spp, seed=4,
                                   method="regen")
    monkeypatch.undo()
    gaps["port_rounded_sqrt_vs_unjit"] = _rel_gap(rounded, ieee)
    for k, v in gaps.items():
        record_property(k, v)
    assert 1e-5 < gaps["jit_vs_unjit"] <= REFERENCE_JIT_SPREAD, gaps
    assert gaps["port_vs_jit"] <= REFERENCE_JIT_SPREAD, gaps
    assert gaps["port_rounded_sqrt_vs_unjit"] <= 1e-5, gaps
    with torch.no_grad():
        scan, _ = pathtracer.render(cfg, sc, cam, side, side, spp, seed=4)
    np.testing.assert_allclose(scan.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert got.mean() > 0


def test_walk_and_brute_agree_on_the_walk_scene(walk_scene):
    """On the 5,120-triangle scene, 4 bounces: the walk's image is bitwise
    the brute backend's."""
    _, _, cfg, sc = walk_scene
    cam = default_camera(16, 16).pytree("cpu")
    img = {}
    for accel in ("bvh", "brute"):
        c = dataclasses.replace(cfg, max_bounces=4, mesh_accel=accel)
        img[accel], _ = pathtracer.render(c, sc, cam, 16, 16, 2, seed=4,
                                          method="regen")
    assert torch.equal(img["bvh"], img["brute"])


def test_scene_to_numpy_keeps_walk_tables(walk_scene):
    """The walk's five tables leave and re-enter the port bit for bit."""
    _, jsc, _, sc = walk_scene
    back = scene_to_numpy(sc)
    for name in ("bvh_nodes", "bvh_links", "leaf_verts", "tri_verts",
                 "tri_normals"):
        _same_bits(back[name], getattr(jsc, name), name)
