"""K1's reduced-precision forms on the CPU: the plain version of the
tensor-core kernel (``mesh_brute.intersect_reduced_plain``) against the JAX
package's TPU kernel in interpret mode (the split forms) and its XLA path
(the bf16 table); ``mesh_intersect`` under every switch against the JAX
package's on the CPU; the switches' dispatch to the kernels (a stand-in
library); the fragments the kernel loads; and ``mesh_second_pass`` against
the JAX package's.  The kernel itself runs in tests/test_torch_cuda.py.

Winners must be equal; a lane may part only at a tie the test shows (both
candidates' scores within 2 float32 ulp), at most 1e-4 of a population.

A test that loads a scene in both packages makes both build its BVH the
same way (``same_bvh_build``): the native and the Python builders order
the triangles differently, and a test process can be without the JAX
package's native library (its build is shared by every process that
builds it at once, and a process that loses that race keeps none).
"""
import contextlib
import dataclasses
import os
import subprocess
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import intersect as j_isect
from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute as j_mb
from photorealistic_rendering_using_opencl_tpu.runtime import native as j_native
from photorealistic_rendering_using_opencl_tpu.scene import bvh_build as j_bvh
from photorealistic_rendering_using_opencl_tpu.scene import loader as j_loader
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.ops import (
    _cuda, intersect, mesh_brute,
)
from photorealistic_rendering_using_opencl_tpu_torch.runtime import native as p_native
from photorealistic_rendering_using_opencl_tpu_torch.scene import loader

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 700  # two whole relevance blocks of 256 rays and a padded tail
PAD_SLOTS = 80640  # degenerate slots before the mesh: indices to 81,919
TIE_SHARE = 1e-4


def same_bvh_build(monkeypatch):
    """Both packages build BVHs the same way for the rest of the test:
    natively when both native libraries load in this process, else both
    in Python (PRT_NO_NATIVE, which each package reads at every call)."""
    if j_native.get_lib() is None or p_native.get_lib() is None:
        monkeypatch.setenv("PRT_NO_NATIVE", "1")


def lose_jax_library(monkeypatch):
    """The JAX package's native library made unavailable in this process,
    as a process that lost its build race is left."""
    monkeypatch.setattr(j_native, "_lib_tried", True)
    monkeypatch.setattr(j_native, "_lib", None)


def _pack(pad=0):
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    order = j_bvh.build_bvh(tv).order
    tv, tn = tv[order], tn[order]
    if pad:
        z = np.zeros((pad, 3, 3), np.float32)
        tv, tn = np.concatenate([z, tv]), np.concatenate([z, tn])
    bp = j_mb.pack_brute(tv, tn)
    for a, b in zip(bp, mesh_brute.pack_brute(tv, tn)):
        assert a.tobytes() == b.tobytes()
    return bp


@pytest.fixture(scope="module")
def tables():
    return _pack()


def _pack_at(tile):
    """The port's tables of ``_pack``'s mesh at ``tile`` triangles a tile
    (bitwise the JAX package's: tests/test_torch_mesh_tile.py)."""
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    order = j_bvh.build_bvh(tv).order
    return mesh_brute.pack_brute(tv[order], tn[order], tile)


POPULATIONS = ("random", "camera", "surface")


def _lanes(pop, bp, n=N, seed=0):
    """One population: origins around the mesh (random), at the default
    camera (camera) or on a random triangle with that triangle excluded
    (surface), aimed at the mesh; every third lane any-hit, every seventh
    inactive; t_init values that are not bf16 values (20.3, 7.123456 and a
    uniform draw); the other lanes exclude random indices up to the table's
    last."""
    r = np.random.default_rng(POPULATIONS.index(pop) + 31 + seed)
    slots = bp.tri_verts.shape[0]
    live = np.nonzero(np.abs(bp.tri_verts).sum(axis=(1, 2)) > 0)[0]
    target = (np.array([0.1, -0.2, 0.3], np.float32)
              + r.uniform(-0.75, 0.75, (n, 3)).astype(np.float32))
    ex = r.integers(-1, slots, n).astype(np.int32)
    if pop == "random":
        o = r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    elif pop == "camera":
        o = np.tile(np.array([0.0, 4 * np.sin(0.3), 4 * np.cos(0.3)],
                             np.float32), (n, 1))
    else:
        ex = live[r.integers(0, live.size, n)].astype(np.int32)
        uv = r.uniform(0, 1, (n, 2)).astype(np.float32)
        uv[uv.sum(1) > 1] = 1 - uv[uv.sum(1) > 1]
        v = bp.tri_verts[ex]
        o = (v[:, 0] * (1 - uv[:, 0:1] - uv[:, 1:2]) + v[:, 1] * uv[:, 0:1]
             + v[:, 2] * uv[:, 1:2]).astype(np.float32)
        target = o + r.normal(size=(n, 3)).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_init = np.where(np.arange(n) % 4 == 0, 7.123456, 20.3).astype(np.float32)
    t_init[np.arange(n) % 4 == 2] = r.uniform(0.05, 3.0, (n + 1) // 4)
    anyh = np.arange(n) % 3 == 1
    act = np.arange(n) % 7 != 3
    return o, d, t_init, act, anyh, ex


def _jax(feat, bp, lanes, form):
    o, d, t_init, act, anyh, ex = lanes
    return j_mb._intersect_pallas(
        jnp.asarray(feat), jnp.asarray(bp.clusters), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_init), jnp.asarray(act),
        any_hit=jnp.asarray(anyh), exclude=jnp.asarray(ex), interpret=True)


def _plain(feat, bp, lanes, form, norel=False):
    t, tri = mesh_brute.intersect_reduced_plain(
        feat, torch.from_numpy(bp.clusters),
        *(torch.from_numpy(x) for x in lanes), form, norel=norel)
    return t.numpy(), tri.numpy()


def _scores(feat, bp, lanes, lane, tris, form):
    """Both candidates' scores (t, inf on a miss) on ``lane`` in ``form``,
    from the plain version run on that lane alone with every other
    triangle's coefficients zeroed."""
    out = []
    size = mesh_brute.table_tile(feat, bp.clusters)
    for tri in tris:
        if tri < 0:
            out.append(np.inf)
            continue
        one = torch.zeros_like(feat)
        tile, c = divmod(int(tri), size)
        cols = [tile * 4 * size + q * size + c for q in range(4)]
        one[:, cols] = feat[:, cols]
        lane_in = [x[lane:lane + 1] for x in lanes]
        lane_in[2] = np.full(1, 3e38, np.float32)  # no t_init cap
        lane_in[3] = np.ones(1, bool)
        lane_in[4] = np.zeros(1, bool)
        lane_in[5] = np.full(1, -1, np.int32)
        t, got = _plain(one, bp, lane_in, form, norel=True)
        out.append(float(t[0]) if got[0] >= 0 else np.inf)
    return out


def _assert_winners(feat, bp, lanes, form, got, want):
    """Winners equal, but at ties the test shows: both candidates' scores
    within 2 float32 ulp, on at most TIE_SHARE of the lanes (and none of
    the inactive ones)."""
    parted = np.nonzero(got != want)[0]
    assert parted.size <= TIE_SHARE * got.size, parted
    for lane in parted:
        assert lanes[3][lane], lane
        a, b = _scores(feat, bp, lanes, lane, (got[lane], want[lane]), form)
        assert np.isfinite(a) and np.isfinite(b), (lane, a, b)
        assert abs(a - b) <= 2 * np.spacing(np.float32(max(a, b))), \
            (lane, a, b)


def _check_against_pallas(feat_np, bp, lanes, form):
    jt, jtri = (np.asarray(x) for x in _jax(feat_np, bp, lanes, form))
    feat = torch.from_numpy(np.asarray(feat_np, np.float32))
    if form == "bf16":
        feat = feat.to(torch.bfloat16)
    t, tri = _plain(feat, bp, lanes, form)
    assert (jtri[~lanes[4]] >= 0).sum() > N // 10  # the rays do hit
    _assert_winners(feat, bp, lanes, form, tri, jtri)
    same = tri == jtri
    np.testing.assert_array_equal(t[same], jt[same])
    return t, tri


@pytest.mark.parametrize("pop", POPULATIONS)
@pytest.mark.parametrize("form", ["bf16x3", "bf16x6"])
def test_reduced_plain_matches_pallas(tables, monkeypatch, form, pop):
    """The split forms against the JAX package's TPU kernel in interpret
    mode under the same PRT_MESH_PRECISION name: winners, and t bitwise
    where they agree; a lane that misses returns t_init as the form
    rebuilds it, rounded by bf16x3's two parts, exact in bf16x6."""
    monkeypatch.setattr(j_mb, "_PRECISION_NAME", form)
    lanes = _lanes(pop, tables)
    t, tri = _check_against_pallas(tables.feat, tables, lanes, form)
    miss = (tri < 0) & (lanes[2] == np.float32(7.123456))
    assert miss.any()
    if form == "bf16x3":
        assert (t[miss] != lanes[2][miss]).all()
    else:
        np.testing.assert_array_equal(t[miss], lanes[2][miss])


def test_reduced_plain_matches_pallas_at_high_indices(monkeypatch):
    """The mesh behind 80,640 degenerate slots, so that its triangles are
    indices 80,640-81,919 (the reference's streamed chunks on the TPU
    side): the excluded triangles rebuilt from bf16x3's two parts."""
    bp = _pack(PAD_SLOTS)
    monkeypatch.setattr(j_mb, "_PRECISION_NAME", "bf16x3")
    lanes = _lanes("surface", bp)
    assert lanes[5].max() > 81000
    _check_against_pallas(bp.feat, bp, lanes, "bf16x3")


@pytest.mark.parametrize("pop", POPULATIONS)
def test_reduced_plain_bf16_matches_reference(tables, pop):
    """Form bf16 on the table cast to bf16: against the JAX package's XLA
    path on that table (closest winners, any-hit occlusion) and its TPU
    kernel in interpret mode (winners and t)."""
    lanes = _lanes(pop, tables)
    feat16 = jnp.asarray(tables.feat, jnp.bfloat16)
    jt, jtri = (np.asarray(x) for x in j_mb._intersect_xla(
        feat16, jnp.asarray(tables.clusters), *(jnp.asarray(x)
                                                for x in lanes[:4]),
        exclude=jnp.asarray(lanes[5])))
    feat = torch.from_numpy(tables.feat).to(torch.bfloat16)
    t, tri = _plain(feat, tables, lanes, "bf16")
    act, anyh = lanes[3], lanes[4]
    closest = act & ~anyh
    _assert_winners(feat, tables, lanes, "bf16", np.where(closest, tri, -1),
                    np.where(closest, jtri, -1))
    np.testing.assert_array_equal((tri >= 0)[act & anyh],
                                  (jtri >= 0)[act & anyh])
    _check_against_pallas(feat16, tables, lanes, "bf16")


@pytest.mark.parametrize("form", ["bf16", "bf16x3", "bf16x6"])
def test_reduced_plain_nonfinite_t_init_matches_pallas(tables, monkeypatch,
                                                       form):
    """t_init = inf, or a finite value past bf16's range, on every fifth
    lane: the control values meet the table's zero rows in the product, as
    in the JAX package's TPU kernel, so such a lane's quantities are NaN and
    it records no hit (the kernel gives it none, tests/test_torch_cuda.py);
    the other lanes keep their winners."""
    if form != "bf16":
        monkeypatch.setattr(j_mb, "_PRECISION_NAME", form)
    lanes = list(_lanes("camera", tables))
    odd = np.arange(N) % 5 == 0
    lanes[2] = np.where(odd, np.where(np.arange(N) % 2 == 0, np.inf, 3.4e38),
                        lanes[2]).astype(np.float32)
    feat = (jnp.asarray(tables.feat, jnp.bfloat16) if form == "bf16"
            else tables.feat)
    t, tri = _check_against_pallas(feat, tables, lanes, form)
    assert (tri[odd] == -1).all()


@pytest.mark.parametrize("n", [1, 2, 3])
def test_hi_lo_parts_match_reference(n):
    """The parts bitwise the reference's, and what they rebuild: two parts
    hold every integer up to 81,919 exactly but not an f32 t_init, three
    parts hold both."""
    r = np.random.default_rng(n)
    x = np.concatenate([
        r.normal(size=4096) * np.exp2(r.integers(-30, 30, 4096)),
        np.arange(81920), [3.14159274, 7.123456, 20.3, -1.0, 0.0]]
    ).astype(np.float32)
    got = mesh_brute.hi_lo_parts(torch.from_numpy(x), n)
    want = j_mb._hi_lo_parts(jnp.asarray(x), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                      np.asarray(w).view(np.int16))
    rebuilt = got[0].float()
    for part in got[1:]:
        rebuilt = rebuilt + part.float()
    ints = rebuilt[4096:4096 + 81920].numpy()
    pi = rebuilt[-5].item()
    if n >= 2:
        np.testing.assert_array_equal(ints, np.arange(81920, dtype=np.float32))
    if n == 2:
        assert pi != np.float32(3.14159274) and abs(pi - 3.141594) < 5e-7
    if n == 3:
        assert pi == np.float32(3.14159274)


NAMES = (None, "highest", "bf16x6", "bf16x3", "default")


@pytest.mark.parametrize("switch", [None, "PRT_MESH_NOREL",
                                    "PRT_MESH_FORCE_XLA"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_cpu_dispatch_matches_reference(tables, monkeypatch, name, dtype,
                                        switch):
    """On the CPU, under each PRT_MESH_PRECISION name (set in both
    packages), table dtype and run-time switch, ``mesh_intersect`` runs
    the reference's XLA path in both packages: the same winners, t within
    1e-6."""
    if name is not None:
        monkeypatch.setattr(j_mb, "_PRECISION_NAME", name)
        monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
    if switch:
        monkeypatch.setenv(switch, "1")
    lanes = _lanes("random", tables)
    o, d, t_init, act, anyh, ex = lanes
    jfeat = jnp.asarray(tables.feat,
                        jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    feat = torch.from_numpy(tables.feat)
    if dtype == "bf16":
        feat = feat.to(torch.bfloat16)
    jt, jtri = (np.asarray(x) for x in j_mb.mesh_intersect(
        jfeat, jnp.asarray(tables.clusters), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_init), jnp.asarray(act), any_hit=jnp.asarray(anyh),
        exclude=jnp.asarray(ex)))
    t, tri = mesh_brute.mesh_intersect(
        feat, torch.from_numpy(tables.clusters), *(torch.from_numpy(x)
                                                   for x in lanes[:3]),
        active=torch.from_numpy(act), any_hit=torch.from_numpy(anyh),
        exclude=torch.from_numpy(ex))
    t, tri = t.numpy(), tri.numpy()
    form = "bf16" if dtype == "bf16" else None
    if form is None:
        np.testing.assert_array_equal(tri, jtri)
    else:
        _assert_winners(feat, tables, lanes, form, tri, jtri)
    np.testing.assert_allclose(t, jt, rtol=1e-6, atol=0)


def test_precision_name_is_read_at_import():
    """PRT_MESH_PRECISION is read once, when the module is imported; an
    unknown name raises there, as the reference's dict lookup does; unset
    is the port's "highest"."""
    code = ("from photorealistic_rendering_using_opencl_tpu_torch.ops import "
            "mesh_brute as m; print(m._PRECISION_NAME)")
    env = {k: v for k, v in os.environ.items() if k != "PRT_MESH_PRECISION"}

    def run(value):
        e = dict(env) if value is None else dict(env, PRT_MESH_PRECISION=value)
        return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=e,
                              capture_output=True, text=True, timeout=120)
    for value, want in ((None, "highest"), ("bf16x3", "bf16x3")):
        res = run(value)
        assert res.returncode == 0, res.stderr
        assert res.stdout.split() == [want]
    res = run("bf16x9")
    assert res.returncode != 0 and "KeyError" in res.stderr


@pytest.mark.parametrize("name,dtype,form", [
    ("highest", torch.float32, None), ("bf16x6", torch.float32, "bf16x6"),
    ("bf16x3", torch.float32, "bf16x3"), ("default", torch.float32, "bf16"),
    ("highest", torch.bfloat16, "bf16"), ("bf16x6", torch.bfloat16, "bf16")])
def test_reduced_form_by_switch(monkeypatch, name, dtype, form):
    """The card's form: K1 (None) for highest on the f32 table, the split
    for bf16x3 / bf16x6, one bf16 pass for default; a bf16 table is form
    bf16 whatever the name (the reference's split is off for it)."""
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
    assert mesh_brute.reduced_form(torch.zeros(2, dtype=dtype)) == form


def test_uses_kernel_gate(monkeypatch):
    """True for tensors on the card, False on the CPU and, on the card,
    under PRT_MESH_FORCE_XLA (the reference's uses_pallas)."""
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert mesh_brute.uses_kernel(on_card)
    assert not mesh_brute.uses_kernel(torch.zeros(1))
    monkeypatch.setenv("PRT_MESH_FORCE_XLA", "1")
    assert not mesh_brute.uses_kernel(on_card)


class _FakeLibrary:
    """Stands in for ``_cuda.LIBRARY``: records each entry's name and
    arguments and reports success."""

    def __init__(self):
        self.calls = []

    def get(self):
        return self

    def __getattr__(self, name):
        if not name.startswith("prt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


@pytest.fixture
def fake_library(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(_cuda, "LIBRARY", lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda t: 0)
    monkeypatch.setattr(_cuda, "on_device", lambda t: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("norel", [False, True])
@pytest.mark.parametrize("name,dtype,entry,code,parts", [
    ("highest", torch.float32, "prt_mesh_brute", None, None),
    ("bf16x6", torch.float32, "prt_mesh_brute_tc", 2, 3),
    ("bf16x3", torch.float32, "prt_mesh_brute_tc", 1, 2),
    ("default", torch.float32, "prt_mesh_brute_tc", 0, 1),
    ("bf16x3", torch.bfloat16, "prt_mesh_brute_tc", 0, 1)])
def test_kernel_launch_by_switch(tables, fake_library, monkeypatch, name,
                                 dtype, entry, code, parts, norel):
    """What ``mesh_intersect`` launches on the card under each switch: the
    C entry, the form code, the fragments' parts and the NOREL flag (read
    at the call), each wrapper's count moving by one; tensors on the CPU
    and a stand-in library, so no card is needed."""
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", name)
    if norel:
        monkeypatch.setenv("PRT_MESH_NOREL", "1")
    o, d, t_init, act, anyh, ex = (torch.from_numpy(x)
                                   for x in _lanes("camera", tables, n=64))
    feat = torch.from_numpy(tables.feat).to(dtype)
    wrapper = (mesh_brute.mesh_brute_kernel if code is None
               else mesh_brute.mesh_brute_tc_kernel)
    before = wrapper.launches
    mesh_brute._launch(feat, torch.from_numpy(tables.clusters), o, d, t_init,
                       act, anyh, ex)
    assert wrapper.launches == before + 1
    [(called, args)] = fake_library.calls
    assert called == entry
    assert len(args) == len(_cuda._SIGNATURES[entry])
    assert args[-2] == int(norel)
    if code is not None:
        assert args[-3] == code
        frag = mesh_brute.form_fragments(feat, mesh_brute.reduced_form(feat))
        assert args[0] == frag.data_ptr() and frag.shape[0] == parts


def test_tc_wrapper_checks_the_image(tables, fake_library):
    """The wrapper takes the table image's shape ([parts, nt, tile / 2, 2,
    8, 8]) and nothing else (the old per-lane fragments, another part
    count, f32), and an image or boxes whose data start off a 16-byte
    boundary (the bulk copies' and the box loads' alignment) raise: no C
    call, no launch counted.  A ring stage is a whole number of 16-byte
    pieces and every kernel tile a whole number of stages.  (That the
    Python side's wgmma width and stage are the build's is checked on the
    card, by chip_smoke.py's tc_resources_log.)"""
    feat = torch.from_numpy(tables.feat)
    clusters = torch.from_numpy(tables.clusters)
    lanes = [torch.from_numpy(x) for x in _lanes("camera", tables, n=64)]
    nt = clusters.shape[0]
    frag = mesh_brute.form_fragments(feat, "bf16x3")
    assert frag.shape == (2, nt, 64, 2, 8, 8)
    wrapper = mesh_brute.mesh_brute_tc_kernel
    before = wrapper.launches
    old = torch.zeros(2, nt, 8, 4, 32, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="frag"):
        wrapper(old, clusters, *lanes, "bf16x3")
    with pytest.raises(ValueError, match="frag"):
        wrapper(frag, clusters, *lanes, "bf16x6")
    with pytest.raises(TypeError, match="frag"):
        wrapper(frag.float(), clusters, *lanes, "bf16x3")
    base = torch.zeros(frag.numel() + 8, dtype=torch.bfloat16)
    off = base[1:1 + frag.numel()].view(frag.shape)
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        wrapper(off, clusters, *lanes, "bf16x3")
    boxes = torch.zeros(clusters.numel() + 1)
    off_boxes = boxes[1:].view(clusters.shape).copy_(clusters)
    with pytest.raises(ValueError, match="16-byte"):
        wrapper(frag, off_boxes, *lanes, "bf16x3")
    assert wrapper.launches == before and not fake_library.calls
    wrapper(frag, clusters, *lanes, "bf16x3")
    [(name, args)] = fake_library.calls
    assert name == "prt_mesh_brute_tc" and args[0] == frag.data_ptr()
    assert args[1:4] == (nt, 128, mesh_brute.RELEVANCE_BLOCK)
    assert wrapper.launches == before + 1
    stage_bytes = mesh_brute.TC_STAGE_TRIS * mesh_brute.TC_TRI_BYTES
    assert stage_bytes % 16 == 0
    assert all(t % mesh_brute.TC_STAGE_TRIS == 0
               for t in mesh_brute.KERNEL_TILES)
    assert frag[0, 0].numel() * 2 == 128 * mesh_brute.TC_TRI_BYTES


@pytest.mark.parametrize("dtype,parts", [(torch.float32, 3),
                                         (torch.float32, 1),
                                         (torch.bfloat16, 1)])
def test_fragments_hold_the_table_parts(tables, dtype, parts):
    """Every column of the table image rebuilt from its two core matrices
    ([column // 8][feature // 8][column % 8][feature % 8], the kernel's
    K-major shared-memory slabs) is its part's table column of the
    (triangle, quantity) that ``tc_column_map`` gives it, and each tile's
    4 x 128 (triangle, quantity) pairs are held by exactly one column."""
    feat = torch.from_numpy(tables.feat).to(dtype)
    frag = mesh_brute.tc_fragments(feat, parts)
    nt = tables.clusters.shape[0]
    assert frag.shape == (parts, nt, 64, 2, 8, 8)
    assert frag.dtype == torch.bfloat16 and frag.is_contiguous()
    cols = frag.permute(0, 1, 2, 4, 3, 5).reshape(parts, nt, 512, 16)
    tri, q = mesh_brute.tc_column_map(128)
    src = feat if dtype == torch.bfloat16 else feat.float()
    for p, part in enumerate(mesh_brute.hi_lo_parts(src, parts)):
        want = part.reshape(16, nt, 4 * 128)[:, :, q * 128 + tri]
        assert torch.equal(cols[p].view(torch.int16),
                           want.permute(1, 2, 0).contiguous()
                           .view(torch.int16))
    assert len(set(zip(tri.tolist(), q.tolist()))) == 512
    assert sorted(set(tri.tolist())) == list(range(128))


def _wgmma_emulation(feat, clusters, lanes, form, tile):
    """The kernel's arithmetic for one warpgroup of 64 rays, emulated in
    float64: A from the rays' parts as the kernel builds it, B from the
    table image a stage and wgmma slab at a time, D = sum over the form's
    terms of A_j . B_i, each thread's registers d[8m + 2r + {0, 1, 4, 5}]
    read through ``tc_accumulator_map`` -> (the quantities the kernel tests
    together [tile, stage, slab, thread, m, r, 4], the (ray, column) each
    came from, the triangle index the kernel derives for them)."""
    n_col, stage = mesh_brute.TC_N, mesh_brute.TC_STAGE_TRIS
    terms = mesh_brute.FORM_TERMS[form]
    n_ray = max(j for _, j in terms) + 1
    f = mesh_brute._ray_features(lanes[0], lanes[1])[:64]
    if form == "bf16":
        a_parts = [f.to(torch.bfloat16).double()]
    else:
        a_parts = [x.double() for x in mesh_brute.hi_lo_parts(f, n_ray)]
    image = mesh_brute.tc_fragments(feat, mesh_brute.table_parts(form), tile)
    rows, cols = mesh_brute.tc_accumulator_map(n_col)
    thread = torch.arange(128)
    tig = thread % 4
    regs = torch.tensor([[[8 * m + 2 * r + e for e in (0, 1, 4, 5)]
                          for r in range(2)] for m in range(n_col // 16)])
    nt = clusters.shape[0]
    out = torch.empty(nt, tile // stage, stage * 4 // n_col, 128,
                      n_col // 16, 2, 4, dtype=torch.float64)
    tri_idx = torch.empty(out.shape[:-1], dtype=torch.int64)
    where = (rows[:, regs], cols[:, regs])  # [128, m, r, 4] each
    for j in range(nt):
        for s in range(tile // stage):
            for c in range(stage * 4 // n_col):
                c8 = s * stage // 2 + c * n_col // 8
                d = torch.zeros(64, n_col, dtype=torch.float64)
                for ti, tj in terms:
                    slab = image[ti, j, c8:c8 + n_col // 8]  # [c8, kh, r, k8]
                    b = slab.permute(1, 3, 0, 2).reshape(16, n_col).double()
                    d += a_parts[tj] @ b
                out[j, s, c] = d[where]
                m = torch.arange(n_col // 16)
                tri_idx[j, s, c] = (j * tile + s * stage + c * (n_col // 4)
                                    + 4 * m[None, :, None]
                                    + tig[:, None, None]).expand(-1, -1, 2)
    return out, where, tri_idx


@pytest.mark.parametrize("tile", [128, 256, 512])
@pytest.mark.parametrize("form", ["bf16", "bf16x3", "bf16x6"])
def test_wgmma_layout_emulated(form, tile):
    """The table image, wgmma's accumulator layout and the kernel's reads of
    it, emulated: the four registers a thread tests together hold den,
    t*den, u*den and v*den of one (ray, triangle) pair, ray 16w + g + 8r of
    the warpgroup and the triangle the kernel derives from (tile, stage,
    slab, m, tig), each equal to the plain version's product of the form's
    stacked parts (both summed in float64)."""
    bp = _pack_at(tile)
    feat = torch.from_numpy(bp.feat)
    clusters = torch.from_numpy(bp.clusters)
    lanes = [torch.from_numpy(x) for x in _lanes("camera", bp, n=64)]
    got, (rows, cols), tri_idx = _wgmma_emulation(feat, clusters, lanes,
                                                  form, tile)
    # the four registers: one row, and columns of one triangle, quantities
    # 0-3 in order (tc_column_map of the slab's columns)
    tri, q = mesh_brute.tc_column_map(mesh_brute.TC_N // 4)
    assert bool((rows == rows[..., :1]).all())
    thread = torch.arange(128)[:, None, None]
    r = torch.arange(2)[None, None, :]
    assert torch.equal(rows[..., 0], (16 * (thread // 32) + (thread % 32) // 4
                                      + 8 * r).expand_as(rows[..., 0]))
    assert bool((tri[cols] == tri[cols][..., :1]).all())
    assert torch.equal(q[cols], torch.arange(4).expand_as(cols))
    assert torch.equal(tri[cols][..., 0], (4 * torch.arange(
        mesh_brute.TC_N // 16)[None, :, None] + thread % 4).expand(-1, -1, 2))
    # the values: the plain version's stacked product at (ray, triangle)
    ray_f, table_a, _ = mesh_brute._form_operands(
        feat, mesh_brute._ray_pack(*lanes), form)
    want = ray_f[:64].double() @ table_a.double()  # [64, 4 * Tpad]
    c = tile
    col = ((tri_idx // c) * 4 * c)[..., None] + torch.arange(4) * c \
        + (tri_idx % c)[..., None]
    ray = rows.expand(got.shape[:3] + rows.shape)
    assert torch.allclose(got, want[ray, col], rtol=1e-12, atol=1e-12)
    assert int((got[..., 0] != 0).sum()) > 0


def test_fragments_are_made_once_per_table(tables):
    """``form_fragments`` keeps a table's fragments for each number of
    parts and makes them anew after the table changes in place."""
    feat = torch.from_numpy(tables.feat.copy())
    a = mesh_brute.form_fragments(feat, "bf16x6")
    assert mesh_brute.form_fragments(feat, "bf16x6") is a
    assert mesh_brute.form_fragments(feat, "bf16").shape[0] == 1
    feat.mul_(2.0)
    b = mesh_brute.form_fragments(feat, "bf16x6")
    assert b is not a
    assert torch.equal(b, mesh_brute.tc_fragments(feat, 3))


def test_mesh_dtype_switch_loads_a_bf16_table(monkeypatch):
    """PRT_MESH_DTYPE=bf16, read at each load: both packages' coefficient
    tables bf16 and bitwise equal; unset, float32."""
    _mesh_dtype_switch(monkeypatch)


def _mesh_dtype_switch(monkeypatch):
    same_bvh_build(monkeypatch)
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
    for value, dtype in (("bf16", torch.bfloat16), (None, torch.float32)):
        if value:
            monkeypatch.setenv("PRT_MESH_DTYPE", value)
        else:
            monkeypatch.delenv("PRT_MESH_DTYPE", raising=False)
        _, jsc = j_loader.load_scene("scenes/cornell.json",
                                     mesh_override=mesh)
        _, sc = loader.load_scene("scenes/cornell.json", mesh_override=mesh,
                                  device="cpu")
        assert sc.bf_feat.dtype == dtype
        bits = np.int16 if value else np.int32
        assert (sc.bf_feat.view(torch.int16 if value else torch.int32)
                .numpy().tobytes() == np.asarray(jsc.bf_feat).view(bits)
                .tobytes())


def _second_pass_rays(n=2048, seed=5):
    """Rays that graze the mesh: origins around it, aimed near its
    silhouette, where the bf16 table's false hits fail validation."""
    r = np.random.default_rng(seed)
    c = np.array([0.0, -1.0, 0.0], np.float32)
    o = (c + r.uniform(-2.5, 2.5, (n, 3))).astype(np.float32)
    to_c = c - o
    side = np.cross(to_c, r.normal(size=(n, 3)).astype(np.float32))
    side /= np.linalg.norm(side, axis=1, keepdims=True)
    target = c + side * r.uniform(0.5, 0.62, (n, 1)).astype(np.float32)
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def test_second_pass_matches_reference(monkeypatch):
    """``mesh_second_pass`` with both packages' kernel gates forced open
    (the port's uses_kernel, the reference's uses_pallas), so that both
    sort and search again through their plain paths, on a bf16 table whose
    first pass has winners that validation rejects: the port's
    mesh_closest winners are the reference's, and the second pass moved
    some."""
    _second_pass(monkeypatch)


def _second_pass(monkeypatch):
    same_bvh_build(monkeypatch)
    monkeypatch.setenv("PRT_MESH_DTYPE", "bf16")
    mesh = make_icosphere(subdiv=2, radius=0.6, center=(0.0, -1.0, 0.0))
    jcfg, jsc = j_loader.load_scene("scenes/cornell.json", mesh_override=mesh)
    cfg, sc = loader.load_scene("scenes/cornell.json", mesh_override=mesh,
                                device="cpu")
    monkeypatch.setattr(j_mb, "uses_pallas", lambda: True)
    monkeypatch.setattr(mesh_brute, "uses_kernel", lambda x: True)
    o, d = _second_pass_rays()
    n = o.shape[0]
    t_init = np.full(n, 20.0, np.float32)
    act = np.arange(n) % 9 != 4
    out = {}
    for second in (False, True):
        jc = dataclasses.replace(jcfg, mesh_second_pass=second,
                                 mesh_sort_rays=True)
        pc = dataclasses.replace(cfg, mesh_second_pass=second,
                                 mesh_sort_rays=True)
        _, jtri, _, _ = j_isect.mesh_closest(
            jc, jsc, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_init),
            active=jnp.asarray(act))
        _, tri, _, _ = intersect.mesh_closest(
            pc, sc, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_init), active=torch.from_numpy(act))
        jtri, tri = np.asarray(jtri), tri.numpy()
        parted = np.nonzero(tri != jtri)[0]
        assert parted.size <= TIE_SHARE * n, parted
        out[second] = tri
    raw_t, raw = mesh_brute.mesh_intersect(
        sc.bf_feat, sc.bf_clusters, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(t_init), active=torch.from_numpy(act))
    rejected = (raw.numpy() >= 0) & (out[False] < 0)
    assert rejected.sum() > 0  # the first pass does reject winners
    moved = out[True] != out[False]
    assert moved.any() and not moved[~rejected].any()


@pytest.mark.parametrize("check", ["mesh dtype switch", "second pass"])
def test_cross_package_loads_with_the_jax_library_lost(monkeypatch, check):
    """The two comparisons above with the JAX package's native library made
    unavailable in this process (a lost build race): both packages then
    take their Python BVH builds, and the comparisons hold."""
    lose_jax_library(monkeypatch)
    assert j_native.get_lib() is None
    {"mesh dtype switch": _mesh_dtype_switch,
     "second pass": _second_pass}[check](monkeypatch)
    assert os.environ.get("PRT_NO_NATIVE") == "1"


def test_bench_kernel_legs(tables, monkeypatch):
    """tools/bench_kernel.py's precision sweep and bf16-table leg, run on
    the CPU with the host clock in place of CUDA events (on the CPU every
    name runs the twin, so the f32 names agree with highest entirely): the
    reference's names, the numbers each leg reports, and the precision
    name put back."""
    from photorealistic_rendering_using_opencl_tpu_torch.tools import (
        bench_kernel,
    )
    monkeypatch.setattr(bench_kernel, "cuda_ms", lambda fn, reps: 1.0)
    saved = mesh_brute._PRECISION_NAME
    o, d, t_init, *_ = (torch.from_numpy(x) for x in _lanes("camera", tables))
    feat, cl = torch.from_numpy(tables.feat), torch.from_numpy(tables.clusters)
    sweep, results = bench_kernel.precision_sweep(feat, cl, o, d, t_init, 2)
    assert mesh_brute._PRECISION_NAME == saved
    assert list(sweep) == ["default", "bf16x3", "bf16x6", "highest"]
    for name in ("default", "bf16x3", "bf16x6"):
        assert sweep[name]["index_agreement"] == 1.0
        assert sweep[name]["hit_miss_flips"] == 0
    leg = bench_kernel.bf16_table_leg(feat, cl, o, d, t_init, 2,
                                      results["highest"])
    assert set(leg) == {"ms", "hit_rate_f32", "index_agreement",
                        "hit_miss_flips", "t_max_abs_both_hit"}
    assert 0.1 < leg["hit_rate_f32"] < 1.0 and leg["index_agreement"] < 1.0
