"""K1's tile and block sizes on the CPU (PRT_MESH_TILE, PRT_MESH_BLOCK):
the port's tables, plain twin and plain reduced forms at the reference's
sizes against the JAX package's, the switches read at import through both
loaders, and the kernels' refusal of a size they have no instance for (a
stand-in library; the kernels themselves run in tests/test_torch_cuda.py).

The JAX package reads its TILE and BLOCK at call time in ``_intersect_xla``
and ``_intersect_pallas``, so those tests set them with monkeypatch; its
``pack_brute`` takes the tile as an argument.  Winners follow
tests/test_torch_mesh_precision.py's tie rule.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute as j_mb
from photorealistic_rendering_using_opencl_tpu.scene import bvh_build as j_bvh
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
# the tie rule, the lanes and the stand-in library of the reduced forms'
# tests (fake_library is a fixture)
from test_torch_mesh_precision import (  # noqa: F401
    _assert_winners, _lanes, fake_library,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2100  # four whole blocks of 512 rays and a padded tail
# (tile, relevance block) pairs of the reduced forms: the reference's
# default tile with its other blocks, its default block with another tile,
# and a size no kernel is built for (the plain versions take any)
PAIRS = [(256, 256), (128, 128), (128, 512), (64, 64)]


def _mesh():
    """bench.py's icosphere on cornell.json's scale, in BVH order: 1,280
    triangles, 10 tiles of 128, 5 of 256, 2.5 of 512 (padding)."""
    tv, tn = make_icosphere(subdiv=3, radius=0.8, center=(0.1, -0.2, 0.3))
    order = j_bvh.build_bvh(tv).order
    return tv[order], tn[order]


_TABLES = {}


def _tables(tile):
    """The JAX package's pack_brute at ``tile``, held bitwise by
    test_pack_brute_matches_reference_at_tile."""
    if tile not in _TABLES:
        _TABLES[tile] = j_mb.pack_brute(*_mesh(), tile=tile)
    return _TABLES[tile]


@pytest.mark.parametrize("tile", [128, 256, 512, 64])
def test_pack_brute_matches_reference_at_tile(tile):
    """Every table bitwise the JAX package's at the same tile: the padded
    layout, the tile-grouped columns and the boxes; the table's tile is
    read back from it."""
    tv, tn = _mesh()
    want = j_mb.pack_brute(tv, tn, tile=tile)
    got = mesh_brute.pack_brute(tv, tn, tile=tile)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    assert got.clusters.shape[0] == -(-tv.shape[0] // tile)
    assert mesh_brute.table_tile(got.feat, got.clusters) == tile


@pytest.mark.parametrize("pop", ["random", "surface"])
@pytest.mark.parametrize("tile", [256, 512, 64])
def test_intersect_xla_matches_reference_at_tile(monkeypatch, tile, pop):
    """The plain twin on a table of ``tile`` against the JAX package's XLA
    path (un-jitted) with its TILE set to the same size: t and the winner
    bitwise on every lane."""
    monkeypatch.setattr(j_mb, "TILE", tile)
    bp = _tables(tile)
    o, d, t_init, act, _, ex = _lanes(pop, bp, n=N)
    jt, jtri = (np.asarray(x) for x in j_mb._intersect_xla(
        jnp.asarray(bp.feat), jnp.asarray(bp.clusters), jnp.asarray(o),
        jnp.asarray(d), jnp.asarray(t_init), jnp.asarray(act),
        exclude=jnp.asarray(ex)))
    t, tri = mesh_brute._intersect_xla(
        torch.from_numpy(bp.feat), torch.from_numpy(bp.clusters),
        *(torch.from_numpy(x) for x in (o, d, t_init, act)),
        exclude=torch.from_numpy(ex))
    assert (jtri >= 0).sum() > N // 10
    np.testing.assert_array_equal(tri.numpy(), jtri)
    np.testing.assert_array_equal(t.numpy(), jt)


@pytest.mark.parametrize("form", ["bf16", "bf16x3", "bf16x6"])
@pytest.mark.parametrize("tile,block", PAIRS)
def test_reduced_plain_matches_pallas_at_sizes(monkeypatch, tile, block,
                                               form):
    """The plain reduced form on a table of ``tile`` with relevance blocks
    of ``block`` rays against the JAX package's TPU kernel in interpret
    mode with its TILE and BLOCK set to the same (and, for the split
    forms, its precision name): winners equal but at shown ties, t bitwise
    where they agree.  The bf16 form runs on the table cast to bf16."""
    monkeypatch.setattr(j_mb, "TILE", tile)
    monkeypatch.setattr(j_mb, "BLOCK", block)
    if form != "bf16":
        monkeypatch.setattr(j_mb, "_PRECISION_NAME", form)
    bp = _tables(tile)
    lanes = _lanes("camera", bp, n=N)
    o, d, t_init, act, anyh, ex = lanes
    jfeat = jnp.asarray(bp.feat, jnp.bfloat16 if form == "bf16"
                        else jnp.float32)
    jt, jtri = (np.asarray(x) for x in j_mb._intersect_pallas(
        jfeat, jnp.asarray(bp.clusters), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_init), jnp.asarray(act), any_hit=jnp.asarray(anyh),
        exclude=jnp.asarray(ex), interpret=True))
    feat = torch.from_numpy(bp.feat)
    if form == "bf16":
        feat = feat.to(torch.bfloat16)
    t, tri = (x.numpy() for x in mesh_brute.intersect_reduced_plain(
        feat, torch.from_numpy(bp.clusters),
        *(torch.from_numpy(x) for x in lanes), form, block=block))
    assert (jtri[~anyh] >= 0).sum() > N // 10
    _assert_winners(feat, bp, lanes, form, tri, jtri)
    same = tri == jtri
    np.testing.assert_array_equal(t[same], jt[same])


@pytest.mark.parametrize("pop", ["random", "camera", "surface"])
def test_twin_closest_winners_do_not_depend_on_the_tile(pop):
    """The f32 twin's closest lanes give the same (t, winner) at every
    tile: a strictly smaller t wins across tiles and the lowest index
    within one, which together is the lowest index of the least t however
    the triangles are grouped (chip_smoke.py holds K1's frames at 256 and
    512 bitwise the 128 one by this)."""
    lanes = [torch.from_numpy(x) for x in _lanes(pop, _tables(128), n=N)]
    closest = lanes[3] & ~lanes[4]
    outs = []
    for tile in (128, 256, 512):
        tb = _tables(tile)
        t, tri = mesh_brute._intersect_xla(
            torch.from_numpy(tb.feat), torch.from_numpy(tb.clusters),
            *lanes[:4], exclude=lanes[5])
        outs.append((t[closest], tri[closest]))
    assert int((outs[0][1] >= 0).sum()) > N // 10
    for t, tri in outs[1:]:
        assert torch.equal(t, outs[0][0]) and torch.equal(tri, outs[0][1])


_LOAD = {
    "jax": """
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute as m
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
_, sc = load_scene("scenes/cornell.json", mesh_override=make_icosphere(
    subdiv=3, radius=0.6, center=(0.0, -1.0, 0.0)))
tables = [np.asarray(getattr(sc, k)) for k in NAMES]
tile, block = m.TILE, m.BLOCK
""",
    "port": """
import numpy as np
from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute as m
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
_, sc = load_scene("scenes/cornell.json", mesh_override=make_icosphere(
    subdiv=3, radius=0.6, center=(0.0, -1.0, 0.0)), device="cpu")
tables = [getattr(sc, k).numpy() for k in NAMES]
tile, block = m.TILE, m.RELEVANCE_BLOCK
""",
}
_SAVE = """
np.savez(OUT, *tables)
print(json.dumps([tile, block]))
"""


def test_switches_reach_both_loaders(tmp_path):
    """PRT_MESH_TILE=256 and PRT_MESH_BLOCK=128 in a fresh process of each
    package (both read them at import, and the JAX package's pack_brute
    binds its tile when it is defined): both read 256 and 128, and both
    loaders pack cornell.json with a 1,280-triangle icosphere into
    bitwise-equal tables of 256-triangle tiles.  Both build the BVH in
    Python (PRT_NO_NATIVE), so that their triangle orders agree."""
    names = ["bf_feat", "bf_clusters", "bf_tri_verts", "bf_tri_normals"]
    env = dict(os.environ, PRT_MESH_TILE="256", PRT_MESH_BLOCK="128",
               PRT_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    env.pop("PRT_MESH_DTYPE", None)
    got = {}
    for pkg, code in _LOAD.items():
        out = str(tmp_path / f"{pkg}.npz")
        head = f"import json\nNAMES = {names!r}\nOUT = {out!r}\n"
        res = subprocess.run([sys.executable, "-c", head + code + _SAVE],
                             cwd=REPO, env=env, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        assert json.loads(res.stdout.splitlines()[-1]) == [256, 128], pkg
        with np.load(out) as z:
            got[pkg] = [z[f"arr_{i}"] for i in range(len(names))]
    for name, a, b in zip(names, got["port"], got["jax"]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    feat, clusters = got["port"][0], got["port"][1]
    assert clusters.shape[0] == 5
    assert mesh_brute.table_tile(feat, clusters) == 256


def _card_lanes(bp, n=64):
    return [torch.from_numpy(x) for x in _lanes("camera", bp, n=n)]


@pytest.mark.parametrize("tile", [128, 256, 512])
def test_kernels_get_the_table_tile(fake_library, monkeypatch, tile):
    """K1, the tensor-core kernel (each relevance block) and T1 pass the
    table's tile, and the block, to their C entries; one launch each."""
    bp = _tables(tile)
    feat, cl = torch.from_numpy(bp.feat), torch.from_numpy(bp.clusters)
    lanes = _card_lanes(bp)
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", "highest")
    mesh_brute._launch(feat, cl, *lanes)
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", "bf16x3")
    for block in mesh_brute.KERNEL_BLOCKS:
        monkeypatch.setattr(mesh_brute, "RELEVANCE_BLOCK", block)
        mesh_brute._launch(feat, cl, *lanes)
    words = mesh_brute.relevance_words(cl, *lanes[:4], 128)
    pack = mesh_brute.matmul_only_pack(*lanes[:3])
    mesh_brute.matmul_only_kernel(words, pack, feat, 128, tile)
    calls = fake_library.calls
    assert [c[0] for c in calls] == (["prt_mesh_brute"]
                                     + ["prt_mesh_brute_tc"] * 3
                                     + ["prt_matmul_only"])
    assert calls[0][1][3] == tile
    for (_, args), block in zip(calls[1:4], mesh_brute.KERNEL_BLOCKS):
        assert args[2:4] == (tile, block)
        assert args[0] == mesh_brute.form_fragments(
            feat, "bf16x3", tile).data_ptr()
    assert calls[4][1][6] == tile


@pytest.mark.parametrize("kernel", ["K1", "K1tc", "T1"])
def test_unbuilt_tile_raises(fake_library, monkeypatch, kernel):
    """A table of 64-triangle tiles, which no kernel instance takes: the
    wrapper raises ValueError naming PRT_MESH_TILE, calls no C entry and
    counts no launch; there is no plain-version fallback on the card."""
    bp = _tables(64)
    feat, cl = torch.from_numpy(bp.feat), torch.from_numpy(bp.clusters)
    lanes = _card_lanes(bp)
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME",
                        "highest" if kernel == "K1" else "bf16x6")
    wrapper = {"K1": mesh_brute.mesh_brute_kernel,
               "K1tc": mesh_brute.mesh_brute_tc_kernel,
               "T1": mesh_brute.matmul_only_kernel}[kernel]
    before = wrapper.launches
    with pytest.raises(ValueError, match="PRT_MESH_TILE"):
        if kernel == "T1":
            words = mesh_brute.relevance_words(cl, *lanes[:4], 128)
            pack = mesh_brute.matmul_only_pack(*lanes[:3])
            mesh_brute.matmul_only_kernel(words, pack, feat, 128, 64)
        else:
            mesh_brute._launch(feat, cl, *lanes)
    assert wrapper.launches == before and not fake_library.calls


@pytest.mark.parametrize("block", [64, 1024])
def test_unbuilt_block_raises(fake_library, monkeypatch, block):
    """A relevance block no instance of the tensor-core kernel takes, by
    the module's RELEVANCE_BLOCK (PRT_MESH_BLOCK) or the wrapper's
    argument: ValueError naming PRT_MESH_BLOCK, no C call, no launch
    counted."""
    bp = _tables(128)
    feat, cl = torch.from_numpy(bp.feat), torch.from_numpy(bp.clusters)
    lanes = _card_lanes(bp)
    monkeypatch.setattr(mesh_brute, "_PRECISION_NAME", "bf16x6")
    before = mesh_brute.mesh_brute_tc_kernel.launches
    monkeypatch.setattr(mesh_brute, "RELEVANCE_BLOCK", block)
    with pytest.raises(ValueError, match="PRT_MESH_BLOCK"):
        mesh_brute._launch(feat, cl, *lanes)
    monkeypatch.setattr(mesh_brute, "RELEVANCE_BLOCK", 256)
    with pytest.raises(ValueError, match="PRT_MESH_BLOCK"):
        mesh_brute.mesh_brute_tc_kernel(
            mesh_brute.form_fragments(feat, "bf16x6", 128), cl, *lanes,
            "bf16x6", block=block)
    assert mesh_brute.mesh_brute_tc_kernel.launches == before
    assert not fake_library.calls
