"""The port's tool kernels T1 and T2 (their plain versions, on the CPU)
against the JAX package's Pallas kernels in interpret mode, the relevance
pass that feeds T1, the barrier probe's forms, and every BSDF family
against the JAX package's on the same seeded inputs."""
import dataclasses
import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from photorealistic_rendering_using_opencl_tpu.ops import bsdf as j_bsdf
from photorealistic_rendering_using_opencl_tpu.ops import mesh_brute as j_mb
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
from photorealistic_rendering_using_opencl_tpu_torch.ops import bsdf, mesh_brute, passthrough
from photorealistic_rendering_using_opencl_tpu_torch.scene import bvh_build
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import (
    ABS_REFR, ABS_REFR2, BECKMANN, BURLEY, COAT, COND, DIEL, DIFF, GGX, PHONG,
    ROUGH_COND, ROUGH_DIEL, SceneConfig, default_lobes_for_type,
)
from photorealistic_rendering_using_opencl_tpu_torch.tools import barrier_test, bench_kernel

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name):
    """A module of the repo's tools/ directory (the JAX package's tools)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# T1 and the relevance pass
# ---------------------------------------------------------------------------

@functools.cache
def _t1_inputs(n=1024):
    """A 1,280-triangle sphere of radius 2 in 10 tiles spread over its
    surface, and rays from 8 spots (128 rays each) with short t_init:
    six next to the surface, so each block needs only some tiles, and two
    far from it, so their blocks need none."""
    tv, tn = make_icosphere(subdiv=3, radius=2.0, center=(0.0, 0.0, 0.0))
    order = bvh_build.build_bvh(tv).order
    bp = mesh_brute.pack_brute(tv[order], tn[order])
    rng = np.random.default_rng(21)
    spots = rng.normal(size=(8, 3))
    spots *= 2.1 / np.linalg.norm(spots, axis=1, keepdims=True)
    spots[6:] *= 3.0
    o = (np.repeat(spots, n // 8, axis=0)
         + rng.normal(scale=0.1, size=(n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_init = rng.uniform(0.1, 0.6, n).astype(np.float32)
    active = rng.uniform(size=n) > 0.1
    return bp, o, d, t_init, active


@pytest.mark.parametrize("block", [256, 128])
def test_block_relevance_matches_reference(block):
    bp, o, d, t_init, active = _t1_inputs()
    n, nt = o.shape[0], bp.clusters.shape[0]
    want = np.asarray(j_mb._block_relevance(
        jnp.asarray(bp.clusters), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(t_init), jnp.asarray(active), n // block, block))
    got = mesh_brute.relevance_words(
        torch.from_numpy(bp.clusters), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(t_init),
        torch.from_numpy(active), block)
    assert want.dtype == np.uint32 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    bits = np.unpackbits(want.view(np.uint8), bitorder="little").reshape(
        want.shape[0], -1)[:, :nt]
    assert 0.05 < bits.mean() < 0.9  # some tiles pruned, some kept
    # a ragged tail pads with inactive rays
    got_r = mesh_brute.relevance_words(
        torch.from_numpy(bp.clusters), torch.from_numpy(o[:n - 37]),
        torch.from_numpy(d[:n - 37]), torch.from_numpy(t_init[:n - 37]),
        torch.from_numpy(active[:n - 37]), block)
    want_r = np.asarray(j_mb._block_relevance(
        jnp.asarray(bp.clusters), jnp.asarray(o[:n - 37]),
        jnp.asarray(d[:n - 37]), jnp.asarray(t_init[:n - 37]),
        jnp.asarray(active[:n - 37]), n // block, block, pad=37))
    np.testing.assert_array_equal(got_r.numpy().view(np.uint32), want_r)


@pytest.mark.parametrize("block", [256, 128])
def test_t1_plain_matches_reference_kernel(block):
    """T1's plain version against tools/bench_kernel.py's make_matmul_only
    in Pallas interpret mode, on the same relevance words and pack.  The
    sum runs in another order on each side: the bound is 1e-6 of the sum
    of the absolute terms, per ray."""
    bp, o, d, t_init, active = _t1_inputs()
    n = o.shape[0]
    nt = bp.clusters.shape[0]
    feat = torch.from_numpy(bp.feat)
    words = mesh_brute.relevance_words(
        torch.from_numpy(bp.clusters), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(t_init),
        torch.from_numpy(active), block)
    pack = mesh_brute.matmul_only_pack(torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(t_init))
    t, i = mesh_brute.matmul_only(words, pack, feat, block)
    scale, _ = mesh_brute.matmul_only_plain(words, pack.abs(), feat.abs(),
                                            block)

    tool = _tool("bench_kernel")
    jt, ji = pl.pallas_call(
        tool.make_matmul_only(nt, mesh_brute.TILE, block),
        grid=(n // block,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((mesh_brute.FEAT, block), lambda g: (0, g),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((mesh_brute.FEAT, bp.feat.shape[1]),
                               lambda g: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=(pl.BlockSpec((1, block), lambda g: (0, g),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((1, block), lambda g: (0, g),
                                memory_space=pltpu.VMEM)),
        out_shape=(jax_struct((1, n), jnp.float32),
                   jax_struct((1, n), jnp.int32)),
        interpret=True,
    )(jnp.asarray(words.numpy().view(np.uint32).reshape(-1)),
      jnp.asarray(pack.numpy()), jnp.asarray(bp.feat))
    jt, ji = np.asarray(jt)[0], np.asarray(ji)[0]
    assert i.dtype == torch.int32 and not i.any() and not ji.any()
    err = np.abs(t.numpy() - jt) / np.maximum(scale.numpy(), 1e-30)
    assert err.max() <= 1e-6, err.max()
    summed = scale.numpy() > 0
    assert 0.05 < summed.mean() < 0.95  # rays of kept and of idle blocks
    assert np.all(jt[~summed] == 0.0)


def jax_struct(shape, dtype):
    import jax
    return jax.ShapeDtypeStruct(shape, dtype)


def test_t1_wrapper_checks_and_block_sizes():
    bp, o, d, t_init, active = _t1_inputs()
    words = mesh_brute.relevance_words(
        torch.from_numpy(bp.clusters), torch.from_numpy(o),
        torch.from_numpy(d), torch.from_numpy(t_init),
        torch.from_numpy(active), 128)
    pack = mesh_brute.matmul_only_pack(torch.from_numpy(o),
                                       torch.from_numpy(d),
                                       torch.from_numpy(t_init))
    assert pack.shape == (16, o.shape[0])
    assert torch.equal(pack[11], torch.ones(o.shape[0]))
    assert not pack[12:].any()
    launches = mesh_brute.matmul_only_kernel.launches
    with pytest.raises(ValueError, match="128 or 256"):
        mesh_brute.matmul_only_kernel(words, pack, torch.from_numpy(bp.feat),
                                      64)
    # CPU: plain version (other files' stand-in libraries count launches)
    assert mesh_brute.matmul_only_kernel.launches == launches


# ---------------------------------------------------------------------------
# T2 and the barrier probe
# ---------------------------------------------------------------------------

def test_t2_plain_matches_reference_kernel(monkeypatch):
    tool = _tool("pallas_barrier_test")
    monkeypatch.setattr(tool.pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    x = np.random.default_rng(4).normal(size=(4096, 3)).astype(np.float32)
    want = np.asarray(tool._passthrough(jnp.asarray(x)))
    got = passthrough.passthrough(torch.from_numpy(x))
    assert got.numpy().tobytes() == want.tobytes() == x.tobytes()
    flat = torch.from_numpy(x.reshape(-1))
    got_f = passthrough.passthrough_flat(flat)
    assert got_f.numpy().tobytes() == x.tobytes()
    assert got_f.data_ptr() != flat.data_ptr()
    assert passthrough.passthrough_kernel.launches == 0
    assert passthrough.passthrough_flat_kernel.launches == 0


def test_barrier_probe_forms_change_nothing():
    """The probe's three forms wrap shadow_visible with copies whose result
    folds in without changing it; the real function comes back after each."""
    real = integrator.shadow_visible
    cfg, scene, state, pix = barrier_test.setup(1024, "cpu")
    diffs = barrier_test.check_forms(cfg, scene, state, pix)
    assert diffs == {name: 0.0 for name in barrier_test.FORMS[1:]}
    assert integrator.shadow_visible is real
    with pytest.raises(RuntimeError):
        with barrier_test.form("one T2a copy"):
            assert integrator.shadow_visible is not real
            raise RuntimeError
    assert integrator.shadow_visible is real


def test_tools_need_a_card():
    with pytest.raises(ValueError, match="CUDA"):
        bench_kernel.run(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        barrier_test.run(device="cpu")
    cl = torch.tensor([[-1.0, -2.0, -3.0, 1.0, 2.0, 3.0, 0.0, 0.0],
                       [3e38, 3e38, 3e38, -3e38, -3e38, -3e38, 0.0, 0.0]])
    o, d, t = bench_kernel.rays_around_mesh(cl, 100, device="cpu")
    assert o.shape == d.shape == (100, 3) and t.shape == (100,)
    assert (o.abs().amax(0) <= torch.tensor([1.5, 3.0, 4.5])).all()
    np.testing.assert_allclose(d.norm(dim=1).numpy(), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# BSDF families
# ---------------------------------------------------------------------------

# microfacet sampling and Fresnel terms pass through sin/cos/exp/log/pow,
# whose float32 results differ by an ulp or two between the two frameworks'
# CPU libraries; near-grazing lanes amplify that to a few 1e-5 relative
BSDF_RTOL, BSDF_ATOL = 1e-4, 1e-5
FAMILIES = {
    "diffuse": DIFF, "burley": BURLEY, "conductor": COND,
    "rough_conductor": ROUGH_COND, "dielectric": DIEL,
    "dielectric_abs1": DIEL | ABS_REFR, "rough_dielectric": ROUGH_DIEL,
    "rough_dielectric_abs2": ROUGH_DIEL | ABS_REFR2, "coat": COAT,
}


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _bsdf_inputs(mat_type, n=2048, seed=8):
    rng = np.random.default_rng(seed)
    diel = mat_type & (DIEL | ROUGH_DIEL)
    wi = _unit(rng, n)
    wo = _unit(rng, n)
    # a quarter of the lanes on the mirror (and, for dielectrics, the
    # refracted) direction, so the Dirac lobes evaluate non-zero
    q = n // 4
    wo[:q] = wi[:q] * np.array([-1.0, -1.0, 1.0], np.float32)
    eta = (rng.uniform(1.3, 1.8, (n, 1)) * np.ones((1, 3)) if diel
           else rng.uniform(0.2, 2.0, (n, 3))).astype(np.float32)
    mat = dict(
        color=rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32), eta=eta,
        k=rng.uniform(1.0, 4.0, (n, 3)).astype(np.float32),
        roughness=rng.uniform(0.05, 0.8, n).astype(np.float32),
        mat_type=np.full(n, mat_type, np.int32),
        lobes=np.full(n, default_lobes_for_type(mat_type), np.int32),
        dist=rng.choice([BECKMANN, PHONG, GGX], n).astype(np.int32))
    extra = dict(backside=rng.uniform(size=n) < 0.5,
                 ray_t=rng.uniform(0.1, 3.0, n).astype(np.float32),
                 u=rng.uniform(size=(3, n)).astype(np.float32))
    return wi, wo, mat, extra


def _close(name, got, want, valid=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if valid is not None:
        got, want = got[valid], want[valid]
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=BSDF_RTOL, atol=BSDF_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_bsdf_family_matches_reference(family):
    mat_type = FAMILIES[family]
    jcfg, _ = j_load("scenes/cornell_simple.json")
    jcfg = dataclasses.replace(jcfg, active_mats=mat_type)
    cfg = SceneConfig(**dataclasses.asdict(jcfg))
    wi, wo, mat, ex = _bsdf_inputs(mat_type)
    jm = j_bsdf.MatProps(**{k: jnp.asarray(v) for k, v in mat.items()})
    tm = bsdf.MatProps(**{k: torch.from_numpy(v) for k, v in mat.items()})
    bs, rt, u = ex["backside"], ex["ray_t"], ex["u"]

    want = j_bsdf.sample(jcfg, jm, jnp.asarray(wi), jnp.asarray(bs),
                         jnp.asarray(rt), *map(jnp.asarray, u))
    got = bsdf.sample(cfg, tm, torch.from_numpy(wi), torch.from_numpy(bs),
                      torch.from_numpy(rt), *map(torch.from_numpy, u))
    _close(f"{family} sample.valid", got.valid, want.valid)
    valid = np.asarray(want.valid)
    assert valid.mean() > 0.2, family
    for f in ("lobe", "wo", "pdf", "weight"):
        _close(f"{family} sample.{f}", getattr(got, f), getattr(want, f),
               valid)

    # evaluate / pdf at random directions and at the sampled ones
    for label, w2 in (("random", wo), ("sampled", np.array(want.wo))):
        f_j = j_bsdf.evaluate(jcfg, jm, jnp.asarray(wi), jnp.asarray(w2),
                              jnp.asarray(bs), jnp.asarray(rt))
        f_t = bsdf.evaluate(cfg, tm, torch.from_numpy(wi),
                            torch.from_numpy(w2), torch.from_numpy(bs),
                            torch.from_numpy(rt))
        p_j = j_bsdf.pdf(jcfg, jm, jnp.asarray(wi), jnp.asarray(w2))
        p_t = bsdf.pdf(cfg, tm, torch.from_numpy(wi), torch.from_numpy(w2))
        _close(f"{family} evaluate {label}", f_t, f_j)
        _close(f"{family} pdf {label}", p_t, p_j)
        assert np.abs(np.asarray(f_j)).max() > 0, (family, label)


def test_volume_material_is_refused():
    """A volume boundary (VOL, JSON type 5) beside a diffuse family, which
    the port refused until ROADMAP M11: its lanes get the JAX package's
    dispatch result, an invalid zero sample and zero value and pdf (the
    reference has no VOL family), the diffuse lanes theirs.  (The name is
    the refusal test's.)"""
    jcfg, _ = j_load("scenes/cornell_simple.json")
    jcfg = dataclasses.replace(jcfg, active_mats=DIFF | (1 << 5))
    cfg = SceneConfig(**dataclasses.asdict(jcfg))
    wi, wo, mat, ex = _bsdf_inputs(DIFF)
    vol = np.arange(wi.shape[0]) % 2 == 0
    mat["mat_type"] = np.where(vol, 1 << 5, DIFF).astype(np.int32)
    mat["lobes"] = np.asarray([default_lobes_for_type(int(t))
                               for t in mat["mat_type"]], np.int32)
    jm = j_bsdf.MatProps(**{k: jnp.asarray(v) for k, v in mat.items()})
    tm = bsdf.MatProps(**{k: torch.from_numpy(v) for k, v in mat.items()})
    bs, rt, u = ex["backside"], ex["ray_t"], ex["u"]
    want = j_bsdf.sample(jcfg, jm, jnp.asarray(wi), jnp.asarray(bs),
                         jnp.asarray(rt), *map(jnp.asarray, u))
    got = bsdf.sample(cfg, tm, torch.from_numpy(wi), torch.from_numpy(bs),
                      torch.from_numpy(rt), *map(torch.from_numpy, u))
    for f in ("valid", "lobe", "wo", "pdf", "weight"):
        _close(f"vol sample.{f}", getattr(got, f), getattr(want, f))
    assert not got.valid[torch.from_numpy(vol)].any()
    f_t = bsdf.evaluate(cfg, tm, torch.from_numpy(wi), torch.from_numpy(wo),
                        torch.from_numpy(bs), torch.from_numpy(rt))
    _close("vol evaluate", f_t,
           j_bsdf.evaluate(jcfg, jm, jnp.asarray(wi), jnp.asarray(wo),
                           jnp.asarray(bs), jnp.asarray(rt)))
    _close("vol pdf", bsdf.pdf(cfg, tm, torch.from_numpy(wi),
                               torch.from_numpy(wo)),
           j_bsdf.pdf(jcfg, jm, jnp.asarray(wi), jnp.asarray(wo)))
    assert not f_t[torch.from_numpy(vol)].any()
    np.testing.assert_array_equal(
        bsdf.nee_capable(tm).numpy(), np.asarray(j_bsdf.nee_capable(jm)))