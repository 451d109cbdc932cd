"""Several devices (ROADMAP M15): the port's ``parallel/`` over gloo on the
CPU, held to its own single-process render and to the JAX package's
``parallel/render.py`` on the tests' 8-device virtual CPU mesh.

Process groups of 1, 2 and 3 ranks are spawned once for the module
(``torch_parallel_worker.py``, a ``file://`` store under a temporary
directory, so no TCP port can collide between test workers); every
collective of ``torch.distributed`` is counted there.  Scenes: cornell_simple
at 24^2 x 2 spp, seed 5 (``test_parallel_extra.py``'s frame), frames whose
pixels the world size does not divide (15^2 on 2 ranks, 16^2 on 3), and the
train step at 16^2 x 1 spp against a 0.2 target.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_worker as worker
from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.ops.camera_rays import (
    default_camera as j_default_camera,
)
from photorealistic_rendering_using_opencl_tpu.parallel.render import (
    RAYS_AXIS, make_train_step as j_make_train_step,
    render_sharded as j_render_sharded,
)
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.parallel import distributed, render
from photorealistic_rendering_using_opencl_tpu_torch.parallel.dryrun import dryrun_multichip
from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
from photorealistic_rendering_using_opencl_tpu_torch.runtime.camera import InteractiveCamera
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOBS = {1: ["frame", "train", "train_lr1", "bounds"],
        2: ["frame", "padded", "train", "train_lr1", "bounds", "mesh"],
        3: ["bounds", "padded3"]}
RENDER_TOL = 1e-6  # test_parallel_extra.py's sharded-vs-single bound
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{world: [rank 0's results, ...]} of the 1-, 2- and 3-rank groups,
    run side by side."""
    dirs = {w: str(tmp_path_factory.mktemp(f"world{w}")) for w in JOBS}
    ctxs = [worker.spawn(w, dirs[w], JOBS[w]) for w in JOBS]
    for ctx in ctxs:
        while not ctx.join():
            pass
    return {w: worker.results(w, dirs[w]) for w in JOBS}


def _port_scene():
    return load_scene(worker.SCENE, device="cpu")


def _trace_regen_frame(w, h, spp, seed, cam=None):
    """The port's single-process trace_regen of the whole frame."""
    cfg, sc = _port_scene()
    cam = default_camera(w, h).pytree("cpu") if cam is None else cam
    px, py = pathtracer.pixel_grid(w, h, "cpu")
    with torch.no_grad():
        rad, alpha = pathtracer.trace_regen(cfg, sc, cam, w, h, spp, px, py,
                                            seed)
    return rad.reshape(h, w, 3), alpha.reshape(h, w)


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), (RAYS_AXIS,))


@pytest.mark.parametrize("world,job", [(1, "frame"), (2, "frame"),
                                       (2, "padded"), (3, "padded3")])
def test_sharded_render_is_the_single_process_frame(ranks, world, job):
    """Every rank's gathered frame is bitwise the single-process
    ``trace_regen`` frame: the RNG is keyed on the global pixel id, and the
    padding pixels (0, 0) are cut away."""
    want_img, want_a = _trace_regen_frame(*worker.RENDERS[job])
    for res in ranks[world]:
        img, alpha, _ = res[job]
        np.testing.assert_array_equal(img, want_img.numpy())
        np.testing.assert_array_equal(alpha, want_a.numpy())


def _gap(a, b):
    """max |a - b| / (1 + |b|): the least tol with a within rtol = atol =
    tol of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / (1.0 + np.abs(b))).max())


def test_sharded_render_matches_jax_render_sharded(ranks, record_property):
    """Within test_sharded_render_matches_single_chip's 1e-6 of the JAX
    ``render_sharded`` on a 2-device mesh, and of the port's
    ``render(method="while")``, as that test holds the reference.  Under
    jit XLA fuses the reference's CPU arithmetic (FMAs; shard_map's body
    is compiled even under ``jax.disable_jit``), and its jitted frame and
    its un-jitted ``trace_regen`` frame part here by more than 1e-6
    absolute (the gaps are recorded).  So the port is held to the
    un-jitted frame at the reference test's atol 1e-6, and to the sharded
    one in the suite's form, rtol = atol = 1e-6."""
    w, h, spp, seed = worker.RENDERS["frame"]
    img, alpha, _ = ranks[2][0]["frame"]
    jcfg, jsc = j_load("scenes/cornell_simple.json")
    jcam = j_default_camera(w, h).pytree()
    j_img, j_a = j_render_sharded(jcfg, jsc, jcam, w, h, spp, _mesh(2),
                                  seed=seed)
    with jax.disable_jit():
        u_img, u_a = j_pt.render(jcfg, jsc, jcam, w, h, spp, seed=seed,
                                 method="regen")
    gaps = {"port_vs_unjit_abs": float(np.abs(img - np.asarray(u_img)).max()),
            "jit_vs_unjit_abs": float(np.abs(np.asarray(j_img)
                                             - np.asarray(u_img)).max()),
            "port_vs_jit": _gap(img, j_img), "jit_vs_unjit": _gap(j_img, u_img)}
    for k, v in gaps.items():
        record_property(k, v)
    np.testing.assert_allclose(img, np.asarray(u_img), atol=RENDER_TOL)
    np.testing.assert_allclose(alpha, np.asarray(u_a), atol=RENDER_TOL)
    np.testing.assert_allclose(img, np.asarray(j_img), rtol=RENDER_TOL,
                               atol=RENDER_TOL)
    np.testing.assert_allclose(alpha, np.asarray(j_a), rtol=RENDER_TOL,
                               atol=RENDER_TOL)
    cfg, sc = _port_scene()
    w_img, w_a = pathtracer.render(cfg, sc, default_camera(w, h).pytree("cpu"),
                                   w, h, spp, seed=seed, method="while")
    np.testing.assert_allclose(img, w_img.numpy(), atol=RENDER_TOL)
    np.testing.assert_allclose(alpha, w_a.numpy(), atol=RENDER_TOL)
    assert img.mean() > 0


def test_train_step_update_rank_count_invariant(ranks):
    """The SGD update is bitwise the same on 1 and 2 ranks (the reference's
    test_train_step_update_device_count_invariant), on every rank, and it
    moves the parameters."""
    loss1, color1, sigma1, _ = ranks[1][0]["train"]
    for res in ranks[2]:
        loss2, color2, sigma2, _ = res["train"]
        assert abs(loss2 - loss1) < 1e-6
        np.testing.assert_array_equal(color2, color1)
        np.testing.assert_array_equal(sigma2, sigma1)
    _, sc = _port_scene()
    assert np.abs(color1 - sc.color.numpy()).max() > 1e-5


@pytest.mark.parametrize("world", [1, 2])
def test_train_step_matches_jax(ranks, world):
    """At lr = 1 the update is the gradient: the port's on ``world`` ranks
    against the JAX ``make_train_step`` on a ``world``-device mesh, within
    the suite's gradient tolerance; the losses within 1e-6."""
    side = worker.TRAIN_SIDE
    jcfg, jsc = j_load("scenes/cornell_simple.json")
    step = j_make_train_step(jcfg, side, side, 1, _mesh(world), lr=1.0)
    target = jnp.full((side * side, 3), worker.TRAIN_TARGET, jnp.float32)
    j_loss, j_s2 = step(jsc, j_default_camera(side, side).pytree(), target, 0)
    loss, color, sigma, _ = ranks[world][0]["train_lr1"]
    _, sc = _port_scene()
    assert abs(loss - float(j_loss)) <= 1e-6 * max(1.0, abs(float(j_loss)))
    for got, old, want, jold in (
            (color, sc.color, j_s2.color, jsc.color),
            (sigma, sc.medium_sigma_t, j_s2.medium_sigma_t,
             jsc.medium_sigma_t)):
        np.testing.assert_allclose(old.numpy() - got,
                                   np.asarray(jold) - np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("world", [1, 2])
def test_collectives_of_a_step(ranks, world):
    """A step issues exactly two all-reduces: the loss (one element) and
    ONE flat buffer of every parameter's gradient; nothing else."""
    _, sc = _port_scene()
    n_grad = sum(getattr(sc, k).numel() for k in render.PARAM_LEAVES)
    for res in ranks[world]:
        for job in ("train", "train_lr1"):
            calls = res[job][-1]
            assert calls == [("all_reduce", 1), ("all_reduce", n_grad)], calls


@pytest.mark.parametrize("world,job,gathers", [(1, "frame", 0),
                                               (2, "frame", 1),
                                               (2, "padded", 1),
                                               (3, "padded3", 1)])
def test_collectives_of_a_render(ranks, world, job, gathers):
    """A sharded render issues one all_gather of each rank's (radiance,
    alpha) block and no other collective; one rank issues none."""
    w, h = worker.RENDERS[job][:2]
    per = -(-w * h // world)
    for res in ranks[world]:
        assert res[job][-1] == [("all_gather", per * 4)] * gathers


@pytest.mark.parametrize("world", [1, 2, 3])
def test_local_shard_bounds_partition(ranks, world):
    """The ranks' [start, end) slices tile [0, n) in order, with the
    reference's ceil(n / world) per rank."""
    for i, n in enumerate(worker.BOUNDS_N):
        bounds = [res["bounds"][i] for res in ranks[world]]
        per = -(-n // world)
        assert bounds[0][0] == 0 and bounds[-1][1] == n, bounds
        for r, (lo, hi) in enumerate(bounds):
            assert 0 <= lo <= hi <= n
            assert hi - lo == min(per, max(n - r * per, 0))
            if r:
                assert lo == bounds[r - 1][1]
    assert [res["rank_world"] for res in ranks[world]] == [
        (r, world) for r in range(world)]


def test_global_mesh_covers_all_ranks(ranks):
    for r, res in enumerate(ranks[2]):
        assert res["mesh"] == ((RAYS_AXIS,), 2, r)


def test_initialize_single_process_noop(monkeypatch):
    """No coordinator and no WORLD_SIZE: no group, (0, 1), the whole range;
    a second call is a no-op too."""
    for name in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    distributed.initialize()
    distributed.initialize()
    assert not torch.distributed.is_initialized()
    assert distributed.rank_world() == (0, 1)
    assert distributed.local_shard_bounds(100) == (0, 100)
    with pytest.raises(RuntimeError, match="initialize"):
        distributed.global_mesh("cpu")
    # one rank outside a group: the frame with no collective
    cfg, sc = _port_scene()
    img, _ = render.render_sharded(cfg, sc, default_camera(8, 8).pytree("cpu"),
                                   8, 8, 1)
    np.testing.assert_array_equal(img.numpy(),
                                  _trace_regen_frame(8, 8, 1, 0)[0].numpy())


def test_cli_sharded_under_torchrun(tmp_path):
    """``--sharded --device cpu`` under torchrun on 2 ranks: rank 0 writes
    a PNG byte for byte the one written the same way (``app._export``) from
    the single-process ``trace_regen`` frame of the CLI's camera and seed.
    (The unsharded CLI runs the progressive loop, another estimator.)"""
    w, h, spp, seed = 20, 15, 2, 3
    out = str(tmp_path / "sharded.png")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", app.PROG, "-scene",
         "scenes/cornell_simple.json", "-width", str(w), "-height", str(h),
         "-spp", str(spp), "--seed", str(seed), "--sharded", "--device",
         "cpu", "-o", out],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "sharding 20x15 over 2 ranks (gloo)" in r.stdout
    assert r.stdout.count(f"saved {out}") == 1  # rank 0 alone exports
    cam = InteractiveCamera(resolution=(w, h)).build_render_camera().pytree("cpu")
    img, _ = _trace_regen_frame(w, h, spp, seed, cam)
    want = str(tmp_path / "want.png")
    app._export(want, img, None, 0)
    assert open(out, "rb").read() == open(want, "rb").read()


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    """The twin of __graft_entry__.dryrun_multichip: a 16^2 sharded render
    and one train step of the tiny icosphere scene over 2 gloo ranks."""
    dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): loss=" in capfd.readouterr().out
