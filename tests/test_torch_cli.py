"""The port's command line, run as a user runs it
(``python -m photorealistic_rendering_using_opencl_tpu_torch``), with
``--device cpu``, on cornell_simple.json at 32^2 x 4 spp: batch, checkpoint
and resume, the five AOVs, HDR export, the interactive viewer with piped
commands, and the JAX package's CLI PNG on the same arguments (within 1
LSB: the two tonemaps agree within 1e-6).
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import default_camera
from photorealistic_rendering_using_opencl_tpu_torch.ops.tonemap import tonemap
from photorealistic_rendering_using_opencl_tpu_torch.runtime import app
from photorealistic_rendering_using_opencl_tpu_torch.runtime.camera import InteractiveCamera
from photorealistic_rendering_using_opencl_tpu_torch.runtime.checkpoint import load_checkpoint
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.utils.image import (
    read_hdr, read_png, write_hdr,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = "scenes/cornell_simple.json"
ARGS = ["-scene", SCENE, "-width", "32", "-height", "32", "-spp", "4"]


def _cli(args, pkg=app.PROG, stdin=None, env=None, timeout=600):
    full_env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
                    **(env or {}))
    return subprocess.run([sys.executable, "-m", pkg, *args],
                          capture_output=True, text=True, timeout=timeout,
                          env=full_env, cwd=REPO, input=stdin)


def _ok(r):
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r


def _image(spp, seed=0, w=32, h=32):
    cfg, sc = load_scene(os.path.join(REPO, SCENE), device="cpu")
    cam = InteractiveCamera(resolution=(w, h)).build_render_camera().pytree("cpu")
    state = pathtracer.progressive_init(w, h, seed=seed, device="cpu")
    for _ in range(spp):
        state = pathtracer.progressive_step(cfg, sc, cam, state)
    return state, cfg, sc, cam


def test_cli_batch_checkpoint_and_resume(tmp_path):
    out, ck = str(tmp_path / "out.png"), str(tmp_path / "ck.npz")
    r = _ok(_cli(ARGS + ["--device", "cpu", "-o", out, "--checkpoint", ck,
                         "--checkpoint-interval", "2"]))
    assert "4/4 spp" in r.stdout and f"saved {out}" in r.stdout
    assert "32x32 @ 4 spp" in r.stdout and "resumed" not in r.stdout
    want, _, _, _ = _image(4)
    state, _, _ = load_checkpoint(ck, device="cpu")
    assert int(state.samples) == 4 and torch.equal(state.acc, want.acc)
    png = read_png(out)
    img, _ = pathtracer.progressive_image(want)
    assert png.shape == (32, 32, 3)
    np.testing.assert_array_equal(png, app.ldr_u8(tonemap(img)))
    # already at its target: resumes, renders nothing, exports again
    os.remove(out)
    r2 = _ok(_cli(ARGS + ["--device", "cpu", "-o", out, "--checkpoint", ck]))
    assert f"resumed {ck} at 4 samples" in r2.stdout
    assert "32x32 @ 4 spp" in r2.stdout
    np.testing.assert_array_equal(read_png(out), png)
    # further: 2 more samples on top of the checkpoint
    r3 = _ok(_cli(["-scene", SCENE, "-width", "32", "-height", "32", "-spp",
                   "6", "--device", "cpu", "-o", out, "--checkpoint", ck]))
    assert "resumed" in r3.stdout and "6/6 spp" in r3.stdout
    six, _, _, _ = _image(6)
    state, _, _ = load_checkpoint(ck, device="cpu")
    assert int(state.samples) == 6 and torch.equal(state.acc, six.acc)


def test_cli_png_matches_the_jax_cli(tmp_path):
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    _ok(_cli(ARGS + ["--device", "cpu", "--seed", "3", "-alpha", "-o", ours]))
    _ok(_cli(ARGS + ["--seed", "3", "-alpha", "-o", theirs],
             pkg="photorealistic_rendering_using_opencl_tpu",
             env={"JAX_PLATFORMS": "cpu"}))
    a, b = read_png(ours), read_png(theirs)
    assert a.shape == b.shape == (32, 32, 4)
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert a[..., :3].mean() > 10


@pytest.mark.parametrize("mode", pathtracer.AOV_MODES)
def test_cli_aov(tmp_path, mode):
    out = str(tmp_path / f"{mode}.png")
    _ok(_cli(["-scene", SCENE, "-width", "24", "-height", "20", "--aov", mode,
              "--device", "cpu", "-o", out]))
    cfg, sc = load_scene(os.path.join(REPO, SCENE), device="cpu")
    cam = InteractiveCamera(resolution=(24, 20)).build_render_camera().pytree("cpu")
    want = pathtracer.render_aov(cfg, sc, cam, 24, 20, mode=mode)
    np.testing.assert_array_equal(read_png(out), app.ldr_u8(tonemap(want)))


def test_cli_hdr_encoder(tmp_path):
    out = str(tmp_path / "lin.png")
    r = _ok(_cli(ARGS + ["--device", "cpu", "-encoder", "1", "-o", out]))
    path = str(tmp_path / "lin.hdr")
    assert f"saved {path}" in r.stdout and not os.path.exists(out)
    back = read_hdr(path)
    state, _, _, _ = _image(4)
    img = pathtracer.progressive_image(state)[0].numpy()
    # RGBE keeps 8 mantissa bits of each pixel's largest channel
    step = np.ldexp(1.0, np.frexp(img.max(axis=2))[1] - 8)[..., None]
    assert (np.abs(back - img) <= step).all()


def test_cli_interactive_piped_commands(tmp_path):
    out = str(tmp_path / "ia.png")
    r = _ok(_cli(["-scene", SCENE, "-width", "24", "-height", "24",
                  "--interactive", "--no-preview", "--device", "cpu", "-o",
                  out], stdin="orbit 10 5\nbogus\np\nn\nq\n"))
    assert "interactive viewer" in r.stdout
    assert "unknown command 'bogus'" in r.stdout
    assert "samples accumulated" in r.stdout
    assert r.stdout.count(f"saved {out}") == 2  # "p", then on quit
    assert read_png(out).shape == (24, 24, 3)


def test_cli_interactive_preview(tmp_path):
    out = str(tmp_path / "pv.png")
    r = _ok(_cli(["-scene", SCENE, "-width", "16", "-height", "16",
                  "--interactive", "--preview", "--device", "cpu", "-o", out],
                 stdin="q\n", env={"PRT_TERM_GRAPHICS": "ansi"}))
    assert "\x1b[38;2;" in r.stdout and "[1 spp] >" in r.stdout


def test_cli_needs_the_card_unless_told_otherwise(tmp_path):
    """No silent CPU fallback: without a card the default device fails with
    resolve_device's message and writes nothing."""
    out = str(tmp_path / "none.png")
    r = _cli(ARGS + ["-o", out], env={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert not os.path.exists(out)


def test_cli_later_roadmap_flags_raise(tmp_path, monkeypatch):
    """``-hdr`` (ROADMAP M11, ported): the CLI lights the scene with an
    equirect map it reads from a .hdr file, and its PNG is ``render``'s
    image of the same scene and map (``while``, the progressive step's
    method) through the same export; ``--sharded`` (M15, ported) renders
    over torchrun's ranks or a rank a card, and unsharded on one device.
    (The name is from when both raised.)"""
    rng = np.random.default_rng(4)
    env = rng.uniform(0.0, 3.0, (8, 16, 3)).astype(np.float32)
    sky = str(tmp_path / "sky.hdr")
    write_hdr(sky, env)
    out = str(tmp_path / "x.png")
    _ok(_cli(["-scene", "scenes/cornell_simple.json", "-width", "12",
              "-height", "10", "-spp", "2", "--device", "cpu", "-hdr", sky,
              "-o", out]))
    env_read = read_hdr(sky)
    cfg, sc = load_scene("scenes/cornell_simple.json", env_map=env_read,
                         device="cpu")
    assert cfg.has_env_map
    img, _ = pathtracer.render(cfg, sc, default_camera(12, 10).pytree("cpu"),
                                   12, 10, 2, method="while")
    want = str(tmp_path / "want.png")
    app._export(want, img, None, 0)
    assert open(out, "rb").read() == open(want, "rb").read()
    args = types.SimpleNamespace(hdr=None, sharded=True)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert app._ranks(args, torch.device("cpu")) == 1  # one device: unsharded
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert app._ranks(args, torch.device("cuda")) == 1
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert app._ranks(args, torch.device("cuda")) == 2  # a rank a card
    assert app._ranks(args, torch.device("cuda:1")) == 1
    monkeypatch.setenv("WORLD_SIZE", "3")  # torchrun's ranks
    assert app._ranks(args, torch.device("cpu")) == 3
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert app._ranks(args, torch.device("cuda")) == 1
    # across ranks only the batch frame is sharded
    monkeypatch.setenv("WORLD_SIZE", "2")
    for extra in (["--aov", "normal"], ["--interactive"]):
        assert app.main(ARGS + ["--device", "cpu", "--sharded", *extra]) == 1
    assert app._ranks(types.SimpleNamespace(sharded=False),
                      torch.device("cuda")) == 1


def test_cli_sharded_on_one_device_renders_unsharded(tmp_path):
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    _ok(_cli(ARGS + ["--device", "cpu", "-o", a]))
    _ok(_cli(ARGS + ["--device", "cpu", "--sharded", "-o", b]))
    np.testing.assert_array_equal(read_png(a), read_png(b))


def test_main_module_is_guarded():
    """Importing the package's __main__ starts nothing."""
    r = subprocess.run([sys.executable, "-c",
                        f"import {app.PROG}.__main__ as m; print(m.main.__module__)"],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"{app.PROG}.runtime.app"


def _mesh_scene(tmp_path):
    """cornell_simple.json with the repo's 320-triangle icosphere as its
    OBJ mesh, as a scene file of its own."""
    import json
    with open(os.path.join(REPO, SCENE)) as fh:
        doc = json.load(fh)
    doc["scene"]["obj"] = {
        "path": os.path.join(REPO, "scenes/assets/icosphere.obj"),
        "material": {"color": [1.0, 1.0, 1.0], "type": 4, "roughness": 0.1}}
    path = tmp_path / "mesh_scene.json"
    path.write_text(json.dumps(doc))
    return str(path)


def test_cli_in_process_one_mesh_search_per_dispatch(tmp_path, monkeypatch):
    """app.main in-process on a mesh scene: the mesh search (K1 on the
    card, its plain twin here) runs once per dispatch, 1 + the bounces run
    a sample; the tonemap runs once, at export; the image is bitwise
    render(method="while") at the same spp and seed."""
    from photorealistic_rendering_using_opencl_tpu_torch.models import integrator
    from photorealistic_rendering_using_opencl_tpu_torch.ops import mesh_brute
    from photorealistic_rendering_using_opencl_tpu_torch.ops import tonemap as tm
    scene = _mesh_scene(tmp_path)
    counts = {"mesh": 0, "bounces": 0, "tonemap": 0}

    def counted(key, fn):
        def wrapper(*a, **k):
            counts[key] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(mesh_brute, "_intersect_xla",
                        counted("mesh", mesh_brute._intersect_xla))
    monkeypatch.setattr(integrator, "_trace_shade",
                        counted("bounces", integrator._trace_shade))
    monkeypatch.setattr(tm, "tonemap_plain", counted("tonemap", tm.tonemap_plain))
    ck = str(tmp_path / "m.npz")
    assert app.main(["-scene", scene, "-width", "20", "-height", "16", "-spp",
                     "3", "--seed", "4", "--device", "cpu", "--checkpoint", ck,
                     "-o", str(tmp_path / "m.png")]) == 0
    assert counts["bounces"] > 3
    assert counts["mesh"] == counts["bounces"] + 3
    assert counts["tonemap"] == 1
    state, _, _ = load_checkpoint(ck, device="cpu")
    cfg, sc = load_scene(scene, device="cpu")
    assert cfg.has_mesh and cfg.n_triangles == 320
    cam = InteractiveCamera(resolution=(20, 16)).build_render_camera().pytree("cpu")
    with torch.no_grad():
        want, want_a = pathtracer.render(cfg, sc, cam, 20, 16, 3, seed=4,
                                         method="while")
    img, alpha = pathtracer.progressive_image(state)
    assert torch.equal(img, want) and torch.equal(alpha, want_a)
