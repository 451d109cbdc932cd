"""The runtime layer against the JAX package's: the interactive camera and
the shell's commands, checkpoints (each package's and across packages),
terminal frames, image IO bytes, the config manifest, and Metrics.

Twins of tests/test_runtime.py, tests/test_interactive.py and the Metrics
half of tests/test_noise_profiling.py, held to the JAX package: strings,
bytes, camera fields and dicts equal; images within 1e-5.
"""
import base64
import dataclasses
import functools
import json
import os
import re
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.models import pathtracer as j_pt
from photorealistic_rendering_using_opencl_tpu.runtime import app as j_app
from photorealistic_rendering_using_opencl_tpu.runtime import camera as j_camera
from photorealistic_rendering_using_opencl_tpu.runtime import checkpoint as j_ckpt
from photorealistic_rendering_using_opencl_tpu.runtime import terminal as j_terminal
from photorealistic_rendering_using_opencl_tpu.scene.loader import load_scene as j_load
from photorealistic_rendering_using_opencl_tpu.utils import config as j_config
from photorealistic_rendering_using_opencl_tpu.utils import image as j_image
from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
from photorealistic_rendering_using_opencl_tpu_torch.runtime import app, camera, checkpoint, terminal
from photorealistic_rendering_using_opencl_tpu_torch.scene.loader import load_scene
from photorealistic_rendering_using_opencl_tpu_torch.scene.obj import make_icosphere
from photorealistic_rendering_using_opencl_tpu_torch.utils import config, image, profiling

torch.set_num_threads(2)

CAM_FIELDS = ("center", "yaw", "pitch", "radius", "aperture_radius",
              "focal_distance", "resolution", "fov_x")


def _assert_same_camera(tc, jc):
    for f in CAM_FIELDS:
        a, b = getattr(tc, f), getattr(jc, f)
        assert type(a) is type(b), f
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        else:
            assert a == b, f
    tr, jr = tc.build_render_camera(), jc.build_render_camera()
    for f in dataclasses.fields(jr):
        a, b = np.asarray(getattr(tr, f.name)), np.asarray(getattr(jr, f.name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name


# (operation, argument): every edit, at values that reach every clamp
CAMERA_OPS = [
    ("change_yaw", 0.3), ("change_yaw", 7.0), ("change_yaw", -13.1),
    ("change_pitch", 0.4), ("change_pitch", 10.0), ("change_pitch", -10.0),
    ("change_radius", 0.5), ("change_radius", -0.99), ("change_radius", -0.99),
    ("change_radius", -0.99), ("change_radius", 1e3), ("change_radius", 1e3),
    ("change_altitude", 0.37), ("go_forward", 0.8), ("strafe", -0.45),
    ("change_aperture_diameter", 0.1), ("change_aperture_diameter", 900.0),
    ("change_aperture_diameter", -5.0), ("change_focal_distance", 0.3),
    ("change_focal_distance", -1000.0), ("change_focal_distance", 1e4),
    ("set_fov_x", 60.0), ("change_pitch", 0.7), ("strafe", 0.2),
]


def test_interactive_camera_ops_and_clamps_match_reference():
    tc = camera.InteractiveCamera(resolution=(64, 48))
    jc = j_camera.InteractiveCamera(resolution=(64, 48))
    _assert_same_camera(tc, jc)
    for op, m in CAMERA_OPS:
        getattr(tc, op)(m)
        getattr(jc, op)(m)
        _assert_same_camera(tc, jc)
    assert tc.radius == 100.0 and tc.aperture_radius == 0.0
    assert tc.focal_distance == 100.0


def test_build_render_camera_is_the_ports_camera():
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        Camera, default_camera,
    )
    built = camera.InteractiveCamera(resolution=(64, 48)).build_render_camera()
    assert isinstance(built, Camera)
    cam = built.pytree("cpu")
    ref = default_camera(64, 48).pytree("cpu")
    for k, v in ref.items():
        torch.testing.assert_close(cam[k], v, rtol=0, atol=1e-6)


COMMANDS = (["orbit 20 10", "orbit -3.5 41", "zoom 5", "zoom -250", "pan 3",
             "pan -0.5", "+", "-", "space", " ", "bogus 1 2", "orbit 1",
             "zoom x", ""] + sorted(camera.KEY_BINDINGS))


def test_handle_command_matches_reference():
    """Every command and key, applied in turn to both packages' cameras:
    the same (changed, handled) and the same camera after each."""
    assert sorted(camera.KEY_BINDINGS) == sorted(j_camera.KEY_BINDINGS)
    tc = camera.InteractiveCamera(resolution=(32, 32))
    jc = j_camera.InteractiveCamera(resolution=(32, 32))
    for key in COMMANDS * 2:
        tc, t_changed, t_handled = app.handle_command(
            key, tc, lambda: camera.InteractiveCamera(resolution=(32, 32)))
        jc, j_changed, j_handled = j_app.handle_command(
            key, jc, lambda: j_camera.InteractiveCamera(resolution=(32, 32)))
        assert (t_changed, t_handled) == (j_changed, j_handled), key
        _assert_same_camera(tc, jc)


def test_mouse_equivalent_commands():
    c = camera.InteractiveCamera()

    def reset():
        return camera.InteractiveCamera()

    yaw0, pitch0 = c.yaw, c.pitch
    c, changed, handled = app.handle_command("orbit 20 10", c, reset)
    assert handled and changed and c.yaw != yaw0 and c.pitch != pitch0
    r0 = c.radius
    c, changed, _ = app.handle_command("zoom 5", c, reset)
    assert changed and c.radius < r0
    c, changed, _ = app.handle_command("space", c, reset)
    assert changed and c.yaw == 0.0 and c.radius == 4.0
    c, changed, handled = app.handle_command("bogus 1 2", c, reset)
    assert not handled and not changed


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

W, H = 16, 12


@functools.cache
def _cornell_simple():
    return (j_load("scenes/cornell_simple.json")
            + load_scene("scenes/cornell_simple.json", device="cpu"))


def _steps(pkg, state, n):
    jcfg, jsc, cfg, sc = _cornell_simple()
    if pkg == "jax":
        jcam = j_camera.InteractiveCamera(resolution=(W, H)).build_render_camera()
        for _ in range(n):
            state = j_pt.progressive_step(jcfg, jsc, jcam.pytree(), state)
        return state
    cam = camera.InteractiveCamera(resolution=(W, H)).build_render_camera()
    for _ in range(n):
        state = pathtracer.progressive_step(cfg, sc, cam.pytree("cpu"), state)
    return state


def test_checkpoint_roundtrip(tmp_path):
    _, _, cfg, sc = _cornell_simple()
    state = _steps("torch", pathtracer.progressive_init(W, H, seed=5,
                                                        device="cpu"), 2)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_checkpoint(path, state, sc, extra={"spp_target": 8})
    assert not os.path.exists(path + ".tmp")
    state2, sc2, extra = checkpoint.load_checkpoint(path, scene_template=sc,
                                                    device="cpu")
    assert extra == {"spp_target": 8}
    for f in state._fields:
        assert torch.equal(getattr(state, f), getattr(state2, f)), f
    for f in dataclasses.fields(sc):
        assert torch.equal(getattr(sc, f.name), getattr(sc2, f.name)), f.name
    with np.load(path) as z:
        assert z["state.samples"].dtype == z["state.seed"].dtype == np.uint32
        assert z["state.acc"].dtype == np.float32
    resumed = _steps("torch", state2, 2)
    straight = _steps("torch", pathtracer.progressive_init(W, H, seed=5,
                                                           device="cpu"), 4)
    assert torch.equal(resumed.acc, straight.acc)
    assert int(resumed.samples) == 4


def test_checkpoint_with_scene_needs_a_template(tmp_path):
    _, _, _, sc = _cornell_simple()
    path = str(tmp_path / "c.npz")
    checkpoint.save_checkpoint(path, pathtracer.progressive_init(
        W, H, device="cpu"), sc)
    with pytest.raises(ValueError, match="scene_template"):
        checkpoint.load_checkpoint(path, device="cpu")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_across_packages(tmp_path, writer):
    """Saved by one package after 2 steps, loaded by the other and stepped
    to 4: the straight 4-step accumulation within 1e-5; samples and seed
    exact."""
    path = str(tmp_path / "x.npz")
    if writer == "jax":
        j_ckpt.save_checkpoint(path, _steps("jax", j_pt.progressive_init(
            W, H, seed=0xFFFFFFF0), 2), extra={"by": writer})
        state, _, extra = checkpoint.load_checkpoint(path, device="cpu")
        assert int(state.samples) == 2 and int(state.seed) == 0xFFFFFFF0
        got = _steps("torch", state, 2)
    else:
        checkpoint.save_checkpoint(path, _steps("torch", pathtracer.progressive_init(
            W, H, seed=0xFFFFFFF0, device="cpu"), 2), extra={"by": writer})
        state, _, extra = j_ckpt.load_checkpoint(path)
        assert state.samples.dtype == state.seed.dtype == jnp.uint32
        assert int(state.samples) == 2 and int(state.seed) == 0xFFFFFFF0
        got = _steps("jax", state, 2)
    assert extra == {"by": writer}
    want = _steps("torch", pathtracer.progressive_init(W, H, seed=0xFFFFFFF0,
                                                       device="cpu"), 4)
    assert int(got.samples) == 4 and int(got.seed) == 0xFFFFFFF0
    np.testing.assert_allclose(np.asarray(got.acc), want.acc.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.alpha), want.alpha.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_checkpoint_version_checked(tmp_path):
    path = str(tmp_path / "v.npz")
    meta = np.frombuffer(json.dumps({"version": 99}).encode(), np.uint8)
    np.savez(path, meta=meta)
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_checkpoint(path, device="cpu")


# ---------------------------------------------------------------------------
# terminal frames
# ---------------------------------------------------------------------------

def _ldr(h, w, seed):
    img = np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)
    img[0, 0] = [0.0, 1.0, 0.5]
    return img


@pytest.mark.parametrize("protocol", ["ansi", "kitty", "iterm2", "sixel"])
@pytest.mark.parametrize("shape", [(12, 16), (45, 33), (700, 900)])
def test_image_str_matches_reference(protocol, shape):
    """The same frame in every protocol: strings equal (the large frame is
    downsampled to the character grid's budget first)."""
    img = _ldr(*shape, seed=shape[0])
    got = terminal.image_str(img, protocol=protocol, max_cols=40, max_rows=12)
    assert got == j_terminal.image_str(img, protocol=protocol, max_cols=40,
                                       max_rows=12)
    assert got.startswith({"ansi": "\x1b[38;2", "kitty": "\x1b_G",
                           "iterm2": "\x1b]1337", "sixel": "\x1bPq"}[protocol])


def _preview_channels(s: str, protocol: str, tmp_path) -> np.ndarray:
    """A preview string's 8-bit channels: the ANSI escapes' colours, or the
    inline PNG's pixels."""
    if protocol == "ansi":
        return np.array([int(x) for x in re.findall(r"\x1b\[[34]8;2;(\d+);(\d+);(\d+)m", s)
                         for x in x], np.int32)
    payload = (re.sub(r"\x1b_G[^;]*;|\x1b\\", "", s) if protocol == "kitty"
               else s[s.index(":") + 1:-1])
    path = tmp_path / f"{protocol}.png"
    path.write_bytes(base64.standard_b64decode(payload))
    return image.read_png(str(path)).astype(np.int32)


@pytest.mark.parametrize("protocol", ["ansi", "kitty", "iterm2"])
def test_preview_str_within_one_level_of_reference(protocol, tmp_path):
    """The viewer's preview of one HDR frame against the reference's: the
    port tonemaps (the plain version on the CPU), quantises to 8 bits and
    then downsamples; the reference downsamples the float image first.  So
    each downsampled channel lies within 1 of the reference's 255 levels,
    and some do differ (the 8-bit copy is what crosses from the card)."""
    from photorealistic_rendering_using_opencl_tpu.ops.tonemap import tonemap as j_tonemap
    img = _hdr_image(700, 900, seed=5)
    got = app.preview_str(torch.from_numpy(img), protocol=protocol)
    want = j_terminal.image_str(np.asarray(j_tonemap(jnp.asarray(img))),
                                protocol=protocol)
    a = _preview_channels(got, protocol, tmp_path)
    b = _preview_channels(want, protocol, tmp_path)
    assert a.shape == b.shape and a.size > 0
    assert int(np.abs(a - b).max()) == 1


def test_ansi_image_and_protocol_detection(monkeypatch):
    img = np.zeros((32, 32, 3), np.float32)
    img[:16] = [1.0, 0.0, 0.0]
    img[16:] = [0.0, 0.0, 1.0]
    s = terminal.ansi_image(img, max_cols=16, max_rows=8)
    assert "▀" in s and "38;2;255;0;0" in s and "48;2;0;0;255" in s
    assert len(s.splitlines()) == 8
    assert s == j_terminal.ansi_image(img, max_cols=16, max_rows=8)
    for env in ({"PRT_TERM_GRAPHICS": "sixel"}, {"TERM": "xterm-kitty"},
                {"TERM_PROGRAM": "WezTerm"}, {"TERM": "mlterm"},
                {"TERM": "xterm-256color"}):
        for k in ("PRT_TERM_GRAPHICS", "TERM", "TERM_PROGRAM",
                  "KITTY_WINDOW_ID"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert terminal.detect_protocol() == j_terminal.detect_protocol()


# ---------------------------------------------------------------------------
# image IO
# ---------------------------------------------------------------------------

def _hdr_image(h, w, seed):
    r = np.random.default_rng(seed)
    img = (r.random((h, w, 3)) * np.exp(r.normal(0, 4, (h, w, 1)))).astype(np.float32)
    img[0, :3] = 0.0  # black: the zero exponent
    if h > 1 and w > 1:
        img[1, 0] = [1e-33, 0.0, 0.0]  # below RGBE's range
        img[1, 1] = [3e4, 2.0, 0.5]
    return img


@pytest.mark.parametrize("shape", [(1, 1), (7, 13), (32, 48)])
def test_write_hdr_and_png_bytes_match_reference(tmp_path, shape):
    img = _hdr_image(*shape, seed=shape[1])
    a, b = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    image.write_hdr(a, img)
    j_image.write_hdr(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    for x in (img, np.clip(img, 0, 1), (img * 40).astype(np.uint8),
              np.concatenate([np.clip(img, 0, 1), img[..., :1]], -1),
              np.clip(img[..., 0], 0, 1)):
        assert image.png_bytes(x) == j_image.png_bytes(x)


def test_read_hdr_round_trip_within_rgbe(tmp_path):
    img = _hdr_image(20, 24, seed=1)
    path = str(tmp_path / "r.hdr")
    image.write_hdr(path, img)
    back = image.read_hdr(path)
    assert back.dtype == np.float32 and back.shape == img.shape
    np.testing.assert_array_equal(back, j_image.read_hdr(path))  # values
    # RGBE keeps 8 mantissa bits of the largest channel of each pixel
    step = np.ldexp(1.0, np.frexp(img.max(axis=2))[1] - 8)[..., None]
    big = img.max(axis=2) >= 1e-32
    err = np.abs(back - img)[big]
    assert (err <= step[big] * 1.0001).all()


def _rle_channel(vals):
    out, x = bytearray(), 0
    while x < len(vals):
        run = 1
        while x + run < len(vals) and run < 127 and vals[x + run] == vals[x]:
            run += 1
        if run >= 3:
            out += bytes([128 + run, vals[x]])
            x += run
        else:
            n = min(128, len(vals) - x)
            out += bytes([n]) + bytes(vals[x:x + n])
            x += n
    return bytes(out)


def test_read_hdr_rle_scanlines_match_reference(tmp_path):
    """Adaptive-RLE scanlines (runs and literals), as other tools write."""
    h, w = 5, 40
    r = np.random.default_rng(2)
    rgbe = r.integers(0, 256, (h, w, 4), dtype=np.uint8)
    rgbe[:, 10:30] = rgbe[:, 10:11]  # runs
    data = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        data += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            data += _rle_channel(rgbe[y, :, c].tolist())
    path = tmp_path / "rle.hdr"
    path.write_bytes(data)
    got = image.read_hdr(str(path))
    np.testing.assert_array_equal(got, j_image.read_hdr(str(path)))
    e = rgbe[..., 3].astype(np.int32)
    want = (rgbe[..., :3] + 0.5) * np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)[..., None]
    np.testing.assert_array_equal(got, want.astype(np.float32))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def _png_with_filters(img):
    """A PNG whose rows use filters 0-4 in turn (the writer uses 0 only)."""
    h, w, nch = img.shape
    rows = img.reshape(h, w * nch).astype(np.int32)
    raw, prev = b"", np.zeros(w * nch, np.int32)
    for y in range(h):
        f, cur = y % 5, rows[y]
        enc = []
        for x in range(w * nch):
            a = int(cur[x - nch]) if x >= nch else 0
            b = int(prev[x])
            c = int(prev[x - nch]) if x >= nch else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, c)][f]
            enc.append((int(cur[x]) - pred) & 0xFF)
        raw += bytes([f] + enc)
        prev = cur

    def chunk(tag, d):
        return (struct.pack(">I", len(d)) + tag + d
                + struct.pack(">I", zlib.crc32(tag + d) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[nch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("nch", [1, 2, 3, 4])
def test_read_png_every_filter_and_round_trip(tmp_path, nch):
    img = np.random.default_rng(nch).integers(0, 256, (11, 9, nch), dtype=np.uint8)
    p = tmp_path / "f.png"
    p.write_bytes(_png_with_filters(img))
    got = image.read_png(str(p))
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, j_image.read_png(str(p)))
    if nch in (1, 3, 4):
        q = str(tmp_path / "w.png")
        image.write_png(q, img if nch > 1 else img[..., 0])
        back = image.read_png(q)
        np.testing.assert_array_equal(back, img if nch > 1
                                      else np.repeat(img, 3, axis=2))


def test_read_png_refuses_other_files(tmp_path):
    p = tmp_path / "x.png"
    p.write_bytes(b"GIF89a" + bytes(10))
    with pytest.raises(ValueError, match="not a PNG"):
        image.read_png(str(p))


@pytest.mark.parametrize("name,encoder", [("a.png", 0), ("b", 0), ("c", 1),
                                          ("d.hdr", 0), ("e.png", 1)])
def test_save_image_matches_reference(tmp_path, name, encoder):
    img = _hdr_image(6, 5, seed=3)
    ldr = np.clip(img, 0, 1) if encoder == 0 and not name.endswith(".hdr") else img
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    image.save_image(str(tmp_path / "t" / name), ldr, encoder)
    j_image.save_image(str(tmp_path / "j" / name), ldr, encoder)
    ours, theirs = sorted(os.listdir(tmp_path / "t")), sorted(os.listdir(tmp_path / "j"))
    assert ours == theirs and len(ours) == 1
    assert ((tmp_path / "t" / ours[0]).read_bytes()
            == (tmp_path / "j" / ours[0]).read_bytes())


# ---------------------------------------------------------------------------
# config manifest, Metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path,mesh", [
    ("scenes/cornell_simple.json", None), ("scenes/materials.json", None),
    ("scenes/cornell.json", dict(subdiv=1, radius=0.6, center=(0, -1, 0)))])
def test_describe_and_manifest_match_reference(path, mesh):
    mesh_np = None if mesh is None else make_icosphere(**mesh)
    jcfg, _ = j_load(path, mesh_override=mesh_np)
    cfg, _ = load_scene(path, mesh_override=mesh_np, device="cpu")
    assert config.describe(cfg) == j_config.describe(jcfg)
    extra = {"scene": path, "method": "while"}
    assert (config.manifest(cfg, 64, 32, 8, seed=3, extra=extra)
            == j_config.manifest(jcfg, 64, 32, 8, seed=3, extra=extra))


def test_metrics_spans_and_rates():
    m = profiling.Metrics()
    with m.span("render"):
        sum(range(20000))
    with m.span("render"):
        pass
    m.count("rays", 1e6)
    m.count("rays", 5e5)
    total, count = m.spans["render"]
    assert count == 2 and total > 0
    assert m.counters["rays"] == 1.5e6
    assert m.rate("rays", "render") == pytest.approx(1.5e6 / total)
    rep = m.report()
    assert "render:" in rep and "over 2 calls" in rep and "rays: 1,500,000" in rep
    assert profiling.samples_per_sec(64, 32, 4, 2.0) == 64 * 32 * 4 / 2.0


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with profiling.torch_trace(None):
        pass  # no-op
    d = tmp_path / "prof"
    with profiling.torch_trace(str(d)):
        torch.ones(64).cumsum(0)
    trace = json.loads((d / profiling.TRACE_FILE).read_text())
    assert trace["traceEvents"]
