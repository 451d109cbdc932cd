"""The PyTorch port imports without JAX and without a GPU toolchain."""
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "photorealistic_rendering_using_opencl_tpu_torch"

# the package's sources (its gitignored _build/ holds build outputs only)
SOURCES = sorted(p for p in PKG.rglob("*.py")
                 if "_build" not in p.relative_to(PKG).parts)
MODULES = [".".join(p.relative_to(REPO).with_suffix("").parts)
           for p in SOURCES if p.name != "__init__.py"]


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a fresh interpreter in which
    ``import jax`` fails, and none of them pulls jax in."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        f"mods = {MODULES!r}\n"
        "import importlib\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') "
        "for k, v in sys.modules.items() if v is not None)\n"
        "print(len(mods))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) == len(MODULES) >= 15


@pytest.mark.parametrize("path", [p.relative_to(REPO).as_posix()
                                  for p in SOURCES])
def test_port_source_never_names_jax(path):
    text = (REPO / path).read_text()
    for line in text.splitlines():
        s = line.strip()
        assert not s.startswith(("import jax", "from jax")), (path, line)


def test_native_source_is_the_ports_own_copy():
    """runtime/native.py builds a source inside the port package, the JAX
    package's code line for line (only comments may differ), and reads
    nothing of the JAX package."""
    from photorealistic_rendering_using_opencl_tpu_torch.runtime import native
    src = pathlib.Path(native._SRC).resolve()
    assert src.is_relative_to(PKG.resolve())
    jax_src = (REPO / "photorealistic_rendering_using_opencl_tpu" / "runtime"
               / "csrc" / "prt_native.cpp")
    ours, theirs = src.read_text().splitlines(), jax_src.read_text().splitlines()
    assert len(ours) == len(theirs)
    changed = [(a, b) for a, b in zip(ours, theirs) if a != b]
    assert len(changed) <= 2
    assert all(a.lstrip().startswith("//") and b.lstrip().startswith("//")
               for a, b in changed)
    text = (PKG / "runtime" / "native.py").read_text()
    assert '"photorealistic_rendering_using_opencl_tpu"' not in text


def test_entry_points_default_to_the_card(monkeypatch):
    """load_scene, build_scene and Camera.pytree run on the card unless the
    caller asks for the CPU; without a card they raise, never fall back."""
    import torch
    from photorealistic_rendering_using_opencl_tpu_torch.ops.camera_rays import (
        default_camera,
    )
    from photorealistic_rendering_using_opencl_tpu_torch.scene import loader
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.load_scene(str(REPO / "scenes/cornell_simple.json"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loader.build_scene({"scene": {}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_camera(8, 8).pytree()
    cfg, sc = loader.load_scene(str(REPO / "scenes/cornell_simple.json"),
                                device="cpu")
    assert sc.device.type == "cpu"
    assert default_camera(8, 8).pytree("cpu")["position"].device.type == "cpu"
