"""The check that decides ``correct`` has to fail what it is there to catch,
at sizes the CPU holds: the control (the reference in bfloat16 in the
program's place), and a run whose timed path is broken underneath by each
fault a cell can have (a step that leaves its state unchanged, half the
batch left out with the mean taken over the rest, an answer altered where
it is produced).  The same control runs on the card at each cell's own
size through ``benchmark/control.py``.

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""
from __future__ import annotations

import pytest
import torch

from benchmark import control
from benchmark.harness import core
from benchmark.tests.tiny import TINY_CELLS, tiny_tree

SEED = 2**31 + 4242


@pytest.fixture
def root(tmp_path, monkeypatch):
    # the CPU takes the walk's plain twin, as the card takes W1
    monkeypatch.setenv("PRT_MESH_ACCEL", "bvh")
    return tiny_tree(str(tmp_path))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.parametrize("cell", sorted(TINY_CELLS.values()))
def test_the_control_and_planted_faults_are_not_correct(cell, root):
    for out in control.control(root, cell, SEED, passes=3, device="cpu"):
        assert not out["correct"], out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_the_control_is_not_correct_on_the_card(cell, card, tmp_path):
    root = tiny_tree(str(tmp_path))
    for out in control.control(root, cell, SEED, passes=3):
        assert not out["correct"], out


def _render_fault(name, monkeypatch):
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    if name == "unchanged":
        monkeypatch.setattr(pathtracer, "progressive_step",
                            lambda cfg, scene, cam, state, *a, **k: state)
        return
    real = pathtracer.render_sample

    def broken(*args, **kwargs):
        rad, alpha = real(*args, **kwargs)
        if name == "half_batch":
            keep = torch.arange(rad.shape[0], device=rad.device) % 2 == 0
            rad = torch.where(keep[:, None], rad * 2.0, 0.0)
        else:  # "altered"
            rad = rad * 1.001
        return rad, alpha

    monkeypatch.setattr(pathtracer, "render_sample", broken)


def _grad_fault(name, monkeypatch):
    from photorealistic_rendering_using_opencl_tpu_torch.diff import inverse
    from photorealistic_rendering_using_opencl_tpu_torch.models import pathtracer
    if name == "unchanged":
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
        return

    def broken(cfg, scene, cam, width, height, spp, target, seed=0,
               method="scan", regen_iters=0):
        img, _ = pathtracer.render(cfg, scene, cam, width, height, spp,
                                   seed=seed, method=method,
                                   regen_iters=regen_iters)
        if name == "half_batch":
            return torch.mean(torch.square(img - target)[::2])
        return torch.mean(torch.square(img * 1.001 - target))  # "altered"

    monkeypatch.setattr(inverse, "image_loss", broken)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS.values()))
def test_a_broken_timed_path_is_not_correct(cell, fault, root, monkeypatch):
    kind = core.find_cell(core.load_spec(root), root, cell)["traffic"]["kind"]
    (_render_fault if kind == "render" else _grad_fault)(fault, monkeypatch)
    res = core.run(root, cell, SEED, 0.01, False, device="cpu")
    assert not res["correct"], res["checks"]
