"""chip_smoke.py --op-census on the CPU alone: the tool that found which
ATen ops give the card other bits than the CPU (its finding is held on the
card by tests/test_torch_cuda.py::test_progressive_on_card_is_cpu_but_for_six_ops).

Here both legs run on the CPU: unchanged, the census finds no source and
the runs are bitwise equal in one round; with one op made to return the
next float32 up on one leg (beneath the recorder, as a device's libm
would), it names that op, its ulps and the port's line that called it.
"""
import importlib.util
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


@pytest.fixture
def cs(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "CENSUS_SCHEMES", ("mwc",))
    monkeypatch.setattr(mod, "log", lambda *a: None)
    return mod


class _NextUp(TorchDispatchMode):
    """aten.tan's result moved one float32 up."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if str(func) == "aten.tan.default":
            with _disable_current_modes():
                out = torch.nextafter(out, torch.full_like(out, torch.inf))
        return out


def test_census_of_equal_runs_finds_nothing(cs):
    (history,) = cs.op_census(torch.device("cpu")).values()
    assert len(history) == 1
    assert history[0]["bitwise"] and not history[0]["sources"]
    assert history[0]["aligned"] == history[0]["calls"][0] > 1000


def test_census_names_the_op_that_differs(cs, monkeypatch):
    record, calls = cs.op_record, []

    def one_leg_off(run):
        calls.append(None)
        if len(calls) == 1:  # the reference leg
            return record(run)
        with _NextUp():
            return record(run)

    monkeypatch.setattr(cs, "op_record", one_leg_off)
    (history,) = cs.op_census(torch.device("cpu")).values()
    first = history[0]
    assert not first["bitwise"] and first["sum_max_abs"] > 0
    assert set(first["sources"]) == {"aten.tan.default"}
    tan = first["sources"]["aten.tan.default"]
    assert tan["max_ulps"] == 1 and tan["other_bits"] == tan["equal_inputs"] > 0
    assert first["first"][1] == "aten.tan.default"
    assert all(line.startswith(os.path.join(
        "photorealistic_rendering_using_opencl_tpu_torch", "ops", "camera_rays.py"))
        for line in tan["lines"])
    assert history[-1]["on_cpu"] == ["aten.tan.default"]
