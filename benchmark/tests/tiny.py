"""A small copy of the benchmark for the CPU tests: the same code, with
cells whose configurations and traffic are cut to sizes the CPU holds."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY_CELLS = {"cornell_mesh.render": "tiny_mesh.tiny_render",
              "env_lens.grad": "tiny_env.tiny_grad"}


def tiny_tree(root: str) -> str:
    """``root`` gets BENCHMARK.json and benchmark/ with two more cells,
    tiny_mesh.tiny_render and tiny_env.tiny_grad, cut from the real ones:
    a 1,280-triangle icosphere, a 32x64 sky, frames of 24x16 and 16x16."""
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        spec = json.load(fh)
    cfg_dir = os.path.join(root, "benchmark", "configs")
    tr_dir = os.path.join(root, "benchmark", "traffic")
    with open(os.path.join(cfg_dir, "cornell_mesh.json")) as fh:
        mesh = json.load(fh)
    mesh["mesh"]["icosphere"]["subdiv"] = 3
    with open(os.path.join(cfg_dir, "env_lens.json")) as fh:
        env = json.load(fh)
    env["env_map"] = {"width": 64, "height": 32}
    for name, cfg in (("tiny_mesh", mesh), ("tiny_env", env)):
        with open(os.path.join(cfg_dir, name + ".json"), "w") as fh:
            json.dump(cfg, fh)
        spec["configs"].append({"name": name, "source": "tests",
                                "file": f"benchmark/configs/{name}.json",
                                "reduced": [], "why": "CPU tests"})
    with open(os.path.join(tr_dir, "render.json")) as fh:
        render = json.load(fh)
    render.update(width=24, height=16, check_pixels=64, warmup_passes=1)
    with open(os.path.join(tr_dir, "grad.json")) as fh:
        grad = json.load(fh)
    # so few lanes rarely reach the longest paths in the calibration
    grad.update(width=16, height=16, regen_margin=2.5)
    for name, tr in (("tiny_render", render), ("tiny_grad", grad)):
        with open(os.path.join(tr_dir, name + ".json"), "w") as fh:
            json.dump(tr, fh)
    for real, tiny in TINY_CELLS.items():
        cell = dict(next(w for w in spec["workloads"] if w["name"] == real))
        cell.update(name=tiny, config=tiny.split(".")[0],
                    traffic=tiny.split(".")[1])
        spec["workloads"].append(cell)
        for m in spec["end_to_end"] + spec["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(spec, fh)
    return root
