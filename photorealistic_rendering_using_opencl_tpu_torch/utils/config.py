"""Config introspection: the resolved static scene configuration.

Port of ``photorealistic_rendering_using_opencl_tpu/utils/config.py``.  The
reference's third configuration tier (kernel specialization) is the frozen
``SceneConfig``: its presence flags gate whole code paths.  This module
renders the resolved config for logs and reproducibility manifests; the
dicts equal the reference's for the same scene.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from photorealistic_rendering_using_opencl_tpu_torch.scene.types import SceneConfig


def describe(cfg: SceneConfig) -> dict[str, Any]:
    """Resolved static configuration as a plain dict (two scenes with equal
    describe() take the same code paths)."""
    d = dataclasses.asdict(cfg)
    d["n_objects"] = cfg.n_objects
    d["has_mesh"] = cfg.has_mesh
    d["env_nee"] = cfg.env_nee
    return d


def manifest(cfg: SceneConfig, width: int, height: int, spp: int,
             seed: int = 0, extra: dict | None = None) -> str:
    """One-line JSON reproducibility manifest for a render."""
    return json.dumps({
        "config": describe(cfg),
        "width": width, "height": height, "spp": spp, "seed": seed,
        **(extra or {}),
    }, sort_keys=True)
