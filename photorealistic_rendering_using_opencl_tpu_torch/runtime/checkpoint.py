"""Checkpoint / resume for long progressive renders and optimisations.

Port of ``photorealistic_rendering_using_opencl_tpu/runtime/checkpoint.py``,
with its ``.npz`` layout and format version, so a checkpoint written by
either package loads in the other: ``state.samples`` and ``state.seed`` are
numpy uint32 scalars, ``state.acc`` and ``state.alpha`` float32 arrays,
``scene.<field>`` each scene leaf, ``meta`` a JSON byte string.  The
counter-keyed RNG makes sample i the same whenever it is drawn, so a
resumed render is the one that never stopped.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

from photorealistic_rendering_using_opencl_tpu_torch.models.pathtracer import (
    ProgressiveState,
)
from photorealistic_rendering_using_opencl_tpu_torch.scene.types import SceneData
from photorealistic_rendering_using_opencl_tpu_torch.utils.device import (
    DEFAULT_DEVICE, resolve_device,
)

_FORMAT_VERSION = 1
_U32_FIELDS = ("samples", "seed")


def save_checkpoint(path: str, state: ProgressiveState,
                    scene: SceneData | None = None,
                    extra: dict[str, Any] | None = None) -> None:
    """Atomically write the progressive state (+ optional scene leaves):
    a ``.tmp`` file, then ``os.replace``."""
    arrays: dict[str, np.ndarray] = {}
    meta: dict[str, Any] = {"version": _FORMAT_VERSION, "extra": extra or {}}

    for name, val in state._asdict().items():
        a = val.detach().cpu().numpy()
        arrays[f"state.{name}"] = (a.astype(np.uint32) if name in _U32_FIELDS
                                   else a.astype(np.float32))
    if scene is not None:
        for f in dataclasses.fields(scene):
            arrays[f"scene.{f.name}"] = (
                getattr(scene, f.name).detach().cpu().numpy())
        meta["has_scene"] = True
    arrays["meta"] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8).copy()

    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    os.replace(tmp, path)


def load_checkpoint(path: str, scene_template: SceneData | None = None, *,
                    device=DEFAULT_DEVICE):
    """Returns (ProgressiveState on ``device``, SceneData on the template's
    device or None, extra dict)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta"]).decode())
        if meta.get("version") != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version in {path}")
        fields = {}
        for name in ProgressiveState._fields:
            a = z[f"state.{name}"]
            fields[name] = torch.from_numpy(
                a.astype(np.int64) if name in _U32_FIELDS
                else a.astype(np.float32)).to(dev)
        state = ProgressiveState(**fields)
        scene = None
        if meta.get("has_scene"):
            if scene_template is None:
                raise ValueError(
                    "checkpoint contains a scene; pass scene_template")
            scene = SceneData(**{
                f.name: torch.from_numpy(z[f"scene.{f.name}"]).to(
                    scene_template.device)
                for f in dataclasses.fields(scene_template)})
        return state, scene, meta.get("extra", {})
