"""Finite-difference gradient validation harness.

Port of ``photorealistic_rendering_using_opencl_tpu/diff/fd.py``.  The
gradient metric: max |AD - FD| < 1e-3 against central finite differences.
FD of a Monte-Carlo estimator only matches AD when both evaluations use
the same random stream, which the counter-based RNG guarantees for a fixed
(pixel, sample, seed), and when the perturbation flips no discrete
decision (a silhouette, a sampled lobe): use small eps and edge-free
scenes.

``params`` is a tensor, or a dict, tuple or list of tensors.  As in the
reference, each coordinate is perturbed in float64 and the perturbed leaf
is cast back to float32 before ``f`` sees it.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class FDReport(NamedTuple):
    max_abs_err: float  # max |ad - fd| over all checked coordinates
    max_rel_err: float  # max |ad - fd| / max(|fd|, floor)
    ad: Any  # AD gradient (the structure of params; zeros where unused)
    fd: Any  # FD gradient, float64 (same structure)

    @property
    def ok(self) -> bool:
        return self.max_abs_err < 1e-3


def _flatten(params):
    """(leaves, rebuild): the tensors of ``params`` and the inverse."""
    if isinstance(params, torch.Tensor):
        return [params], lambda leaves: leaves[0]
    if isinstance(params, dict):
        keys = list(params)
        return ([params[k] for k in keys],
                lambda leaves: dict(zip(keys, leaves)))
    if isinstance(params, (tuple, list)):
        return list(params), lambda leaves: type(params)(leaves)
    raise TypeError(f"params: a tensor, dict, tuple or list of tensors, "
                    f"not {type(params).__name__}")


def fd_gradient(f: Callable[[Any], torch.Tensor], params: Any,
                eps: float = 1e-3, max_coords: int | None = None) -> Any:
    """Central finite differences of scalar ``f`` w.r.t. float tensors.

    Perturbs every scalar coordinate of every leaf (or the first
    ``max_coords`` per leaf): 2 evaluations per coordinate, without
    autograd; use tiny scenes and resolutions.
    """
    leaves, rebuild = _flatten(params)
    out = []
    with torch.no_grad():
        for li, leaf in enumerate(leaves):
            arr = leaf.detach().cpu().numpy().astype(np.float64)
            flat = arr.reshape(-1)
            g = np.zeros_like(flat)
            n = len(flat) if max_coords is None else min(len(flat), max_coords)
            for i in range(n):
                for sgn in (1.0, -1.0):
                    pert = flat.copy()
                    pert[i] += sgn * eps
                    new = list(leaves)
                    new[li] = torch.from_numpy(
                        pert.reshape(arr.shape).astype(np.float32)).to(leaf.device)
                    g[i] += sgn * float(f(rebuild(new))) / (2.0 * eps)
            out.append(torch.from_numpy(g.reshape(arr.shape)))
    return rebuild(out)


def check_gradients(f: Callable[[Any], torch.Tensor], params: Any,
                    eps: float = 1e-3, max_coords: int | None = None,
                    rel_floor: float = 1e-2) -> FDReport:
    """Compare autograd of ``f`` against central FD; returns an FDReport."""
    leaves, rebuild = _flatten(params)
    ad_in = [x.detach().clone().requires_grad_() for x in leaves]
    with torch.enable_grad():
        val = f(rebuild(ad_in))
        grads = torch.autograd.grad(val, ad_in, allow_unused=True)
    ad = [torch.zeros_like(x) if g is None else g.detach()
          for x, g in zip(ad_in, grads)]
    fd = fd_gradient(f, params, eps=eps, max_coords=max_coords)

    max_abs = 0.0
    max_rel = 0.0
    for a, d in zip(ad, _flatten(fd)[0]):
        a = a.cpu().numpy().astype(np.float64).reshape(-1)
        d = d.numpy().reshape(-1)
        if max_coords is not None:
            a = a[:max_coords]
            d = d[:max_coords]
        err = np.abs(a - d)
        max_abs = max(max_abs, float(err.max(initial=0.0)))
        denom = np.maximum(np.abs(d), rel_floor)
        max_rel = max(max_rel, float((err / denom).max(initial=0.0)))
    return FDReport(max_abs, max_rel, rebuild(ad), fd)
