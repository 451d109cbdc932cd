"""Frames and gradient steps of the plain tracer, in blocks of lanes so that
they fit beside nothing else on the card: pixel sums over a run of
samples, a whole image, an image loss with its gradients, and Adam."""
from __future__ import annotations

import torch

from benchmark.reference.scene import Scene
from benchmark.reference.tracer import radiance


def pixel_sums(sc: Scene, cam: dict, width: int, height: int, pixels,
               n_samples: int, seed: int, lanes: int = 1 << 18):
    """Each pixel's radiance summed over samples 0 .. n_samples - 1, added
    in sample order -> [K,3]."""
    k = pixels.shape[0]
    acc = torch.zeros((k, 3), dtype=sc.dt, device=sc.dev)
    per = max(1, lanes // max(k, 1))
    with torch.no_grad():
        for s0 in range(0, n_samples, per):
            ss = torch.arange(s0, min(n_samples, s0 + per), device=sc.dev)
            rad = radiance(sc, cam, width, height, pixels.repeat(ss.numel()),
                           ss.repeat_interleave(k), seed)
            for row in rad.reshape(ss.numel(), k, 3):
                acc = acc + row
    return acc


def image(sc: Scene, cam: dict, width: int, height: int, spp: int, seed: int,
          lanes: int = 1 << 20):
    """The mean of ``spp`` samples of every pixel -> [H*W,3]."""
    n = width * height
    per = max(1, lanes // spp)
    out = []
    for p0 in range(0, n, per):
        pix = torch.arange(p0, min(n, p0 + per), device=sc.dev)
        out.append(pixel_sums(sc, cam, width, height, pix, spp, seed,
                              lanes) / spp)
    return torch.cat(out)


def loss_and_grads(sc: Scene, cam: dict, width: int, height: int, spp: int,
                   seed: int, target, leaves: dict, lanes: int = 1 << 20,
                   stride: int = 1, gain: float = 1.0):
    """The mean squared error of the ``spp``-sample image against
    ``target`` [H*W,3] and its gradients with respect to ``leaves``
    ("color", "obj_color", "env_map"), block by block of pixels (the
    loss is a sum over pixels, so the blocks' gradients add up).
    ``stride`` > 1 takes the mean over every stride-th pixel alone and
    ``gain`` scales the image: the faults the check has to catch."""
    params = {k: v.detach().clone().requires_grad_() for k, v in
              leaves.items()}
    n = width * height
    scale = 1.0 / (-(-n // stride) * 3)
    per = max(1, lanes // spp) * stride
    total = 0.0
    for p0 in range(0, n, per):
        pix = torch.arange(p0, min(n, p0 + per), stride, device=sc.dev)
        k = pix.numel()
        rad = radiance(sc, cam, width, height, pix.repeat(spp),
                       torch.arange(spp, device=sc.dev).repeat_interleave(k),
                       seed, params)
        acc = torch.zeros((k, 3), dtype=sc.dt, device=sc.dev)
        for row in rad.reshape(spp, k, 3):
            acc = acc + row
        part = torch.sum(torch.square(acc / spp * gain - target[pix]))
        (part * scale).backward()
        total += float(part.detach().double())
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in params.items()}
    return total * scale, grads


class Adam:
    """Kingma & Ba's Adam (beta1 0.9, beta2 0.999, eps 1e-8 added to the
    root of the bias-corrected second moment), each leaf clipped at zero
    after its update."""

    def __init__(self, leaves: dict, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8):
        self.p = {k: v.detach().clone() for k, v in leaves.items()}
        self.m = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t = 0

    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = 1.0 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1.0 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1.0 - self.b2) * g * g
            step = self.m[k] / c1 / (torch.sqrt(self.v[k] / c2) + self.eps)
            self.p[k] = torch.clamp(self.p[k] - self.lr * step, min=0.0)
