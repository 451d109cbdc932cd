"""The PCG4D hash of Jarzynski & Olano (2020), "Hash Functions for GPU
Rendering", keyed on (pixel, sample, dimension window, seed): the random
number of a path's decision is a function of where it is drawn, not of
the order in which lanes run.

uint32 words are held in int64 and every product of two words is taken in
16-bit halves, so nothing overflows.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _mul(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for words a, b."""
    return (((a & 0xFFFF) * b) + ((((a >> 16) * b) & 0xFFFF) << 16)) & M32


def pcg4d(x, y, z, w):
    """Four words in, four words out."""
    x = (_mul(x, 1664525) + 1013904223) & M32
    y = (_mul(y, 1664525) + 1013904223) & M32
    z = (_mul(z, 1664525) + 1013904223) & M32
    w = (_mul(w, 1664525) + 1013904223) & M32
    x = (x + _mul(y, w)) & M32
    y = (y + _mul(z, x)) & M32
    z = (z + _mul(x, y)) & M32
    w = (w + _mul(y, z)) & M32
    x, y, z, w = x ^ (x >> 16), y ^ (y >> 16), z ^ (z >> 16), w ^ (w >> 16)
    x = (x + _mul(y, w)) & M32
    y = (y + _mul(z, x)) & M32
    z = (z + _mul(x, y)) & M32
    w = (w + _mul(y, z)) & M32
    return x, y, z, w


def to_unit(bits: torch.Tensor) -> torch.Tensor:
    """A word -> a float32 in [0, 1): its top 23 bits as the mantissa of a
    number in [1, 2), less 1."""
    return (((bits >> 9) | 0x3F800000).to(torch.int32)
            .view(torch.float32) - 1.0)


class Stream:
    """The draws of a batch of paths: ``u(dim)`` is the uniform number of
    decision ``dim`` (one hash gives the four dimensions of a window)."""

    def __init__(self, pixel: torch.Tensor, sample: torch.Tensor, seed: int):
        self.pixel = pixel.to(torch.int64) & M32
        self.sample = sample.to(torch.int64) & M32
        self.seed = int(seed) & M32
        self._cache = {}

    def u(self, dim: int) -> torch.Tensor:
        win = dim >> 2
        if win not in self._cache:
            z = torch.full_like(self.pixel, win)
            w = torch.full_like(self.pixel, self.seed)
            self._cache = {win: pcg4d(self.pixel, self.sample, z, w)}
        return to_unit(self._cache[win][dim & 3])
