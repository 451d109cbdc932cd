"""Counter-based parallel RNG keyed on (pixel, sample, dim, seed).

Port of ``photorealistic_rendering_using_opencl_tpu/ops/rng.py``: its three
schemes, with the same words.  Every random decision draws from a fixed
dimension index, so an image does not depend on the schedule that rendered
it.

  * "pcg4d": the PCG4D hash of Jarzynski & Olano, four words a hash (the
    default of the render entry points).
  * "threefry": threefry2x32, 20 rounds, one hash a draw.
  * "mwc": a dual 16-bit multiply-with-carry hash, one hash a draw.

uint32 arithmetic is emulated in int64 with ``& 0xFFFFFFFF``: torch on the
CPU has no uint32 add or shifts.  Every intermediate stays below 2**63, so
the words are bitwise those of the reference: every u32 x u32 product goes
through ``mul32`` (16-bit halves), and every left shift is masked.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

SCHEMES = ("pcg4d", "threefry", "mwc")


def _u32(x) -> torch.Tensor:
    return x & MASK32


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2**32 for a, b in [0, 2**32), without int64 overflow."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


_THREEFRY_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_THREEFRY_PARITY = 0x1BD11BDA


def threefry2x32(key0, key1, x0, x1):
    """Threefry-2x32, 20 rounds.  All args int64 tensors holding uint32
    words, broadcastable; returns the two output words."""
    key0, key1, x0, x1 = (_u32(v) for v in (key0, key1, x0, x1))
    ks2 = key0 ^ key1 ^ _THREEFRY_PARITY
    x0 = _u32(x0 + key0)
    x1 = _u32(x1 + key1)
    ks = (key0, key1, ks2)
    for block in range(5):
        for i in range(4):
            x0 = _u32(x0 + x1)
            x1 = _rotl(x1, _THREEFRY_ROTATIONS[(block % 2) * 4 + i])
            x1 = x1 ^ x0
        # key injection every 4 rounds
        inj = block + 1
        x0 = _u32(x0 + ks[inj % 3])
        x1 = _u32(x1 + ks[(inj + 1) % 3] + inj)
    return x0, x1


def pcg4d(v: torch.Tensor) -> torch.Tensor:
    """PCG4D hash; v is int64[..., 4] holding uint32 words -> same."""
    v = _u32(mul32(_u32(v), 1664525) + 1013904223)
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    x = _u32(x + mul32(y, w))
    y = _u32(y + mul32(z, x))
    z = _u32(z + mul32(x, y))
    w = _u32(w + mul32(y, z))
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)
    x = _u32(x + mul32(y, w))
    y = _u32(y + mul32(z, x))
    z = _u32(z + mul32(x, y))
    w = _u32(w + mul32(y, z))
    return torch.stack([x, y, z, w], dim=-1)


def mwc_hash(x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
    """Three rounds of 16-bit multiply-with-carry mixing; x0/x1 int64
    holding uint32 words -> uint32 bits (int64)."""
    x0 = _u32(x0)
    x1 = _u32(x1)
    for _ in range(3):
        x0 = 36969 * (x0 & 0xFFFF) + (x0 >> 16)  # < 2**32: no wrap
        x1 = 18000 * (x1 & 0xFFFF) + (x1 >> 16)
        x0, x1 = x0 ^ ((x1 << 16) & MASK32), x1 ^ (x0 >> 3)
    return _u32((x0 << 16) + (x1 & 0xFFFF))


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> float32 in [0, 1) via the mantissa trick."""
    word = (bits >> 9) | 0x3F800000  # < 2**31: exact in int32
    return word.to(torch.int32).view(torch.float32) - 1.0


def _as_u32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return _u32(x.to(device=device, dtype=torch.int64))
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


class Sampler:
    """Per-ray deterministic random stream.

    ``pixel`` and ``sample`` index the stream; ``dim`` (auto-incremented)
    indexes the decision.  pcg4d hashes once per 4-dim window and hands out
    one word a draw; threefry and mwc hash once a draw.  A stream is a pure
    function of (pixel, sample, seed, dim), with ``dim`` 4-aligned at the
    start.
    """

    __slots__ = ("pixel", "sample", "seed", "scheme", "_dim0", "_off",
                 "_blk", "_blk_win")

    def __init__(self, pixel: torch.Tensor, sample, seed=0,
                 scheme: str = "pcg4d", dim=0):
        if scheme not in SCHEMES:
            raise ValueError(f"rng scheme {scheme!r}: one of {SCHEMES}")
        device = pixel.device
        self.pixel = _as_u32(pixel, device)
        self.sample = torch.broadcast_to(_as_u32(sample, device),
                                         self.pixel.shape)
        self.seed = _as_u32(seed, device)
        if isinstance(dim, int):
            assert dim % 4 == 0, "Sampler dim start must be 4-aligned"
            dim = torch.tensor(dim, dtype=torch.int64, device=device)
        self._dim0 = _as_u32(dim, device)
        self._off = 0  # draws consumed so far
        self.scheme = scheme
        self._blk = None  # pcg4d 4-word block cache (see _draw)
        self._blk_win = -1

    @property
    def dim(self) -> torch.Tensor:
        """The next draw's dimension index (uint32 in int64)."""
        return _u32(self._dim0 + self._off)

    def next1d(self) -> torch.Tensor:
        u, = self.nextnd(1)
        return u

    def next2d(self) -> tuple[torch.Tensor, torch.Tensor]:
        u, v = self.nextnd(2)
        return u, v

    def nextnd(self, n: int):
        return tuple(self._draw() for _ in range(n))

    def _draw(self) -> torch.Tensor:
        shape = self.pixel.shape
        if self.scheme == "threefry":
            d = torch.broadcast_to(self.dim, shape)
            bits, _ = threefry2x32(self.seed, d, self.pixel, self.sample)
        elif self.scheme == "mwc":
            bits = mwc_hash(self.pixel ^ mul32(self.seed, 0x9E3779B9),
                            mul32(self.sample, 0x85EBCA6B) ^ self.dim)
        else:
            win = self._off // 4
            if self._blk_win != win:
                base = _u32((self._dim0 >> 2) + win)
                v = torch.stack([
                    self.pixel,
                    self.sample,
                    torch.broadcast_to(base, shape),
                    torch.broadcast_to(self.seed, shape),
                ], dim=-1)
                self._blk = pcg4d(v)
                self._blk_win = win
            bits = self._blk[..., self._off % 4]
        self._off += 1
        return uniform_from_bits(bits)
