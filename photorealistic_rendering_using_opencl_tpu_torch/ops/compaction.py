"""Prefix-sum stream compaction: the blocked exclusive scan, its plain
PyTorch version, and the CUDA kernel K3 (``csrc/block_scan.cu``).

Port of ``exclusive_prefix_sum`` and ``compact_indices`` of
``photorealistic_rendering_using_opencl_tpu/ops/pallas_kernels.py``, whose
Pallas kernel ``_block_scan_kernel`` (K3) scans each block of the padded
flags and writes the block's total.  The block offsets, the exclusive
cumulative sum of the totals, are added outside the kernel, as the
reference adds them.  No render path calls these: path regeneration
replaced wavefront compaction in the reference too.

``block_scan`` dispatches on the device of its input: CPU tensors take
``block_scan_plain``; CUDA tensors launch K3 or raise.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda

DEFAULT_BLOCK = 1024


def _check_block(block: int) -> None:
    if not (32 <= block <= 1024 and block & (block - 1) == 0):
        raise ValueError(f"block {block}: the scan takes a power of two "
                         "from 32 to 1024 (one CTA of that many threads)")


def block_scan_plain(f: torch.Tensor, block: int):
    """Per-block exclusive scan of int32 ``f`` ([nb*block]) -> (scans
    [nb*block], totals [nb]), plain PyTorch: [nb, block] -> cumsum - f."""
    fb = f.reshape(-1, block)
    inc = torch.cumsum(fb, dim=1, dtype=torch.int32)
    return (inc - fb).reshape(-1), inc[:, -1].contiguous()


class _BlockScanKernel:
    """Wrapper of ``prt_block_scan`` (csrc/block_scan.cu).  ``launches``
    counts kernel launches and nothing else."""

    def __init__(self):
        self.launches = 0

    def __call__(self, f: torch.Tensor, block: int):
        _check_block(block)
        n = f.shape[0]
        if f.ndim != 1 or n % block:
            raise ValueError(f"flags {tuple(f.shape)}: expected [nb * {block}]")
        nb = n // block
        _cuda.require(f, "flags", torch.int32, (n,), f.device)
        scans = torch.empty_like(f)
        totals = torch.empty((nb,), dtype=torch.int32, device=f.device)
        if nb == 0:
            return scans, totals
        lib = _cuda.LIBRARY.get()
        code = lib.prt_block_scan(f.data_ptr(), scans.data_ptr(),
                                  totals.data_ptr(), nb, block,
                                  _cuda.stream_handle(f))
        _cuda.check(code, "prt_block_scan")
        self.launches += 1
        return scans, totals


block_scan_kernel = _BlockScanKernel()


def block_scan(f: torch.Tensor, block: int):
    """Per-block exclusive scan and block totals of int32 ``f``, whose
    length is a multiple of ``block``: the plain version on CPU tensors,
    K3 on CUDA tensors, with no fallback."""
    if f.device.type == "cpu":
        return block_scan_plain(f, block)
    if f.device.type != "cuda":
        raise ValueError(f"block_scan: unsupported device {f.device}")
    return block_scan_kernel(f.contiguous(), block)


def exclusive_prefix_sum(flags: torch.Tensor, block: int = DEFAULT_BLOCK):
    """Exclusive prefix sum of an int vector -> (scan [N] int32, total []
    int32).  Two levels: per-block scans (K3 on the card), then the
    blocks' offsets added outside the kernel."""
    _check_block(block)
    n = flags.shape[0]
    f = flags.to(torch.int32)
    pad = (-n) % block
    if pad:
        f = torch.cat([f, torch.zeros((pad,), dtype=torch.int32,
                                      device=f.device)])
    scans, totals = block_scan(f, block)
    offsets = torch.cumsum(totals, dim=0, dtype=torch.int32) - totals
    full = scans + torch.repeat_interleave(offsets, block)
    return full[:n], torch.sum(totals, dtype=torch.int32)


def compact_indices(alive: torch.Tensor):
    """Indices of live lanes packed to the front (stable), dead behind.

    Returns (perm [N] int32, n_alive [] int32): ``x[perm]`` groups the live
    lanes first; slots come from prefix sums, with no atomics.
    """
    n = alive.shape[0]
    flags = alive.to(torch.int32)
    pos_alive, n_alive = exclusive_prefix_sum(flags)
    pos_dead, _ = exclusive_prefix_sum(1 - flags)
    slot = torch.where(alive, pos_alive, n_alive + pos_dead)
    perm = torch.zeros((n,), dtype=torch.int32, device=alive.device)
    perm.index_put_((slot.long(),),
                    torch.arange(n, dtype=torch.int32, device=alive.device))
    return perm, n_alive
