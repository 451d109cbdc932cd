"""The port's prefix-sum compaction (ops/compaction.py, K3's plain version on
the CPU) against numpy and against the JAX package's
``exclusive_prefix_sum`` / ``compact_indices`` (Pallas, interpret mode on
the CPU).  Integer results: every comparison is bitwise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photorealistic_rendering_using_opencl_tpu.ops import pallas_kernels as pk
from photorealistic_rendering_using_opencl_tpu_torch.ops import compaction

torch.set_num_threads(2)

SIZES = [1, 1023, 1025, 3000, 262144]
DENSITIES = [0.0, 0.03, 0.5, 1.0]


def _flags(n, density):
    rng = np.random.default_rng(int(n * 10 + density * 100))
    return (rng.uniform(size=n) < density).astype(np.int32)


@pytest.mark.parametrize("block", [256, 1024])
@pytest.mark.parametrize("n", SIZES)
def test_exclusive_prefix_sum_matches_numpy_and_reference(block, n):
    for density in DENSITIES:
        f = _flags(n, density)
        scan, total = compaction.exclusive_prefix_sum(torch.from_numpy(f),
                                                      block=block)
        assert scan.dtype == torch.int32 and scan.shape == (n,)
        assert total.dtype == torch.int32 and total.shape == ()
        want = np.cumsum(f) - f
        np.testing.assert_array_equal(scan.numpy(), want)
        assert int(total) == int(f.sum())
        j_scan, j_total = pk.exclusive_prefix_sum(jnp.asarray(f), block=block)
        np.testing.assert_array_equal(scan.numpy(), np.asarray(j_scan))
        assert int(total) == int(j_total)


@pytest.mark.parametrize("block", [32, 256, 1024])
def test_block_scan_plain_matches_reference_kernel_contract(block):
    """The plain version's per-block scans and totals: what the Pallas
    kernel writes before the offsets are added."""
    f = _flags(4 * block, 0.5)
    scans, totals = compaction.block_scan_plain(torch.from_numpy(f), block)
    fb = f.reshape(-1, block)
    np.testing.assert_array_equal(scans.numpy().reshape(-1, block),
                                  np.cumsum(fb, axis=1) - fb)
    np.testing.assert_array_equal(totals.numpy(), fb.sum(axis=1))
    assert scans.dtype == totals.dtype == torch.int32


@pytest.mark.parametrize("n", SIZES)
def test_compact_indices_matches_reference(n):
    for density in DENSITIES:
        alive = _flags(n, density).astype(bool)
        perm, n_alive = compaction.compact_indices(torch.from_numpy(alive))
        j_perm, j_n = pk.compact_indices(jnp.asarray(alive))
        np.testing.assert_array_equal(perm.numpy(), np.asarray(j_perm))
        assert perm.dtype == torch.int32
        assert int(n_alive) == int(j_n) == int(alive.sum())
        p = perm.numpy()
        k = int(n_alive)
        assert alive[p[:k]].all() and not alive[p[k:]].any()
        assert (np.diff(p[:k]) > 0).all() and (np.diff(p[k:]) > 0).all()


@pytest.mark.parametrize("block", [0, 16, 100, 2048])
def test_unsupported_block_raises(block):
    with pytest.raises(ValueError, match="power of two"):
        compaction.exclusive_prefix_sum(torch.ones(64, dtype=torch.int32),
                                        block=block)


def test_block_scan_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        compaction.block_scan(torch.ones(64, dtype=torch.int32,
                                         device="meta"), 32)
