"""The skip-link BVH walk on the card: the CUDA kernel W1
(``csrc/bvh_walk.cu``) and its wrapper.

W1 is no TPU kernel: the reference runs the walk as one XLA
``lax.while_loop`` (its ``ops/intersect.py:_bvh_traverse_chunk``), which
stays on the device for the whole walk.  Eager PyTorch would go back to the
host at every node step, so on the card the walk is one kernel: a ray a
lane, a CTA's warps refilling their finished lanes from the CTA's block of
rays.  Its plain twin is ``intersect._bvh_traverse_chunk``, which the CPU
runs and ``chip_smoke.py`` holds W1 against, bitwise, on the card.

``walk`` launches W1 for CUDA tensors and raises for any other device (the
CPU's caller, ``intersect.bvh_traverse``, takes the twin).  A failed build
or launch raises; there is no fallback.
"""
from __future__ import annotations

import torch

from photorealistic_rendering_using_opencl_tpu_torch.ops import _cuda
from photorealistic_rendering_using_opencl_tpu_torch.ops.mesh_brute import _lane_tensor

# node visits, leaf visits that tested triangles, triangle tests, warp
# node steps, warp steps in which a lane entered a leaf
W1_COUNTERS = 5


class _BvhWalkKernel:
    """Wrapper of ``prt_bvh_walk``.  ``launches`` counts kernel launches and
    nothing else.  ``counters``, an int64 [5] tensor on the card, receives
    the launch's work: node visits, visits to a leaf whose box the ray
    entered (each reads the 144-byte leaf row), triangle tests, the warp
    node steps the kernel ran and those in which a lane entered a leaf; the
    render path passes none (and runs the kernel's instance that counts
    nothing)."""

    def __init__(self):
        self.launches = 0

    def __call__(self, nodes, links, leaf_verts, origin, direction, t_init,
                 active, any_hit, count_steps=False, counters=None):
        dev = origin.device
        n = origin.shape[0]
        m = nodes.shape[0]
        n_leaves = leaf_verts.shape[0]
        _cuda.require(nodes, "nodes", torch.float32, (m, 8), dev)
        _cuda.require(links, "links", torch.int32, (8 * m, 2), dev)
        _cuda.require(leaf_verts, "leaf_verts", torch.float32,
                      (n_leaves, 36), dev)
        _cuda.require(origin, "origin", torch.float32, (n, 3), dev)
        _cuda.require(direction, "direction", torch.float32, (n, 3), dev)
        _cuda.require(t_init, "t_init", torch.float32, (n,), dev)
        _cuda.require(active, "active", torch.bool, (n,), dev)
        _cuda.require(any_hit, "any_hit", torch.bool, (n,), dev)
        for name, t in (("nodes", nodes), ("links", links),
                        ("leaf_verts", leaf_verts)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the kernel reads it in 16-byte "
                                 "pieces; its data must start on a 16-byte "
                                 "boundary")
        if counters is not None:
            _cuda.require(counters, "counters", torch.int64, (W1_COUNTERS,),
                          dev)
        out = (torch.empty((n,), dtype=torch.float32, device=dev),
               torch.empty((n,), dtype=torch.int32, device=dev),
               torch.empty((n,), dtype=torch.float32, device=dev),
               torch.empty((n,), dtype=torch.float32, device=dev))
        steps = (torch.empty((n,), dtype=torch.int32, device=dev)
                 if count_steps else None)
        if n:
            lib = _cuda.LIBRARY.get()
            with _cuda.on_device(origin):
                code = lib.prt_bvh_walk(
                    nodes.data_ptr(), links.data_ptr(), leaf_verts.data_ptr(),
                    m, origin.data_ptr(), direction.data_ptr(),
                    t_init.data_ptr(), active.data_ptr(), any_hit.data_ptr(),
                    n, *(o.data_ptr() for o in out),
                    None if steps is None else steps.data_ptr(),
                    None if counters is None else counters.data_ptr(),
                    _cuda.stream_handle(origin))
            _cuda.check(code, "prt_bvh_walk")
            self.launches += 1
        return out + ((steps,) if count_steps else ())


bvh_walk_kernel = _BvhWalkKernel()


def walk(nodes, links, leaf_verts, origin, direction, t_init, any_hit=False,
         active=None, count_steps=False):
    """W1 on CUDA tensors -> (t, tri, u, v[, steps]), as
    ``intersect._bvh_traverse_chunk`` returns them."""
    if origin.device.type != "cuda":
        raise ValueError(f"bvh_walk.walk: W1 runs on CUDA tensors, got "
                         f"{origin.device} (the CPU takes "
                         "intersect._bvh_traverse_chunk)")
    n = origin.shape[0]
    dev = origin.device
    return bvh_walk_kernel(
        nodes.detach().contiguous(), links.contiguous(),
        leaf_verts.detach().contiguous(), origin.detach().contiguous(),
        direction.detach().contiguous(),
        _lane_tensor(t_init, n, torch.float32, dev, None),
        _lane_tensor(active, n, torch.bool, dev, True),
        _lane_tensor(any_hit, n, torch.bool, dev, False), count_steps)
