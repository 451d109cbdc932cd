"""PyTorch/CUDA port of the path tracer in ``photorealistic_rendering_using_opencl_tpu``.

The JAX package beside this one is the reference: every module here keeps
its counterpart's name and function names, written as plain functions on
torch tensors.  The two Pallas kernels on the forward render path are
hand-written CUDA C++ for Hopper (``csrc/``), built with ``nvcc`` at first
use; on CPU tensors their wrappers run the plain PyTorch twin instead.

Layout:
    ops/       math, RNG, sampling, camera, intersection (spheres, SDFs,
               boxes, quads, + the mesh kernel K1), BSDFs, lights, phase
               functions, media, environment maps, tonemap (+ the display
               kernel K2), noise and texture sampling, and the CUDA build
               and loader ``_cuda.py``
    scene/     scene types, JSON loader, OBJ import, BVH build (host),
               Phong tessellation
    models/    integrator, the render loops, progressive accumulation, AOVs
    parallel/  several devices over torch.distributed: the sharded render,
               the all-reduced train step, a one-step check over n ranks
    runtime/   the command line (``python -m`` this package), the interactive
               camera, checkpoints, terminal frames, and the shared native
               (C++) host library: BVH build, OBJ parser
    utils/     device choice, image IO (PNG, HDR), config manifest, metrics
    csrc/      CUDA sources of the kernels

The package never imports ``jax``.
"""

__version__ = "0.1.0"
