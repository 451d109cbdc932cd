"""Differentiable-rendering subsystem: FD validation + inverse rendering."""
from photorealistic_rendering_using_opencl_tpu_torch.diff.fd import (  # noqa: F401
    FDReport, check_gradients, fd_gradient,
)
from photorealistic_rendering_using_opencl_tpu_torch.diff.inverse import (  # noqa: F401
    FitResult, fit_scene, image_loss, make_loss_fn,
)
