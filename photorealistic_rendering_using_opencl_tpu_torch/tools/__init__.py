"""Measurement tools of the port: the K1 microbenchmark (``bench_kernel``)
and the launch probe (``barrier_test``).  Each runs as
``python -m photorealistic_rendering_using_opencl_tpu_torch.tools.<name>``
and does no work at import."""
