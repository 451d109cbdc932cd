"""Measurement tools of the port: the K1 microbenchmark (``bench_kernel``),
the launch probe (``barrier_test``), BASELINE's north-star fwd+bwd
(``northstar``) and the differentiable loop's remat and chunk sweep
(``regen_scan_probe``).  Each runs as
``python -m photorealistic_rendering_using_opencl_tpu_torch.tools.<name>``
and does no work at import."""
