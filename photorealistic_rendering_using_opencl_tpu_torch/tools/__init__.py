"""Measurement tools of the port: the K1 microbenchmark (``bench_kernel``),
the launch probe (``barrier_test``), BASELINE's north-star fwd+bwd
(``northstar``), the differentiable loop's remat and chunk sweep
(``regen_scan_probe``), the bounce-level profilers (``bounces``,
``bounce_parts``, ``trace_bounce``, ``bisect_bounce``, ``profile_floor``,
``bwd_anatomy``) and the several-rank tools (``spmd_audit``,
``scaling_bench``).  Each runs as
``python -m photorealistic_rendering_using_opencl_tpu_torch.tools.<name>``
and does no work at import; the bounce-level and several-rank tools run on
the card unless given ``--device cpu``."""
