"""Measurement helpers: ``profiler`` (the step profiler and the
step-pipeline counters), ``device_profile`` (measured device-time
phases), ``memory_profile`` (classified device memory) and ``scaling``
(the measured 1 -> n curve)."""
