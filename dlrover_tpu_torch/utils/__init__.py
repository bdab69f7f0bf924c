"""Host-side measurement helpers (``profiler``: the step-pipeline
counters)."""
