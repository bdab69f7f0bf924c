"""Kernels: hand-written CUDA for Hopper, each beside its plain version."""
