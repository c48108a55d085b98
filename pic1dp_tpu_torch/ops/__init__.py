"""Compute ops: interpolation, spectral field solve, fused substep kernels."""
