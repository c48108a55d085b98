"""Utilities: phase timers, the nvcc build of the CUDA sources."""
