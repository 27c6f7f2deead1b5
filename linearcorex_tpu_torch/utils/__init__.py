"""Kernel build (nvcc + ctypes) and carrying JAX-fitted models across."""
