"""Moment system, preprocessing, and the CUDA chain kernel with its plain
PyTorch twin."""
