"""Restart sweeps of the PyTorch port: k fits run as lanes of one solve."""
