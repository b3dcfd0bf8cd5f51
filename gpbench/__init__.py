"""Benchmark of the PyTorch / CUDA port on one H100 (see README.md)."""
