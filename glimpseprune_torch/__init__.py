"""GlimpsePrune on PyTorch and CUDA for one NVIDIA H100.

The PyTorch port of ``glimpseprune_tpu`` (the JAX reference package). It
keeps the JAX package's module layout so each counterpart is easy to find,
and imports nothing of it: the numpy-only modules it needs (``config``,
``registry``, ``preprocessing``) are copies. Kernels are hand-written CUDA
C++ under ``csrc/``.
"""
