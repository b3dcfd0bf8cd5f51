"""GlimpsePrune on PyTorch and CUDA for one NVIDIA H100.

The PyTorch port of ``glimpseprune_tpu`` (the JAX reference package). It
keeps the JAX package's module layout so each counterpart is easy to find,
and reuses only the reference's numpy-only modules (``config`` and
``preprocessing``). Kernels are hand-written CUDA C++ under ``csrc/``.
"""
