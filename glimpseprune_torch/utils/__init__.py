"""Host-side utilities of the port: profiling decorators and mask
visualization (counterparts of glimpseprune_tpu/utils/profiling.py and
viz.py)."""
