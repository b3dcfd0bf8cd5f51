"""Hand-written CUDA kernels, their ctypes wrappers and plain versions."""
