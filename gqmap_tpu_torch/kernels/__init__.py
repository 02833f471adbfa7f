"""Hand-written CUDA kernels of the port, with their wrappers and plain versions."""
