"""Hand-written CUDA kernels of the port (sources and their build)."""
