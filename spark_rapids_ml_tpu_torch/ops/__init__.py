"""Device math of the port: torch functions and hand-written CUDA kernels."""
