"""Hand-written CUDA kernels, how they are built, and their plain versions."""
