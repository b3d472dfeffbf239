"""Tensor operations and the CUDA kernels' wrappers."""
