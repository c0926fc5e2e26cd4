"""Tensor ops of the serving slice and their CUDA kernels."""
