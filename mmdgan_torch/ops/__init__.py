"""Distances, MMD kernels, the fused kernel-means CUDA kernel, spectral norm and losses."""
