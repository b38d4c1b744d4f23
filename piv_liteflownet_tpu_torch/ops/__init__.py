"""Ops of the port: plain PyTorch versions and the wrappers of the CUDA kernels."""
