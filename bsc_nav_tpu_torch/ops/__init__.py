"""Kernels K1 and K2 with their plain versions, and the CUDA build."""
