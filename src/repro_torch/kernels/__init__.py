"""Kernels of the serving path: CUDA sources in ``repro_torch/csrc``,
ctypes wrappers, plain PyTorch versions and device routing."""
