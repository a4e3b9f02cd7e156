"""Causal flash-attention forward kernel (CUDA C++ for Hopper).

``flash_attention`` (module) holds the kernel's wrapper and launch count,
``ref`` its plain PyTorch version, ``ops.flash_attention`` the autograd
Function the model calls.
"""
