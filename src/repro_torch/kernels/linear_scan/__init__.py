"""Chunked gated linear-scan kernel (CUDA C++ for Hopper): the RWKV6 / SSD
core.

``linear_scan`` (module) holds the kernel's wrapper and launch count,
``ref`` its plain PyTorch version, ``ops.linear_scan`` the autograd
Function the model calls.
"""
