"""Grouped multi-adapter LoRA kernels (CUDA C++ for Hopper).

Slice 1 ports the rank-local forward pair (``ranklocal.xa`` and
``ranklocal.sb_add``) that the serving path reaches; ``ref.py`` holds their
plain PyTorch versions.
"""
from repro_torch.kernels.grouped_lora.ops import ranklocal_grouped_lora

__all__ = ["ranklocal_grouped_lora"]
