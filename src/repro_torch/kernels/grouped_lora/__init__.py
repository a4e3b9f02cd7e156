"""Grouped multi-adapter LoRA kernels (CUDA C++ for Hopper).

The dense set (module ``grouped_lora``: every slot at full rank) and the
rank-local set (module ``ranklocal``: per-slot true ranks and token rows),
each under a ``torch.autograd.Function`` in ``ops`` (``ops.grouped_lora``,
``ops.ranklocal_grouped_lora``); ``ref`` holds their plain PyTorch
versions. The dense Function is not re-exported here: its name would hide
the ``grouped_lora`` module.
"""
from repro_torch.kernels.grouped_lora.ops import ranklocal_grouped_lora

__all__ = ["ranklocal_grouped_lora"]
