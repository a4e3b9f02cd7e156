"""Grouped multi-adapter LoRA kernels (CUDA C++ for Hopper).

The dense set (module ``grouped_lora``: every slot at full rank), the
ragged set (module ``ragged``: full rank, per-slot token rows) and the
rank-local set (module ``ranklocal``: per-slot true ranks and token rows),
one kernel template each instantiated three times, each set under a
``torch.autograd.Function`` in ``ops`` (``ops.grouped_lora``,
``ops.ragged_grouped_lora``, ``ops.ranklocal_grouped_lora``); ``ref`` holds
their plain PyTorch versions. The dense Function is not re-exported here:
its name would hide the ``grouped_lora`` module.
"""
from repro_torch.kernels.grouped_lora.ops import (ragged_grouped_lora,
                                                  ranklocal_grouped_lora)

__all__ = ["ragged_grouped_lora", "ranklocal_grouped_lora"]
