"""Compute-backend selection for the model's hot paths: the port of
``src/repro/models/backend.py``.

"kernel" (default) — the hand kernels: contiguous causal attention
  (training, eval and full-length prefill) -> ``kernels/flash_attention``;
  the JAX package's Pallas backends ("pallas", "pallas_interpret").
"torch" — plain PyTorch reference paths: the baseline grouped einsum
  attention, the JAX package's "jnp" backend.
LoRA projections have their own switch in ``core/lora.py``.

The choice is thread-local. A layer recomputed in the backward pass (remat)
may run in autograd's own thread, so ``models/model.py`` captures it with
the LoRA binding and re-enters it there.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()

BACKENDS = ("kernel", "torch")


def get_backend() -> str:
    return getattr(_state, "name", "kernel")


def set_backend(name: str) -> None:
    if name not in BACKENDS:
        raise ValueError(f"unknown model backend {name!r}; have {BACKENDS}")
    _state.name = name


def use_kernel() -> bool:
    return get_backend() == "kernel"


@contextlib.contextmanager
def backend(name: str):
    prev = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)
