"""Shared low-level model components: norms, init, dtype and device policy."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device: Optional[str | torch.device]) -> torch.device:
    """Entry points run on the card: ``None`` means ``"cuda"``, and a CUDA
    device without a card raises. The CPU is used only when the caller
    asks for it (``device="cpu"``), as the tests do."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default — pass device='cpu' (CLI: --device cpu) to run on the "
            "CPU")
    return dev


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, cast back to input dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dt)


def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 on the generator's device, cast
    to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def he_init(gen: torch.Generator, shape: Sequence[int], fan_in: int,
            dtype: torch.dtype) -> torch.Tensor:
    return normal_init(gen, shape, 1.0 / np.sqrt(max(fan_in, 1)), dtype)


def lora_at(lora: Dict, target: str, layer: int
            ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """Layer ``layer``'s (A, B) of a stacked LoRA tree, or None when the
    tree has no adapter on ``target``."""
    if target not in lora:
        return None
    return lora[target]["A"][layer], lora[target]["B"][layer]


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return silu(gate) * up


def causal_mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """Additive attention bias: 0 where visible, -inf where masked.

    q_pos: [..., Sq] absolute query positions
    k_pos: [..., Sk] absolute key positions
    window: 0 => full causal; >0 => sliding window of that many positions
    """
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    visible = k <= q
    if window > 0:
        visible &= k > (q - window)
    zero = torch.zeros((), dtype=torch.float32, device=visible.device)
    return torch.where(visible, zero, zero - float("inf"))
