"""Architecture registry: resolves ``--arch <id>`` strings to ModelConfigs.

Lists only the architectures the port runs (the dense family, the MoE
family, the RWKV ``ssm`` family and the Hymba ``hybrid`` family); every
other architecture of the JAX package raises "not ported yet"."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (granite_moe_1b_a400m, hymba_1p5b,
                                 llama4_scout_17b_a16e, paper_llama_tiny,
                                 rwkv6_3b, stablelm_3b)
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG for m in (stablelm_3b, paper_llama_tiny,
                                       rwkv6_3b, hymba_1p5b,
                                       granite_moe_1b_a400m,
                                       llama4_scout_17b_a16e)}

# the JAX package's other architectures (other families or not yet copied)
NOT_PORTED = (
    "mistral-nemo-12b", "musicgen-medium", "qwen2-vl-72b", "granite-8b",
    "glm4-9b",
)


def get_arch(name: str) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name!r} is not ported yet; have {sorted(ARCHS)}")
    try:
        cfg = ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg.validate()
    return cfg


def list_archs() -> List[str]:
    return sorted(ARCHS)
