"""Architecture registry: resolves ``--arch <id>`` strings to ModelConfigs.

Lists every architecture of the JAX package's registry; each config module
is a copy of the reference's with only its import changed."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import (glm4_9b, granite_8b, granite_moe_1b_a400m,
                                 hymba_1p5b, llama4_scout_17b_a16e,
                                 mistral_nemo_12b, musicgen_medium,
                                 paper_llama_tiny, qwen2_vl_72b, rwkv6_3b,
                                 stablelm_3b)
from repro_torch.configs.base import ModelConfig

_MODULES = (
    rwkv6_3b, granite_moe_1b_a400m, stablelm_3b, mistral_nemo_12b,
    hymba_1p5b, llama4_scout_17b_a16e, musicgen_medium, qwen2_vl_72b,
    granite_8b, glm4_9b, paper_llama_tiny,
)

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The 10 assigned architectures (excludes the paper-reference tiny model).
ASSIGNED: List[str] = [
    "rwkv6-3b", "granite-moe-1b-a400m", "stablelm-3b", "mistral-nemo-12b",
    "hymba-1.5b", "llama4-scout-17b-a16e", "musicgen-medium", "qwen2-vl-72b",
    "granite-8b", "glm4-9b",
]


def get_arch(name: str) -> ModelConfig:
    try:
        cfg = ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    cfg.validate()
    return cfg


def list_archs() -> List[str]:
    return sorted(ARCHS)
