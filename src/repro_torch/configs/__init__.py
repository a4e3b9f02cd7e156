"""Config system: dataclasses and the architectures the port runs."""
from repro_torch.configs.base import (LoRAConfig, ModelConfig, RoPEConfig,
                                      TrainConfig)

__all__ = ["LoRAConfig", "ModelConfig", "RoPEConfig", "TrainConfig"]
