"""paper-llama-tiny — ~100M Llama-style model for end-to-end runnable examples.

This is the in-repo analogue of the paper's single-GPU models (Llama-3.1-8B
class), scaled to ~100M params so a few hundred real training steps run on
CPU. It is the config used by the end-to-end driver (examples/) and the
kernel microbenchmark (paper Table 2 uses Llama-3.2-1B similarly scaled).
"""
from repro_torch.configs.base import DENSE, LoRAConfig, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="paper-llama-tiny",
    family=DENSE,
    num_layers=8,
    d_model=512,
    num_heads=8,
    num_kv_heads=4,
    head_dim=64,
    d_ff=1536,
    vocab_size=8192,
    rope=RoPEConfig(theta=10_000.0),
    long_context_mode="window",
    sliding_window=1024,
    lora=LoRAConfig(r_max=32),
    citation="paper §8.1 (scaled-down Llama-class reference model)",
)
