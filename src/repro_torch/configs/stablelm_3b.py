"""stablelm-3b — StableLM-family dense decoder.

[hf:stabilityai/stablelm-2-1_6b] (assigned dims) 32L d_model=2560 32H
(GQA kv=32 => MHA) d_ff=6912 vocab=50304.
"""
from repro_torch.configs.base import DENSE, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family=DENSE,
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    rope=RoPEConfig(theta=10_000.0),
    long_context_mode="window",   # long_500k uses sliding-window decode
    sliding_window=8192,
    citation="hf:stabilityai/stablelm-2-1_6b",
)
