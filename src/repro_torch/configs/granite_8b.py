"""granite-8b — IBM Granite Code 8B (llama-arch dense).

[arXiv:2405.04324] 36L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=49152.
"""
from repro_torch.configs.base import DENSE, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family=DENSE,
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    rope=RoPEConfig(theta=10_000_000.0),
    long_context_mode="window",
    sliding_window=8192,
    citation="arXiv:2405.04324 (Granite Code Models)",
)
