"""mistral-nemo-12b — Mistral-NeMo dense decoder, 128k context.

[hf:mistralai/Mistral-Nemo-Base-2407] 40L d_model=5120 32H (GQA kv=8)
head_dim=128 (q_dim 4096 != d_model) d_ff=14336 vocab=131072.
"""
from repro_torch.configs.base import DENSE, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family=DENSE,
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope=RoPEConfig(theta=1_000_000.0),
    long_context_mode="window",
    sliding_window=8192,
    citation="hf:mistralai/Mistral-Nemo-Base-2407",
    notes="head_dim=128 decoupled from d_model/num_heads",
)
