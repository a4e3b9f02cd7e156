"""glm4-9b — GLM-4 9B dense decoder with extreme GQA (kv=2).

[hf:THUDM/glm-4-9b] 40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552.
kv_heads=2 < model-axis size stresses the KV sharding rules (KV replicated
or sequence-sharded on the model axis).
"""
from repro_torch.configs.base import DENSE, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family=DENSE,
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope=RoPEConfig(theta=10_000.0),
    long_context_mode="window",
    sliding_window=8192,
    citation="hf:THUDM/glm-4-9b",
)
