"""hymba-1.5b — NVIDIA Hymba hybrid-head decoder.

[arXiv:2411.13676] 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16. Parallel attention + Mamba heads within each layer; outputs
fused (mean of normed branch outputs). Attention uses sliding window in most
layers (global in a few) per the paper; SSM branch gives sub-quadratic
long-context decode.
"""
from repro_torch.configs.base import (ATTN_SLIDING, HYBRID, LoRAConfig,
                                      ModelConfig, RoPEConfig, SSMConfig)

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family=HYBRID,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_kind=ATTN_SLIDING,
    sliding_window=1024,
    long_context_mode="hybrid",   # ssm state + windowed attention cache
    rope=RoPEConfig(theta=10_000.0),
    ssm=SSMConfig(state_size=16, head_size=64, expand=2, chunk_size=128),
    lora=LoRAConfig(targets=("in_proj", "q_proj", "k_proj", "v_proj",
                             "o_proj", "gate_proj", "up_proj", "down_proj")),
    citation="arXiv:2411.13676 (Hymba)",
    notes="parallel attn+mamba heads sharing in/out projections",
)
