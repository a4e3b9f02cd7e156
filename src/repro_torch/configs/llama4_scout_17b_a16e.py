"""llama4-scout-17b-a16e — Llama 4 Scout MoE (16 experts, top-1 + shared).

[hf:meta-llama/Llama-4-Scout-17B-16E] 48L d_model=5120 40H (GQA kv=8)
head_dim=128, d_ff=8192 per routed expert, 16 experts top-1 with an
always-on shared expert, vocab=202048. Early-fusion multimodal in the
original; here the language backbone (text tokens) is modeled, with MoE in
every layer (routed top-1 + shared).
"""
from repro_torch.configs.base import (MOE, LoRAConfig, ModelConfig,
                                      MoEConfig, RoPEConfig)

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family=MOE,
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope=RoPEConfig(theta=500_000.0),
    moe=MoEConfig(num_experts=16, top_k=1, d_ff_expert=8192,
                  num_shared_experts=1, d_ff_shared=8192,
                  capacity_factor=1.5),
    lora=LoRAConfig(targets=("q_proj", "k_proj", "v_proj", "o_proj")),
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    notes="top-1 routing + shared expert; expert-parallel all-to-all",
)
