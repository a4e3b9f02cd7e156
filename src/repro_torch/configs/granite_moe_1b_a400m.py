"""granite-moe-1b-a400m — IBM Granite 3.0 1B-A400M MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H (GQA kv=8)
d_ff=512 per expert, 32 experts top-8, vocab=49155.
"""
from repro_torch.configs.base import (MOE, LoRAConfig, ModelConfig,
                                      MoEConfig)

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family=MOE,
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    moe=MoEConfig(num_experts=32, top_k=8, d_ff_expert=512,
                  capacity_factor=1.25),
    lora=LoRAConfig(targets=("q_proj", "k_proj", "v_proj", "o_proj")),
    tie_embeddings=True,
    citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    notes="32 experts top-8; expert FFNs frozen, LoRA on attention projections",
)
