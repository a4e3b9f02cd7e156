"""rwkv6-3b — RWKV-6 "Finch": attention-free, data-dependent decay.

[arXiv:2404.05892] 32L d_model=2560 d_ff=8960 vocab=65536, head_size=64
(40 recurrent heads). LoRA attaches to the time-mix (r/k/v/g/o) and
channel-mix projections; ALTO's grouped-LoRA + AP apply unchanged.
`long_500k` decodes natively with O(1) recurrent state.
"""
from repro_torch.configs.base import (ATTN_NONE, SSM, LoRAConfig, ModelConfig,
                                SSMConfig)

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family=SSM,
    num_layers=32,
    d_model=2560,
    num_heads=40,            # 2560 / head_size 64
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attn_kind=ATTN_NONE,
    long_context_mode="recurrent",
    ssm=SSMConfig(state_size=64, head_size=64, chunk_size=128),
    lora=LoRAConfig(targets=(
        "r_proj", "k_proj", "v_proj", "g_proj", "o_proj",
        "ffn_k", "ffn_v")),
    citation="arXiv:2404.05892 (RWKV-6 Finch)",
    notes="data-dependent decay w_t; wkv chunked scan; token-shift mixing",
)
