"""qwen2-vl-72b — Qwen2-VL 72B language backbone with M-RoPE.

[arXiv:2409.12191] 80L d_model=8192 64H (GQA kv=8) head_dim=128 d_ff=29568
vocab=152064. M-RoPE: rotary dims split into (temporal, height, width)
sections over 3-component position ids. The ViT vision encoder + projector
is the allowed STUB: ``input_specs()`` provides precomputed patch embeddings
merged at image-token prefix positions (dynamic-resolution is represented by
the stub's patch count).
"""
from repro_torch.configs.base import VLM, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family=VLM,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    rope=RoPEConfig(theta=1_000_000.0, mrope_sections=(16, 24, 24)),
    long_context_mode="window",
    sliding_window=8192,
    input_mode="mixed",
    num_modality_tokens=256,       # stub patch-embedding prefix length
    citation="arXiv:2409.12191 (Qwen2-VL)",
    notes="M-RoPE (t,h,w) sections; vision tower stubbed as patch embeddings",
)
