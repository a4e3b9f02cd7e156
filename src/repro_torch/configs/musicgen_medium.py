"""musicgen-medium — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284] 48L d_model=1536 24H (kv=24 => MHA) d_ff=6144 vocab=2048.
The EnCodec conv codec frontend is the allowed STUB: ``input_specs()``
provides precomputed codebook token ids / frame embeddings of the right
shape; this config is the transformer backbone that consumes them.
"""
from repro_torch.configs.base import AUDIO, ModelConfig, RoPEConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family=AUDIO,
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    rope=RoPEConfig(theta=10_000.0),
    long_context_mode="window",
    sliding_window=8192,
    input_mode="tokens",          # EnCodec discrete codes
    citation="arXiv:2306.05284 (MusicGen)",
    notes="EnCodec frontend stubbed; backbone decodes audio codebook tokens",
)
