"""Config system of the PyTorch port: a copy of ``repro.configs.base``.

The port imports nothing of the JAX package, so the dataclasses and
``reduced()`` are copied here unchanged; the two packages must agree on
every field so that a test can hand the same configuration to both.

``TrainConfig`` (per-job training hyperparameters), the input shapes
(``ShapeConfig``, with the ``KIND_*`` step kinds) and the logical mesh
(``MeshConfig``) are copied too.

Design rules:
  * No config object ever touches device state at import time.
  * Reduced ("smoke") variants are derived from the full config via
    ``reduced()`` so smoke tests always exercise the same code path as the
    production config.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Architecture families
# ---------------------------------------------------------------------------
DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
AUDIO = "audio"
VLM = "vlm"

FAMILIES = (DENSE, MOE, SSM, HYBRID, AUDIO, VLM)

# Attention kinds
ATTN_FULL = "full"          # full causal attention
ATTN_SLIDING = "sliding"    # sliding-window causal attention
ATTN_NONE = "none"          # attention-free (pure SSM / RWKV)


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int
    top_k: int
    d_ff_expert: int                 # per-expert hidden dim
    num_shared_experts: int = 0      # always-on shared expert(s)
    d_ff_shared: int = 0             # hidden dim of the shared expert path
    capacity_factor: float = 1.25    # GShard-style expert capacity
    router_aux_weight: float = 0.01  # load-balance auxiliary loss weight
    moe_every: int = 1               # apply MoE every k-th layer (1 = all)

    def validate(self) -> None:
        assert 1 <= self.top_k <= self.num_experts
        assert self.d_ff_expert > 0
        assert self.moe_every >= 1


@dataclass(frozen=True)
class SSMConfig:
    """State-space / RWKV recurrent block configuration."""
    state_size: int = 16          # per-head recurrent state (Mamba N / RWKV hd)
    head_size: int = 64           # recurrent head width (RWKV6 uses 64)
    expand: int = 2               # Mamba expansion factor
    conv_width: int = 4           # short conv width (Mamba)
    chunk_size: int = 128         # chunked-scan block length
    dt_rank: int = 0              # 0 -> ceil(d_model/16) at build time


@dataclass(frozen=True)
class RoPEConfig:
    theta: float = 10_000.0
    # M-RoPE (Qwen2-VL): dims of head_dim allotted to (temporal, height, width)
    mrope_sections: Optional[Tuple[int, int, int]] = None

    @property
    def is_mrope(self) -> bool:
        return self.mrope_sections is not None


@dataclass(frozen=True)
class LoRAConfig:
    """Multi-adapter LoRA configuration (the ALTO workload unit).

    ``r_max`` is the slot-stacked padded rank (paper §A.1 rank-only padding);
    per-slot true ranks live in the runtime adapter state, not the config.
    """
    r_max: int = 64
    # which projections carry adapters (paper: all attn + MLP projections)
    targets: Tuple[str, ...] = (
        "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
        "down_proj",
    )
    alpha_over_r: float = 2.0     # paper: alpha = 2r
    dropout: float = 0.0

    def scale_for_rank(self, r: int) -> float:
        return self.alpha_over_r  # alpha/r with alpha = alpha_over_r * r


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the unified decoder stack."""
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // num_heads
    attn_kind: str = ATTN_FULL
    sliding_window: int = 4096             # used when attn_kind == sliding
    # long-context decode policy: "window" (dense w/ sliding window cache),
    # "recurrent" (SSM state), "hybrid" (ssm state + window cache)
    long_context_mode: str = "window"
    rope: RoPEConfig = field(default_factory=RoPEConfig)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    lora: LoRAConfig = field(default_factory=LoRAConfig)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # input modality: "tokens" | "embeddings" | "mixed" (tokens + stub
    # modality embeddings merged at prefix positions)
    input_mode: str = "tokens"
    num_modality_tokens: int = 0           # prefix positions fed by the stub
    citation: str = ""
    notes: str = ""
    dtype: str = "bfloat16"

    # ---- derived ---------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def is_recurrent(self) -> bool:
        return self.family in (SSM, HYBRID)

    def validate(self) -> None:
        assert self.family in FAMILIES, self.family
        assert self.num_layers >= 1
        if self.attn_kind != ATTN_NONE:
            assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
                "GQA requires num_heads divisible by num_kv_heads")
        if self.moe is not None:
            self.moe.validate()
        if self.family in (SSM, HYBRID):
            assert self.ssm is not None
        if self.input_mode == "mixed":
            assert self.num_modality_tokens > 0

    # ---- parameter accounting (used by scheduler memory model + roofline)
    def param_count(self, active_only: bool = False) -> int:
        """Approximate backbone parameter count (embeddings included once)."""
        d, hd = self.d_model, self.resolved_head_dim
        attn = d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
        if self.attn_kind == ATTN_NONE:
            attn = 0
        if self.moe is not None:
            e = self.moe.top_k if active_only else self.moe.num_experts
            ffn = 3 * d * self.moe.d_ff_expert * e
            if self.moe.num_shared_experts:
                ffn += 3 * d * self.moe.d_ff_shared * self.moe.num_shared_experts
            dense_layers = 0
            if self.moe.moe_every > 1:
                n_moe = self.num_layers // self.moe.moe_every
                dense_layers = self.num_layers - n_moe
                ffn = ffn * n_moe / max(self.num_layers, 1)
                ffn += 3 * d * self.d_ff * dense_layers / max(self.num_layers, 1)
            ffn += d * self.moe.num_experts  # router
        else:
            ffn = 3 * d * self.d_ff
        ssm = 0
        if self.ssm is not None:
            # in/out/x-proj + conv + dt (rough; exact per-arch detail in model)
            inner = self.ssm.expand * d
            ssm = d * inner * 2 + inner * d + inner * (
                self.ssm.state_size * 2 + self.ssm.conv_width + 1)
        per_layer = attn + ffn + ssm + 2 * d  # + norms
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(self.num_layers * per_layer + emb + d)

    def lora_param_count(self, rank: int) -> int:
        """Trainable params of ONE adapter at ``rank`` over ``lora.targets``."""
        d, hd = self.d_model, self.resolved_head_dim
        sizes = {
            "q_proj": (d, self.q_dim), "k_proj": (d, self.kv_dim),
            "v_proj": (d, self.kv_dim), "o_proj": (self.q_dim, d),
            "gate_proj": (d, self.d_ff), "up_proj": (d, self.d_ff),
            "down_proj": (self.d_ff, d),
        }
        if self.moe is not None:
            ff = self.moe.d_ff_shared or self.moe.d_ff_expert
            sizes.update({"gate_proj": (d, ff), "up_proj": (d, ff),
                          "down_proj": (ff, d)})
        total = 0
        for t in self.lora.targets:
            if t not in sizes:
                continue
            din, dout = sizes[t]
            total += rank * (din + dout)
        return int(self.num_layers * total)

    # ---- reduced variant for smoke tests ---------------------------------
    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """Same family/code path, tiny dims (CPU-runnable smoke variant)."""
        hd = 32
        heads = max(d_model // hd, 2)
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        moe = None
        if self.moe is not None:
            moe = replace(self.moe, num_experts=min(4, self.moe.num_experts),
                          top_k=min(self.moe.top_k, 2),
                          d_ff_expert=d_model, d_ff_shared=(
                              d_model if self.moe.num_shared_experts else 0))
        ssm = None
        if self.ssm is not None:
            ssm = replace(self.ssm, head_size=hd, chunk_size=16)
        mrope = self.rope.mrope_sections
        if mrope is not None:
            # keep 3 sections summing to hd//2
            mrope = (hd // 4, hd // 8, hd // 8)
        return replace(
            self, num_layers=num_layers, d_model=d_model, num_heads=heads,
            num_kv_heads=kv, head_dim=hd, d_ff=2 * d_model, vocab_size=vocab,
            sliding_window=min(self.sliding_window, 64),
            rope=replace(self.rope, mrope_sections=mrope),
            moe=moe, ssm=ssm,
            lora=replace(self.lora, r_max=8),
            num_modality_tokens=min(self.num_modality_tokens, 8),
        )


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------
KIND_TRAIN = "train"
KIND_PREFILL = "prefill"
KIND_DECODE = "decode"


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    # preferred (Z, b) decomposition; 0 -> auto
    num_slots: int = 0
    per_adapter_batch: int = 0

    def decompose(self) -> Tuple[int, int]:
        """global_batch = Z * b (ALTO slots x per-adapter batch)."""
        if self.num_slots:
            z = self.num_slots
            b = self.per_adapter_batch or (self.global_batch // z)
        else:
            z = min(64, self.global_batch)
            b = self.global_batch // z
        assert z * b == self.global_batch, (
            f"{self.name}: {z}*{b} != {self.global_batch}")
        return z, b

    @property
    def is_decode(self) -> bool:
        return self.kind == KIND_DECODE


@dataclass(frozen=True)
class MeshConfig:
    """Logical mesh description (built by launch/mesh.py)."""
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


@dataclass(frozen=True)
class TrainConfig:
    """Per-job training hyperparameters (one point in the search space)."""
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    lora_rank: int = 16
    per_adapter_batch: int = 4
    max_steps: int = 100
    warmup_steps: int = 0
    grad_clip: float = 1.0
    seed: int = 0

    def label(self) -> str:
        return (f"lr{self.learning_rate:g}_r{self.lora_rank}"
                f"_b{self.per_adapter_batch}_s{self.seed}")
