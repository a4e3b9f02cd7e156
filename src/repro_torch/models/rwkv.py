"""RWKV-6 "Finch" block pieces: the port of ``src/repro/models/rwkv.py``.

[arXiv:2404.05892] Per-layer structure:
  time-mix : token-shift lerp feeds r/k/v/g projections and a data-dependent
             per-channel decay w_t = exp(-exp(w0 + tanh(x w1) w2)); the WKV
             recurrence runs through the chunked linear-scan core
             (``models/linear_scan.py``: the CUDA kernel for a sequence, the
             recurrent step for one decoded token) with current-token bonus
             ``u``; output gated by silu(g) and per-head group norm, then
             o_proj.
  channel-mix: token-shift lerp, squared-ReLU MLP (ffn_k -> relu^2 -> ffn_v).

LoRA targets: r/k/v/g/o projections + ffn_k/ffn_v. Weights have the JAX
package's keys, so ``bridge.py`` maps them 1:1.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import proj
from repro_torch.models.common import he_init, lora_at, normal_init, silu
from repro_torch.models.linear_scan import (chunked_linear_attention,
                                            linear_attention_decode_step)

DECAY_LORA_DIM = 64


def rwkv_target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    d = cfg.d_model
    return {
        "r_proj": (d, d), "k_proj": (d, d), "v_proj": (d, d),
        "g_proj": (d, d), "o_proj": (d, d),
        "ffn_k": (d, cfg.d_ff), "ffn_v": (cfg.d_ff, d),
    }


def init_rwkv_layer(gen: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    d, ff, dev = cfg.d_model, cfg.d_ff, gen.device
    H, hs = cfg.num_heads, cfg.ssm.head_size
    f32 = torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=dev)

    return {
        "tm_norm": full((d,), 1.0),
        "cm_norm": full((d,), 1.0),
        # token-shift mix coefficients (per channel, for r/k/v/g/w and ffn)
        "mu": full((5, d), 0.5),
        "mu_ffn": full((d,), 0.5),
        "r_proj": he_init(gen, (d, d), d, dtype),
        "k_proj": he_init(gen, (d, d), d, dtype),
        "v_proj": he_init(gen, (d, d), d, dtype),
        "g_proj": he_init(gen, (d, d), d, dtype),
        "o_proj": he_init(gen, (d, d), d, dtype),
        # data-dependent decay: w0 + tanh(x w1) w2  (low-rank, fp32)
        "w0": -1.0 + normal_init(gen, (d,), 0.3, f32),
        "w1": normal_init(gen, (d, DECAY_LORA_DIM), 0.02, f32),
        "w2": normal_init(gen, (DECAY_LORA_DIM, d), 0.02, f32),
        "u": normal_init(gen, (H, hs), 0.3, f32),       # bonus
        "ln_x": full((d,), 1.0),                        # per-head norm
        "ffn_k": he_init(gen, (d, ff), d, dtype),
        "ffn_v": he_init(gen, (ff, d), ff, dtype),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Shifted-by-one sequence: [Z,b,S,d] -> the previous token at each
    position; position 0 takes ``prev`` ([Z,b,d], a decode continuation)
    or zeros."""
    first = (torch.zeros_like(x[:, :, :1]) if prev is None
             else prev[:, :, None].to(x.dtype))
    return torch.cat([first, x[:, :, :-1]], dim=2)


def rwkv_time_mix(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                  cfg: ModelConfig, *,
                  prev_x: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None,
                  scale=2.0) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Time-mix over a sequence. x: [Z,b,S,d] (normed).

    Returns (out, final wkv state [Z,b,H,hs,hs] fp32, last x [Z,b,d])."""
    Z, b, S, d = x.shape
    H, hs = cfg.num_heads, cfg.ssm.head_size
    xx = _token_shift(x, prev_x)
    mu = p["mu"].to(x.dtype)
    xr, xk, xv, xg, xw = (x + (xx - x) * mu[i] for i in range(5))

    def heads(t):
        return t.reshape(Z, b, S, H, hs)

    def lp(t):
        return lora_at(lora, t, layer)

    r = heads(proj(xr, p["r_proj"], lp("r_proj"), scale, name="r_proj"))
    k = heads(proj(xk, p["k_proj"], lp("k_proj"), scale, name="k_proj"))
    v = heads(proj(xv, p["v_proj"], lp("v_proj"), scale, name="v_proj"))
    g = proj(xg, p["g_proj"], lp("g_proj"), scale, name="g_proj")

    # data-dependent decay (fp32): logw = -exp(w0 + tanh(xw w1) w2) < 0
    dd = torch.tanh(xw.float() @ p["w1"]) @ p["w2"]
    logw = heads(-torch.exp(torch.clamp(p["w0"] + dd, -8.0, 4.0)))

    if S == 1 and state is not None:
        y, new_state = linear_attention_decode_step(
            r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], state,
            bonus=p["u"], decay_on_query=False)
        y = y[:, :, None]
    else:
        y, new_state = chunked_linear_attention(
            r, k, v, logw, bonus=p["u"], decay_on_query=False,
            initial_state=state, chunk=cfg.ssm.chunk_size)

    # per-head group norm, gate, output projection
    yf = y.float()
    mean = yf.mean(dim=-1, keepdim=True)
    var = yf.var(dim=-1, keepdim=True, unbiased=False)
    yn = (yf - mean) * torch.rsqrt(var + 1e-5)
    yn = (yn.reshape(Z, b, S, d) * p["ln_x"]).to(x.dtype)
    out = proj(yn * silu(g), p["o_proj"], lp("o_proj"), scale,
               name="o_proj")
    return out, new_state, x[:, :, -1]


def rwkv_channel_mix(x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                     cfg: ModelConfig, *,
                     prev_x: Optional[torch.Tensor] = None,
                     scale=2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    xx = _token_shift(x, prev_x)
    xk = x + (xx - x) * p["mu_ffn"].to(x.dtype)
    k = proj(xk, p["ffn_k"], lora_at(lora, "ffn_k", layer), scale,
             name="ffn_k")
    k = torch.square(torch.relu(k))
    return (proj(k, p["ffn_v"], lora_at(lora, "ffn_v", layer), scale,
                 name="ffn_v"), x[:, :, -1])
