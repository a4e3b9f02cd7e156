"""GQA causal attention: the flash-attention kernel for contiguous causal
forwards, the JAX package's single-device "baseline" path otherwise.

Under the "kernel" model backend (``models/backend.py``, the default) a
contiguous causal forward — more than one query, no ``kv_valid_len``, 1-D
positions, as many keys as queries: every training, remat and eval forward
and a prefill that fills its whole cache — goes to
``kernels/flash_attention`` in the ``[Z*b*H, S, hd]`` layout, with K/V
repeated to the query heads for GQA, as ``src/repro/models/attention.py:
102-124`` dispatches to the Pallas kernel. Prefill into a longer cache,
decode and the "torch" backend take the baseline path: grouped-query
einsums with an fp32 softmax per query chunk, a per-lane ``[Z, b, Sq, Sk]``
bias when positions carry lane dims (continuous batching), and
``_softmax_chunk``'s ``-1e30`` floor so fully masked rows give zeros. The
repeat/kshard sharding layouts come with the ``launch/`` slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import backend as BK
from repro_torch.models.common import causal_mask_bias


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: [Z,b,qc,KV,G,hd], k: [Z,b,Sk,KV,hd] -> [Z,b,KV,G,qc,Sk] fp32
    (bf16 products are exact in fp32, as XLA's
    ``preferred_element_type=f32``)."""
    return torch.einsum("zbqkgh,zbskh->zbkgqs", q.float(), k.float())


def _gqa_combine(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: [Z,b,KV,G,qc,Sk], v: [Z,b,Sk,KV,hd] -> [Z,b,qc,KV,G,hd]."""
    return torch.einsum("zbkgqs,zbskh->zbqkgh", p.to(v.dtype), v)


def _softmax_chunk(scores: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    s = scores + bias
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # fully masked rows
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    return e / denom.clamp_min(1e-30)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, *,
              window: int = 0, q_chunk: int = 512,
              kv_valid_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention.

    q:      [Z, b, Sq, H, hd]
    q_pos:  [Sq] — or [Z, b, Sq] for per-lane positions
    k, v:   [Z, b, Sk, KV, hd]   (H = KV * G)
    k_pos:  [Sk] absolute positions, or [Z, b, Sk] per lane (ring caches)
    window: sliding window size (0 = full causal)
    kv_valid_len: optional scalar — or [Z, b] per lane — keys at
            index >= len are masked
    returns [Z, b, Sq, H, hd]
    """
    Z, b, Sq, H, hd = q.shape
    KV = k.shape[3]
    if H % KV:
        raise ValueError(f"GQA needs H % KV == 0, got H={H} KV={KV}")
    G = H // KV
    if (BK.use_kernel() and Sq > 1 and kv_valid_len is None
            and q_pos.dim() == 1 and k_pos.dim() == 1
            and q_pos.shape[0] == Sq and k_pos.shape[0] == k.shape[2]
            and k.shape[2] == Sq):
        # the hand kernel: contiguous causal (suffix-aligned ranges, no
        # partially filled or longer cache); at Z = b = 1 the reshape is a
        # strided view, so the rows are made contiguous
        kk = k.repeat_interleave(G, dim=3) if G > 1 else k
        vv = v.repeat_interleave(G, dim=3) if G > 1 else v
        qf, kf, vf = (t.permute(0, 1, 3, 2, 4).reshape(Z * b * H, Sq, hd)
                      .contiguous() for t in (q, kk, vv))
        out = FA.flash_attention(qf, kf, vf, causal=True, window=window)
        return out.reshape(Z, b, H, Sq, hd).permute(0, 1, 3, 2, 4)
    scale = hd ** -0.5
    kv_index = torch.arange(k.shape[2], dtype=torch.int32, device=q.device)

    def bias_for(pos_c):
        bias = causal_mask_bias(pos_c, k_pos, window)
        if kv_valid_len is not None:
            vlen = kv_valid_len
            zero = torch.zeros((), dtype=torch.float32, device=q.device)
            if vlen.dim():                       # per-lane [Z, b]
                bias = bias + torch.where(kv_index < vlen[..., None, None],
                                          zero, zero - float("inf"))
            else:
                bias = bias + torch.where(kv_index[None, :] < vlen,
                                          zero, zero - float("inf"))
        # per-lane [Z, b, Sq, Sk] -> broadcast over the (KV, G) head dims
        return bias if bias.dim() == 2 else bias[:, :, None, None]

    q = (q * scale).reshape(Z, b, Sq, KV, G, hd)

    def chunk_attn(q_c, pos_c):
        p = _softmax_chunk(_gqa_scores(q_c, k), bias_for(pos_c))
        return _gqa_combine(p, v)

    if Sq <= q_chunk:
        out = chunk_attn(q, q_pos)
    else:
        if q_pos.dim() != 1 or Sq % q_chunk:
            raise ValueError("chunked attention needs shared positions and "
                             f"Sq % q_chunk == 0 (Sq={Sq}, q_chunk={q_chunk})")
        out = torch.cat([chunk_attn(q[:, :, i:i + q_chunk],
                                    q_pos[i:i + q_chunk])
                         for i in range(0, Sq, q_chunk)], dim=2)
    return out.reshape(Z, b, Sq, H, hd)
