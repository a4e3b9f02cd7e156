"""GQA causal attention: the flash-attention kernel for contiguous causal
forwards, the JAX package's einsum paths otherwise.

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
``_softmax_chunk``'s ``-1e30`` floor so fully masked rows give zeros.

Sharding-aware layouts (opt_level >= 1 with a model axis of more than one
rank, from the ``models/shardctx`` hints; reference ``attention.py:6-21,
60-70``): "grouped" (KV % m == 0: the grouped-query einsums, KV sharded),
"repeat" (H % m == 0: K/V repeated to the H query heads, H sharded) and
"kshard" (otherwise: keys, values and probabilities sharded along Sk), each
with the reference's per-dim constraints; at opt_level >= 2 each query
chunk is checkpointed (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` around its scan body, ``:211-214``). Without hints, and
on one card, where ``model_size`` is 1, the mode is "baseline". The flash
dispatch comes first, as in the reference, so a contiguous causal forward
takes the kernel under every mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import backend as BK
from repro_torch.models import shardctx
from repro_torch.models.common import causal_mask_bias
from repro_torch.models.shardctx import constrain, get_hint


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


def _dims(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain with an explicit per-dim axis assignment (the policy drops
    an axis that does not divide its dim)."""
    return constrain(x, "dims:" + ",".join(a or "-" for a in axes))


def _pick_mode(H: int, KV: int) -> str:
    if get_hint("opt_level", 0) < 1:
        return "baseline"
    m = get_hint("model_size", 0) or 0
    if m <= 1:
        return "baseline"
    if KV % m == 0:
        return "grouped"
    if H % m == 0:
        return "repeat"
    return "kshard"


def _chunk_under(state, fn, q_c, pos_c):
    """``fn(q_c, pos_c)`` under a ``shardctx`` state: a checkpointed
    chunk's recompute may run in autograd's own thread."""
    with shardctx.installed(state):
        return fn(q_c, pos_c)


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
    mode = _pick_mode(H, KV)
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
        return bias

    def headed(bias, n_head_dims):
        """A per-lane [Z, b, Sq, Sk] bias with broadcast head dims, to line
        up with [Z, b, <heads...>, Sq, Sk] scores; a plain [Sq, Sk] bias
        already broadcasts."""
        if bias.dim() == 2:
            return bias
        return bias.reshape(*bias.shape[:2], *(1,) * n_head_dims,
                            *bias.shape[2:])

    if mode == "repeat":
        k = _dims(k.repeat_interleave(G, dim=3), "data", "pod", None, "model")
        v = _dims(v.repeat_interleave(G, dim=3), "data", "pod", None, "model")
        q = _dims(q * scale, "data", "pod", None, "model")

        def chunk_attn(q_c, pos_c):
            scores = torch.einsum("zbqhd,zbshd->zbhqs", q_c.float(),
                                  k.float())
            scores = _dims(scores, "data", "pod", "model")
            p = _softmax_chunk(scores, headed(bias_for(pos_c), 1))
            out = torch.einsum("zbhqs,zbshd->zbqhd", p.to(v.dtype), v)
            return _dims(out, "data", "pod", None, "model")
    elif mode == "kshard":
        k = _dims(k, "data", "pod", "model")
        v = _dims(v, "data", "pod", "model")
        q = _dims(q * scale, "data", "pod").reshape(Z, b, Sq, KV, G, hd)

        def chunk_attn(q_c, pos_c):
            scores = _dims(_gqa_scores(q_c, k), "data", "pod", None, None,
                           None, "model")
            p = _softmax_chunk(scores, headed(bias_for(pos_c), 2))
            return _dims(_gqa_combine(p, v), "data", "pod")
    else:
        # baseline, and grouped: KV-sharded when it divides
        q = (q * scale).reshape(Z, b, Sq, KV, G, hd)
        if mode == "grouped":
            q = _dims(q, "data", "pod", None, "model")
            k = _dims(k, "data", "pod", None, "model")
            v = _dims(v, "data", "pod", None, "model")

        def chunk_attn(q_c, pos_c):
            scores = _gqa_scores(q_c, k)
            if mode == "grouped":
                scores = _dims(scores, "data", "pod", "model")
            p = _softmax_chunk(scores, headed(bias_for(pos_c), 2))
            return _gqa_combine(p, v)

    if Sq <= q_chunk:
        out = chunk_attn(q, q_pos)
    else:
        if q_pos.dim() != 1 or Sq % q_chunk:
            raise ValueError("chunked attention needs shared positions and "
                             f"Sq % q_chunk == 0 (Sq={Sq}, q_chunk={q_chunk})")
        remat = get_hint("opt_level", 0) >= 2 and torch.is_grad_enabled()
        state = shardctx.current()
        outs = []
        for i in range(0, Sq, q_chunk):
            q_c, pos_c = q[:, :, i:i + q_chunk], q_pos[i:i + q_chunk]
            if remat:
                # per-chunk fp32 scores recomputed in the backward, not kept
                outs.append(checkpoint(_chunk_under, state, chunk_attn, q_c,
                                       pos_c, use_reentrant=False))
            else:
                outs.append(chunk_attn(q_c, pos_c))
        out = torch.cat(outs, dim=2)
    out = out.reshape(Z, b, Sq, H, hd)
    if mode == "baseline":
        out = constrain(out, "attn_qkv")
    return out
