"""Chunked linear-attention / gated-SSM scan core: the port of
``src/repro/models/linear_scan.py``.

One numerical core serves both RWKV-6 (data-dependent per-channel decay
with current-token bonus ``u``) and Mamba-2/SSD (decay on the query, no
bonus). Recurrence (per head; state S maps key-dim K -> value-dim V):

    S_t = diag(w_t) S_{t-1} + k_t^T v_t             w_t = exp(logw_t) in (0,1]
    y_t = q_t S_{t-1} + (q_t . u) k_t v_t           (decay_on_query=False; RWKV)
    y_t = q_t S_t                                    (decay_on_query=True; SSD)

The sequence is evaluated in chunks of C tokens, the intra-chunk pair term
exactly in log space (``kernels/linear_scan/ref.py`` holds the plain core).
``chunked_linear_attention`` fuses the rows to B = Z*b*H and runs them
through the chunked linear-scan kernel under the "kernel" model backend
(``models/backend.py``, the default) and through the plain core under
"torch", as ``src/repro/models/linear_scan.py:58-73`` dispatches to the
Pallas kernel.

The two tuning hints of ``models/shardctx`` (reference ``:51-52``):
``scan_chunk`` overrides the chunk (the launcher's opt-level 2 train policy
sets 32; the kernel takes any chunk that divides S and fits its shared
memory, and raises otherwise, never taking the plain core); and
``opt_level >= 2`` asks for the per-chunk checkpoint, which the port's
plain core, the scan's backward, keeps at every opt level while gradients
are recorded (the same numbers; holding every chunk's ``[B, C, C, K]``
pair tensors is what the hint exists to avoid).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.linear_scan import ops as LSK
from repro_torch.kernels.linear_scan import ref
from repro_torch.models import backend as BK
from repro_torch.models.shardctx import get_hint


def chunked_linear_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    *, bonus: Optional[torch.Tensor] = None,
    decay_on_query: bool = False,
    initial_state: Optional[torch.Tensor] = None,
    chunk: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, logw: [Z,b,S,H,K]; v: [Z,b,S,H,V]; bonus: [H,K] or None;
    initial_state: [Z,b,H,K,V] or None.

    Returns (y [Z,b,S,H,V] in q's dtype, final_state [Z,b,H,K,V] fp32)."""
    Z, b, S, H, K = q.shape
    V = v.shape[-1]
    C = min(int(get_hint("scan_chunk", 0) or chunk), S)
    while S % C:
        C -= 1
    Bf = Z * b * H

    def to_rows(x, d):        # a strided view at Z = b = 1: made contiguous
        return x.permute(0, 1, 3, 2, 4).reshape(Bf, S, d).contiguous()

    bon = (bonus.float()[None, None].expand(Z, b, H, K).reshape(Bf, K)
           if bonus is not None else None)
    s0 = (initial_state.float().reshape(Bf, K, V)
          if initial_state is not None else None)
    scan = LSK.linear_scan if BK.use_kernel() else ref.linear_scan_ref
    y, st = scan(to_rows(q, K), to_rows(k, K), to_rows(v, V),
                 to_rows(logw.float(), K), bonus=bon,
                 decay_on_query=decay_on_query, initial_state=s0, chunk=C)
    y = y.reshape(Z, b, H, S, V).permute(0, 1, 3, 2, 4)
    return y.to(q.dtype), st.reshape(Z, b, H, K, V)


def linear_attention_decode_step(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    state: torch.Tensor, *, bonus: Optional[torch.Tensor] = None,
    decay_on_query: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.

    q, k, logw: [Z,b,H,K]; v: [Z,b,H,V]; state: [Z,b,H,K,V] fp32.
    Returns (y [Z,b,H,V] in q's dtype, new_state fp32)."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    w = torch.exp(logw.float())
    new_state = state * w[..., None] + kf[..., :, None] * vf[..., None, :]
    if decay_on_query:
        y = torch.einsum("zbhk,zbhkv->zbhv", qf, new_state)
    else:
        y = torch.einsum("zbhk,zbhkv->zbhv", qf, state)
        if bonus is not None:
            y = y + (qf * bonus.float() * kf).sum(-1, keepdim=True) * vf
    return y.to(q.dtype), new_state


def reference_linear_attention(q, k, v, logw, *, bonus=None,
                               decay_on_query=False, initial_state=None):
    """O(S) step-by-step oracle (tests validate the chunked path with
    it)."""
    Z, b, S, H, K = q.shape
    V = v.shape[-1]
    state = (torch.zeros((Z, b, H, K, V), dtype=torch.float32,
                         device=q.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(S):
        y, state = linear_attention_decode_step(
            q[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t], state,
            bonus=bonus, decay_on_query=decay_on_query)
        ys.append(y)
    return torch.stack(ys, dim=2), state
