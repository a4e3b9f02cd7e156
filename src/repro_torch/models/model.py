"""Unified multi-adapter decoder: init / forward / prefill / decode.

Parameters are plain dicts of tensors with the JAX package's keys and
``[L, ...]`` stacking (``bridge.py`` maps one onto the other 1:1); the JAX
package's ``lax.scan`` over the stacked layers is a Python loop over L.

Caches are updated IN PLACE: ``forward``, ``decode_step``, ``reset_lanes``
and ``prefill_lanes`` write the K/V rows (dense), the recurrent state (RWKV,
``ssm``) or both (Hymba, ``hybrid``: K/V and the Mamba state) they own into the cache tensors and return the same cache dict
(with ``pos`` / ``k_pos`` replaced). Lanes a call does not own — idle lanes
under ``active``, lanes outside ``lane_mask`` — stay bitwise untouched, the
contract the JAX package keeps with whole-cache selects.

The sharding hints (``models/shardctx``) sit where the reference's do
(``model.py:67-80,189-200``): the embedded residual stream, the
``lm_head`` weight and the logits. On a real multi-rank mesh they issue
the sharded steps' collectives (``launch/partitioning.py``); a
remat recompute re-issues its layer's collectives, in the same order on
every rank.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN_NONE, ATTN_SLIDING, ModelConfig
from repro_torch.core import lora as LORA
from repro_torch.models import backend as BK
from repro_torch.models import blocks as B
from repro_torch.models.common import (dtype_of, he_init, normal_init,
                                       resolve_device, rms_norm)
from repro_torch.models import shardctx
from repro_torch.models.mamba import init_mamba_state
from repro_torch.models.rope import rope_angles, text_positions
from repro_torch.models.shardctx import constrain

RING_INIT_POS = -(1 << 30)    # ring-cache slots start far in the past


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: Optional[str | torch.device] = None) -> Dict:
    """Random backbone weights from ``torch.Generator(device).manual_seed
    (seed)``, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg.dtype)
    emb = normal_init(gen, (cfg.vocab_size, cfg.d_model), 0.02, dtype)
    layer_list = [B.init_layer_params(gen, cfg, dtype)
                  for _ in range(cfg.num_layers)]

    def stacked(trees):
        """Stack each leaf over the layers (nested dicts per leaf)."""
        return {k: (stacked([t.pop(k) for t in trees])
                    if isinstance(trees[0][k], dict)
                    else torch.stack([t.pop(k) for t in trees]))
                for k in list(trees[0])}

    layers = stacked(layer_list)
    params = {"embed": emb, "layers": layers,
              "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                       device=dev)}
    if not cfg.tie_embeddings:
        params["lm_head"] = he_init(gen, (cfg.d_model, cfg.vocab_size),
                                    cfg.d_model, dtype)
    return params


def target_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    return B.target_shapes(cfg)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _train_window(cfg: ModelConfig) -> int:
    return cfg.sliding_window if cfg.attn_kind == ATTN_SLIDING else 0


def _embed(params: Dict, tokens: torch.Tensor,
           modal_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [Z,b,S,d]; ``modal_embeds`` ([Z,b,P,d], the stub
    modality encoder's output) replace the first P positions. Sharded
    (``shardctx.spmd()``), the lookup is vocabulary-parallel and the
    "residual" constraint reduce-scatters it along S over "model"; each
    model rank then writes the prefix rows of its own sequence block
    (``SpmdPlan.prefix``)."""
    sp = shardctx.spmd()
    if sp is not None:
        x = constrain(sp.embed(params["embed"], tokens), "residual")
        return x if modal_embeds is None else sp.prefix(x, modal_embeds)
    x = params["embed"][tokens.long()]                     # [Z,b,S,d]
    if modal_embeds is not None:
        P = modal_embeds.shape[2]
        x = torch.cat([modal_embeds.to(x.dtype), x[:, :, P:]], dim=2)
    return constrain(x, "residual")


def _angles(cfg: ModelConfig,
            positions: torch.Tensor) -> Optional[torch.Tensor]:
    if cfg.attn_kind == ATTN_NONE:
        return None
    return rope_angles(positions, cfg.resolved_head_dim, cfg.rope)


def _unembed(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits of the hidden states ``x`` [..., d]. Sharded
    (``shardctx.spmd()``), a vocabulary-parallel unembedding's logits are
    gathered over "model": every model rank returns the whole
    vocabulary."""
    W = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    W = constrain(W, "weight:lm_head")
    logits = constrain(x @ W, "logits")
    sp = shardctx.spmd()
    return logits if sp is None else sp.whole_vocab(logits)


def _remat_block(binding, model_backend: str, sharding, cfg: ModelConfig,
                 x: torch.Tensor, p: Dict, lora: Dict, layer: int,
                 ctx: Dict[str, Any]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One layer under the LoRA binding, model backend and sharding hints
    of the forward that checkpointed it: the recompute runs in the backward
    pass, possibly in autograd's own thread, where the thread-local choices
    are not set."""
    with (LORA.bound(binding), BK.backend(model_backend),
          shardctx.installed(sharding)):
        return B.apply_block(cfg, x, p, lora, layer, ctx)


def _layer_slice(tree: Dict, l: int) -> Dict:
    """Layer ``l`` of a tree of ``[L, ...]`` stacked leaves, at any
    depth (MoE's ``moe.shared`` sits two dicts down)."""
    return {k: (_layer_slice(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def _run_layers(cfg: ModelConfig, x: torch.Tensor, params: Dict, lora: Dict,
                ctx: Dict[str, Any], layers: Optional[Dict],
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``_scan_layers`` as a loop over the stacked
    layers; layer l reads its base weights at ``[l]`` and its cache views
    at ``[l]`` (``blocks.layer_cache``). ``remat`` checkpoints each layer
    (``jax.checkpoint`` around the scan body): its activations are
    recomputed in the backward pass instead of kept. Returns (x, the sum
    of the layers' MoE load-balance terms: fp32, 0 for the families
    without experts)."""
    stacked = params["layers"]
    binding, model_backend = LORA.current_binding(), BK.get_backend()
    sharding = shardctx.current()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for l in range(cfg.num_layers):
        p = _layer_slice(stacked, l)
        if layers is not None:
            ctx["cache"] = B.layer_cache(cfg, layers, l)
        if remat:
            x, a = checkpoint(_remat_block, binding, model_backend,
                              sharding, cfg, x, p, lora, l, ctx,
                              use_reentrant=False)
        else:
            x, a = B.apply_block(cfg, x, p, lora, l, ctx)
        if a is not None:
            aux = aux + a
    return x, aux


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: Dict, lora: Dict, tokens: torch.Tensor,
            *, positions: Optional[torch.Tensor] = None,
            modal_embeds: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None, remat: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Dict]]:
    """Full-sequence causal forward.

    tokens: [Z, b, S] int; ``positions`` [..., S] (M-RoPE: [3, ..., S]; by
    default ``text_positions``); ``modal_embeds`` [Z, b, P, d] written over
    the first P token embeddings. Returns (final_hidden [Z,b,S,d] (post final
    norm, pre-unembed), the MoE load-balance term summed over the layers
    (fp32 scalar; 0 for the other families), cache|None).
    With ``cache`` given (prefill), every lane's K/V are written at index
    0..S-1 (RWKV: its recurrent state continued from the cached one;
    hybrid: both, the Mamba state continued from the cached one) in
    place and the cache's position is set to S. While gradients
    are recorded and no cache is written (a training forward), every layer
    is checkpointed (``torch.utils.checkpoint``), as the JAX package's
    train step rematerializes its forward, unless ``remat`` is False."""
    Z, b, S = tokens.shape
    dev = tokens.device
    x = _embed(params, tokens, modal_embeds)
    sp = shardctx.spmd()
    if positions is None:
        positions = text_positions((), S, cfg.rope, device=dev)
    elif sp is not None:        # per-slot positions: this rank's block
        positions = sp.slot_positions(positions, cfg.rope.is_mrope)
    ctx: Dict[str, Any] = {
        "angles": _angles(cfg, positions),
        "q_pos": torch.arange(S, dtype=torch.int32, device=dev),
        "window": _train_window(cfg),
    }
    if cache is not None:
        ctx["write_index"] = 0
    remat = remat and cache is None and torch.is_grad_enabled()
    x, aux = _run_layers(cfg, x, params, lora, ctx,
                         cache["layers"] if cache is not None else None,
                         remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cache is not None:
        per_lane = cache["pos"].dim() == 2
        cache["pos"] = (torch.full_like(cache["pos"], S) if per_lane
                        else torch.tensor(S, dtype=torch.int32, device=dev))
        if "k_pos" in cache:
            kp = torch.arange(cache["k_pos"].shape[-1], dtype=torch.int32,
                              device=dev)
            cache["k_pos"] = (kp.expand_as(cache["k_pos"]).clone()
                              if per_lane else kp)
    return x, aux, cache


# ---------------------------------------------------------------------------
# Losses (chunked over sequence so [*, S, V] logits are never materialized)
# ---------------------------------------------------------------------------

def per_slot_xent(cfg: ModelConfig, params: Dict, hidden: torch.Tensor,
                  labels: torch.Tensor, chunk: int = 512
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden: [Z,b,S,d]; labels: [Z,b,S] int (-1 = ignore).

    Returns (sum_nll [Z] fp32, token_count [Z] fp32). The logits of one
    sequence chunk at a time are computed in the hidden dtype and taken to
    fp32, as the JAX package's scan over chunks does. Sharded
    (``shardctx.spmd()``) with the vocabulary split over "model", the
    hidden states are gathered along S over "model" and each rank's logits
    cover its vocabulary block: the log-sum-exp and the gold logit are
    all-reduced over "model" per chunk. With the vocabulary whole (it does
    not divide), each rank takes its own sequence block and the per-slot
    sums are all-reduced over "model" once (``SpmdPlan.loss_rows``). On a
    pod mesh the sums of this rank's b/p rows are then added over "pod"
    (``SpmdPlan.loss_sums``), before the caller's mean or log-sigmoid."""
    sp = shardctx.spmd()
    if sp is not None:
        hidden, labels = sp.loss_rows(hidden, labels)
    Z, b, S, d = hidden.shape
    W = (params["lm_head"] if not cfg.tie_embeddings
         else params["embed"].T)
    W = constrain(W, "weight:lm_head")
    c = min(chunk, S)
    while S % c:
        c -= 1
    s = torch.zeros((Z,), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((Z,), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        lab = labels[:, :, i:i + c]
        logits = constrain((hidden[:, :, i:i + c] @ W).float(), "logits")
        if sp is not None:
            lse, gold = sp.xent(logits, lab)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1,
                                lab.clamp_min(0).long()[..., None])[..., 0]
        mask = (lab >= 0).float()
        s = s + ((lse - gold) * mask).sum(dim=(1, 2))
        cnt = cnt + mask.sum(dim=(1, 2))
    if sp is not None:
        s, cnt = sp.loss_sums(s, cnt)
    return s, cnt


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, Z: int, bsz: int, max_len: int, *,
               ring: bool = False, per_lane: bool = False,
               device: Optional[str | torch.device] = None) -> Dict:
    """Build a decode cache (on the card unless ``device`` says
    otherwise). ``ring=True`` => sliding-window ring buffer of size
    ``cfg.sliding_window``; ``per_lane=True`` => the decode position is a
    ``[Z, bsz]`` vector (and the ring ``k_pos`` a ``[Z, bsz, Sc]``
    tensor), so every (slot, lane) stream advances independently.

    The RWKV family (``ssm``) keeps a recurrent state instead of K/V
    (``src/repro/models/model.py:238-241``): ``wkv`` [L,Z,bsz,H,hs,hs]
    fp32 and the token-shift streams ``tm_x`` / ``cm_x`` [L,Z,bsz,d]; it
    needs no ring (``ring`` is ignored) and no ``max_len``. The hybrid
    family keeps the attention K/V (ring or not) beside the Mamba state
    (``:243-253``): ``conv`` [L,Z,bsz,W-1,inner] and ``ssm``
    [L,Z,bsz,H,N,hs], both fp32."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    if cfg.family == "ssm":
        H, hs, d = cfg.num_heads, cfg.ssm.head_size, cfg.d_model
        layers = {"wkv": torch.zeros((L, Z, bsz, H, hs, hs),
                                     dtype=torch.float32, device=dev),
                  "tm_x": torch.zeros((L, Z, bsz, d), dtype=dtype,
                                      device=dev),
                  "cm_x": torch.zeros((L, Z, bsz, d), dtype=dtype,
                                      device=dev)}
        ring = False
    else:
        Sc = cfg.sliding_window if ring else max_len
        shape = (L, Z, bsz, Sc, KV, hd)
        layers = {"attn": {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}}
        if cfg.family == "hybrid":
            layers["mamba"] = init_mamba_state(cfg, L, Z, bsz, device=dev)
    cache: Dict[str, Any] = {
        "layers": layers,
        "pos": (torch.zeros((Z, bsz), dtype=torch.int32, device=dev)
                if per_lane
                else torch.tensor(0, dtype=torch.int32, device=dev)),
    }
    if ring:
        kp = torch.full((Sc,), RING_INIT_POS, dtype=torch.int32, device=dev)
        cache["k_pos"] = (kp.expand(Z, bsz, Sc).clone() if per_lane else kp)
    return cache


def decode_step(cfg: ModelConfig, params: Dict, lora: Dict, cache: Dict,
                tokens: torch.Tensor,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: [Z, b] int -> (logits [Z,b,V], cache).

    With a global position cache (``cache["pos"]`` 0-d) every lane writes
    and reads at the same position. With a per-lane cache (``pos`` is
    [Z, b]) each (slot, lane) stream writes at its own index and sees only
    keys up to its own position. ``active`` ([Z, b] bool, per-lane caches
    only) freezes idle lanes: their K/V rows and recurrent state and
    position stay bitwise untouched while live lanes advance.

    Sharded (``shardctx.spmd()``), ``tokens`` and the cache's layer leaves
    are this rank's shards (``partitioning.serve_cache_specs``), while a
    per-lane ``pos`` (and ring ``k_pos``) and ``active`` arrive whole: the
    layers read this rank's lanes of them (``SpmdPlan.slot_lanes``)
    for the positions, the write indices and the write mask, and the new
    positions are computed whole, the same on every rank (a ring's
    ``k_pos`` too, each rank then reading its own lanes)."""
    Z, bsz = tokens.shape
    pos = cache["pos"]
    per_lane = pos.dim() == 2
    if active is not None and not per_lane:
        raise ValueError("an active mask needs a per-lane cache")
    dev = tokens.device
    sp = shardctx.spmd()

    def mine(t):
        """A per-lane tensor's lanes of the slots this call runs."""
        return t if sp is None or t is None else sp.slot_lanes(t)

    x = _embed(params, tokens[:, :, None])
    lane_pos = mine(pos) if per_lane else pos
    if per_lane:
        positions = lane_pos[..., None]                    # [Z, b, 1]
        if cfg.rope.is_mrope:
            positions = positions.expand(3, Z, bsz, 1)
    else:
        positions = text_positions((), 1, cfg.rope, offset=pos, device=dev)
    ctx: Dict[str, Any] = {
        "angles": _angles(cfg, positions),
        "q_pos": lane_pos[..., None] if per_lane else pos[None],
        "write_mask": mine(active),
    }
    new_kpos = None
    if cfg.family == "ssm":
        pass                  # the recurrent state needs no positions
    elif "k_pos" in cache:
        W = cfg.sliding_window
        widx = torch.remainder(pos, W)
        if per_lane:
            sel = (torch.arange(W, dtype=torch.int32, device=dev)[None, None]
                   == widx[..., None])                       # [Z, b, W]
            new_kpos = torch.where(sel, pos[..., None], cache["k_pos"])
            if active is not None:
                new_kpos = torch.where(active[..., None], new_kpos,
                                       cache["k_pos"])
        else:
            new_kpos = cache["k_pos"].clone()
            new_kpos.index_copy_(0, widx.view(1).long(), pos.view(1))
        ctx.update(write_index=mine(widx) if per_lane else widx,
                   k_pos=mine(new_kpos) if per_lane else new_kpos, window=W)
    else:
        ctx.update(write_index=lane_pos, kv_valid_len=lane_pos + 1,
                   window=_train_window(cfg))
    x, _ = _run_layers(cfg, x, params, lora, ctx, cache["layers"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(cfg, params, x[:, :, 0])
    new_pos = pos + 1
    if active is not None:
        new_pos = torch.where(active, new_pos, pos)
    cache["pos"] = new_pos
    if new_kpos is not None:
        cache["k_pos"] = new_kpos
    return logits, cache


# ---------------------------------------------------------------------------
# Lane lifecycle (continuous batching over a per-lane cache)
# ---------------------------------------------------------------------------

def reset_lanes(cfg: ModelConfig, cache: Dict,
                lane_mask: torch.Tensor) -> Dict:
    """Reset the masked lanes in place to the just-initialized state (pos
    0, zero K/V and recurrent state, ring slots pushed to the far past) so
    a fresh request can join them. Unmasked lanes are bitwise untouched."""
    if cache["pos"].dim() != 2:
        raise ValueError("reset_lanes needs a per-lane cache")

    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))

    for leaf in leaves(cache["layers"]):           # [L, Z, b, ...]
        leaf.masked_fill_(lane_mask.reshape(
            1, *lane_mask.shape, *(1,) * (leaf.dim() - 3)), 0)
    cache["pos"] = torch.where(lane_mask, 0, cache["pos"]).to(torch.int32)
    if "k_pos" in cache:
        cache["k_pos"] = torch.where(lane_mask[..., None], RING_INIT_POS,
                                     cache["k_pos"]).to(torch.int32)
    return cache


def prefill_lanes(cfg: ModelConfig, params: Dict, lora: Dict, cache: Dict,
                  tokens: torch.Tensor, lane_mask: torch.Tensor,
                  plens: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict]:
    """Block-prefill a subset of lanes of a live per-lane cache.

    tokens: [Z, b, P] int (rows of non-joining lanes are ignored);
    lane_mask: [Z, b] bool. The forward runs over every lane, but only the
    joining lanes are reset and get their prompt's K/V written at 0..P-1;
    their positions become P (or ``plens``). Every other lane — mid-decode
    or idle — stays bitwise untouched. Returns (last-token logits
    [Z, b, V], cache).

    ``plens`` ([Z, b] int) serves ragged joins in one launch: each joining
    lane's true prompt length, with ``tokens`` right-padded to P. The
    padded tail writes garbage K/V at indices >= len — harmless because
    causality hides index i until the lane's position reaches i, and
    decode writes index i before it reads it (write-before-read).

    Non-ring attention caches only (ring caches and the recurrent and
    hybrid families join by streaming the prompt through ``decode_step``)."""
    if (cache["pos"].dim() != 2 or "k_pos" in cache
            or cfg.family in ("ssm", "hybrid")):
        raise ValueError("prefill_lanes needs a per-lane non-ring "
                         "attention cache")
    Z, b, P = tokens.shape
    dev = tokens.device
    reset_lanes(cfg, cache, lane_mask)
    x = _embed(params, tokens)
    ctx: Dict[str, Any] = {
        "angles": _angles(cfg, text_positions((), P, cfg.rope, device=dev)),
        "q_pos": torch.arange(P, dtype=torch.int32, device=dev),
        "window": _train_window(cfg),
        "write_index": 0,
        "write_mask": lane_mask,
    }
    x, _ = _run_layers(cfg, x, params, lora, ctx, cache["layers"])
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if plens is None:
        last = x[:, :, -1]
        new_pos = torch.full_like(cache["pos"], P)
    else:
        idx = (plens.long() - 1)[:, :, None, None].expand(Z, b, 1, x.shape[-1])
        last = torch.gather(x, 2, idx)[:, :, 0]
        new_pos = plens.to(torch.int32)
    logits = _unembed(cfg, params, last)
    cache["pos"] = torch.where(lane_mask, new_pos,
                               cache["pos"]).to(torch.int32)
    return logits, cache
