"""Mixture-of-Experts with grouped, capacity-bound token-choice routing.

The same function as the JAX package's ``moe_block``: the flattened
``Z·b·S`` tokens split into groups of ``pick_group_size(T)``; each token
picks its top-k experts from an fp32 softmax router, the selected gates are
renormalized, and every expert takes at most ``cap`` choices per group, in
token-major priority order (earlier tokens first, then lower k). A dropped
choice keeps a zero gate (the kept gates are not renormalized). The routed
experts, the router and the shared expert are frozen base weights (LoRA
attaches to attention only); the load-balance term ``aux`` is returned for
the loss.

Dispatch and combine go by index instead of the reference's ``[G, s, E,
cap]`` one-hot contractions (their entries are 0 or 1, so the values are
the same exactly; at granite-moe's train step each one-hot tensor would
hold 671 MB in fp32): each kept choice writes its token's row into its
own ``(e, g, c)`` slot of the expert buffer, and each token gathers its k
expert outputs back and sums them over k in a fixed order. Dropped choices
write into, and read from, one spare row whose value and gradient are
never used. Every other row has one writer and one reader at most, so no
pass, forward or backward, adds into a row in a data-dependent order: the
backward is deterministic, bit for bit. The expert GEMMs are ``torch.bmm``
over the experts (the JAX package computes them outside any Pallas kernel,
so this layer has no kernel of its own).

``moe_block`` reads ``route`` and its other parts at call time, so a check
can wrap one (to read the routing or time it) or replace it (to plant a
fault).

The sharding hints of ``models/shardctx`` sit where the reference's do
(``moe.py:76-138``): the token groups and the output over data+pod at
opt_level >= 1, the expert weights by name, and the expert-major buffers
as ``moe_expert`` ([E, G, cap, d] views). The reference's opt-level
constraints on its ``[G, s, E, cap]`` dispatch and combine one-hots have no
tensor to attach to here: the index route never forms them.

Sharded over a real (data, model) or (pod, data, model) mesh
(``shardctx.spmd()``, the launcher's ``SpmdPlan``), "model" is expert
parallelism, "data" holds Z/d slots and "pod" b/p rows of each:
  * every model rank gathers its data rank's normed tokens along S and
    routes all of them with the whole router (the same result on each);
  * the groups are the global ones over the flat Z·b·S: a group that lies
    inside one of the rank's contiguous runs of rows (all of its rows, or
    on a pod mesh one slot's b/p rows) is routed as on one rank; a group
    that spans ranks is routed in pieces, each piece's queue places
    starting after the choices of the pieces before it in the flat order
    and its top-1 shares counted over the whole group
    (``SpmdPlan.route_exchange``, one all-gather of [n, E] counts over
    "pod" and one over "data");
  * each model rank dispatches only the choices of its block of E/m
    experts into a local buffer of ``E/m · n · cap + 1`` rows (its local
    queue places; the spare row takes dropped and other ranks' choices),
    runs them on its local expert weights (gathered over "data") and sums
    its choices in fp32: a partial sum over "model", with the shared
    expert's row-parallel partial, that the "residual" constraint
    reduce-scatters once. Experts that do not split over "model" run whole
    on every rank, and a whole output is sliced along S;
  * ``aux`` is the rank's share: its tokens' router mass against the
    group's top-1 shares, on model rank 0 only (0 elsewhere), so the shares
    add up to the reference's term over the mesh and it enters the
    gradient once;
  * a serve step's Z·b one-token rows are one group across the data and
    pod ranks (``pick_group_size``), whose capacity is lossless: its count
    exchange changes no choice, and runs all the same.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.models import shardctx
from repro_torch.models.common import he_init, swiglu
from repro_torch.models.shardctx import constrain, get_hint


def pick_group_size(num_tokens: int, lo: int = 128, hi: int = 4096) -> int:
    """Largest power-of-two group size in [lo, hi] dividing num_tokens."""
    g = 1
    t = num_tokens
    while t % 2 == 0 and g < hi:
        g *= 2
        t //= 2
    if g < lo:
        return num_tokens if num_tokens <= hi else g
    return min(g, hi)


def capacity(moe: MoEConfig, s: int) -> int:
    """Choices each expert takes per group of ``s`` tokens: lossless for
    tiny groups (decode steps), else ``capacity_factor · s · k / E``."""
    if s <= 64:
        return s * moe.top_k
    return max(int(moe.capacity_factor * s * moe.top_k / moe.num_experts), 1)


def init_moe_params(gen: torch.Generator, d_model: int, moe: MoEConfig,
                    dtype: torch.dtype) -> Dict:
    """The router (fp32), the routed experts' stacked SwiGLU weights and
    the shared expert (model dtype)."""
    E, ff = moe.num_experts, moe.d_ff_expert
    p = {
        "router": he_init(gen, (d_model, E), d_model, torch.float32),
        "w_gate": he_init(gen, (E, d_model, ff), d_model, dtype),
        "w_up": he_init(gen, (E, d_model, ff), d_model, dtype),
        "w_down": he_init(gen, (E, ff, d_model), ff, dtype),
    }
    if moe.num_shared_experts:
        ffs = moe.d_ff_shared * moe.num_shared_experts
        p["shared"] = {
            "gate": he_init(gen, (d_model, ffs), d_model, dtype),
            "up": he_init(gen, (d_model, ffs), d_model, dtype),
            "down": he_init(gen, (ffs, d_model), ffs, dtype),
        }
    return p


class Groups(NamedTuple):
    """A rank's part of the token groups in a sharded step: each piece of
    ``xt`` is a whole group of ``size`` tokens, or this rank's part of one
    that spans ranks; ``count`` groups over all ranks; ``exchange(counts,
    top1)`` ([n, E] int32 each) returns (the queue places the pieces
    before each piece took in its group, the group's top-1 counts):
    ``SpmdPlan.route_exchange``."""
    size: int
    count: int
    exchange: Callable


def route(xt: torch.Tensor, router: torch.Tensor, moe: MoEConfig, cap: int,
          groups: Optional[Groups] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """xt: [G, s, d] -> (gates [G,s,k] fp32 with dropped choices zeroed,
    expert_idx [G,s,k], pos [G,s,k] (each choice's place in its expert's
    queue), keep [G,s,k] bool, aux scalar fp32). With ``groups`` (a
    sharded step) xt holds this data rank's pieces of the groups, ``pos``
    the places among the piece's own choices, ``keep`` says whether the
    place in the whole group's queue is within ``cap``, and ``aux`` is this
    rank's share of the term (its tokens' router mass, the groups' top-1
    shares)."""
    E, k = moe.num_experts, moe.top_k
    probs = torch.softmax(xt.float() @ router, dim=-1)           # [G,s,E]
    gates, expert_idx = torch.topk(probs, k, dim=-1, sorted=True)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    ids = torch.arange(E, device=xt.device)
    top1 = expert_idx[..., :1] == ids                            # [G,s,E]
    if groups is None:
        # load balance: mean router mass times the top-1 share, per group
        me = probs.mean(dim=1)                                   # [G,E]
        ce = top1.float().mean(dim=1)                            # [G,E]
        aux = E * (me * ce).sum(-1).mean()

    # place in the expert's queue over the flattened (s, k) axis: earlier
    # tokens first, then lower k. The running counts run along the last
    # axis, [G, E, s·k] (a scan along a middle axis of [G, s·k, E] is
    # far slower on the card)
    G, s = expert_idx.shape[:2]
    flat = expert_idx.reshape(G, 1, s * k)
    sel = (flat == ids[:, None]).to(torch.int32)                 # [G,E,s·k]
    before = torch.cumsum(sel, dim=-1, dtype=torch.int32) - sel
    pos = before.gather(1, flat).reshape(G, s, k)
    if groups is None:
        keep = pos < cap
        return gates * keep, expert_idx, pos, keep, aux
    offset, top1 = groups.exchange(sel.sum(-1, dtype=torch.int32),
                                   top1.sum(1, dtype=torch.int32))
    keep = pos + offset.gather(1, flat[:, 0]).reshape(G, s, k) < cap
    me = probs.sum(dim=1) / groups.size                          # [G,E]
    ce = top1.float() / groups.size
    aux = E * (me * ce).sum() / groups.count
    return gates * keep, expert_idx, pos, keep, aux


def slots(expert_idx: torch.Tensor, pos: torch.Tensor, keep: torch.Tensor,
          num_experts: int, cap: int, first: int = 0) -> torch.Tensor:
    """Each choice's row of the flat expert buffer, ``[G·s·k]``: row
    ``(e·G + g)·cap + pos`` (the reference's ``egcd`` layout), or the
    spare last row ``E·G·cap`` for a dropped choice. Sharded, the buffer
    holds the ``num_experts`` experts from ``first`` on, and a choice of
    another expert takes the spare row too."""
    G = expert_idx.shape[0]
    g = torch.arange(G, device=pos.device)[:, None, None]
    e = expert_idx - first
    row = (e * G + g) * cap + pos
    mine = keep & (e >= 0) & (e < num_experts)
    return torch.where(mine, row, num_experts * G * cap).reshape(-1)


def dispatch(xt: torch.Tensor, slot: torch.Tensor, num_experts: int,
             cap: int) -> torch.Tensor:
    """xt: [G, s, d] -> the experts' inputs [E, G·cap, d]: every kept
    choice writes its token's row into its own slot (empty slots stay 0).
    The backward is a gather of the slots' gradients and a sum over k."""
    G, s, d = xt.shape
    k = slot.numel() // (G * s)
    n = num_experts * G * cap
    rows = xt[:, :, None].expand(G, s, k, d).reshape(-1, d)
    buf = xt.new_zeros((n + 1, d)).index_put((slot,), rows)
    return buf[:n].reshape(num_experts, G * cap, d)


def experts(expert_in: torch.Tensor, params: Dict) -> torch.Tensor:
    """The routed experts' SwiGLU over their slots: [E, G·cap, d] ->
    [E·G·cap, d]."""
    h = swiglu(torch.bmm(expert_in, params["w_gate"]),
               torch.bmm(expert_in, params["w_up"]))
    return torch.bmm(h, params["w_down"]).reshape(-1, expert_in.shape[-1])


class _GatherRows(torch.autograd.Function):
    """``src[idx]`` for an ``idx`` that reads every row of ``src`` at most
    once, its last (spare) row aside: the backward writes each gradient
    row back to its own source row with no accumulation (the spare row's
    gradient is never used). Autograd's own backward of an index
    accumulates, sorting the indices first, which took ~3 ms a layer at
    granite-moe's train step on an H100."""

    @staticmethod
    def forward(ctx, src, idx):
        ctx.save_for_backward(idx)
        ctx.rows = src.shape[0]
        return src[idx]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        out = grad.new_zeros((ctx.rows, grad.shape[-1]))
        return out.index_put_((idx,), grad), None


def combine(expert_out: torch.Tensor, slot: torch.Tensor,
            gates: torch.Tensor, dtype: torch.dtype,
            out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Each token's k expert outputs gathered back (a dropped choice reads
    the zero spare row) and summed over k in fp32, weighted by the gates
    cast to the activation dtype: -> [G, s, d] in ``out_dtype`` (default
    ``dtype``; a sharded step's partial sum stays fp32)."""
    G, s, k = gates.shape
    d = expert_out.shape[-1]
    spare = torch.cat([expert_out, expert_out.new_zeros((1, d))])
    picked = _GatherRows.apply(spare, slot).reshape(G, s, k, d)
    w = gates.to(dtype).float()[..., None]
    return (picked.float() * w).sum(dim=2).to(out_dtype or dtype)


def shared_expert(xt: torch.Tensor, sh: Dict) -> torch.Tensor:
    """The always-on shared expert's SwiGLU on every token."""
    return swiglu(xt @ sh["gate"], xt @ sh["up"]) @ sh["down"]


def moe_block(x: torch.Tensor, params: Dict, moe: MoEConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [Z, b, S, d] -> (out [Z, b, S, d], aux scalar fp32). Sharded
    (``shardctx.spmd()``), x is this rank's sequence block of its data
    rank's slots (its pod rank's rows of them), and out is the fp32 partial sum over "model" of the whole
    sequence (the "residual" constraint reduce-scatters it) or, where
    nothing splits over "model", this rank's block of the whole output;
    aux is this rank's share (the module docstring)."""
    sp = shardctx.spmd()
    if sp is not None:
        x = sp.columns(x)
    Z, b, S, d = x.shape
    T = Z * b * S
    E = moe.num_experts
    first, E_loc, groups = 0, E, None
    if sp is None:
        s = pick_group_size(T)
        G = T // s
    else:
        s = pick_group_size(T * sp.d * sp.p)
        G, piece = sp.moe_groups(T, s, E)
        groups = Groups(s, T * sp.d * sp.p // s, lambda counts, top1:
                        sp.route_exchange(counts, top1, piece, s))
        first, E_loc = sp.experts_local(E)
    cap = capacity(moe, s)
    opt = get_hint("opt_level", 0) >= 1
    xt = x.reshape(G, T // G, d)
    if opt:
        xt = constrain(xt, "dims:data+pod")
    gates, expert_idx, pos, keep, aux = (
        route(xt, params["router"], moe, cap) if groups is None
        else route(xt, params["router"], moe, cap, groups))
    slot = slots(expert_idx, pos, keep, E_loc, cap, first)
    weights = {n: constrain(params[n], f"weight:{n}")
               for n in ("w_gate", "w_up", "w_down")}
    expert_in = constrain(dispatch(xt, slot, E_loc, cap).reshape(
        E_loc, G, cap, d), "moe_expert")
    expert_out = constrain(
        experts(expert_in.reshape(E_loc, G * cap, d), weights).reshape(
            E_loc, G, cap, d), "moe_expert")
    out = combine(expert_out.reshape(-1, d), slot, gates, x.dtype,
                  None if sp is None else torch.float32)
    if opt:
        out = constrain(out, "dims:data+pod")
    shared = None
    if "shared" in params:
        sh = params["shared"]
        shared = shared_expert(xt, {
            n: constrain(sh[n], f"weight:shared/{n}")
            for n in ("gate", "up", "down")})
    if sp is None:
        if shared is not None:
            out = out + shared
        return out.reshape(Z, b, S, d), aux
    return _sharded_out(sp, out, shared, E_loc < E, x.shape, x.dtype), (
        aux if sp.model_rank == 0 else torch.zeros_like(aux))


def _sharded_out(sp, routed: torch.Tensor, shared: Optional[torch.Tensor],
                 experts_split: bool, shape, dtype: torch.dtype
                 ) -> torch.Tensor:
    """The sharded MoE output [Z/d, b, S, d] from the routed experts' fp32
    sum over this rank's choices and the shared expert's output: one fp32
    partial sum over "model" when either is split over it (a whole part
    counted on model rank 0 only), else the whole output in the model
    dtype, cut to this rank's sequence block."""
    shared_split = shared is not None and sp.split("shared/down") == "row"
    if not (experts_split or shared_split):
        out = routed.to(dtype)
        if shared is not None:
            out = out + shared
        out = out.reshape(shape)
        return sp.local(out, 2).contiguous() if sp.seq_sharded else out
    parts = [(routed, experts_split)]
    if shared is not None:
        parts.append((shared.float(), shared_split))
    out = sum(p if split or sp.model_rank == 0 else torch.zeros_like(p)
              for p, split in parts)
    return sp.partial(out.reshape(shape))
