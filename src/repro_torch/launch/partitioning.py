"""Sharding rules: Adapter Parallelism + tensor/sequence sharding (the port
of ``repro.launch.partitioning``).

The paper's AP (Fig. 8) on a named mesh:
  * adapter slots ``Z`` shard over "data" — adapters, their grads, and their
    optimizer state are RANK-LOCAL on that axis (zero adapter collectives);
  * frozen base weights shard 2-D: one dim over "data" (ZeRO-style,
    all-gathered forward-only) and one dim over "model" (tensor
    parallelism);
  * per-adapter batch ``b`` shards over "pod" (multi-pod DP);
  * residual-stream activations sequence-shard over "model" between blocks
    (Megatron-SP style) to bound remat live memory.

All rules are divisibility-aware with ordered fallbacks (e.g. hymba's 25
heads on a 16-way model axis fall back to sharding head_dim). The rules,
their candidate lists and the six spec-tree builders are the reference's,
verbatim; a spec is a ``PartitionSpec`` (a tuple of axis names, None or
tuples of names), the leaf paths are the reference's ``_leaf_path_str``
("layers/q_proj", "moe/w_gate", ...), and ``to_named`` turns a spec into
DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh dimension).

Execution: the step runs on local shards, with the collectives issued
where the reference places its constraints (``SpmdPlan``, through
``launch/collectives.py``). On a one-rank mesh the shards are whole
(``distribute`` wraps each tensor as a DTensor without a copy, ``local``
takes it back) and nothing moves: the activation policy resolves and
records each constraint's spec and returns the tensor unchanged. On a real
multi-rank ``(data, model)`` or ``(pod, data, model)`` mesh ``distribute``
slices each rank's shard out of the full tensor, and the policy's
``SpmdPlan`` runs the train, eval, prefill and serve steps of the dense,
MoE, ssm, hybrid, vlm and audio families (the SFT and DPO losses;
``check_sharded``; the eval step is the train step's forward, with no
backward):

  * "data" is Adapter Parallelism (paper Fig. 8): each data rank holds its
    Z/d slots' adapters, gradients, AdamW state, hyper-parameters, ranks
    and batch rows, and no adapter tensor crosses the axis; the frozen base
    weights are ZeRO-sharded over it and all-gathered forward-only (one
    gather a forward pass of a layer, the gathered weight kept for its
    backward; no backward reduce-scatter, the base is frozen);
  * "pod" is data parallelism over the per-adapter batch: each (data, pod)
    rank holds b/p of its slots' b rows (the batch, the prefix and, cut
    here, the per-slot positions; the cache's lanes), and the base
    weights, adapters, AdamW state and hyper-parameters are replicated
    over it. Three things cross it: the per-slot loss sums (nll and count,
    or DPO's log-probability sums), added over "pod" in one all-reduce
    before any nonlinearity (role "loss"; backward: identity, so each pod
    rank's gradient is its own rows' share); one all-reduce of the adapter
    gradients a train step (role "adapter_grad"), after which every pod
    rank takes the same AdamW update and holds the same adapters,
    bitwise; and the MoE route counts (below). A serve step of the other
    families sends nothing over it;
  * "model" is tensor and sequence parallelism: q/k/v and gate/up
    column-parallel, o/down row-parallel (their partial sums,
    the LoRA term's included, reduce-scattered along S by the "residual"
    constraint), the residual stream sequence-sharded between blocks and
    all-gathered once before each sublayer's column-parallel projections,
    the embedding and the logits vocabulary-parallel (or, where the
    vocabulary does not split, whole on every rank and the loss
    sequence-parallel); adapter gradients are all-reduced over "model"
    only. Attention whose heads or KV heads do not split over "model"
    runs whole on every model rank: q/k/v/o all-gathered over "model"
    too (forward only), q/k/v over the whole sequence, the output cut to
    this rank's sequence block before o_proj;
  * MoE: "model" is expert parallelism. The router is whole: every model
    rank routes all of its data rank's tokens (the normed residual
    gathered along S, as for a column-parallel projection) and runs the
    choices of its block of E/m experts; the shared expert is column- and
    row-parallel; their fp32 partial sum is reduce-scattered by the
    "residual" constraint (experts that do not split run whole on every
    rank). A token group that spans data ranks takes one all-gather of
    per-expert counts over "data" (role "route") for its queue places and
    its top-1 shares; the load-balance term enters the gradient once. On a
    pod mesh a rank's tokens are Z/d runs of (b/p)·S rows, one a slot, in
    the flat Z·b·S order, between the other pod ranks' runs: each piece
    takes its queue places from the pieces before it in its group, by
    global flat offset, and its counts cross "pod" and "data". Where
    neither a group nor a run divides the other, the pieces are gcd(run,
    group) rows, each inside one group (``SpmdPlan.moe_groups``);
  * ragged slot rows (``slot_rows``, a [Z] leaf laid out as the batch's
    slots) are cut to the data rank's slots; a projection over the whole
    sequence takes a slot's rows as they are, and one over this rank's
    sequence block (the o_proj of attention or RWKV's time mix that runs
    whole) the prefix of them that lies in the block
    (``SpmdPlan.block_rows``). Ragged rows on a pod mesh are refused: the
    reference's ``batch_specs`` cannot lay them out;
  * ssm (RWKV-6) and hybrid (Hymba's Mamba branch): "model" splits the
    scan heads. Each model rank runs the chunked scan on its H/m heads
    over the whole sequence; no scan state crosses ranks (training starts
    from zeros and drops the final state). RWKV gathers its normed input
    along S once, so the token shift reads the true previous token and
    the five mixes share the gather; r/k/v/g and ffn_k are
    column-parallel, o and ffn_v row-parallel, and each rank slices the
    decay, the bonus ``u`` and ``ln_x`` to its heads. Mamba's ``in_proj``
    is laid out in blocks (``BLOCKED``: rank r holds the x half's inner
    block r and the z half's, matching ``conv``'s split); ``bc_proj`` and
    ``dt_proj``, which contract over all of inner, are gathered over
    "model" (forward only) and each rank's rows of them multiply its
    inner block, the fp32 partial products summed in one all-reduce over
    "model" (``row_products``); ``out_proj`` is row-parallel. Hymba's
    branch outputs are reduce-scattered, each by its own "residual"
    constraint, before their branch norms. Scan heads that do not split
    over "model" (``whole_scan``: GSPMD splits a head; the port does not)
    run whole on every model rank, as attention's do: the branch's
    weights (RWKV's r/k/v/g/o, Mamba's in_proj, conv, bc_proj, dt_proj
    and out_proj) all-gathered over "model" (forward only), the
    projections, the conv and the scan over all heads and the whole
    sequence, the output cut to this rank's sequence block before o_proj
    / out_proj (``SpmdPlan.whole_out``); RWKV's channel mix keeps its
    split;
  * vlm (Qwen2-VL) and audio (MusicGen) take the dense layout. The stub
    encoder's prefix ``modal_embeds`` arrives as the rank's slots, and
    after the embedding's "residual" constraint each model rank writes the
    prefix rows that fall in its own sequence block (``SpmdPlan.prefix``;
    no collective). Per-slot positions (``[Z, b, S]``, M-RoPE's ``[3, Z, b,
    S]``) arrive whole, as the reference's batch spec keeps them, and each
    rank takes its own slots' (and its pod rank's rows of them) before the
    rotary angles (``SpmdPlan.slot_positions``);
  * DPO: the policy's two forwards and the frozen reference's two (the
    empty adapter tree, no gradient) each run the layout above on the data
    rank's slots; the per-slot log-probability sums are all-reduced over
    "model" by the loss head, and each rank's total covers its own slots;
  * prefill and serve (``serve_cache_specs``): every cache leaf is split by
    slots over "data" and by what this rank's heads write over "model":
    the K/V cache [L, Z, b, Sc, KV, hd] by KV heads, as ``cache_specs``
    lays it out, or, where the heads do not split (``whole_heads``), whole:
    every model rank computes and writes all the heads; RWKV's ``wkv`` and
    Mamba's ``ssm`` state by scan heads (``cache_specs``, the reference's
    layout, splits their key channel or N); Mamba's ``conv`` buffer by its
    inner block, the block of this rank's ``in_proj`` x half; where the
    scan heads do not split (``whole_scan``) ``wkv``, ``ssm`` and ``conv``
    whole, every model rank writing all of them; RWKV's token-shift rows
    ``tm_x`` / ``cm_x`` whole (the mixes read the gathered x). The step
    refuses a cache laid out any other way
    (``check_serve_cache``). A prefill writes this rank's heads of its
    slots for the whole sequence of the column-parallel projections'
    gathered input, and the scan starts from the cache's state. The
    positions (``pos``, a ring's ``k_pos``) and a serve step's ``active``
    lanes arrive whole on every rank and each rank reads its own slots'
    lanes (``SpmdPlan.slot_lanes``; on a pod mesh its pod rank's b/p of
    them, as every other leaf splits b over "pod") for its positions,
    write indices and write mask; the updated positions are computed
    whole. A serve
    step's residual (S 1) is not sequence-sharded: its partial sums are
    all-reduced, RWKV's mixes read the whole x, Mamba's ``bc_proj`` /
    ``dt_proj`` products are summed over "model" at the one token, and an
    MoE decode step's Z·b one-token rows form one lossless token group
    across the data ranks (its count exchange still runs, role "route").
    The last token's hidden state comes from the model rank whose
    sequence block holds it (``SpmdPlan.last_row``), and a
    vocabulary-parallel unembedding's logits are gathered over "model"
    (``SpmdPlan.whole_vocab``): every rank returns its (data, pod) rank's
    slots' lanes' logits over the whole vocabulary.

Every opt level runs this one schedule: the levels change only the recorded
``decisions`` and the hints, and the numbers stay equal. A mesh over a
``fake`` group (``mesh.fake_group``) moves no data: the activation policy
lets it through, records its decisions and moves nothing (the dry run,
``launch/dryrun.py``, resolves the policy on the production mesh through
it), and ``distribute`` refuses it.
"""
from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import axis_names, axis_sizes, is_fake

SHARDED_EXECUTION = ("sharded execution over a fake group is not possible: "
                     "its collectives move no data (launch/dryrun.py "
                     "traces shapes only)")
# what a multi-rank mesh runs: every step the reference's GSPMD steps run
# on these families, but ragged rows on a pod mesh
SHARDED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
# the step builders (``steps_dist.make_<name>_step``) whose steps run
# sharded, every family each
SHARDED_STEPS = ("train", "eval", "prefill", "serve")
# where each refusal is recorded
SHARDED_REFUSED = "recorded in ROADMAP.md §1, not queued"
POD_RAGGED = ("recorded in ROADMAP.md §3, 'Ragged slot rows on a pod mesh': "
              "a fault of the reference")
# the meshes' axes, in order, whose steps run sharded
SHARDED_AXES = (("data", "model"), ("pod", "data", "model"))


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: an axis name, a tuple of names (one
    dim over several axes jointly) or None (replicated), trailing Nones
    dropped — ``jax.sharding.PartitionSpec`` as a tuple."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_size(mesh, name: Optional[str]) -> int:
    if name is None:
        return 1
    return axis_sizes(mesh).get(name, 0)


def pick_spec(mesh, shape: Sequence[int],
              candidates: Sequence[Dict[int, str]]) -> P:
    """First candidate assignment {dim: axis} that divides evenly wins."""
    for cand in candidates:
        ok = True
        spec: List[Optional[str]] = [None] * len(shape)
        for dim, axis in cand.items():
            n = _axis_size(mesh, axis)
            if n == 0 or shape[dim] % n != 0:
                ok = False
                break
            spec[dim] = axis
        if ok:
            while spec and spec[-1] is None:
                spec.pop()
            return P(*spec)
    return P()


def has_pod(mesh) -> bool:
    return "pod" in axis_names(mesh)


def _real_multi_rank(mesh) -> bool:
    """A ``DeviceMesh`` of more than one rank whose group moves data (a
    ``fake`` group's does not)."""
    return (isinstance(mesh, DeviceMesh) and mesh.size() > 1
            and not is_fake(mesh))


# ---------------------------------------------------------------------------
# Activation constraints (installed via models.shardctx)
# ---------------------------------------------------------------------------

def activation_policy(mesh, *, seq_shard: bool = True,
                      opt_level: int = 0, step_kind: str = "train"):
    """Returns ``policy(x, kind)``: the reference's decision of the spec
    for ``x`` in role ``kind`` (``repro.launch.partitioning
    .activation_policy``: opt_level 0 = the paper-baseline GSPMD-guided
    lowering; opt_level >= 1 also honours "weight:<name>" and
    "dims:a,b,..." hints; decode steps run the baseline at every level).
    The decision is recorded in ``policy.decisions`` ({(kind, shape):
    spec}) and ``x`` is returned unchanged: on a one-rank mesh no tensor
    moves. ``policy.hints`` carries ``model_size``, ``opt_level`` and, at
    opt_level >= 2 in training, ``scan_chunk`` 32 and ``scan_opt``.

    On a real multi-rank mesh ``policy.spmd`` is the step's ``SpmdPlan``
    (None otherwise): "weight:<name>" then returns the weight all-gathered
    over "data", "residual" reduce-scatters (or, unsharded, all-reduces) a
    partial sum over "model", and every decision is recorded on the
    global shape of the tensor whose local shard passes."""
    if step_kind == "decode":
        opt_level = 0
    pod = "pod" if has_pod(mesh) else None

    def weight_spec(name: str, shape) -> P:
        for pat, cands in _PARAM_RULES:
            if any(re.search(pat, pre + name)
                   for pre in ("", "moe/", "mamba/")):
                cand = _resolve(cands[0], len(shape))
                spec: List[Optional[str]] = [None] * len(shape)
                for dim, axis in cand.items():
                    if axis == "data":
                        continue       # gathered over the adapter axis
                    n = _axis_size(mesh, axis)
                    if n and shape[dim] % n == 0:
                        spec[dim] = axis
                while spec and spec[-1] is None:
                    spec.pop()
                return P(*spec)
        return P()

    def decide(shape: Tuple[int, ...], kind: str) -> Optional[P]:
        """The spec the reference constrains ``kind`` to (None: it leaves
        the tensor unconstrained)."""
        ndim = len(shape)
        if kind.startswith("weight:"):
            if opt_level < 1:
                return None
            return weight_spec(kind.split(":", 1)[1], shape)
        if kind.startswith("dims:"):
            axes = kind.split(":", 1)[1].split(",")
            spec: List = [None] * ndim
            for dim, axis in enumerate(axes[:ndim]):
                if axis in ("-", ""):
                    continue
                # "a+b" = shard this dim over multiple mesh axes jointly
                names = tuple(a for a in axis.split("+")
                              if _axis_size(mesh, a))
                n = 1
                for a in names:
                    n *= _axis_size(mesh, a)
                if names and n and shape[dim] % n == 0:
                    spec[dim] = names if len(names) > 1 else names[0]
            while spec and spec[-1] is None:
                spec.pop()
            return P(*spec)
        if kind == "residual" and ndim == 4:            # [Z,b,S,d]
            cands = []
            if seq_shard:
                cands.append({0: "data", 1: pod, 2: "model"})
            cands += [{0: "data", 1: pod}, {0: "data"}]
        elif kind == "attn_qkv" and ndim == 5:          # [Z,b,S,H,hd]
            cands = [{0: "data", 1: pod, 3: "model"},
                     {0: "data", 1: pod, 4: "model"},
                     {0: "data", 1: pod}, {0: "data"}]
        elif kind == "ffn_hidden" and ndim == 4:        # [Z,b,S,ff]
            cands = [{0: "data", 1: pod, 3: "model"},
                     {0: "data", 1: pod}, {0: "data"}]
        elif kind == "logits":                          # [Z,b,c,V]
            cands = [{0: "data", 1: pod, ndim - 1: "model"},
                     {0: "data", ndim - 1: "model"}, {0: "data"}]
        elif kind == "moe_expert" and ndim == 4:        # [E,G,C,d]
            cands = [{0: "model", 1: "data"}, {0: "model"}, {1: "data"}]
        else:
            return None
        cands = [{d: a for d, a in c.items() if a is not None}
                 for c in cands]
        return pick_spec(mesh, shape, cands)

    def policy(x: torch.Tensor, kind: str) -> torch.Tensor:
        spmd = policy.spmd
        shape = tuple(x.shape)
        if spmd is not None:
            shape = spmd.global_shape(x, kind)
        key = (kind, shape)
        if key not in policy.decisions:
            policy.decisions[key] = decide(shape, kind)
        if spmd is None:
            return x
        if kind.startswith("weight:"):
            return spmd.weight(x, kind.split(":", 1)[1])
        if kind == "residual":
            return spmd.residual(x)
        return x

    policy.decisions = {}
    policy.spmd = (SpmdPlan(mesh, decide)
                   if _real_multi_rank(mesh) else None)
    policy.hints = {
        "model_size": axis_sizes(mesh).get("model", 1),
        "opt_level": opt_level,
    }
    if opt_level >= 2 and step_kind == "train":
        # scan-remat + small chunks fight the outer checkpoint's residual
        # stacking — a training-only pathology (regresses fwd-only prefill)
        policy.hints["scan_chunk"] = 32
        policy.hints["scan_opt"] = True
    return policy


# ---------------------------------------------------------------------------
# Parameter / state / batch pspecs
# ---------------------------------------------------------------------------

_PARAM_RULES: List[Tuple[str, List[Dict[int, str]]]] = [
    # path-regex, candidates over the leaf's dims (layer-stacked leaves have
    # a leading L dim; dims below are the WEIGHT dims counted from the END:
    # negative indices are resolved against the actual leaf rank).
    (r"embed$", [{-2: "model", -1: "data"}, {-2: "model"}, {-1: "data"}, {}]),
    (r"lm_head$", [{-2: "data", -1: "model"}, {-1: "model"}, {-2: "data"}, {}]),
    (r"(q_proj|k_proj|v_proj|g_proj|r_proj|in_proj)$",
     [{-2: "data", -1: "model"}, {-1: "model"}, {-2: "data"}, {}]),
    (r"(o_proj|out_proj|down_proj|ffn_v)$",
     [{-2: "model", -1: "data"}, {-2: "model"}, {-1: "data"}, {}]),
    (r"(gate_proj|up_proj|ffn_k)$",
     [{-2: "data", -1: "model"}, {-1: "model"}, {-2: "data"}, {}]),
    (r"moe/(w_gate|w_up)$",                   # [L, E, d, ff]
     [{-3: "model", -2: "data"}, {-3: "model"}, {}]),
    (r"moe/w_down$",                          # [L, E, ff, d]
     [{-3: "model", -2: "data"}, {-3: "model"}, {}]),
    (r"moe/shared/(gate|up)$", [{-2: "data", -1: "model"}, {-1: "model"}, {}]),
    (r"moe/shared/down$", [{-2: "model", -1: "data"}, {-2: "model"}, {}]),
    (r"moe/router$", [{}]),
    (r"mamba/(bc_proj|dt_proj)$", [{-2: "data", -1: "model"}, {-1: "model"}, {}]),
    (r"mamba/conv$", [{-1: "model"}, {}]),
    (r"(w1|w2)$", [{}]),
]


def _leaf_path_str(path: Tuple) -> str:
    """The reference's path string of a leaf: its keys joined by "/"."""
    return "/".join(str(p) for p in path)


def _resolve(cand: Dict[int, str], rank: int) -> Dict[int, str]:
    return {(d if d >= 0 else rank + d): a for d, a in cand.items()}


def _map_with_path(tree: Any, fn, path: Tuple = ()) -> Any:
    """``jax.tree_util.tree_map_with_path`` over nested dicts, lists,
    tuples and NamedTuples (sequence entries keyed by their index)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(v, fn, path + (i,))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_with_path(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _map(tree: Any, fn) -> Any:
    return _map_with_path(tree, lambda _, leaf: fn(leaf))


def base_param_specs(mesh, params: Any) -> Any:
    """PartitionSpec tree for the frozen backbone."""

    def spec_of(path, leaf) -> P:
        ps = _leaf_path_str(path)
        for pat, cands in _PARAM_RULES:
            if re.search(pat, ps):
                resolved = [_resolve(c, leaf.ndim) for c in cands]
                return pick_spec(mesh, leaf.shape, resolved)
        return P()   # norms, scalars, small vectors: replicated

    return _map_with_path(params, spec_of)


def lora_param_specs(mesh, lora: Any) -> Any:
    """LoRA leaves are [L, Z, din|r, r|dout]: Z -> "data" ONLY (rank-local
    AP). No other dim is sharded: adapters are small and must stay local."""

    def spec_of(leaf) -> P:
        if leaf.ndim >= 2:
            cand = [{1: "data"}, {}]
            return pick_spec(mesh, leaf.shape, cand)
        return P()

    return _map(lora, spec_of)


def opt_state_specs(mesh, opt_state: Any) -> Any:
    """Optimizer moments follow LoRA params; per-slot counters follow Z."""
    from repro_torch.optim.adamw import AdamWState
    mu = lora_param_specs(mesh, opt_state.mu)
    nu = lora_param_specs(mesh, opt_state.nu)
    count = pick_spec(mesh, opt_state.count.shape, [{0: "data"}, {}])
    return AdamWState(mu=mu, nu=nu, count=count)


def hp_specs(mesh, hp: Any) -> Any:
    """SlotHParams [Z] vectors shard over data with the slots."""
    return _map(hp, lambda v: pick_spec(mesh, v.shape, [{0: "data"}, {}]))


def batch_specs(mesh, batch: Dict) -> Dict:
    """tokens/labels [Z,b,S]; modal_embeds [Z,b,P,d]; positions [*,S]."""
    pod = "pod" if has_pod(mesh) else None

    def spec_of(path, leaf) -> P:
        ps = _leaf_path_str(path)
        if "positions" in ps:
            return P()
        cands = [{0: "data", 1: pod}, {0: "data"}, {}]
        cands = [{d: a for d, a in c.items() if a is not None}
                 for c in cands]
        return pick_spec(mesh, leaf.shape, cands)

    return _map_with_path(batch, spec_of)


def cache_specs(mesh, cache: Any) -> Any:
    """KV cache [L,Z,b,Sc,KV,hd]: Z->data, b->pod, KV|hd|Sc->model.
    Recurrent states [L,Z,b,...]: Z->data, b->pod."""
    pod = "pod" if has_pod(mesh) else None

    def spec_of(path, leaf) -> P:
        ps = _leaf_path_str(path)
        nd = leaf.ndim
        if ps.endswith("pos") or "k_pos" in ps:
            return P()
        cands: List[Dict[int, str]] = []
        if nd == 6:    # [L,Z,b,Sc,KV,hd]
            cands = [{1: "data", 2: pod, 4: "model"},
                     {1: "data", 2: pod, 5: "model"},
                     {1: "data", 2: pod, 3: "model"},
                     {1: "data", 2: pod}, {1: "data"}, {}]
        elif nd >= 3:  # recurrent states [L,Z,b,...]
            cands = [{1: "data", 2: pod, nd - 1: "model"},
                     {1: "data", 2: pod}, {1: "data"}, {}]
        else:
            cands = [{}]
        cands = [{d: a for d, a in c.items() if a is not None}
                 for c in cands]
        return pick_spec(mesh, leaf.shape, cands)

    return _map_with_path(cache, spec_of)


def serve_cache_specs(cfg, mesh, cache: Any) -> Any:
    """The cache layout the sharded prefill and serve steps take on a real
    ("data", "model") or ("pod", "data", "model") mesh: slots over "data"
    and lanes (b) over "pod" in every leaf but the positions, as
    ``cache_specs`` splits them, and over "model" what this rank's heads
    write. K/V [L, Z, b,
    Sc, KV, hd] split by KV heads, as ``cache_specs`` lays it out, or whole
    where the heads do not split (``whole_heads``: every model rank writes
    all of them); RWKV's ``wkv`` and Mamba's ``ssm`` [L, Z, b, H, ., hs]
    split by scan heads; ``conv`` [L, Z, b, W-1, inner] by inner (this
    rank's block of in_proj's x half, ``BLOCKED``); ``tm_x`` / ``cm_x`` [L,
    Z, b, d] whole (the mixes read the gathered x); ``pos`` and ``k_pos``
    whole. ``cache_specs`` (the reference's layout, which the dry run reads)
    differs where it splits the key channel, N, d or hd. The splits divide:
    ``whole_heads`` keeps whole the K/V heads that do not, and
    ``whole_scan`` the scan states and the conv buffer of scan heads that
    do not."""
    m_dim = {"k": 4, "v": 4, "wkv": 3, "ssm": 3, "conv": 4}
    m = axis_sizes(mesh).get("model", 1)
    whole = (("k", "v") if whole_heads(cfg, m) else ()) + (
        ("wkv", "ssm", "conv") if whole_scan(cfg, m) else ())
    lanes = {1: "data", 2: "pod"} if has_pod(mesh) else {1: "data"}

    def spec_of(path, leaf) -> P:
        name = path[-1]
        if name in ("pos", "k_pos"):
            return P()
        dims = dict(lanes)
        if name in m_dim and name not in whole:
            dims[m_dim[name]] = "model"
        return P(*(dims.get(d) for d in range(max(dims) + 1)))

    return _map_with_path(cache, spec_of)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements, and the one-rank execution
# ---------------------------------------------------------------------------

def placements(mesh, spec: P) -> Tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` for the tensor dim d that names its axis (several mesh
    dims may shard one tensor dim jointly), else ``Replicate()``."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            out[names.index(axis)] = Shard(d)
    return tuple(out)


def to_named(mesh, spec_tree: Any) -> Any:
    """A spec tree as a tree of placement tuples."""
    return _map(spec_tree, lambda s: placements(mesh, s)
                if isinstance(s, P) else s)


def distribute(mesh: DeviceMesh, tree: Any, named: Any) -> Any:
    """Each tensor of ``tree`` (the full, global tensor) as a DTensor on
    ``mesh`` with its placements from ``named`` (a ``to_named`` tree of the
    same structure). On a one-rank mesh a tensor is its own local shard: no
    copy is made. On a real multi-rank mesh each rank keeps a copy of its
    shard, sliced out by the placements (mesh dimensions in order, so a
    dim sharded over several axes is split data-major); a sharded dim must
    divide evenly. A mesh over a fake group is refused."""
    if is_fake(mesh):
        raise NotImplementedError(SHARDED_EXECUTION)

    def wrap(path, t):
        pl = _lookup(named, path)
        blocks = BLOCKED.get(_weight_name(path), 1)
        return DTensor.from_local(shard_of(mesh, t, pl, blocks), mesh, pl,
                                  run_check=False)

    return _map_with_path(tree, wrap)


# weights whose output columns are several halves side by side, each split
# over "model" on its own: {name: halves}. Mamba's in_proj [d, 2·inner]
# holds x and z; model rank r keeps x's inner block r and z's (the block
# its conv and scan heads take), so its local [d, 2·inner/m] splits into
# its own x and z as the whole one does. The DTensor's placements still
# say Shard(-1); only the local shards are used
BLOCKED = {"in_proj": 2}


def shard_of(mesh: DeviceMesh, t: torch.Tensor, pl: Tuple,
             blocks: int = 1) -> torch.Tensor:
    """This rank's shard of the full tensor ``t`` under placements ``pl``
    (``t`` itself when no dim is split); with ``blocks`` > 1 the last dim's
    split over "model" takes this rank's part of each of ``blocks`` equal
    halves (``BLOCKED``)."""
    out, names = t, axis_names(mesh)
    for i, p in enumerate(pl):
        n = mesh.size(i)
        if not isinstance(p, Shard) or n == 1:
            continue
        parts = (blocks if names[i] == "model" and p.dim == t.dim() - 1
                 else 1)
        if out.shape[p.dim] % (n * parts):
            raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                             f"split over {n} ranks")
        out = out.unflatten(p.dim, (parts, -1))
        k = out.shape[p.dim + 1] // n
        out = out.narrow(p.dim + 1, mesh.get_local_rank(i) * k, k).flatten(
            p.dim, p.dim + 1)
    return out if out is t else out.clone(
        memory_format=torch.contiguous_format)


def from_local(mesh: DeviceMesh, tree: Any, named: Any) -> Any:
    """Each local shard of ``tree`` as a DTensor with its placements from
    ``named``, without a copy (a step's outputs, which are local)."""
    return _map_with_path(tree, lambda path, t: DTensor.from_local(
        t, mesh, _lookup(named, path), run_check=False))


def _lookup(tree: Any, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def local(tree: Any) -> Any:
    """``tree`` with each DTensor replaced by its local shard (the step's
    kernels take plain tensors)."""
    return _map(tree, lambda t: t.to_local() if isinstance(t, DTensor)
                else t)


# ---------------------------------------------------------------------------
# Sharded execution on a real multi-rank mesh
# ---------------------------------------------------------------------------

def _model_dim(spec: P, ndim: int) -> Optional[int]:
    """The (negative) dim of a spec that names "model", else None."""
    for d, e in enumerate(spec):
        if e is not None and "model" in (e if isinstance(e, tuple) else (e,)):
            return d - ndim
    return None


def whole_heads(cfg, m: int) -> bool:
    """Whether attention runs whole on every rank of a model axis of ``m``
    ranks: its heads or KV heads do not split over it (GSPMD splits a
    head; the port does not)."""
    return (cfg.family != "ssm" and m > 1
            and bool(cfg.num_heads % m or cfg.num_kv_heads % m))


def whole_scan(cfg, m: int) -> bool:
    """Whether the scan branch (RWKV's time mix, Hymba's Mamba branch) runs
    whole on every rank of a model axis of ``m`` ranks: its scan heads
    (RWKV's ``num_heads``, Mamba's inner // head_size) do not split over it
    (GSPMD splits a head; the port does not)."""
    if cfg.family == "ssm":
        heads = cfg.num_heads
    elif cfg.family == "hybrid":
        heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_size
    else:
        return False
    return m > 1 and bool(heads % m)


def check_sharded(cfg, mesh, step: str = "train") -> None:
    """Raise ``NotImplementedError`` unless the ``step`` builder's step
    (``SHARDED_STEPS``) runs ``cfg`` on the real multi-rank ``mesh``: the
    dense, MoE, ssm, hybrid, vlm or audio family (vlm and audio as dense)
    with either loss (SFT or DPO), a ("data", "model") mesh or a ("pod",
    "data", "model") one (``MULTI_POD``'s order; "pod" splits the
    per-adapter batch), and, over a model axis of m > 1 ranks, the
    Megatron layout (q/k/v, gate/up, RWKV's
    r/k/v/g and ffn_k, Mamba's in_proj and conv split by output columns;
    o, down, ffn_v and out_proj by input rows). Attention whose heads do
    not split runs whole (``whole_heads``), and so does a scan branch whose
    heads do not (``whole_scan``: RWKV's r/k/v/g/o, Mamba's in_proj, conv
    and out_proj): their weights may take either layout. RWKV's channel
    mix keeps its split. The embedding and an
    untied unembedding are split by vocabulary or, where the rule falls
    back, whole. MoE: the router whole, the routed experts split by expert
    or whole, the shared expert's gate/up by columns and its down by rows,
    or all three whole. The prefill and serve steps take every family, the
    cache laid out by ``serve_cache_specs``. Ragged slot rows on a pod mesh
    are refused per call (``SpmdPlan.bind``)."""
    if step not in SHARDED_STEPS:
        raise ValueError(f"unknown step {step!r}")
    names = tuple(axis_names(mesh))
    if names not in SHARDED_AXES:
        raise NotImplementedError(
            f"sharded execution over axes {names}: only "
            + " and ".join(f"({', '.join(a)})" for a in SHARDED_AXES)
            + f" run ({SHARDED_REFUSED})")
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"sharded execution of the {cfg.family} family ({cfg.name}) is "
            f"not ported ({SHARDED_REFUSED})")
    m = axis_sizes(mesh)["model"]
    if m == 1:
        return
    d, L, ff = cfg.d_model, cfg.num_layers, cfg.d_ff
    layers: Dict[str, Any] = {}
    # each leaf's allowed dims over "model" (None: whole)
    want: Dict[str, Tuple] = {"embed": (-2, None)}
    col, row = ((-1, None), (-2, None)) if whole_scan(cfg, m) else \
        ((-1,), (-2,))                          # the scan branch's
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import DECAY_LORA_DIM as R
        for n in ("r_proj", "k_proj", "v_proj", "g_proj"):
            layers[n], want[n] = (L, d, d), col
        layers.update(o_proj=(L, d, d), ffn_k=(L, d, ff), ffn_v=(L, ff, d),
                      w1=(L, d, R), w2=(L, R, d))
        want.update(o_proj=row, ffn_k=(-1,), ffn_v=(-2,), w1=(None,),
                    w2=(None,))
    else:
        a_col, a_row = ((-1, None), (-2, None)) if whole_heads(cfg, m) else \
            ((-1,), (-2,))
        layers.update(q_proj=(L, d, cfg.q_dim), k_proj=(L, d, cfg.kv_dim),
                      v_proj=(L, d, cfg.kv_dim), o_proj=(L, cfg.q_dim, d))
        want.update(q_proj=a_col, k_proj=a_col, v_proj=a_col, o_proj=a_row)
    if cfg.is_moe:
        E, ffe = cfg.moe.num_experts, cfg.moe.d_ff_expert
        moe = {"router": (L, d, E), "w_gate": (L, E, d, ffe),
               "w_up": (L, E, d, ffe), "w_down": (L, E, ffe, d)}
        want.update(router=(None,), w_gate=(-3, None), w_up=(-3, None),
                    w_down=(-3, None))
        if cfg.moe.num_shared_experts:
            ffs = cfg.moe.d_ff_shared * cfg.moe.num_shared_experts
            moe["shared"] = {"gate": (L, d, ffs), "up": (L, d, ffs),
                             "down": (L, ffs, d)}
            want.update({"shared/gate": (-1, None), "shared/up": (-1, None),
                         "shared/down": (-2, None)})
        layers["moe"] = moe
    elif cfg.family != "ssm":
        layers.update(gate_proj=(L, d, ff), up_proj=(L, d, ff),
                      down_proj=(L, ff, d))
        want.update(gate_proj=(-1,), up_proj=(-1,), down_proj=(-2,))
    if cfg.family == "hybrid":
        inner, N = cfg.ssm.expand * d, cfg.ssm.state_size
        H = inner // cfg.ssm.head_size
        layers["mamba"] = {
            "in_proj": (L, d, 2 * inner), "conv": (L, cfg.ssm.conv_width,
                                                   inner),
            "bc_proj": (L, inner, 2 * N), "dt_proj": (L, inner, H),
            "out_proj": (L, inner, d)}
        want.update(in_proj=col, conv=col, bc_proj=(-1, None),
                    dt_proj=(-1, None), out_proj=row)

    def meta(node):
        if isinstance(node, dict):
            return {k: meta(v) for k, v in node.items()}
        return torch.empty(node, device="meta")

    tree = {"embed": meta((cfg.vocab_size, d)), "layers": meta(layers)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = meta((d, cfg.vocab_size))
        want["lm_head"] = (-1, None)
    specs = base_param_specs(mesh, tree)
    flat: Dict[str, Tuple[P, int]] = {}       # name -> (spec, ndim)
    _map_with_path(tree, lambda path, leaf: flat.__setitem__(
        _weight_name(path), (_lookup(specs, path), leaf.ndim)))
    for name, dims in want.items():
        spec, ndim = flat[name]
        if _model_dim(spec, ndim) not in dims:
            raise NotImplementedError(
                f"{cfg.name}: {name} takes spec {spec} on mesh "
                f"{axis_sizes(mesh)}; the sharded step needs it "
                + " or ".join("whole over model" if d_ is None else
                              f"split over model along dim {d_}"
                              for d_ in dims))


def check_serve_cache(cfg, mesh, cache: Dict) -> None:
    """Raise ``ValueError`` unless every leaf of ``cache`` is a DTensor laid
    out as ``serve_cache_specs`` says: the sharded prefill and serve steps
    read a rank's local shard as its slots' lanes and its heads' rows, and
    a cache cut any other way would be read wrongly."""
    want = to_named(mesh, serve_cache_specs(cfg, mesh, cache))

    def visit(path, leaf):
        name = _leaf_path_str(path)
        if not isinstance(leaf, DTensor):
            raise ValueError(
                f"the sharded step takes the cache as DTensors laid out by "
                f"serve_cache_specs; {name} is a {type(leaf).__name__}")
        if tuple(leaf.placements) != _lookup(want, path):
            raise ValueError(
                f"cache leaf {name} {tuple(leaf.shape)} is laid out as "
                f"{leaf.placements}; the sharded {cfg.family} prefill and "
                f"serve steps take {_lookup(want, path)} "
                f"(serve_cache_specs)")

    _map_with_path(cache, visit)


def _weight_name(path: Tuple) -> str:
    """A parameter's name as the model's "weight:<name>" hints give it:
    its path without the "layers", "moe" and "mamba" levels ("q_proj",
    "w_gate", "shared/gate", "in_proj", "embed"), as the reference's
    ``weight_spec`` tries those prefixes."""
    return "/".join(str(p) for p in path
                    if p not in ("layers", "moe", "mamba"))


class SpmdPlan:
    """The collectives of the sharded train, eval, prefill and serve steps
    on a real ("data", "model") or ("pod", "data", "model") mesh, issued on
    local shards through
    ``launch/collectives.py`` (the module docstring has the layout).
    ``bind`` reads each base
    weight's placements off the DTensor parameters and the global shape of
    the call's tokens; the model reaches the plan through
    ``models.shardctx.spmd()``; ``log`` collects the ``collectives.Record``
    of every collective the step's calls issue."""

    def __init__(self, mesh: DeviceMesh, decide):
        sizes = axis_sizes(mesh)
        self.mesh = mesh
        self.d, self.m = sizes.get("data", 1), sizes.get("model", 1)
        self.p = sizes.get("pod", 1)      # a mesh without "pod": p = 1
        self.model_rank, self.data_rank, self.pod_rank = (
            mesh.get_local_rank(a) if a in sizes else 0
            for a in ("model", "data", "pod"))
        self.decide = decide           # the policy's: (shape, kind) -> spec
        self.layouts: Optional[Dict[str, Dict[str, Optional[int]]]] = None
        self.seq_len = self.z = self.z_local = self.d_model = 0
        self.b = self.b_local = 0         # rows a slot: global, this rank's
        self.seq_sharded = False
        # attention, and the scan branch, run whole on every model rank
        # (``whole_heads``, ``whole_scan``); set by ``steps_dist``'s step
        # builders
        self.attn_whole = self.scan_whole = False
        self._cols: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        # the MoE layer's groups: (experts E, groups G, tokens a group s)
        self._moe: Optional[Tuple[int, int, int]] = None
        self.log: List[C.Record] = []     # every collective of every call

    # -- per call ----------------------------------------------------------

    def bind(self, params: Dict, tokens: torch.Tensor,
             batch: Optional[Dict] = None) -> None:
        """Bind one call: the weights' placements (read once) and the
        shapes of ``tokens``, the call's [Z, b, S] tokens (a DPO batch's
        chosen ones) or a serve step's [Z, b] (S 1: the residual is not
        sequence-sharded), a DTensor (its global shape) or this rank's
        block (its data rank's slots, its pod rank's rows of them);
        ``batch``, where the step takes one, may not carry ragged slot rows
        on a pod axis."""
        if self.layouts is None:
            self.layouts = _weight_layouts(self.mesh, params)
        emb = params["embed"]
        if not isinstance(emb, DTensor):
            raise ValueError("the sharded step takes the parameters as "
                             "DTensors (partitioning.distribute)")
        self.d_model = emb.shape[1]
        shape = tuple(tokens.shape)
        self.z, self.b = shape[:2]
        self.seq_len = shape[2] if len(shape) > 2 else 1
        if isinstance(tokens, DTensor):
            self.z_local, self.b_local = tokens.to_local().shape[:2]
        else:
            self.z_local, self.b_local = self.z, self.b
            self.z, self.b = self.z * self.d, self.b * self.p
        if self.z != self.z_local * self.d:
            raise NotImplementedError(
                f"Z = {self.z} slots do not split over data {self.d}")
        if self.b != self.b_local * self.p:
            raise NotImplementedError(
                f"b = {self.b} rows a slot do not split over pod {self.p}")
        if (batch is not None and batch.get("slot_rows") is not None
                and self.p > 1):
            raise NotImplementedError(
                "ragged slot rows on a pod axis: the reference's "
                "batch_specs cannot lay out the [Z] slot_rows leaf with a "
                "pod axis (its {0: data, 1: pod} candidate indexes a dim "
                f"the leaf lacks; {POD_RAGGED})")
        spec = self.decide((self.z, self.b, self.seq_len, self.d_model),
                           "residual")
        self.seq_sharded = self.m > 1 and len(spec) > 2 and \
            spec[2] == "model"

    def end(self) -> None:
        self._cols = self._moe = None

    def slot_vectors(self, batch: Dict) -> Dict:
        """``batch`` (local shards) with its ragged ``slot_rows`` ([Z]) cut
        to this data rank's Z/d slots where they arrive whole (laid out as
        ``batch_specs`` lays out a [Z] leaf, {0: "data"}, they arrive
        cut)."""
        rows = batch.get("slot_rows")
        if rows is None or rows.shape[0] != self.z or self.z == self.z_local:
            return batch
        return dict(batch, slot_rows=rows.narrow(
            0, self.data_rank * self.z_local, self.z_local))

    def block_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """Ragged slot rows ([Z/d]: slot z's valid rows R in its flat b·S
        order) counted in the flat [b, S/m] order of this model rank's
        sequence block, where the valid rows are still a prefix: q·(S/m) +
        clamp(R - q·S - r·S/m, 0, S/m) of them, q = R // S, r the model
        rank."""
        S = self.seq_len
        n = S // self.m
        q = torch.div(rows, S, rounding_mode="floor")
        tail = (rows - q * S - self.model_rank * n).clamp(0, n)
        return (q * n + tail).to(rows.dtype)

    def global_shape(self, x: torch.Tensor, kind: str) -> Tuple[int, ...]:
        """The global shape of the tensor whose local shard ``x`` passes a
        ``kind`` constraint (the shape the reference decides on)."""
        shape = list(x.shape)
        if kind.startswith("weight:"):
            lay = self._layout(kind.split(":", 1)[1])
            for axis, n in (("data", self.d), ("model", self.m)):
                if lay[axis] is not None:
                    shape[lay[axis]] *= n
            return tuple(shape)
        if self._moe is not None and (
                kind == "moe_expert" or kind.startswith("dims:")
                and len(shape) == 3):
            E, G, s = self._moe             # [E, G, cap, d] or [G, s, d]
            if kind == "moe_expert":
                shape[:2] = [E, G]
            else:
                shape[:2] = [G, s]
            return tuple(shape)
        if self.z and shape and shape[0] == self.z_local:
            shape[0] = self.z
            if self.p > 1 and len(shape) >= 3:
                shape[1] *= self.p          # [Z, b/p, ...]: rows over pod
        if self.m > 1:
            if kind == "residual" and len(shape) == 4 and \
                    shape[2] != self.seq_len:
                shape[2] *= self.m
            elif (kind == "ffn_hidden" and len(shape) >= 4
                  or not self.attn_whole and (
                      kind == "attn_qkv" and len(shape) >= 4
                      or kind.startswith("dims:") and len(shape) == 5)):
                shape[3] *= self.m          # [Z, b, S, H/m | ff/m, ...]
            elif kind == "logits" and self.split("lm_head") is not None:
                shape[-1] *= self.m
        return tuple(shape)

    # -- weights -----------------------------------------------------------

    def _layout(self, name: str) -> Dict[str, Optional[int]]:
        """{"data": dim, "model": dim} of weight ``name`` (its
        "weight:<name>" hint)."""
        lay = self.layouts.get(name)
        if lay is None and name == "lm_head":      # tied: embed transposed
            e = self.layouts["embed"]
            lay = {a: (None if v is None else -3 - v) for a, v in e.items()}
        if lay is None:
            return {"data": None, "model": None}
        return lay

    def weight(self, W: torch.Tensor, name: str) -> torch.Tensor:
        """The frozen weight ``name`` all-gathered over "data" (forward
        only: it takes no gradient); still split over "model"."""
        dim = self._layout(name)["data"]
        if dim is None or self.d == 1:
            return W
        return C.all_gather(W.detach(), self.mesh, "data", dim,
                            "base_weight", self.log)

    def gather_model(self, W: torch.Tensor, name: str) -> torch.Tensor:
        """The frozen weight ``name`` (gathered over "data") all-gathered
        over "model" too, where it splits there: whole on every rank
        (forward only, role "base_weight"). A ``BLOCKED`` weight's blocks
        are put back in their global order."""
        dim = self._layout(name)["model"]
        if dim is None or self.m == 1:
            return W
        out = C.all_gather(W.detach(), self.mesh, "model", dim,
                           "base_weight", self.log)
        parts = BLOCKED.get(name, 1)
        if parts > 1:            # [.., m, parts, n] -> [.., parts, m, n]
            out = out.unflatten(-1, (self.m, parts, -1)).transpose(
                -3, -2).flatten(-3)
        return out

    def split(self, name: str) -> Optional[str]:
        """"col" or "row": how weight ``name`` is split over "model"
        (None: whole on every rank)."""
        if self.m == 1:
            return None
        return {-1: "col", -2: "row"}.get(self._layout(name)["model"])

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's block of the whole tensor ``t`` along ``dim``
        (a differentiable slice)."""
        k = t.shape[dim] // self.m
        return t.narrow(dim, self.model_rank * k, k)

    def local_out(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This model rank's output columns of the column-parallel weight
        ``name`` in the last dim of ``t`` (the whole LoRA B), laid out as
        the weight's local shard (``BLOCKED``), contiguous."""
        parts = BLOCKED.get(name, 1)
        if parts == 1:
            return self.local(t, -1).contiguous()
        return self.local(t.unflatten(-1, (parts, -1)), -1).flatten(
            -2).contiguous()

    # -- MoE ---------------------------------------------------------------

    def experts_local(self, num_experts: int) -> Tuple[int, int]:
        """(first, count) of this model rank's block of the routed experts:
        E/m of them where the expert weights split over "model", else all
        E."""
        if self._layout("w_gate")["model"] is None:
            return 0, num_experts
        k = num_experts // self.m
        return self.model_rank * k, k

    def moe_groups(self, tokens: int, group: int, num_experts: int
                   ) -> Tuple[int, int]:
        """This rank's ``tokens`` rows against the token groups of
        ``group`` rows of the flat Z·b·S: (pieces, rows a piece). The rows
        lie in runs that are contiguous in the flat order: one run of all
        of them on a mesh without "pod" (the Z/d slots from ``data_rank ·
        tokens`` on), else Z/d runs of (b/p)·S, one a slot, each between
        the other pod ranks' runs. The pieces are gcd(run, group) rows:
        whole groups where they lie inside a run, a run where it lies
        inside a group, else smaller; every run starts at a multiple of
        the run and every group at a multiple of the group, so each piece
        lies inside one group, which may hold several pieces of this rank
        and of others (``route_exchange``)."""
        run = tokens if self.p == 1 else tokens // self.z_local
        piece = math.gcd(run, group)
        self._moe = (num_experts, tokens * self.d * self.p // group, group)
        return tokens // piece, piece

    def _offsets(self, tokens: int, piece: int, data_rank, pod_rank
                 ) -> torch.Tensor:
        """[n] flat Z·b·S offsets of the pieces of ``piece`` rows of the
        rank at (``data_rank``, ``pod_rank``), each holding ``tokens``
        rows: local row i of its slot zl lies at ((data_rank · Z/d + zl) ·
        p + pod_rank) · (b/p)·S + i."""
        per_slot = tokens // self.z_local
        rows = torch.arange(0, tokens, piece)
        zl, i = rows // per_slot, rows % per_slot
        return ((data_rank * self.z_local + zl) * self.p + pod_rank
                ) * per_slot + i

    def route_exchange(self, counts: torch.Tensor, top1: torch.Tensor,
                       piece: int, group: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``counts``, ``top1``: [n, E] int32 per-expert counts of this
        rank's choices (kept or not) and of its tokens' top-1 experts in
        each of its n pieces. Returns (offset: the choices of the pieces
        before each piece in the flat order within its group, each
        expert's queue places taken before this piece's; the group's top-1
        counts over every piece in it). Groups inside a run need no
        exchange; a spanning group takes one all-gather of both counts over
        "pod" and one over "data" (no gradient)."""
        if piece == group or self.d * self.p == 1:
            return torch.zeros_like(counts), top1
        every = torch.stack([counts, top1])[None]             # [1,2,n,E]
        for axis, n in (("pod", self.p), ("data", self.d)):
            if n > 1:
                every = C.all_gather(every, self.mesh, axis, 0, "route",
                                     self.log)
        # every[r], r = data_rank · p + pod_rank: [2, n, E]
        tokens = counts.shape[0] * piece
        at = torch.stack([self._offsets(tokens, piece, r // self.p,
                                        r % self.p)
                          for r in range(self.d * self.p)]).to(
                              counts.device)                   # [R, n]
        mine = at[self.data_rank * self.p + self.pod_rank]     # [n]
        mates = at // group == (mine // group)[:, None, None]  # [n, R, n]
        before = mates & (at < mine[:, None, None])
        flat = every.movedim(0, 1).flatten(1, 2)[:, None]      # [2,1,R·n,E]

        def total(mask, c):
            return (mask.flatten(1)[..., None] * c).sum(1).to(counts.dtype)

        return total(before, flat[0]), total(mates, flat[1])

    # -- activations -------------------------------------------------------

    def columns(self, x: torch.Tensor) -> torch.Tensor:
        """The input of a column-parallel projection: the normed residual
        all-gathered along S over "model" (or, unsharded, passed with its
        gradient all-reduced), once for all the projections that read the
        same ``x``."""
        if self.m == 1 or getattr(x, "_spmd_whole", False):
            return x
        if self._cols is not None and self._cols[0] is x:
            return self._cols[1]
        y = (C.gather(x, self.mesh, "model", 2, "activation", self.log)
             if self.seq_sharded else
             C.broadcast_grad(x, self.mesh, "model", "activation",
                              self.log))
        self._cols = (x, y)
        return y

    @staticmethod
    def partial(y: torch.Tensor) -> torch.Tensor:
        """Mark ``y`` as this rank's partial sum over "model"."""
        y._spmd_partial = True
        return y

    @staticmethod
    def gathered(y: torch.Tensor) -> torch.Tensor:
        """Mark ``y`` as an input of column-parallel projections that is
        already whole (made from a ``columns`` result): ``columns`` passes
        it as it is."""
        y._spmd_whole = True
        return y

    def seq_block(self, t: torch.Tensor) -> torch.Tensor:
        """This model rank's sequence block of the whole-sequence output
        ``t`` ([Z, b, S, ...]) of a sublayer that runs whole, contiguous
        and marked so that a LoRA projection on it takes its slots' ragged
        rows in the block (``block_rows``)."""
        out = self.local(t, 2).contiguous()
        out._spmd_block = True
        return out

    def whole_out(self, y: torch.Tensor) -> torch.Tensor:
        """The output of a sublayer that every model rank runs whole, on
        its own sequence block: as it is where the residual is
        sequence-sharded; else every rank computed all of it, and it
        counts once: model rank 0's, a partial sum for the "residual"
        constraint."""
        if self.m == 1 or self.seq_sharded:
            return y
        return self.partial(y if self.model_rank == 0 else y * 0)

    def row_products(self, x: torch.Tensor, weights: Dict[str, torch.Tensor]
                     ) -> List[torch.Tensor]:
        """``x @ W`` in fp32 for each frozen weight W ([inner, n], gathered
        over "data") of ``weights`` ({name: W}), where x's last dim is this
        model rank's block of inner: each W gathered over "model" (forward
        only), this rank's rows of it taken, and the partial products
        summed over "model" in one fp32 all-reduce. Each rank uses the sum
        for its own heads only, so its gradient is all-reduced back."""
        parts = [x.float() @ self.local(self.gather_model(W, n), -2).float()
                 for n, W in weights.items()]
        y = torch.cat(parts, dim=-1)
        if self.m > 1:
            y = C.broadcast_grad(
                C.reduce(y, self.mesh, "model", "activation", self.log),
                self.mesh, "model", "activation", self.log)
        return list(y.split([t.shape[-1] for t in parts], dim=-1))

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        """The "residual" constraint: a partial sum is reduce-scattered
        along S (sequence-sharded) or all-reduced; a residual already in
        place passes."""
        if self.m == 1:
            return x
        partial = getattr(x, "_spmd_partial", False)
        if self.seq_sharded:
            if partial:
                return C.scatter(x, self.mesh, "model", 2, "activation",
                                 self.log)
            if x.shape[2] == self.seq_len:
                raise RuntimeError("a whole-sequence residual that is not a "
                                   "partial sum reached the constraint")
            return x
        return (C.reduce(x, self.mesh, "model", "activation", self.log)
                if partial else x)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The vocabulary-parallel lookup: each model rank reads the rows of
        its vocabulary block (zeros elsewhere), a partial sum for the
        "residual" constraint."""
        W = self.weight(table, "embed")
        tok = tokens.long()
        if self.split("embed") is None:
            x = W[tok]
            if self.seq_sharded:
                x = self.local(x, 2).contiguous()
            return x
        n = W.shape[0]
        loc = tok - self.model_rank * n
        ok = (loc >= 0) & (loc < n)
        x = W[loc.clamp(0, n - 1)]
        x = torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
        return self.partial(x)

    def prefix(self, x: torch.Tensor, modal: torch.Tensor) -> torch.Tensor:
        """The embedded residual ``x`` (after its "residual" constraint:
        this model rank's sequence block where the residual is
        sequence-sharded, else the whole sequence) with the rows of the
        prefix ``modal`` ([Z/d, b/p, P, d], this rank's slots) that fall
        at its positions in place of the token embeddings there: the global
        positions [r·S/m, (r+1)·S/m) ∩ [0, P) on model rank r. On a pod
        mesh ``modal`` arrives as this rank's rows of its slots too, cut as
        the batch spec cuts it ({0: data, 1: pod})."""
        P, n_rows = modal.shape[2], x.shape[2]
        lo = self.model_rank * n_rows if self.seq_sharded else 0
        n = min(max(P - lo, 0), n_rows)
        if n == 0:
            return x
        return torch.cat([modal[:, :, lo:lo + n].to(x.dtype), x[:, :, n:]],
                         dim=2)

    def slot_positions(self, positions: torch.Tensor, mrope: bool
                       ) -> torch.Tensor:
        """This rank's block of per-slot ``positions`` ([Z, b, S], or [3, Z,
        b, S] under M-RoPE: whole on every rank, as the batch spec keeps
        them): its data rank's slots and its pod rank's rows of them, cut
        as ``shard_of`` cuts the batch; [S] and [3, S] positions pass as
        they are."""
        dim = 1 if mrope else 0
        if positions.dim() != dim + 3:
            return positions
        if positions.shape[dim:dim + 2] != (self.z, self.b):
            raise ValueError(f"positions {tuple(positions.shape)} for "
                             f"{self.z} slots of {self.b} rows")
        return self._block(positions, dim)

    def slot_lanes(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's lanes of a per-lane tensor ([Z, b, ...]: a cache's
        ``pos`` or ring ``k_pos``, a serve step's ``active``), which
        arrives whole on every rank, as ``cache_specs`` keeps the
        positions: its data rank's slots and its pod rank's lanes of them,
        cut as ``shard_of`` cuts the cache, so each rank writes and reads
        its own lanes at their own indices."""
        if t.shape[:2] != (self.z, self.b):
            raise ValueError(f"per-lane {tuple(t.shape)} for {self.z} "
                             f"slots of {self.b} lanes")
        return self._block(t, 0)

    def _block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The (data, pod) block of ``t``'s slots (``dim``) and rows
        (``dim`` + 1)."""
        t = t.narrow(dim, self.data_rank * self.z_local, self.z_local)
        return t.narrow(dim + 1, self.pod_rank * self.b_local, self.b_local)

    def last_row(self, h: torch.Tensor) -> torch.Tensor:
        """The hidden state of the last token ([Z/d, b, d]) of ``h`` ([Z/d,
        b, S or S/m, d]) on every model rank: where the residual is
        sequence-sharded it lies in model rank m-1's block, and every rank
        gathers the blocks' last rows over "model" (forward only) and takes
        that one."""
        if self.m == 1 or not self.seq_sharded:
            return h[:, :, -1]
        rows = C.all_gather(h[:, :, -1:].contiguous(), self.mesh, "model", 2,
                            "activation", self.log)
        return rows[:, :, -1]

    def whole_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Logits of a vocabulary-parallel unembedding ([..., V/m])
        gathered over "model" to the whole vocabulary on every model rank
        (forward only); where the unembedding is whole, as they are."""
        if self.split("lm_head") is None:
            return logits
        return C.all_gather(logits.contiguous(), self.mesh, "model", -1,
                            "activation", self.log)

    def loss_rows(self, hidden: torch.Tensor, labels: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loss head's (hidden, labels): with the vocabulary split over
        "model", the hidden states gathered along S; with it whole, this
        rank's sequence block of both (the loss sums then add over
        "model", ``loss_sums``)."""
        if self.split("lm_head") is not None:
            return self.columns(hidden), labels
        if self.seq_sharded:
            labels = self.local(labels, 2)
        return hidden, labels

    def loss_sums(self, *sums: torch.Tensor) -> List[torch.Tensor]:
        """Per-slot sums over this rank's rows: added over "model" where
        each rank took its own sequence block (whole-vocabulary loss,
        sequence-sharded), in one all-reduce, then over "pod" (its b/p
        rows of each slot), in one more (role "loss"). Both are partial
        sums whose backward is the identity: each pod rank's gradient
        is its own rows' share, which ``reduce_grads`` adds up."""
        both = torch.stack(sums)
        if self.split("lm_head") is None and self.seq_sharded:
            both = C.reduce(both, self.mesh, "model", "activation", self.log)
        if self.p > 1:
            both = C.reduce(both, self.mesh, "pod", "loss", self.log)
        return list(both.unbind(0))

    def xent(self, logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(log-sum-exp, gold logit) of fp32 vocabulary-parallel ``logits``
        ([..., V/m]) at ``labels`` (-1: no gold, 0), each all-reduced over
        "model"."""
        if self.m == 1 or self.split("lm_head") is None:
            gold = torch.gather(logits, -1,
                                labels.clamp_min(0).long()[..., None])
            return torch.logsumexp(logits, dim=-1), gold[..., 0]
        n = logits.shape[-1]
        mx = C.all_reduce(logits.detach().amax(dim=-1), self.mesh, "model",
                          "activation", self.log, op=dist.ReduceOp.MAX)
        se = torch.exp(logits - mx[..., None]).sum(dim=-1)
        lse = mx + torch.log(C.reduce(se, self.mesh, "model", "activation",
                                      self.log))
        loc = labels.long() - self.model_rank * n
        ok = (loc >= 0) & (loc < n) & (labels >= 0)
        g = torch.gather(logits, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        g = torch.where(ok, g, torch.zeros((), dtype=g.dtype,
                                           device=g.device))
        return lse, C.reduce(g, self.mesh, "model", "activation", self.log)

    # -- after the backward ------------------------------------------------

    def reduce_grads(self, grads: Dict) -> Dict:
        """Each adapter gradient (a partial sum over "model") all-reduced
        over "model", then all of them (each pod rank's share of its rows)
        in one all-reduce over "pod", flat; nothing crosses "data"."""
        out = {t: {k: C.all_reduce(g, self.mesh, "model", "adapter_grad",
                                   self.log)
                   for k, g in ab.items()} for t, ab in grads.items()}
        if self.p == 1:
            return out
        leaves = [g for ab in out.values() for g in ab.values()]
        flat = C.all_reduce(torch.cat([g.reshape(-1) for g in leaves]),
                            self.mesh, "pod", "adapter_grad", self.log)
        parts = iter(flat.split([g.numel() for g in leaves]))
        return {t: {k: next(parts).view_as(g) for k, g in ab.items()}
                for t, ab in out.items()}

    def gather_metrics(self, *vecs: torch.Tensor) -> List[torch.Tensor]:
        """The per-slot [Z/d] vectors gathered over "data" to [Z], in one
        collective (every pod rank already holds the same ones)."""
        both = torch.stack([v.float() for v in vecs], dim=-1)
        full = C.all_gather(both, self.mesh, "data", 0, "metric", self.log)
        return list(full.unbind(-1))


def _weight_layouts(mesh,
                    params: Dict) -> Dict[str, Dict[str, Optional[int]]]:
    """{leaf name: {"data": dim, "model": dim}} of each DTensor parameter:
    the negative tensor dim each axis splits (None: not split), the same
    for a layer-stacked leaf and one layer's slice of it."""
    names = axis_names(mesh)
    out: Dict[str, Dict[str, Optional[int]]] = {}

    def visit(path, leaf):
        lay = {"data": None, "model": None}
        if isinstance(leaf, DTensor):
            for axis, p in zip(names, leaf.placements):
                if isinstance(p, Shard) and axis in lay:
                    lay[axis] = p.dim - leaf.ndim
        out[_weight_name(path)] = lay

    _map_with_path(params, visit)
    return out
