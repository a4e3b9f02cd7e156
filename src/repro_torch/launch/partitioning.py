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

Execution: the port runs the step on the local shards of a one-rank mesh,
whose shards are whole (``distribute`` wraps each tensor as a DTensor
without a copy, ``local`` takes it back). The activation policy resolves
and records each constraint's spec and returns the tensor unchanged. A
real mesh of more than one rank raises ``NotImplementedError``: sharded
execution needs more than one card (``ROADMAP.md`` §1, "sharded
execution"). The activation policy lets a mesh over a ``fake`` group
(``mesh.fake_group``) through: it moves no data, and the dry run
(``launch/dryrun.py``) resolves the policy's decisions on the production
mesh through it. ``distribute`` refuses every mesh of more than one rank.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import axis_names, axis_sizes, is_fake

SHARDED_EXECUTION = ("sharded execution over a mesh of more than one rank "
                     "is not ported (ROADMAP.md §1, sharded execution): "
                     "it needs more than one card")


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
    opt_level >= 2 in training, ``scan_chunk`` 32 and ``scan_opt``."""
    if _real_multi_rank(mesh):
        raise NotImplementedError(SHARDED_EXECUTION)
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
        shape = tuple(x.shape)
        key = (kind, shape)
        if key not in policy.decisions:
            policy.decisions[key] = decide(shape, kind)
        return x

    policy.decisions = {}
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
    """Each tensor of ``tree`` as a DTensor on ``mesh`` with its placements
    from ``named`` (a ``to_named`` tree of the same structure). On a
    one-rank mesh a tensor is its own local shard: no copy is made."""
    if mesh.size() > 1:
        raise NotImplementedError(SHARDED_EXECUTION)

    def wrap(path, t):
        return DTensor.from_local(t, mesh, _lookup(named, path),
                                  run_check=False)

    return _map_with_path(tree, wrap)


def _lookup(tree: Any, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def local(tree: Any) -> Any:
    """``tree`` with each DTensor replaced by its local shard (the step's
    kernels take plain tensors)."""
    return _map(tree, lambda t: t.to_local() if isinstance(t, DTensor)
                else t)
