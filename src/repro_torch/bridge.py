"""Weight bridge: the JAX package's pytrees <-> the port's tensor dicts.

Both packages keep parameters as nested dicts with identical keys and
``[L, ...]`` stacking, so the bridge is a 1:1 key map through numpy.
Leaves come in as numpy arrays (``np.asarray`` of a JAX array); bf16 may
arrive either as the ``bfloat16`` numpy dtype or as raw ``uint16`` bits
(the way the checkpoint format stores it), and goes out as ``uint16``
bits. Tests use it to give both packages the same weights, and — for
training — the same optimizer moments (``AdamWState``), per-slot
hyperparameters (``SlotHParams``) and rotated-out job state
(``SlotSnapshot``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.adapter_state import SlotSnapshot
from repro_torch.models import blocks as B
from repro_torch.models.common import resolve_device
from repro_torch.optim.adamw import AdamWState, SlotHParams


def tensor_from_numpy(arr: Any, device) -> torch.Tensor:
    """One leaf: bf16 (named dtype or uint16 bits) -> torch.bfloat16,
    anything else keeps its dtype."""
    arr = np.asarray(arr)
    if arr.dtype.name in ("bfloat16", "uint16"):
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One leaf back to numpy: bf16 as uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(cfg: ModelConfig, tree: Dict, device=None) -> Dict:
    """Backbone params of ``cfg`` from the JAX package's param tree."""
    dev = resolve_device(device)
    params = _map(tree, lambda a: tensor_from_numpy(a, dev))
    want = (cfg.vocab_size, cfg.d_model)
    if tuple(params["embed"].shape) != want:
        raise ValueError(f"embed has shape {tuple(params['embed'].shape)}, "
                         f"config {cfg.name} wants {want}")
    def depths(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from depths(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", v.shape[0]

    depths = dict(depths(params["layers"]))
    if set(depths.values()) != {cfg.num_layers}:
        raise ValueError(f"layer stack depths {depths} do not match the "
                         f"config's {cfg.num_layers} layers")
    _check_projections(cfg, params)
    if cfg.is_moe:
        _check_moe(cfg, params["layers"].get("moe", {}))
    return params


def _check_projections(cfg: ModelConfig, params: Dict) -> None:
    """The attention and MLP projections' ``[L, in, out]`` shapes (q_dim
    may differ from d_model) and an untied ``lm_head`` against the
    config."""
    if cfg.family == "ssm":
        want: Dict[str, tuple] = {}
    else:
        want = dict(B.attn_target_shapes(cfg))
        if not cfg.is_moe:
            want.update(B.mlp_target_shapes(cfg))
    got = {k: tuple(params["layers"][k].shape[1:]) for k in want
           if k in params["layers"]}
    if not cfg.tie_embeddings:
        want["lm_head"] = (cfg.d_model, cfg.vocab_size)
        if "lm_head" in params:
            got["lm_head"] = tuple(params["lm_head"].shape)
    if got != want:
        raise ValueError(f"projections {got}, config {cfg.name} wants "
                         f"{want}")


def _check_moe(cfg: ModelConfig, moe: Dict) -> None:
    """The ``moe`` subtree's ``[L, E, ...]`` shapes against the config."""
    L, d, m = cfg.num_layers, cfg.d_model, cfg.moe
    E, ff = m.num_experts, m.d_ff_expert
    want = {"router": (L, d, E), "w_gate": (L, E, d, ff),
            "w_up": (L, E, d, ff), "w_down": (L, E, ff, d)}
    if m.num_shared_experts:
        ffs = m.d_ff_shared * m.num_shared_experts
        want.update({"shared.gate": (L, d, ffs), "shared.up": (L, d, ffs),
                     "shared.down": (L, ffs, d)})
    got = {k: tuple(v.shape) for k, v in moe.items() if k != "shared"}
    got.update({f"shared.{k}": tuple(v.shape)
                for k, v in moe.get("shared", {}).items()})
    if got != want:
        raise ValueError(f"moe weights {got}, config {cfg.name} wants "
                         f"{want}")


def lora_from_numpy(tree: Dict, device=None) -> Dict:
    """A stacked LoRA tree ``{target: {"A", "B"}}`` from the JAX one."""
    dev = resolve_device(device)
    return _map(tree, lambda a: tensor_from_numpy(a, dev))


def params_to_numpy(params: Dict) -> Dict:
    return _map(params, tensor_to_numpy)


def lora_to_numpy(tree: Dict) -> Dict:
    return _map(tree, tensor_to_numpy)


def adamw_state_from_numpy(state: Any, device=None) -> AdamWState:
    """The port's AdamWState from anything with ``mu``, ``nu`` (trees) and
    ``count`` ([Z] int) — e.g. the JAX package's AdamWState with numpy
    leaves."""
    dev = resolve_device(device)
    conv = lambda a: tensor_from_numpy(a, dev)
    return AdamWState(mu=_map(state.mu, conv), nu=_map(state.nu, conv),
                      count=conv(np.asarray(state.count, np.int32)))


def adamw_state_to_numpy(state: AdamWState) -> Dict:
    """{"mu", "nu", "count"} as numpy (the JAX AdamWState's fields)."""
    return {"mu": _map(state.mu, tensor_to_numpy),
            "nu": _map(state.nu, tensor_to_numpy),
            "count": tensor_to_numpy(state.count)}


def hparams_from_numpy(hp: Any, device=None) -> SlotHParams:
    """SlotHParams from anything with its five [Z] fields."""
    dev = resolve_device(device)
    return SlotHParams(*(tensor_from_numpy(
        np.asarray(getattr(hp, f), np.float32), dev)
        for f in SlotHParams._fields))


def snapshot_from_numpy(snap: Any) -> SlotSnapshot:
    """A host SlotSnapshot (CPU tensors) from one with numpy leaves — e.g.
    the JAX package's."""
    conv = lambda a: tensor_from_numpy(a, "cpu")
    return SlotSnapshot(
        job_id=snap.job_id, lora=_map(snap.lora, conv),
        mu=_map(snap.mu, conv), nu=_map(snap.nu, conv),
        count=int(snap.count), rank=int(snap.rank),
        per_adapter_batch=int(snap.per_adapter_batch),
        seq_len=int(snap.seq_len))


def snapshot_to_numpy(snap: SlotSnapshot) -> Dict:
    """The SlotSnapshot's fields with numpy leaves (keyword arguments of
    the JAX package's SlotSnapshot)."""
    d = {f.name: getattr(snap, f.name) for f in dataclasses.fields(snap)}
    for k in ("lora", "mu", "nu"):
        d[k] = _map(d[k], tensor_to_numpy)
    return d
