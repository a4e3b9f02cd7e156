"""Pytree checkpointing in the JAX package's npz layout.

``save_pytree`` / ``load_pytree`` read and write the same files as
``repro.checkpoint.checkpoint``: one array per leaf under its ``/``-joined
dict path (keys sorted, as JAX flattens dicts), bf16 stored as raw
``uint16`` bits, plus ``__meta__`` and ``__dtypes__`` JSON entries. An
adapter saved by either package therefore loads in the other.
``save_state_tree`` / ``load_state_tree`` do the same for the JAX package's
free-form nested-dict checkpoints (the durable lifecycle state of
``checkpoint/taskstate.py``): positional arrays, their leaf paths and dtypes
as JSON, dict order kept.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    if isinstance(tree, dict):
        flat: Dict[str, Any] = {}
        for k in sorted(tree):
            flat.update(_flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return flat
    return {prefix[:-1]: tree}


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name): bf16 tensors become their uint16
    bits — np.savez cannot store bfloat16."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _atomic_savez(path: str, payload: Dict[str, Any]) -> None:
    """Crash-safe npz write: tmp file + fsync + ``os.replace``."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_pytree(path: str, tree: Any, meta: Dict | None = None,
                atomic: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat, dtypes = {}, {}
    for k, leaf in _flatten_with_paths(tree).items():
        flat[k], dtypes[k] = _to_numpy(leaf)
    payload = dict(__meta__=json.dumps(meta or {}),
                   __dtypes__=json.dumps(dtypes), **flat)
    if atomic:
        if not path.endswith(".npz"):
            path = path + ".npz"
        _atomic_savez(path, payload)
    else:
        np.savez(path, **payload)


def _unflatten(flat: Dict[str, Any]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_pytree(path: str, like: Any) -> Tuple[Any, Dict]:
    """Restore into the structure of ``like`` (a dict tree of tensors; the
    meta device will do — only names, shapes and dtypes are read).
    Returns (CPU tensor tree, meta)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    out = {}
    for key, leaf in _flatten_with_paths(like).items():
        arr = data[key]
        if leaf.dtype == torch.bfloat16:
            if arr.dtype != np.uint16:
                raise ValueError(f"{key}: expected bf16 bits, got {arr.dtype}")
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr)).to(leaf.dtype)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                             f"{tuple(leaf.shape)}")
        out[key] = t
    return _unflatten(out), meta


def save_state_tree(path: str, tree: Dict,
                    meta: Optional[Dict] = None) -> None:
    """Free-form nested-dict checkpoint (always atomic).

    Keys may contain ``/`` (job ids do: ``task/label``) and no ``like``
    template is needed to load: leaf paths are stored as a JSON array
    beside positional arrays. Leaves are tensors (any device) or numpy
    arrays. Dict insertion order survives a round trip, which the
    lifecycle restore relies on (resident order is semantic)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    paths: list = []
    dtypes: list = []
    arrays: Dict[str, np.ndarray] = {}

    def walk(prefix: list, node: Any) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(prefix + [str(k)], v)
        else:
            arr, dt = _to_numpy(node)
            dtypes.append(dt)
            arrays[f"arr_{len(paths)}"] = arr
            paths.append(prefix)

    walk([], tree)
    _atomic_savez(path, dict(__meta__=json.dumps(meta or {}),
                             __paths__=json.dumps(paths),
                             __dtypes__=json.dumps(dtypes), **arrays))


def load_state_tree(path: str) -> Tuple[Dict, Dict]:
    """Inverse of ``save_state_tree``: ``(nested host tree, meta)``. Leaves
    are numpy arrays; bf16 ones (numpy has no such type) come back as CPU
    ``torch.bfloat16`` tensors."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["__meta__"]))
    paths = json.loads(str(data["__paths__"]))
    dtypes = json.loads(str(data["__dtypes__"]))
    tree: Dict = {}
    for i, (p, dt) in enumerate(zip(paths, dtypes)):
        arr = data[f"arr_{i}"]
        if dt == "bfloat16":
            arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = arr
    return tree, meta


def extract_slot(lora_tree: Dict, slot: int) -> Dict:
    """Pull one adapter out of a slot-stacked tree: [L,Z,...] -> [L,...]."""
    return {t: {m: x[:, slot] for m, x in ab.items()}
            for t, ab in lora_tree.items()}


def insert_slot(lora_tree: Dict, slot: int, adapter: Dict) -> Dict:
    """A new slot-stacked tree with one adapter ([L, ...] leaves) in slot
    ``slot``; ``lora_tree`` is left as it was."""
    out: Dict = {}
    for t, ab in lora_tree.items():
        out[t] = {}
        for m, x in ab.items():
            y = x.detach().clone()
            y[:, slot] = torch.as_tensor(adapter[t][m], dtype=y.dtype,
                                         device=y.device)
            out[t][m] = y
    return out
