"""AdamW over slot-stacked LoRA trees with PER-SLOT hyperparameters.

Every adapter slot trains under its own (lr, wd) — the ALTO tuning unit —
so the hyperparameters are [Z] vectors broadcast onto [L, Z, ...] leaves.
Per-slot global-norm gradient clipping keeps one diverging job from
touching its neighbours. Rank masks are re-applied after every update so
rank-padded regions stay identically zero (paper §A.1).

The arithmetic is the JAX package's (``repro.optim.adamw``), op for op, in
fp32. These are elementwise passes that the JAX package leaves to XLA, so
they are plain PyTorch here. Unlike the JAX functions, ``apply_updates``
and ``reset_slot`` update the parameter and moment tensors IN PLACE under
``torch.no_grad()`` (a full-size tree is gigabytes) and return them.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch


class SlotHParams(NamedTuple):
    """Per-slot hyperparameters, each [Z] fp32."""
    lr: torch.Tensor
    wd: torch.Tensor
    beta1: torch.Tensor
    beta2: torch.Tensor
    grad_clip: torch.Tensor     # 0 => no clipping

    @staticmethod
    def broadcast(Z: int, lr=1e-4, wd=0.01, beta1=0.9, beta2=0.999,
                  grad_clip=1.0, device=None) -> "SlotHParams":
        f = lambda v: torch.full((Z,), v, dtype=torch.float32, device=device)
        return SlotHParams(f(lr), f(wd), f(beta1), f(beta2), f(grad_clip))

    def replace_slot(self, slot: int, **kw) -> "SlotHParams":
        """A new SlotHParams with slot ``slot`` of the named fields set."""
        d = self._asdict()
        for k, v in kw.items():
            d[k] = d[k].clone()
            d[k][slot] = v
        return SlotHParams(**d)


class AdamWState(NamedTuple):
    mu: Dict
    nu: Dict
    count: torch.Tensor         # [Z] int32 per-slot step counts


def _leaves(tree: Dict) -> List[torch.Tensor]:
    """Leaves in the JAX package's flattening order (sorted keys)."""
    out: List[torch.Tensor] = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(_leaves(v) if isinstance(v, dict) else [v])
    return out


def _map(tree: Dict, fn) -> Dict:
    return {k: (_map(v, fn) if isinstance(v, dict) else fn(v))
            for k, v in tree.items()}


def init_state(lora_tree: Dict, Z: int) -> AdamWState:
    zeros = lambda x: torch.zeros_like(x, dtype=torch.float32)
    dev = _leaves(lora_tree)[0].device
    return AdamWState(mu=_map(lora_tree, zeros), nu=_map(lora_tree, zeros),
                      count=torch.zeros((Z,), dtype=torch.int32, device=dev))


def _bshape(v: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """Reshape [Z] vector to broadcast over [L, Z, ...] leaves."""
    return v.reshape((1, -1) + (1,) * (leaf.dim() - 2))


def per_slot_global_norm(grads: Dict) -> torch.Tensor:
    """[Z] fp32 global grad norm per slot across all leaves."""
    total = None
    for g in _leaves(grads):
        sq = torch.sum(torch.square(g.float()),
                       dim=tuple(i for i in range(g.dim()) if i != 1))
        total = sq if total is None else total + sq
    return torch.sqrt(torch.clamp_min(total, 0.0))


def apply_updates(params: Dict, grads: Dict, state: AdamWState,
                  hp: SlotHParams, active: torch.Tensor,
                  rank_masker: Optional[Callable[[Dict], Dict]] = None,
                  eps: float = 1e-8) -> Tuple[Dict, AdamWState]:
    """One AdamW step, in place. ``active``: [Z] {0,1} — inactive slots
    are frozen (their parameters and moments are left as they were).

    ``rank_masker``: optional fn(tree) -> tree re-applying rank masks."""
    with torch.no_grad():
        norms = per_slot_global_norm(grads)
        clip = torch.where((hp.grad_clip > 0) & (norms > hp.grad_clip),
                           hp.grad_clip / torch.clamp_min(norms, 1e-12),
                           torch.ones_like(norms))                  # [Z]
        act = active.float()
        new_count = state.count + active.to(torch.int32)
        t = torch.clamp_min(new_count, 1).float()                   # [Z]
        bc1 = 1.0 - hp.beta1 ** t
        bc2 = 1.0 - hp.beta2 ** t
        for p, g, m, n in zip(_leaves(params), _leaves(grads),
                              _leaves(state.mu), _leaves(state.nu)):
            gf = g.float() * _bshape(clip * act, p)
            b1, b2 = _bshape(hp.beta1, p), _bshape(hp.beta2, p)
            a = _bshape(act, p)
            m2 = (b1 * m + (1 - b1) * gf) * a + m * (1 - a)
            n2 = (b2 * n + (1 - b2) * torch.square(gf)) * a + n * (1 - a)
            mhat = m2 / _bshape(bc1, p)
            nhat = n2 / _bshape(bc2, p)
            step = mhat / (torch.sqrt(nhat) + eps) + _bshape(hp.wd, p) * p
            p.sub_(_bshape(hp.lr * act, p) * step)
            m.copy_(m2)
            n.copy_(n2)
        state.count.copy_(new_count)
        if rank_masker is not None:
            params = rank_masker(params)
    return params, state


def reset_slot(state: AdamWState, slot: int) -> AdamWState:
    """Zero a slot's optimizer state in place (eviction / swap-in)."""
    with torch.no_grad():
        for x in _leaves(state.mu) + _leaves(state.nu):
            x[:, slot] = 0.0
        state.count[slot] = 0
    return state
