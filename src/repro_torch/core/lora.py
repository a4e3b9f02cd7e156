"""Multi-adapter (slot-stacked) LoRA: the ALTO workload unit.

All adapters of one replica live in slot-stacked fp32 tensors with a
leading ``Z`` axis (paper §A.1 rank-only padding), stacked over layers:

    A: [L, Z, d_in, r_max]     B: [L, Z, r_max, d_out]

Per-slot true ranks are expressed by zeroing columns/rows beyond ``r_i``
(``rank_mask``). Under a ``slot_ranks`` binding the ranks become a COMPUTE
dimension: ``lora_delta`` goes to the rank-local grouped-LoRA kernels
(``kernels/grouped_lora``), which skip dead rank tiles and never read the
padded region into the output.

``lora_delta`` is differentiable in x, A and B on both backends. The
default ``"kernel"`` backend takes, as the JAX package's Pallas backends
do:
  * under ``slot_ranks`` (with or without ``ragged_rows``):
    ``ranklocal_grouped_lora``, an autograd Function over the six
    rank-local CUDA kernels;
  * under ``ragged_rows`` alone (every resident slot at r_max, mixed
    widths): ``ragged_grouped_lora``, an autograd Function over the six
    ragged CUDA kernels;
  * with nothing bound (every resident slot at r_max and full width):
    ``grouped_lora``, an autograd Function over the six dense CUDA
    kernels.
The three kernel sets are one template instantiated three times, so a
full-rank slot gets bitwise one result whichever its co-tenants select.
For CPU tensors each Function runs its kernels' plain versions; on a CUDA
tensor no branch does plain math. The ``"torch"`` backend takes autograd
through the rank-local kernels' plain versions under ``slot_ranks`` and
plain PyTorch math otherwise, with the row mask under ``ragged_rows`` (the
JAX package's ``jnp`` path), on any device — the reference a run on the
card compares its kernels against.

The bindings are thread-local. A step that recomputes layers during the
backward pass (``torch.utils.checkpoint``; on the card autograd runs the
backward in its own thread) captures them with ``current_binding()`` and
re-enters them with ``bound()``.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.grouped_lora import ops as kops
from repro_torch.kernels.grouped_lora import ref as kref
from repro_torch.models import shardctx
from repro_torch.models.shardctx import constrain

_backend = threading.local()

BACKENDS = ("kernel", "torch")


def set_backend(name: str) -> None:
    if name not in BACKENDS:
        raise ValueError(f"unknown LoRA backend {name!r}; have {BACKENDS}")
    _backend.name = name


def get_backend() -> str:
    return getattr(_backend, "name", "kernel")


@contextlib.contextmanager
def backend(name: str):
    prev = get_backend()
    set_backend(name)
    try:
        yield
    finally:
        set_backend(prev)


# ---------------------------------------------------------------------------
# Ragged slot widths and per-slot true ranks (bound around a forward)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def ragged_rows(rows: Optional[torch.Tensor]):
    """Bind per-slot valid token-row counts ([Z] int32, in flattened
    lead-dims units) for lora_delta calls made under this context."""
    prev = getattr(_backend, "rows", None)
    _backend.rows = rows
    try:
        yield
    finally:
        _backend.rows = prev


def get_ragged_rows() -> Optional[torch.Tensor]:
    return getattr(_backend, "rows", None)


@contextlib.contextmanager
def slot_ranks(ranks: Optional[torch.Tensor]):
    """Bind per-slot true ranks ([Z] int32) for lora_delta calls made
    under this context."""
    prev = getattr(_backend, "ranks", None)
    _backend.ranks = ranks
    try:
        yield
    finally:
        _backend.ranks = prev


def get_slot_ranks() -> Optional[torch.Tensor]:
    return getattr(_backend, "ranks", None)


def current_binding() -> Tuple[str, Optional[torch.Tensor],
                               Optional[torch.Tensor]]:
    """(backend, ragged rows, slot ranks) bound in this thread."""
    return get_backend(), get_ragged_rows(), get_slot_ranks()


@contextlib.contextmanager
def bound(binding: Tuple[str, Optional[torch.Tensor],
                         Optional[torch.Tensor]]):
    """Re-enter a binding taken with ``current_binding()``."""
    name, rows, ranks = binding
    with backend(name), ragged_rows(rows), slot_ranks(ranks):
        yield


def _apply_row_mask(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Zero token rows >= rows[z]; row index runs over the flattened
    non-feature lead dims (b*seq for [Z, b, S, d] activations)."""
    Z = x.shape[0]
    n = 1
    for d in x.shape[1:-1]:
        n *= d
    idx = torch.arange(n, device=x.device).reshape((1,) + x.shape[1:-1])
    keep = idx < rows.to(x.device).reshape((Z,) + (1,) * (x.dim() - 2))
    return torch.where(keep[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))


# ---------------------------------------------------------------------------
# Application
# ---------------------------------------------------------------------------

def _scale_vec(scale, Z: int, device) -> torch.Tensor:
    s = torch.as_tensor(scale, dtype=torch.float32, device=device)
    return s.expand(Z) if s.dim() == 0 else s


def lora_delta(x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
               scale: torch.Tensor | float) -> torch.Tensor:
    """scale * (x @ A) @ B, grouped over the leading slot axis.

    x: [Z, ..., d_in]; A: [Z, d_in, r]; B: [Z, r, d_out]; scale: float or
    [Z]. Under ``ragged_rows`` slot z's delta covers only its first rows[z]
    token rows; under ``slot_ranks`` only its first ranks[z] ranks."""
    rows, ranks = get_ragged_rows(), get_slot_ranks()
    kernel = get_backend() == "kernel"
    lead, Z = x.shape[:-1], x.shape[0]
    xt = x.reshape(Z, -1, x.shape[-1])
    if ranks is not None:
        if kernel:
            y = kops.ranklocal_grouped_lora(xt, A, B, scale, ranks, rows)
        else:
            y = kref.ranklocal_lora_ref(xt, A, B,
                                        _scale_vec(scale, Z, x.device),
                                        ranks, rows)
        return y.reshape(*lead, B.shape[-1])
    if kernel:
        y = (kops.grouped_lora(xt, A, B, scale) if rows is None else
             kops.ragged_grouped_lora(xt, A, B, scale, rows))
        return y.reshape(*lead, B.shape[-1])
    if rows is not None:
        x = _apply_row_mask(x, rows)
    return _lora_delta_torch(x, A, B, scale)


def _lora_delta_torch(x, A, B, scale):
    """The JAX package's ``_lora_delta_jnp``: both products in x's dtype."""
    dt = x.dtype
    Z = x.shape[0]
    xt = x.reshape(Z, -1, x.shape[-1])
    y = torch.bmm(torch.bmm(xt, A.to(dt)), B.to(dt))
    sv = _scale_vec(scale, Z, x.device).to(dt).reshape(Z, 1, 1)
    return (y * sv).reshape(*x.shape[:-1], B.shape[-1])


def proj(x: torch.Tensor, W: torch.Tensor,
         lora_pair: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
         scale: torch.Tensor | float = 2.0,
         name: Optional[str] = None, *, whole: bool = False) -> torch.Tensor:
    """Frozen base projection + optional grouped LoRA residual.

    x: [Z, ..., d_in]; W: [d_in, d_out] (frozen, slot-shared). ``name``
    lets the sharding policy (``models/shardctx``) gather the frozen weight
    over the adapter ("data") axis before use, as the reference's
    ``proj`` does at opt_level >= 1.

    Sharded over "model" (``shardctx.spmd()``), W is this rank's block. A
    column-parallel W ([d_in, d_out/m]) reads the normed residual gathered
    over "model" (an input already made whole, ``SpmdPlan.gathered``, is
    read as it is) and the LoRA term takes the whole A and B's local output
    columns (a ``BLOCKED`` weight's blocks); a row-parallel W ([d_in/m,
    d_out]) reads x's local input columns, the LoRA term A's local input
    rows and the whole B, and the output is this rank's partial sum, base
    and LoRA term alike, which the "residual" constraint reduce-scatters
    (the partial LoRA terms add up to the LoRA term once). With ``whole``
    (attention or a scan branch whose heads do not split) W is gathered
    over "model" too and the projection runs whole on x as given. Where x
    is this rank's sequence block of such a sublayer's output
    (``SpmdPlan.seq_block``), bound ragged rows are taken in the block
    (``SpmdPlan.block_rows``). The kernels get contiguous local
    operands."""
    if name is not None:
        W = constrain(W, f"weight:{name}")
    sp = shardctx.spmd()
    split = sp.split(name) if sp is not None and name is not None else None
    if whole and split is not None:
        W, split = sp.gather_model(W, name), None
    if split == "col":
        x = sp.columns(x)
    y = x @ W
    if lora_pair is not None:
        A, B = lora_pair
        if split == "col":
            B = sp.local_out(B, name)
        elif split == "row":
            A = sp.local(A, -2).contiguous()
        rows = get_ragged_rows()
        if rows is not None and getattr(x, "_spmd_block", False):
            rows = sp.block_rows(rows)
        with ragged_rows(rows):
            y = y + lora_delta(x, A, B, scale)
    return sp.partial(y) if split == "row" else y


# ---------------------------------------------------------------------------
# Initialization / masking / slot surgery
# ---------------------------------------------------------------------------

def rank_mask(ranks: torch.Tensor, r_max: int) -> torch.Tensor:
    """[Z] int ranks -> [Z, r_max] float {0,1} mask."""
    return (torch.arange(r_max, device=ranks.device)[None, :]
            < ranks[:, None]).float()


def init_slot_lora(gen: torch.Generator, d_in: int, d_out: int, r_max: int,
                   Z: int, ranks: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LoRA init: A ~ N(0, 1/r_max) (rank-masked), B = 0. fp32 master."""
    dev = gen.device
    A = torch.randn((Z, d_in, r_max), generator=gen, dtype=torch.float32,
                    device=dev)
    A = A * (r_max ** -0.5) * rank_mask(ranks.to(dev), r_max)[:, None, :]
    B = torch.zeros((Z, r_max, d_out), dtype=torch.float32, device=dev)
    return A, B


def init_lora_tree(gen: torch.Generator, cfg: ModelConfig, Z: int,
                   ranks: torch.Tensor,
                   target_shapes: Dict[str, Tuple[int, int]],
                   num_layers: Optional[int] = None) -> Dict:
    """Stacked-over-layers LoRA tree on the generator's device:
    ``{target: {"A": [L,Z,din,r], "B": [L,Z,r,dout]}}``. Only targets in
    ``target_shapes`` AND ``cfg.lora.targets`` get adapters."""
    L = num_layers if num_layers is not None else cfg.num_layers
    r = cfg.lora.r_max
    tree: Dict[str, Dict[str, torch.Tensor]] = {}
    for t in [t for t in cfg.lora.targets if t in target_shapes]:
        d_in, d_out = target_shapes[t]
        pairs = [init_slot_lora(gen, d_in, d_out, r, Z, ranks)
                 for _ in range(L)]
        tree[t] = {"A": torch.stack([a for a, _ in pairs]),
                   "B": torch.stack([b for _, b in pairs])}
    return tree


def mask_lora_tree(tree: Dict, ranks: torch.Tensor, r_max: int) -> Dict:
    """Re-apply rank masks to a stacked LoRA tree IN PLACE (the JAX
    package returns a new tree; the post-step re-mask here multiplies the
    slot-stacked tensors where they lie); returns the same tree."""
    with torch.no_grad():
        for ab in tree.values():
            m = rank_mask(ranks.to(ab["A"].device), r_max)   # [Z, r]
            ab["A"].mul_(m[None, :, None, :])
            ab["B"].mul_(m[None, :, :, None])
    return tree


def slot_update(tree: Dict, slot: int, new_tree_slot: Dict) -> Dict:
    """Replace one slot's adapter params IN PLACE (the JAX package returns
    a new tree; here the pool's tensors are updated where they lie and the
    same tree is returned)."""
    for t, ab in tree.items():
        for m in ("A", "B"):
            ab[m][:, slot].copy_(torch.as_tensor(new_tree_slot[t][m]))
    return tree


def gather_slots(tree: Dict, slots: List[int]) -> Dict:
    """Sub-tree of the given slots (leading Z axis becomes len(slots))."""
    return {t: {m: x[:, list(slots)] for m, x in ab.items()}
            for t, ab in tree.items()}


def zero_slot(tree: Dict, slot: int) -> Dict:
    """Zero a slot's adapter params IN PLACE (eviction); returns the tree."""
    for ab in tree.values():
        for x in ab.values():
            x[:, slot].zero_()
    return tree
