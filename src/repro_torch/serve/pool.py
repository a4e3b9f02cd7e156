"""AdapterPool: hot publish/retire of adapters into backbone slots.

One frozen backbone holds ``Z`` adapter slots; adapters are published
into / retired from those slots between decode steps — no replica
restart (slot shapes are static at ``r_max`` capacity; TRUE ranks ride the
``slot_ranks`` binding). The pool's ``lora`` tree and ``ranks`` vector are
inputs to every forward, so a publish is visible on the very next step and
resident slots are untouched bit-for-bit (slot isolation). Slots are
written in place on the pool's device.

Publishes load either from a live adapter tree (``publish``) or from a
durable ``checkpoint/checkpoint.py`` artifact (``publish_checkpoint``) in
the JAX package's npz layout.
"""
from __future__ import annotations

import time
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import load_pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as LORA
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device

# Version stamp written into / checked against checkpoint metadata (the
# same value as the JAX package's, so artifacts move between them).
SPEC_VERSION = 1


def _zero_tree(cfg: ModelConfig, lead: Tuple[int, ...],
               device: torch.device) -> Dict:
    r = cfg.lora.r_max
    L = cfg.num_layers
    shapes = M.target_shapes(cfg)
    return {t: {"A": torch.zeros((L, *lead, shapes[t][0], r),
                                 dtype=torch.float32, device=device),
                "B": torch.zeros((L, *lead, r, shapes[t][1]),
                                 dtype=torch.float32, device=device)}
            for t in cfg.lora.targets if t in shapes}


def adapter_template(cfg: ModelConfig) -> Dict:
    """Single-adapter tree ``{target: {"A": [L,din,r], "B": ...}}`` on the
    meta device — the names, shapes and dtypes checkpoint loads restore
    into, without allocating them."""
    return _zero_tree(cfg, (), torch.device("meta"))


def _mask_adapter(adapter: Dict, rank: int, r_max: int,
                  device: torch.device) -> Dict:
    """Zero the padded rank region of a single adapter ([L,din,r] A /
    [L,r,dout] B) on ``device``: published slots keep the invariant that
    the region beyond the TRUE rank is exactly zero."""
    keep = (torch.arange(r_max, device=device) < rank).float()

    def leaf(x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):     # numpy (maybe read-only)
            x = torch.from_numpy(np.array(x))
        return x.to(device, torch.float32)

    return {t: {"A": leaf(ab["A"]) * keep[None, None, :],
                "B": leaf(ab["B"]) * keep[None, :, None]}
            for t, ab in adapter.items()}


class PoolFull(Exception):
    """Raised by ``publish`` when no free slot is available."""


class CorruptCheckpoint(Exception):
    """Raised by ``publish_checkpoint`` when the artifact on disk cannot
    be read (truncated npz, missing keys, shape mismatch); distinct from
    the AssertionError raised for a valid artifact with a mismatched
    arch/spec_version."""


class AdapterPool:
    """``Z`` hot-swappable adapter slots over one frozen backbone; the
    slot-stacked fp32 tree lives on the card unless ``device`` says
    otherwise."""

    def __init__(self, cfg: ModelConfig, Z: int,
                 device: Optional[str | torch.device] = None):
        assert Z >= 1
        self.cfg = cfg
        self.Z = Z
        self.r_max = cfg.lora.r_max
        self.device = resolve_device(device)
        self._template = adapter_template(cfg)
        self.lora = _zero_tree(cfg, (Z,), self.device)
        self.slot_adapter: List[Optional[str]] = [None] * Z
        self.slot_rank: List[int] = [0] * Z
        self.version = 0                       # bumps on publish/retire
        self.publish_latencies_s: List[float] = []
        self._meta: Dict[str, Dict] = {}       # adapter_id -> publish meta
        self._ranks_cache: Optional[torch.Tensor] = None
        self._ranks_version = -1

    # ------------------------------------------------------------ queries
    @property
    def ranks(self) -> torch.Tensor:
        """[Z] int32 TRUE ranks (0 = empty slot) on the pool's device — a
        forward input, uploaded once per pool version."""
        if self._ranks_version != self.version:
            self._ranks_cache = torch.tensor(self.slot_rank,
                                             dtype=torch.int32,
                                             device=self.device)
            self._ranks_version = self.version
        return self._ranks_cache

    def resident(self) -> Dict[str, int]:
        return {a: s for s, a in enumerate(self.slot_adapter)
                if a is not None}

    def slot_of(self, adapter_id: str) -> int:
        res = self.resident()
        assert adapter_id in res, f"adapter {adapter_id!r} not resident"
        return res[adapter_id]

    def free_slots(self) -> List[int]:
        return [s for s, a in enumerate(self.slot_adapter) if a is None]

    def mixed_rank(self) -> bool:
        return any(r != self.r_max for s, r in enumerate(self.slot_rank)
                   if self.slot_adapter[s] is not None)

    def meta_of(self, adapter_id: str) -> Dict:
        return self._meta.get(adapter_id, {})

    def occupied_tokens(self, lanes: int, seq_len: int) -> int:
        """Serving token budget: every resident adapter's lanes decode at
        up to ``seq_len`` positions (§A.3 token-linear accounting)."""
        return len(self.resident()) * lanes * seq_len

    def occupied_rank_tokens(self, lanes: int, seq_len: int) -> int:
        return sum(self.slot_rank[s] for s in self.resident().values()) \
            * lanes * seq_len

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------ mutation
    def publish(self, adapter_id: str, adapter: Dict, rank: int,
                slot: Optional[int] = None,
                meta: Optional[Dict] = None) -> int:
        """Insert a single adapter ([L,...] tree) into a free slot; visible
        on the next decode step. Returns the slot index."""
        assert adapter_id not in self.resident(), \
            f"adapter {adapter_id!r} already resident"
        free = self.free_slots()
        if slot is None:
            if not free:
                raise PoolFull(f"no free slot for {adapter_id!r}")
            slot = free[0]
        assert slot in free, f"slot {slot} occupied"
        rank = max(min(int(rank), self.r_max), 1)
        t0 = time.perf_counter()
        LORA.slot_update(self.lora, slot,
                         _mask_adapter(adapter, rank, self.r_max,
                                       self.device))
        self._sync()
        self.publish_latencies_s.append(time.perf_counter() - t0)
        self.slot_adapter[slot] = adapter_id
        self.slot_rank[slot] = rank
        self._meta[adapter_id] = dict(meta or {})
        self.version += 1
        return slot

    def publish_many(self, items: List[Tuple]) -> List[int]:
        """Batched publish: insert N adapters with ONE indexed slot write
        per LoRA leaf. ``items`` is a list of ``(adapter_id, adapter,
        rank)`` or ``(adapter_id, adapter, rank, meta)``. Returns the slot
        indices, in item order."""
        if not items:
            return []
        free = self.free_slots()
        if len(items) > len(free):
            raise PoolFull(
                f"{len(items)} publishes, {len(free)} free slots")
        resident = self.resident()
        norm = []
        for it in items:
            aid, adapter, rank = it[0], it[1], it[2]
            meta = it[3] if len(it) > 3 else None
            assert aid not in resident, f"adapter {aid!r} already resident"
            assert all(aid != o[0] for o in norm), \
                f"adapter {aid!r} listed twice"
            norm.append((aid, adapter,
                         max(min(int(rank), self.r_max), 1), meta))
        slots = free[:len(norm)]
        idx = torch.tensor(slots, dtype=torch.long, device=self.device)
        masked = [_mask_adapter(ad, rank, self.r_max, self.device)
                  for _, ad, rank, _ in norm]
        t0 = time.perf_counter()
        for t, ab in self.lora.items():
            for m, leaf in ab.items():
                leaf[:, idx] = torch.stack([a[t][m] for a in masked], dim=1)
        self._sync()
        per = (time.perf_counter() - t0) / len(norm)
        for slot, (aid, _, rank, meta) in zip(slots, norm):
            self.publish_latencies_s.append(per)   # amortized per adapter
            self.slot_adapter[slot] = aid
            self.slot_rank[slot] = rank
            self._meta[aid] = dict(meta or {})
        self.version += len(norm)
        return slots

    def publish_checkpoint(self, path: str,
                           adapter_id: Optional[str] = None,
                           slot: Optional[int] = None) -> Tuple[str, int]:
        """Publish from a durable artifact written by ``save_pytree`` (of
        either package). The checkpoint's meta must carry the TRUE
        ``rank``, a matching ``spec_version``, and (when present) an
        ``arch`` equal to this pool's backbone. Returns ``(adapter_id,
        slot)``."""
        try:
            adapter, meta = load_pytree(path, self._template)
            rank = int(meta["rank"])
        except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
            raise CorruptCheckpoint(
                f"checkpoint {path!r} unreadable: {e}") from e
        ver = meta.get("spec_version")
        assert ver == SPEC_VERSION, \
            f"checkpoint spec_version {ver} != pool {SPEC_VERSION}"
        arch = meta.get("arch")
        assert arch is None or arch == self.cfg.name, \
            f"checkpoint arch {arch!r} != backbone {self.cfg.name!r}"
        aid = adapter_id or meta.get("adapter_id") or path
        s = self.publish(aid, adapter, rank, slot=slot, meta=meta)
        return aid, s

    def retire(self, adapter_id: str) -> int:
        """Zero the adapter's slot and free it; resident slots untouched."""
        slot = self.slot_of(adapter_id)
        LORA.zero_slot(self.lora, slot)
        self.slot_adapter[slot] = None
        self.slot_rank[slot] = 0
        self._meta.pop(adapter_id, None)
        self.version += 1
        return slot

    def adapter_at(self, slot: int) -> Dict:
        """Host copy of one slot's adapter ([L,...]) as numpy arrays."""
        return {t: {m: x[:, slot].cpu().numpy() for m, x in ab.items()}
                for t, ab in self.lora.items()}
