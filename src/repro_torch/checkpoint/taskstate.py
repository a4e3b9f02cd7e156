"""Durable mid-task checkpoints: serialize a live ``TaskLifecycle``.

Port of ``src/repro/checkpoint/taskstate.py``, with the same ``SCHEMA``,
tree keys and meta keys, in the npz layout both packages read
(``checkpoint.save_state_tree``). ``export_lifecycle`` captures everything
the lifecycle's trajectory is a function of:

  * per-slot ``SlotSnapshot``s — adapter, AdamW moments (``mu``, ``nu``),
    step count, TRUE rank and ragged width — of the resident jobs (host
    copies; the card's state is untouched) and of the rotated-out ones;
  * the generator state of future job inits: the port draws each init
    from a ``torch.Generator`` seeded by (task seed, admission counter)
    (``TaskLifecycle._next_key``), so the task seed — stored under
    ``prng`` in the layout of the JAX package's ``PRNGKey(seed)``, two
    uint32 words — and the admission counter are the whole of it; no
    generator outlives an admission;
  * every ``JobMonitor``'s loss history, the phase counters, the queue,
    the best-validation adapters;
  * the batch streams: each leaf ``SlotBatcher``'s numpy generator states,
    permutations, cursors and epochs (two leaf batchers for the DPO
    ``PairSlotBatcher``);
  * the resident (job, lane) order, which is semantic: it drives eval
    iteration, exit order and lane backfill.

``restore_lifecycle`` rebuilds an equivalent lifecycle on a FRESH executor;
slots are bit-isolated (the migration property), so the continued chunk
stream is bitwise identical to the uninterrupted run's tail.

``TaskCheckpointer``, installed as ``BatchedExecutor.ckpt_hook``, persists
the lifecycle atomically every ``every`` chunks under
``state_dir/ckpt/<task>/chunk-%06d.npz``, prunes stale snapshots, and can
raise ``SimulatedCrash`` after N saves (a kill at a chunk boundary: what is
on disk is already fsynced). Given the service's ``EventJournal``
(``sched/journal.py``), it appends a ``ckpt`` record (task, path, chunk,
remaining-steps bound) for each save, which ``TuningService.recover``
resumes from.
"""
from __future__ import annotations

import glob
import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import load_state_tree, save_state_tree
from repro_torch.core.adapter_state import SlotSnapshot
from repro_torch.core.early_exit import ExitDecision, ExitReason

log = logging.getLogger(__name__)

SCHEMA = 1


class SimulatedCrash(RuntimeError):
    """Injected process death (chaos testing): raised at a chunk boundary
    after the checkpoint was durably written, like a pod loss would."""


# ---------------------------------------------------------------------------
# lifecycle <-> state tree
# ---------------------------------------------------------------------------

def _sub_batchers(batcher) -> List[Tuple[str, object]]:
    """A batcher is either a SlotBatcher or a pair-wrapper (DPO) holding
    two of them; return the leaf batchers with stable labels."""
    if hasattr(batcher, "chosen") and hasattr(batcher, "rejected"):
        return [("chosen", batcher.chosen), ("rejected", batcher.rejected)]
    return [("_", batcher)]


def _seed_key(seed: int) -> np.ndarray:
    """The task seed in the layout of ``jax.random.PRNGKey(seed)``."""
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def _key_seed(key) -> int:
    hi, lo = (int(x) for x in np.asarray(key, np.uint64).reshape(-1)[-2:])
    return (hi << 32) | lo


def _host_tree(node):
    """A state-tree node with CPU tensor leaves (numpy arrays from a
    loaded file become tensors; tensors stay)."""
    if isinstance(node, dict):
        return {k: _host_tree(v) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.cpu()
    return torch.from_numpy(np.array(node))


def _monitor_state(m) -> Dict:
    exited = None
    if m.exited is not None:
        exited = {"reason": m.exited.reason.value, "step": m.exited.step,
                  "best_val": m.exited.best_val,
                  "best_val_step": m.exited.best_val_step}
    return {"ema_train": m.ema_train, "ema_hist": list(m.ema_hist),
            "val_hist": list(m.val_hist),
            "raw_train_hist": list(m.raw_train_hist),
            "cnt_div": m.cnt_div, "cnt_ovf": m.cnt_ovf,
            "best_val": m.best_val, "best_val_step": m.best_val_step,
            "steps_trained": m.steps_trained, "exited": exited}


def _load_monitor(m, st: Dict) -> None:
    m.ema_train = st["ema_train"]
    m.ema_hist = [float(x) for x in st["ema_hist"]]
    m.val_hist = [float(x) for x in st["val_hist"]]
    m.raw_train_hist = [float(x) for x in st["raw_train_hist"]]
    m.cnt_div = int(st["cnt_div"])
    m.cnt_ovf = int(st["cnt_ovf"])
    m.best_val = float(st["best_val"])
    m.best_val_step = int(st["best_val_step"])
    m.steps_trained = int(st["steps_trained"])
    ex = st["exited"]
    m.exited = None if ex is None else ExitDecision(
        reason=ExitReason(ex["reason"]), step=int(ex["step"]),
        best_val=float(ex["best_val"]),
        best_val_step=int(ex["best_val_step"]))


def export_lifecycle(lc) -> Tuple[Dict, Dict]:
    """``(tree, meta)`` capturing a live (non-done) lifecycle at a chunk
    boundary. Resident slots are snapshotted through read-only host copies
    — the card's state is untouched, so exporting is safe every chunk."""
    assert lc.phase in ("warmup", "continue"), \
        f"cannot export lifecycle in phase {lc.phase!r}"
    snaps: Dict[str, SlotSnapshot] = {}
    resident_order: List[Tuple[str, int]] = []
    for job_id, (lane, slot) in lc.resident.items():
        snaps[job_id] = lc.ex.snapshot(slot)
        resident_order.append((job_id, lane))
    for job_id, snap in lc.snapshots.items():     # rotated-out wave jobs
        snaps[job_id] = snap
    tree: Dict = {
        "prng": _seed_key(lc._seed),
        "snap": {j: {"lora": s.lora, "mu": s.mu, "nu": s.nu}
                 for j, s in snaps.items()},
        "best": dict(lc._best_ckpt),
        "perm": {name: {str(z): np.asarray(sb._perm[z])
                        for z in range(sb.Z)}
                 for name, sb in _sub_batchers(lc.batcher)},
    }
    meta: Dict = {
        "schema": SCHEMA,
        "task": lc.task_name,
        "total_steps": lc.total_steps,
        "phase": lc.phase,
        "wave_idx": lc._wave_idx,
        "wave_step": lc._wave_step,
        "cont_step": lc._cont_step,
        "admissions": lc._admissions,
        "queue": list(lc._queue),
        "steps_done": dict(lc.steps_done),
        "resident": resident_order,
        "monitors": {j: _monitor_state(m) for j, m in lc.monitors.items()},
        "snap_meta": {j: {"count": s.count, "rank": s.rank,
                          "b": s.per_adapter_batch, "seq": s.seq_len}
                      for j, s in snaps.items()},
        "batcher": {name: {"rng": [r.bit_generator.state for r in sb._rngs],
                           "cursor": [int(c) for c in sb._cursor],
                           "epochs": [int(e) for e in sb.epochs]}
                    for name, sb in _sub_batchers(lc.batcher)},
        "remaining_steps_bound": lc.remaining_steps_bound(),
    }
    return tree, meta


def restore_lifecycle(ex, task_name: str, jobs: Dict, total_steps: int, *,
                      ee, max_slots: Optional[int], batcher, state):
    """Rebuild a lifecycle from ``(tree, meta)`` onto a fresh executor.

    The lifecycle is constructed normally, then its mutable state is
    overwritten from the checkpoint; residents are re-admitted at their
    exact lanes through the normal ``_admit_job`` restore path (physical
    slot indices may differ — slot isolation makes that invisible).
    ``state`` may come from either package's checkpoint file."""
    from repro_torch.core.executor import TaskLifecycle
    tree, meta = state
    assert meta.get("schema") == SCHEMA, \
        f"checkpoint schema {meta.get('schema')} != {SCHEMA}"
    assert meta["task"] == task_name, (meta["task"], task_name)
    assert int(meta["total_steps"]) == int(total_steps)
    assert set(meta["monitors"]) == set(jobs), "job set changed on restore"
    lc = TaskLifecycle(ex, task_name, jobs, total_steps, ee=ee,
                       max_slots=max_slots, batcher=batcher)
    lc._seed = _key_seed(tree["prng"])
    lc._admissions = int(meta["admissions"])
    lc.phase = meta["phase"]
    lc._wave_idx = int(meta["wave_idx"])
    lc._wave_step = int(meta["wave_step"])
    lc._cont_step = int(meta["cont_step"])
    lc._queue = list(meta["queue"])
    lc.steps_done = {j: int(v) for j, v in meta["steps_done"].items()}
    for j, st in meta["monitors"].items():
        _load_monitor(lc.monitors[j], st)
    lc._best_ckpt = _host_tree(dict(tree.get("best", {})))
    sm = meta["snap_meta"]
    for j, arrs in tree.get("snap", {}).items():
        arrs = _host_tree(arrs)
        lc.snapshots[j] = SlotSnapshot(
            job_id=j, lora=arrs["lora"], mu=arrs["mu"], nu=arrs["nu"],
            count=int(sm[j]["count"]), rank=int(sm[j]["rank"]),
            per_adapter_batch=int(sm[j]["b"]), seq_len=int(sm[j]["seq"]))
    for name, sb in _sub_batchers(batcher):
        bm = meta["batcher"][name]
        perms = tree["perm"][name]
        for z in range(sb.Z):
            rng = np.random.default_rng()
            rng.bit_generator.state = bm["rng"][z]
            sb._rngs[z] = rng
            sb._perm[z] = np.asarray(perms[str(z)])
            sb._cursor[z] = int(bm["cursor"][z])
            sb.epochs[z] = int(bm["epochs"][z])
    lc._t0 = time.time()
    for job_id, lane in meta["resident"]:
        lc._admit_job(job_id, lane=int(lane))
    return lc


# ---------------------------------------------------------------------------
# checkpoint driver
# ---------------------------------------------------------------------------

def _safe_name(task: str) -> str:
    return task.replace("/", "_").replace(":", "_")


class TaskCheckpointer:
    """Periodic atomic lifecycle checkpointing under ``state_dir/ckpt/``.

    Installed as ``BatchedExecutor.ckpt_hook``; fires every ``every``
    completed chunks. Keeps the last ``keep`` snapshots per task. If
    ``fail_after[task]`` (or the ``"*"`` wildcard) is set, raises
    ``SimulatedCrash`` once that many saves have landed for the task —
    AFTER the save is durable, mimicking a pod death at a boundary."""

    def __init__(self, state_dir: str, journal=None, every: int = 1,
                 keep: int = 2):
        self.dir = os.path.join(state_dir, "ckpt")
        os.makedirs(self.dir, exist_ok=True)
        self.journal = journal
        self.every = max(int(every), 1)
        self.keep = max(int(keep), 1)
        self.fail_after: Dict[str, int] = {}
        self.saves: Dict[str, int] = {}

    def on_chunk(self, lc, chunk_i: int) -> None:
        if lc.done or chunk_i % self.every != 0:
            return
        tdir = os.path.join(self.dir, _safe_name(lc.task_name))
        path = os.path.join(tdir, f"chunk-{chunk_i:06d}.npz")
        tree, meta = export_lifecycle(lc)
        meta["chunk"] = chunk_i
        save_state_tree(path, tree, meta)
        if self.journal is not None:
            self.journal.append({
                "rec": "ckpt", "task": lc.task_name, "path": path,
                "chunk": chunk_i,
                "remaining_steps_bound": meta["remaining_steps_bound"]})
        self._prune(tdir)
        self.saves[lc.task_name] = self.saves.get(lc.task_name, 0) + 1
        limit = self.fail_after.get(lc.task_name, self.fail_after.get("*"))
        if limit is not None and self.saves[lc.task_name] >= limit:
            raise SimulatedCrash(
                f"injected crash: task {lc.task_name!r} after "
                f"{self.saves[lc.task_name]} checkpoint saves")

    def _prune(self, tdir: str) -> None:
        snaps = sorted(glob.glob(os.path.join(tdir, "chunk-*.npz")))
        for old in snaps[:-self.keep]:
            try:
                os.remove(old)
            except OSError:
                pass

    def latest(self, task: str) -> Optional[str]:
        snaps = sorted(glob.glob(os.path.join(
            self.dir, _safe_name(task), "chunk-*.npz")))
        return snaps[-1] if snaps else None


def load_task_checkpoint(path: str) -> Optional[Tuple[Dict, Dict]]:
    """Load a lifecycle checkpoint, degrading corrupt or stale files to
    ``None`` (requeue from zero) instead of raising."""
    try:
        tree, meta = load_state_tree(path)
        if meta.get("schema") != SCHEMA:
            raise ValueError(f"schema {meta.get('schema')} != {SCHEMA}")
        return tree, meta
    except Exception as e:                        # noqa: BLE001
        log.warning("task checkpoint %s unreadable (%s): "
                    "falling back to requeue-from-zero", path, e)
        return None
