"""Synthetic task datasets: a copy of ``repro.data.synthetic``.

``make_task_dataset``, ``TaskDataset``, ``SlotBatcher`` and the DPO
``PairSlotBatcher`` are copied verbatim: for a given seed they give the
same tokens and the same batches as the JAX package's, so both packages
train and serve on identical data.

The paper's GSM8K/Tulu-3/
OpenThoughts3 are replaced by synthetic language-modeling *task families*
with controllable difficulty. Each task is a random order-1 Markov chain
over the model vocabulary with a task-specific low-entropy structure: a
model genuinely reduces loss by learning the transition matrix, a too-high
learning rate genuinely diverges, and a small dataset with multi-epoch
training genuinely overfits (train keeps dropping, val rises) — exactly the
three redundancy patterns of paper §3 Obs. 1, produced by the *dynamics*
rather than scripted.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TaskDataset:
    """One fine-tuning task's data: train/val token arrays."""
    name: str
    train: np.ndarray           # [N_train, S+1] int32
    val: np.ndarray             # [N_val, S+1] int32
    vocab_size: int
    seed: int

    @property
    def num_train(self) -> int:
        return len(self.train)


def make_task_dataset(name: str, vocab_size: int, seq_len: int,
                      num_train: int = 512, num_val: int = 64,
                      difficulty: float = 0.5, seed: int = 0) -> TaskDataset:
    """Sample a Markov-chain language task.

    ``difficulty`` in [0,1]: 0 => near-deterministic transitions (easy,
    fast-learnable), 1 => near-uniform (hard, high irreducible loss).
    """
    rng = np.random.default_rng(seed)
    V = vocab_size
    # sparse peaked transition structure over a vocabulary subset
    active = max(min(V, 256), 2)
    concentration = 0.05 + 4.0 * difficulty
    probs = rng.dirichlet(np.full(active, concentration), size=active)

    def sample(n: int, rng_) -> np.ndarray:
        out = np.empty((n, seq_len + 1), np.int32)
        state = rng_.integers(0, active, size=n)
        out[:, 0] = state
        # vectorized chain sampling
        cum = np.cumsum(probs, axis=1)
        for t in range(1, seq_len + 1):
            u = rng_.random(n)
            state = (u[:, None] < cum[state]).argmax(axis=1)
            out[:, t] = state
        return out

    train = sample(num_train, np.random.default_rng(seed + 1))
    val = sample(num_val, np.random.default_rng(seed + 2))
    return TaskDataset(name=name, train=train, val=val, vocab_size=V,
                       seed=seed)


class SlotBatcher:
    """Per-slot epoch-cycling batch streams, stacked to [Z, b, S].

    Each slot has its own cursor/shuffle (independent jobs). ``b`` is the
    slot's DEFAULT per-adapter batch size; ragged executors instead draw
    per-lane via ``lane_batch_dict(lane, n)`` with the occupying job's own
    width (paper §A.1 generalized to heterogeneous batch grouping). A
    lane's stream depends only on its own draw history — never on which
    other lanes exist or what they draw — which is what keeps a task's
    batches identical whether it runs alone or co-located.
    """

    def __init__(self, ds: TaskDataset, Z: int, per_adapter_batch: int,
                 seed: int = 0):
        self.ds = ds
        self.Z = Z
        self.b = per_adapter_batch
        self._rngs = [np.random.default_rng(seed * 1000 + z)
                      for z in range(Z)]
        self._perm = [self._rngs[z].permutation(ds.num_train)
                      for z in range(Z)]
        self._cursor = [0] * Z
        self.epochs = [0] * Z

    @property
    def seq_len(self) -> int:
        return self.ds.train.shape[1] - 1

    def reset_slot(self, z: int, seed: Optional[int] = None) -> None:
        if seed is not None:
            self._rngs[z] = np.random.default_rng(seed)
        self._perm[z] = self._rngs[z].permutation(self.ds.num_train)
        self._cursor[z] = 0
        self.epochs[z] = 0

    def take(self, z: int, n: int) -> np.ndarray:
        """Draw n rows from lane z's stream (epoch-cycling): [n, S+1]."""
        idx = []
        while len(idx) < n:
            grab = min(n - len(idx), self.ds.num_train - self._cursor[z])
            idx.extend(self._perm[z][self._cursor[z]:self._cursor[z] + grab])
            self._cursor[z] += grab
            if self._cursor[z] >= self.ds.num_train:
                self._perm[z] = self._rngs[z].permutation(self.ds.num_train)
                self._cursor[z] = 0
                self.epochs[z] += 1
        return self.ds.train[np.asarray(idx)]

    def _slot_batch(self, z: int) -> np.ndarray:
        return self.take(z, self.b)

    def lane_batch_dict(self, lane: int, n: int) -> dict:
        """One lane's ragged draw: {tokens [n,S], labels [n,S]}."""
        rows = self.take(lane, n)
        return {"tokens": rows[:, :-1].astype(np.int32),
                "labels": rows[:, 1:].astype(np.int32)}

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (tokens [Z,b,S], labels [Z,b,S])."""
        rows = np.stack([self._slot_batch(z) for z in range(self.Z)])
        return rows[:, :, :-1].astype(np.int32), rows[:, :, 1:].astype(np.int32)

    def val_batch(self, max_rows: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Validation batch, same rows for every slot: [Z, n, S] x2."""
        rows = self.ds.val[:max_rows]
        n = (len(rows) // self.b) * self.b or len(rows)
        rows = rows[:max(n, 1)]
        stacked = np.broadcast_to(
            rows[None], (self.Z, *rows.shape)).copy()
        return (stacked[:, :, :-1].astype(np.int32),
                stacked[:, :, 1:].astype(np.int32))

    # dict interfaces (shared with the DPO pair batcher)
    def next_batch_dict(self) -> dict:
        t, l = self.next_batch()
        return {"tokens": t, "labels": l}

    def val_batch_dict(self, max_rows: int = 64) -> dict:
        t, l = self.val_batch(max_rows)
        return {"tokens": t, "labels": l}


class PairSlotBatcher:
    """Preference-pair batches for DPO (paper §8.2 RL end-to-end).

    'Chosen' sequences come from the task's low-entropy chain; 'rejected'
    from a higher-entropy (noisier) chain over the same vocabulary — a
    synthetic preference structure a DPO adapter genuinely learns to
    separate."""

    def __init__(self, chosen: TaskDataset, rejected: TaskDataset, Z: int,
                 per_adapter_batch: int, seed: int = 0):
        self.chosen = SlotBatcher(chosen, Z, per_adapter_batch, seed=seed)
        self.rejected = SlotBatcher(rejected, Z, per_adapter_batch,
                                    seed=seed + 7)
        self.Z, self.b = Z, per_adapter_batch
        self.epochs = self.chosen.epochs

    @property
    def seq_len(self) -> int:
        return self.chosen.seq_len

    def reset_slot(self, z: int, seed=None) -> None:
        self.chosen.reset_slot(z, seed)
        self.rejected.reset_slot(z, seed)

    def lane_batch_dict(self, lane: int, n: int) -> dict:
        c = self.chosen.lane_batch_dict(lane, n)
        r = self.rejected.lane_batch_dict(lane, n)
        return {"tokens_chosen": c["tokens"], "labels_chosen": c["labels"],
                "tokens_rejected": r["tokens"],
                "labels_rejected": r["labels"]}

    def next_batch_dict(self) -> dict:
        tc, lc = self.chosen.next_batch()
        tr, lr = self.rejected.next_batch()
        return {"tokens_chosen": tc, "labels_chosen": lc,
                "tokens_rejected": tr, "labels_rejected": lr}

    def val_batch_dict(self, max_rows: int = 64) -> dict:
        tc, lc = self.chosen.val_batch(max_rows)
        tr, lr = self.rejected.val_batch(max_rows)
        n = min(tc.shape[1], tr.shape[1])
        return {"tokens_chosen": tc[:, :n], "labels_chosen": lc[:, :n],
                "tokens_rejected": tr[:, :n], "labels_rejected": lr[:, :n]}
