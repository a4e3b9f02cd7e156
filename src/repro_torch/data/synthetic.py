"""Synthetic task datasets: a copy of ``repro.data.synthetic``'s sampler.

Only ``make_task_dataset`` and ``TaskDataset`` are copied (the serving CLI
draws its prompts from them); for a given seed they give the same tokens as
the JAX package's copy, so both CLIs serve the same prompts.

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
