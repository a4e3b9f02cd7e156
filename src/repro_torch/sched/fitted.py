"""Profile-fitted cost models: least-squares (k0, k1, k2) from observed steps.

A verbatim copy of ``repro.sched.fitted`` (numpy only), over the port's
``profiler`` and ``intra_task``: the port imports nothing of the JAX
package.

The analytic models in ``profiler.py`` (roofline step time) and
``intra_task.py`` (M_hat memory accounting) derive their coefficients from
FLOP counts and target-hardware constants. This module fits the SAME linear
structures from the raw ``StepObservation`` points ``ProfileStore`` now
accumulates per ``(arch, gpus)`` key —

    step_time(tokens, rank_tokens) = k0 + k1*tokens + k2*rank_tokens
    M_hat(tokens, rank_tokens)     = k0 + k1*tokens + k2*rank_tokens

— so once a session has watched enough real fused steps, admission density
(``admit_cross_task`` / executor backfill / ``plan_fused``) and fused-step
duration budgeting are driven by measured hardware behavior instead of
modeled behavior. The swap lives behind ``fitted=True`` on
``Engine``/``TuningService``; the analytic models remain both the default
and the fallback whenever a key has fewer than ``MIN_OBSERVATIONS`` points
or the fit is degenerate (rank-deficient design, e.g. every observed step
at one width — extrapolating from that would be worse than the roofline).

Coefficients are clamped non-negative by column-drop refit: a negative
``k2`` from collinear data would tell admission that MORE rank is FREE
memory/time, which inverts the §A.3 budget's safety direction. A dropped
column contributes 0 — exactly the rank-neutral/intercept-free special
cases the analytic models already handle.

Fits are cached through the ProfileStore's *versioned* spec cache, which
``record_step`` invalidates — every new observation transparently
re-derives the model on next use, the same freshness contract the engine's
profile specs already rely on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.sched import profiler
from repro_torch.sched.intra_task import MemoryModel

# Below this many points a 3-coefficient fit chases noise; the analytic
# model is the better estimator. Deliberately larger than the coefficient
# count so the residual is a meaningful generalization signal.
MIN_OBSERVATIONS = 8


def _lstsq_nonneg(X: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Least squares with non-negative coefficients via column-drop refit:
    solve OLS; while any coefficient is negative, zero the most negative
    one, remove its column, and re-solve the rest. (Full NNLS machinery is
    overkill for a 3-column design; this preserves the safety direction —
    see module docstring — at worst by under-using one regressor.)"""
    n = X.shape[1]
    active = list(range(n))
    coef = np.zeros(n)
    while active:
        sol, *_ = np.linalg.lstsq(X[:, active], y, rcond=None)
        if np.all(sol >= 0):
            for i, c in zip(active, sol):
                coef[i] = c
            return coef
        active.pop(int(np.argmin(sol)))
    return coef


def _design(observations: Sequence[profiler.StepObservation]
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    X = np.asarray([[1.0, o.tokens, o.rank_tokens] for o in observations],
                   np.float64)
    y = np.asarray([o.wall_s for o in observations], np.float64)
    return X, y, np.asarray([o.peak_memory for o in observations
                             if o.peak_memory is not None], np.float64)


def _degenerate(X: np.ndarray) -> bool:
    """True when the design cannot identify 3 coefficients: fewer distinct
    (tokens, rank_tokens) rows than coefficients, or a numerically
    rank-deficient column space (e.g. rank_tokens a fixed multiple of
    tokens — every step at one rank)."""
    distinct = len({(r[1], r[2]) for r in X.tolist()})
    if distinct < X.shape[1]:
        return True
    return np.linalg.matrix_rank(X, tol=1e-9 * max(np.abs(X).max(), 1.0)) \
        < X.shape[1]


@dataclasses.dataclass(frozen=True)
class FittedStepModel:
    """Fused-step wall time fitted from observed steps:
    ``k0 + k1*tokens + k2*rank_tokens`` seconds. ``k2`` is the per-rank-
    token cost the analytic roofline could only infer from FLOP counts —
    here it is the measured slope, i.e. what the ROADMAP's "fitted k2"
    item asks for."""
    k0: float                 # fixed per-step overhead (s)
    k1: float                 # s per real token (frozen backbone)
    k2: float                 # s per rank-weighted FLOP-token (adapters)
    observations: int
    rms_rel_error: float      # training-set relative RMS residual

    def predict(self, tokens: float, rank_tokens: float) -> float:
        return max(self.k0 + self.k1 * tokens + self.k2 * rank_tokens,
                   1e-12)

    def step_time(self, slot_tokens: Sequence[float],
                  ranks: Sequence[float]) -> float:
        """Drop-in for ``profiler.fused_step_time``'s slot interface."""
        tokens = float(sum(slot_tokens))
        rtok = float(sum(t * r for t, r in zip(slot_tokens, ranks)))
        return self.predict(tokens, rtok)


def fit_step_model(observations: Sequence[profiler.StepObservation],
                   min_observations: int = MIN_OBSERVATIONS
                   ) -> Optional[FittedStepModel]:
    """Least-squares (k0, k1, k2) over raw step observations, or None when
    the data cannot support the fit (the caller falls back to analytic)."""
    if len(observations) < max(min_observations, 3):
        return None
    X, y, _ = _design(observations)
    if _degenerate(X):
        return None
    coef = _lstsq_nonneg(X, y)
    pred = X @ coef
    rel = (pred - y) / np.maximum(np.abs(y), 1e-12)
    return FittedStepModel(k0=float(coef[0]), k1=float(coef[1]),
                           k2=float(coef[2]),
                           observations=len(observations),
                           rms_rel_error=float(np.sqrt(np.mean(rel ** 2))))


def fit_memory_model_ranked(
        observations: Sequence[profiler.StepObservation],
        analytic: MemoryModel,
        min_observations: int = MIN_OBSERVATIONS) -> Optional[MemoryModel]:
    """Fit the rank-aware M_hat (bytes = k0 + k1*tokens + k2*rank_tokens)
    from observed peak memory, keeping the analytic model's capacity /
    safety margin / seq_len / r_max frame (those are device facts, not
    fit targets). None when too few memory-bearing points or degenerate."""
    pts = [o for o in observations if o.peak_memory is not None]
    if len(pts) < max(min_observations, 3):
        return None
    X, _, m = _design(pts)
    if _degenerate(X):
        return None
    coef = _lstsq_nonneg(X, m)
    k2 = float(coef[2])
    if analytic.r_max <= 0:
        # a rank-aware model must know what to bill rank-unknown requests
        # (MemoryModel.__post_init__); without an r_max frame, fold the
        # rank term away rather than under-bill at rank 1
        k2 = 0.0
    return MemoryModel(k0=float(coef[0]), k1=float(coef[1]),
                       seq_len=analytic.seq_len,
                       capacity=analytic.capacity,
                       safety_margin=analytic.safety_margin,
                       k2=k2, r_max=analytic.r_max)


# ---------------------------------------------------------------------------
# Store-backed cached accessors (the fitted=True wiring surface)
# ---------------------------------------------------------------------------

def fitted_step_model(store: profiler.ProfileStore, key: Tuple,
                      min_observations: int = MIN_OBSERVATIONS
                      ) -> Optional[FittedStepModel]:
    """The fitted step model for a profile key, or None below the
    observation guard. Cached in the store's versioned spec cache, so
    every ``record_step`` transparently invalidates and the next call
    re-fits over the grown observation set."""
    cache_key = ("fitted_step", key, min_observations)
    hit = store.get_spec(cache_key)
    if hit is not None:
        return hit if isinstance(hit, FittedStepModel) else None
    model = fit_step_model(store.step_observations(key), min_observations)
    # cache negative results too (False sentinel: None means "cache miss")
    store.put_spec(cache_key, model if model is not None else False)
    return model


def fitted_memory_model(store: profiler.ProfileStore, key: Tuple,
                        analytic: MemoryModel,
                        min_observations: int = MIN_OBSERVATIONS
                        ) -> MemoryModel:
    """The memory model admission should budget against: the fitted
    rank-aware M_hat when the key has enough memory observations, else
    ``analytic`` unchanged. This is the single choke point behind
    ``Engine(fitted=True).memory_model`` — the returned model flows into
    ``ColocationSpec.mem`` and from there into ``admit_cross_task``,
    executor backfill, and (linearized into ``ReplicaState``)
    ``plan_fused``, so all three §A.3 layers budget from the same measured
    coefficients."""
    cache_key = ("fitted_mem", key, min_observations)
    hit = store.get_spec(cache_key)
    if hit is not None:
        return hit if isinstance(hit, MemoryModel) else analytic
    model = fit_memory_model_ranked(store.step_observations(key), analytic,
                                    min_observations)
    store.put_spec(cache_key, model if model is not None else False)
    return model if model is not None else analytic


def fitted_fused_step_time(cfg, slot_tokens: Sequence[float],
                           ranks: Sequence[float], chips: int, *,
                           store: Optional[profiler.ProfileStore] = None,
                           key: Optional[Tuple] = None, mfu: float = 0.4,
                           min_observations: int = MIN_OBSERVATIONS
                           ) -> float:
    """``profiler.fused_step_time`` with the fitted model swapped in when
    the key has enough observations — the analytic roofline otherwise
    (also whenever no store/key is given, so it is a safe drop-in)."""
    model = (fitted_step_model(store, key, min_observations)
             if store is not None and key is not None else None)
    if model is None:
        return profiler.fused_step_time(cfg, slot_tokens, ranks, chips,
                                        mfu=mfu)
    return model.step_time(slot_tokens, ranks)


def observe_fused_step(store: profiler.ProfileStore, key: Tuple, *,
                       slot_tokens: Sequence[float],
                       ranks: Sequence[float], wall_s: float,
                       peak_memory: Optional[float] = None) -> None:
    """Record one fused step in the shape the fitters consume (the
    service's ``_feedback`` hook): collapses per-slot widths/ranks to the
    (tokens, rank_tokens) regressors."""
    tokens = float(sum(slot_tokens))
    rtok = float(sum(t * r for t, r in zip(slot_tokens, ranks)))
    store.record_step(key, tokens=tokens, rank_tokens=rtok, wall_s=wall_s,
                      peak_memory=peak_memory)
