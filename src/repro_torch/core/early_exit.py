"""Loss-aware early exit (paper §5, Algorithm 1).

A verbatim copy of ``repro.core.early_exit`` (numpy only): the port imports
nothing of the JAX package.

Host-side controller over per-job loss trajectories:

  Pattern-1 Divergence: linear-regression slopes over the last ``w`` EMA'd
    train losses AND raw val losses both >= tau_slope for p_div consecutive
    evaluation steps -> EXIT(diverging). Patience resets when either slope
    drops below tau_slope.
  Pattern-2 Overfitting: gap ratio g = (val - ema_train)/ema_train >
    tau_gap for p_ovf consecutive evaluation steps -> checkpoint best-val
    model, EXIT(overfitting). Transient fluctuations reset the counter.
  Pattern-3 Underperformance: at the warmup boundary, rank survivors by
    val loss, keep top ceil(select_ratio * K) -> others EXIT(underperforming).

Defaults mirror the paper's evaluation: w=2, p=2, tau_gap=0.1,
tau_slope=0.001, warmup 5% of total steps, 25% selection ratio.
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class ExitReason(enum.Enum):
    DIVERGING = "diverging"
    OVERFITTING = "overfitting"
    UNDERPERFORMING = "underperforming"
    COMPLETED = "completed"


@dataclasses.dataclass(frozen=True)
class EarlyExitConfig:
    ema_alpha: float = 0.3
    window: int = 2                 # w
    tau_slope: float = 0.001
    tau_gap: float = 0.1
    patience_div: int = 2           # p_div
    patience_ovf: int = 2           # p_ovf
    warmup_ratio: float = 0.05
    select_ratio: float = 0.25
    enabled: bool = True

    def warmup_steps(self, total_steps: int) -> int:
        return max(int(math.ceil(self.warmup_ratio * total_steps)), 1)

    def top_k(self, num_candidates: int) -> int:
        return max(int(math.ceil(self.select_ratio * num_candidates)), 1)


def linreg_slope(ys: Sequence[float]) -> float:
    """OLS slope of ys against 0..n-1 (n>=2)."""
    n = len(ys)
    if n < 2:
        return 0.0
    x = np.arange(n, dtype=np.float64)
    y = np.asarray(ys, np.float64)
    xm, ym = x.mean(), y.mean()
    denom = np.sum((x - xm) ** 2)
    return float(np.sum((x - xm) * (y - ym)) / max(denom, 1e-12))


@dataclasses.dataclass
class ExitDecision:
    reason: ExitReason
    step: int
    best_val: float
    best_val_step: int


class JobMonitor:
    """Per-job loss-trajectory state (Algorithm 1 lines 1-14)."""

    def __init__(self, cfg: EarlyExitConfig, job_id: str):
        self.cfg = cfg
        self.job_id = job_id
        self.ema_train: Optional[float] = None
        self.ema_hist: List[float] = []       # EMA'd train losses at evals
        self.val_hist: List[float] = []
        self.raw_train_hist: List[float] = []
        self.cnt_div = 0
        self.cnt_ovf = 0
        self.best_val = float("inf")
        self.best_val_step = -1
        self.steps_trained = 0
        self.exited: Optional[ExitDecision] = None

    # ---- observations ----------------------------------------------------
    def observe_train(self, loss: float) -> None:
        self.steps_trained += 1
        self.raw_train_hist.append(float(loss))
        a = self.cfg.ema_alpha
        if self.ema_train is None or not math.isfinite(self.ema_train):
            self.ema_train = float(loss)
        else:
            self.ema_train = a * float(loss) + (1 - a) * self.ema_train

    def observe_val(self, val_loss: float, step: int
                    ) -> Optional[ExitDecision]:
        """Record an evaluation point and run pattern detection."""
        v = float(val_loss)
        self.val_hist.append(v)
        self.ema_hist.append(self.ema_train if self.ema_train is not None
                             else v)
        if v < self.best_val:
            self.best_val = v
            self.best_val_step = step
        if not self.cfg.enabled:
            return None
        # non-finite loss = immediate divergence exit
        if not math.isfinite(v) or not math.isfinite(self.ema_hist[-1]):
            return self._exit(ExitReason.DIVERGING, step)
        d = self._detect_divergence(step)
        if d is not None:
            return d
        return self._detect_overfitting(step)

    # ---- Pattern 1: divergence -------------------------------------------
    def _detect_divergence(self, step: int) -> Optional[ExitDecision]:
        w = self.cfg.window
        if len(self.ema_hist) >= w and len(self.val_hist) >= w:
            s_train = linreg_slope(self.ema_hist[-w:])
            s_val = linreg_slope(self.val_hist[-w:])
            if s_train >= self.cfg.tau_slope and s_val >= self.cfg.tau_slope:
                self.cnt_div += 1
            else:
                self.cnt_div = 0
            if self.cnt_div >= self.cfg.patience_div:
                return self._exit(ExitReason.DIVERGING, step)
        return None

    # ---- Pattern 2: overfitting --------------------------------------------
    def _detect_overfitting(self, step: int) -> Optional[ExitDecision]:
        ema = self.ema_hist[-1]
        g = (self.val_hist[-1] - ema) / max(abs(ema), 1e-12)
        if g > self.cfg.tau_gap:
            self.cnt_ovf += 1
        else:
            self.cnt_ovf = 0
        if self.cnt_ovf >= self.cfg.patience_ovf:
            return self._exit(ExitReason.OVERFITTING, step)
        return None

    def _exit(self, reason: ExitReason, step: int) -> ExitDecision:
        self.exited = ExitDecision(reason, step, self.best_val,
                                   self.best_val_step)
        return self.exited


def warmup_select(monitors: Dict[str, JobMonitor], cfg: EarlyExitConfig,
                  num_candidates: Optional[int] = None
                  ) -> Tuple[List[str], List[str]]:
    """Pattern-3 at the warmup boundary: rank surviving jobs by latest val
    loss, keep top ceil(select_ratio * K). Returns (kept, evicted) ids."""
    alive = {j: m for j, m in monitors.items()
             if m.exited is None and m.val_hist}
    k = cfg.top_k(num_candidates if num_candidates is not None
                  else len(alive))
    ranked = sorted(alive, key=lambda j: alive[j].val_hist[-1])
    return ranked[:k], ranked[k:]
