"""Task profiling: duration estimates + analytic memory accounting.

A copy of ``repro.sched.profiler`` with the target constants of one NVIDIA
H100 in place of the TPU v5e's, and ``measure_throughput`` synced with
``torch.cuda.synchronize``; the rest (the analytic models, the lifecycle
estimates, ``ProfileStore`` and its JSON save and load) is verbatim. The
port imports nothing of the JAX package.

Paper §7.2: before scheduling, a short profiling run measures throughput
(samples/s); duration = total_samples / throughput. GPU requirement comes
from the base-model size. Results are cached per (arch, b, seq).

Two estimators coexist:
  * ``measure_throughput``: real wall-clock over a few steps of the actual
    train step;
  * ``analytic_step_time``: roofline-based estimate from FLOPs and the
    target-hardware constants (used for production-scale what-if schedules
    and the scheduler benchmarks).

Layer contract: estimates produced here are UPPER BOUNDS that only shrink
as observation replaces analysis (the ProfileStore feedback loop) — the
elastic runtime's adoption rule and the fusion anomaly guard both assume
residual durations never grow, and a replica's projected end must be
recomputed from live residuals whenever a guest departs (eviction,
migration, cancel), never reused from admission time.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import ModelConfig

# NVIDIA H100 SXM target constants (per card, NVIDIA data sheet): dense
# bf16 tensor-core peak, HBM3 bandwidth and the data sheet's 80 GB (74.5
# GiB, under what the card reports). The reference's interconnect rate has
# no counterpart: nothing in either package reads it.
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
HBM_BYTES = 80e9


def train_step_flops(cfg: ModelConfig, total_batch: int, seq_len: int,
                     lora_rank: int = 0) -> float:
    """~6 * N_active * tokens for fwd+bwd... except base is FROZEN: base
    weights take fwd (2ND) + activation-grad bwd (2ND) but no weight-grad
    pass => 4ND; LoRA params take the full 6ND' (tiny)."""
    tokens = total_batch * seq_len
    n_base = cfg.param_count(active_only=True)
    n_lora = cfg.lora_param_count(lora_rank) if lora_rank else 0
    return (4.0 * n_base + 6.0 * n_lora) * tokens


def analytic_step_time(cfg: ModelConfig, total_batch: int, seq_len: int,
                       chips: int, mfu: float = 0.4,
                       lora_rank: int = 16) -> float:
    """Roofline-style estimate of one train step (seconds)."""
    f = train_step_flops(cfg, total_batch, seq_len, lora_rank)
    compute = f / (chips * PEAK_FLOPS_BF16 * mfu)
    # memory floor: every base weight read at least twice (fwd+bwd)
    bytes_moved = 2 * 2 * cfg.param_count(active_only=True)
    memory = bytes_moved / (chips * HBM_BYTES_PER_S)
    return max(compute, memory)


def fused_step_flops(cfg: ModelConfig, slot_tokens: "Sequence[int]",
                     ranks: "Sequence[int]") -> float:
    """Rank-local fused-step FLOPs for one shared-backbone replica:
    frozen base at 4ND over the total real tokens, plus each slot's LoRA
    GEMMs at its TRUE rank (6 * N_lora(r_z) * tokens_z). Rank-MASKED
    execution charges every slot r_max here — the gap between the two is
    exactly the tensor-core work the dead rank-tile skip reclaims."""
    total = sum(slot_tokens)
    f = 4.0 * cfg.param_count(active_only=True) * total
    for t, r in zip(slot_tokens, ranks):
        f += 6.0 * cfg.lora_param_count(int(r)) * t
    return f


def fused_step_time(cfg: ModelConfig, slot_tokens: "Sequence[int]",
                    ranks: "Sequence[int]", chips: int,
                    mfu: float = 0.4) -> float:
    """Roofline-style fused-step seconds under rank-local compute (the
    §A.3 rank-aware duration estimate). Pass ``ranks = [r_max] * Z`` for
    the rank-masked baseline."""
    f = fused_step_flops(cfg, slot_tokens, ranks)
    compute = f / (chips * PEAK_FLOPS_BF16 * mfu)
    bytes_moved = 2 * 2 * cfg.param_count(active_only=True)
    memory = bytes_moved / (chips * HBM_BYTES_PER_S)
    return max(compute, memory)


def analytic_peak_memory(cfg: ModelConfig, Z: int, b: int, seq_len: int,
                         chips: int = 1, rank: int = 16) -> float:
    """Bytes per chip: params + adapters/opt + remat activations.

    Linear in total batch B=Z*b (the structure the paper's M_hat fits).
    """
    base = 2 * cfg.param_count() / chips                   # bf16, sharded
    # fp32 master + two fp32 moments per adapter param, Z adapters
    adapters = (4 + 8) * cfg.lora_param_count(rank) * Z / chips
    # remat: residual checkpoints per layer + one layer's working set
    tokens = Z * b * seq_len / chips
    act = 2 * tokens * cfg.d_model * (cfg.num_layers + 6)
    return base + adapters + act


@dataclasses.dataclass
class TaskProfile:
    samples_per_s: float
    step_time_s: float
    peak_memory: float


_CACHE: Dict[Tuple, TaskProfile] = {}


def _block_until_ready(out) -> None:
    """Wait for the card's work behind ``out`` (a tensor or a nest of
    dicts, lists and tuples of them) when any of it is on the card."""
    import torch
    todo, on_card = [out], False
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            on_card = on_card or x.is_cuda
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (list, tuple)):
            todo.extend(x)
    if on_card:
        torch.cuda.synchronize()


def measure_throughput(step_fn: Callable, args: tuple, total_batch: int,
                       warmup: int = 1, iters: int = 3,
                       repeats: int = 3) -> TaskProfile:
    """Wall-clock a step function.

    ``warmup`` iterations run first (compile + caches land outside the
    timed region) and the timed loop runs ``repeats`` times, reporting the
    MEDIAN per-step time — a single timing is at the mercy of a GC pause
    or a noisy neighbor, and the autotuner picks tile-plan winners off
    these numbers, so one outlier must not crown a candidate. The card's
    work is waited for (``torch.cuda.synchronize``) at the end of the
    warmup and of each timed loop; a step whose outputs are all on the CPU
    has nothing to wait for."""
    out = None
    for _ in range(max(warmup, 1)):
        out = step_fn(*args)
    _block_until_ready(out)
    samples = []
    for _ in range(max(repeats, 1)):
        t0 = time.time()
        for _ in range(iters):
            out = step_fn(*args)
        _block_until_ready(out)
        samples.append((time.time() - t0) / iters)
    samples.sort()
    dt = samples[len(samples) // 2] if len(samples) % 2 else (
        samples[len(samples) // 2 - 1] + samples[len(samples) // 2]) / 2
    dt = max(dt, 1e-12)
    return TaskProfile(samples_per_s=total_batch / dt, step_time_s=dt,
                       peak_memory=0.0)


def profile_task(cfg: ModelConfig, Z: int, b: int, seq_len: int,
                 chips: int, *, mfu: float = 0.4, rank: int = 16
                 ) -> TaskProfile:
    """Cached analytic profile for scheduler duration estimates."""
    key = (cfg.name, Z, b, seq_len, chips, mfu, rank)
    if key not in _CACHE:
        st = analytic_step_time(cfg, Z * b, seq_len, chips,
                                mfu=mfu, lora_rank=rank)
        _CACHE[key] = TaskProfile(
            samples_per_s=Z * b / st, step_time_s=st,
            peak_memory=analytic_peak_memory(cfg, Z, b, seq_len, chips,
                                             rank))
    return _CACHE[key]


# --------------------------------------------------------------------------
# Lifecycle duration (re-)estimation (elastic runtime, paper §7.2)
# --------------------------------------------------------------------------

def lifecycle_steps(K: int, Z: int, warmup_steps: int, total_steps: int,
                    survivors: Optional[int] = None) -> int:
    """Worst-case executor steps for the ALTO per-task lifecycle:
    ceil(K/Z) warmup waves, then the survivors packed onto Z slots for the
    remaining budget. ``survivors=None`` means the warmup boundary has not
    been reached yet and no pattern exits are assumed (the scheduler's
    worst case) — but Pattern-3 selection is deterministic, so even the
    worst case retains only ``survivors`` jobs once that count is known."""
    if K <= 0:
        return 0
    Z = max(Z, 1)
    warmup_steps = max(min(warmup_steps, total_steps), 0)
    s = K if survivors is None else max(min(survivors, K), 0)
    waves = -(-K // Z)                      # ceil
    cont_waves = -(-s // Z) if s else 0
    return waves * warmup_steps + cont_waves * (total_steps - warmup_steps)


def residual_duration(steps_remaining: float, step_time_s: float) -> float:
    """Seconds of residual work from an executor-step bound."""
    return max(float(steps_remaining), 0.0) * step_time_s


def reestimate_duration(step_time_s: float, K: int, Z: int,
                        warmup_steps: int, total_steps: int,
                        survivors: int) -> float:
    """Duration re-estimate after the warmup boundary reported ``survivors``
    jobs continuing (warmup-selection drops and divergence exits both lower
    it). The elastic runtime feeds this into residual re-solves so freed
    capacity is reclaimed immediately instead of at the static plan's
    worst-case boundaries."""
    steps = lifecycle_steps(K, Z, warmup_steps, total_steps,
                            survivors=survivors)
    return residual_duration(steps, step_time_s)


# --------------------------------------------------------------------------
# Profiler feedback loop (service sessions, paper §7.2 / ROADMAP item)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ProfileRecord:
    """Observed execution statistics for one profile key (EMA-smoothed).

    ``wall_token_time_s`` is the per-TOKEN wall time: with ragged slot
    widths two fused steps can differ several-fold in token throughput,
    so per-step wall time alone mis-calibrates duration estimates on
    heterogeneous mixes — tokens are the width-invariant denominator."""
    duration_frac: float      # realized_duration / estimated_duration
    wall_step_time_s: Optional[float] = None  # realized host per-step seconds
    wall_token_time_s: Optional[float] = None  # realized host per-token secs
    observations: int = 0


@dataclasses.dataclass(frozen=True)
class StepObservation:
    """One observed fused step: its real token load, rank-weighted token
    load, wall seconds, and (when the platform reports it) peak memory.
    The raw points — not an EMA — because the fitted cost model
    (``sched/fitted.py``) least-squares (k0, k1, k2) over them, and a
    smoothed scalar cannot recover per-coefficient structure."""
    tokens: float
    rank_tokens: float
    wall_s: float
    peak_memory: Optional[float] = None


MAX_STEP_OBSERVATIONS = 512      # per key; oldest evicted first


class ProfileStore:
    """Session-scoped feedback store closing the profiler loop.

    Four layers:

      * **Observed records** keyed by an arch-level profile key (e.g.
        ``(cfg.name, gpus)``): every completed task reports its realized
        step time and realized/estimated duration ratio. Later admissions
        in the same session consult ``step_time``/``duration_scale`` so
        they are scheduled from observed rather than analytic estimates
        (early exits make worst-case analytic durations systematically
        pessimistic — paper Fig. 9 reports 72-83% sample savings).
      * **Step observations** (``record_step``): raw per-step (tokens,
        rank_tokens, wall_s, peak_memory) points per key, the training
        set for the fitted (k0, k1, k2) step-time / memory models in
        ``sched/fitted.py``. Persisted.
      * **Spec cache** keyed by ``(task_name, early-exit signature)``:
        ``Engine.schedule`` and ``Engine.batched_execution`` profile the
        same tasks back to back; the cache de-duplicates that work. Cache
        entries are versioned — any new observation invalidates previously
        computed specs so feedback takes effect immediately.
      * **Durable specs** (``put_spec(..., durable=True)``): entries that
        are NOT derived from observations — tile-plan autotune winners —
        so they survive version bumps and are JSON-persisted by ``save``
        (later sessions skip the sweep entirely). Durable specs must be
        JSON-representable.
    """

    def __init__(self, ema: float = 0.5):
        assert 0.0 < ema <= 1.0
        self.ema = ema
        self._records: Dict[Tuple, ProfileRecord] = {}
        self._specs: Dict[Tuple, Tuple[int, object]] = {}
        self._durable_specs: Dict[Tuple, object] = {}
        self._steps: Dict[Tuple, List[StepObservation]] = {}
        self._version = 0

    # ---- observed records --------------------------------------------------
    def record(self, key: Tuple, *, realized_duration: float,
               estimated_duration: float,
               wall_step_time_s: Optional[float] = None,
               wall_token_time_s: Optional[float] = None) -> None:
        """Log one completed task. ``realized/estimated`` must both be in
        the session's *virtual* timeline and the estimate must be the
        UNSCALED worst case (recording vs an already-scaled estimate would
        compound the ratio). Wall step/token times are the only host-clock
        quantities; virtual step times are never recorded — for real
        executors the realized virtual step time IS the analytic one, so
        an observation would be circular. Per-token wall time is the
        calibrated quantity for ragged (mixed-width) fused steps."""
        frac = (realized_duration / estimated_duration
                if estimated_duration > 0 else 1.0)
        frac = min(max(frac, 0.0), 1.0)     # estimates are upper bounds

        def ema(new, old):
            if new is None:
                return old
            if old is None:
                return new
            return self.ema * new + (1 - self.ema) * old

        prev = self._records.get(key)
        if prev is None:
            self._records[key] = ProfileRecord(
                duration_frac=frac, wall_step_time_s=wall_step_time_s,
                wall_token_time_s=wall_token_time_s,
                observations=1)
        else:
            self._records[key] = ProfileRecord(
                duration_frac=ema(frac, prev.duration_frac),
                wall_step_time_s=ema(wall_step_time_s,
                                     prev.wall_step_time_s),
                wall_token_time_s=ema(wall_token_time_s,
                                      prev.wall_token_time_s),
                observations=prev.observations + 1)
        self._version += 1                  # invalidates all cached specs

    def wall_step_time(self, key: Tuple) -> Optional[float]:
        """Realized host seconds per executor step (observability; kept
        out of the virtual timeline on purpose)."""
        rec = self._records.get(key)
        return rec.wall_step_time_s if rec is not None else None

    def wall_token_time(self, key: Tuple) -> Optional[float]:
        """Realized host seconds per REAL token trained (padding
        excluded) — width-invariant, so it stays calibrated when fused
        steps mix heterogeneous per-adapter batch sizes."""
        rec = self._records.get(key)
        return rec.wall_token_time_s if rec is not None else None

    def duration_scale(self, key: Tuple) -> float:
        """Multiplier for analytic worst-case durations (1.0 = no data)."""
        rec = self._records.get(key)
        return rec.duration_frac if rec is not None else 1.0

    def scaled_duration(self, key: Tuple, duration: float) -> float:
        """Apply the observed realized/worst-case ratio to an UNSCALED
        worst-case duration (single scaling point for engine + service)."""
        scale = self.duration_scale(key)
        if scale >= 1.0:
            return duration
        return max(duration * scale, 1e-9)

    def observations(self, key: Tuple) -> int:
        rec = self._records.get(key)
        return rec.observations if rec is not None else 0

    # ---- raw step observations (fitted cost model's training set) ----------
    def record_step(self, key: Tuple, *, tokens: float, rank_tokens: float,
                    wall_s: float, peak_memory: Optional[float] = None
                    ) -> None:
        """Log one observed fused step. Unlike ``record``, points are kept
        raw (bounded FIFO per key) — ``sched/fitted.py`` least-squares the
        (k0, k1, k2) step-time and memory models over them, which needs
        the per-point (tokens, rank_tokens) structure an EMA destroys."""
        obs = self._steps.setdefault(key, [])
        obs.append(StepObservation(tokens=float(tokens),
                                   rank_tokens=float(rank_tokens),
                                   wall_s=float(wall_s),
                                   peak_memory=(None if peak_memory is None
                                                else float(peak_memory))))
        if len(obs) > MAX_STEP_OBSERVATIONS:
            del obs[:len(obs) - MAX_STEP_OBSERVATIONS]
        self._version += 1              # fitted specs must re-derive

    def step_observations(self, key: Tuple) -> List[StepObservation]:
        return list(self._steps.get(key, ()))

    def step_observation_count(self, key: Tuple) -> int:
        return len(self._steps.get(key, ()))

    # ---- spec cache --------------------------------------------------------
    def get_spec(self, key: Tuple):
        if key in self._durable_specs:
            return self._durable_specs[key]
        hit = self._specs.get(key)
        if hit is None or hit[0] != self._version:
            return None
        return hit[1]

    def put_spec(self, key: Tuple, spec, durable: bool = False) -> None:
        """Cache a derived spec. ``durable=True`` marks the entry as NOT
        observation-derived (tile-plan autotune winners): it survives
        version bumps and is JSON-persisted by ``save`` — such specs must
        be JSON-representable values."""
        if durable:
            json.dumps(spec)            # fail fast, not at save() time
            self._durable_specs[key] = spec
        else:
            self._specs[key] = (self._version, spec)

    # ---- persistence (service sessions survive process restarts) -----------
    def save(self, path: str) -> None:
        """JSON-persist the observed records, raw step observations, and
        durable specs (the versioned spec cache is derived state tied to
        in-process objects and is not saved). Keys must be
        JSON-representable tuples — which the engine's (arch, gpus) keys
        and the autotuner's plan keys are.

        The write is ATOMIC: the document lands in a same-directory tmp
        file first and is ``os.replace``d into place, so a crash mid-save
        leaves the previous profile intact instead of a truncated JSON the
        next session cannot load."""
        data = {
            "version": 2,
            "ema": self.ema,
            "records": [
                {"key": list(k),
                 "duration_frac": r.duration_frac,
                 "wall_step_time_s": r.wall_step_time_s,
                 "wall_token_time_s": r.wall_token_time_s,
                 "observations": r.observations}
                for k, r in sorted(self._records.items(),
                                   key=lambda kv: repr(kv[0]))],
            "steps": [
                {"key": list(k),
                 "observations": [
                     {"tokens": o.tokens, "rank_tokens": o.rank_tokens,
                      "wall_s": o.wall_s, "peak_memory": o.peak_memory}
                     for o in obs]}
                for k, obs in sorted(self._steps.items(),
                                     key=lambda kv: repr(kv[0]))],
            "durable_specs": [
                {"key": list(k), "spec": spec}
                for k, spec in sorted(self._durable_specs.items(),
                                      key=lambda kv: repr(kv[0]))],
        }
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "ProfileStore":
        """Load a persisted store. A corrupt/truncated file (crash
        mid-write predating the atomic ``save``, disk damage) degrades to
        a FRESH store with a warning — analytic profiles take over —
        rather than refusing to start."""
        try:
            with open(path) as f:
                data = json.load(f)
            store = cls(ema=float(data.get("ema", 0.5)))
            for rec in data.get("records", []):
                store._records[tuple(rec["key"])] = ProfileRecord(
                    duration_frac=float(rec["duration_frac"]),
                    wall_step_time_s=(
                        None if rec.get("wall_step_time_s") is None
                        else float(rec["wall_step_time_s"])),
                    wall_token_time_s=(
                        None if rec.get("wall_token_time_s") is None
                        else float(rec["wall_token_time_s"])),
                    observations=int(rec.get("observations", 1)))
            for entry in data.get("steps", []):
                store._steps[tuple(entry["key"])] = [
                    StepObservation(
                        tokens=float(o["tokens"]),
                        rank_tokens=float(o["rank_tokens"]),
                        wall_s=float(o["wall_s"]),
                        peak_memory=(None if o.get("peak_memory") is None
                                     else float(o["peak_memory"])))
                    for o in entry["observations"]]
            for entry in data.get("durable_specs", []):
                store._durable_specs[tuple(entry["key"])] = entry["spec"]
            return store
        except (OSError, ValueError, KeyError, TypeError) as e:
            logging.getLogger(__name__).warning(
                "profile store %s unreadable (%s): starting fresh", path, e)
            return cls()

    @classmethod
    def load_or_new(cls, path: str) -> "ProfileStore":
        """Load a persisted store, or start fresh if the file is absent."""
        if os.path.exists(path):
            return cls.load(path)
        return cls()


def gpus_for_model(cfg: ModelConfig, hbm_bytes: float = HBM_BYTES,
                   overhead: float = 1.35) -> int:
    """GPU/chip requirement from base-model size (paper §7.2)."""
    need = 2 * cfg.param_count() * overhead
    g = 1
    while g * hbm_bytes * 0.9 < need:
        g *= 2
    return g
