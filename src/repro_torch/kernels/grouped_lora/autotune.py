"""Tile-plan autotuning for the grouped-LoRA kernels on Hopper.

The port of ``src/repro/kernels/grouped_lora/autotune.py``. A ``TilePlan``
names one set of bf16 tiles for the three kernel templates of
``csrc/ranklocal_common.cuh``; the autotuner times the legal candidates for
a ``(d_in, d_out, r_max, Z, token-bucket)`` key on the six kernels of each
of the three sets (rank-local, ragged, dense), keeps the fastest one whose
eighteen outputs equal the default plan's bit for bit, and caches the
winner twice: in-process and durably through
``ProfileStore.put_spec(..., durable=True)``, so that a later session with
the same store skips the sweep.

The fields keep the reference's names; on Hopper they tile:

  * ``bm`` — token rows: narrow_out's BM (xa, ds) and rank_sum's BM
    (sb_add, dx); parallel;
  * ``bn`` — output features: rank_sum's BN, and tn's feature-side tile
    (da's BA, db's BB); parallel;
  * ``br`` — rank: narrow_out's BN (rank is an output axis of xa and ds)
    and tn's rank-side tile (da's BB, db's BA); parallel;
  * ``bk`` — the feature contraction split of narrow_out (``NO_BK``: 8
    warps of ``NO_KW`` 32); contraction, pinned;
  * ``bt`` — the token contraction stage of tn (``TC_BK``); contraction,
    pinned.

**The bitwise contract.** A parallel tile only re-partitions independent
output elements: in every template each element is summed in one fixed
order that depends on the contraction length alone (narrow_out's 8 warps in
warp order, rank_sum's k16 steps up to the live rank extent, tn's k16 steps
from row 0), so no plan moves a bit and the contraction fields stay at
their defaults. The sweep still checks it on every candidate, and a
candidate whose outputs differ from the default's is discarded, not
repaired.

**The compiled set.** A plan is a template instantiation, so only the plans
of ``PLAN_SET`` exist in the library (``GL_PLANS`` in
``csrc/ranklocal_common.cuh``, which ``gl_plan_tiles`` reports); a plan
outside it is not legal. ``DEFAULT_PLAN`` (every parallel field None) is
each launcher's own shape rule — ``default_tiles`` spells it out — and is
what a call with no plan launches. Only the bf16 tiles are plan-selectable:
the fp32 instantiations run on the FMA units in train checks only, keep one
tile each (``NO_BM`` x ``NO_BR``, ``RS_BM`` x ``RS_BN``, tn's 128 x 16) and
refuse a plan on the card. On the CPU the wrappers take their plain
versions, which validate a plan and otherwise ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_SUB = 8                   # token-bucket floor (the reference's sublane)
MMA_M, MMA_N = 16, 8       # mma.sync m16n8k16 fragment rows / columns
NO_WARPS, NO_KW = 8, 32    # narrow_out: warps, k per warp per stage
NO_BK = NO_WARPS * NO_KW   # narrow_out's contraction stage (bk)
NO_SMEM_BUDGET = 220 * 1024
TC_BK, TC_STAGES, TC_WN = 128, 3, 16   # tn: rows a stage (bt), ring, b/warp
RC_THREADS, RC_RK = 256, 64            # rank_sum: threads, ranks a chunk
SMEM_LIMIT = 227 * 1024    # opt-in shared memory a block (sm_90)
GRID_YZ_MAX = 65535

PLAN_SPEC_VERSION = 2
TARGET = "sm_90a"


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One set of bf16 tiles for the grouped-LoRA kernels (module
    docstring). None in a parallel field = the launchers' default."""
    bm: Optional[int] = None
    bn: Optional[int] = None
    bk: int = NO_BK
    bt: int = TC_BK
    br: Optional[int] = None

    def to_json(self) -> Dict:
        return {"version": PLAN_SPEC_VERSION, "target": TARGET,
                "bm": self.bm, "bn": self.bn, "bk": self.bk, "bt": self.bt,
                "br": self.br}

    @classmethod
    def from_json(cls, d: Dict) -> Optional["TilePlan"]:
        """The plan a spec names, or None for a spec of another version or
        target (one the reference wrote for a TPU is never applied)."""
        if (not isinstance(d, dict) or d.get("version") != PLAN_SPEC_VERSION
                or d.get("target") != TARGET):
            return None

        def field(k):
            return None if d.get(k) is None else int(d[k])

        return cls(bm=field("bm"), bn=field("bn"), bk=int(d["bk"]),
                   bt=int(d["bt"]), br=field("br"))


DEFAULT_PLAN = TilePlan()

# the compiled plan set, in GL_PLANS order (its index is the plan argument
# of the C entry points)
PLAN_SET: Tuple[TilePlan, ...] = tuple(
    TilePlan(bm=bm, bn=bn, br=br) for bm, bn, br in (
        (64, 128, 32), (32, 128, 32), (32, 64, 64), (16, 128, 32),
        (64, 64, 32)))


def token_bucket(tokens: int) -> int:
    """Round a token count up to the next power of two (floor ``_SUB``):
    nearby fused-step widths share one tuned plan instead of sweeping per
    exact T."""
    b = _SUB
    while b < tokens:
        b *= 2
    return b


def plan_key(d_in: int, d_out: int, r_max: int, Z: int,
             tokens: int) -> Tuple:
    """The autotune cache key — flat JSON-representable tuple, shared by
    the in-process cache and the ProfileStore durable-spec layer."""
    return ("tile_plan", PLAN_SPEC_VERSION, int(d_in), int(d_out),
            int(r_max), int(Z), token_bucket(int(tokens)))


# ---------------------------------------------------------------------------
# Tiles and Hopper legality
# ---------------------------------------------------------------------------

def default_tiles(tokens: int, rank_local: bool) -> Dict[str, Tuple[int, int]]:
    """The bf16 tile each launcher picks with no plan
    (``launch_narrow``, ``launch_rank_sum``, ``launch_da`` / ``launch_db``):
    narrow_out 16 x 8 at T <= 16, else 32 x 32 (rank-local) or 64 x 32;
    rank_sum 16 x 64 at T <= 16, else 128 x 128; tn 64 x 64."""
    if tokens <= 16:
        narrow, rank_sum = (16, 8), (16, 64)
    else:
        narrow, rank_sum = (32 if rank_local else 64, 32), (128, 128)
    return {"narrow_out": narrow, "rank_sum": rank_sum,
            "tn_da": (64, 64), "tn_db": (64, 64)}


def plan_tiles(plan: TilePlan, tokens: int,
               rank_local: bool) -> Dict[str, Tuple[int, int]]:
    """The bf16 tiles a call under ``plan`` launches: narrow_out bm x br,
    rank_sum bm x bn, tn bn x br (da) and br x bn (db); the default plan's
    are ``default_tiles``."""
    if plan == DEFAULT_PLAN:
        return default_tiles(tokens, rank_local)
    return {"narrow_out": (plan.bm, plan.br), "rank_sum": (plan.bm, plan.bn),
            "tn_da": (plan.bn, plan.br), "tn_db": (plan.br, plan.bn)}


def narrow_out_smem(bm: int, bn: int, w_kn: bool) -> Tuple[int, int]:
    """(ring stages, shared bytes) of ``NoTile<bm, bn, w_kn>``."""
    ws = bn + 4 if w_kn else NO_BK + 8
    stage = bm * (NO_BK + 8) * 2 + (NO_BK if w_kn else bn) * ws * 4
    stages = min(NO_SMEM_BUDGET // stage, 8)
    rs = bn if bn % 32 in (8, 24) else bn + 8
    return stages, max(stages * stage, NO_WARPS * bm * rs * 4)


def rank_sum_ok(bm: int, bn: int) -> bool:
    """``RcTile<bm, bn>``'s warp split: 8 warps as WM rows x WN columns,
    each an MT x NT grid of m16 x n8 tiles, NT 1 or even."""
    if bm % MMA_M or bn % MMA_N:
        return False
    wm = min(bm // MMA_M, 4)
    wn = RC_THREADS // 32 // wm
    if bm % (MMA_M * wm) or bn % (MMA_N * wn):
        return False
    nt = bn // (MMA_N * wn)
    return nt == 1 or nt % 2 == 0


def rank_sum_smem(bm: int, bn: int, w_t: bool) -> int:
    ss = RC_RK + 8
    w = bn * ss * 2 if w_t else RC_RK * (bn + 8) * 2
    return max(bm * ss * 2 + w, bm * (bn + 8) * 4)


def tn_ok(ba: int, bb: int) -> bool:
    """tn's bf16 tile: warps of 32 x TC_WN outputs, at most 1,024
    threads, its cp.async ring within the opt-in limit."""
    return (ba % 32 == 0 and bb % TC_WN == 0 and ba * bb // TC_WN <= 1024
            and TC_STAGES * TC_BK * (ba + bb + 16) * 2 <= SMEM_LIMIT)


def is_legal(plan: TilePlan, tokens: int, d_in: int, d_out: int,
             r_max: int, Z: int = 1) -> bool:
    """Hopper legality of a plan for one shape: the default, or a member of
    the compiled set whose contraction fields are pinned, whose tiles are
    multiples of the MMA fragments they feed (m16 rows, n8 columns), split
    over each template's warps as its config struct requires (``NoTile``:
    a ring of at least two stages; ``RcTile``; tn's 32 x 16 warps), fit the
    227 KB of shared memory a block may opt into, and give a grid that
    fits (at most 65,535 row tiles and slots). The kernels mask their own
    edges, so a tile need not divide the feature or rank extents."""
    if plan == DEFAULT_PLAN:
        return Z <= GRID_YZ_MAX and tokens >= 1
    if plan not in PLAN_SET or plan.bk != NO_BK or plan.bt != TC_BK:
        return False
    bm, bn, br = plan.bm, plan.bn, plan.br
    if bm % MMA_M or bn % MMA_N or br % MMA_N:
        return False
    for w_kn in (True, False):
        stages, smem = narrow_out_smem(bm, br, w_kn)
        if stages < 2 or smem > SMEM_LIMIT:
            return False
    if not rank_sum_ok(bm, bn) or max(rank_sum_smem(bm, bn, w_t)
                                      for w_t in (True, False)) > SMEM_LIMIT:
        return False
    if not (tn_ok(bn, br) and tn_ok(br, bn)):
        return False
    return -(-tokens // bm) <= GRID_YZ_MAX and Z <= GRID_YZ_MAX


def plan_index(plan: Optional[TilePlan], tokens: int, Z: int) -> int:
    """The plan argument of the C entry points: -1 for None or the default,
    else ``plan``'s index in ``PLAN_SET``. Raises for a plan outside the
    set or one whose grid does not fit: an illegal plan never falls back
    to the default."""
    if plan is None or plan == DEFAULT_PLAN:
        return -1
    if not isinstance(plan, TilePlan) or plan not in PLAN_SET:
        raise ValueError(f"{plan} is not in the compiled plan set")
    if not is_legal(plan, tokens, 1, 1, 1, Z):
        raise ValueError(f"{plan} is not legal at T={tokens}, Z={Z}")
    return PLAN_SET.index(plan)


def candidate_plans(tokens: int, d_in: int, d_out: int, r_max: int,
                    max_candidates: int = 12, Z: int = 1) -> List[TilePlan]:
    """The default plan (always candidate 0) and the legal plans of the
    compiled set, evenly subsampled down to ``max_candidates``."""
    plans = [DEFAULT_PLAN] + [p for p in PLAN_SET
                              if is_legal(p, tokens, d_in, d_out, r_max, Z)]
    if len(plans) > max_candidates:
        rest = plans[1:]
        stride = len(rest) / (max_candidates - 1)
        plans = [plans[0]] + [rest[int(i * stride)]
                              for i in range(max_candidates - 1)]
    return plans


# ---------------------------------------------------------------------------
# The sweep: time each candidate on the six kernels of the three sets
# ---------------------------------------------------------------------------

def _probe_operands(Z: int, tokens: int, d_in: int, d_out: int, r_max: int,
                    seed: int = 0, device=None, dtype=None):
    """Representative operands (bf16 on the card, fp32 on the CPU): mixed
    true ranks (dead rank tiles and boundary masks both exercised) and a
    ragged row tail, as the reference's probe."""
    from repro_torch.models.common import resolve_device
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    x = normal(Z, tokens, d_in).to(dtype)
    A = normal(Z, d_in, r_max, scale=0.1)
    B = normal(Z, r_max, d_out, scale=0.1)
    dy = normal(Z, tokens, d_out).to(dtype)
    scale = torch.ones((Z,), dtype=torch.float32, device=dev)
    sweep_r = [r for r in (r_max // 8, r_max // 4, r_max // 2, r_max) if r]
    ranks = torch.tensor([max(_SUB, sweep_r[z % len(sweep_r)])
                          for z in range(Z)], dtype=torch.int32, device=dev)
    rows = torch.tensor([tokens if z % 2 == 0 else max(tokens // 2, 1)
                         for z in range(Z)], dtype=torch.int32, device=dev)
    return x, A, B, dy, scale, rows, ranks


def six_kernel_step(plan: TilePlan):
    """A function running the six kernels (xa, sb_add, ds, dx, da, db) of
    each of the three sets under one plan — rank-local at mixed ranks with
    the ragged row tail, ragged with the rows, dense — the autotuner's
    unit of timing AND of bitwise comparison. Returns the 18 outputs."""
    from repro_torch.kernels.grouped_lora import grouped_lora as GL
    from repro_torch.kernels.grouped_lora import ragged as RG
    from repro_torch.kernels.grouped_lora import ranklocal as RL

    def step(x, A, B, dy, scale, rows, ranks):
        outs = []
        for xa, sb, ds, dx, da, db in (
                (lambda: RL.xa(x, A, rows, ranks, plan=plan),
                 lambda s: RL.sb_add(s, B, scale, rows, ranks, plan=plan),
                 lambda: RL.ds(dy, B, scale, rows, ranks, plan=plan),
                 lambda g: RL.dx(g, A, rows, ranks, plan=plan),
                 lambda g: RL.da(x, g, rows, ranks, plan=plan),
                 lambda s: RL.db(s, dy, scale, rows, ranks, plan=plan)),
                (lambda: RG.xa(x, A, rows, plan=plan),
                 lambda s: RG.sb_add(s, B, scale, rows, plan=plan),
                 lambda: RG.ds(dy, B, scale, rows, plan=plan),
                 lambda g: RG.dx(g, A, rows, plan=plan),
                 lambda g: RG.da(x, g, rows, plan=plan),
                 lambda s: RG.db(s, dy, scale, rows, plan=plan)),
                (lambda: GL.xa(x, A, plan=plan),
                 lambda s: GL.sb_add(s, B, scale, plan=plan),
                 lambda: GL.ds(dy, B, scale, plan=plan),
                 lambda g: GL.dx(g, A, plan=plan),
                 lambda g: GL.da(x, g, plan=plan),
                 lambda s: GL.db(s, dy, scale, plan=plan))):
            s = xa()
            g = ds()
            outs += [s, sb(s), g, dx(g), da(g), db(s)]
        return tuple(outs)

    return step


def kernel_family_flops(Z: int, tokens: int, d_in: int, d_out: int,
                        r_max: int) -> float:
    """Dense-equivalent 2 x MAC count of one set's six kernels, times the
    three sets (a normalization for throughput, the same for every
    candidate)."""
    fwd = 2.0 * Z * tokens * r_max * (d_in + d_out)
    return 3 * (fwd + 2.0 * fwd)


def _replayed(fn, args):
    """``fn`` as a timed unit. On the card: its launches captured once in
    a CUDA graph (after a warm-up on a side stream), and a function that
    replays the graph and returns its outputs, so that the timing sees the
    kernels' device time, not the host's dispatch of 18 launches; on the
    CPU, ``fn`` itself."""
    if not args[0].is_cuda:
        return fn
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn(*args)

    def replay(*_):
        graph.replay()
        return outs

    return replay


@dataclasses.dataclass
class CandidateTiming:
    plan: TilePlan
    seconds: float
    bitwise_equal_default: bool


@dataclasses.dataclass
class TuneResult:
    """Everything the report layers need from one sweep."""
    key: Tuple
    plan: TilePlan                      # the winner
    default_s: float
    best_s: float
    flops: float
    candidates: List[CandidateTiming]

    @property
    def speedup(self) -> float:
        return self.default_s / max(self.best_s, 1e-12)

    @property
    def discarded(self) -> List[TilePlan]:
        return [c.plan for c in self.candidates
                if not c.bitwise_equal_default]


def sweep(d_in: int, d_out: int, r_max: int, Z: int = 4,
          tokens: int = 128, *, device=None, max_candidates: int = 12,
          iters: int = 2, repeats: int = 3, seed: int = 0) -> TuneResult:
    """Time every legal candidate on the six kernels of the three sets
    (``sched.profiler.measure_throughput``: warm-up, then the median of
    ``repeats`` loops of ``iters`` steps, waiting for the card; on the card
    each step replays the candidate's launches from a CUDA graph); return
    the fastest candidate whose 18 outputs are ``torch.equal`` to the
    default plan's. The default competes, so the winner is never slower
    than it on the probe."""
    from repro_torch.sched.profiler import measure_throughput
    args = _probe_operands(Z, tokens, d_in, d_out, r_max, seed, device)
    plans = candidate_plans(tokens, d_in, d_out, r_max, max_candidates, Z)
    baseline = six_kernel_step(DEFAULT_PLAN)(*args)
    timings: List[CandidateTiming] = []
    default_s = best_s = None
    best = DEFAULT_PLAN
    for plan in plans:
        fn = six_kernel_step(plan)
        outs = fn(*args)
        bitwise = len(outs) == len(baseline) and all(
            torch.equal(o, b) for o, b in zip(outs, baseline))
        prof = measure_throughput(_replayed(fn, args), args, total_batch=Z,
                                  iters=iters, repeats=repeats)
        timings.append(CandidateTiming(plan, prof.step_time_s, bitwise))
        if plan == DEFAULT_PLAN:
            default_s = prof.step_time_s
        if bitwise and (best_s is None or prof.step_time_s < best_s):
            best_s, best = prof.step_time_s, plan
    if default_s is None or best_s is None:
        raise RuntimeError("the default plan did not run or did not match "
                           "itself")
    return TuneResult(key=plan_key(d_in, d_out, r_max, Z, tokens),
                      plan=best, default_s=default_s, best_s=best_s,
                      flops=kernel_family_flops(Z, tokens, d_in, d_out,
                                                r_max),
                      candidates=timings)


# ---------------------------------------------------------------------------
# Cached entry point: in-process + ProfileStore-durable winners
# ---------------------------------------------------------------------------

_PLANS: Dict[Tuple, TilePlan] = {}
# the sweeps ``autotune_tile_plan`` ran since the cache was last cleared
SWEEPS: List[TuneResult] = []


def clear_plan_cache() -> None:
    """Drop the in-process winner cache and the sweep record (tests)."""
    _PLANS.clear()
    SWEEPS.clear()


def autotune_tile_plan(d_in: int, d_out: int, r_max: int, Z: int = 4,
                       tokens: int = 128, *, device=None, store=None,
                       max_candidates: int = 12, iters: int = 2,
                       repeats: int = 3, seed: int = 0) -> TilePlan:
    """The tuned plan for a shape key, cheapest source first: in-process
    cache -> ProfileStore durable spec (a previous session's sweep; a spec
    of another version or target is ignored) -> fresh sweep (then
    persisted through both). ``store`` is a ``ProfileStore`` or None (no
    cross-session persistence)."""
    key = plan_key(d_in, d_out, r_max, Z, tokens)
    hit = _PLANS.get(key)
    if hit is not None:
        return hit
    if store is not None:
        spec = store.get_spec(key)
        plan = TilePlan.from_json(spec) if spec is not None else None
        if plan is not None and is_legal(plan, tokens, d_in, d_out, r_max,
                                         Z):
            _PLANS[key] = plan
            return plan
    result = sweep(d_in, d_out, r_max, Z, tokens, device=device,
                   max_candidates=max_candidates, iters=iters,
                   repeats=repeats, seed=seed)
    SWEEPS.append(result)
    _PLANS[key] = result.plan
    if store is not None:
        store.put_spec(key, result.plan.to_json(), durable=True)
    return result.plan


def plan_for(shapes: Sequence[int], *, store=None, device=None) -> TilePlan:
    """Convenience: ``shapes = (Z, tokens, d_in, d_out, r_max)`` — the
    executor-facing signature."""
    Z, tokens, d_in, d_out, r_max = shapes
    return autotune_tile_plan(d_in, d_out, r_max, Z, tokens, device=device,
                              store=store)
