"""Inter-task scheduler: P | size_j | C_max makespan minimization (paper §7.2).

A verbatim copy of ``repro.sched.inter_task`` (pure Python): the port
imports nothing of the JAX package.

Tasks expose (duration d_i, GPU requirement g_i) before execution — LoRA
tuning's predictability (paper Obs. 3). The paper solves the big-M
disjunctive CP with CP-SAT; offline here, we implement the equivalent
optimization directly:

  * ``list_schedule``: event-driven (skyline) placement of a task order —
    every resource-feasible order maps to a valid concrete-GPU schedule
    (at any start instant, idle >= g_i by the capacity argument).
  * ``branch_and_bound``: DFS over task orders with lower-bound pruning
    (LB = max(longest task, total area / G, sum of d over tasks with
    g_i > G/2)), exploring the space of non-delay schedules. For the
    paper-scale instances (n <= 16) this matches the CP optimum on every
    instance we cross-check by brute force; a node cap degrades gracefully
    to best-found.
  * ``lpt_schedule``: largest-area-first list schedule (fast fallback,
    2-approx-style quality) used for replanning large queues.

Solving is sub-second (paper: "< 1 s for all tested instances"), which is
what makes event-driven replanning viable (§7.2).

Fusion-aware planning (co-location as a first-class plan concept): the
solvers above plan in *exclusive-GPU space* — every task occupies its own
g_i GPUs. Since the ragged/rank-local refactors, one frozen-backbone
replica can host adapter slots from several tasks, so the plan vocabulary
is lifted: ``FusionProfile`` describes a task's demand on a shared replica
(fuse key, concurrent slots, per-step tokens, rank-weighted FLOP-tokens)
and ``ReplicaState`` a live replica's capacity (slot headroom plus the
remaining §A.3 + k2 memory budget in bytes). ``plan_fused`` places tasks
*into replica slots* first — greedy decreasing-cost, mirroring cross-task
admission — and hands only the un-fusable remainder to list/LPT/B&B over
the GPU skyline, so the lower bound and the makespan the adoption rule
prices are computed against a plan that SEES co-location instead of
discovering it opportunistically at admission time.

Contract (what callers may rely on): ``plan_fused`` never extends a
replica's projected occupancy (a task fuses only when its whole residual
fits before the replica's projected end and the slot/memory budgets hold),
and its projected makespan is never worse than the exclusive plan over the
same queue — fusing only removes tasks from the GPU skyline. Together with
the runtime's adoption rule this preserves the elastic <= static exclusive
makespan guarantee under fusion-aware planning.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    name: str
    duration: float          # estimated d_i (profiled)
    gpus: int                # g_i (from base-model size)
    release: float = 0.0     # r_i: earliest allowed start (dynamic arrival)


@dataclasses.dataclass
class Placement:
    task: TaskSpec
    start: float
    gpu_ids: Tuple[int, ...]

    @property
    def end(self) -> float:
        return self.start + self.task.duration


@dataclasses.dataclass
class Schedule:
    placements: List[Placement]
    makespan: float
    optimal: bool
    solve_time_s: float

    def validate(self, G: int) -> None:
        """No-overlap per GPU + capacity + demand + release satisfied."""
        for p in self.placements:
            assert len(set(p.gpu_ids)) == p.task.gpus, p
            assert all(0 <= g < G for g in p.gpu_ids), p
            assert p.start >= p.task.release - 1e-9, p
        for a, b in itertools.combinations(self.placements, 2):
            if a.start < b.end - 1e-9 and b.start < a.end - 1e-9:
                assert not (set(a.gpu_ids) & set(b.gpu_ids)), (a, b)


def lower_bound(tasks: Sequence[TaskSpec], G: int,
                free_at: Optional[Sequence[float]] = None) -> float:
    """Makespan LB; with ``free_at`` it bounds the residual problem over a
    partially busy cluster (running tasks occupy GPUs until free_at[g])."""
    base = [0.0] * G if free_at is None else list(free_at)
    if not tasks:
        return max(base, default=0.0)
    earliest = min(base)
    area = (sum(base) + sum(t.duration * t.gpus for t in tasks)) / G
    # a task can start no earlier than both its release and the cluster
    longest = max(max(earliest, t.release) + t.duration for t in tasks)
    # tasks needing more than half the cluster can never overlap each other
    big = earliest + sum(t.duration for t in tasks if t.gpus > G / 2)
    return max(area, longest, big, max(base))


def list_schedule(order: Sequence[TaskSpec], G: int,
                  free_at: Optional[Sequence[float]] = None) -> Schedule:
    """Greedy non-delay placement: each task starts at the earliest time
    enough GPUs are free; concrete ids picked from the per-GPU skyline.

    ``free_at`` seeds the per-GPU skyline (residual re-solves over a
    half-busy cluster); defaults to an idle cluster. Tasks with a
    ``release`` (announced future arrivals) never start before it."""
    free_at = [0.0] * G if free_at is None else list(free_at)
    placements: List[Placement] = []
    for t in order:
        # earliest time when >= g GPUs are free: g-th smallest free_at
        times = sorted(range(G), key=lambda g: free_at[g])
        chosen = times[:t.gpus]
        start = max(max(free_at[g] for g in chosen), t.release)
        # better: any set of g GPUs minimizing start; the g earliest-free
        # GPUs minimize the max -> optimal choice for non-delay placement
        for g in chosen:
            free_at[g] = start + t.duration
        placements.append(Placement(t, start, tuple(sorted(chosen))))
    mk = max((p.end for p in placements), default=0.0)
    mk = max(mk, max(free_at, default=0.0))
    return Schedule(placements, mk, optimal=False, solve_time_s=0.0)


def lpt_schedule(tasks: Sequence[TaskSpec], G: int,
                 free_at: Optional[Sequence[float]] = None) -> Schedule:
    """Best of several greedy orders (area, duration, width)."""
    best: Optional[Schedule] = None
    keys = [lambda t: -t.duration * t.gpus,
            lambda t: -t.duration,
            lambda t: (-t.gpus, -t.duration)]
    for key in keys:
        s = list_schedule(sorted(tasks, key=key), G, free_at)
        if best is None or s.makespan < best.makespan - 1e-12:
            best = s
    assert best is not None
    return best


def branch_and_bound(tasks: Sequence[TaskSpec], G: int,
                     node_cap: int = 200_000,
                     time_cap_s: float = 5.0,
                     free_at: Optional[Sequence[float]] = None) -> Schedule:
    """Exact-over-non-delay-orders DFS with LB pruning."""
    t0 = time.time()
    tasks = list(tasks)
    base_free = [0.0] * G if free_at is None else list(free_at)
    n = len(tasks)
    if n == 0:
        return Schedule([], max(base_free, default=0.0), True, 0.0)
    incumbent = lpt_schedule(tasks, G, base_free)
    best_mk = incumbent.makespan
    best_order: Optional[Tuple[int, ...]] = None
    lb_all = lower_bound(tasks, G, base_free)
    if best_mk <= lb_all + 1e-9:
        incumbent.optimal = True
        incumbent.solve_time_s = time.time() - t0
        return incumbent

    nodes = 0
    complete = True
    areas = [t.duration * t.gpus for t in tasks]

    def dfs(order: List[int], free_at: List[float], used_mk: float,
            rem_area: float) -> None:
        nonlocal nodes, best_mk, best_order, complete
        nodes += 1
        if nodes > node_cap or time.time() - t0 > time_cap_s:
            complete = False
            return
        if len(order) == n:
            if used_mk < best_mk - 1e-12:
                best_mk = used_mk
                best_order = tuple(order)
            return
        remaining = [i for i in range(n) if i not in order]
        # LB: remaining area must fit after current per-GPU frontier
        base = sum(free_at)
        lb = max(used_mk,
                 (base + rem_area) / G,
                 max(max(min(free_at), tasks[i].release) + tasks[i].duration
                     for i in remaining))
        if lb >= best_mk - 1e-12:
            return
        # symmetry: skip duplicate (duration,gpus,release) at the same depth
        seen = set()
        # heuristic child order: larger area first
        for i in sorted(remaining, key=lambda j: -areas[j]):
            sig = (tasks[i].duration, tasks[i].gpus, tasks[i].release)
            if sig in seen:
                continue
            seen.add(sig)
            t = tasks[i]
            times = sorted(free_at)
            start = max(times[t.gpus - 1], t.release)
            # apply placement to the g earliest-free GPUs
            new_free = list(free_at)
            idxs = sorted(range(G), key=lambda g: free_at[g])[:t.gpus]
            for g in idxs:
                new_free[g] = start + t.duration
            dfs(order + [i], new_free,
                max(used_mk, start + t.duration), rem_area - areas[i])

    dfs([], list(base_free), max(base_free), float(sum(areas)))
    if best_order is not None:
        sched = list_schedule([tasks[i] for i in best_order], G, base_free)
        sched.optimal = complete or sched.makespan <= lb_all + 1e-9
    else:
        sched = incumbent
        sched.optimal = complete and best_mk <= incumbent.makespan + 1e-12
    sched.solve_time_s = time.time() - t0
    return sched


def solve(tasks: Sequence[TaskSpec], G: int, method: str = "cp",
          free_at: Optional[Sequence[float]] = None) -> Schedule:
    """Entry point. method: "cp" (exact B&B, paper's MILP/CP analogue),
    "lpt" (greedy), "sjf" (shortest-job-first baseline of Fig. 5a)."""
    for t in tasks:
        assert t.gpus <= G, f"{t.name} needs {t.gpus} > {G} GPUs"
    if method == "cp":
        return branch_and_bound(tasks, G, free_at=free_at)
    if method == "lpt":
        return lpt_schedule(tasks, G, free_at)
    if method == "sjf":
        return list_schedule(sorted(tasks, key=lambda t: t.duration), G,
                             free_at)
    raise ValueError(method)


# --------------------------------------------------------------------------
# Residual re-solve + schedule diffing (elastic runtime, paper §7.2)
# --------------------------------------------------------------------------

def solve_residual(tasks: Sequence[TaskSpec], G: int,
                   free_at: Sequence[float], method: str = "cp",
                   bnb_max_n: int = 9) -> Schedule:
    """Re-solve placement of the pending queue over a partially busy
    cluster: ``free_at[g]`` is when GPU g is projected to free up (running
    tasks keep their GPUs — no migration). Exact B&B for small queues,
    LPT fallback beyond ``bnb_max_n`` (replans must stay sub-second so the
    event loop never stalls, paper §7.2)."""
    if method == "cp" and len(tasks) > bnb_max_n:
        method = "lpt"
    return solve(tasks, G, method, free_at=free_at)


@dataclasses.dataclass(frozen=True)
class PlacementDelta:
    task: str
    old_start: Optional[float]
    new_start: Optional[float]
    old_gpus: Tuple[int, ...]
    new_gpus: Tuple[int, ...]

    @property
    def moved_earlier(self) -> bool:
        return (self.old_start is not None and self.new_start is not None
                and self.new_start < self.old_start - 1e-9)


# --------------------------------------------------------------------------
# Fusion-aware planning: place tasks INTO replica slots (token/rank budgets)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FusionProfile:
    """A task's demand on a shared frozen-backbone replica, in the plan
    vocabulary: tasks whose ``fuse_key`` equals a replica's may be placed
    into that replica's adapter slots instead of onto exclusive GPUs.
    ``slots`` is the task's concurrent-slot upper bound, ``tokens`` its
    per-step token footprint bound (slots * b * seq — what the token-linear
    §A.3 memory model M_hat budgets), and ``rank_tokens`` the rank-weighted
    FLOP-token bound (tokens * true rank — the k2 term; bill r_max when the
    rank is unknown)."""
    fuse_key: Tuple
    slots: int
    tokens: float
    rank_tokens: float = 0.0


@dataclasses.dataclass(frozen=True)
class ReplicaState:
    """A live shared-backbone replica as the planner sees it.

    ``projected_end`` is the absolute virtual time the replica is projected
    to free its GPU set (host residual — refreshed on guest departures so
    the planner never budgets against a stale occupancy), ``slot_headroom``
    the physical adapter slots not claimed by residents' future-use bounds,
    and ``mem_budget`` the remaining §A.3 + k2 memory budget in BYTES:
    capacity * margin - k0 - k1 * resident_tokens - k2 * resident_rank_
    tokens. A candidate with profile p costs ``k1 * p.tokens + k2 *
    p.rank_tokens`` bytes — placing into slots is exactly the
    ``fits_ranked`` admission check, linearized so the solver needs no
    memory-model object."""
    host: str
    fuse_key: Tuple
    gpu_ids: Tuple[int, ...]
    projected_end: float
    slot_headroom: int
    mem_budget: float = float("inf")
    k1: float = 0.0
    k2: float = 0.0

    def fits(self, p: FusionProfile, now: float, duration: float) -> bool:
        """Can ``p`` fuse here without extending the replica? Key match,
        whole residual inside the projected occupancy, slot headroom, and
        the linearized memory budget."""
        if p.fuse_key != self.fuse_key:
            return False
        if now + duration > self.projected_end + 1e-9:
            return False
        if p.slots > self.slot_headroom:
            return False
        return self.cost(p) <= self.mem_budget + 1e-9

    def cost(self, p: FusionProfile) -> float:
        return self.k1 * p.tokens + self.k2 * p.rank_tokens


@dataclasses.dataclass
class FusedSchedule(Schedule):
    """A Schedule whose vocabulary includes co-location: ``fused`` maps
    task name -> host replica for tasks placed INTO replica slots (they
    start at plan time and have no exclusive placement); ``placements``
    covers only the exclusive remainder. ``makespan`` accounts for both:
    max over exclusive ends and fused-host projected ends."""
    fused: Dict[str, str] = dataclasses.field(default_factory=dict)

    def validate_fused(self, G: int,
                       replicas: Sequence[ReplicaState]) -> None:
        """Exclusive part validates as usual; every fused task's host must
        be a known replica and no task may appear in both parts."""
        self.validate(G)
        by_host = {r.host: r for r in replicas}
        placed = {p.task.name for p in self.placements}
        for name, host in self.fused.items():
            assert host in by_host, (name, host)
            assert name not in placed, f"{name} both fused and placed"


def lower_bound_fused(tasks: Sequence[TaskSpec], G: int,
                      free_at: Sequence[float],
                      replicas: Sequence[ReplicaState],
                      profiles: Dict[str, FusionProfile],
                      now: float = 0.0) -> float:
    """Fusion-aware makespan lower bound. A task that could fuse into SOME
    replica (individually — ignoring contention) may cost zero exclusive
    GPU area and finish by that replica's projected end, so only the
    provably un-fusable tasks contribute to the exclusive-space bound;
    every fusable task still bounds from below via min(replica end it fits,
    its exclusive completion). Sound by construction: every feasible
    fusion-aware plan is feasible for this relaxation."""
    exclusive: List[TaskSpec] = []
    floor = max(now, 0.0)
    for t in tasks:
        p = profiles.get(t.name)
        hosts = [r for r in replicas
                 if p is not None and t.release <= now + 1e-9
                 and r.fits(p, now, t.duration)]
        if not hosts:
            exclusive.append(t)
        else:
            # finishes no earlier than its own duration, wherever it lands
            floor = max(floor, max(now, t.release) + t.duration)
    return max(lower_bound(exclusive, G, free_at), floor)


def plan_fused(tasks: Sequence[TaskSpec], G: int,
               free_at: Sequence[float],
               replicas: Sequence[ReplicaState],
               profiles: Dict[str, FusionProfile],
               now: float = 0.0, method: str = "cp",
               bnb_max_n: int = 9) -> FusedSchedule:
    """Fusion-aware residual solve: place tasks INTO replica slots first,
    then solve the exclusive remainder over the GPU skyline.

    Fusion assignment is greedy decreasing memory-cost (ties by name),
    mirroring ``admit_cross_task``'s decreasing-width order; each
    assignment decrements the replica's slot headroom and linearized
    memory budget so contention is respected. Only tasks already released
    (``release <= now``) fuse — a future arrival has no driver to attach.
    The remainder goes through ``solve_residual`` (exact B&B for small
    queues, LPT beyond ``bnb_max_n``).

    The projected makespan of the returned plan is never worse than the
    exclusive plan over the same queue: fused tasks leave the GPU skyline
    untouched and never extend a replica's projected occupancy."""
    budgets = {r.host: [r.slot_headroom, r.mem_budget] for r in replicas}
    fused: Dict[str, str] = {}
    def width(t: TaskSpec) -> float:
        p = profiles.get(t.name)
        return p.tokens + p.rank_tokens if p is not None else 0.0

    order = sorted(tasks, key=lambda t: (-width(t), t.name))
    for t in order:
        p = profiles.get(t.name)
        if p is None or t.release > now + 1e-9:
            continue
        for r in sorted(replicas, key=lambda r: r.projected_end):
            slots_left, mem_left = budgets[r.host]
            trial = dataclasses.replace(r, slot_headroom=slots_left,
                                        mem_budget=mem_left)
            if trial.fits(p, now, t.duration):
                fused[t.name] = r.host
                budgets[r.host][0] -= p.slots
                budgets[r.host][1] -= r.cost(p)
                break
    rest = [t for t in tasks if t.name not in fused]
    sched = solve_residual(rest, G, free_at, method, bnb_max_n)
    mk = sched.makespan
    for name, host in fused.items():
        mk = max(mk, next(r.projected_end for r in replicas
                          if r.host == host))
    return FusedSchedule(sched.placements, mk, sched.optimal,
                         sched.solve_time_s, fused=fused)


def diff_schedules(old: Schedule, new: Schedule) -> List[PlacementDelta]:
    """Per-task deltas between two plans (replan observability: which
    pending tasks moved earlier / changed GPUs after an event)."""
    old_by = {p.task.name: p for p in old.placements}
    new_by = {p.task.name: p for p in new.placements}
    deltas: List[PlacementDelta] = []
    for name in sorted(set(old_by) | set(new_by)):
        a, b = old_by.get(name), new_by.get(name)
        if (a is not None and b is not None
                and abs(a.start - b.start) < 1e-9 and a.gpu_ids == b.gpu_ids):
            continue
        deltas.append(PlacementDelta(
            task=name,
            old_start=None if a is None else a.start,
            new_start=None if b is None else b.start,
            old_gpus=() if a is None else a.gpu_ids,
            new_gpus=() if b is None else b.gpu_ids))
    return deltas
