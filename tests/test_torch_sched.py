"""PyTorch port: the scheduler's copies give the JAX package's decisions.

The port keeps its own copies of the pure-Python scheduler
(``sched/inter_task.py``, ``intra_task.py``, ``events.py``, ``cluster.py``,
``fitted.py`` and ``profiler.py``'s ``ProfileStore``). Fixed, seeded
instances go through both packages and must come out equal, with no
tolerance: placements (name, start, GPUs), makespans, realized schedules,
``event_to_json`` logs and driver results.

(a) ``solve`` under "cp", "lpt" and "sjf", and ``plan_fused``.
(b) ``execute_static`` and ``ElasticClusterRuntime.run`` over
    ``SimulatedTaskDriver``s: plain, ``colocate``, ``fusion_planning`` and
    ``migrate``.
(c) ``ClusterSimulator``.
(d) ``fit_memory_model``, ``admit_cross_task``, the ``fitted.py`` fits, and
    a ``ProfileStore`` saved by one package loads in the other with the
    same scales.

The workloads: ``tests/test_cluster.py``'s ``FIXED`` at G = 4 and twenty
seeds of its ``random_workload`` (2-6 tasks each, so the branch-and-bound
time cap never binds), at G = 2 and 4 in turn.
"""
import dataclasses

import numpy as np
import pytest

from repro.sched import cluster as JCL
from repro.sched import events as JEV
from repro.sched import fitted as JFT
from repro.sched import inter_task as JIT
from repro.sched import intra_task as JIA
from repro.sched import profiler as JPR
from repro_torch.sched import cluster as TCL
from repro_torch.sched import events as TEV
from repro_torch.sched import fitted as TFT
from repro_torch.sched import inter_task as TIT
from repro_torch.sched import intra_task as TIA
from repro_torch.sched import profiler as TPR
from tests import test_cluster as REF

PKGS = {"jax": (JCL, JEV, JIT), "torch": (TCL, TEV, TIT)}
SEEDS = range(20)


def _random_params(rng, G):
    """``test_cluster.random_workload``'s draws, as keyword dicts."""
    n = int(rng.integers(2, 7))
    out = []
    for _ in range(n):
        K = int(rng.integers(2, 20))
        Z = int(rng.integers(1, 6))
        total = int(rng.integers(10, 150))
        warm = int(rng.integers(1, max(total // 4, 2)))
        step_time = float(rng.uniform(0.005, 0.05))
        gpus = int(rng.integers(1, G + 1))
        n_exits = int(rng.integers(0, K + 1))
        exits = {int(j): int(rng.integers(1, total)) for j in
                 rng.choice(K, size=n_exits, replace=False)}
        out.append(dict(K=K, Z=Z, total=total, warm=warm,
                        step_time=step_time, gpus=gpus, exits=exits))
    return out


def _instance(which):
    """(G, task keyword dicts, an rng for the instance's other draws)."""
    if which == "fixed":
        return 4, [dict(kw) for kw in REF.FIXED], np.random.default_rng(99)
    seed = int(which[4:])
    G = (2, 4)[seed % 2]
    return G, _random_params(np.random.default_rng(seed), G), \
        np.random.default_rng(10_000 + seed)


INSTANCES = ["fixed"] + [f"seed{s}" for s in SEEDS]


def _tasks(pkg, params, colo=None):
    """(spec, factory, colo spec) per task, built by ``pkg``'s cluster."""
    CL = PKGS[pkg][0]
    out = []
    for i, kw in enumerate(params):
        name = f"t{i}"
        spec = CL.sim_task_spec(name, K=kw["K"], Z=kw["Z"],
                                total_steps=kw["total"],
                                warmup_steps=kw["warm"],
                                step_time_s=kw["step_time"], gpus=kw["gpus"])

        def factory(kw=kw, name=name):
            return CL.SimulatedTaskDriver(
                name, K=kw["K"], Z=kw["Z"], total_steps=kw["total"],
                warmup_steps=kw["warm"], step_time_s=kw["step_time"],
                exit_step=kw["exits"])
        c = None
        if colo is not None and colo[i]:
            c = CL.sim_colo_spec(("shared", kw["gpus"]), K=kw["K"],
                                 Z=kw["Z"])
        out.append((spec, factory, c))
    return out


def _placements(sched):
    return [(p.task.name, p.task.duration, p.task.gpus, p.task.release,
             p.start, tuple(p.gpu_ids)) for p in sched.placements]


def _schedule(sched):
    return (_placements(sched), sched.makespan, sched.optimal)


def test_seeded_workloads_are_test_clusters():
    """The seeded instances are ``test_cluster.random_workload``'s."""
    for seed in SEEDS:
        G = (2, 4)[seed % 2]
        ref = REF.random_workload(np.random.default_rng(seed), G)
        _, params, _ = _instance(f"seed{seed}")
        ours = _tasks("jax", params)
        assert [s for s, _ in ref] == [s for s, _, _ in ours]
        for (_, fr), (_, fo, _) in zip(ref, ours):
            a, b = fr(), fo()
            assert (a.K, a.Z, a.total_steps, a.warmup_steps, a.step_time_s,
                    a.exit_step) == (b.K, b.Z, b.total_steps,
                                     b.warmup_steps, b.step_time_s,
                                     b.exit_step)


# ---------------------------------------------------------------------------
# (a) the solvers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", INSTANCES)
def test_solve_matches_reference(which):
    G, params, _ = _instance(which)
    for method in ("cp", "lpt", "sjf"):
        got = {pkg: _schedule(PKGS[pkg][2].solve(
                   [s for s, _, _ in _tasks(pkg, params)], G, method))
               for pkg in PKGS}
        assert got["torch"] == got["jax"], method


def _fusion_inputs(pkg, params, G, rng):
    """A partly busy skyline, two live replicas and a fusion profile per
    task, drawn from ``rng`` (the same draws for both packages)."""
    IT = PKGS[pkg][2]
    specs = [s for s, _, _ in _tasks(pkg, params)]
    longest = max(s.duration for s in specs)
    free_at = [float(x) for x in rng.uniform(0.0, 0.3 * longest, G)]
    replicas = [IT.ReplicaState(
        host=f"r{g}", fuse_key=("shared", 1), gpu_ids=(g,),
        projected_end=float(rng.uniform(0.2, 1.2) * longest),
        slot_headroom=int(rng.integers(1, 8)),
        mem_budget=float(rng.uniform(1e3, 1e5)), k1=1.0,
        k2=float(rng.uniform(0.0, 0.1))) for g in range(2)]
    profiles = {}
    for s, kw in zip(specs, params):
        tokens = float(kw["Z"] * 4 * 64)
        profiles[s.name] = IT.FusionProfile(
            ("shared", kw["gpus"]), slots=min(kw["Z"], kw["K"]),
            tokens=tokens, rank_tokens=tokens * int(rng.integers(1, 65)))
    return specs, free_at, replicas, profiles


@pytest.mark.parametrize("which", INSTANCES)
def test_plan_fused_matches_reference(which):
    G, params, rng = _instance(which)
    state = rng.bit_generator.state
    got = {}
    for pkg in PKGS:
        rng.bit_generator.state = state
        specs, free_at, replicas, profiles = _fusion_inputs(
            pkg, params, G, rng)
        now = float(min(free_at))
        sched = PKGS[pkg][2].plan_fused(specs, G, free_at, replicas,
                                        profiles, now=now)
        got[pkg] = (_schedule(sched), sched.fused,
                    PKGS[pkg][2].lower_bound_fused(specs, G, free_at,
                                                   replicas, profiles, now))
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# (b) static execution and the elastic runtime
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", INSTANCES)
def test_execute_static_matches_reference(which):
    G, params, _ = _instance(which)
    got = {}
    for pkg, (CL, _, IT) in PKGS.items():
        tasks = _tasks(pkg, params)
        plan = IT.solve([s for s, _, _ in tasks], G, "cp")
        rep = CL.execute_static(plan, G, {s.name: f for s, f, _ in tasks})
        got[pkg] = (_schedule(rep.realized), rep.makespan, rep.gpu_busy,
                    rep.utilization, rep.results, rep.task_starts,
                    rep.task_ends)
    assert got["torch"] == got["jax"]


RUNTIME_MODES = {
    "plain": {},
    "colocate": dict(colocate=True),
    "fusion_planning": dict(colocate=True, fusion_planning=True),
    "migrate": dict(fusion_planning=True, migrate=True),
}


def _runtime_report(pkg, rep):
    EV = PKGS[pkg][1]
    return (rep.makespan, _schedule(rep.realized),
            [EV.event_to_json(e) for e in rep.events], rep.replans,
            rep.plans_adopted, rep.plans_rejected, rep.gpu_busy,
            rep.utilization, rep.results, rep.task_starts, rep.task_ends,
            rep.cancelled, rep.colocated, rep.preemptions, rep.migrations)


@pytest.mark.parametrize("mode", sorted(RUNTIME_MODES))
@pytest.mark.parametrize("which", INSTANCES)
def test_elastic_runtime_matches_reference(which, mode):
    """The runtime over ``SimulatedTaskDriver``s, started from the "cp"
    plan; in the co-location modes about 70% of the tasks (drawn per
    instance) are fusable under the key (shared, gpus)."""
    G, params, rng = _instance(which)
    colo = None
    if mode != "plain":
        colo = [bool(rng.random() < 0.7) for _ in params]
    got = {}
    for pkg, (CL, _, IT) in PKGS.items():
        tasks = _tasks(pkg, params, colo)
        plan = IT.solve([s for s, _, _ in tasks], G, "cp")
        rt = CL.ElasticClusterRuntime(G, **RUNTIME_MODES[mode])
        for s, f, c in tasks:
            rt.submit(s, f, colo=c)
        got[pkg] = _runtime_report(pkg, rt.run(initial=plan))
    assert got["torch"] == got["jax"]
    assert got["torch"][2], "no events logged"


# test_cluster.py's fixed co-location, ragged-width, migration and
# preemption scenarios: (runtime keywords, solve a "cp" plan first,
# tasks as (name, driver keywords, sim_colo_spec keywords or None, at))
_KEY, _RKEY, _MKEY = ("arch-a", 1, 4, 64, "sft"), ("arch-a", 1, "sft"), \
    ("arch", 2, "ce")


def _t(K, Z, total, warm, gpus, exits=None, step_time=0.01):
    return dict(K=K, Z=Z, total=total, warm=warm, step_time=step_time,
                gpus=gpus, exits=exits or {})


SCENARIOS = {
    "colocation": (dict(G=2, colocate=True), True, [
        ("host", _t(8, 4, 400, 20, 1), dict(fuse_key=_KEY), 0.0),
        ("hog", _t(8, 4, 400, 20, 1), None, 0.0),
        ("s1", _t(2, 2, 60, 3, 1), dict(fuse_key=_KEY), 0.0),
        ("s2", _t(2, 2, 60, 3, 1), dict(fuse_key=_KEY), 0.0)]),
    "ragged": (dict(G=2, colocate=True), True, [
        ("host", _t(8, 4, 400, 20, 1), dict(fuse_key=_RKEY,
         per_adapter_batch=4, seq_len=64, replica_slots=8), 0.0),
        ("hog", _t(8, 4, 400, 20, 1), None, 0.0),
        ("wide", _t(2, 2, 60, 3, 1), dict(fuse_key=_RKEY,
         per_adapter_batch=8, seq_len=64), 0.0),
        ("narrow", _t(2, 2, 60, 3, 1), dict(fuse_key=_RKEY,
         per_adapter_batch=2, seq_len=64), 0.0)]),
    "migration": (dict(G=4, fusion_planning=True, migrate=True,
                       delay_delta=2.0), False, [
        ("a", _t(8, 4, 80, 10, 2, {j: 11 for j in range(8)}, 1.0),
         dict(fuse_key=_MKEY, replica_slots=8), 0.0),
        ("b", _t(8, 4, 80, 10, 2, None, 1.0),
         dict(fuse_key=_MKEY, replica_slots=8), 0.0),
        ("g", _t(4, 4, 60, 10, 2, None, 1.0),
         dict(fuse_key=_MKEY, replica_slots=8), 0.0),
        ("d", _t(4, 2, 30, 10, 2, None, 1.0), None, 5.0)]),
    "preemption": (dict(G=4, fusion_planning=True, migrate=True,
                        delay_delta=2.0), False, [
        ("a", _t(8, 4, 80, 10, 2, {j: 11 for j in range(8)}, 1.0),
         dict(fuse_key=_MKEY, replica_slots=8), 0.0),
        ("c", _t(2, 2, 90, 10, 2, None, 1.0), None, 0.0),
        ("g", _t(4, 4, 60, 10, 2, None, 1.0),
         dict(fuse_key=_MKEY, replica_slots=8), 0.0),
        ("d", _t(4, 2, 30, 10, 2, None, 1.0), None, 6.0)]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_runtime_scenarios_match_reference(scenario):
    """Fusions, a migration and a preemption happen, and the two packages
    log them identically."""
    kw, planned, rows = SCENARIOS[scenario]
    G = kw["G"]
    got = {}
    for pkg, (CL, _, IT) in PKGS.items():
        rt = CL.ElasticClusterRuntime(**kw)
        specs = []
        for (name, t, colo, at), (s, f, _) in zip(
                rows, _tasks(pkg, [t for _, t, _, _ in rows])):
            s = dataclasses.replace(s, name=name)
            specs.append(s)

            def factory(t=t, name=name):
                return CL.SimulatedTaskDriver(
                    name, K=t["K"], Z=t["Z"], total_steps=t["total"],
                    warmup_steps=t["warm"], step_time_s=t["step_time"],
                    exit_step=t["exits"])
            c = (CL.sim_colo_spec(K=t["K"], Z=t["Z"], **colo)
                 if colo is not None else None)
            rt.submit(s, factory, at=at, colo=c)
        plan = IT.solve(specs, G, "cp") if planned else None
        got[pkg] = _runtime_report(pkg, rt.run(initial=plan))
    assert got["torch"] == got["jax"]
    events, (preemptions, migrations) = got["torch"][2], got["torch"][-2:]
    assert "task_fused" in {e["kind"] for e in events}
    assert {"migration": migrations, "preemption": preemptions}.get(
        scenario, 1) == 1


def test_events_round_trip_across_packages():
    """A port event's JSON form reads back in the reference, and the
    other way round."""
    ev = TEV.ProgressEvent(kind=TEV.EventKind.WARMUP_SELECTION, task="t",
                           time=1.5, reason="underperforming", step=4,
                           dropped=("t/a", "t/b"), detail="x")
    d = TEV.event_to_json(ev)
    assert d == JEV.event_to_json(JEV.event_from_json(d))
    assert TEV.event_from_json(JEV.event_to_json(JEV.event_from_json(d))) \
        == ev


# ---------------------------------------------------------------------------
# (c) the coarse simulator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", INSTANCES)
def test_cluster_simulator_matches_reference(which):
    """Staggered arrivals, actual durations at 30-100% of the estimates."""
    G, params, rng = _instance(which)
    draws = [(float(rng.uniform(0.3, 1.0)), float(rng.uniform(0.0, 0.5)))
             for _ in params]
    got = {}
    for pkg, (CL, EV, _) in PKGS.items():
        sim = EV.ClusterSimulator(G)
        for (s, _, _), (frac, at) in zip(_tasks(pkg, params), draws):
            sim.submit(s, actual_duration=s.duration * frac,
                       at=at * s.duration)
        mk = sim.run_until_idle()
        got[pkg] = (mk, sim.replans, [
            (r.spec.name, r.submit_time, r.start_time, r.end_time,
             r.gpu_ids) for r in sim.done])
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# (d) memory models, cross-task admission, the fits and the store
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_memory_fit_and_cross_task_admission_match_reference(seed):
    rng = np.random.default_rng(seed)
    seq = int(rng.choice([64, 128, 256]))
    pts = [(int(b), float(1e9 + 3e5 * b * seq + rng.normal(0, 1e6)))
           for b in (1, 2, 4, 8, 16)]
    cap = float(rng.uniform(8e9, 80e9))
    mj = JIA.fit_memory_model(pts, seq, capacity=cap)
    mt = TIA.fit_memory_model(pts, seq, capacity=cap)
    assert dataclasses.asdict(mt) == dataclasses.asdict(mj)
    assert mt.max_batch() == mj.max_batch()

    def requests(IA):
        return [IA.ColoRequest(f"q{i}", slots=int(rng.integers(1, 5)),
                               per_adapter_batch=int(rng.integers(1, 9)),
                               seq_len=int(rng.choice([0, 64, 256])) or None,
                               lora_rank=int(rng.integers(0, 65)) or None)
                for i in range(8)]
    state = rng.bit_generator.state
    admitted = {}
    for name, IA in (("jax", JIA), ("torch", TIA)):
        rng.bit_generator.state = state
        reqs = requests(IA)
        mem = IA.MemoryModel(k0=1e9, k1=2e4, seq_len=seq, capacity=4e9,
                             k2=float(rng.uniform(0, 400)), r_max=64)
        admitted[name] = [IA.admit_cross_task(reqs[:2], reqs[2:], cap_slots,
                                              m)
                          for cap_slots in (4, 8, 16)
                          for m in (None, mem,
                                    dataclasses.replace(mem, k2=0.0))]
    assert admitted["torch"] == admitted["jax"]


def _observations(PR, rng, n, peak=True):
    out = []
    for _ in range(n):
        tok = float(rng.integers(256, 8192))
        rtok = tok * float(rng.integers(4, 65))
        out.append(PR.StepObservation(
            tokens=tok, rank_tokens=rtok,
            wall_s=0.01 + 2e-6 * tok + 5e-9 * rtok + rng.normal(0, 1e-4),
            peak_memory=(2e9 + 1e5 * tok + 300.0 * rtok if peak else None)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_fitted_models_match_reference(seed):
    got = {}
    for name, PR, FT, IA in (("jax", JPR, JFT, JIA),
                             ("torch", TPR, TFT, TIA)):
        rng = np.random.default_rng(seed)
        obs = _observations(PR, rng, 24)
        frame = IA.MemoryModel(k0=0.0, k1=0.0, seq_len=256, capacity=80e9,
                               r_max=64)
        step = FT.fit_step_model(obs)
        mem = FT.fit_memory_model_ranked(obs, frame)
        store = PR.ProfileStore()
        for o in obs[:5]:           # below the guard: the analytic frame
            FT.observe_fused_step(store, ("m", 1), slot_tokens=[o.tokens],
                                  ranks=[o.rank_tokens / o.tokens],
                                  wall_s=o.wall_s, peak_memory=o.peak_memory)
        below = FT.fitted_memory_model(store, ("m", 1), frame)
        for o in obs[5:]:
            FT.observe_fused_step(store, ("m", 1), slot_tokens=[o.tokens],
                                  ranks=[o.rank_tokens / o.tokens],
                                  wall_s=o.wall_s, peak_memory=o.peak_memory)
        got[name] = (dataclasses.asdict(step), dataclasses.asdict(mem),
                     dataclasses.asdict(below),
                     dataclasses.asdict(FT.fitted_memory_model(
                         store, ("m", 1), frame)),
                     dataclasses.asdict(FT.fitted_step_model(store,
                                                             ("m", 1))),
                     FT.fit_step_model(obs[:2]))
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["k2"] > 0 and got["torch"][5] is None


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_profile_store_loads_across_packages(writer, tmp_path):
    """A store saved by one package loads in the other with the same
    records, scales, step observations and durable specs."""
    PR_w, PR_r = (JPR, TPR) if writer == "jax" else (TPR, JPR)
    rng = np.random.default_rng(7)
    store = PR_w.ProfileStore(ema=0.3)
    for key in (("stablelm-3b", 1), ("stablelm-3b", 2), ("tiny", 1)):
        for _ in range(3):
            est = float(rng.uniform(10, 100))
            store.record(key, realized_duration=est * rng.uniform(0.2, 1.2),
                         estimated_duration=est,
                         wall_step_time_s=float(rng.uniform(0.1, 1.0)),
                         wall_token_time_s=float(rng.uniform(1e-5, 1e-4)))
        for o in _observations(PR_w, rng, 4, peak=key[1] == 1):
            store.record_step(key, tokens=o.tokens,
                              rank_tokens=o.rank_tokens, wall_s=o.wall_s,
                              peak_memory=o.peak_memory)
    store.put_spec(("plan", "xa", 64), {"tile": [64, 128]}, durable=True)
    path = str(tmp_path / "profile.json")
    store.save(path)
    back = PR_r.ProfileStore.load(path)
    assert back.ema == store.ema
    for key in (("stablelm-3b", 1), ("stablelm-3b", 2), ("tiny", 1)):
        assert back.duration_scale(key) == store.duration_scale(key)
        assert back.scaled_duration(key, 50.0) == store.scaled_duration(
            key, 50.0)
        assert back.wall_step_time(key) == store.wall_step_time(key)
        assert back.wall_token_time(key) == store.wall_token_time(key)
        assert back.observations(key) == store.observations(key)
        assert [dataclasses.asdict(o) for o in back.step_observations(key)] \
            == [dataclasses.asdict(o) for o in store.step_observations(key)]
    assert back.get_spec(("plan", "xa", 64)) == {"tile": [64, 128]}
    again = str(tmp_path / "again.json")
    back.save(again)
    assert open(again).read() == open(path).read()
