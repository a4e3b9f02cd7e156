"""PyTorch port: the tuning service (``core/service.py``) against the JAX
package's, and its bitwise contracts inside the port.

(a) Simulated sessions, both packages, exact. The same
    ``SimulatedTaskDriver`` workloads go through both ``TuningService``s
    and must give equal reports: makespan, starts, ends, cancelled,
    co-located, replans, adopted and rejected plans, preemptions and
    migrations, the event logs through ``event_to_json``, the drivers'
    results and the ``ProfileStore`` contents. Covered: the arrival
    property with its competitive bound (tests/test_service.py:74, its 15
    derandomized examples), cancellation (:101, :129, :154), stream and
    reactivation (:175), the feedback scale (:200, :222), release times
    (:258), profile persistence (:365, :388), routing onto live replicas
    (:410), quotas (:445, :472), serving leases (tests/test_serve.py:359,
    :393) and ``run_forever`` draining a submission
    (tests/test_recovery.py:383). The host code is a verbatim copy: no
    tolerance.
(b) Real-engine sessions inside the port, bitwise, on the CPU
    (``device="cpu"``, reduced float32 paper-llama-tiny): the dynamic
    session (tests/test_service.py:290: arrivals, a mid-flight submit, a
    cancel, feedback), each completed task equal to that task through
    static ``batched_execution``; tune-to-serve end to end
    (tests/test_serve.py:419: artifact metadata, hot publish, served tokens
    equal a fresh pool holding the live adapter) and the pool-full refusal
    that keeps the artifact (:477); a crashed session recovered with
    ``serve_frontend=``, its finished winner republished from its artifact.
(c) One session through both packages, the JAX package's weights bridged
    into the port: the same event sequence (kind, task, job), the same
    virtual starts and ends (1e-9), the same winners, and each best
    validation loss within the gradient bar of
    tests/test_kernel_backends.py (rtol 2e-3, atol 2e-3): adapter inits are
    drawn differently in the two packages by design.
"""
import dataclasses
import json
import os
import time

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import service as JSVC
from repro.sched import cluster as JCL
from repro.sched import events as JEV
from repro.sched import inter_task as JIT
from repro.sched import profiler as JPR
from repro_torch import bridge
from repro_torch.checkpoint.taskstate import SimulatedCrash
from repro_torch.configs.registry import get_arch
from repro_torch.core import engine as TENG
from repro_torch.core import service as TSVC
from repro_torch.core.early_exit import EarlyExitConfig
from repro_torch.data import synthetic as TSYN
from repro_torch.sched import cluster as TCL
from repro_torch.sched import events as TEV
from repro_torch.sched import inter_task as TIT
from repro_torch.sched import profiler as TPR
from repro_torch.sched.events import EventKind
from repro_torch.sched.journal import replay_journal
from repro_torch.serve import (SPEC_VERSION, AdapterPool, ServingFrontend,
                               ServingReplica, adapter_template)
from tests import test_service as REF
from tests.conftest import reduced_f32
from tests.test_torch_engine import _record_lifecycles, _same
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401

PKGS = {"jax": (JSVC, JCL, JEV, JIT, JPR),
        "torch": (TSVC, TCL, TEV, TIT, TPR)}
CHUNK_STEPS = 5      # SimulatedTaskDriver default
GTOL = dict(rtol=2e-3, atol=2e-3)


def _service(pkg, **kw):
    """``pkg``'s TuningService; the port's on the CPU."""
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    return PKGS[pkg][0].TuningService(**kw)


def _sim(pkg, name, *, K, Z, total, warm, step_time, gpus, exits=None):
    """tests/test_service.py:sim_task in ``pkg``: (spec, factory)."""
    CL = PKGS[pkg][1]
    spec = CL.sim_task_spec(name, K=K, Z=Z, total_steps=total,
                            warmup_steps=warm, step_time_s=step_time,
                            gpus=gpus)

    def factory():
        return CL.SimulatedTaskDriver(name, K=K, Z=Z, total_steps=total,
                                      warmup_steps=warm,
                                      step_time_s=step_time,
                                      exit_step=exits or {})
    return spec, factory


def _store(store):
    """Everything a ProfileStore observed (the spec cache aside)."""
    return (store.ema,
            {k: dataclasses.asdict(r) for k, r in store._records.items()},
            {k: [dataclasses.asdict(o) for o in obs]
             for k, obs in store._steps.items()}, store._version)


def _report(pkg, svc, rep):
    EV = PKGS[pkg][2]
    return (rep.makespan, rep.task_starts, rep.task_ends, rep.cancelled,
            rep.colocated, rep.replans, rep.plans_adopted,
            rep.plans_rejected, rep.preemptions, rep.migrations,
            rep.utilization, rep.runtime.gpu_busy,
            [(p.task.name, p.start, tuple(p.gpu_ids))
             for p in rep.runtime.realized.placements],
            [EV.event_to_json(e) for e in rep.events], rep.task_results,
            _store(svc.profile_store),
            {n: svc.status(n).state.value for n in svc._meta})


def _both(fn, *args):
    got = {pkg: fn(pkg, *args) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    return got["torch"]


# ---------------------------------------------------------------------------
# (a) simulated sessions
# ---------------------------------------------------------------------------

def _arrival_params(rng, G):
    """tests/test_service.py:random_arrival_workload's draws."""
    out = []
    for i in range(int(rng.integers(2, 7))):
        K = int(rng.integers(2, 20))
        Z = int(rng.integers(1, 6))
        total = int(rng.integers(10, 150))
        warm = int(rng.integers(1, max(total // 4, 2)))
        step_time = float(rng.uniform(0.005, 0.05))
        gpus = int(rng.integers(1, G + 1))
        n_exits = int(rng.integers(0, K + 1))
        exits = {int(j): int(rng.integers(1, total)) for j in
                 rng.choice(K, size=n_exits, replace=False)}
        at = float(rng.uniform(0.0, 5.0)) if i else 0.0
        out.append((f"t{i}", dict(K=K, Z=Z, total=total, warm=warm,
                                  step_time=step_time, gpus=gpus,
                                  exits=exits), at))
    return out


def _arrivals(seed, G):
    params = _arrival_params(np.random.default_rng(seed), G)
    ref = REF.random_arrival_workload(np.random.default_rng(seed), G)
    assert [(s, at) for s, _, at, _ in ref] == [
        (_sim("jax", n, **kw)[0], at) for n, kw, at in params]
    return params


@settings(deadline=None, max_examples=15, derandomize=True)
@given(seed=st.integers(0, 10_000), G=st.sampled_from([2, 4, 8]),
       delta=st.sampled_from([None, 1.0, 2.0]))
def test_arrival_trace_matches_and_meets_competitive_bound(seed, G, delta):
    params = _arrivals(seed, G)

    def run(pkg):
        IT, CL = PKGS[pkg][3], PKGS[pkg][1]
        tasks = [(*_sim(pkg, n, **kw), at) for n, kw, at in params]
        svc = _service(pkg, total_gpus=G, delay_delta=delta)
        handles = [svc.submit_spec(s, f, at=at) for s, f, at in tasks]
        report = svc.run_until_idle()
        t_last = max(at for _, _, at in tasks)
        plan = IT.solve([s for s, _, _ in tasks], G, "cp")
        static = CL.execute_static(plan, G, {s.name: f for s, f, _ in tasks})
        chunk_slack = sum(CHUNK_STEPS * kw["step_time"]
                          for _, kw, at in params if at > 0)
        assert report.makespan <= t_last + 2 * static.makespan \
            + chunk_slack + 1e-9
        report.runtime.realized.validate(G)
        for h, (_, _, at) in zip(handles, tasks):
            assert h.status().state.value == "completed"
            assert report.task_starts[h.name] >= at - 1e-9
        assert "task_arrived" in {e.kind.value for e in report.events}
        return _report(pkg, svc, report), static.makespan
    _both(run)


@settings(deadline=None, max_examples=10, derandomize=True)
@given(seed=st.integers(0, 10_000), G=st.sampled_from([4, 8]))
def test_cancellations_match_and_are_terminal(seed, G):
    params = _arrivals(seed, G)

    def run(pkg):
        SVC = PKGS[pkg][0]
        rng = np.random.default_rng(seed)
        _arrival_params(rng, G)               # the workload's draws first
        svc = _service(pkg, total_gpus=G)
        handles = [svc.submit_spec(*_sim(pkg, n, **kw), at=at)
                   for n, kw, at in params]
        for idx in rng.choice(len(params), size=int(
                rng.integers(1, len(params) + 1)), replace=False):
            svc.cancel(params[int(idx)][0], at=float(rng.uniform(0.0, 8.0)))
        report = svc.run_until_idle()
        report.runtime.realized.validate(G)
        for h in handles:
            state = h.status().state
            assert state.terminal, h.name
            if state is SVC.TaskState.CANCELLED:
                assert h.name not in report.task_results
                with pytest.raises(SVC.TaskCancelled):
                    h.result()
            else:
                assert report.task_results[h.name] is not None
        return _report(pkg, svc, report)
    _both(run)


def _cancel_frees_capacity(pkg, tmp):
    big = _sim(pkg, "big", K=8, Z=4, total=400, warm=10, step_time=0.02,
               gpus=4)
    nxt = _sim(pkg, "next", K=4, Z=2, total=100, warm=5, step_time=0.02,
               gpus=4)
    out = []
    for cancel_at in (None, 1.0):
        svc = _service(pkg, total_gpus=4)
        svc.submit_spec(*big)
        svc.submit_spec(*nxt)
        if cancel_at is not None:
            svc.cancel("big", at=cancel_at)
        out.append((svc, svc.run_until_idle()))
    (_, base), (_, cancelled) = out
    assert "big" in cancelled.cancelled
    assert cancelled.task_starts["next"] <= 1.0 + CHUNK_STEPS * 0.02 + 1e-9
    assert cancelled.task_starts["next"] < base.task_starts["next"] - 1e-9
    assert cancelled.makespan < base.makespan - 1e-9
    return [_report(pkg, s, r) for s, r in out]


def _cancel_before_arrival(pkg, tmp):
    svc = _service(pkg, total_gpus=2)
    ha = svc.submit_spec(*_sim(pkg, "a", K=2, Z=2, total=20, warm=2,
                               step_time=0.01, gpus=1))
    hb = svc.submit_spec(*_sim(pkg, "b", K=2, Z=2, total=20, warm=2,
                               step_time=0.01, gpus=1), at=5.0)
    hb.cancel(at=1.0)
    report = svc.run_until_idle()
    assert ha.status().state.value == "completed"
    assert hb.status().state.value == "cancelled"
    assert "b" not in report.task_starts
    assert hb.status().started_at is None
    return _report(pkg, svc, report)


def _stream_and_reactivation(pkg, tmp):
    svc = _service(pkg, total_gpus=2)
    h = svc.submit_spec(*_sim(pkg, "a", K=4, Z=2, total=40, warm=4,
                              step_time=0.01, gpus=2))
    assert h.status().state.value == "pending"
    kinds = [e.kind.value for e in h.stream()]
    assert kinds[0] == "task_submitted" and "task_started" in kinds
    assert kinds[-1] == "task_completed"
    h2 = svc.submit_spec(*_sim(pkg, "late", K=2, Z=2, total=20, warm=2,
                               step_time=0.01, gpus=1), at=svc.now + 3.0)
    assert h2.status().state.value == "pending"
    res = h2.result()
    assert h2.status().state.value == "completed"
    assert svc.status("late").started_at >= svc.status("a").finished_at
    return kinds, res, _report(pkg, svc, svc.run_until_idle())


def _profile_store_scale(pkg, tmp):
    store = PKGS[pkg][4].ProfileStore(ema=0.5)
    key = ("arch", 2)
    out = [store.duration_scale(key), store.wall_step_time(key),
           store.scaled_duration(key, 10.0)]
    store.put_spec(("t", "ee"), "SPEC")
    out.append(store.get_spec(("t", "ee")))
    store.record(key, realized_duration=5.0, estimated_duration=10.0,
                 wall_step_time_s=0.7)
    out += [store.duration_scale(key), store.scaled_duration(key, 10.0),
            store.wall_step_time(key), store.get_spec(("t", "ee"))]
    store.record(key, realized_duration=20.0, estimated_duration=10.0)
    out += [store.duration_scale(key), store.wall_step_time(key),
            store.observations(key), _store(store)]
    assert out[:9] == [1.0, None, 10.0, "SPEC", 0.5, 5.0, 0.7, None, 0.75]
    return out


def _feedback_shrinks_estimates(pkg, tmp):
    store = PKGS[pkg][4].ProfileStore()
    key = ("archX", 2)
    out = []
    for _ in range(2):
        svc = _service(pkg, total_gpus=4, profile_store=store)
        for name, at in (("first", 0.0), ("second", 0.5)):
            svc.submit_spec(*_sim(pkg, name, K=8, Z=4, total=200, warm=10,
                                  step_time=0.02, gpus=2,
                                  exits={j: 15 for j in range(8)}),
                            at=at, profile_key=key)
        rep = svc.run_until_idle()
        out.append((_report(pkg, svc, rep),
                    svc._meta["second"].spec.duration))
        assert store.duration_scale(key) < 1.0
    assert out[1][1] < out[0][1] - 1e-9       # fed back: shorter estimate
    assert store.observations(key) == 4
    return out


def _release_times(pkg, tmp):
    IT = PKGS[pkg][3]
    sched = IT.list_schedule([IT.TaskSpec("x", 1.0, 1, release=3.0)], 2)
    assert sched.placements[0].start == 3.0
    s = IT.solve([IT.TaskSpec("a", 2.0, 2),
                  IT.TaskSpec("b", 1.0, 1, release=5.0)], 2, "cp")
    s.validate(2)
    by = {p.task.name: p for p in s.placements}
    assert by["a"].start == 0.0 and by["b"].start >= 5.0 - 1e-9
    bad = dataclasses.replace(s)
    bad.placements = [dataclasses.replace(by["b"], start=0.0)]
    with pytest.raises(AssertionError):
        bad.validate(2)
    return [[(p.task.name, p.task.release, p.start, tuple(p.gpu_ids))
             for p in x.placements] for x in (sched, s)]


def _profile_persistence(pkg, tmp):
    PR = PKGS[pkg][4]
    path = os.path.join(tmp, "profile.json")
    store = PR.ProfileStore(ema=0.4)
    store.record(("arch-a", 2), realized_duration=30.0,
                 estimated_duration=100.0, wall_step_time_s=0.02,
                 wall_token_time_s=1e-4)
    store.record(("arch-a", 2), realized_duration=50.0,
                 estimated_duration=100.0)
    store.save(path)
    assert _store(PR.ProfileStore.load(path))[:3] == _store(store)[:3]
    # the service persists feedback across sessions
    spath = os.path.join(tmp, "session.json")
    spec, factory = _sim(pkg, "t0", K=8, Z=4, total=100, warm=5,
                         step_time=0.02, gpus=1,
                         exits={j: 10 for j in range(8)})
    svc1 = _service(pkg, total_gpus=2, profile_path=spath)
    svc1.submit_spec(spec, factory, profile_key=("arch-a", 1))
    rep1 = svc1.run_until_idle()
    svc2 = _service(pkg, total_gpus=2, profile_path=spath)
    assert svc2.profile_store.observations(("arch-a", 1)) == 1
    h = svc2.submit_spec(dataclasses.replace(spec, name="t1"), factory,
                         profile_key=("arch-a", 1))
    assert svc2._meta["t1"].spec.duration < spec.duration - 1e-9
    h.result()
    with open(path) as f:
        saved = json.load(f)
    return (saved, _report(pkg, svc1, rep1),
            _report(pkg, svc2, svc2.run_until_idle()))


def _routing_onto_live_replicas(pkg, tmp):
    CL = PKGS[pkg][1]
    key = ("arch-a", 1, 4, 64, "sft")
    out = {}
    for colocate in (True, False):
        svc = _service(pkg, total_gpus=2, colocate=colocate)
        svc.submit_spec(*_sim(pkg, "host", K=8, Z=4, total=400, warm=20,
                              step_time=0.01, gpus=1),
                        colo=CL.sim_colo_spec(key, K=8, Z=4))
        svc.submit_spec(*_sim(pkg, "hog", K=8, Z=4, total=400, warm=20,
                              step_time=0.01, gpus=1))
        svc.submit_spec(*_sim(pkg, "small", K=2, Z=2, total=60, warm=3,
                              step_time=0.01, gpus=1), at=1.0,
                        colo=CL.sim_colo_spec(key, K=2, Z=2))
        out[colocate] = (svc, svc.run_until_idle())
    fused, excl = out[True][1], out[False][1]
    assert fused.colocated == {"small": "host"} and excl.colocated == {}
    assert fused.task_starts["small"] < excl.task_starts["small"] - 1e-9
    assert fused.makespan < excl.makespan - 1e-9
    return [_report(pkg, *out[c]) for c in (True, False)]


def _quota_enforced(pkg, tmp):
    SVC = PKGS[pkg][0]
    svc = _service(pkg, total_gpus=2, max_tasks_per_tenant=2)

    def mk(n):
        return _sim(pkg, n, K=2, Z=2, total=20, warm=2, step_time=0.01,
                    gpus=1)
    svc.submit_spec(*mk("a1"), tenant="alice")
    svc.submit_spec(*mk("a2"), tenant="alice")
    assert svc.active_tasks_of("alice") == 2
    with pytest.raises(SVC.QuotaExceeded):
        svc.submit_spec(*mk("a3"), tenant="alice")
    svc.submit_spec(*mk("b1"), tenant="bob")
    first = _report(pkg, svc, svc.run_until_idle())
    assert svc.active_tasks_of("alice") == 0
    res = svc.submit_spec(*mk("a3"), tenant="alice").result()
    assert res["task"] == "a3"
    return first, res, _report(pkg, svc, svc.run_until_idle())


def _quota_cancel_frees(pkg, tmp):
    SVC = PKGS[pkg][0]
    svc = _service(pkg, total_gpus=2, max_tasks_per_tenant=1)
    h1 = svc.submit_spec(*_sim(pkg, "c1", K=2, Z=2, total=200, warm=2,
                               step_time=0.01, gpus=1), tenant="t")
    c2 = _sim(pkg, "c2", K=2, Z=2, total=20, warm=2, step_time=0.01, gpus=1)
    with pytest.raises(SVC.QuotaExceeded):
        svc.submit_spec(*c2, tenant="t")
    h1.cancel()
    first = _report(pkg, svc, svc.run_until_idle())
    assert svc.status("c1").state is SVC.TaskState.CANCELLED
    svc.submit_spec(*c2, tenant="t")
    return first, _report(pkg, svc, svc.run_until_idle())


def _lease_sim(pkg, name, total):
    return _sim(pkg, name, K=1, Z=1, total=total, warm=1, step_time=1.0,
                gpus=1)


def _serving_lease_holds_gpus(pkg, tmp):
    svc = _service(pkg, total_gpus=2)
    sh = svc.attach_serving(None, gpus=1, horizon_s=100.0, chunk_s=10.0)
    for n in ("t1", "t2"):
        svc.submit_spec(*_lease_sim(pkg, n, 40), scale_duration=False)
    report = svc.run_until_idle()
    ends = report.task_ends
    assert ends["serve/replica-0"] == pytest.approx(100.0)
    assert max(ends["t1"], ends["t2"]) >= 80.0 - 1e-6   # serialized
    assert report.makespan == pytest.approx(100.0)
    assert sh.result()["kind"] == "serving_replica"
    assert sum(report.runtime.gpu_busy) >= 100.0 + 80.0 - 1e-6
    return _report(pkg, svc, report), sh.result()


def _serving_lease_cancel(pkg, tmp):
    svc = _service(pkg, total_gpus=1)
    sh = svc.attach_serving(None, gpus=1, horizon_s=500.0, chunk_s=10.0)
    h = svc.submit_spec(*_lease_sim(pkg, "t1", 20), scale_duration=False)
    sh.cancel(at=50.0)
    h.result()
    report = svc.run_until_idle()
    assert report.task_starts["t1"] >= 50.0 - 1e-6
    assert report.task_ends["t1"] == pytest.approx(70.0)
    assert "serve/replica-0" in report.cancelled
    return _report(pkg, svc, report)


def _lease_chunk_delays_arrival(pkg, tmp):
    """Kept from the reference for parity: the runtime admits an arrival
    only once its clock passes it, and a serving lease's chunk carries
    that clock. Under the default 60 s lease chunks a fusable task
    arriving at 0.24 s is admitted, fused and recorded as started at
    60 s, after its own end; under 0.05 s chunks at 0.25 s."""
    CL = PKGS[pkg][1]
    key = ("arch-a", 1, "sft")
    out = {}
    for chunk_s in (60.0, 0.05):
        svc = _service(pkg, total_gpus=2)
        svc.attach_serving(None, gpus=1, horizon_s=10_000.0,
                           chunk_s=chunk_s)
        host = _sim(pkg, "host", K=4, Z=4, total=8, warm=2,
                    step_time=0.12, gpus=1)
        svc.submit_spec(*host, colo=CL.sim_colo_spec(key, K=4, Z=4))
        guest = _sim(pkg, "guest", K=2, Z=2, total=8, warm=2,
                     step_time=0.06, gpus=1)
        svc.submit_spec(*guest, at=0.25 * host[0].duration,
                        colo=CL.sim_colo_spec(key, K=2, Z=2))
        for name in ("host", "guest"):
            svc._handles[name].result()
        svc.cancel("serve/replica-0")
        out[chunk_s] = (svc, svc.run_until_idle())
    late, fine = out[60.0][1], out[0.05][1]
    assert late.colocated == fine.colocated == {"guest": "host"}
    assert late.task_starts["guest"] == 60.0
    assert late.task_ends["guest"] < late.task_starts["guest"]
    assert fine.task_starts["guest"] < fine.task_ends["host"]
    return [_report(pkg, *out[c]) for c in (60.0, 0.05)]


def _run_forever(pkg, tmp):
    svc = _service(pkg, total_gpus=4)
    loop = svc.run_forever(poll_s=0.01)
    try:
        h = svc.submit_spec(*_sim(pkg, "w0", K=4, Z=2, total=20, warm=2,
                                  step_time=0.01, gpus=2))
        deadline = time.monotonic() + 30.0
        while (not h.status().state.terminal
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert h.status().state.terminal
        assert "w0" in svc._results()
    finally:
        loop.stop()
    assert not loop.alive
    return svc._results(), h.status().state.value


SESSIONS = {f.__name__[1:]: f for f in (
    _cancel_frees_capacity, _cancel_before_arrival, _stream_and_reactivation,
    _profile_store_scale, _feedback_shrinks_estimates, _release_times,
    _profile_persistence, _routing_onto_live_replicas, _quota_enforced,
    _quota_cancel_frees, _serving_lease_holds_gpus, _serving_lease_cancel,
    _lease_chunk_delays_arrival, _run_forever)}


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_simulated_session_matches_reference(name, tmp_path):
    def run(pkg):
        tmp = tmp_path / pkg
        tmp.mkdir()
        return SESSIONS[name](pkg, str(tmp))
    _both(run)


# ---------------------------------------------------------------------------
# (b) real-engine sessions inside the port
# ---------------------------------------------------------------------------

EE = dict(warmup_ratio=0.2, select_ratio=0.5)


@pytest.fixture(scope="module")
def env():
    cfg = dataclasses.replace(get_arch("paper-llama-tiny").reduced(
        num_layers=2, d_model=128, vocab=256), dtype="float32")
    ds = TSYN.make_task_dataset("svc", cfg.vocab_size, seq_len=16,
                                num_train=32, num_val=8, difficulty=0.2)
    params = TENG.Engine(device="cpu")._base_params(cfg)
    return cfg, ds, params


def _engine(env, **kw):
    cfg, _, params = env
    engine = TENG.Engine(eval_every=2, device="cpu", **kw)
    engine._param_cache[cfg.name] = params
    return engine


def _alone(env, task, ee):
    """``task`` through static ``batched_execution`` on its own engine:
    (result, lifecycle)."""
    engine = _engine(env, total_gpus=4)
    lcs = _record_lifecycles(engine)
    rep = engine.batched_execution([task], engine.schedule(
        [task], early_exit=ee), ee, strategy="static")
    return rep.task_results[task.task_name], lcs[task.task_name]


def test_service_defaults_to_the_card_and_checks_device(env):
    engine = _engine(env, total_gpus=2)
    svc = TSVC.TuningService(engine=engine, device="cpu")
    assert svc.engine is engine
    with pytest.raises(ValueError, match="device"):
        TSVC.TuningService(engine=engine, device="meta")
    assert TSVC.TuningService(total_gpus=2,
                              device="cpu").engine.device.type == "cpu"


def test_dynamic_session_equals_static_engine(env):
    """Three tasks at staggered virtual times, one submitted mid-flight and
    one cancelled before it arrives: terminal handles, feedback recorded,
    and each completed task's TaskResult (best job and value, every job,
    loss and validation histories, kept adapters) equal to the task run
    alone through static ``batched_execution``, bit for bit."""
    cfg, ds, _ = env
    ee = EarlyExitConfig(**EE)
    engine = _engine(env, total_gpus=4)
    lcs = _record_lifecycles(engine)
    svc = TSVC.TuningService(engine=engine)
    task_a = TENG.Task(model=cfg, dataset=ds, num_gpus=2, max_steps=8,
                       num_slots=2, name="tenant-a",
                       search_space={"lr": [1e-3, 3e-3], "batch_size": [2]})
    task_b = TENG.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=8,
                       num_slots=2, name="tenant-b",
                       search_space={"lr": [1e-3], "rank": [4, 8]})
    task_c = TENG.Task(model=cfg, dataset=ds, num_gpus=4, max_steps=8,
                       num_slots=2, name="tenant-c",
                       search_space={"lr": [3e-3], "rank": [4]})
    ha = svc.submit(task_a, at=0.0, early_exit=ee)
    mid = 0.4 * svc._meta["tenant-a"].spec.duration
    hb = svc.submit(task_b, at=mid, early_exit=ee)
    hc = svc.submit(task_c, at=2 * svc._meta["tenant-a"].spec.duration,
                    early_exit=ee)
    hc.cancel(at=mid)
    report = svc.run_until_idle()
    assert [h.status().state for h in (ha, hb, hc)] == [
        TSVC.TaskState.COMPLETED, TSVC.TaskState.COMPLETED,
        TSVC.TaskState.CANCELLED]
    with pytest.raises(TSVC.TaskCancelled):
        hc.result()
    assert "tenant-c" not in lcs                # never trained
    assert report.task_starts["tenant-b"] >= mid - 1e-9
    assert "tenant-c" in report.cancelled
    for task in (task_a, task_b):               # keys (arch, gpus) differ
        key = engine.profile_key(task)
        assert svc.profile_store.observations(key) == 1
        assert svc.profile_store.wall_step_time(key) > 0.0
        assert len(svc.profile_store.step_observations(key)) == 1
    kinds = {e.kind for e in report.events}
    assert {EventKind.TASK_ARRIVED, EventKind.TASK_CANCELLED} <= kinds
    for handle, task in ((ha, task_a), (hb, task_b)):
        res = handle.result()
        assert np.isfinite(res.best_val)
        alone, lc = _alone(env, task, ee)
        assert _same(res, alone, lcs[task.task_name], lc), task.task_name


def _serving(env, Z, lanes=2):
    cfg, _, params = env
    pool = AdapterPool(cfg, Z, device="cpu")
    rep = ServingReplica(cfg, params, pool, lanes=lanes, max_len=16,
                         device="cpu")
    return pool, ServingFrontend(rep)


def _serve_tokens(fe, aid, prompt, n=6):
    rid = fe.submit(aid, prompt, n)
    fe.drain()
    return fe.result(rid)


def _fresh_tokens(env, adapter, rank, aid, prompt):
    """The same request through a fresh pool, replica and frontend, into
    which the live adapter was published."""
    pool, fe = _serving(env, 2)
    pool.publish(aid, adapter, rank)
    return _serve_tokens(fe, aid, prompt)


def test_tune_to_serve_end_to_end(env, tmp_path):
    cfg, ds, _ = env
    serve_dir = str(tmp_path / "serve")
    svc = TSVC.TuningService(engine=_engine(env, total_gpus=2),
                             serve_dir=serve_dir)
    pool, fe = _serving(env, 2)
    svc.attach_serving(fe, gpus=1, horizon_s=10_000.0)
    task = TENG.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=6,
                     num_slots=2, name="tenant-a",
                     search_space={"lr": [1e-3, 3e-3], "rank": [4]})
    res = svc.submit(task, early_exit=EarlyExitConfig(**EE)).result()
    assert res.samples_saved_frac > 0.0
    path = svc._ckpt_paths["tenant-a"]
    meta = json.loads(str(np.load(path, allow_pickle=False)["__meta__"]))
    jr = res.job_results[res.best_job]
    assert (meta["rank"], meta["spec_version"], meta["arch"],
            meta["fuse_key"], meta["job"]) == (
        jr.config.lora_rank, SPEC_VERSION, cfg.name, [cfg.name, 1, "sft"],
        res.best_job)
    assert pool.resident() == {"tenant-a": 0}
    assert pool.slot_rank[0] == jr.config.lora_rank
    evs = [e for e in svc._runtime_events()
           if e.kind is EventKind.ADAPTER_PUBLISHED]
    assert len(evs) == 1 and evs[0].reason == "published"
    assert "from=checkpoint" in evs[0].detail
    prompt = np.arange(5, dtype=np.int32) % cfg.vocab_size
    assert _serve_tokens(fe, "tenant-a", prompt) == _fresh_tokens(
        env, jr.adapter, jr.config.lora_rank, "tenant-a", prompt)


def test_tune_to_serve_pool_full_keeps_artifact(env, tmp_path):
    cfg, ds, _ = env
    svc = TSVC.TuningService(engine=_engine(env, total_gpus=2),
                             serve_dir=str(tmp_path / "serve"))
    pool, fe = _serving(env, 1, lanes=1)
    zeros = {t: {m: torch.zeros(x.shape) for m, x in ab.items()}
             for t, ab in adapter_template(cfg).items()}
    pool.publish("squatter", zeros, 4)          # the pool is already full
    svc.attach_serving(fe, gpus=1, horizon_s=10_000.0)
    task = TENG.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=4,
                     num_slots=1, name="tenant-b",
                     search_space={"lr": [1e-3]})
    svc.submit(task, early_exit=EarlyExitConfig(
        warmup_ratio=0.25, select_ratio=1.0)).result()
    evs = [e for e in svc._runtime_events()
           if e.kind is EventKind.ADAPTER_PUBLISHED]
    assert len(evs) == 1 and evs[0].reason == "refused"
    assert "tenant-b" not in pool.resident()
    fe.retire("squatter")
    assert fe.publish_checkpoint(svc._ckpt_paths["tenant-b"]) == "tenant-b"
    assert pool.resident() == {"tenant-b": 0}


def test_recover_republishes_finished_winners(env, tmp_path):
    """A session whose first task finished (artifact under serve_dir) and
    whose second crashed mid-task: ``recover(serve_frontend=)`` republishes
    the first from its artifact to a fresh frontend, resumes the second
    from its checkpoint and publishes it there on completion; both serve
    the tokens of their live winners."""
    cfg, ds, _ = env
    ee = EarlyExitConfig(**EE)
    sd, serve_dir = str(tmp_path / "state"), str(tmp_path / "serve")

    def tasks():
        return [TENG.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=6,
                          num_slots=2, name=n, search_space=s)
                for n, s in (("first", {"lr": [1e-3, 3e-3], "rank": [4]}),
                             ("second", {"lr": [1e-3], "rank": [4, 8]}))]
    svc = TSVC.TuningService(engine=_engine(env, total_gpus=1),
                             state_dir=sd, serve_dir=serve_dir)
    svc._ckpt.fail_after["second"] = 2
    first, second = tasks()
    h1 = svc.submit(first, early_exit=ee)
    h2 = svc.submit(second, early_exit=ee,
                    at=2 * svc._meta["first"].spec.duration)
    res1 = h1.result()
    with pytest.raises(SimulatedCrash):
        h2.result()
    assert replay_journal(sd).terminal_tasks() == {"first"}
    pool, fe = _serving(env, 2)
    rec = TSVC.TuningService.recover(
        sd, tasks=[(t, ee) for t in tasks()], serve_frontend=fe,
        engine=_engine(env, total_gpus=1))
    assert pool.resident() == {"first": 0}
    rep = rec.run_until_idle()
    assert set(rep.task_results) == {"second"}
    res2 = rep.task_results["second"]
    assert set(pool.resident()) == {"first", "second"}
    by = {e.task: e for e in rep.events
          if e.kind is EventKind.ADAPTER_PUBLISHED}
    assert by["first"].reason == "republished"
    assert by["second"].reason == "published"
    recov = [e for e in rep.events if e.kind is EventKind.TASK_RECOVERED]
    assert [(e.task, e.reason) for e in recov] == [("second", "resumed")]
    prompt = np.arange(5, dtype=np.int32) % cfg.vocab_size
    for name, res in (("first", res1), ("second", res2)):
        jr = res.job_results[res.best_job]
        assert _serve_tokens(fe, name, prompt) == _fresh_tokens(
            env, jr.adapter, jr.config.lora_rank, name, prompt), name


# ---------------------------------------------------------------------------
# (c) one session through both packages
# ---------------------------------------------------------------------------

def test_one_session_through_both_packages(monkeypatch):
    """Two tasks, 6 steps, the second arriving mid-flight, on a virtual
    cluster of 2 at the reference's profiler constants. The port's backbone
    is the JAX package's (``_base_params`` patched to the bridged weights),
    and each job's fresh adapter is the one the JAX run drew for it (the two
    packages draw inits differently by design). Each task's learning rates
    differ 10x, so no early-exit decision is near a tie."""
    from repro.core import adapter_state as JAS
    from repro.core import engine as JENG
    from repro.core.early_exit import EarlyExitConfig as JEarlyExitConfig
    from repro.data import synthetic as JSYN
    from repro.models import model as JM
    from repro_torch.core import adapter_state as TAS
    for name in ("PEAK_FLOPS_BF16", "HBM_BYTES_PER_S", "HBM_BYTES"):
        monkeypatch.setattr(TPR, name, getattr(JPR, name))
    monkeypatch.setattr(JPR, "_CACHE", {})
    monkeypatch.setattr(TPR, "_CACHE", {})
    kw = dict(num_layers=2, d_model=128, vocab=256)
    jcfg = reduced_f32("paper-llama-tiny", **kw)
    tcfg = dataclasses.replace(get_arch("paper-llama-tiny").reduced(**kw),
                               dtype="float32")
    dkw = dict(seq_len=16, num_train=32, num_val=8, difficulty=0.2)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    inits = {}
    jadmit, tadmit = JAS.SlotManager.admit, TAS.SlotManager.admit

    def jax_admit(self, slot, job_id, *args, **kwargs):
        jadmit(self, slot, job_id, *args, **kwargs)
        inits[job_id] = jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(x[:, slot])), self.lora)

    def port_admit(self, slot, job_id, *args, **kwargs):
        tadmit(self, slot, job_id, *args, **kwargs)
        TAS._i_slot(self.lora, slot, inits[job_id])
    monkeypatch.setattr(JAS.SlotManager, "admit", jax_admit)
    monkeypatch.setattr(TAS.SlotManager, "admit", port_admit)
    spaces = (("tenant-a", {"lr": [1e-3, 1e-2], "batch_size": [2]}),
              ("tenant-b", {"lr": [3e-4, 3e-3], "rank": [8]}))
    got = {}
    for pkg, alto, SYN, cfg, ee in (
            ("jax", JENG, JSYN, jcfg, JEarlyExitConfig(**EE)),
            ("torch", TENG, TSYN, tcfg, EarlyExitConfig(**EE))):
        ds = SYN.make_task_dataset("both", cfg.vocab_size, **dkw)
        svc = _service(pkg, total_gpus=2, eval_every=2)
        if pkg == "jax":
            svc.engine._param_cache[cfg.name] = jparams
        else:
            monkeypatch.setattr(svc.engine, "_base_params",
                                lambda cfg, seed=0: tparams)
        tasks = [alto.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=6,
                           num_slots=2, name=n, search_space=s,
                           device_memory=JPR.HBM_BYTES)
                 for n, s in spaces]
        h = svc.submit(tasks[0], early_exit=ee)
        svc.submit(tasks[1], early_exit=ee,
                   at=0.5 * svc._meta["tenant-a"].spec.duration)
        h.result()
        rep = svc.run_until_idle()
        got[pkg] = dict(
            events=[(e.kind.value, e.task, e.job) for e in rep.events],
            starts=rep.task_starts, ends=rep.task_ends,
            makespan=rep.makespan, colocated=rep.colocated,
            best={n: (r.best_job, float(r.best_val))
                  for n, r in rep.task_results.items()})
    assert len(inits) == 4                      # every job admitted once
    j, t = got["jax"], got["torch"]
    assert t["events"] == j["events"]
    assert t["colocated"] == j["colocated"]
    for key in ("starts", "ends"):
        assert t[key].keys() == j[key].keys()
        for n in j[key]:
            assert t[key][n] == pytest.approx(j[key][n], abs=1e-9), (key, n)
    assert t["makespan"] == pytest.approx(j["makespan"], abs=1e-9)
    assert set(t["best"]) == {"tenant-a", "tenant-b"}
    for n, (job, val) in j["best"].items():
        assert t["best"][n][0] == job, n
        np.testing.assert_allclose(t["best"][n][1], val, **GTOL)
