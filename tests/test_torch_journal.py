"""PyTorch port: the write-ahead journal and the chaos harness, against the
JAX package's.

(a) The journal (``sched/journal.py``): rotation, a torn tail and a corrupt
    segment (tests/test_recovery.py:34, :73, :88) replay to the same
    records and flags in both packages; a journal written by either
    package's ``EventJournal`` replays in the other to equal records; the
    service's ``_task_record`` / ``_task_from_record`` round trip a
    string-named task equally in both packages (no training).
(b) Chaos (``sched/chaos.py``): ``FaultPlan``-wrapped simulated workloads
    give equal static and elastic reports in both packages, with elastic
    <= static under injection (tests/test_recovery.py:288, its 15
    derandomized examples); a ``FaultyTaskDriver`` returns the unfaulted
    result bit for bit around a simulated driver (:310) and around the
    port's ``ExecutorTaskDriver`` on a reduced float32 config on the CPU;
    a pod kill through ``inject_fault`` requeues and completes with the
    port's report equal to the JAX package's (:334).
(c) Kill and recover through the port's service, on the CPU
    (tests/test_recovery.py:178, :193, :211): a task of mixed ranks and
    widths with more jobs than slots, crashed by ``SimulatedCrash`` after
    its third durable checkpoint and rebuilt by ``TuningService.recover``
    from the journal, equals the uninterrupted session bit for bit (best
    job and value, every job, loss and validation histories, kept adapters)
    with fewer steps run; trashed snapshots degrade to a requeue from zero,
    and a corrupt journal line makes recovery distrust every snapshot; both
    still equal the uninterrupted run, with as many steps.

The host code is a verbatim copy, so every comparison in (a) and (b) is
exact.
"""
import dataclasses
import glob
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import service as JSVC
from repro.core.early_exit import EarlyExitConfig as JEarlyExitConfig
from repro.sched import chaos as JCH
from repro.sched import cluster as JCL
from repro.sched import events as JEV
from repro.sched import inter_task as JIT
from repro.sched import journal as JJN
from repro_torch.checkpoint.taskstate import SimulatedCrash
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import engine as TENG
from repro_torch.core import service as TSVC
from repro_torch.core.early_exit import EarlyExitConfig
from repro_torch.core.executor import BatchedExecutor
from repro_torch.data import synthetic as TSYN
from repro_torch.models import model as TM
from repro_torch.sched import chaos as TCH
from repro_torch.sched import cluster as TCL
from repro_torch.sched import events as TEV
from repro_torch.sched import inter_task as TIT
from repro_torch.sched import journal as TJN
from tests.test_torch_engine import _record_lifecycles, _same
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401

PKGS = {"jax": (JJN, JEV, JCH, JCL, JIT, JSVC),
        "torch": (TJN, TEV, TCH, TCL, TIT, TSVC)}
CHUNK_STEPS = 5      # SimulatedTaskDriver default


# ---------------------------------------------------------------------------
# (a) the journal
# ---------------------------------------------------------------------------

def _records(EV):
    """tests/test_recovery.py:34's seven records, events by ``EV``."""
    return [{"rec": "session", "total_gpus": 4},
            {"rec": "submit", "name": "a", "kind": "driver",
             "spec": {"name": "a", "duration": 1.0, "gpus": 1,
                      "release": 0.0}},
            {"rec": "submit", "name": "b", "kind": "driver",
             "spec": {"name": "b", "duration": 2.0, "gpus": 2,
                      "release": 0.0}},
            {"rec": "ckpt", "task": "a", "path": "/x/1.npz", "chunk": 1,
             "remaining_steps_bound": 10},
            {"rec": "ckpt", "task": "a", "path": "/x/2.npz", "chunk": 2,
             "remaining_steps_bound": 5},
            {"rec": "event", "event": EV.event_to_json(EV.ProgressEvent(
                kind=EV.EventKind.TASK_COMPLETED, task="b", time=3.0))},
            {"rec": "serve", "task": "b", "path": "/s/b.npz"}]


def _replay(rep):
    return (rep.records, [os.path.basename(p) for p in rep.corrupt],
            rep.torn_tail, rep.session(), rep.submits(),
            rep.terminal_tasks(), rep.checkpoints(), rep.serves())


def _rotation(pkg, sd):
    JN, EV = PKGS[pkg][:2]
    j = JN.EventJournal(sd, rotate_every=3)
    for r in _records(EV):
        j.append(r)
    j.close()
    segs = len(glob.glob(os.path.join(sd, "journal", "segment-*.jsonl")))
    first = _replay(JN.replay_journal(sd))
    # a new journal over the same dir keeps appending, not clobbering
    j2 = JN.EventJournal(sd, rotate_every=3)
    j2.append({"rec": "event", "event": EV.event_to_json(EV.ProgressEvent(
        kind=EV.EventKind.TASK_CANCELLED, task="a", time=4.0))})
    j2.close()
    return segs, first, _replay(JN.replay_journal(sd))


def _torn_tail(pkg, sd):
    JN = PKGS[pkg][0]
    j = JN.EventJournal(sd)
    j.append({"rec": "submit", "name": "a", "kind": "driver", "spec": {}})
    j.append({"rec": "submit", "name": "b", "kind": "driver", "spec": {}})
    j.close()
    with open(os.path.join(sd, "journal", "current.jsonl"), "a") as f:
        f.write('{"rec": "submit", "name": "c"')   # crash mid-append
    return _replay(JN.replay_journal(sd))


def _corrupt_segment(pkg, sd):
    JN = PKGS[pkg][0]
    j = JN.EventJournal(sd)
    for n in ("a", "b", "c"):
        j.append({"rec": "submit", "name": n, "kind": "driver", "spec": {}})
    j.close()
    cur = os.path.join(sd, "journal", "current.jsonl")
    lines = open(cur).read().splitlines()
    lines[1] = lines[1][: len(lines[1]) // 2]       # mid-file truncation
    with open(cur, "w") as f:
        f.write("\n".join(lines) + "\n")
    return _replay(JN.replay_journal(sd))


@pytest.mark.parametrize("case", [_rotation, _torn_tail, _corrupt_segment],
                         ids=["rotation", "torn_tail", "corrupt_segment"])
def test_journal_replays_as_the_reference(case, tmp_path):
    got = {pkg: case(pkg, str(tmp_path / pkg)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    out = got["torch"]
    if case is _rotation:
        segs, first, second = out
        assert segs == 2
        assert not first[1] and not first[2]
        assert first[3]["total_gpus"] == 4
        assert sorted(r["name"] for r in first[4]) == ["a", "b"]
        assert first[5] == {"b"} and second[5] == {"a", "b"}
        assert first[6]["a"]["chunk"] == 2          # latest wins
        assert first[7] == {"b": "/s/b.npz"}
    elif case is _torn_tail:
        assert out[2] and not out[1]                # torn, not corrupt
        assert sorted(r["name"] for r in out[4]) == ["a", "b"]
    else:
        assert out[1] == ["current.jsonl"]          # not a torn tail
        assert "a" in {r["name"] for r in out[4]}   # prefix still usable


@pytest.mark.parametrize("writer", sorted(PKGS))
def test_journal_written_by_one_package_replays_in_the_other(writer,
                                                             tmp_path):
    """Both packages' events, a rotation, and the session, submit, ckpt
    and serve records; the other package's replay reads the same records,
    and its events parse back to the writer's."""
    sd = str(tmp_path / "state")
    JN, EV = PKGS[writer][:2]
    j = JN.EventJournal(sd, rotate_every=4)
    recs = _records(EV) + [
        {"rec": "event", "event": EV.event_to_json(EV.ProgressEvent(
            kind=EV.EventKind.POD_KILLED, task="a", time=1.5, job="a/j",
            reason="injected", step=7, dropped=("x", "y"),
            detail="backoff=0.3"))}]
    for r in recs:
        j.append(r)
    j.close()
    reps = {pkg: _replay(PKGS[pkg][0].replay_journal(sd)) for pkg in PKGS}
    assert reps["torch"] == reps["jax"]
    assert len(reps["torch"][0]) == len(recs)
    for pkg in PKGS:
        ev = PKGS[pkg][1]
        events = [ev.event_from_json(r["event"])
                  for r in reps[pkg][0] if r["rec"] == "event"]
        assert [e.kind.value for e in events] == [
            "task_completed", "pod_killed"]
        assert events[1].dropped == ("x", "y")


def test_task_record_round_trips_in_both_packages():
    """A task named by strings (registry arch, dataset name) journals the
    same record in both packages and rebuilds the same task and early-exit
    config; an in-memory model is not journaled by either."""
    from repro.core import engine as JENG
    from repro_torch.core import engine as TENG
    space = {"lr": [1e-4, 1e-3], "rank": [8, 32], "batch_size": [2, 4]}
    got = {}
    ee_kw = dict(warmup_ratio=0.2, select_ratio=0.5)
    for pkg, alto, ee in (("jax", JENG, JEarlyExitConfig(**ee_kw)),
                          ("torch", TENG, EarlyExitConfig(**ee_kw))):
        SVC = PKGS[pkg][5]
        task = alto.Task(model="stablelm-3b", dataset="svc-data",
                         search_space=space, num_gpus=2, max_steps=12,
                         num_slots=4, seed=3, name="tenant-r",
                         device_memory=2 ** 34)
        rec = SVC._task_record(task, ee)
        back, ee_back = SVC._task_from_record(rec)
        got[pkg] = (rec, dataclasses.asdict(back),
                    dataclasses.asdict(ee_back),
                    {k: dataclasses.asdict(v) for k, v in back.jobs().items()})
        assert dataclasses.asdict(back) == dataclasses.asdict(task)
        assert ee_back == ee
        cfg = alto.Task(model="stablelm-3b", dataset="d",
                        search_space=space).model_config()
        assert SVC._task_record(alto.Task(model=cfg, dataset="d",
                                          search_space=space), ee) is None
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# (b) chaos
# ---------------------------------------------------------------------------

def _chaos_params(rng, G):
    """tests/test_recovery.py:_chaos_workload's draws, as keyword dicts."""
    out = []
    for i in range(int(rng.integers(2, 6))):
        K = int(rng.integers(2, 16))
        Z = int(rng.integers(1, 5))
        total = int(rng.integers(10, 120))
        warm = int(rng.integers(1, max(total // 4, 2)))
        step_time = float(rng.uniform(0.005, 0.05))
        gpus = int(rng.integers(1, G + 1))
        work = total * step_time
        faults = ()
        if rng.random() < 0.7:
            faults = tuple(
                (float(rng.uniform(0.0, work)), float(rng.uniform(0.0, 0.5)))
                for _ in range(int(rng.integers(1, 4))))
        out.append(dict(name=f"t{i}", K=K, Z=Z, total=total, warm=warm,
                        step_time=step_time, gpus=gpus, faults=faults))
    return out


def _chaos_tasks(pkg, params):
    CH, CL = PKGS[pkg][2], PKGS[pkg][3]
    plan = CH.FaultPlan(faults={
        p["name"]: tuple(CH.Fault(a, b) for a, b in p["faults"])
        for p in params if p["faults"]})
    tasks = []
    for p in params:
        faults = plan.for_task(p["name"])
        cb = CHUNK_STEPS * p["step_time"]
        spec = CH.chaos_spec(CL.sim_task_spec(
            p["name"], K=p["K"], Z=p["Z"], total_steps=p["total"],
            warmup_steps=p["warm"], step_time_s=p["step_time"],
            gpus=p["gpus"]), faults, cb)

        def factory(p=p, faults=faults, cb=cb):
            inner = CL.SimulatedTaskDriver(
                p["name"], K=p["K"], Z=p["Z"], total_steps=p["total"],
                warmup_steps=p["warm"], step_time_s=p["step_time"])
            return CH.FaultyTaskDriver(p["name"], inner, faults, cb)
        tasks.append((spec, factory))
    return plan, tasks


def _rt_report(pkg, rep):
    EV = PKGS[pkg][1]
    return (rep.makespan, [(p.task.name, p.start, tuple(p.gpu_ids))
                           for p in rep.realized.placements],
            [EV.event_to_json(e) for e in rep.events], rep.replans,
            rep.plans_adopted, rep.plans_rejected, rep.gpu_busy,
            rep.utilization, rep.results, rep.task_starts, rep.task_ends,
            rep.cancelled, rep.pod_kills)


@settings(deadline=None, max_examples=15, derandomize=True)
@given(seed=st.integers(0, 10_000), G=st.sampled_from([2, 4, 8]))
def test_chaos_reports_match_and_elastic_le_static(seed, G):
    """The reference's chaos property, in both packages on the same draws:
    equal static and elastic reports, and elastic <= static with every
    planned fault injected."""
    params = _chaos_params(np.random.default_rng(seed), G)
    got = {}
    for pkg in PKGS:
        IT, CL = PKGS[pkg][4], PKGS[pkg][3]
        plan_faults, tasks = _chaos_tasks(pkg, params)
        plan = IT.solve([s for s, _ in tasks], G, "cp")
        static = CL.execute_static(plan, G, {s.name: f for s, f in tasks})
        rt = CL.ElasticClusterRuntime(G)
        for s, f in tasks:
            rt.submit(s, f)
        elastic = rt.run(initial=plan)
        assert elastic.makespan <= static.makespan + 1e-9
        injected = sum(1 for e in elastic.events
                       if e.kind.value == "replica_failed")
        assert injected == plan_faults.total()
        got[pkg] = (static.makespan, static.results, static.task_starts,
                    static.task_ends, _rt_report(pkg, elastic))
    assert got["torch"] == got["jax"]


def test_faulty_simulated_driver_result_is_unfaulted():
    """tests/test_recovery.py:310 in both packages: the same result as the
    clean driver, the same billed wall, two faults injected."""
    got = {}
    for pkg in PKGS:
        CH, CL = PKGS[pkg][2], PKGS[pkg][3]

        def clean():
            return CL.SimulatedTaskDriver("t", K=6, Z=3, total_steps=40,
                                          warmup_steps=4, step_time_s=0.02)
        base = clean()
        base.start(0.0)
        while not base.step_chunk().done:
            pass
        faulty = CH.FaultyTaskDriver(
            "t", clean(), [CH.Fault(0.2, 0.1), CH.Fault(0.5, 0.3)], 0.1)
        faulty.start(0.0)
        wall, kinds = 0.0, []
        while True:
            ch = faulty.step_chunk()
            wall += ch.dt
            kinds += [e.kind.value for e in ch.events]
            if ch.done:
                break
        assert faulty.faults_injected == 2
        assert wall > 40 * 0.02
        assert faulty.result() == base.result()
        got[pkg] = (wall, kinds, faulty.result())
    assert got["torch"] == got["jax"]


def _summary(res):
    return (res.best_job, res.best_val, res.total_samples,
            res.samples_saved_frac, res.exit_counts,
            {j: (r.best_val, r.best_val_step, r.exit_reason, r.steps_trained,
                 r.samples_trained) for j, r in res.job_results.items()})


def test_faulty_executor_driver_result_is_unfaulted():
    """Around the port's ``ExecutorTaskDriver`` (a reduced float32 rank
    sweep on the CPU): the faults bill time and REPLICA_FAILED events, and
    the TaskResult is the unfaulted driver's bit for bit."""
    cfg = dataclasses.replace(get_arch("paper-llama-tiny").reduced(
        num_layers=2, d_model=64, vocab=128), dtype="float32")
    params = TM.init_params(cfg, seed=0, device="cpu")
    ds = TSYN.make_task_dataset("chaos", cfg.vocab_size, seq_len=16,
                                num_train=32, num_val=8, difficulty=0.2)
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=2)
            for r in (2, 4) for lr in (1e-3, 3e-3)}
    step_s = 0.01

    def driver():
        bx = BatchedExecutor(cfg, params, ds, Z=2, per_adapter_batch=2,
                             ee=EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.5),
                             eval_every=2,
                             device="cpu")
        return TCL.ExecutorTaskDriver("sweep", bx, jobs, 8, step_s)

    def drain(drv):
        drv.start(0.0)
        wall, failed = 0.0, 0
        while True:
            ch = drv.step_chunk()
            wall += ch.dt
            failed += sum(e.kind is TEV.EventKind.REPLICA_FAILED
                          for e in ch.events)
            if ch.done:
                return wall, failed
    clean = driver()
    wall0, failed0 = drain(clean)
    faults = [TCH.Fault(0.5 * wall0, 0.05), TCH.Fault(0.9 * wall0, 0.0)]
    faulty = TCH.FaultyTaskDriver("sweep", driver(), faults,
                                  chunk_bound=wall0)
    wall1, failed1 = drain(faulty)
    assert (failed0, failed1, faulty.faults_injected) == (0, 2, 2)
    assert wall1 > wall0 + 0.05
    a, b = clean.result(), faulty.result()
    assert _summary(a) == _summary(b)
    for j, ra in a.job_results.items():
        rb = b.job_results[j]
        assert (ra.adapter is None) == (rb.adapter is None)
        if ra.adapter is not None:
            assert all(torch.equal(ra.adapter[t][m], rb.adapter[t][m])
                       for t in ra.adapter for m in ra.adapter[t])


POD_DEFS = [dict(K=8, Z=4, total=60, warm=4, step_time=0.02, gpus=2),
            dict(K=6, Z=2, total=40, warm=3, step_time=0.03, gpus=1),
            dict(K=12, Z=4, total=80, warm=5, step_time=0.01, gpus=4)]


def test_pod_kill_requeues_and_completes_as_the_reference():
    """tests/test_recovery.py:334 in both packages: one POD_KILLED, every
    task finished, t0 started twice, bounded degradation; equal reports."""
    G, backoff = 4, 0.3
    got = {}
    for pkg in PKGS:
        CL = PKGS[pkg][3]

        def build():
            rt = CL.ElasticClusterRuntime(G)
            for i, kw in enumerate(POD_DEFS):
                name = f"t{i}"
                spec = CL.sim_task_spec(
                    name, K=kw["K"], Z=kw["Z"], total_steps=kw["total"],
                    warmup_steps=kw["warm"], step_time_s=kw["step_time"],
                    gpus=kw["gpus"])

                def factory(name=name, kw=kw):
                    return CL.SimulatedTaskDriver(
                        name, K=kw["K"], Z=kw["Z"], total_steps=kw["total"],
                        warmup_steps=kw["warm"], step_time_s=kw["step_time"])
                rt.submit(spec, factory)
            return rt
        base = build().run()
        rt = build()
        rt.begin()
        start, end = base.task_starts["t0"], base.task_ends["t0"]
        rt.inject_fault("t0", at=start + 0.5 * (end - start),
                        backoff=backoff)
        while rt.step():
            pass
        rep = rt.report()
        kills = [e for e in rep.events if e.kind.value == "pod_killed"]
        assert len(kills) == 1 and rep.pod_kills == 1
        assert set(rep.results) == {"t0", "t1", "t2"}
        assert sum(1 for e in rep.events if e.kind.value == "task_started"
                   and e.task == "t0") == 2
        chunk = CHUNK_STEPS * max(kw["step_time"] for kw in POD_DEFS)
        assert rep.makespan <= base.makespan + backoff + 3 * chunk + 1e-9
        got[pkg] = (_rt_report(pkg, base), _rt_report(pkg, rep))
    assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# (c) kill and recover through the service
# ---------------------------------------------------------------------------

EE = dict(warmup_ratio=0.2, select_ratio=0.5)


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(get_arch("paper-llama-tiny").reduced(
        num_layers=2, d_model=128, vocab=256), dtype="float32")
    ds = TSYN.make_task_dataset("rec", cfg.vocab_size, seq_len=16,
                                num_train=32, num_val=8, difficulty=0.2)
    return cfg, ds, TM.init_params(cfg, seed=0, device="cpu")


def _mk_task(tiny):
    """tests/test_recovery.py:_mk_task: widths 2 and 4, ranks 4 and 8, 8
    jobs on 2 slots, so the crash lands mid-rotation."""
    cfg, ds, _ = tiny
    return TENG.Task(model=cfg, dataset=ds, num_gpus=2, max_steps=10,
                     num_slots=2, name="tenant-r",
                     search_space={"lr": [1e-3, 3e-3], "rank": [4, 8],
                                   "batch_size": [2, 4]})


def _engine(tiny):
    """An engine over the shared backbone, recording every lifecycle."""
    cfg, _, params = tiny
    engine = TENG.Engine(total_gpus=4, eval_every=2, device="cpu")
    engine._param_cache[cfg.name] = params
    return engine, _record_lifecycles(engine)


@pytest.fixture(scope="module")
def baseline(tiny):
    engine, lcs = _engine(tiny)
    svc = TSVC.TuningService(engine=engine)
    res = svc.submit(_mk_task(tiny), early_exit=EarlyExitConfig(**EE)
                     ).result()
    return res, lcs["tenant-r"], svc._meta["tenant-r"].driver._steps


def _crash_run(tiny, sd, fail_after):
    engine, _ = _engine(tiny)
    svc = TSVC.TuningService(engine=engine, state_dir=sd, ckpt_every=1)
    svc._ckpt.fail_after["*"] = fail_after
    h = svc.submit(_mk_task(tiny), early_exit=EarlyExitConfig(**EE))
    with pytest.raises(SimulatedCrash):
        h.result()


def _trash_snapshots(sd):
    for p in glob.glob(os.path.join(sd, "ckpt", "*", "*.npz")):
        with open(p, "wb") as f:
            f.write(b"\x00" * 100)


def _corrupt_journal(sd):
    cur = os.path.join(sd, "journal", "current.jsonl")
    lines = open(cur).read().splitlines()
    assert len(lines) > 3
    lines[2] = "{garbage"                       # mid-file corruption
    with open(cur, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("damage,fail_after,reason", [
    (None, 3, "resumed"), (_trash_snapshots, 2, "requeued"),
    (_corrupt_journal, 2, "requeued")],
    ids=["bitwise", "corrupt_checkpoint", "corrupt_journal"])
def test_kill_and_recover(tiny, baseline, tmp_path, damage, fail_after,
                          reason):
    res0, lc0, steps0 = baseline
    sd = str(tmp_path / "state")
    _crash_run(tiny, sd, fail_after)
    rep0 = TJN.replay_journal(sd)
    assert [r["name"] for r in rep0.submits()] == ["tenant-r"]
    assert len(rep0.checkpoints()) == 1
    assert rep0.session()["ckpt_every"] == 1
    assert not rep0.terminal_tasks()
    if damage is not None:
        damage(sd)
    engine, lcs = _engine(tiny)
    svc = TSVC.TuningService.recover(
        sd, tasks=[(_mk_task(tiny), EarlyExitConfig(**EE))], engine=engine)
    rep = svc.run_until_idle()
    res = rep.task_results["tenant-r"]
    assert _same(res, res0, lcs["tenant-r"], lc0)
    steps = svc._meta["tenant-r"].driver._steps
    assert steps < steps0 if reason == "resumed" else steps == steps0
    recov = [e for e in rep.events if e.kind is TEV.EventKind.TASK_RECOVERED]
    assert [(e.task, e.reason) for e in recov] == [("tenant-r", reason)]
    after = TJN.replay_journal(sd)
    if damage is _corrupt_journal:
        # replay stops at the bad line: what the session appended after it
        # stays unread, so the file stays flagged
        assert after.corrupt
    else:
        assert "tenant-r" in after.terminal_tasks()
