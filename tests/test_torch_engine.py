"""PyTorch port: the engine (paper Listing 1) over the scheduler and executor.

(a) Host decisions equal the JAX engine's, exactly, on
    ``tests/test_executor_engine.py::test_engine_api_listing1``'s set-up
    (reduced float32 paper-llama-tiny, Listing 1's two tasks,
    ``total_gpus=4``) with the port profiler's constants patched to the
    reference's TPU v5e ones: ``Task.jobs()``, ``pick_slots``,
    ``memory_model``, ``colocation_spec``, ``profile_raw``, ``profile`` and
    ``schedule``. No JAX training runs. Both merge search-space points
    that differ only in weight decay into one job.
(b) Unpatched, the H100 constants are the whole difference: the analytic
    step time is the reference's x 197/989 where the step is compute-bound
    and x 819e9/3.35e12 where it is memory-bound. ``measure_throughput``
    syncs the card only for outputs on it.
(c) Inside the port, bit for bit (best job and value, every job's exit,
    steps, samples, loss and validation histories, and the winners'
    adapters): static ``batched_execution`` gives each task the
    ``TaskResult`` of that task run alone through ``BatchedExecutor``; an
    ``ElasticClusterRuntime`` over ``executor_driver_factory`` drivers
    gives the static run's results, with a virtual makespan no larger; a
    control task with ``seed + 1`` differs. On a virtual cluster of 2
    GPUs one task waits for the others. The three tasks reach the dense,
    rank-local and ragged LoRA Functions. Weights come from the JAX
    package through ``bridge``.
(d) ``batched_execution(strategy="elastic")``, the default, is a one-shot
    tuning-service session: each task's result equals the static run's
    bit for bit, with a virtual makespan no larger.

Everything runs on the CPU (``device="cpu"``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JENG
from repro.data import synthetic as JSYN
from repro.models import model as JM
from repro.sched import profiler as JPR
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.core import engine as TENG
from repro_torch.core.executor import BatchedExecutor
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels.grouped_lora import ops as TOPS
from repro_torch.sched import profiler as TPR
from repro_torch.sched.cluster import ElasticClusterRuntime
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401
from tests.test_torch_grouped_lora import _spy

EE = dict(warmup_ratio=0.2, select_ratio=0.5)
CONSTANTS = ("PEAK_FLOPS_BF16", "HBM_BYTES_PER_S", "HBM_BYTES")


def _configs():
    kw = dict(num_layers=2, d_model=128, vocab=256)
    return (reduced_f32("paper-llama-tiny", **kw), dataclasses.replace(
        get_arch("paper-llama-tiny").reduced(**kw), dtype="float32"))


def _datasets(jcfg):
    kw = dict(seq_len=32, num_train=64, num_val=16, difficulty=0.2)
    return (JSYN.make_task_dataset("t", jcfg.vocab_size, **kw),
            TSYN.make_task_dataset("t", jcfg.vocab_size, **kw))


def _listing1(alto, cfg, ds, num_slots=2, **extra):
    """Listing 1's two tasks (test_engine_api_listing1)."""
    return [alto.Task(model=cfg, dataset=ds, num_gpus=2, max_steps=10,
                      num_slots=num_slots,
                      search_space={"lr": [1e-3, 3e-3], "batch_size": [2]},
                      **extra),
            alto.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=10,
                      num_slots=num_slots, name="task-b",
                      search_space={"lr": [1e-3], "rank": [4, 8]},
                      **extra)]


@pytest.fixture
def fresh_profiles(monkeypatch):
    """Both packages' analytic-profile caches emptied (their keys do not
    hold the constants)."""
    monkeypatch.setattr(JPR, "_CACHE", {})
    monkeypatch.setattr(TPR, "_CACHE", {})


def _asdict(x):
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _host_decisions(alto, engine, tasks, ee):
    sched = engine.schedule(tasks, method="cp", early_exit=ee)
    return {
        "jobs": [{k: dataclasses.asdict(tc) for k, tc in t.jobs().items()}
                 for t in tasks],
        "pick_slots": [engine.pick_slots(t) for t in tasks],
        "memory_model": [_asdict(engine.memory_model(t)) for t in tasks],
        "colocation_spec": [_asdict(engine.colocation_spec(t))
                            for t in tasks],
        "task_rank": [engine.task_rank(t) for t in tasks],
        "step_time": [engine.profiled_step_time(t) for t in tasks],
        "profile_raw": [_asdict(engine.profile_raw(t, ee)) for t in tasks],
        "profile": [_asdict(engine.profile(t, ee)) for t in tasks],
        "schedule": ([(p.task.name, p.task.duration, p.task.gpus, p.start,
                       tuple(p.gpu_ids)) for p in sched.placements],
                     sched.makespan, sched.optimal),
    }


# ---------------------------------------------------------------------------
# (a) host decisions == the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_slots", [2, 0], ids=["listing1", "sized"])
def test_host_decisions_match_reference(num_slots, monkeypatch,
                                        fresh_profiles):
    """``num_slots=0`` sizes Z from the memory model (``pick_slots``)."""
    for name in CONSTANTS:
        monkeypatch.setattr(TPR, name, getattr(JPR, name))
    jcfg, tcfg = _configs()
    jds, tds = _datasets(jcfg)
    np.testing.assert_array_equal(jds.train, tds.train)
    mem = {"device_memory": JPR.HBM_BYTES}
    got = {}
    for key, alto, cfg, ds, kw in (
            ("jax", JENG, jcfg, jds, {}),
            ("torch", TENG, tcfg, tds, {"device": "cpu"})):
        engine = alto.Engine(strategy="adapter_parallel", total_gpus=4, **kw)
        got[key] = _host_decisions(
            alto, engine, _listing1(alto, cfg, ds, num_slots, **mem),
            alto.EarlyExit(**EE))
    assert got["torch"] == got["jax"]
    if num_slots == 0:      # the memory model sized Z: every job resident
        assert got["torch"]["pick_slots"] == [2, 2]


def test_weight_decay_pairs_merge_as_in_the_reference():
    """``TrainConfig.label()`` leaves out the weight decay, so
    ``Task.jobs()`` keeps one job of each (lr, wd) pair that differs only
    in wd: the last one. The port keeps the reference's behaviour."""
    jcfg, tcfg = _configs()
    space = {"rank": [8], "lr": [1e-4, 1e-3], "wd": [0.0, 0.01]}
    jobs = {}
    for key, alto, cfg in (("jax", JENG, jcfg), ("torch", TENG, tcfg)):
        task = alto.Task(model=cfg, dataset="t", name="lr-sweep",
                         search_space=space)
        jobs[key] = {k: dataclasses.asdict(tc)
                     for k, tc in task.jobs().items()}
    assert jobs["torch"] == jobs["jax"]
    assert [tc["weight_decay"] for tc in jobs["torch"].values()] == [0.01,
                                                                     0.01]


# ---------------------------------------------------------------------------
# (b) the H100 constants
# ---------------------------------------------------------------------------

def test_h100_constants_scale_the_analytic_step_time(fresh_profiles):
    assert (TPR.PEAK_FLOPS_BF16, TPR.HBM_BYTES_PER_S, TPR.HBM_BYTES) == (
        989e12, 3.35e12, 80e9)
    assert TENG.Task(model="x", dataset="x",
                     search_space={}).device_memory == 80e9
    from repro.configs.registry import get_arch as jget
    jcfg, tcfg = jget("stablelm-3b"), get_arch("stablelm-3b")
    # 4,096 x 256 tokens: compute-bound on both; 16 tokens: memory-bound
    for batch, seq, chips, ratio in ((4096, 256, 1, 197e12 / 989e12),
                                     (1, 16, 4, 819e9 / 3.35e12)):
        j = JPR.analytic_step_time(jcfg, batch, seq, chips, lora_rank=64)
        t = TPR.analytic_step_time(tcfg, batch, seq, chips, lora_rank=64)
        assert t == pytest.approx(j * ratio, rel=1e-12)
    # compute-bound at the engine phase's load on the card: Z 4, b 4, S 256
    f = TPR.train_step_flops(tcfg, 16, 256, 64)
    assert TPR.analytic_step_time(tcfg, 16, 256, 1, lora_rank=64) == \
        pytest.approx(f / (989e12 * 0.4), rel=1e-12)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card."""
    @property
    def is_cuda(self):
        return True


def test_measure_throughput_syncs_only_for_card_outputs(monkeypatch):
    """``measure_throughput`` waits for the card (in place of
    ``jax.block_until_ready``) only when some output leaf is on it, and
    reports the median of its repeats as the reference does."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: synced.append(1))
    calls = []

    def step(x):
        calls.append(1)
        return {"y": [x * 2, (x + 1,)]}
    prof = TPR.measure_throughput(step, (torch.ones(4),), total_batch=8,
                                  warmup=2, iters=3, repeats=3)
    assert (len(calls), synced) == (2 + 3 * 3, [])
    assert prof.samples_per_s == pytest.approx(8 / prof.step_time_s)
    assert prof.peak_memory == 0.0
    TPR._block_until_ready({"a": [torch.ones(1),
                                  (torch.ones(1).as_subclass(_OnCard),)]})
    assert synced == [1]


# ---------------------------------------------------------------------------
# (c) static == solo, elastic == static, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    jcfg, tcfg = _configs()
    _, ds = _datasets(jcfg)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return tcfg, ds, params


def _tasks(cfg, ds, seed=0):
    """Listing 1's two tasks (full rank: dense; ranks 4 / 8: rank-local)
    and a full-rank task of two widths (ragged while both are resident)."""
    mixed = TENG.Task(model=cfg, dataset=ds, num_gpus=1, max_steps=10,
                      num_slots=2, name="mixed-batch", seed=seed,
                      search_space={"rank": [8], "batch_size": [2, 4],
                                    "lr": [3e-3]})
    return _listing1(TENG, cfg, ds, seed=seed) + [mixed]


def _engine(cfg, params):
    engine = TENG.Engine(total_gpus=2, eval_every=2, device="cpu")
    engine._param_cache[cfg.name] = params
    return engine


def _record_lifecycles(engine):
    """Every executor the engine makes reports its task's lifecycle into
    the returned dict (for the loss and validation histories)."""
    seen = {}
    make = engine._make_executor

    def recording(task, ee):
        bx = make(task, ee)
        add = bx.backbone.add_task

        def add_task(lc):
            seen[lc.task_name] = lc
            add(lc)
        bx.backbone.add_task = add_task
        return bx
    engine._make_executor = recording
    return seen


def _histories(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def _summary(result, lc):
    """Everything of a TaskResult but the wall time, and the histories."""
    jobs = {j: (r.best_val, r.best_val_step, r.exit_reason, r.steps_trained,
                r.samples_trained, r.adapter is None)
            for j, r in result.job_results.items()}
    return (result.best_job, result.best_val, result.total_samples,
            result.samples_saved_frac, result.exit_counts, jobs,
            _histories(lc))


def _same(a, b, lc_a, lc_b):
    if _summary(a, lc_a) != _summary(b, lc_b):
        return False
    for j, ra in a.job_results.items():
        wa, wb = ra.adapter, b.job_results[j].adapter
        if wa is not None and not all(torch.equal(wa[t][m], wb[t][m])
                                      for t in wa for m in wa[t]):
            return False
    return True


def test_static_solo_elastic_bitwise(env, monkeypatch):
    cfg, ds, params = env
    ee = TENG.EarlyExit(**EE)
    calls = {n: _spy(monkeypatch, TOPS, n) for n in (
        "grouped_lora", "ranklocal_grouped_lora", "ragged_grouped_lora")}
    tasks = _tasks(cfg, ds)
    engine = _engine(cfg, params)
    static_lcs = _record_lifecycles(engine)
    schedule = engine.schedule(tasks, method="cp", early_exit=ee)
    schedule.validate(2)
    assert max(p.start for p in schedule.placements) > 0    # one waits
    static = engine.batched_execution(tasks, schedule, ee, strategy="static")
    assert static.execution == "static"
    assert static.virtual_makespan == schedule.makespan
    assert all(len(c) > 0 for c in calls.values()), \
        {n: len(c) for n, c in calls.items()}

    # each task alone through BatchedExecutor, built here from the task
    for task in tasks:
        jobs = task.jobs()
        bsz = max(tc.per_adapter_batch for tc in jobs.values())
        bx = BatchedExecutor(cfg, params, ds, Z=task.num_slots,
                             per_adapter_batch=bsz, ee=ee, eval_every=2,
                             seed=task.seed,
                             mem_model=engine.memory_model(task),
                             device="cpu")
        solo_lc = {}
        add = bx.backbone.add_task
        bx.backbone.add_task = lambda lc: (solo_lc.update(lc=lc), add(lc))
        solo = bx.run_task(task.task_name, jobs, task.max_steps)
        name = task.task_name
        assert np.isfinite(solo.best_val)
        assert _same(static.task_results[name], solo,
                     static_lcs[name], solo_lc["lc"]), name

    # the elastic runtime over real executors, as the service runs it
    engine2 = _engine(cfg, params)
    elastic_lcs = _record_lifecycles(engine2)
    rt = ElasticClusterRuntime(2)
    for task in tasks:
        rt.submit(engine2.profile_raw(task, ee),
                  engine2.executor_driver_factory(task, ee))
    rep = rt.run(initial=schedule)
    assert set(rep.results) == {t.task_name for t in tasks}
    for task in tasks:
        name = task.task_name
        assert _same(rep.results[name], static.task_results[name],
                     elastic_lcs[name], static_lcs[name]), name
    assert rep.makespan <= static.virtual_makespan + 1e-9
    assert rep.replans > 0
    rep.realized.validate(2)

    # the control: seed + 1 changes the batches and the adapters' init
    control = _engine(cfg, params)
    control_lcs = _record_lifecycles(control)
    ctask = _tasks(cfg, ds, seed=1)[1]
    cres = control.batched_execution(
        [ctask], control.schedule([ctask], early_exit=ee), ee,
        strategy="static").task_results[ctask.task_name]
    assert not _same(cres, static.task_results[ctask.task_name],
                     control_lcs[ctask.task_name],
                     static_lcs[ctask.task_name])


# ---------------------------------------------------------------------------
# (d) the elastic wrapper: a one-shot tuning-service session
# ---------------------------------------------------------------------------

def test_elastic_batched_execution_runs_through_the_service(env):
    """``batched_execution`` (elastic by default) submits every placement
    to a one-shot ``TuningService`` session (strict adoption rule, no
    co-location) and drains it: each task's TaskResult equals the static
    run's bit for bit (best job and value, every job, loss and validation
    histories, kept adapters), the virtual makespan is no larger, and the
    report carries the session's events and replans."""
    cfg, ds, params = env
    ee = TENG.EarlyExit(**EE)
    tasks = _tasks(cfg, ds)
    engine = _engine(cfg, params)
    static_lcs = _record_lifecycles(engine)
    schedule = engine.schedule(tasks, method="cp", early_exit=ee)
    static = engine.batched_execution(tasks, schedule, ee, strategy="static")
    engine2 = _engine(cfg, params)
    elastic_lcs = _record_lifecycles(engine2)
    elastic = engine2.batched_execution(tasks, schedule, ee)
    assert elastic.execution == "elastic"
    assert set(elastic.task_results) == {t.task_name for t in tasks}
    for task in tasks:
        name = task.task_name
        assert _same(elastic.task_results[name], static.task_results[name],
                     elastic_lcs[name], static_lcs[name]), name
    assert elastic.virtual_makespan <= static.virtual_makespan + 1e-9
    assert elastic.replans > 0 and elastic.utilization > 0.0
    kinds = [e.kind.value for e in elastic.events]
    assert kinds.count("task_completed") == len(tasks)
    assert "task_cancelled" not in kinds
    assert elastic.schedule is schedule
    assert elastic.makespan_estimate == schedule.makespan
