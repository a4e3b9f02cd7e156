"""PyTorch port: the shared-backbone executor and its host modules.

(a) The port's copies of the host modules (early exit, ``SlotBatcher``,
    ``IntraTaskScheduler``) give the JAX package's decisions and batches
    on identical inputs.
(b) ``SlotSnapshot`` round trip is bit-exact, across slots, managers and
    the bridge (a port snapshot restores into the JAX ``SlotManager``).
(c) Co-located == solo loss histories, bitwise, inside the port, for tasks
    of different ranks, per-adapter batch sizes and sequence lengths (the
    JAX package's tests/test_lora_isolation.py contracts).
(d) ``suspend``/``resume`` onto a second executor == never moved, bitwise.
(e) A rank-sweep and a full-rank learning-rate sweep through
    ``BatchedExecutor.run_task`` go warmup -> selection -> continue and
    return a ``TaskResult``; three full-rank tasks of different widths
    share one executor through ``run_colocated``, the third admitted only
    when a running task frees its slots.

(c) and (d) hold for low-rank tasks, whose steps take the rank-local path
(per-slot sums that do not depend on the co-tenants), and for full-rank
tasks, which take the dense path alone or beside full-width full-rank
tasks, the ragged path beside a narrower full-rank one and the rank-local
path beside a lower-rank one: the three give bitwise one result at full
rank. Everything runs on the CPU (``device="cpu"``) at a reduced float32
size.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import adapter_state as JAS
from repro.core import early_exit as JEE
from repro.data import synthetic as JSYN
from repro.sched import intra_task as JIT
from repro_torch import bridge
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core import early_exit as TEE
from repro_torch.core.adapter_state import SlotManager
from repro_torch.core.executor import (BatchedExecutor,
                                       SharedBackboneExecutor, TaskLifecycle,
                                       TaskResult, run_colocated)
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels.grouped_lora import grouped_lora as TGL
from repro_torch.kernels.grouped_lora import ops as TOPS
from repro_torch.kernels.grouped_lora import ranklocal as TRL
from repro_torch.models import model as TM
from repro_torch.sched import intra_task as TIT
from repro_torch.sched.events import EventKind
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401
from tests.test_torch_grouped_lora import _spy


@pytest.fixture(scope="module")
def env():
    cfg = dataclasses.replace(
        get_arch("paper-llama-tiny").reduced(num_layers=2, d_model=64,
                                             vocab=128), dtype="float32")
    assert cfg.lora.r_max == 8
    params = TM.init_params(cfg, seed=0, device="cpu")
    ds_a = TSYN.make_task_dataset("task-a", cfg.vocab_size, seq_len=16,
                                  num_train=32, num_val=8, difficulty=0.2,
                                  seed=1)
    ds_b = TSYN.make_task_dataset("task-b", cfg.vocab_size, seq_len=16,
                                  num_train=32, num_val=8, difficulty=0.6,
                                  seed=2)
    return cfg, params, ds_a, ds_b


# ---------------------------------------------------------------------------
# (a) copied host modules
# ---------------------------------------------------------------------------

def _loss_stream(seed, n):
    """Train/val losses that fall, then rise (divergence) or split
    (overfitting), with noise and one non-finite point."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    train = 3.0 - 0.05 * t + 0.02 * rng.standard_normal(n)
    val = train + np.where(t > n // 2, 0.03 * (t - n // 2), 0.0) \
        + 0.02 * rng.standard_normal(n)
    if seed % 3 == 0:
        train[n // 2:] += 0.2 * (t[n // 2:] - n // 2)
    if seed % 5 == 0:
        val[-2] = np.inf
    return train.tolist(), val.tolist()


@pytest.mark.parametrize("seed", range(6))
def test_early_exit_decisions_match_jax(seed):
    cfg_kw = dict(warmup_ratio=0.25, select_ratio=0.5)
    jcfg, tcfg = JEE.EarlyExitConfig(**cfg_kw), TEE.EarlyExitConfig(**cfg_kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmons, tmons = {}, {}
    for j in range(4):
        train, val = _loss_stream(seed * 10 + j, 24)
        jm, tm = JEE.JobMonitor(jcfg, f"j{j}"), TEE.JobMonitor(tcfg, f"j{j}")
        for step, (lt, lv) in enumerate(zip(train, val)):
            jm.observe_train(lt)
            tm.observe_train(lt)
            if step % 2:
                jd, td = jm.observe_val(lv, step), tm.observe_val(lv, step)
                assert (jd is None) == (td is None)
                if jd is not None:
                    assert (jd.reason.value, jd.step, jd.best_val) == (
                        td.reason.value, td.step, td.best_val)
                    break
        jmons[f"j{j}"], tmons[f"j{j}"] = jm, tm
    assert JEE.warmup_select(jmons, jcfg, 4) == TEE.warmup_select(tmons,
                                                                  tcfg, 4)
    assert jcfg.warmup_steps(37) == tcfg.warmup_steps(37)


def test_slot_batcher_draws_the_jax_batches():
    kw = dict(vocab_size=64, seq_len=12, num_train=20, num_val=9, seed=4)
    jds, tds = (JSYN.make_task_dataset("t", **kw),
                TSYN.make_task_dataset("t", **kw))
    np.testing.assert_array_equal(jds.train, tds.train)
    jb, tb = JSYN.SlotBatcher(jds, 3, 2, seed=7), TSYN.SlotBatcher(tds, 3, 2,
                                                                   seed=7)
    for i in range(25):              # past an epoch boundary of every lane
        lane, n = i % 3, 1 + i % 4
        want, got = jb.lane_batch_dict(lane, n), tb.lane_batch_dict(lane, n)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v)
    jt, jl = jb.next_batch()
    tt, tl = tb.next_batch()
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(jl, tl)
    for k, v in jb.val_batch_dict(4).items():
        np.testing.assert_array_equal(tb.val_batch_dict(4)[k], v)
    assert jb.epochs == tb.epochs


def test_intra_task_scheduler_decisions_match_jax():
    mem_kw = dict(k0=1e9, k1=2e5, seq_len=16, capacity=2e9, k2=3e3, r_max=64)
    scheds = [mod.IntraTaskScheduler(mod.MemoryModel(**mem_kw), 4)
              for mod in (JIT, TIT)]
    rng = np.random.default_rng(3)
    specs = [(f"j{i}", int(rng.integers(1, 9)), int(rng.choice([0, 4, 16,
                                                                 64])))
             for i in range(10)]
    queues = [[mod.PendingJob(*s) for s in specs] for mod in (JIT, TIT)]
    admitted = [[j.job_id for j in s.admit_initial(q)]
                for s, q in zip(scheds, queues)]
    assert admitted[0] == admitted[1]
    for victim in admitted[0]:
        picks = []
        for s, q in zip(scheds, queues):
            s.evict(victim)
            p = s.backfill(q)
            picks.append(None if p is None else p.job_id)
        assert picks[0] == picks[1]
        assert scheds[0].resident == scheds[1].resident


# ---------------------------------------------------------------------------
# (b) SlotSnapshot round trip
# ---------------------------------------------------------------------------

def _fill_slot(sm, slot, seed):
    """Give a slot non-trivial adapter, moments and step count."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for tree in (sm.lora, sm.opt_state.mu, sm.opt_state.nu):
            for ab in tree.values():
                for x in ab.values():
                    x[:, slot] = torch.randn(x[:, slot].shape, generator=g)
    sm.opt_state.count[slot] = 7


def _slot_state(sm, slot):
    return [x[:, slot].clone() for tree in (sm.lora, sm.opt_state.mu,
                                            sm.opt_state.nu)
            for ab in tree.values() for x in ab.values()] + [
        sm.opt_state.count[slot].clone(), sm.ranks[slot].clone()]


def test_slot_snapshot_round_trip_is_bit_exact(env):
    cfg = env[0]
    shapes = TM.target_shapes(cfg)
    tc = TrainConfig(lora_rank=4, per_adapter_batch=2, learning_rate=3e-3)
    sm1 = SlotManager(cfg, 4, shapes, device="cpu")
    sm1.admit(1, "job", tc, torch.Generator().manual_seed(0), task="t",
              b=2, seq=16)
    _fill_slot(sm1, 1, seed=3)
    want = _slot_state(sm1, 1)
    snap = sm1.snapshot(1)
    sm1.evict(1)
    assert sm1.slot_jobs[1] is None and sm1.slot_rank[1] == 0
    assert all(float(x[:, 1].abs().max()) == 0 for ab in sm1.lora.values()
               for x in ab.values())
    # the snapshot crosses the bridge and back, then lands on another slot
    # of another manager that already holds a job
    snap2 = bridge.snapshot_from_numpy(
        JAS.SlotSnapshot(**bridge.snapshot_to_numpy(snap)))
    sm2 = SlotManager(cfg, 4, shapes, device="cpu")
    sm2.admit(0, "other", tc, torch.Generator().manual_seed(1))
    sm2.restore(3, snap2, tc, task="t")
    got = _slot_state(sm2, 3)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (sm2.slot_b[3], sm2.slot_seq[3], sm2.slot_rank[3]) == (2, 16, 4)
    assert float(sm2.hp.lr[3]) == pytest.approx(3e-3)
    # a port snapshot restores bit-exactly into the JAX package's manager
    jsm = JAS.SlotManager(reduced_f32("paper-llama-tiny", num_layers=2,
                                      d_model=64, vocab=128), 4, shapes,
                          jax.random.PRNGKey(0))
    jsm.restore(2, JAS.SlotSnapshot(**bridge.snapshot_to_numpy(snap)), tc)
    for t, ab in jsm.adapter_at(2).items():
        for m, x in ab.items():
            np.testing.assert_array_equal(x, snap.lora[t][m].numpy())
    assert int(jsm.opt_state.count[2]) == 7


# ---------------------------------------------------------------------------
# (c) co-located == solo, (d) migrated == never migrated
# ---------------------------------------------------------------------------

def _lifecycle(ex, name, ds, seed, ranks, total_steps=8, width=None):
    kw = {} if width is None else {"per_adapter_batch": width}
    jobs = {f"{name}/j{i}": TrainConfig(learning_rate=lr, lora_rank=rk,
                                        max_steps=total_steps, **kw)
            for i, (lr, rk) in enumerate(zip((3e-3, 1e-3), ranks))}
    ee = TEE.EarlyExitConfig(warmup_ratio=0.25, select_ratio=1.0)
    return TaskLifecycle(ex, name, jobs, total_steps, ee=ee, max_slots=2,
                         batcher=TSYN.SlotBatcher(ds, 2, ex.b_cap, seed=seed),
                         seed=seed)


def _executor(cfg, params):
    return SharedBackboneExecutor(cfg, params, Z=4, per_adapter_batch=2,
                                  eval_every=2, seed=0, device="cpu")


def _hists(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def _drive(ex, lcs, steps=None):
    """Minimal coordinator (run_colocated's loop, stoppable mid-run)."""
    done = 0
    while any(not lc.done for lc in lcs):
        live = [lc for lc in lcs if not lc.done]
        n = max(min(min(lc.steps_until_boundary() for lc in live),
                    ex.eval_every), 1)
        ex.run_steps(n)
        for lc in live:
            lc.on_steps(n)
        done += n
        if steps is not None and done >= steps:
            return


def test_colocated_losses_bitwise_equal_solo(env):
    """Two tasks at different true ranks (2/4 and 3/5 of r_max 8) fused on
    one executor produce bitwise the loss histories of each task alone."""
    cfg, params, ds_a, ds_b = env
    specs = [("A", ds_a, 3, (2, 4)), ("B", ds_b, 4, (3, 5))]

    def run(chosen):
        ex = _executor(cfg, params)
        lcs = [_lifecycle(ex, *s) for s in chosen]
        return run_colocated(ex, lcs), {lc.task_name: _hists(lc)
                                        for lc in lcs}

    fused, fused_h = run(specs)
    solo_a, solo_a_h = run(specs[:1])
    solo_b, solo_b_h = run(specs[1:])
    assert fused_h["A"] == solo_a_h["A"]        # bitwise: tuples of floats
    assert fused_h["B"] == solo_b_h["B"]
    assert fused["A"].best_val == solo_a["A"].best_val
    assert fused["B"].best_val == solo_b["B"].best_val
    assert np.isfinite(fused["A"].best_val)
    assert set(TRL.LAUNCHES.values()) == {0}    # CPU: plain versions only


def test_full_rank_colocated_losses_bitwise_equal_solo(env, monkeypatch):
    """Port of the JAX package's ranklocal cross-task test: a low-rank task
    (2/4 of r_max 8) and a full-rank one (8/8) fused on one executor give
    bitwise each task's solo loss histories and best validation loss. The
    full-rank task takes the dense path alone (nothing bound) and the
    rank-local path fused (its slots at ranks = r_max): its losses must
    not move a bit."""
    cfg, params, ds_a, ds_b = env
    specs = [("A", ds_a, 3, (2, 4)), ("B", ds_b, 4, (8, 8))]
    dense = _spy(monkeypatch, TOPS, "grouped_lora")
    local = _spy(monkeypatch, TOPS, "ranklocal_grouped_lora")

    def run(chosen):
        ex = _executor(cfg, params)
        lcs = [_lifecycle(ex, *s) for s in chosen]
        calls = (len(dense), len(local))
        out = run_colocated(ex, lcs), {lc.task_name: _hists(lc)
                                       for lc in lcs}
        return out + ((len(dense) - calls[0], len(local) - calls[1]),)

    fused, fused_h, fused_calls = run(specs)
    solo_a, solo_a_h, _ = run(specs[:1])
    solo_b, solo_b_h, solo_b_calls = run(specs[1:])
    assert fused_calls[1] > 0               # fused: the rank-local path
    assert solo_b_calls[0] > 0 and solo_b_calls[1] == 0   # B alone: dense
    assert fused_h["A"] == solo_a_h["A"]        # bitwise: tuples of floats
    assert fused_h["B"] == solo_b_h["B"]
    assert fused["A"].best_val == solo_a["A"].best_val
    assert fused["B"].best_val == solo_b["B"].best_val
    assert np.isfinite(fused["B"].best_val)
    assert set(TGL.LAUNCHES.values()) == {0}    # CPU: plain versions only


_FUNCTIONS = ("grouped_lora", "ragged_grouped_lora", "ranklocal_grouped_lora")


def _run_mixed(cfg, params, specs, monkeypatch, seq_cap=None):
    """Run ``specs`` (name, ds, seed, ranks, width) co-located on a fresh
    Z=4, b_cap=4 executor. Returns (results, histories, calls): ``calls``
    counts the run's calls of each grouped-LoRA Function (dense, ragged,
    rank-local), train and eval steps together."""
    spies = {n: _spy(monkeypatch, TOPS, n) for n in _FUNCTIONS}
    before = {n: len(c) for n, c in spies.items()}
    ex = SharedBackboneExecutor(cfg, params, Z=4, per_adapter_batch=4,
                                eval_every=2, seed=0, seq_cap=seq_cap,
                                device="cpu")
    lcs = [_lifecycle(ex, name, ds, seed, ranks, width=w)
           for name, ds, seed, ranks, w in specs]
    results = run_colocated(ex, lcs)
    calls = {n[:-len("grouped_lora")] or "dense": len(c) - before[n]
             for n, c in spies.items()}
    monkeypatch.undo()
    return results, {lc.task_name: _hists(lc) for lc in lcs}, calls


def _assert_isolated(fused, fused_h, solos):
    """Each task's fused histories and best val equal its solo run's bit
    for bit."""
    for name, (solo, solo_h) in solos.items():
        assert fused_h[name] == solo_h[name], name   # tuples of floats
        assert fused[name].best_val == solo[name].best_val, name
        assert np.isfinite(fused[name].best_val), name


def test_ragged_full_rank_losses_bitwise_equal_solo(env, monkeypatch):
    """Port of the JAX package's ragged cross-task test with both tasks at
    full rank (8/8): A trains at b = 2, B at b = 4 in the same fused step
    (the ragged path); alone, A is still narrower than the lane (ragged)
    and B is full-width (dense). Loss histories are bitwise those of each
    task alone, and each task trained at its own width."""
    cfg, params, ds_a, ds_b = env
    specs = [("A", ds_a, 3, (8, 8), 2), ("B", ds_b, 4, (8, 8), 4)]
    fused, fused_h, calls = _run_mixed(cfg, params, specs, monkeypatch)
    solo_a, solo_a_h, calls_a = _run_mixed(cfg, params, specs[:1],
                                           monkeypatch)
    solo_b, solo_b_h, calls_b = _run_mixed(cfg, params, specs[1:],
                                           monkeypatch)
    assert calls["ragged_"] > 0 and calls["ranklocal_"] == 0
    assert calls_a["ragged_"] > 0 and calls_a["ranklocal_"] == 0
    assert calls_b["ragged_"] == calls_b["ranklocal_"] == 0
    assert calls_b["dense"] > 0
    _assert_isolated(fused, fused_h, {"A": (solo_a, solo_a_h),
                                      "B": (solo_b, solo_b_h)})
    for name, width in (("A", 2), ("B", 4)):
        for r in fused[name].job_results.values():
            assert r.samples_trained == r.steps_trained * width


def test_ragged_full_width_host_unperturbed_by_narrow_guest(env,
                                                            monkeypatch):
    """A full-width full-rank host takes the dense path alone and the
    ragged path beside a narrow (b = 2) full-rank guest: its losses must
    not move a bit either way."""
    cfg, params, ds_a, ds_b = env
    specs = [("A", ds_a, 3, (8, 8), 4), ("B", ds_b, 4, (8, 8), 2)]
    fused, fused_h, calls = _run_mixed(cfg, params, specs, monkeypatch)
    solo, solo_h, calls_a = _run_mixed(cfg, params, specs[:1], monkeypatch)
    assert calls["ragged_"] > 0 and calls["ranklocal_"] == 0
    assert calls_a["dense"] > 0 and calls_a["ragged_"] == 0
    assert calls_a["ranklocal_"] == 0
    _assert_isolated(fused, fused_h, {"A": (solo, solo_h)})


def test_ragged_mixed_seq_len_full_rank_bitwise(env, monkeypatch):
    """Full-rank tasks of different sequence lengths (16 and 8) and widths
    (4 and 2) fused on one seq_cap=16 executor: the short guest's lanes pad
    mid-row (label masking keeps it exact) and every slot's row count is
    bound, so the step takes the ragged path; alone, the full-width host is
    dense. Both tasks' histories equal their solo runs' bit for bit."""
    cfg, params, ds_a, _ = env
    ds_short = TSYN.make_task_dataset("task-c", cfg.vocab_size, seq_len=8,
                                      num_train=32, num_val=8,
                                      difficulty=0.4, seed=5)
    specs = [("A", ds_a, 3, (8, 8), 4), ("C", ds_short, 5, (8, 8), 2)]
    fused, fused_h, calls = _run_mixed(cfg, params, specs, monkeypatch,
                                       seq_cap=16)
    solo_a, solo_a_h, calls_a = _run_mixed(cfg, params, specs[:1],
                                           monkeypatch, seq_cap=16)
    solo_c, solo_c_h, calls_c = _run_mixed(cfg, params, specs[1:],
                                           monkeypatch, seq_cap=16)
    assert calls["ragged_"] > 0 and calls["ranklocal_"] == 0
    assert calls_a["ragged_"] == 0 and calls_a["dense"] > 0
    assert calls_c["ragged_"] > 0
    _assert_isolated(fused, fused_h, {"A": (solo_a, solo_a_h),
                                      "C": (solo_c, solo_c_h)})


def test_ranklocal_ragged_rank_and_width_compose_bitwise(env, monkeypatch):
    """A full-rank b = 4 host beside a rank 2/4, b = 2 guest rides the
    rank-local path with rows bound; alone the host takes the dense path
    and the guest the rank-local one. Both tasks' histories equal their
    solo runs' bit for bit."""
    cfg, params, ds_a, ds_b = env
    specs = [("A", ds_a, 3, (8, 8), 4), ("B", ds_b, 4, (2, 4), 2)]
    fused, fused_h, calls = _run_mixed(cfg, params, specs, monkeypatch)
    solo_a, solo_a_h, calls_a = _run_mixed(cfg, params, specs[:1],
                                           monkeypatch)
    solo_b, solo_b_h, calls_b = _run_mixed(cfg, params, specs[1:],
                                           monkeypatch)
    assert calls["ranklocal_"] > 0 and calls["ragged_"] == 0
    assert calls_a["dense"] > 0 and calls_a["ragged_"] == 0
    assert calls_a["ranklocal_"] == 0
    assert calls_b["ranklocal_"] > 0 and calls_b["ragged_"] == 0
    _assert_isolated(fused, fused_h, {"A": (solo_a, solo_a_h),
                                      "B": (solo_b, solo_b_h)})


def _migrated_equals_unmoved(env, a_ranks, b_ranks, c_ranks):
    """Task A runs to the end beside B on one executor (the reference);
    again beside B for 4 steps, then is suspended and resumed on a second
    executor that hosts C (so its physical slots change); it must train on
    bitwise as if it had never moved."""
    cfg, params, ds_a, ds_b = env
    ds_c = TSYN.make_task_dataset("task-c", cfg.vocab_size, seq_len=16,
                                  num_train=32, num_val=8, difficulty=0.4,
                                  seed=3)
    ex0 = _executor(cfg, params)
    a0 = _lifecycle(ex0, "A", ds_a, 3, a_ranks)
    b0 = _lifecycle(ex0, "B", ds_b, 4, b_ranks)
    run_colocated(ex0, [a0, b0])
    ref = _hists(a0)

    ex1, ex2 = _executor(cfg, params), _executor(cfg, params)
    A = _lifecycle(ex1, "A", ds_a, 3, a_ranks)
    B = _lifecycle(ex1, "B", ds_b, 4, b_ranks)
    C = _lifecycle(ex2, "C", ds_c, 5, c_ranks)
    ex2.add_task(C)
    C.begin()
    _drive(ex2, [C], steps=4)           # C occupies replica 2's low slots
    for lc in (A, B):
        ex1.add_task(lc)
        lc.begin()
    _drive(ex1, [A, B], steps=4)        # A mid-flight on replica 1
    slots_before = {j: s for j, (_, s) in A.resident.items()}
    A.suspend()
    assert ex2.can_admit_task(A)
    A.resume(ex2)
    slots_after = {j: s for j, (_, s) in A.resident.items()}
    assert set(slots_before.values()) != set(slots_after.values())
    _drive(ex2, [A, C])
    _drive(ex1, [B])
    assert _hists(A) == ref             # bitwise: tuples of floats
    assert A.result().best_val == a0.result().best_val
    assert A.result().best_job == a0.result().best_job
    assert np.isfinite(C.result().best_val)


def test_migration_across_executors_bitwise_equal(env):
    """A low-rank task moved mid-training from beside another low-rank
    task to beside a third one trains on bitwise as if it had never
    moved."""
    _migrated_equals_unmoved(env, (2, 4), (3, 5), (2, 6))


def test_full_rank_migration_across_executors_bitwise_equal(env,
                                                            monkeypatch):
    """A full-rank task (8/8) moved mid-training from a replica where
    every slot is at r_max (the dense path) to one beside a low-rank task
    (the rank-local path) trains on bitwise as if it had never moved (its
    reference run stays on the dense path throughout)."""
    dense = _spy(monkeypatch, TOPS, "grouped_lora")
    local = _spy(monkeypatch, TOPS, "ranklocal_grouped_lora")
    _migrated_equals_unmoved(env, (8, 8), (8, 8), (2, 6))
    assert dense and local              # both paths were taken


# ---------------------------------------------------------------------------
# (e) a rank sweep through BatchedExecutor
# ---------------------------------------------------------------------------

def test_rank_sweep_runs_warmup_selection_continue(env):
    """8 jobs (ranks 2/3/4/6 x two learning rates) on 4 slots: two warmup
    waves with rotation, Pattern-3 selection of the top 2, continue to the
    step budget, per-slot evals — the chip smoke's run_task at a reduced
    size."""
    cfg, params, ds_a, _ = env
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=2)
            for r in (2, 3, 4, 6) for lr in (1e-3, 1e-2)}
    bx = BatchedExecutor(cfg, params, ds_a, Z=4, per_adapter_batch=2,
                         ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.25),
                         eval_every=2, device="cpu")
    gen = bx.run_task_chunks("rank-sweep", jobs, total_steps=8)
    phases, events = [], []
    while True:
        try:
            rep = next(gen)
        except StopIteration as stop:
            result = stop.value
            break
        phases.append(rep.phase)
        events.extend(rep.events)
        if rep.steps_executed:
            assert rep.wall_time_s > 0 and rep.tokens_executed > 0
    assert isinstance(result, TaskResult) and result.best_job in jobs
    assert phases[0] == "warmup" and "continue" in phases
    assert phases[-1] == "done"
    sel = [e for e in events if e.kind == EventKind.WARMUP_SELECTION]
    assert len(sel) == 1 and len(sel[0].dropped) == 6
    assert result.exit_counts.get("underperforming") == 6
    assert sum(result.exit_counts.values()) == 8
    assert all(np.isfinite(r.best_val) for r in result.job_results.values()
               if r.exit_reason is not None and
               r.exit_reason.value != "diverging")
    assert result.job_results[result.best_job].adapter is not None
    assert 0 < result.samples_saved_frac < 1


def test_executor_refuses_params_on_another_device(env):
    cfg, params, _, _ = env
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in params.items()}
    with pytest.raises(ValueError, match="params lie on"):
        SharedBackboneExecutor(cfg, meta, Z=2, per_adapter_batch=1,
                               device="cpu")
    with pytest.raises(ValueError, match="unknown loss kind"):
        SharedBackboneExecutor(cfg, params, Z=2, per_adapter_batch=1,
                               device="cpu", loss_kind="ppo")
    # DPO is ported: the executor takes it
    assert SharedBackboneExecutor(cfg, params, Z=2, per_adapter_batch=1,
                                  device="cpu",
                                  loss_kind="dpo").loss_kind == "dpo"


def test_full_rank_lr_sweep_runs_on_the_dense_path(env, monkeypatch):
    """8 jobs, all at r_max (4 learning rates x 2 weight decays), on 4
    slots through ``BatchedExecutor.run_task``: every fused train and eval
    step leaves nothing bound, so every LoRA projection takes the dense
    Function and none the rank-local one — the chip smoke's lr sweep at a
    reduced size."""
    cfg, params, ds_a, _ = env
    r_max = cfg.lora.r_max
    jobs = {f"lr{lr:g}-wd{wd:g}": TrainConfig(learning_rate=lr,
                                              weight_decay=wd,
                                              lora_rank=r_max,
                                              per_adapter_batch=2)
            for lr in (1e-4, 3e-4, 1e-3, 3e-3) for wd in (0.0, 0.01)}
    dense = _spy(monkeypatch, TOPS, "grouped_lora")
    local = _spy(monkeypatch, TOPS, "ranklocal_grouped_lora")
    bx = BatchedExecutor(cfg, params, ds_a, Z=4, per_adapter_batch=2,
                         ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.25),
                         eval_every=2, device="cpu")
    result = bx.run_task("lr-sweep", jobs, total_steps=8)
    assert isinstance(result, TaskResult) and result.best_job in jobs
    assert sum(result.exit_counts.values()) == 8
    assert result.exit_counts.get("underperforming") == 6
    assert result.job_results[result.best_job].adapter is not None
    per_forward = cfg.num_layers * len(cfg.lora.targets)
    assert dense and len(dense) % per_forward == 0
    assert not local


def test_heterogeneous_colocation_admits_the_third_task_when_slots_free(
        env, monkeypatch):
    """The chip smoke's main path at a reduced size: three full-rank tasks
    of widths (b, S) = (4, 16), (2, 16) and (4, 8), 4 jobs each on 2 slots
    each, through ``run_colocated`` on one Z=4, b_cap=4, seq_cap=16
    executor. The third waits at the admission gate and starts only once a
    running task has finished or shed its slots; every mixed-width train
    step takes the ragged Function, none the rank-local one, and every task
    ends with a finite best validation loss."""
    cfg, params, ds_a, ds_b = env
    ds_short = TSYN.make_task_dataset("task-c", cfg.vocab_size, seq_len=8,
                                      num_train=32, num_val=8,
                                      difficulty=0.4, seed=5)
    r_max = cfg.lora.r_max
    ex = SharedBackboneExecutor(cfg, params, Z=4, per_adapter_batch=4,
                                eval_every=2, seed=0, seq_cap=16,
                                device="cpu")
    ee = TEE.EarlyExitConfig(warmup_ratio=0.25, select_ratio=0.5)
    lcs = []
    for name, ds, b, lrs, seed in (("wide", ds_a, 4, (1e-4, 1e-3), 1),
                                   ("narrow", ds_b, 2, (3e-4, 3e-3), 2),
                                   ("short", ds_short, 4, (1e-4, 1e-3), 3)):
        jobs = {f"{name}/lr{lr:g}-wd{wd:g}": TrainConfig(
                    learning_rate=lr, weight_decay=wd, lora_rank=r_max,
                    per_adapter_batch=b)
                for lr in lrs for wd in (0.0, 0.01)}
        lcs.append(TaskLifecycle(ex, name, jobs, 8, ee=ee, max_slots=2,
                                 dataset=ds, seed=seed))
    steps, began = [0], {}
    real_run_steps = ex.run_steps

    def run_steps(n):
        real_run_steps(n)
        steps[0] += n
    ex.run_steps = run_steps
    for lc in lcs:
        def begin(lc=lc, real=lc.begin):
            others = [o for o in lcs if o is not lc and o.phase != "idle"]
            began[lc.task_name] = (steps[0],
                                   [o.phase for o in others],
                                   sum(o.slots_bound() for o in others))
            real()
        lc.begin = begin
    dense = _spy(monkeypatch, TOPS, "grouped_lora")
    ragged = _spy(monkeypatch, TOPS, "ragged_grouped_lora")
    local = _spy(monkeypatch, TOPS, "ranklocal_grouped_lora")
    results = run_colocated(ex, lcs)
    assert began["wide"][0] == began["narrow"][0] == 0
    step, phases, bound = began["short"]
    assert step > 0                     # it waited at the gate
    assert bound <= ex.Z - lcs[2].m     # until the others freed its slots
    assert "done" in phases or bound < 2 * lcs[2].m
    assert set(results) == {"wide", "narrow", "short"}
    for name, res in results.items():
        assert res.best_job in lcs[[lc.task_name for lc in lcs].index(
            name)].jobs and np.isfinite(res.best_val)
    assert ragged and dense and not local
    per_forward = cfg.num_layers * len(cfg.lora.targets)
    assert len(ragged) % per_forward == 0
