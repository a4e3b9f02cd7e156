"""PyTorch port: DPO preference tuning and crash-and-resume of a tuning
task, against the JAX package and inside the port.

(a) ``dpo_loss`` per slot and its LoRA gradients against the JAX package's
    (loss 1e-4, gradients 2e-3: the JAX backend bars of
    tests/test_kernel_backends.py), calibrated to log 2 at init; three DPO
    train steps against the JAX train step; ``PairSlotBatcher`` draws the
    JAX package's pairs bit for bit.
(b) A DPO task co-located with another equals the task alone, bitwise.
(c) The durable state: ``save_state_tree`` round trips and reads and writes
    the JAX package's files, ``TaskCheckpointer`` prunes and finds the
    latest file, a corrupt file degrades to ``None``
    (tests/test_recovery.py:112, :228, :193), and the port's exported
    lifecycle tree has the JAX package's keys.
(d) Kill and recover at the executor: a task crashed by ``SimulatedCrash``
    after a durable checkpoint and resumed on a fresh executor with
    ``resume_task_chunks`` ends bitwise equal to the uninterrupted run (every
    job's loss history, best job and value, the winner's adapter) and runs
    fewer steps than from zero, for an SFT and a DPO task; one AdamW moment
    perturbed in the file breaks the equality.

Float32 reduced configs on the CPU; data through numpy.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as JCK
from repro.checkpoint import taskstate as JTS
from repro.configs.base import TrainConfig as JTrainConfig
from repro.core import executor as JEX
from repro.core import lora as JLORA
from repro.core import steps as JSTEPS
from repro.core.early_exit import EarlyExitConfig as JEarlyExitConfig
from repro.core.losses import dpo_loss as jdpo_loss
from repro.core.losses import dpo_reward_accuracy as jdpo_reward_accuracy
from repro.data import synthetic as JSYN
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as TCK
from repro_torch.checkpoint import taskstate as TTS
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import lora as TLORA
from repro_torch.core import losses as TLS
from repro_torch.core import steps as TSTEPS
from repro_torch.core.early_exit import EarlyExitConfig
from repro_torch.core.executor import (BatchedExecutor,
                                       SharedBackboneExecutor, TaskLifecycle,
                                       run_colocated)
from repro_torch.data import synthetic as TSYN
from repro_torch.models import model as TM
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401
from tests.test_torch_train import _step_inputs

GTOL = dict(rtol=2e-3, atol=2e-3)
LOSS_RTOL = 1e-4
Z, BSZ, SEQ = 4, 2, 16
RANKS = [2, 4, 6, 3]


def _t(a):
    return torch.from_numpy(np.array(a))


def _pairs(rng, cfg, n=1):
    out = []
    for _ in range(n):
        b = {}
        for side in ("chosen", "rejected"):
            tok = rng.integers(0, cfg.vocab_size, (Z, BSZ, SEQ)).astype(
                np.int32)
            b[f"tokens_{side}"] = tok
            b[f"labels_{side}"] = np.roll(tok, -1, axis=-1)
        out.append(b)
    return out


# ---------------------------------------------------------------------------
# (a) DPO against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env():
    jcfg = reduced_f32("stablelm-3b", d_model=128, vocab=256)
    tcfg = dataclasses.replace(
        tget_arch("stablelm-3b").reduced(d_model=128, vocab=256),
        dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def test_dpo_loss_and_grads_match_jax(env):
    """Per-slot DPO loss and its gradient in every LoRA leaf, port (rank-
    local path, plain versions on the CPU) against the JAX package (its
    XLA path) on the same weights, adapters and pairs."""
    jcfg, tcfg, jparams, tparams = env
    lora, _, _, ranks, active, _ = _step_inputs(jcfg, RANKS, [1, 1, 0, 1],
                                                None)
    batch = _pairs(np.random.default_rng(3), jcfg)[0]

    def loss(l_):
        with JLORA.slot_ranks(jnp.asarray(ranks)):
            total, per = jdpo_loss(jcfg, jparams, l_,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                                   jnp.asarray(active), remat=False)
        return total, per

    (_, jper), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, lora))
    tb = {k: _t(v) for k, v in batch.items()}
    tb["slot_ranks"] = _t(ranks)
    tper, tgrads = TSTEPS.lora_grads(tcfg, tparams,
                                     bridge.lora_from_numpy(lora, "cpu"), tb,
                                     _t(active), loss_kind="dpo")
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper),
                               rtol=LOSS_RTOL)
    for t in jgrads:
        for m in jgrads[t]:
            np.testing.assert_allclose(tgrads[t][m].numpy(),
                                       np.asarray(jgrads[t][m]),
                                       err_msg=f"{t}.{m}", **GTOL)
    # the inactive slot contributes no gradient
    assert all(float(tgrads[t][m][:, 2].abs().max()) == 0.0
               for t in tgrads for m in tgrads[t])


def test_dpo_loss_is_calibrated_at_init():
    """Fresh adapters (B = 0): the policy is the reference, the margin 0,
    every slot's loss log 2 (tests/test_system.py:60-76)."""
    cfg = dataclasses.replace(
        tget_arch("paper-llama-tiny").reduced(num_layers=2, d_model=128,
                                              vocab=128), dtype="float32")
    params = TM.init_params(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    lt = TLORA.init_lora_tree(gen, cfg, 2, torch.tensor([4, 4]),
                              TM.target_shapes(cfg))
    rng = np.random.default_rng(3)
    tok = lambda: _t(rng.integers(0, 128, (2, 2, 16)).astype(np.int32))
    c, r = tok(), tok()
    batch = {"tokens_chosen": c, "labels_chosen": c,
             "tokens_rejected": r, "labels_rejected": r}
    total, per = TLS.dpo_loss(cfg, params, lt, batch,
                              torch.ones(2, dtype=torch.int32))
    assert per.shape == (2,) and bool(torch.isfinite(per).all())
    np.testing.assert_allclose(per.numpy(), np.log(2.0), rtol=1e-3)
    np.testing.assert_allclose(float(total), 2 * np.log(2.0), rtol=1e-3)
    margins = np.asarray([0.5, -0.1, 0.0], np.float32)
    acc = TLS.dpo_reward_accuracy(torch.from_numpy(margins))
    assert acc.tolist() == [1.0, 0.0, 0.0]
    np.testing.assert_array_equal(
        acc.numpy(), np.asarray(jdpo_reward_accuracy(jnp.asarray(margins))))


def test_dpo_train_steps_match_jax_over_three_steps(env):
    jcfg, tcfg, jparams, tparams = env
    lora, opt, hp, ranks, active, _ = _step_inputs(jcfg, RANKS, [1, 1, 1, 1],
                                                   None)
    batches = _pairs(np.random.default_rng(4), jcfg, 3)
    jstep = jax.jit(JSTEPS.make_train_step(jcfg, loss_kind="dpo"))
    tstep = TSTEPS.make_train_step(tcfg, loss_kind="dpo")
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    jo = jax.tree_util.tree_map(jnp.asarray, opt)
    jhp = jax.tree_util.tree_map(jnp.asarray, hp)
    tl = bridge.lora_from_numpy(lora, "cpu")
    to = bridge.adamw_state_from_numpy(opt, "cpu")
    thp = bridge.hparams_from_numpy(hp, "cpu")
    for i, nb in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        jb["slot_ranks"] = jnp.asarray(ranks)
        tb = {k: _t(v) for k, v in nb.items()}
        tb["slot_ranks"] = _t(ranks)
        jl, jo, jm = jstep(jparams, jl, jo, jhp, jnp.asarray(active),
                           jnp.asarray(ranks), jb)
        tl, to, tm = tstep(tparams, tl, to, thp, _t(active), _t(ranks), tb)
        np.testing.assert_allclose(tm["per_slot_loss"].numpy(),
                                   np.asarray(jm["per_slot_loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i} loss")
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]),
                                   err_msg=f"step {i} norm", **GTOL)
    for t in jl:
        for m in jl[t]:
            np.testing.assert_allclose(tl[t][m].numpy(),
                                       np.asarray(jl[t][m]),
                                       err_msg=f"lora {t}.{m}", **GTOL)
    # the eval step of the DPO kind against the JAX one
    jeval = jax.jit(JSTEPS.make_eval_step(jcfg, loss_kind="dpo"))(
        jparams, jl, jnp.asarray(active), jb)
    teval = TSTEPS.make_eval_step(tcfg, loss_kind="dpo")(
        tparams, tl, _t(active), tb)
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval),
                               rtol=LOSS_RTOL)


def _pair_data(seed=0, vocab=128, seq=16):
    kw = dict(num_train=24, num_val=8)
    return ((JSYN.make_task_dataset("c", vocab, seq, difficulty=0.2,
                                    seed=seed + 1, **kw),
             JSYN.make_task_dataset("r", vocab, seq, difficulty=0.9,
                                    seed=seed + 2, **kw)),
            (TSYN.make_task_dataset("c", vocab, seq, difficulty=0.2,
                                    seed=seed + 1, **kw),
             TSYN.make_task_dataset("r", vocab, seq, difficulty=0.9,
                                    seed=seed + 2, **kw)))


def test_pair_slot_batcher_draws_the_jax_pairs():
    (jc, jr), (tc, tr) = _pair_data()
    jb = JSYN.PairSlotBatcher(jc, jr, 3, 2, seed=5)
    tb = TSYN.PairSlotBatcher(tc, tr, 3, 2, seed=5)
    draws = [lambda b: b.next_batch_dict(), lambda b: b.lane_batch_dict(1, 3),
             lambda b: b.next_batch_dict(), lambda b: b.val_batch_dict(),
             lambda b: (b.reset_slot(2, seed=11), b.next_batch_dict())[1]]
    for _ in range(4):
        for draw in draws:
            want, got = draw(jb), draw(tb)
            assert list(got) == list(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
    assert tb.epochs == jb.epochs and tb.seq_len == jb.seq_len


# ---------------------------------------------------------------------------
# (b) DPO co-located == solo inside the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(
        tget_arch("paper-llama-tiny").reduced(num_layers=2, d_model=64,
                                              vocab=128), dtype="float32")
    params = TM.init_params(cfg, seed=0, device="cpu")
    _, (tc, tr) = _pair_data()
    ds = TSYN.make_task_dataset("s", 128, 16, num_train=24, num_val=8,
                                difficulty=0.3, seed=4)
    return cfg, params, tc, tr, ds


def _hists(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def test_dpo_colocated_losses_bitwise_equal_solo(tiny):
    """Two DPO tasks (ranks 2/4 and 3/8) fused on one executor give each
    task's loss histories of running alone, bit for bit."""
    cfg, params, tc, tr, _ = tiny

    def lifecycle(ex, name, ranks, seed):
        jobs = {f"{name}/j{i}": TrainConfig(learning_rate=lr, lora_rank=rk)
                for i, (lr, rk) in enumerate(zip((3e-3, 1e-3), ranks))}
        return TaskLifecycle(
            ex, name, jobs, 6, max_slots=2, seed=seed,
            ee=EarlyExitConfig(warmup_ratio=0.25, select_ratio=1.0),
            batcher=TSYN.PairSlotBatcher(tc, tr, 2, 2, seed=seed))

    def run(names):
        ex = SharedBackboneExecutor(cfg, params, Z=4, per_adapter_batch=2,
                                    eval_every=2, loss_kind="dpo",
                                    seq_cap=16, device="cpu")
        specs = {"a": ((2, 4), 1), "b": ((3, 8), 2)}
        lcs = [lifecycle(ex, n, *specs[n]) for n in names]
        res = run_colocated(ex, lcs)
        return res, {lc.task_name: _hists(lc) for lc in lcs}

    fused, fh = run(["a", "b"])
    for name in ("a", "b"):
        solo, sh = run([name])
        assert fh[name] == sh[name]
        assert fused[name].best_val == solo[name].best_val
        assert np.isfinite(solo[name].best_val)


# ---------------------------------------------------------------------------
# (c) durable state
# ---------------------------------------------------------------------------

def test_state_tree_roundtrip(tmp_path):
    path = str(tmp_path / "st.npz")
    tree = {"snap": {"task/a": {"A": torch.arange(6, dtype=torch.float32),
                                "B": np.ones((2, 3), np.int64),
                                "h": torch.linspace(0, 1, 5).to(
                                    torch.bfloat16)}},
            "prng": np.asarray([1, 2], np.uint32)}
    meta = {"chunk": 3, "queue": ["x", "y"]}
    TCK.save_state_tree(path, tree, meta=meta)
    tree2, meta2 = TCK.load_state_tree(path)
    assert meta2["chunk"] == 3 and meta2["queue"] == ["x", "y"]
    assert list(tree2) == list(tree)                 # order preserved
    a = tree2["snap"]["task/a"]
    np.testing.assert_array_equal(a["A"], np.arange(6, dtype=np.float32))
    np.testing.assert_array_equal(a["B"], tree["snap"]["task/a"]["B"])
    assert torch.equal(a["h"], tree["snap"]["task/a"]["h"])
    np.testing.assert_array_equal(tree2["prng"], tree["prng"])
    # the JAX package reads the port's file, and the port the JAX one's
    jtree, jmeta = JCK.load_state_tree(path)
    assert jmeta == meta2 and list(jtree) == list(tree2)
    np.testing.assert_array_equal(np.asarray(jtree["snap"]["task/a"]["h"],
                                             np.float32),
                                  a["h"].float().numpy())
    jpath = str(tmp_path / "jax.npz")
    JCK.save_state_tree(jpath, jtree, meta=jmeta)
    back, bmeta = TCK.load_state_tree(jpath)
    assert bmeta == meta and torch.equal(back["snap"]["task/a"]["h"],
                                         a["h"])


def test_insert_slot_writes_one_slot_in_place():
    """insert_slot returns a new tree with one slot written, as the JAX
    package's does, and leaves its input as it was."""
    rng = np.random.default_rng(0)
    full = {"q": {"A": rng.standard_normal((2, 3, 4)).astype(np.float32),
                  "B": rng.standard_normal((2, 3, 5)).astype(np.float32)}}
    one = {"q": {"A": np.ones((2, 4), np.float32),
                 "B": np.full((2, 5), 2.0, np.float32)}}
    tree = {t: {m: torch.from_numpy(x.copy()) for m, x in ab.items()}
            for t, ab in full.items()}
    mixed = {"q": {"A": torch.from_numpy(one["q"]["A"]), "B": one["q"]["B"]}}
    out = TCK.insert_slot(tree, 1, mixed)
    assert out is not tree
    want = JCK.insert_slot(jax.tree_util.tree_map(jnp.asarray, full), 1,
                           jax.tree_util.tree_map(jnp.asarray, one))
    for m in ("A", "B"):
        np.testing.assert_array_equal(out["q"][m].numpy(),
                                      np.asarray(want["q"][m]))
        np.testing.assert_array_equal(tree["q"][m].numpy(), full["q"][m])
    assert torch.equal(TCK.extract_slot(out, 1)["q"]["A"], torch.ones(2, 4))


def test_checkpointer_prunes_and_latest(tmp_path):
    ck = TTS.TaskCheckpointer(str(tmp_path / "s"), every=1, keep=2)
    tdir = os.path.join(ck.dir, "t")
    os.makedirs(tdir)
    for i in (1, 2, 3):
        TCK.save_state_tree(os.path.join(tdir, f"chunk-{i:06d}.npz"),
                            {"x": np.zeros(1)}, meta={"chunk": i,
                                                      "schema": 1})
        ck._prune(tdir)
    assert sorted(os.listdir(tdir)) == ["chunk-000002.npz",
                                        "chunk-000003.npz"]
    assert ck.latest("t").endswith("chunk-000003.npz")
    assert TTS.load_task_checkpoint(ck.latest("t"))[1]["chunk"] == 3
    # unreadable artifact -> None, never an exception
    with open(ck.latest("t"), "wb") as f:
        f.write(b"nope")
    assert TTS.load_task_checkpoint(ck.latest("t")) is None


def test_corrupt_or_stale_checkpoint_degrades_to_none(tmp_path):
    p = str(tmp_path / "c.npz")
    TCK.save_state_tree(p, {"x": np.zeros(2)}, meta={"schema": 1})
    assert TTS.load_task_checkpoint(p) is not None
    TCK.save_state_tree(p, {"x": np.zeros(2)}, meta={"schema": 99})
    assert TTS.load_task_checkpoint(p) is None          # stale schema
    with open(p, "wb") as f:
        f.write(b"\x00" * 100)                         # trashed
    assert TTS.load_task_checkpoint(p) is None
    assert TTS.load_task_checkpoint(str(tmp_path / "missing.npz")) is None


def test_journal_is_not_ported_yet(tmp_path):
    with pytest.raises(NotImplementedError, match="journal"):
        TTS.TaskCheckpointer(str(tmp_path), journal=object())


def _keys(node):
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    return None


def test_exported_tree_has_the_jax_keys(tiny, tmp_path):
    """One DPO task (4 jobs on 2 slots, mixed ranks) in both packages,
    exported at its first chunk boundary (the first warmup wave rotated
    out, the second resident): the same tree paths, the same meta keys and
    the same host decisions (phase, counters, residents, batch-stream
    state). The JAX package's checkpoint file then resumes in both
    packages and the continuations agree: the same best job, every job's
    loss histories within the loss bar (1e-4) and the winner's adapter
    within the gradient bar (2e-3). No job is admitted fresh after the
    resume (the admission counter is the file's at the end of both runs):
    fresh inits are drawn differently in the two packages by design, so
    the continuations are comparable exactly when every resident and
    rotated job comes from the file."""
    cfg, tparams, *_ = tiny
    (jc, jr), (tc, tr) = _pair_data()
    jcfg = reduced_f32("paper-llama-tiny", num_layers=2, d_model=64,
                       vocab=128)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    jobs = {f"r{r}-lr{lr:g}": (lr, r) for r in (2, 4) for lr in (1e-3, 3e-3)}
    got = {}

    class Stop(Exception):
        pass

    def grab(name):
        def hook(lc, chunk_i):
            got[name] = (JTS if name == "jax" else TTS).export_lifecycle(lc)
            raise Stop
        return hook

    jbx = JEX.BatchedExecutor(
        jcfg, jparams, None, Z=2, per_adapter_batch=2, eval_every=2,
        ee=JEarlyExitConfig(warmup_ratio=0.25, select_ratio=0.5),
        loss_kind="dpo", batcher=JSYN.PairSlotBatcher(jc, jr, 2, 2, seed=0),
        seq_cap=16)
    jbx.ckpt_hook = grab("jax")
    with pytest.raises(Stop):
        jbx.run_task("dpo", {j: JTrainConfig(learning_rate=lr, lora_rank=r)
                             for j, (lr, r) in jobs.items()}, 8)
    tbx = BatchedExecutor(
        cfg, tparams, None, Z=2, per_adapter_batch=2, eval_every=2,
        ee=EarlyExitConfig(warmup_ratio=0.25, select_ratio=0.5),
        loss_kind="dpo", batcher=TSYN.PairSlotBatcher(tc, tr, 2, 2, seed=0),
        seq_cap=16, device="cpu")
    tbx.ckpt_hook = grab("port")
    with pytest.raises(Stop):
        tbx.run_task("dpo", {j: TrainConfig(learning_rate=lr, lora_rank=r)
                             for j, (lr, r) in jobs.items()}, 8)
    (jtree, jmeta), (ttree, tmeta) = got["jax"], got["port"]
    assert _keys(ttree) == _keys(jtree)
    assert set(ttree["perm"]) == {"chosen", "rejected"}
    assert list(tmeta) == list(jmeta)
    np.testing.assert_array_equal(ttree["prng"], np.asarray(jtree["prng"]))
    for k in ("schema", "phase", "wave_idx", "wave_step", "cont_step",
              "admissions", "queue", "resident", "batcher", "snap_meta"):
        assert tmeta[k] == jmeta[k], k
    for name in ttree["perm"]:
        for z in ttree["perm"][name]:
            np.testing.assert_array_equal(ttree["perm"][name][z],
                                          jtree["perm"][name][z])
    # the JAX lifecycle's file, resumed by the port on bridged weights
    path = str(tmp_path / "jax-chunk.npz")
    JCK.save_state_tree(path, jtree, dict(jmeta, chunk=1))
    state = TTS.load_task_checkpoint(path)
    bparams = bridge.params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rbx = BatchedExecutor(
        cfg, bparams, None, Z=2, per_adapter_batch=2, eval_every=2,
        ee=EarlyExitConfig(warmup_ratio=0.25, select_ratio=0.5),
        loss_kind="dpo", batcher=TSYN.PairSlotBatcher(tc, tr, 2, 2, seed=0),
        seq_cap=16, device="cpu")
    ends = {}
    rbx.ckpt_hook = lambda lc, i: ends.update(port=lc)
    res = _drain(rbx.resume_task_chunks(
        "dpo", {j: TrainConfig(learning_rate=lr, lora_rank=r)
                for j, (lr, r) in jobs.items()}, 8, state, start_chunk=1))
    assert res.best_job in jobs and np.isfinite(res.best_val)
    assert sum(r.steps_trained for r in res.job_results.values()) > 4
    # the same file resumed by the JAX package
    jrbx = JEX.BatchedExecutor(
        jcfg, jparams, None, Z=2, per_adapter_batch=2, eval_every=2,
        ee=JEarlyExitConfig(warmup_ratio=0.25, select_ratio=0.5),
        loss_kind="dpo", batcher=JSYN.PairSlotBatcher(jc, jr, 2, 2, seed=0),
        seq_cap=16)
    jrbx.ckpt_hook = lambda lc, i: ends.update(jax=lc)
    jres = _drain(jrbx.resume_task_chunks(
        "dpo", {j: JTrainConfig(learning_rate=lr, lora_rank=r)
                for j, (lr, r) in jobs.items()}, 8,
        JTS.load_task_checkpoint(path), start_chunk=1))
    admitted = jmeta["admissions"]
    assert ends["port"]._admissions == ends["jax"]._admissions == admitted
    assert res.best_job == jres.best_job
    np.testing.assert_allclose(res.best_val, jres.best_val, rtol=LOSS_RTOL)
    for j, m in ends["jax"].monitors.items():
        tm_ = ends["port"].monitors[j]
        for h in ("val_hist", "raw_train_hist"):
            want, got = getattr(m, h), getattr(tm_, h)
            assert len(got) == len(want), (j, h)
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL,
                                       err_msg=f"{j} {h}")
    tw = res.job_results[res.best_job].adapter
    jw = jres.job_results[jres.best_job].adapter
    for t in jw:
        for m in jw[t]:
            np.testing.assert_allclose(tw[t][m].numpy(), np.asarray(jw[t][m]),
                                       err_msg=f"{t}.{m}", **GTOL)


# ---------------------------------------------------------------------------
# (d) kill and recover
# ---------------------------------------------------------------------------

def _task(tiny, kind):
    cfg, params, tc, tr, ds = tiny
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=b)
            for r, b in ((2, 2), (8, 1)) for lr in (1e-3, 3e-3)}

    def make(counter=None):
        batcher = (TSYN.PairSlotBatcher(tc, tr, 2, 2, seed=0)
                   if kind == "dpo" else None)
        bx = BatchedExecutor(cfg, params, ds, Z=2, per_adapter_batch=2,
                             ee=EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.5),
                             eval_every=2, loss_kind=kind, batcher=batcher,
                             seq_cap=16, device="cpu")
        if counter is not None:
            step = bx.backbone._train_step

            def counted(*a):
                counter.append(1)
                return step(*a)
            bx.backbone._train_step = counted
        return bx
    return jobs, make


def _drain(gen):
    while True:
        try:
            next(gen)
        except StopIteration as done:
            return done.value


def _same_result(a, b):
    if a.best_job != b.best_job or a.best_val != b.best_val:
        return False
    for j, ra in a.job_results.items():
        rb = b.job_results[j]
        if (ra.best_val, ra.best_val_step, ra.exit_reason, ra.steps_trained
                ) != (rb.best_val, rb.best_val_step, rb.exit_reason,
                      rb.steps_trained):
            return False
    wa, wb = a.job_results[a.best_job].adapter, b.job_results[
        b.best_job].adapter
    return all(torch.equal(wa[t][m], wb[t][m]) for t in wa for m in wa[t])


@pytest.mark.parametrize("kind", ["sft", "dpo"])
def test_kill_and_recover_bitwise(tiny, kind, tmp_path):
    """Crash after the third durable checkpoint (mid-rotation: more jobs
    than slots, mixed ranks and widths), resume on a fresh executor: the
    tail equals the uninterrupted run bit for bit and costs fewer steps; a
    perturbed AdamW moment in the file breaks the equality."""
    jobs, make = _task(tiny, kind)
    steps0 = []
    bx0 = make(steps0)
    hist0 = {}
    bx0.ckpt_hook = lambda lc, i: hist0.update(lc=lc)
    res0 = bx0.run_task(kind, jobs, 8)
    mon0 = {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in hist0["lc"].monitors.items()}

    ck = TTS.TaskCheckpointer(str(tmp_path / "state"), every=1)
    ck.fail_after["*"] = 3
    bx1 = make()
    bx1.ckpt_hook = ck.on_chunk
    with pytest.raises(TTS.SimulatedCrash):
        bx1.run_task(kind, jobs, 8)
    state = TTS.load_task_checkpoint(ck.latest(kind))
    assert state is not None and state[1]["chunk"] == 3

    steps1 = []
    bx2 = make(steps1)
    seen = {}
    bx2.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res1 = _drain(bx2.resume_task_chunks(kind, jobs, 8, state,
                                         start_chunk=state[1]["chunk"]))
    mon1 = {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in seen["lc"].monitors.items()}
    assert mon1 == mon0
    assert _same_result(res1, res0)
    assert 0 < len(steps1) < len(steps0)

    # one first moment of the winner (resident or rotated out at the
    # crash, and trained after it) perturbed in the file
    tree, meta = TTS.load_task_checkpoint(ck.latest(kind))
    assert res0.best_job in tree["snap"]
    leaf = tree["snap"][res0.best_job]["mu"]["q_proj"]["A"]
    leaf.reshape(-1)[0] += 1e-3
    bx3 = make()
    bx3.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res2 = _drain(bx3.resume_task_chunks(kind, jobs, 8, (tree, meta),
                                         start_chunk=meta["chunk"]))
    mon2 = {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in seen["lc"].monitors.items()}
    assert mon2 != mon0 and not _same_result(res2, res0)
