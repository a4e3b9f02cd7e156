"""PyTorch port: the RWKV-6 family (``rwkv6-3b``, the ``ssm`` family) held
against the JAX package, and its bitwise contracts inside the port.

(a) Model level, on a float32 ``reduced("rwkv6-3b")`` with bridged weights
    (initialized by the JAX package, carried over by ``repro_torch.bridge``)
    and numpy tokens, at the JAX package's backend bars (forward 5e-4, loss
    1e-4, gradients 2e-3; tests/test_kernel_backends.py): the forward's
    hidden states under each backend (the port's "kernel" backend takes the
    linear-scan Function once per layer), one train step's per-slot loss,
    LoRA gradients and updated adapters, prefill and decode logits over a
    recurrent cache, and the rwkv6-3b cases of tests/test_arch_smoke.py.
(b) Inside the port: idle lanes' recurrent state stays bitwise untouched by
    decode under ``active`` and by ``reset_lanes``; an rwkv task co-located
    with another equals each alone, bitwise; a task crashed after a durable
    checkpoint and resumed equals the uninterrupted run, bitwise; a rank
    sweep runs through ``BatchedExecutor.run_task``.
(c) Serving: greedy streams of ``AdapterPool -> ServingReplica ->
    ServingFrontend`` equal the JAX replica's (prompts stream through
    decode: the recurrent family has no block prefill), and every join
    leaves the other lanes' ``wkv`` / ``tm_x`` / ``cm_x`` bitwise untouched.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import lora as JLORA
from repro.core import steps as JSTEPS
from repro.core.losses import sft_loss as jsft_loss
from repro.models import backend as JBK
from repro.models import model as JM
from repro.optim import adamw as JAD
from repro.serve import AdapterPool as JPool
from repro.serve import ServingFrontend as JFrontend
from repro.serve import ServingReplica as JReplica
from repro_torch import bridge
from repro_torch.checkpoint import taskstate as TTS
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import early_exit as TEE
from repro_torch.core import lora as TLORA
from repro_torch.core import steps as TSTEPS
from repro_torch.core.executor import (BatchedExecutor,
                                       SharedBackboneExecutor, TaskLifecycle,
                                       TaskResult, run_colocated)
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels.grouped_lora import ranklocal as TRL
from repro_torch.kernels.linear_scan import linear_scan as TLSK
from repro_torch.kernels.linear_scan import ops as TLSOPS
from repro_torch.models import backend as TBK
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAD
from repro_torch.serve import AdapterPool, ServingFrontend, ServingReplica
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401
from tests.test_torch_recovery import _drain, _same_result

FWD_TOL = dict(rtol=5e-4, atol=5e-4)
GTOL = dict(rtol=2e-3, atol=2e-3)
LOSS_RTOL = 1e-4
KW = dict(num_layers=2, d_model=128, vocab=256)
Z, BSZ, SEQ = 2, 2, 32          # SEQ spans two chunks of the reduced 16
RANKS = [3, 6]


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    jcfg = reduced_f32("rwkv6-3b", **kw)
    tcfg = dataclasses.replace(tget_arch("rwkv6-3b").reduced(**kw),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def env():
    jcfg, tcfg = _cfgs(**KW)
    assert tcfg.family == "ssm" and tcfg.ssm.chunk_size == 16
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    r = tcfg.lora.r_max
    lora = {}
    for t, (din, dout) in JM.target_shapes(jcfg).items():
        mask = (np.arange(r)[None, :] < np.asarray(RANKS)[:, None]).astype(
            np.float32)                                        # [Z, r]
        lora[t] = {
            "A": (rng.standard_normal((KW["num_layers"], Z, din, r),
                                      np.float32) / din ** 0.5
                  * mask[None, :, None, :]),
            "B": (rng.standard_normal((KW["num_layers"], Z, r, dout),
                                      np.float32) * 0.05
                  * mask[None, :, :, None])}
    tokens = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, lora, tokens, labels


# ---------------------------------------------------------------------------
# (a) model level against the JAX package
# ---------------------------------------------------------------------------

def test_target_shapes_and_params_match_jax(env):
    jcfg, tcfg, jparams, tparams, *_ = env
    assert TM.target_shapes(tcfg) == JM.target_shapes(jcfg)
    assert set(TM.target_shapes(tcfg)) == set(tcfg.lora.targets)
    own = TM.init_params(tcfg, seed=0, device="cpu")
    assert set(own["layers"]) == set(jparams["layers"])
    for k, v in jparams["layers"].items():
        assert tuple(own["layers"][k].shape) == v.shape, k
        assert own["layers"][k].dtype == tparams["layers"][k].dtype, k


def _spy_scan(monkeypatch):
    calls = []
    real = TLSOPS._LinearScan.apply

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return real(*args)
    monkeypatch.setattr(TLSOPS._LinearScan, "apply", spy)
    return calls


@pytest.mark.parametrize("backends", [("kernel", "pallas_interpret"),
                                      ("torch", "jnp")])
def test_forward_matches_jax(env, backends, monkeypatch):
    """Hidden states of the port's forward under "kernel" (the scan
    Function, once per layer, on [Z*b*H, S, hs] rows) and "torch" (the plain
    core) against the JAX forward under its Pallas (interpret) and jnp
    backends."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    tb, jb = backends
    with JBK.backend(jb):
        want, _, _ = jax.jit(lambda p, l_, t: JM.forward(
            jcfg, p, l_, t, remat=False))(
                jparams, jax.tree_util.tree_map(jnp.asarray, lora),
                jnp.asarray(tokens))
    calls = _spy_scan(monkeypatch)
    with TBK.backend(tb), torch.no_grad(), TLORA.slot_ranks(_t(RANKS)):
        got, aux, _ = TM.forward(tcfg, tparams,
                                 bridge.lora_from_numpy(lora, "cpu"),
                                 _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    assert float(aux) == 0.0
    H, hs = tcfg.num_heads, tcfg.ssm.head_size
    rows = [(Z * BSZ * H, SEQ, hs)] * tcfg.num_layers
    assert calls == (rows if tb == "kernel" else [])


def test_train_step_matches_jax(env, monkeypatch):
    """One make_train_step at mixed ranks (slot_ranks bound, the rank-local
    path): per-slot loss (1e-4), grad norm, every LoRA gradient and the
    updated adapters and first moments (2e-3) against the JAX step (its XLA
    path). Under remat the scan Function runs twice per layer (the forward
    and its recompute) in each of the two gradient passes."""
    jcfg, tcfg, jparams, tparams, lora, tokens, labels = env
    batch = {"tokens": tokens, "labels": labels}
    ranks, active = np.asarray(RANKS, np.int32), np.ones(Z, np.int32)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    jopt = JAD.init_state(jl, Z)
    jhp = JAD.SlotHParams.broadcast(Z, lr=3e-3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jb["slot_ranks"] = jnp.asarray(ranks)

    @jax.jit
    def jfn(lora_, opt_, batch_):
        b = {k: v for k, v in batch_.items() if k != "slot_ranks"}
        with JLORA.slot_ranks(batch_["slot_ranks"]):
            grads = jax.grad(lambda l_: jsft_loss(
                jcfg, jparams, l_, b, jnp.asarray(active))[0])(lora_)
        return grads, JSTEPS.make_train_step(jcfg)(
            jparams, lora_, opt_, jhp, jnp.asarray(active),
            jnp.asarray(ranks), batch_)

    jgrads, (jl2, jopt2, jm) = jfn(jl, jopt, jb)
    calls = _spy_scan(monkeypatch)
    tl = bridge.lora_from_numpy(lora, "cpu")
    tb = {k: _t(v) for k, v in batch.items()}
    tb["slot_ranks"] = _t(ranks)
    _, tgrads = TSTEPS.lora_grads(tcfg, tparams, tl, tb, _t(active))
    topt = TAD.init_state(tl, Z)
    thp = TAD.SlotHParams.broadcast(Z, lr=3e-3, device="cpu")
    tl2, topt2, tm = TSTEPS.make_train_step(tcfg)(
        tparams, tl, topt, thp, _t(active), _t(ranks), tb)
    np.testing.assert_allclose(tm["per_slot_loss"].numpy(),
                               np.asarray(jm["per_slot_loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), **GTOL)
    for name, got, want in (("grad", tgrads, jgrads), ("lora", tl2, jl2),
                            ("mu", topt2.mu, jopt2.mu)):
        for t in want:
            for m in want[t]:
                np.testing.assert_allclose(
                    got[t][m].detach().numpy(), np.asarray(want[t][m]),
                    err_msg=f"{name} {t}.{m}", **GTOL)
    assert len(calls) == 2 * 2 * tcfg.num_layers


def _cache_close(tc, jc):
    for leaf in ("wkv", "tm_x", "cm_x"):
        np.testing.assert_allclose(tc["layers"][leaf].numpy(),
                                   np.asarray(jc["layers"][leaf]),
                                   err_msg=leaf, **FWD_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_prefill_and_decode_over_recurrent_cache_match_jax(env):
    """forward(cache=...) over a 6-token prompt (the scan continues from
    the zero state), then three global-position decode steps (the recurrent
    step): logits and the whole cache against the JAX package; the cache
    holds no K/V and no ring."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    jc = JM.init_cache(jcfg, Z, BSZ, 16)
    tc = TM.init_cache(tcfg, Z, BSZ, 16, ring=True, device="cpu")
    assert set(tc["layers"]) == {"wkv", "tm_x", "cm_x"} and "k_pos" not in tc
    jpre = jax.jit(JSTEPS.make_prefill_step(jcfg))
    jdec = jax.jit(JSTEPS.make_serve_step(jcfg))
    with torch.no_grad():
        jlog, jc = jpre(jparams, jl, jc, {"tokens": jnp.asarray(
            tokens[:, :, :6])})
        tlog, tc = TSTEPS.make_prefill_step(tcfg)(
            tparams, tl, tc, {"tokens": _t(tokens[:, :, :6])})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
        _cache_close(tc, jc)
        for i in range(6, 9):
            jlog, jc = jdec(jparams, jl, jc, jnp.asarray(tokens[:, :, i]))
            tlog, tc = TSTEPS.make_serve_step(tcfg)(tparams, tl, tc,
                                                    _t(tokens[:, :, i]))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **FWD_TOL)
            _cache_close(tc, jc)


def test_per_lane_decode_and_reset_keep_idle_lanes(env):
    """Per-lane decode under ``active`` matches the JAX package on the live
    lanes and leaves the idle lanes' wkv / tm_x / cm_x and position bitwise
    untouched; ``reset_lanes`` zeroes exactly the masked lanes; a block
    lane prefill is refused (the family joins by streaming)."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    jc = JM.init_cache(jcfg, Z, BSZ, 16, per_lane=True)
    tc = TM.init_cache(tcfg, Z, BSZ, 16, per_lane=True, device="cpu")
    active = np.array([[True, False], [True, True]])
    jdec = jax.jit(lambda c, t, a: JM.decode_step(jcfg, jparams, jl, c, t,
                                                  active=a))
    with torch.no_grad():
        for i in range(3):
            act = np.ones_like(active) if i == 0 else active
            jlog, jc = jdec(jc, jnp.asarray(tokens[:, :, i]),
                            jnp.asarray(act))
            before = {k: v.clone() for k, v in tc["layers"].items()}
            tlog, tc = TM.decode_step(tcfg, tparams, tl, tc,
                                      _t(tokens[:, :, i]), active=_t(act))
            np.testing.assert_allclose(tlog.numpy()[act],
                                       np.asarray(jlog)[act], **FWD_TOL)
            for k, v in tc["layers"].items():
                assert torch.equal(v[:, ~_t(act)], before[k][:, ~_t(act)])
        _cache_close(tc, jc)
        mask = _t(np.array([[False, True], [False, False]]))
        before = {k: v.clone() for k, v in tc["layers"].items()}
        tc = TM.reset_lanes(tcfg, tc, mask)
        for k, v in tc["layers"].items():
            assert torch.equal(v[:, ~mask], before[k][:, ~mask])
            assert bool((v[:, mask] == 0).all())
        assert tc["pos"].tolist() == [[3, 0], [3, 3]]
        with pytest.raises(ValueError, match="attention cache"):
            TM.prefill_lanes(tcfg, tparams, tl, tc, _t(tokens[:, :, :4]),
                             mask)


# the rwkv6-3b cases of tests/test_arch_smoke.py, in the port
def _smoke_setup():
    jcfg = dataclasses.replace(jget_arch("rwkv6-3b").reduced(),
                               dtype="float32")
    tcfg = dataclasses.replace(tget_arch("rwkv6-3b").reduced(),
                               dtype="float32")
    key = jax.random.PRNGKey(0)
    jparams = JM.init_params(key, jcfg)
    jl = JLORA.init_lora_tree(key, jcfg, 2, jnp.array([4, 8]),
                              JM.target_shapes(jcfg))
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tl = bridge.lora_from_numpy(jax.tree_util.tree_map(np.asarray, jl),
                                "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 2, 32)).astype(np.int32)
    return jcfg, tcfg, jparams, jl, tparams, tl, tokens


def test_arch_smoke_forward_and_train_step():
    """test_arch_smoke's forward (shapes, finite, the token count) and
    train step (finite loss, adapters moved, the rank mask kept) for
    rwkv6-3b in the port."""
    _, tcfg, _, _, tparams, tl, tokens = _smoke_setup()
    with torch.no_grad():
        h, _, _ = TM.forward(tcfg, tparams, tl, _t(tokens))
    assert h.shape == (2, 2, 32, tcfg.d_model)
    assert bool(torch.isfinite(h).all())
    loss, cnt = TM.per_slot_xent(tcfg, tparams, h, _t(tokens))
    assert loss.shape == (2,) and bool(torch.isfinite(loss).all())
    assert float(cnt[0]) == 2 * 32
    before = {t: {m: x.clone() for m, x in ab.items()} for t, ab in tl.items()}
    ranks = torch.tensor([4, 8], dtype=torch.int32)
    tl2, _, met = TSTEPS.make_train_step(tcfg)(
        tparams, tl, TAD.init_state(tl, 2),
        TAD.SlotHParams.broadcast(2, lr=1e-3, device="cpu"),
        torch.ones(2, dtype=torch.int32), ranks,
        {"tokens": _t(tokens), "labels": _t(tokens)})
    assert bool(torch.isfinite(met["per_slot_loss"]).all())
    moved = sum(float((tl2[t][m] - before[t][m]).abs().sum())
                for t in tl2 for m in tl2[t])
    assert moved > 0.0
    for ab in tl2.values():
        assert float(ab["A"][:, 0, :, 4:].abs().max()) == 0.0


def test_arch_smoke_serve_and_recurrent_long_decode_match_jax():
    """test_arch_smoke's serve step and ring_or_recurrent_long_decode for
    rwkv6-3b: four decode steps over a pure recurrent state (no ring, no
    K/V), logits against the JAX package's at every step."""
    jcfg, tcfg, jparams, jl, tparams, tl, tokens = _smoke_setup()
    jc = JM.init_cache(jcfg, 2, 2, 128, ring=False)
    tc = TM.init_cache(tcfg, 2, 2, 128, ring=False, device="cpu")
    jserve = jax.jit(JSTEPS.make_serve_step(jcfg))
    serve = TSTEPS.make_serve_step(tcfg)
    with torch.no_grad():
        for t in range(4):
            jlog, jc = jserve(jparams, jl, jc, jnp.asarray(tokens[:, :, t]))
            tlog, tc = serve(tparams, tl, tc, _t(tokens[:, :, t]))
            assert tlog.shape == (2, 2, tcfg.vocab_size)
            assert bool(torch.isfinite(tlog).all())
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **FWD_TOL)
    assert int(tc["pos"]) == 4 and "k_pos" not in tc


# ---------------------------------------------------------------------------
# (b) inside the port: executor contracts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    _, cfg = _cfgs(num_layers=2, d_model=64, vocab=128)
    params = TM.init_params(cfg, seed=0, device="cpu")
    ds = [TSYN.make_task_dataset(f"task-{i}", cfg.vocab_size, seq_len=SEQ,
                                 num_train=32, num_val=8,
                                 difficulty=0.2 + 0.4 * i, seed=1 + i)
          for i in range(2)]
    return cfg, params, ds


def _hists(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def test_colocated_rwkv_task_bitwise_equal_solo(small):
    """Two rwkv tasks at different true ranks (2/4 and 3/5 of r_max 8)
    fused on one executor give each task's loss histories alone, bit for
    bit; on the CPU no kernel launches."""
    cfg, params, ds = small
    specs = [("A", ds[0], 3, (2, 4)), ("B", ds[1], 4, (3, 5))]

    def run(chosen):
        ex = SharedBackboneExecutor(cfg, params, Z=4, per_adapter_batch=2,
                                    eval_every=2, seed=0, device="cpu")
        lcs = []
        for name, d, seed, ranks in chosen:
            jobs = {f"{name}/j{i}": TrainConfig(learning_rate=lr,
                                                lora_rank=rk, max_steps=6)
                    for i, (lr, rk) in enumerate(zip((3e-3, 1e-3), ranks))}
            lcs.append(TaskLifecycle(
                ex, name, jobs, 6, max_slots=2, seed=seed,
                ee=TEE.EarlyExitConfig(warmup_ratio=0.25, select_ratio=1.0),
                batcher=TSYN.SlotBatcher(d, 2, ex.b_cap, seed=seed)))
        return run_colocated(ex, lcs), {lc.task_name: _hists(lc)
                                        for lc in lcs}

    TLSK.reset_launches()
    fused, fused_h = run(specs)
    solo_a, solo_a_h = run(specs[:1])
    solo_b, solo_b_h = run(specs[1:])
    assert fused_h["A"] == solo_a_h["A"] and fused_h["B"] == solo_b_h["B"]
    assert fused["A"].best_val == solo_a["A"].best_val
    assert fused["B"].best_val == solo_b["B"].best_val
    assert np.isfinite(fused["A"].best_val)
    assert TLSK.LAUNCHES == {"linear_scan": 0}
    assert set(TRL.LAUNCHES.values()) == {0}


def test_rwkv_kill_and_recover_bitwise(small, tmp_path):
    """An rwkv task (4 jobs on 2 slots, mixed ranks and widths) crashed
    after its third durable checkpoint and resumed on a fresh executor
    ends bitwise equal to the uninterrupted run, in fewer steps; one AdamW
    moment of the winner perturbed in the file changes the loss
    histories after the resume."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=b)
            for r, b in ((2, 2), (8, 1)) for lr in (1e-3, 3e-3)}

    def make(counter=None):
        bx = BatchedExecutor(cfg, params, ds[0], Z=2, per_adapter_batch=2,
                             ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                    select_ratio=0.5),
                             eval_every=2, seq_cap=SEQ, device="cpu")
        if counter is not None:
            step = bx.backbone._train_step

            def counted(*a):
                counter.append(1)
                return step(*a)
            bx.backbone._train_step = counted
        return bx

    steps0, seen = [], {}
    bx0 = make(steps0)
    bx0.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res0 = bx0.run_task("rwkv", jobs, 8)
    mon0 = _hists(seen["lc"])
    ck = TTS.TaskCheckpointer(str(tmp_path / "state"), every=1)
    ck.fail_after["*"] = 3
    bx1 = make()
    bx1.ckpt_hook = ck.on_chunk
    with pytest.raises(TTS.SimulatedCrash):
        bx1.run_task("rwkv", jobs, 8)
    state = TTS.load_task_checkpoint(ck.latest("rwkv"))
    assert state is not None and state[1]["chunk"] == 3
    steps1 = []
    bx2 = make(steps1)
    bx2.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res1 = _drain(bx2.resume_task_chunks("rwkv", jobs, 8, state,
                                         start_chunk=3))
    assert _hists(seen["lc"]) == mon0 and _same_result(res1, res0)
    assert 0 < len(steps1) < len(steps0)
    tree, meta = TTS.load_task_checkpoint(ck.latest("rwkv"))
    assert res0.best_job in tree["snap"]
    tree["snap"][res0.best_job]["mu"]["r_proj"]["A"].reshape(-1)[0] += 1e-3
    bx3 = make()
    bx3.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res2 = _drain(bx3.resume_task_chunks("rwkv", jobs, 8, (tree, meta),
                                         start_chunk=3))
    assert _hists(seen["lc"]) != mon0 and res2.best_job in jobs


def test_rwkv_rank_sweep_through_run_task(small):
    """8 jobs (ranks 2/3/4/6 x two learning rates) on 4 slots of the
    reduced rwkv6-3b: warmup, selection and continue, a TaskResult with
    finite losses — the chip smoke's rwkv rank sweep at a reduced size."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=2)
            for r in (2, 3, 4, 6) for lr in (1e-3, 1e-2)}
    bx = BatchedExecutor(cfg, params, ds[0], Z=4, per_adapter_batch=2,
                         ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.25),
                         eval_every=2, device="cpu")
    result = bx.run_task("rwkv-sweep", jobs, total_steps=8)
    assert isinstance(result, TaskResult) and result.best_job in jobs
    assert result.exit_counts.get("underperforming") == 6
    assert sum(result.exit_counts.values()) == 8
    assert all(np.isfinite(r.best_val) for r in result.job_results.values()
               if r.exit_reason is None or r.exit_reason.value != "diverging")
    winner = result.job_results[result.best_job].adapter
    assert set(winner) == set(cfg.lora.targets)


# ---------------------------------------------------------------------------
# (c) serving
# ---------------------------------------------------------------------------

SERVE_RANKS, LANES, MAX_LEN, MAX_NEW = [4, 8, 2], 2, 24, 5


@pytest.fixture(scope="module")
def serve_env():
    kw = dict(num_layers=2, d_model=64, vocab=128)
    jcfg, tcfg = _cfgs(**kw)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(key)
    ranks = jnp.asarray(SERVE_RANKS, jnp.int32)
    lt = JLORA.init_lora_tree(key, jcfg, 3, ranks, JM.target_shapes(jcfg))
    lt = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(key, x.shape), lt)
    lt = JLORA.mask_lora_tree(lt, ranks, jcfg.lora.r_max)
    adapters = {z: jax.tree_util.tree_map(lambda x: np.asarray(x[:, z]), lt)
                for z in range(3)}
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(11)
    prompts = {z: [rng.integers(0, 128, size=int(rng.integers(3, 9)))
                   .astype(np.int32) for _ in range(3)] for z in range(3)}
    return jcfg, tcfg, jparams, tparams, adapters, prompts


def _submit(fe, prompts):
    for z in range(3):
        for p in prompts[z]:
            fe.submit(f"a{z}", p, MAX_NEW)
    return fe.drain()


@pytest.mark.parametrize("mode", ["continuous", "round"])
def test_rwkv_greedy_streams_match_jax_and_joins_keep_lanes(serve_env,
                                                            mode):
    """Three requests per adapter over two lanes: the port's greedy streams
    equal the JAX replica's; every lane reset (a join) and every decode
    under ``active`` leaves the lanes it does not own bitwise untouched;
    ring and block prefill are off for the family, and no scan kernel or
    plain scan runs (prompts stream through the recurrent step)."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = serve_env
    jpool = JPool(jcfg, 3)
    pool = AdapterPool(tcfg, 3, device="cpu")
    for z in range(3):
        jpool.publish(f"a{z}", adapters[z], SERVE_RANKS[z], slot=z)
        pool.publish(f"a{z}", adapters[z], SERVE_RANKS[z], slot=z)
    jout = _submit(JFrontend(JReplica(jcfg, jparams, jpool, lanes=LANES,
                                      max_len=MAX_LEN, ring=True),
                             mode=mode), prompts)
    rep = ServingReplica(tcfg, tparams, pool, lanes=LANES, max_len=MAX_LEN,
                         ring=True, device="cpu")
    assert not rep.ring and not rep._block_prefill
    checked = {"reset": 0, "decode": 0}

    def guarded(fn, kind, mask_at):
        def run(*args):
            cache, mask = args[2 if kind == "decode" else 0], args[mask_at]
            before = {k: v.clone() for k, v in cache["layers"].items()}
            out = fn(*args)
            after = out[-1] if kind == "decode" else out
            keep = ~mask
            for k, v in after["layers"].items():
                assert torch.equal(v[:, keep], before[k][:, keep]), k
            checked[kind] += 1
            return out
        return run

    rep._reset_lanes = guarded(rep._reset_lanes, "reset", 1)
    rep._decode_lanes = guarded(rep._decode_lanes, "decode", 4)
    calls = []
    real = TLSOPS._LinearScan.apply
    TLSOPS._LinearScan.apply = lambda *a: calls.append(1) or real(*a)
    try:
        tout = _submit(ServingFrontend(rep, mode=mode), prompts)
    finally:
        TLSOPS._LinearScan.apply = real
    assert len(tout) == 9 and all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout
    assert calls == []
    if mode == "continuous":
        assert checked["reset"] > 0 and checked["decode"] > 0
