"""PyTorch port: the Hymba hybrid family (``hymba-1.5b``, the ``hybrid``
family) held against the JAX package, and its bitwise contracts inside the
port.

(a) Model level, on a float32 ``reduced("hymba-1.5b")`` (2 layers, d 256,
    8 heads / 4 KV heads of 32, SSM head 32, chunk 16, window 64) with
    bridged weights (initialized by the JAX package, carried over by
    ``repro_torch.bridge``) and numpy tokens at S = 128 — the window of 64
    binds and the scan crosses 8 chunks — at the JAX package's backend bars
    (forward 5e-4, loss 1e-4, gradients 2e-3; tests/test_kernel_backends.py):
    the registry's config, target shapes and parameter keys; ``mamba_block``
    alone (a sequence, a continued sequence, one decoded token); the
    forward's hidden states under each backend (the port's "kernel" backend
    takes the flash Function and the scan Function once per layer); one
    train step's per-slot loss, LoRA gradients and updated adapters;
    prefill and decode logits over the hybrid cache, ring and not; and the
    hymba-1.5b cases of tests/test_arch_smoke.py.
(b) Inside the port: idle lanes' K/V, ``k_pos``, ``conv`` and ``ssm`` stay
    bitwise untouched by decode under ``active`` and by ``reset_lanes``; a
    hymba task co-located with another equals each alone, bitwise; a task
    crashed after a durable checkpoint and resumed equals the uninterrupted
    run, bitwise; a rank sweep runs through ``BatchedExecutor.run_task``
    (the executor's contracts at S = 32, where they cost a third).
(c) Serving: greedy streams of ``AdapterPool -> ServingReplica(ring=True)
    -> ServingFrontend`` equal the JAX replica's (prompts stream through
    decode: the hybrid family has no block prefill), and every join leaves
    the other lanes' state bitwise untouched.
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
from repro.models import mamba as JMB
from repro.models import model as JM
from repro.optim import adamw as JAD
from repro.serve import AdapterPool as JPool
from repro.serve import ServingFrontend as JFrontend
from repro.serve import ServingReplica as JReplica
from repro_torch import bridge
from repro_torch.checkpoint import taskstate as TTS
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import early_exit as TEE
from repro_torch.core import lora as TLORA
from repro_torch.core import steps as TSTEPS
from repro_torch.core.executor import (BatchedExecutor,
                                       SharedBackboneExecutor, TaskLifecycle,
                                       TaskResult, run_colocated)
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels.flash_attention import flash_attention as TFAK
from repro_torch.kernels.flash_attention import ops as TFAOPS
from repro_torch.kernels.grouped_lora import ranklocal as TRL
from repro_torch.kernels.linear_scan import linear_scan as TLSK
from repro_torch.kernels.linear_scan import ops as TLSOPS
from repro_torch.models import backend as TBK
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAD
from repro_torch.serve import AdapterPool, ServingFrontend, ServingReplica
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401
from tests.test_torch_recovery import _drain, _same_result

FWD_TOL = dict(rtol=5e-4, atol=5e-4)
GTOL = dict(rtol=2e-3, atol=2e-3)
LOSS_RTOL = 1e-4
Z, BSZ, SEQ = 2, 2, 128         # the window of 64 binds; 8 scan chunks
EX_SEQ = 32                     # the executor's contracts need no window
RANKS = [3, 6]
ARCH = "hymba-1.5b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(**kw):
    jcfg = reduced_f32(ARCH, **kw)
    tcfg = dataclasses.replace(tget_arch(ARCH).reduced(**kw),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _leaves(tree, prefix=""):
    """(dotted key, leaf) of a nested dict, in key order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _random_lora(cfg, shapes, L, rng):
    r = cfg.lora.r_max
    mask = (np.arange(r)[None, :] < np.asarray(RANKS)[:, None]).astype(
        np.float32)                                            # [Z, r]
    return {t: {"A": (rng.standard_normal((L, Z, din, r), np.float32)
                      / din ** 0.5 * mask[None, :, None, :]),
                "B": (rng.standard_normal((L, Z, r, dout), np.float32)
                      * 0.05 * mask[None, :, :, None])}
            for t, (din, dout) in shapes.items()}


@pytest.fixture(scope="module")
def env():
    jcfg, tcfg = _cfgs()
    assert (tcfg.family, tcfg.num_layers, tcfg.d_model) == ("hybrid", 2, 256)
    assert (tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim) == (8, 4, 32)
    assert (tcfg.ssm.head_size, tcfg.ssm.chunk_size,
            tcfg.sliding_window) == (32, 16, 64)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    lora = _random_lora(tcfg, JM.target_shapes(jcfg), tcfg.num_layers, rng)
    tokens = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, lora, tokens, labels


# ---------------------------------------------------------------------------
# (a) model level against the JAX package
# ---------------------------------------------------------------------------

def test_registry_config_equals_jax_field_by_field():
    assert ARCH in TREG.ASSIGNED and ARCH in TREG.list_archs()
    tcfg, jcfg = TREG.get_arch(ARCH), jget_arch(ARCH)
    tfields = dataclasses.asdict(tcfg)
    jfields = dataclasses.asdict(jcfg)
    assert tfields.keys() == jfields.keys()
    for name in jfields:
        assert tfields[name] == jfields[name], name
    assert (tcfg.num_layers, tcfg.d_model, tcfg.sliding_window,
            tcfg.ssm.state_size, tcfg.ssm.chunk_size) == (32, 1600, 1024,
                                                          16, 128)


def test_target_shapes_and_params_match_jax(env):
    jcfg, tcfg, jparams, tparams, *_ = env
    assert TM.target_shapes(tcfg) == JM.target_shapes(jcfg)
    assert set(TM.target_shapes(tcfg)) == set(tcfg.lora.targets)
    assert TMB.mamba_dims(tcfg) == JMB.mamba_dims(jcfg)
    own = dict(_leaves(TM.init_params(tcfg, seed=0, device="cpu")["layers"]))
    want = dict(_leaves(jparams["layers"]))
    bridged = dict(_leaves(tparams["layers"]))
    assert set(own) == set(bridged) == set(want)
    assert "mamba.in_proj" in own and "branch_norm_ssm" in own
    for k, v in want.items():
        assert tuple(own[k].shape) == v.shape, k
        assert own[k].dtype == bridged[k].dtype, k
    with pytest.raises(ValueError, match="depths"):
        short = jax.tree_util.tree_map(np.asarray, jparams)
        short["layers"]["mamba"]["conv"] = short["layers"]["mamba"][
            "conv"][:1]
        bridge.params_from_numpy(tcfg, short, "cpu")


def _layer(tree, layer):
    return {k: (_layer(v, layer) if isinstance(v, dict) else v[layer])
            for k, v in tree.items()}


@pytest.mark.parametrize("case", ["sequence", "continued", "decode"])
def test_mamba_block_matches_jax(env, case):
    """``mamba_block`` of layer 1 alone against the JAX one: a sequence
    from zeros (S = 128, 8 chunks), a sequence continued from a random
    conv buffer and SSM state, and one decoded token (the recurrent step):
    the output and the new conv / ssm state."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    rng = np.random.default_rng(7)
    S = 1 if case == "decode" else SEQ
    x = rng.standard_normal((Z, BSZ, S, tcfg.d_model)).astype(np.float32)
    inner, H, hs = TMB.mamba_dims(tcfg)
    state = None
    if case != "sequence":
        state = {"conv": rng.standard_normal(
                     (Z, BSZ, tcfg.ssm.conv_width - 1, inner)
                 ).astype(np.float32),
                 "ssm": 0.1 * rng.standard_normal(
                     (Z, BSZ, H, tcfg.ssm.state_size, hs)).astype(np.float32)}
    jp = _layer(jparams["layers"], 1)["mamba"]
    jl = {"in_proj": {m: jnp.asarray(v[1]) for m, v in lora["in_proj"].items()}}
    with JBK.backend("jnp"):
        jout, jst = jax.jit(lambda x_, s_: JMB.mamba_block(
            x_, jp, jl, jcfg, state=s_))(
                jnp.asarray(x), None if state is None else
                {k: jnp.asarray(v) for k, v in state.items()})
    tp = _layer(tparams["layers"], 1)["mamba"]
    tl = bridge.lora_from_numpy(lora, "cpu")
    with torch.no_grad():
        tout, tst = TMB.mamba_block(
            _t(x), tp, tl, 1, tcfg,
            state=None if state is None else {k: _t(v)
                                              for k, v in state.items()})
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **FWD_TOL)
    for k in ("conv", "ssm"):
        assert tst[k].dtype == torch.float32
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                   err_msg=k, **FWD_TOL)


def test_softplus_is_jax_form():
    x = torch.tensor([-50.0, -3.0, 0.0, 3.0, 19.0, 21.0, 60.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_allclose(TMB.softplus(x).numpy(), want, rtol=1e-6)


def _spy(monkeypatch):
    """Record the shapes the flash and the scan Functions are called on."""
    calls = {"flash": [], "scan": []}
    for key, fn in (("flash", TFAOPS._FlashAttention),
                    ("scan", TLSOPS._LinearScan)):
        real = fn.apply

        def spy(*args, _real=real, _key=key):
            calls[_key].append(tuple(args[0].shape))
            return _real(*args)
        monkeypatch.setattr(fn, "apply", spy)
    return calls


@pytest.mark.parametrize("backends", [("kernel", "pallas_interpret"),
                                      ("torch", "jnp")])
def test_forward_matches_jax(env, backends, monkeypatch):
    """Hidden states of the port's forward under "kernel" (the flash
    Function on [Z*b*H, S, hd] rows with the window of 64, and the scan
    Function on [Z*b*H_ssm, S, N] rows in SSD mode, each once per layer)
    and "torch" (the plain versions) against the JAX forward under its
    Pallas (interpret) and jnp backends."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    tb, jb = backends
    with JBK.backend(jb):
        want, _, _ = jax.jit(lambda p, l_, t: JM.forward(
            jcfg, p, l_, t, remat=False))(
                jparams, jax.tree_util.tree_map(jnp.asarray, lora),
                jnp.asarray(tokens))
    calls = _spy(monkeypatch)
    with TBK.backend(tb), torch.no_grad(), TLORA.slot_ranks(_t(RANKS)):
        got, aux, _ = TM.forward(tcfg, tparams,
                                 bridge.lora_from_numpy(lora, "cpu"),
                                 _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    assert float(aux) == 0.0
    _, H_ssm, _ = TMB.mamba_dims(tcfg)
    L, H, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    want_calls = ({"flash": [(Z * BSZ * H, SEQ, hd)] * L,
                   "scan": [(Z * BSZ * H_ssm, SEQ, tcfg.ssm.state_size)] * L}
                  if tb == "kernel" else {"flash": [], "scan": []})
    assert calls == want_calls


def test_single_stream_forward_hands_the_kernels_contiguous_rows(
        env, monkeypatch):
    """At Z = b = 1 the flattened [Z*b*H, S, d] rows are a strided view
    of the heads-minor layout; the forward must hand the flash and scan
    Functions contiguous rows (their CUDA wrappers refuse others), once
    per layer each, and agree with the "torch" backend."""
    _, tcfg, _, tparams, lora, tokens, _ = env
    one = {t: {m: x[:, :1] for m, x in ab.items()}
           for t, ab in bridge.lora_from_numpy(lora, "cpu").items()}
    seen = []
    for fn in (TFAOPS._FlashAttention, TLSOPS._LinearScan):
        real = fn.apply

        def spy(*args, _real=real):
            seen.append(all(a.is_contiguous() for a in args[:3]))
            return _real(*args)
        monkeypatch.setattr(fn, "apply", spy)
    out = {}
    with torch.no_grad(), TLORA.slot_ranks(_t(RANKS[:1])):
        for tb in ("kernel", "torch"):
            with TBK.backend(tb):
                out[tb], _, _ = TM.forward(tcfg, tparams, one,
                                           _t(tokens[:1, :1]))
    assert seen == [True] * (2 * tcfg.num_layers)
    np.testing.assert_allclose(out["kernel"].numpy(), out["torch"].numpy(),
                               **FWD_TOL)


def test_train_step_matches_jax(env, monkeypatch):
    """One make_train_step at mixed ranks (slot_ranks bound, the rank-local
    path): per-slot loss (1e-4), grad norm, every LoRA gradient (in_proj
    among them) and the updated adapters and first moments (2e-3) against
    the JAX step. Under remat the flash and scan Functions run twice per
    layer (the forward and its recompute) in each of the two gradient
    passes."""
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
    calls = _spy(monkeypatch)
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
    assert set(jgrads) == set(tgrads) and "in_proj" in tgrads
    for name, got, want in (("grad", tgrads, jgrads), ("lora", tl2, jl2),
                            ("mu", topt2.mu, jopt2.mu)):
        for t in want:
            for m in want[t]:
                np.testing.assert_allclose(
                    got[t][m].detach().numpy(), np.asarray(want[t][m]),
                    err_msg=f"{name} {t}.{m}", **GTOL)
    n = 2 * 2 * tcfg.num_layers
    assert len(calls["flash"]) == n and len(calls["scan"]) == n


def _flat_cache(cache):
    return dict(_leaves(cache["layers"]))


def _cache_close(tc, jc):
    got, want = _flat_cache(tc), _flat_cache(jc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FWD_TOL)
    for k in ("pos", "k_pos"):
        assert (k in tc) == (k in jc), k
        if k in jc:
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))


PROMPT, DECODES = 48, 24        # decode runs positions 48..71: past 64


@pytest.mark.parametrize("ring", [True, False])
def test_prefill_and_decode_over_hybrid_cache_match_jax(env, ring):
    """forward(cache=...) over a 48-token prompt (K/V written, the Mamba
    state continued from zeros), then 24 global-position decode steps
    (positions 48-71: a ring of 64 wraps and the window cuts): logits at
    every step and the whole cache (K/V, conv, ssm, pos, k_pos) against
    the JAX package."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    jc = JM.init_cache(jcfg, Z, BSZ, SEQ, ring=ring)
    tc = TM.init_cache(tcfg, Z, BSZ, SEQ, ring=ring, device="cpu")
    assert set(tc["layers"]) == {"attn", "mamba"}
    assert ("k_pos" in tc) == ring
    assert tc["layers"]["attn"]["k"].shape[3] == (64 if ring else SEQ)
    jpre = jax.jit(JSTEPS.make_prefill_step(jcfg))
    jdec = jax.jit(JSTEPS.make_serve_step(jcfg))
    with torch.no_grad():
        jlog, jc = jpre(jparams, jl, jc, {"tokens": jnp.asarray(
            tokens[:, :, :PROMPT])})
        tlog, tc = TSTEPS.make_prefill_step(tcfg)(
            tparams, tl, tc, {"tokens": _t(tokens[:, :, :PROMPT])})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
        _cache_close(tc, jc)
        for i in range(PROMPT, PROMPT + DECODES):
            jlog, jc = jdec(jparams, jl, jc, jnp.asarray(tokens[:, :, i]))
            tlog, tc = TSTEPS.make_serve_step(tcfg)(tparams, tl, tc,
                                                    _t(tokens[:, :, i]))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       err_msg=f"position {i}", **FWD_TOL)
        _cache_close(tc, jc)


def _lane_state(cache):
    """Every per-lane tensor of a per-lane cache, [Z, b] leading (layer
    leaves moved to put the lanes first)."""
    out = {k: v.transpose(0, 2).transpose(0, 1)
           for k, v in _flat_cache(cache).items()}          # [Z, b, L, ...]
    out["pos"] = cache["pos"]
    if "k_pos" in cache:
        out["k_pos"] = cache["k_pos"]
    return out


def test_per_lane_decode_and_reset_keep_idle_lanes(env):
    """Per-lane decode over a ring cache under ``active`` matches the JAX
    package on the live lanes and leaves the idle lanes' K/V, k_pos, conv,
    ssm and position bitwise untouched; ``reset_lanes`` zeroes exactly the
    masked lanes (ring slots back in the far past); a block lane prefill is
    refused (the family joins by streaming)."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    jc = JM.init_cache(jcfg, Z, BSZ, SEQ, ring=True, per_lane=True)
    tc = TM.init_cache(tcfg, Z, BSZ, SEQ, ring=True, per_lane=True,
                       device="cpu")
    active = np.array([[True, False], [True, True]])
    jdec = jax.jit(lambda c, t, a: JM.decode_step(jcfg, jparams, jl, c, t,
                                                  active=a))
    with torch.no_grad():
        for i in range(4):
            act = np.ones_like(active) if i == 0 else active
            jlog, jc = jdec(jc, jnp.asarray(tokens[:, :, i]),
                            jnp.asarray(act))
            before = {k: v.clone() for k, v in _lane_state(tc).items()}
            tlog, tc = TM.decode_step(tcfg, tparams, tl, tc,
                                      _t(tokens[:, :, i]), active=_t(act))
            np.testing.assert_allclose(tlog.numpy()[act],
                                       np.asarray(jlog)[act], **FWD_TOL)
            for k, v in _lane_state(tc).items():
                assert torch.equal(v[~_t(act)], before[k][~_t(act)]), k
        _cache_close(tc, jc)
        mask = _t(np.array([[False, True], [False, False]]))
        before = {k: v.clone() for k, v in _lane_state(tc).items()}
        tc = TM.reset_lanes(tcfg, tc, mask)
        after = _lane_state(tc)
        for k, v in after.items():
            assert torch.equal(v[~mask], before[k][~mask]), k
            if k != "k_pos":
                assert bool((v[mask] == 0).all()), k
        assert bool((after["k_pos"][mask] == TM.RING_INIT_POS).all())
        assert tc["pos"].tolist() == [[4, 0], [4, 4]]
        plain = TM.init_cache(tcfg, Z, BSZ, SEQ, per_lane=True, device="cpu")
        with pytest.raises(ValueError, match="attention cache"):
            TM.prefill_lanes(tcfg, tparams, tl, plain, _t(tokens[:, :, :4]),
                             mask)


# the hymba-1.5b cases of tests/test_arch_smoke.py, in the port
@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jget_arch(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tget_arch(ARCH).reduced(), dtype="float32")
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(key)
    jl = jax.jit(lambda k: JLORA.init_lora_tree(
        k, jcfg, 2, jnp.array([4, 8]), JM.target_shapes(jcfg)))(key)
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tl = bridge.lora_from_numpy(jax.tree_util.tree_map(np.asarray, jl),
                                "cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 2, 32)).astype(np.int32)
    return jcfg, tcfg, jparams, jl, tparams, tl, tokens


def test_arch_smoke_forward_and_train_step(smoke):
    """test_arch_smoke's forward (shapes, finite, the token count) and
    train step (finite loss, adapters moved, the rank mask kept) for
    hymba-1.5b in the port."""
    _, tcfg, _, _, tparams, tl, tokens = smoke
    tl = {t: {m: x.clone() for m, x in ab.items()}     # the step updates
          for t, ab in tl.items()}                      # in place
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


@pytest.mark.parametrize("ring", [False, True])
def test_arch_smoke_serve_and_ring_long_decode_match_jax(smoke, ring):
    """test_arch_smoke's serve step (a cache of 64, one step, pos 1) and
    ring_or_recurrent_long_decode (a ring of the window's size, four
    steps) for hymba-1.5b: logits against the JAX package's at every
    step."""
    jcfg, tcfg, jparams, jl, tparams, tl, tokens = smoke
    steps = 4 if ring else 1
    max_len = 128 if ring else 64
    jc = JM.init_cache(jcfg, 2, 2, max_len, ring=ring)
    tc = TM.init_cache(tcfg, 2, 2, max_len, ring=ring, device="cpu")
    jserve = jax.jit(JSTEPS.make_serve_step(jcfg))
    serve = TSTEPS.make_serve_step(tcfg)
    with torch.no_grad():
        for t in range(steps):
            jlog, jc = jserve(jparams, jl, jc, jnp.asarray(tokens[:, :, t]))
            tlog, tc = serve(tparams, tl, tc, _t(tokens[:, :, t]))
            assert tlog.shape == (2, 2, tcfg.vocab_size)
            assert bool(torch.isfinite(tlog).all())
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **FWD_TOL)
    assert int(tc["pos"]) == steps
    if ring:
        assert tc["layers"]["attn"]["k"].shape[3] == tcfg.sliding_window


# ---------------------------------------------------------------------------
# (b) inside the port: executor contracts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    _, cfg = _cfgs(num_layers=2, d_model=64, vocab=128)
    params = TM.init_params(cfg, seed=0, device="cpu")
    ds = [TSYN.make_task_dataset(f"task-{i}", cfg.vocab_size, seq_len=EX_SEQ,
                                 num_train=32, num_val=8,
                                 difficulty=0.2 + 0.4 * i, seed=1 + i)
          for i in range(2)]
    return cfg, params, ds


def _hists(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def test_colocated_hymba_task_bitwise_equal_solo(small):
    """Two hymba tasks at different true ranks (2/4 and 3/5 of r_max 8)
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

    for m in (TLSK, TFAK, TRL):
        m.reset_launches()
    fused, fused_h = run(specs)
    solo_a, solo_a_h = run(specs[:1])
    solo_b, solo_b_h = run(specs[1:])
    assert fused_h["A"] == solo_a_h["A"] and fused_h["B"] == solo_b_h["B"]
    assert fused["A"].best_val == solo_a["A"].best_val
    assert fused["B"].best_val == solo_b["B"].best_val
    assert np.isfinite(fused["A"].best_val)
    assert TLSK.LAUNCHES == {"linear_scan": 0}
    assert TFAK.LAUNCHES == {"flash_attention": 0}
    assert set(TRL.LAUNCHES.values()) == {0}


def test_hymba_kill_and_recover_bitwise(small, tmp_path):
    """A hymba task (4 jobs on 2 slots, mixed ranks and widths) crashed
    after its third durable checkpoint and resumed on a fresh executor
    ends bitwise equal to the uninterrupted run, in fewer steps; one AdamW
    moment of the winner's in_proj perturbed in the file changes the loss
    histories after the resume."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=b)
            for r, b in ((2, 2), (8, 1)) for lr in (1e-3, 3e-3)}

    def make(counter=None):
        bx = BatchedExecutor(cfg, params, ds[0], Z=2, per_adapter_batch=2,
                             ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                    select_ratio=0.5),
                             eval_every=2, seq_cap=EX_SEQ, device="cpu")
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
    res0 = bx0.run_task("hymba", jobs, 8)
    mon0 = _hists(seen["lc"])
    ck = TTS.TaskCheckpointer(str(tmp_path / "state"), every=1)
    ck.fail_after["*"] = 3
    bx1 = make()
    bx1.ckpt_hook = ck.on_chunk
    with pytest.raises(TTS.SimulatedCrash):
        bx1.run_task("hymba", jobs, 8)
    state = TTS.load_task_checkpoint(ck.latest("hymba"))
    assert state is not None and state[1]["chunk"] == 3
    steps1 = []
    bx2 = make(steps1)
    bx2.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res1 = _drain(bx2.resume_task_chunks("hymba", jobs, 8, state,
                                         start_chunk=3))
    assert _hists(seen["lc"]) == mon0 and _same_result(res1, res0)
    assert 0 < len(steps1) < len(steps0)
    tree, meta = TTS.load_task_checkpoint(ck.latest("hymba"))
    assert res0.best_job in tree["snap"]
    tree["snap"][res0.best_job]["mu"]["in_proj"]["A"].reshape(-1)[0] += 1e-3
    bx3 = make()
    bx3.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res2 = _drain(bx3.resume_task_chunks("hymba", jobs, 8, (tree, meta),
                                         start_chunk=3))
    assert _hists(seen["lc"]) != mon0 and res2.best_job in jobs


def test_hymba_rank_sweep_through_run_task(small):
    """8 jobs (ranks 2/3/4/6 x two learning rates) on 4 slots of the
    reduced hymba-1.5b at S = 32 (EX_SEQ): warmup, selection and continue, a
    TaskResult with finite losses — the chip smoke's hymba rank sweep at a
    reduced size."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=2)
            for r in (2, 3, 4, 6) for lr in (1e-3, 1e-2)}
    bx = BatchedExecutor(cfg, params, ds[0], Z=4, per_adapter_batch=2,
                         ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.25),
                         eval_every=2, device="cpu")
    result = bx.run_task("hymba-sweep", jobs, total_steps=8)
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

    @jax.jit
    def adapters_of(k):
        lt = JLORA.init_lora_tree(k, jcfg, 3, ranks, JM.target_shapes(jcfg))
        lt = jax.tree_util.tree_map(
            lambda x: x + 0.05 * jax.random.normal(k, x.shape), lt)
        return JLORA.mask_lora_tree(lt, ranks, jcfg.lora.r_max)

    lt = adapters_of(key)
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
def test_hymba_greedy_streams_match_jax_and_joins_keep_lanes(serve_env,
                                                             mode):
    """Three requests per adapter over two lanes, ring caches: the port's
    greedy streams equal the JAX replica's; every lane reset (a join) and
    every decode under ``active`` leaves the lanes it does not own bitwise
    untouched (K/V, k_pos, conv, ssm); block prefill is off for the
    family, and neither the flash nor the scan Function runs (prompts
    stream through the decode step)."""
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
    assert rep.ring and not rep._block_prefill
    checked = {"reset": 0, "decode": 0}

    def guarded(fn, kind, mask_at):
        def run(*args):
            cache, mask = args[2 if kind == "decode" else 0], args[mask_at]
            before = {k: v.clone() for k, v in _lane_state(cache).items()}
            out = fn(*args)
            after = out[-1] if kind == "decode" else out
            keep = ~mask
            for k, v in _lane_state(after).items():
                assert torch.equal(v[keep], before[k][keep]), k
            checked[kind] += 1
            return out
        return run

    rep._reset_lanes = guarded(rep._reset_lanes, "reset", 1)
    rep._decode_lanes = guarded(rep._decode_lanes, "decode", 4)
    calls = {"flash": [], "scan": []}
    reals = (TFAOPS._FlashAttention.apply, TLSOPS._LinearScan.apply)
    TFAOPS._FlashAttention.apply = (
        lambda *a: calls["flash"].append(1) or reals[0](*a))
    TLSOPS._LinearScan.apply = (
        lambda *a: calls["scan"].append(1) or reals[1](*a))
    try:
        tout = _submit(ServingFrontend(rep, mode=mode), prompts)
    finally:
        TFAOPS._FlashAttention.apply, TLSOPS._LinearScan.apply = reals
    assert len(tout) == 9 and all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout
    assert calls == {"flash": [], "scan": []}
    if mode == "continuous":
        assert checked["reset"] > 0 and checked["decode"] > 0
