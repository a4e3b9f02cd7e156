"""PyTorch port: the MoE family (``granite-moe-1b-a400m`` and
``llama4-scout-17b-a16e``) held against the JAX package, and its bitwise
contracts inside the port.

(a) ``moe_block`` alone, on the reduced configs' expert shapes (E 4,
    d 256) with weights initialized by the JAX package and carried over by
    ``repro_torch.bridge``, inputs from numpy seeds: the routing
    (``expert_idx`` and ``keep``, read from inside the JAX function) must
    be identical, and the output, ``aux`` and the gradient with respect to
    x agree at the JAX package's backend bars (forward 5e-4, gradients
    2e-3; tests/test_kernel_backends.py) in float32, and within four bf16
    roundings of the largest value (2^-5 of it) in bf16. Five cases:
    lossless (T <= 64), capacity-bound (T 128, cap 80), heavy drop
    (capacity factor 0.5), top-1 with a shared expert, and bf16. Then the
    reference's co-tenant dependence: under capacity pressure a slot's
    output depends on the other slots' tokens (the token groups span
    slots), equally in both packages; without drops it does not.
(b) Model level, reduced float32 granite-moe and llama4 (2 layers, d 256,
    E 4) at Z 2, b 2, S 32 (T 128: the capacity binds): the registry's
    configs, target shapes (attention only) and parameter keys; the
    forward's hidden states and summed ``aux``; the SFT total with the
    router term; three train steps; block prefill over a per-lane cache
    (every lane's rows compete for capacity) and per-lane decode.
(c) Inside the port: a reduced granite rank sweep through
    ``BatchedExecutor.run_task``; a task crashed after a durable checkpoint
    and resumed on a fresh executor (the same slot layout) equals the
    uninterrupted run bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.registry import get_arch as jget_arch
from repro.core import lora as JLORA
from repro.core import steps as JSTEPS
from repro.core.losses import sft_loss as jsft_loss
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.optim import adamw as JAD
from repro_torch import bridge
from repro_torch.checkpoint import taskstate as TTS
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.core import early_exit as TEE
from repro_torch.core import lora as TLORA
from repro_torch.core import steps as TSTEPS
from repro_torch.core.executor import BatchedExecutor, TaskResult
from repro_torch.core.losses import sft_loss as tsft_loss
from repro_torch.data import synthetic as TSYN
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as TAD
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401
from tests.test_torch_model import _cache_close, _clone, _lanes_equal
from tests.test_torch_recovery import _drain, _same_result

FWD_TOL = dict(rtol=5e-4, atol=5e-4)
GTOL = dict(rtol=2e-3, atol=2e-3)
LOSS_RTOL = 1e-4
BF16_REL = 2 ** -5              # four bf16 roundings of the largest value
Z, BSZ, SEQ = 2, 2, 32          # T 128: one group of 128, cap 80 (granite)
RANKS = [3, 6]
ARCHS = ("granite-moe-1b-a400m", "llama4-scout-17b-a16e")
EX_SEQ = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class _Over:
    """A module with some attributes replaced (the rest read through)."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def _jax_moe(x, params, moe, monkeypatch):
    """The JAX package's ``moe_block`` run eagerly, with its routing read
    from inside: ``expert_idx`` from its ``lax.top_k`` and ``keep`` from
    its one ``jnp.where``. Returns (out, aux, expert_idx, keep)."""
    seen = {}

    def top_k(p, k):
        v, i = jax.lax.top_k(p, k)
        seen["idx"] = np.asarray(i)
        return v, i

    def where(c, a, b):
        seen["keep"] = np.asarray(c)
        return jnp.where(c, a, b)

    with monkeypatch.context() as m:
        m.setattr(JMOE, "jax", _Over(jax, lax=_Over(jax.lax, top_k=top_k)))
        m.setattr(JMOE, "jnp", _Over(jnp, where=where))
        out, aux = JMOE.moe_block(x, params, moe)
    return out, aux, seen["idx"], seen["keep"]


def _torch_moe(x, params, moe, monkeypatch):
    """The port's ``moe_block`` with its routing read through
    ``moe.route``. Returns (out, aux, expert_idx, keep)."""
    seen = {}
    real = TMOE.route

    def tapped(*args):
        out = real(*args)
        seen["idx"], seen["keep"] = out[1].numpy(), out[3].numpy()
        return out
    with monkeypatch.context() as m:
        m.setattr(TMOE, "route", tapped)
        out, aux = TMOE.moe_block(x, params, moe)
    return out, aux, seen["idx"], seen["keep"]


def _moe_setup(moe_kw, shape, dtype=jnp.float32, d=256, seed=0, tilt=1.0):
    """Both packages' MoEConfig and weights (JAX init, bridged) and an
    input: N(0, 1) tokens plus ``tilt`` times one N(0, 1) offset shared by
    all of them, which tilts the router toward some experts so that
    capacity binds."""
    jm = JMoEConfig(**moe_kw)
    tm = TMoEConfig(**moe_kw)
    jp = JMOE.init_moe_params(jax.random.PRNGKey(seed), d, jm, dtype)
    tp = bridge.lora_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                "cpu")
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*shape, d))
         + tilt * rng.standard_normal(d)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    return jm, tm, jp, tp, jx, bridge.tensor_from_numpy(np.asarray(jx), "cpu")


GRANITE_MOE = dict(num_experts=4, top_k=2, d_ff_expert=256,
                   capacity_factor=1.25)
LLAMA4_MOE = dict(num_experts=4, top_k=1, d_ff_expert=256,
                  num_shared_experts=1, d_ff_shared=256, capacity_factor=1.5)
MOE_CASES = {   # name: (MoEConfig fields, [Z, b, S], dtype, dropped share)
    "lossless": (GRANITE_MOE, (2, 2, 16), jnp.float32, (0.0, 0.0)),
    "capacity": (GRANITE_MOE, (2, 2, 32), jnp.float32, (0.01, 0.3)),
    "heavy_drop": (dict(GRANITE_MOE, capacity_factor=0.5), (2, 2, 32),
                   jnp.float32, (0.4, 0.8)),
    "top1_shared": (LLAMA4_MOE, (2, 2, 32), jnp.float32, (0.01, 0.5)),
    "bf16": (GRANITE_MOE, (2, 2, 32), jnp.bfloat16, (0.01, 0.3)),
}


# ---------------------------------------------------------------------------
# (a) moe_block against the JAX package
# ---------------------------------------------------------------------------

def test_pick_group_size_and_capacity_equal_reference():
    for T in [*range(1, 300), 384, 512, 1000, 1024, 4096, 6144, 8192, 12288,
              16384, 65536, 3 * 4096, 7 * 128, 5 * 4096 + 64]:
        s = JMOE.pick_group_size(T)
        assert TMOE.pick_group_size(T) == s, T
        assert T % s == 0
    # the reference's capacity expression, through the port's helper
    for cf, k, E in ((1.25, 8, 32), (1.5, 1, 16), (0.5, 2, 4)):
        moe = TMoEConfig(num_experts=E, top_k=k, d_ff_expert=8,
                         capacity_factor=cf)
        for s in (16, 64, 128, 4096):
            want = s * k if s <= 64 else max(int(cf * s * k / E), 1)
            assert TMOE.capacity(moe, s) == want
    granite = TREG.get_arch("granite-moe-1b-a400m").moe
    assert TMOE.capacity(granite, TMOE.pick_group_size(4 * 4 * 256)) == 1280


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_block_matches_jax(case, monkeypatch):
    """Routing identical; out, aux and dL/dx within the bars."""
    moe_kw, shape, dtype, (lo, hi) = MOE_CASES[case]
    jm, tm, jp, tp, jx, tx = _moe_setup(moe_kw, shape, dtype)
    jout, jaux, jidx, jkeep = _jax_moe(jx, jp, jm, monkeypatch)
    tx.requires_grad_(True)
    tout, taux, tidx, tkeep = _torch_moe(tx, tp, tm, monkeypatch)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tkeep, jkeep)
    dropped = 1.0 - float(jkeep.mean())
    assert lo <= dropped <= hi, dropped
    assert tout.dtype == tx.dtype and taux.dtype == torch.float32
    rng = np.random.default_rng(7)
    g = rng.standard_normal(tout.shape).astype(np.float32)
    jg = jnp.asarray(g, dtype)
    _, vjp = jax.vjp(lambda x: JMOE.moe_block(x, jp, jm), jx)
    (jdx,) = vjp((jg, jnp.float32(0.7)))
    (tdx,) = torch.autograd.grad(
        (tout, taux), tx,
        (bridge.tensor_from_numpy(np.asarray(jg), "cpu"), torch.tensor(0.7)))
    if dtype == jnp.float32:
        fwd, grad = FWD_TOL, GTOL
    else:
        fwd = dict(rtol=0, atol=BF16_REL * np.abs(_np(jout)).max())
        grad = dict(rtol=0, atol=BF16_REL * np.abs(_np(jdx)).max())
    np.testing.assert_allclose(_np(tout), _np(jout), **fwd)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), **FWD_TOL)
    np.testing.assert_allclose(_np(tdx), _np(jdx), **grad)


def test_moe_backward_is_deterministic():
    """Two backward passes of the same block give the same dL/dx bit for
    bit (dispatch and combine accumulate nothing in a data-dependent
    order)."""
    _, tm, _, tp, _, tx = _moe_setup(dict(GRANITE_MOE, capacity_factor=0.5),
                                     (2, 2, 32))
    g = torch.randn((2, 2, 32, 256), generator=torch.Generator().manual_seed(
        1))
    grads = []
    for _ in range(2):
        x = tx.clone().requires_grad_(True)
        out, aux = TMOE.moe_block(x, tp, tm)
        grads.append(torch.autograd.grad((out, aux), x,
                                         (g, torch.tensor(1.0)))[0])
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("cf,tilt", [(0.5, 1.0), (1.25, 0.0)])
def test_co_tenant_dependence_equals_reference(cf, tilt, monkeypatch):
    """E 4, top-2, Z 2, b 2, S 64: one group of 256 tokens holds both
    slots. At capacity factor 0.5 slot 1's output moves when slot 0's
    tokens change, and differs from slot 1 run alone (Z 1: its own group
    of 128) — equally in both packages, which is the reference's
    behaviour the port keeps. At 1.25, with untilted tokens, nothing is
    dropped and slot 1's output is its own in both."""
    moe_kw = dict(GRANITE_MOE, capacity_factor=cf)
    jm, tm, jp, tp, jx, tx = _moe_setup(moe_kw, (2, 2, 64), tilt=tilt)
    other = np.random.default_rng(3).standard_normal(
        (2, 64, 256)).astype(np.float32)
    jx2 = jx.at[0].set(jnp.asarray(other))
    tx2 = tx.clone()
    tx2[0] = _t(other)
    runs = {}
    with torch.no_grad():
        for name, jin, tin in (("co-located", jx, tx),
                               ("slot 0 changed", jx2, tx2),
                               ("alone", jx[1:], tx[1:])):
            jout, _, _, jkeep = _jax_moe(jin, jp, jm, monkeypatch)
            tout, _, _, tkeep = _torch_moe(tin, tp, tm, monkeypatch)
            np.testing.assert_array_equal(tkeep, jkeep)
            jz, tz = _np(jout)[-1], _np(tout)[-1]
            np.testing.assert_allclose(tz, jz, **FWD_TOL, err_msg=name)
            runs[name] = (jz, tz, 1.0 - float(jkeep.mean()))
    co = runs["co-located"]
    for name in ("slot 0 changed", "alone"):
        j_gap = np.abs(runs[name][0] - co[0]).max()
        t_gap = np.abs(runs[name][1] - co[1]).max()
        print(f"capacity factor {cf}: slot 1 co-located vs {name}: max "
              f"|diff| {t_gap:.6g} (JAX {j_gap:.6g}); dropped share "
              f"{co[2]:.4f} co-located, {runs[name][2]:.4f} {name}")
        if cf < 1.0:
            assert co[2] > 0.3 and j_gap > 0.1 and t_gap > 0.1, name
            np.testing.assert_allclose(t_gap, j_gap, rtol=1e-3)
        else:
            assert co[2] == 0.0 and runs[name][2] == 0.0
            assert j_gap < 1e-5 and t_gap < 1e-5, name


# ---------------------------------------------------------------------------
# (b) model level against the JAX package
# ---------------------------------------------------------------------------

def test_registry_configs_equal_jax_field_by_field():
    for arch in ARCHS:
        assert arch in TREG.ASSIGNED and arch in TREG.list_archs()
        tcfg, jcfg = TREG.get_arch(arch), jget_arch(arch)
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    g = TREG.get_arch("granite-moe-1b-a400m")
    assert (g.num_layers, g.d_model, g.moe.num_experts, g.moe.top_k,
            g.vocab_size, g.tie_embeddings) == (24, 1024, 32, 8, 49155, True)
    s = TREG.get_arch("llama4-scout-17b-a16e")
    assert (s.d_model, s.head_dim, s.moe.num_experts, s.moe.top_k,
            s.moe.num_shared_experts, s.vocab_size, s.tie_embeddings) == (
                5120, 128, 16, 1, 1, 202048, False)


def _cfgs(arch, **kw):
    jcfg = reduced_f32(arch, **kw)
    tcfg = dataclasses.replace(TREG.get_arch(arch).reduced(**kw),
                               dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _random_lora(shapes, L, r, rng):
    mask = (np.arange(r)[None, :] < np.asarray(RANKS)[:, None]).astype(
        np.float32)
    return {t: {"A": (rng.standard_normal((L, Z, din, r), np.float32)
                      / din ** 0.5 * mask[None, :, None, :]),
                "B": (rng.standard_normal((L, Z, r, dout), np.float32)
                      * 0.05 * mask[None, :, :, None])}
            for t, (din, dout) in shapes.items()}


@pytest.fixture(scope="module", params=ARCHS)
def env(request):
    jcfg, tcfg = _cfgs(request.param)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    lora = _random_lora(JM.target_shapes(jcfg), tcfg.num_layers,
                        tcfg.lora.r_max, rng)
    tokens = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, lora, tokens, labels


def test_target_shapes_and_params_match_jax(env):
    jcfg, tcfg, jparams, tparams, *_ = env
    assert TM.target_shapes(tcfg) == JM.target_shapes(jcfg)
    assert set(TM.target_shapes(tcfg)) == {"q_proj", "k_proj", "v_proj",
                                           "o_proj"}
    own = dict(_leaves(TM.init_params(tcfg, seed=0, device="cpu")))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jparams)))
    bridged = dict(_leaves(tparams))
    assert set(own) == set(bridged) == set(want)
    assert "layers.moe.router" in own and "layers.mlp_norm" in own
    assert ("layers.moe.shared.down" in own) == bool(
        tcfg.moe.num_shared_experts)
    for k, v in want.items():
        assert tuple(own[k].shape) == v.shape, k
        assert own[k].dtype == bridged[k].dtype, k
    assert own["layers.moe.router"].dtype == torch.float32
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["layers"]["moe"]["w_up"] = bad["layers"]["moe"]["w_up"][:, :, :, :8]
    with pytest.raises(ValueError, match="moe weights"):
        bridge.params_from_numpy(tcfg, bad, "cpu")


def test_forward_aux_and_sft_total_match_jax(env):
    """Hidden states and the summed aux of the forward (T 128: capacity
    binds), and the SFT total with ``router_aux_weight · aux``."""
    jcfg, tcfg, jparams, tparams, lora, tokens, labels = env
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    active = np.array([1, 0], np.int32)
    jh, jaux, _ = jax.jit(lambda p, l_, t: JM.forward(
        jcfg, p, l_, t, remat=False))(jparams, jl, jnp.asarray(tokens))
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    with JLORA.slot_ranks(jnp.asarray(RANKS, jnp.int32)):
        jtot, jper = jsft_loss(jcfg, jparams, jl, jbatch,
                               jnp.asarray(active))
    with torch.no_grad(), TLORA.slot_ranks(_t(RANKS)):
        th, taux, _ = TM.forward(tcfg, tparams, tl, _t(tokens))
        ttot, tper = tsft_loss(tcfg, tparams, tl, {
            "tokens": _t(tokens), "labels": _t(labels)}, _t(active))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FWD_TOL)
    assert float(taux) > 0.5 * tcfg.num_layers
    np.testing.assert_allclose(float(taux), float(jaux), rtol=LOSS_RTOL)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=LOSS_RTOL)
    # the router term is in the total, unmasked: slot 1 is inactive
    np.testing.assert_allclose(
        float(ttot), float(tper[0]) + tcfg.moe.router_aux_weight * float(taux),
        rtol=1e-6)


def test_three_train_steps_match_jax(env):
    """Three make_train_step calls at mixed ranks (the rank-local path):
    per-slot loss each step (1e-4), grad norms, and the adapters and first
    moments after the third step (2e-3) against the JAX steps; the loss
    the gradients come from includes the router term."""
    jcfg, tcfg, jparams, tparams, lora, tokens, labels = env
    ranks, active = np.asarray(RANKS, np.int32), np.ones(Z, np.int32)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    jopt = JAD.init_state(jl, Z)
    jhp = JAD.SlotHParams.broadcast(Z, lr=3e-3)
    jstep = jax.jit(JSTEPS.make_train_step(jcfg))
    tl = bridge.lora_from_numpy(lora, "cpu")
    topt = TAD.init_state(tl, Z)
    thp = TAD.SlotHParams.broadcast(Z, lr=3e-3, device="cpu")
    tstep = TSTEPS.make_train_step(tcfg)
    rng = np.random.default_rng(4)
    for i in range(3):
        tok = tokens if i == 0 else rng.integers(
            0, jcfg.vocab_size, tokens.shape).astype(np.int32)
        batch = {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jb["slot_ranks"] = jnp.asarray(ranks)
        jl, jopt, jm = jstep(jparams, jl, jopt, jhp, jnp.asarray(active),
                             jnp.asarray(ranks), jb)
        tb = {k: _t(v) for k, v in batch.items()}
        tb["slot_ranks"] = _t(ranks)
        tl, topt, tm = tstep(tparams, tl, topt, thp, _t(active), _t(ranks),
                             tb)
        np.testing.assert_allclose(tm["per_slot_loss"].numpy(),
                                   np.asarray(jm["per_slot_loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]),
                                   err_msg=f"step {i}", **GTOL)
    for name, got, want in (("lora", tl, jl), ("mu", topt.mu, jopt.mu)):
        for t in want:
            for m in want[t]:
                np.testing.assert_allclose(
                    got[t][m].detach().numpy(), np.asarray(want[t][m]),
                    err_msg=f"{name} {t}.{m}", **GTOL)


def _jit_ranked(fn, cfg):
    def f(ranks, *args):
        with JLORA.slot_ranks(ranks):
            return fn(cfg, *args)
    return jax.jit(f)


def test_prefill_lanes_and_decode_match_jax(env):
    """A per-lane cache: block-prefill lanes at P 32 (T 128: every lane's
    rows, joining or not, compete for capacity, as in the reference),
    decode four steps with one lane idle for one (T 4: lossless), then
    join the other lanes. Logits and the whole cache match the JAX
    package; lanes a call does not own stay bitwise untouched."""
    jcfg, tcfg, jparams, tparams, lora, tokens, _ = env
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    ranks = np.asarray(RANKS, np.int32)
    P, max_len = SEQ, SEQ + 8
    jc = JM.init_cache(jcfg, Z, BSZ, max_len, per_lane=True)
    tc = TM.init_cache(tcfg, Z, BSZ, max_len, per_lane=True, device="cpu")
    masks = [np.array([[1, 0], [1, 1]], bool), np.array([[0, 1], [0, 0]],
                                                        bool)]
    plens = [np.array([[32, 1], [20, 9]], np.int32),
             np.array([[1, 17], [1, 1]], np.int32)]
    jpre = _jit_ranked(JM.prefill_lanes, jcfg)
    jdec = _jit_ranked(JM.decode_step, jcfg)
    rng = np.random.default_rng(5)
    active = np.zeros((Z, BSZ), bool)
    for join in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (Z, BSZ, P))
        jlog, jc = jpre(jnp.asarray(ranks), jparams, jl, jc,
                        jnp.asarray(toks), jnp.asarray(masks[join]),
                        jnp.asarray(plens[join]))
        before = _clone(tc)
        with torch.inference_mode(), TLORA.slot_ranks(_t(ranks)):
            tlog, tc = TM.prefill_lanes(tcfg, tparams, tl, tc, _t(toks),
                                        _t(masks[join]), _t(plens[join]))
        _lanes_equal(tc, before, masks[join])
        m = masks[join]
        np.testing.assert_allclose(tlog[_t(m)].numpy(), np.asarray(jlog)[m],
                                   **FWD_TOL)
        _cache_close(tc, jc)
        active |= m
        for step in range(4):
            act = active.copy()
            act[0, 0] &= step != 1
            cur = rng.integers(0, jcfg.vocab_size, (Z, BSZ))
            jlog, jc = jdec(jnp.asarray(ranks), jparams, jl, jc,
                            jnp.asarray(cur), jnp.asarray(act))
            before = _clone(tc)
            with torch.inference_mode(), TLORA.slot_ranks(_t(ranks)):
                tlog, tc = TM.decode_step(tcfg, tparams, tl, tc, _t(cur),
                                          active=_t(act))
            _lanes_equal(tc, before, act)
            np.testing.assert_allclose(tlog[_t(act)].numpy(),
                                       np.asarray(jlog)[act], **FWD_TOL)
            _cache_close(tc, jc)


# ---------------------------------------------------------------------------
# (c) inside the port: the executor
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    _, cfg = _cfgs("granite-moe-1b-a400m", num_layers=2, d_model=64,
                   vocab=128)
    params = TM.init_params(cfg, seed=0, device="cpu")
    ds = TSYN.make_task_dataset("moe-task", cfg.vocab_size, seq_len=EX_SEQ,
                                num_train=32, num_val=8, difficulty=0.3,
                                seed=1)
    return cfg, params, ds


def _hists(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def test_moe_rank_sweep_through_run_task(small):
    """8 jobs (ranks 2/3/4/6 x two learning rates) on 4 slots of the
    reduced granite-moe at S 32 (one group of 256 tokens over the four
    slots, cap 160): warmup, selection and continue, a TaskResult with
    finite losses and attention-only adapters — the chip smoke's granite
    rank sweep at a reduced size."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=2)
            for r in (2, 3, 4, 6) for lr in (1e-3, 1e-2)}
    bx = BatchedExecutor(cfg, params, ds, Z=4, per_adapter_batch=2,
                         ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.25),
                         eval_every=2, device="cpu")
    result = bx.run_task("moe-sweep", jobs, total_steps=8)
    assert isinstance(result, TaskResult) and result.best_job in jobs
    assert sum(result.exit_counts.values()) == 8
    assert all(np.isfinite(r.best_val) for r in result.job_results.values()
               if r.exit_reason is None or r.exit_reason.value != "diverging")
    winner = result.job_results[result.best_job].adapter
    assert set(winner) == {"q_proj", "k_proj", "v_proj", "o_proj"}


def test_moe_kill_and_recover_bitwise(small, tmp_path):
    """A granite-moe task (4 jobs on 2 slots, mixed ranks and widths)
    crashed after its third durable checkpoint and resumed on a fresh
    executor ends bitwise equal to the uninterrupted run, in fewer steps:
    the resume restores each job to its slot, so every token group holds
    the same co-tenants. One AdamW moment of the winner perturbed in the
    file changes the loss histories after the resume."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=b)
            for r, b in ((2, 2), (8, 1)) for lr in (1e-3, 3e-3)}

    def make(counter=None):
        bx = BatchedExecutor(cfg, params, ds, Z=2, per_adapter_batch=2,
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
    res0 = bx0.run_task("moe", jobs, 8)
    mon0 = _hists(seen["lc"])
    ck = TTS.TaskCheckpointer(str(tmp_path / "state"), every=1)
    ck.fail_after["*"] = 3
    bx1 = make()
    bx1.ckpt_hook = ck.on_chunk
    with pytest.raises(TTS.SimulatedCrash):
        bx1.run_task("moe", jobs, 8)
    state = TTS.load_task_checkpoint(ck.latest("moe"))
    assert state is not None and state[1]["chunk"] == 3
    steps1 = []
    bx2 = make(steps1)
    bx2.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res1 = _drain(bx2.resume_task_chunks("moe", jobs, 8, state,
                                         start_chunk=3))
    assert _hists(seen["lc"]) == mon0 and _same_result(res1, res0)
    assert 0 < len(steps1) < len(steps0)
    tree, meta = TTS.load_task_checkpoint(ck.latest("moe"))
    assert res0.best_job in tree["snap"]
    tree["snap"][res0.best_job]["mu"]["q_proj"]["A"].reshape(-1)[0] += 1e-3
    bx3 = make()
    bx3.ckpt_hook = lambda lc, i: seen.update(lc=lc)
    res2 = _drain(bx3.resume_task_chunks("moe", jobs, 8, (tree, meta),
                                         start_chunk=3))
    assert _hists(seen["lc"]) != mon0 and res2.best_job in jobs
