"""PyTorch port: the dense model (forward with cache, per-lane prefill and
decode, ring cache) held against the JAX package on
``reduced("stablelm-3b")`` in float32 with bridged weights.

Both packages get the same weights (initialized by the JAX package, carried
over by ``repro_torch.bridge``) and the same tokens (numpy seed). Tolerance:
float32 rtol/atol 5e-4, the JAX package's own forward bar
(tests/test_kernel_backends.py). Inside the port, lanes a call does not own
must stay bitwise untouched.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as JLORA
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import lora as TLORA
from repro_torch.models import model as TM
from tests.conftest import reduced_f32

TOL = dict(rtol=5e-4, atol=5e-4)
RANKS = [4, 8, 0]               # an empty slot, full r_max and a partial


@pytest.fixture(scope="module")
def env():
    jcfg = reduced_f32("stablelm-3b", d_model=128, vocab=256)
    tcfg = dataclasses.replace(
        tget_arch("stablelm-3b").reduced(d_model=128, vocab=256),
        dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(key)
    Z = len(RANKS)
    ranks = jnp.asarray(RANKS, jnp.int32)

    @jax.jit
    def init_lora(k):
        lt = JLORA.init_lora_tree(k, jcfg, Z, ranks, JM.target_shapes(jcfg))
        lt = jax.tree_util.tree_map(   # nonzero B: every delta is live
            lambda x: x + 0.05 * jax.random.normal(k, x.shape), lt)
        return JLORA.mask_lora_tree(lt, ranks, jcfg.lora.r_max)

    jlora = init_lora(key)
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tlora = bridge.lora_from_numpy(
        jax.tree_util.tree_map(np.asarray, jlora), "cpu")
    return jcfg, tcfg, jparams, jlora, tparams, tlora


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit_ranked(fn, cfg, **kw):
    """The JAX step under jit with ``ranks`` bound while tracing (as the
    JAX serving replica runs it); compiled once per shape."""
    def f(ranks, *args):
        with JLORA.slot_ranks(ranks):
            return fn(cfg, *args, **kw)
    return jax.jit(f)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def _cache_close(tc, jc):
    for m in ("k", "v"):
        _close(tc["layers"]["attn"][m], jc["layers"]["attn"][m])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if "k_pos" in jc:
        np.testing.assert_array_equal(tc["k_pos"].numpy(),
                                      np.asarray(jc["k_pos"]))


def _clone(cache):
    return {"layers": {"attn": {m: x.clone() for m, x in
                                cache["layers"]["attn"].items()}},
            **{k: v.clone() for k, v in cache.items() if k != "layers"}}


def _lanes_equal(a, b, mask):
    """Cache lanes where ``mask`` is False are bitwise equal."""
    keep = ~torch.as_tensor(mask)
    for m in ("k", "v"):
        assert torch.equal(a["layers"]["attn"][m][:, keep],
                           b["layers"]["attn"][m][:, keep])


def test_bridge_round_trips_bf16_bits():
    x = jax.random.normal(jax.random.PRNGKey(3), (4, 5)).astype(jnp.bfloat16)
    t = bridge.tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    back = bridge.tensor_to_numpy(t)
    np.testing.assert_array_equal(back, np.asarray(x).view(np.uint16))
    np.testing.assert_array_equal(
        bridge.tensor_from_numpy(back, "cpu").float().numpy(),
        np.asarray(x.astype(jnp.float32)))


@pytest.mark.parametrize("bind_ranks", [False, True])
def test_forward_with_cache_and_global_decode_match(env, bind_ranks):
    """Prefill through ``forward(cache=...)`` then two global-position
    decode steps (the round-mode path)."""
    jcfg, tcfg, jp, jl, tp, tl = env
    Z, b, S, max_len = len(RANKS), 2, 6, 12
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (Z, b, S))
    ranks = np.asarray(RANKS, np.int32)
    r_j = jnp.asarray(ranks) if bind_ranks else None
    r_t = _t(ranks) if bind_ranks else None
    jc = JM.init_cache(jcfg, Z, b, max_len)
    tc = TM.init_cache(tcfg, Z, b, max_len, device="cpu")
    jfwd = _jit_ranked(lambda c, p, l, t, cache: JM.forward(
        c, p, l, t, cache=cache, remat=False), jcfg)
    jdec = _jit_ranked(JM.decode_step, jcfg)
    jh, _, jc = jfwd(r_j, jp, jl, jnp.asarray(toks), jc)
    with torch.inference_mode(), TLORA.slot_ranks(r_t):
        th, _, tc = TM.forward(tcfg, tp, tl, _t(toks), cache=tc)
    _close(th, jh)
    _cache_close(tc, jc)
    for step in range(2):
        cur = np.random.default_rng(step + 1).integers(0, 256, (Z, b))
        jlog, jc = jdec(r_j, jp, jl, jc, jnp.asarray(cur))
        with torch.inference_mode(), TLORA.slot_ranks(r_t):
            tlog, tc = TM.decode_step(tcfg, tp, tl, tc, _t(cur))
        _close(tlog, jlog)
        _cache_close(tc, jc)


def test_prefill_lanes_ragged_and_per_lane_decode_match(env):
    """A live per-lane cache: block-prefill some lanes (ragged ``plens``),
    decode with an ``active`` mask, then join more lanes mid-decode. Logits
    and the whole cache match the JAX package; every lane a call does not
    own is bitwise untouched in the port."""
    jcfg, tcfg, jp, jl, tp, tl = env
    Z, b, P, max_len = len(RANKS), 2, 8, 16
    rng = np.random.default_rng(5)
    ranks = np.asarray(RANKS, np.int32)
    jc = JM.init_cache(jcfg, Z, b, max_len, per_lane=True)
    tc = TM.init_cache(tcfg, Z, b, max_len, per_lane=True, device="cpu")
    masks = [np.array([[1, 0], [1, 1], [0, 1]], bool),
             np.array([[0, 1], [0, 0], [1, 0]], bool)]
    plens = [np.array([[5, 1], [8, 3], [1, 7]], np.int32),
             np.array([[1, 6], [1, 1], [2, 1]], np.int32)]
    active = np.zeros((Z, b), bool)
    jpre = _jit_ranked(JM.prefill_lanes, jcfg)
    jdec = _jit_ranked(JM.decode_step, jcfg)
    for join in range(2):
        toks = rng.integers(0, jcfg.vocab_size, (Z, b, P))
        jlog, jc = jpre(jnp.asarray(ranks), jp, jl, jc, jnp.asarray(toks),
                        jnp.asarray(masks[join]), jnp.asarray(plens[join]))
        before = _clone(tc)
        with torch.inference_mode(), TLORA.slot_ranks(_t(ranks)):
            tlog, tc = TM.prefill_lanes(tcfg, tp, tl, tc, _t(toks),
                                        _t(masks[join]), _t(plens[join]))
        _lanes_equal(tc, before, masks[join])
        m = masks[join]
        _close(tlog[_t(m)], np.asarray(jlog)[m])
        _cache_close(tc, jc)
        active |= masks[join]
        for step in range(3):
            act = active.copy()
            act[0, 0] &= step != 1            # a lane idles for one step
            cur = rng.integers(0, jcfg.vocab_size, (Z, b))
            jlog, jc = jdec(jnp.asarray(ranks), jp, jl, jc,
                            jnp.asarray(cur), jnp.asarray(act))
            before = _clone(tc)
            with torch.inference_mode(), TLORA.slot_ranks(_t(ranks)):
                tlog, tc = TM.decode_step(tcfg, tp, tl, tc, _t(cur),
                                          active=_t(act))
            _lanes_equal(tc, before, act)
            _close(tlog[_t(act)], np.asarray(jlog)[act])
            _cache_close(tc, jc)


def test_ring_cache_per_lane_decode_and_reset_match(env):
    """Per-lane sliding-window ring cache streamed past its wrap point,
    with a lane reset mid-stream (the ring join path)."""
    jcfg, tcfg, jp, jl, tp, tl = env
    jcfg = dataclasses.replace(jcfg, sliding_window=5)
    tcfg = dataclasses.replace(tcfg, sliding_window=5)
    Z, b = len(RANKS), 2
    rng = np.random.default_rng(9)
    ranks = np.asarray(RANKS, np.int32)
    jc = JM.init_cache(jcfg, Z, b, 16, ring=True, per_lane=True)
    tc = TM.init_cache(tcfg, Z, b, 16, ring=True, per_lane=True,
                       device="cpu")
    active = np.ones((Z, b), bool)
    jdec = _jit_ranked(JM.decode_step, jcfg)
    for step in range(8):
        if step == 4:
            reset = np.zeros((Z, b), bool)
            reset[1, 0] = True
            jc = JM.reset_lanes(jcfg, jc, jnp.asarray(reset))
            before = _clone(tc)
            tc = TM.reset_lanes(tcfg, tc, _t(reset))
            _lanes_equal(tc, before, reset)
        act = active.copy()
        act[2, 1] = step % 3 != 0
        cur = rng.integers(0, jcfg.vocab_size, (Z, b))
        jlog, jc = jdec(jnp.asarray(ranks), jp, jl, jc, jnp.asarray(cur),
                        jnp.asarray(act))
        with torch.inference_mode(), TLORA.slot_ranks(_t(ranks)):
            tlog, tc = TM.decode_step(tcfg, tp, tl, tc, _t(cur),
                                      active=_t(act))
        _close(tlog[_t(act)], np.asarray(jlog)[act])
        _cache_close(tc, jc)
