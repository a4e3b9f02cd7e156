"""PyTorch port: the chunked linear-scan kernel's plain version and autograd
Function, and the model's scan core, against the JAX package.

On the CPU the wrapper takes its plain version (``ref.py``), so these tests
hold the port's plain core and its Function (forward = the wrapper,
backward = autograd through the plain core) against the JAX Pallas kernel
in interpret mode and the JAX oracle, on the parametrisation of
``tests/test_kernels_linear_scan.py`` in both modes (RWKV: bonus, pairs
t > i; SSD: decay on the query, pairs t >= i), and the port's
``chunked_linear_attention`` under both model backends against the JAX core
and the step-by-step oracles (``tests/test_linear_scan.py``'s cases).
Inputs are made with numpy. Tolerances, as the JAX tests': fp32 forward
3e-4, strong decay 1e-3, bf16 5e-2, gradients 2e-4; the core 2e-4.
The card-side checks are in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.linear_scan import ops as jops
from repro.kernels.linear_scan.ref import linear_scan_ref as jref
from repro.models import linear_scan as JLS
from repro_torch.kernels.linear_scan import linear_scan as TLSK
from repro_torch.kernels.linear_scan import ops as tops
from repro_torch.kernels.linear_scan.ref import linear_scan_ref as tref
from repro_torch.models import backend as TBK
from repro_torch.models import linear_scan as TLS

TOL = dict(rtol=3e-4, atol=3e-4)
CORE_TOL = dict(rtol=2e-4, atol=2e-4)


def _make(B, S, K, V, seed=0, decay=1.0):
    """q, k [B,S,K], v [B,S,V], logw = -decay * exp(N(0,1)) [B,S,K] and a
    per-row bonus [B,K], float32 numpy."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((B, S, K), np.float32) for _ in range(2))
    v = rng.standard_normal((B, S, V), np.float32)
    logw = (-decay * np.exp(rng.standard_normal((B, S, K)))).astype(
        np.float32)
    u = rng.standard_normal((B, K), np.float32)
    return q, k, v, logw, u


def _t(*arrs, dtype=torch.float32):
    return [None if a is None else torch.from_numpy(np.asarray(a)).to(dtype)
            for a in arrs]


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,K,V,chunk", [
    (2, 64, 8, 8, 16), (3, 32, 16, 8, 8), (1, 128, 8, 16, 32),
])
@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
def test_plain_and_function_match_jax(B, S, K, V, chunk, mode):
    """The port's plain core and Function against the JAX Pallas kernel
    (interpret mode) and the JAX oracle, fp32; no kernel launch on the
    CPU."""
    q, k, v, logw, u = _make(B, S, K, V)
    doq = mode == "ssd"
    bonus = u if mode == "rwkv" else None
    want = [jops.linear_scan(q, k, v, logw, bonus=bonus, decay_on_query=doq,
                             chunk=chunk, interpret=True),
            jref(q, k, v, logw, bonus=bonus, decay_on_query=doq,
                 chunk=chunk)]
    args = _t(q, k, v, logw)
    kw = dict(bonus=_t(bonus)[0], decay_on_query=doq, chunk=chunk)
    TLSK.reset_launches()
    got = [tref(*args, **kw), tops.linear_scan(*args, **kw)]
    for y, s in got:
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        for wy, ws in want:
            np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
            np.testing.assert_allclose(s.numpy(), np.asarray(ws), **TOL)
    assert TLSK.LAUNCHES == {"linear_scan": 0}


def test_initial_state_and_strong_decay():
    q, k, v, logw, u = _make(2, 32, 8, 8, seed=3, decay=6.0)
    s0 = np.random.default_rng(9).standard_normal((2, 8, 8)).astype(
        np.float32)
    wy, ws = jops.linear_scan(q, k, v, logw, bonus=u, initial_state=s0,
                              chunk=8, interpret=True)
    y, s = tops.linear_scan(*_t(q, k, v, logw), bonus=_t(u)[0],
                            initial_state=_t(s0)[0], chunk=8)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-3,
                               atol=1e-3)
    jy, js = jref(q, k, v, logw, bonus=u, initial_state=s0, chunk=8)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-3,
                               atol=1e-3)


def test_bf16_matches_jax():
    q, k, v, logw, u = _make(1, 32, 8, 8, seed=5)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    wy, _ = jops.linear_scan(jq, jk, jv, logw, bonus=u, chunk=8,
                             interpret=True)
    tq, tk, tv = _t(q, k, v, dtype=torch.bfloat16)
    y, s = tops.linear_scan(tq, tk, tv, *_t(logw), bonus=_t(u)[0], chunk=8)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), np.asarray(wy, np.float32),
                               rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(
        y.float().numpy(),
        np.asarray(jref(jq, jk, jv, logw, bonus=u, chunk=8)[0], np.float32),
        rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("with_state", [True, False])
def test_gradients_match_jax(with_state):
    """q/k/v/logw gradients of the Function (autograd through the plain
    core) against ``jax.grad`` through the JAX kernel's custom VJP, at the
    JAX gradient test's bar (2e-4). Without ``with_state`` the loss reads y
    alone: the final state's cotangent is None, as in training."""
    q, k, v, logw, u = _make(1, 16, 4, 4, seed=7)

    def jloss(q_, k_, v_, lw_):
        y, s = jops.linear_scan(q_, k_, v_, lw_, bonus=u, chunk=8,
                                interpret=True)
        return jnp.sum(jnp.tanh(y)) + (jnp.sum(s * s) if with_state else 0.)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(q, k, v, logw)
    ins = [x.requires_grad_(True) for x in _t(q, k, v, logw)]
    y, s = tops.linear_scan(*ins, bonus=_t(u)[0], chunk=8)
    loss = torch.tanh(y).sum() + ((s * s).sum() if with_state else 0.0)
    got = torch.autograd.grad(loss, ins)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-4,
                                   atol=2e-4)


def test_function_gradient_only_where_asked():
    q, k, v, logw, u = _t(*_make(1, 16, 4, 4, seed=3))
    s0 = torch.zeros(1, 4, 4, requires_grad=True)
    k.requires_grad_(True)
    y, _ = tops.linear_scan(q, k, v, logw, bonus=u, initial_state=s0,
                            chunk=8)
    gk, gs = torch.autograd.grad(y.sum(), (k, s0))
    assert gk.shape == k.shape and gs.shape == s0.shape
    assert q.grad is None and logw.grad is None


# ---------------------------------------------------------------------------
# the model's scan core
# ---------------------------------------------------------------------------

def _make5(Z, b, S, H, K, V, seed=0, decay=1.0):
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((Z, b, S, H, K), np.float32)
            for _ in range(2))
    v = rng.standard_normal((Z, b, S, H, V), np.float32)
    logw = (-decay * np.exp(rng.standard_normal((Z, b, S, H, K)))).astype(
        np.float32)
    u = rng.standard_normal((H, K), np.float32)
    return q, k, v, logw, u


@pytest.mark.parametrize("backend", ["kernel", "torch"])
@pytest.mark.parametrize("chunk", [4, 16, 32])
@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
def test_chunked_matches_jax_core_and_oracle(backend, chunk, mode):
    q, k, v, logw, u = _make5(2, 2, 64, 3, 8, 8)
    doq = mode == "ssd"
    bonus = u if mode == "rwkv" else None
    wy, ws = JLS.chunked_linear_attention(q, k, v, logw, bonus=bonus,
                                          decay_on_query=doq, chunk=chunk)
    args = _t(q, k, v, logw)
    with TBK.backend(backend):
        y, s = TLS.chunked_linear_attention(*args, bonus=_t(bonus)[0],
                                            decay_on_query=doq, chunk=chunk)
    oy, os_ = TLS.reference_linear_attention(*args, bonus=_t(bonus)[0],
                                             decay_on_query=doq)
    jy, js = JLS.reference_linear_attention(q, k, v, logw, bonus=bonus,
                                            decay_on_query=doq)
    for got, want in ((y, wy), (s, ws), (y, oy), (s, os_), (oy, jy),
                      (os_, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CORE_TOL)


def test_strong_decay_is_stable():
    q, k, v, logw, u = _make5(1, 1, 128, 2, 8, 8, decay=8.0)
    args = _t(q, k, v, logw)
    y, s = TLS.chunked_linear_attention(*args, bonus=_t(u)[0], chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    wy, _ = JLS.chunked_linear_attention(q, k, v, logw, bonus=u, chunk=32)
    oy, _ = TLS.reference_linear_attention(*args, bonus=_t(u)[0])
    for want in (wy, oy):
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)


def test_initial_state_continuation():
    """[0:S/2] then [S/2:S] with the carried state == one pass."""
    q, k, v, logw, u = _t(*_make5(1, 2, 64, 2, 8, 8))
    bonus = u
    y_full, s_full = TLS.chunked_linear_attention(q, k, v, logw, bonus=bonus,
                                                  chunk=16)
    h = 32
    y1, s1 = TLS.chunked_linear_attention(
        q[:, :, :h], k[:, :, :h], v[:, :, :h], logw[:, :, :h], bonus=bonus,
        chunk=16)
    y2, s2 = TLS.chunked_linear_attention(
        q[:, :, h:], k[:, :, h:], v[:, :, h:], logw[:, :, h:], bonus=bonus,
        initial_state=s1, chunk=16)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=2).numpy(),
                               y_full.numpy(), **CORE_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **CORE_TOL)


def test_decode_step_matches_chunked_and_jax():
    q, k, v, logw, u = _make5(2, 1, 16, 2, 4, 4)
    tq, tk, tv, tl, tu = _t(q, k, v, logw, u)
    y_full, s_full = TLS.chunked_linear_attention(tq, tk, tv, tl, bonus=tu,
                                                  chunk=8)
    state = torch.zeros(2, 1, 2, 4, 4)
    jstate = jnp.zeros((2, 1, 2, 4, 4))
    for t in range(16):
        y_t, state = TLS.linear_attention_decode_step(
            tq[:, :, t], tk[:, :, t], tv[:, :, t], tl[:, :, t], state,
            bonus=tu)
        jy_t, jstate = JLS.linear_attention_decode_step(
            q[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t], jstate,
            bonus=u)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(jy_t),
                                   **CORE_TOL)
    np.testing.assert_allclose(y_t.numpy(), y_full[:, :, -1].numpy(),
                               **CORE_TOL)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), **CORE_TOL)


@pytest.mark.parametrize("S,chunk", [(24, 8), (48, 24), (8, 4)])
@pytest.mark.parametrize("mode", [False, True])
def test_chunk_invariance(S, chunk, mode):
    """The output does not depend on the chunk size (associativity)."""
    q, k, v, logw, u = _t(*_make5(1, 1, S, 1, 4, 4, seed=S + chunk))
    bonus = None if mode else u
    y1, _ = TLS.chunked_linear_attention(q, k, v, logw, bonus=bonus,
                                         decay_on_query=mode, chunk=chunk)
    y2, _ = TLS.chunked_linear_attention(q, k, v, logw, bonus=bonus,
                                         decay_on_query=mode, chunk=S)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=5e-4, atol=5e-4)
