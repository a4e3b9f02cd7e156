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
import torch.nn.functional as F

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
# the CUDA kernel's pivoted chunk algebra, modelled in plain torch
# ---------------------------------------------------------------------------

BLOCK = 16   # tokens of a block of the pivoted form (csrc/linear_scan.cu)


def _pivoted_scan(q, k, v, logw, bonus, doq, s0, chunk, exponents):
    """The linear scan in the form of ``csrc/linear_scan.cu``: per chunk,
    L by ``torch.cumsum``; blocks of ``BLOCK`` tokens with PV[T] = L at the
    last token of block T-1 (PV[0] = 0, PV[nb] = L_end); off-diagonal
    tiles as contractions of q~ = q e^{Lq - PV[T]}, g = e^{PV[T] - PV[I+1]}
    and k~ = k e^{PV[I+1] - L}; diagonal tiles with one exponential per
    visible pair; the state term from q~ e^{PV[T]}, the update from
    k~ e^{PV[nb] - PV[I+1]} and e^{L_end}. Every exponent argument it forms
    is appended to ``exponents``. fp32 in, (y, state) out."""
    B, S, K = q.shape
    C = min(chunk, S)
    state = torch.zeros(B, K, v.shape[-1]) if s0 is None else s0.clone()

    def ex(x):
        exponents.append(x.detach().reshape(-1))
        return torch.exp(x)

    starts = list(range(0, C, BLOCK))
    ends = [min(b + BLOCK, C) for b in starts]
    blk = torch.arange(C) // BLOCK
    ys = []
    for c in range(0, S, C):
        qc, kc, vc = q[:, c:c + C], k[:, c:c + C], v[:, c:c + C]
        L = torch.cumsum(logw[:, c:c + C], dim=1)
        Lq = L if doq else F.pad(L, (0, 0, 1, 0))[:, :-1]
        PV = torch.stack([torch.zeros_like(L[:, 0])]
                         + [L[:, e - 1] for e in ends], dim=1)
        qt = qc * ex(Lq - PV[:, blk])
        kt = kc * ex(PV[:, blk + 1] - L)
        P = torch.zeros(B, C, C)
        for T, (s, e) in enumerate(zip(starts, ends)):
            for I in range(T):
                si, ei = starts[I], ends[I]
                g = ex(PV[:, T] - PV[:, I + 1])
                P[:, s:e, si:ei] = torch.einsum("btk,bk,bik->bti",
                                                qt[:, s:e], g, kt[:, si:ei])
            t = torch.arange(s, e)
            vis = (t[:, None] >= t[None, :]) if doq else (
                t[:, None] > t[None, :])
            d = Lq[:, s:e, None, :] - L[:, None, s:e, :]
            w = torch.zeros_like(d)
            w[:, vis] = ex(d[:, vis])
            P[:, s:e, s:e] = (qc[:, s:e, None, :] * kc[:, None, s:e, :]
                              * w).sum(-1)
        if bonus is not None:
            P = P + torch.diag_embed((qc * bonus[:, None, :] * kc).sum(-1))
        qh = qt * ex(PV[:, blk])
        kh = kt * ex(PV[:, -1:] - PV[:, blk + 1])
        ys.append(torch.bmm(qh, state) + torch.bmm(P, vc))
        state = (state * ex(PV[:, -1])[:, :, None]
                 + torch.bmm(kh.transpose(1, 2), vc))
    return torch.cat(ys, dim=1), state


def _decayed(B, S, K, V, decay, seed=11):
    """_make's inputs with logw at chip_smoke's decay (-exp(N(0,1))),
    at the clip -e^4 on every token, or with the even channels at the clip
    and the odd ones near 0 (-1e-3 exp(N(0,1)))."""
    q, k, v, logw, u = _make(B, S, K, V, seed=seed)
    if decay == "clip":
        logw = np.full_like(logw, -np.exp(4.0))
    elif decay == "mixed":
        logw = (1e-3 * logw).astype(np.float32)
        logw[..., 0::2] = -np.exp(4.0)
    return q, k, v, logw, (0.3 * u).astype(np.float32)


@pytest.mark.parametrize("B,S,K,V,chunk,with_state", [
    (2, 256, 64, 64, 128, False),     # an rwkv6-3b head at its chunk
    (3, 80, 16, 8, 40, True),         # K 16; C 40 = 16 + 16 + 8
])
@pytest.mark.parametrize("decay", ["phase", "clip", "mixed"])
@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
def test_pivoted_form_matches_plain_and_jax(B, S, K, V, chunk, with_state,
                                            decay, mode):
    """The kernel's pivoted algebra against the plain core at the card's
    fp32 bar (|diff| <= 1e-5 |plain| + 1e-5 max|plain|, y and the state)
    and against the JAX kernel in interpret mode at this file's bars (3e-4;
    1e-3 at the strong decays); every exponent argument it forms is <= 0
    and every output finite."""
    q, k, v, logw, u = _decayed(B, S, K, V, decay)
    doq = mode == "ssd"
    bonus = None if doq else u
    s0 = (np.random.default_rng(12).standard_normal((B, K, V)).astype(
        np.float32) if with_state else None)
    tq, tk, tv, tl, tu, ts = _t(q, k, v, logw, bonus, s0)
    exps = []
    y, st = _pivoted_scan(tq, tk, tv, tl, tu, doq, ts, chunk, exps)
    assert float(torch.cat(exps).max()) <= 0.0
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())
    wy, ws = tref(tq, tk, tv, tl, bonus=tu, decay_on_query=doq,
                  initial_state=ts, chunk=chunk)
    for got, want in ((y, wy), (st, ws)):
        bar = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
        assert float(((got - want).abs() / bar).max()) <= 1.0
    jy, js = jops.linear_scan(q, k, v, logw, bonus=bonus, decay_on_query=doq,
                              initial_state=s0, chunk=chunk, interpret=True)
    tol = TOL if decay == "phase" else dict(rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **tol)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), **tol)


@pytest.mark.parametrize("mode", ["rwkv", "ssd"])
def test_unpivoted_factorisation_overflows_at_the_clip(mode):
    """The control: (q e^{Lq}) (k e^{-L})^T, the factorisation the kernel
    refuses, gives non-finite y at the decay clip, where the pivoted form
    stays finite and within the fp32 bar."""
    q, k, v, logw, u = _t(*_decayed(2, 128, 16, 16, "clip"))
    doq = mode == "ssd"
    L = torch.cumsum(logw, dim=1)
    Lq = L if doq else F.pad(L, (0, 0, 1, 0))[:, :-1]
    t = torch.arange(128)
    vis = (t[:, None] >= t[None, :]) if doq else (t[:, None] > t[None, :])
    P = torch.bmm(q * torch.exp(Lq), (k * torch.exp(-L)).transpose(1, 2))
    naive = torch.bmm(P * vis, v)
    assert not bool(torch.isfinite(naive).all())
    y, _ = _pivoted_scan(q, k, v, logw, None, doq, None, 128, [])
    want, _ = tref(q, k, v, logw, decay_on_query=doq, chunk=128)
    assert bool(torch.isfinite(y).all())
    bar = 1e-5 * want.abs() + 1e-5 * float(want.abs().max())
    assert float(((y - want).abs() / bar).max()) <= 1.0


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
