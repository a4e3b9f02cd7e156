"""PyTorch port: the flash-attention kernel's plain version and autograd
Function against the JAX package, and the model's dispatch to it.

On the CPU the wrapper takes its plain version (``ref.py``), so these tests
hold the port's plain oracle and its Function (forward = the wrapper,
backward = autograd through the oracle) against the JAX oracle and the JAX
Pallas kernel in interpret mode, on the parametrisation of
``tests/test_kernels_flash_attention.py``; inputs are made with numpy.
Tolerances: fp32 forward rtol/atol 2e-5 (the JAX kernel test's), bf16
3e-2, q/k/v gradients 1e-5; model level the JAX package's backend bars
(forward 5e-4, loss 1e-4, gradients 2e-3; tests/test_kernel_backends.py).
The card-side checks are in ``tests/test_torch_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ATTN_SLIDING
from repro.core import lora as JLORA
from repro.core.losses import sft_loss as jsft_loss
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import flash_attention_ref as jref
from repro.models import backend as JBK
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import lora as TLORA
from repro_torch.core import losses as TLS
from repro_torch.kernels.flash_attention import flash_attention as TFA
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as tref
from repro_torch.models import attention as TATT
from repro_torch.models import backend as TBK
from repro_torch.models import model as TM
from tests.conftest import reduced_f32

FTOL = dict(rtol=2e-5, atol=2e-5)
FWD_TOL = dict(rtol=5e-4, atol=5e-4)
GTOL = dict(rtol=2e-3, atol=2e-3)


def _qkv(B, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, hd), np.float32),
            rng.standard_normal((B, Sk, hd), np.float32),
            rng.standard_normal((B, Sk, hd), np.float32))


def _t(*arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


# ---------------------------------------------------------------------------
# kernel level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,hd,bq,bk", [
    (2, 64, 64, 32, 16, 16),
    (1, 128, 128, 64, 32, 64),
    (3, 32, 96, 16, 16, 32),      # Sq < Sk (suffix alignment)
])
@pytest.mark.parametrize("window", [0, 24])
def test_plain_and_function_match_jax(B, Sq, Sk, hd, bq, bk, window):
    """The port's oracle and Function against the JAX oracle and the JAX
    Pallas kernel (interpret mode), fp32."""
    q, k, v = _qkv(B, Sq, Sk, hd)
    want_ref = np.asarray(jref(q, k, v, window=window))
    want_kernel = np.asarray(jops.flash_attention(
        q, k, v, window=window, bq=bq, bk=bk, interpret=True))
    tq, tk, tv = _t(q, k, v)
    TFA.reset_launches()
    got_ref = tref(tq, tk, tv, window=window).numpy()
    got_fn = tops.flash_attention(tq, tk, tv, window=window).numpy()
    for got in (got_ref, got_fn):
        np.testing.assert_allclose(got, want_ref, **FTOL)
        np.testing.assert_allclose(got, want_kernel, **FTOL)
    # plain versions on the CPU are not kernel launches
    assert TFA.LAUNCHES == {"flash_attention": 0}


def test_noncausal_matches_jax():
    q, k, v = _qkv(1, 32, 32, 16, seed=4)
    want = np.asarray(jops.flash_attention(q, k, v, causal=False, bq=16,
                                           bk=16, interpret=True))
    got = tops.flash_attention(*_t(q, k, v), causal=False).numpy()
    np.testing.assert_allclose(got, want, **FTOL)
    np.testing.assert_allclose(got, np.asarray(jref(q, k, v, causal=False)),
                               **FTOL)


def test_bf16_matches_jax():
    q, k, v = _qkv(2, 64, 64, 32, seed=5)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, bq=32, bk=32,
                                           interpret=True), np.float32)
    got = tops.flash_attention(*_t(q, k, v, dtype=torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jref(jq, jk, jv), np.float32),
        rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("window", [0, 16])
def test_head_dim_80_matches_jax(window):
    """stablelm-3b's head dim (80, not a power of two)."""
    q, k, v = _qkv(2, 48, 48, 80, seed=6)
    want = np.asarray(jops.flash_attention(q, k, v, window=window, bq=16,
                                           bk=16, interpret=True))
    got = tops.flash_attention(*_t(q, k, v), window=window).numpy()
    np.testing.assert_allclose(got, want, **FTOL)


def test_fully_masked_rows_are_exact_zeros():
    """Sq > Sk, causal: queries i < Sq - Sk see no key, their rows are
    exactly 0 (the oracle zeroes the NaN softmax), as in the JAX kernel."""
    B, Sq, Sk, hd = 2, 64, 32, 16
    q, k, v = _qkv(B, Sq, Sk, hd, seed=8)
    got = tops.flash_attention(*_t(q, k, v)).numpy()
    assert np.all(got[:, :Sq - Sk] == 0.0)
    assert np.all(np.isfinite(got))
    want = np.asarray(jops.flash_attention(q, k, v, bq=16, bk=16,
                                           interpret=True))
    assert np.all(want[:, :Sq - Sk] == 0.0)
    np.testing.assert_allclose(got, want, **FTOL)


# the card's bf16 bar for the kernel against its plain version
# (chip_smoke.FLASH_RTOL["bf16"], FLASH_ATOL_REL): one bf16 rounding
BF16_RTOL, BF16_ATOL_REL = 2 ** -7, 1e-5


def _attention_p_rounded(q, k, v, round_p):
    """The plain version's causal attention with the unnormalised softmax
    weights p = exp(s - rowmax) rounded by ``round_p`` before the product
    with V (fp32 sums, then / sum p), as the card's bf16 kernel feeds p to
    the tensor cores; out in q's dtype."""
    S, hd = q.shape[1], q.shape[2]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * hd ** -0.5
    vis = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(vis, s, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bqk,bkd->bqd", round_p(p), v.float())
    return (out / p.sum(-1, keepdim=True)).to(q.dtype)


def _bf16(t):
    return t.bfloat16().float()


def test_bf16_kernel_keeps_p_to_two_bf16_halves():
    """Why the bf16 kernel multiplies V by p as hi = bf16(p) plus lo =
    bf16(p - hi): the plain attention with p so split reads <= 1 of the
    card's bf16 bar, and with p rounded once to bf16 it reads > 1."""
    q, k, v = _t(*_qkv(16, 128, 128, 80, seed=4), dtype=torch.bfloat16)
    want = tref(q, k, v).float()

    def reading(got):
        tol = BF16_RTOL * want.abs() + BF16_ATOL_REL * float(want.abs().max())
        return float(((got.float() - want).abs() / tol).max())

    split = reading(_attention_p_rounded(
        q, k, v, lambda p: _bf16(p) + _bf16(p - _bf16(p))))
    once = reading(_attention_p_rounded(q, k, v, _bf16))
    assert split <= 1.0
    assert once > 1.0


@pytest.mark.parametrize("window", [0, 12])
def test_gradients_match_jax_vjp(window):
    """q/k/v gradients of the Function (autograd through the oracle)
    against ``jax.vjp`` of the JAX oracle, fp32, 1e-5."""
    q, k, v = _qkv(2, 32, 32, 16, seed=7)
    ct = np.random.default_rng(9).standard_normal(q.shape, np.float32)
    _, vjp = jax.vjp(lambda a, b, c: jref(a, b, c, window=window), q, k, v)
    want = vjp(jnp.asarray(ct))
    tq, tk, tv = (x.requires_grad_(True) for x in _t(q, k, v))
    out = tops.flash_attention(tq, tk, tv, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(ct))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_function_gradient_only_where_asked():
    q, k, v = _t(*_qkv(1, 16, 16, 16, seed=3))
    q.requires_grad_(True)
    out = tops.flash_attention(q, k, v)
    (gq,) = torch.autograd.grad(out.sum(), (q,))
    assert gq.shape == q.shape and k.grad is None


# ---------------------------------------------------------------------------
# model level: the port under "kernel" vs the JAX package under its Pallas
# backend (interpret mode)
# ---------------------------------------------------------------------------

def _variant(cfg, name):
    if name == "sliding":
        return dataclasses.replace(cfg, attn_kind=ATTN_SLIDING,
                                   sliding_window=8)
    return cfg


# (arch, reduced widths, variant): stablelm-3b (MHA), paper-llama-tiny with
# 8 query heads over 4 KV heads (GQA), and the same with a sliding window
MODEL_CASES = {
    "stablelm-3b": ("stablelm-3b", dict(d_model=128, vocab=256), None),
    "llama-gqa": ("paper-llama-tiny", dict(d_model=256, vocab=256), None),
    "llama-gqa-window": ("paper-llama-tiny", dict(d_model=256, vocab=256),
                         "sliding"),
}


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_env(request):
    arch, kw, variant = MODEL_CASES[request.param]
    jcfg = _variant(reduced_f32(arch, **kw), variant)
    tcfg = _variant(dataclasses.replace(tget_arch(arch).reduced(**kw),
                                        dtype="float32"), variant)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    key = jax.random.PRNGKey(1)
    jparams = jax.jit(lambda k_: JM.init_params(k_, jcfg))(key)
    Z = 2
    lt = JLORA.init_lora_tree(key, jcfg, Z, jnp.array([4, 8]),
                              JM.target_shapes(jcfg))
    lt = jax.tree_util.tree_map(lambda x: x + 0.01, lt)
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tlora = bridge.lora_from_numpy(jax.tree_util.tree_map(np.asarray, lt),
                                   "cpu")
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (Z, 1, 32)).astype(np.int32)
    return request.param, jcfg, tcfg, jparams, lt, tparams, tlora, tokens


def _spy_flash(monkeypatch):
    calls = []
    real = TATT.FA.flash_attention

    def spy(q, k, v, **kw):
        calls.append((tuple(q.shape), tuple(k.shape), kw))
        return real(q, k, v, **kw)
    monkeypatch.setattr(TATT.FA, "flash_attention", spy)
    return calls


def test_model_forward_matches_jax_pallas_backend(model_env, monkeypatch):
    name, jcfg, tcfg, jparams, lt, tparams, tlora, tokens = model_env
    with JBK.backend("pallas_interpret"):
        want, _, _ = jax.jit(lambda p, l_, t: JM.forward(
            jcfg, p, l_, t, remat=False))(jparams, lt, jnp.asarray(tokens))
    calls = _spy_flash(monkeypatch)
    with torch.no_grad():
        got, _, _ = TM.forward(tcfg, tparams, tlora,
                               torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    H, hd = tcfg.num_heads, tcfg.resolved_head_dim
    window = 8 if name == "llama-gqa-window" else 0
    assert calls == [((2 * H, 32, hd), (2 * H, 32, hd),
                      {"causal": True, "window": window})] * tcfg.num_layers


def test_model_loss_and_grads_match_jax_pallas_backend(model_env):
    _, jcfg, tcfg, jparams, lt, tparams, tlora, tokens = model_env
    Z = tokens.shape[0]
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(tokens)}
    active = np.ones((Z,), np.int32)

    def loss(l_):
        return jsft_loss(jcfg, jparams, l_, jbatch, jnp.asarray(active),
                         remat=False)[0]

    with JBK.backend("pallas_interpret"):
        l1, g1 = jax.jit(jax.value_and_grad(loss))(lt)
    leaves = {t: {m: x.clone().requires_grad_(True) for m, x in ab.items()}
              for t, ab in tlora.items()}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(tokens)}
    total, _ = TLS.sft_loss(tcfg, tparams, leaves, tb,
                            torch.from_numpy(active))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), float(l1), rtol=1e-4)
    for t in g1:
        for m in g1[t]:
            np.testing.assert_allclose(leaves[t][m].grad.numpy(),
                                       np.asarray(g1[t][m]),
                                       err_msg=f"{t}.{m}", **GTOL)


def _lora_tree(cfg):
    gen = torch.Generator().manual_seed(0)
    return TLORA.init_lora_tree(gen, cfg, 2, torch.tensor([4, 8]),
                                TM.target_shapes(cfg))


def _dispatch_cfg():
    return dataclasses.replace(
        tget_arch("paper-llama-tiny").reduced(num_layers=2, d_model=64,
                                              vocab=128), dtype="float32")


@pytest.mark.parametrize("mode", ["train", "eval", "prefill-longer",
                                  "prefill-full", "decode", "torch-backend"])
def test_flash_dispatch_by_shape(mode, monkeypatch):
    """Train forwards (and their remat recompute) and eval forwards take
    the Function; a prefill into a longer cache and decode do not; a
    prefill that fills its whole cache does (the JAX package's condition);
    the "torch" backend never does."""
    cfg = _dispatch_cfg()
    L, S = cfg.num_layers, 8
    params = TM.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, S),
                           generator=torch.Generator().manual_seed(0))
    calls = []
    real = tops._FlashAttention.apply

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(tops._FlashAttention, "apply", spy)
    if mode == "train":
        lora = {t: {m: x.requires_grad_(True) for m, x in ab.items()}
                for t, ab in _lora_tree(cfg).items()}
        h, _, _ = TM.forward(cfg, params, lora, tokens)
        h.sum().backward()
        want = 2 * L                       # the forward and its recompute
    elif mode == "eval":
        with torch.no_grad():
            TM.forward(cfg, params, {}, tokens)
        want = L
    elif mode in ("prefill-longer", "prefill-full"):
        max_len = 2 * S if mode == "prefill-longer" else S
        cache = TM.init_cache(cfg, 2, 2, max_len, device="cpu")
        with torch.no_grad():
            TM.forward(cfg, params, {}, tokens, cache=cache)
        want = 0 if mode == "prefill-longer" else L
    elif mode == "decode":
        cache = TM.init_cache(cfg, 2, 2, 2 * S, per_lane=True, device="cpu")
        with torch.no_grad():
            TM.decode_step(cfg, params, {}, cache, tokens[:, :, 0])
        want = 0
    else:
        with TBK.backend("torch"), torch.no_grad():
            TM.forward(cfg, params, {}, tokens)
        want = 0
    assert len(calls) == want


def test_remat_recompute_keeps_the_backend(monkeypatch):
    """A training forward under "torch" recomputes its layers under "torch"
    too, whichever thread runs the backward."""
    cfg = _dispatch_cfg()
    params = TM.init_params(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 1, 8),
                           generator=torch.Generator().manual_seed(1))
    calls = []
    monkeypatch.setattr(tops._FlashAttention, "apply",
                        lambda *a: calls.append(1))
    lora = {t: {m: x.requires_grad_(True) for m, x in ab.items()}
            for t, ab in _lora_tree(cfg).items()}
    with TBK.backend("torch"):
        h, _, _ = TM.forward(cfg, params, lora, tokens)
    h.sum().backward()
    assert calls == []


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown model backend"):
        TBK.set_backend("pallas")
