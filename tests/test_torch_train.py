"""PyTorch port: the training path held against the JAX package.

(a) The four rank-local backward kernels' plain versions against the JAX
    VJP (``ops._ranklocal_bwd_impl`` and ``ranklocal.ds`` in Pallas
    interpret mode) on the forward tests' cases, fp32 and one bf16 case.
(b) The autograd Functions' gradients (rank-local, dense and ragged)
    against autograd through the kernels' plain versions (the ``"torch"``
    LoRA backend).
(c) ``make_train_step`` in both packages from bridged weights, adapters
    (non-zero B, garbage in the padded rank region), moments and batches,
    for 3 steps on reduced float32 stablelm-3b, the JAX side under
    ``LORA.backend("pallas_interpret")``: with ``slot_ranks`` bound, so
    both sides take the rank-local path; with every slot at r_max and
    nothing bound, so both take the dense path; and with every slot at
    r_max and ``slot_rows`` bound alone, so both take the ragged path;
    AdamW alone on identical numpy gradients.
(d) The padded rank region stays exactly 0 across steps with no re-mask.
(e) ``make_eval_step`` parity, on the rank-local and the dense path.

Bars: the JAX package's own (tests/test_kernel_backends.py) — float32
kernels rtol/atol 5e-4, loss rtol 1e-4, gradients rtol/atol 2e-3; AdamW
on identical gradients 1e-6 (the same fp32 elementwise ops).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as JLORA
from repro.core import steps as JSTEPS
from repro.core.losses import sft_loss as jsft_loss
from repro.kernels.grouped_lora import ops as JOPS
from repro.kernels.grouped_lora import ranklocal as JRL
from repro.models import model as JM
from repro.optim import adamw as JAD
from repro_torch import bridge
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import lora as TLORA
from repro_torch.core import steps as TSTEPS
from repro_torch.kernels.grouped_lora import grouped_lora as TGL
from repro_torch.kernels.grouped_lora import ops as TOPS
from repro_torch.kernels.grouped_lora import ragged as TRG
from repro_torch.kernels.grouped_lora import ranklocal as TRL
from repro_torch.kernels.grouped_lora import ref as TREF
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TAD
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import (  # noqa: F401
    CASES, _inputs, _one_torch_thread, _spy, _t)

KTOL = dict(rtol=5e-4, atol=5e-4)      # float32 kernels
GTOL = dict(rtol=2e-3, atol=2e-3)      # gradients, parameters
LOSS_RTOL = 1e-4


def _full_rows(rows, Z, T):
    return rows if rows is not None else np.full((Z,), T, np.int32)


# ---------------------------------------------------------------------------
# (a) plain backward versions vs the JAX VJP
# ---------------------------------------------------------------------------

def _jax_backward(x, A, B, scale, ranks, rows, dy):
    """(S, dS, dX, dA, dB) of the JAX rank-local VJP, interpret mode."""
    Z, T = x.shape[:2]
    r = A.shape[2]
    jrows = jnp.asarray(_full_rows(rows, Z, T))
    args = [jnp.asarray(a) for a in (x, A, B, scale, ranks)]
    _, s = JOPS._ranklocal_fwd_impl(*args, jrows, None, interpret=True)
    dx, dA, dB = JOPS._ranklocal_bwd_impl(*args, jrows, s, jnp.asarray(dy),
                                          interpret=True)
    _, _, Bp, _, dyp = JOPS._pad_bwd(args[0], args[1], args[2], s,
                                     jnp.asarray(dy))
    ds = JRL.ds(dyp, Bp, args[3], jrows, args[4], interpret=True)
    return s[:, :, :r], ds[:, :T, :r], dx, dA, dB


def _port_backward(x, A, B, scale, ranks, rows, dy):
    s = TRL.xa(x, A, rows, ranks)
    ds = TRL.ds(dy, B, scale, rows, ranks)
    return (s, ds, TRL.dx(ds, A, rows, ranks), TRL.da(x, ds, rows, ranks),
            TRL.db(s, dy, scale, rows, ranks))


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_pallas_interpret(case):
    x, A, B, scale, ranks, rows, _ = _inputs(case)
    Z, T = x.shape[:2]
    dy = np.random.default_rng(5).standard_normal(
        (Z, T, B.shape[2]), dtype=np.float32)
    want = _jax_backward(x, A, B, scale, ranks, rows, dy)
    got = _port_backward(_t(x), _t(A), _t(B), _t(scale), _t(ranks),
                         _t(rows), _t(dy))
    for name, g, w in zip(("s", "ds", "dx", "da", "db"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **KTOL)
    _, ds, dx, da, db = (g.numpy() for g in got)
    live = _full_rows(rows, Z, T)
    for z, rk in enumerate(ranks):
        # exact zeros where nothing lives, garbage in the pad notwithstanding
        assert np.all(ds[z, :, rk:] == 0) and np.all(ds[z, live[z]:] == 0)
        assert np.all(dx[z, live[z]:] == 0)
        assert np.all(da[z, :, rk:] == 0) and np.all(db[z, rk:] == 0)
        if rk == 0 or live[z] == 0:
            assert np.all(dx[z] == 0) and np.all(da[z] == 0)
            assert np.all(db[z] == 0)


def test_plain_backward_bf16_rounds_where_the_jax_kernels_do():
    """bf16 activations and cotangent: A/B rounded to bf16, fp32 sums,
    dS and dX stored in bf16, dA/dB fp32. dS/dX may differ by one bf16
    rounding (fp32 sums in another order): 2 bf16 ulps (rtol 2**-7) plus
    1e-2; dA/dB sum the same bf16 products in another order: rtol 1e-4
    plus 1e-4 of their largest entry."""
    x, A, B, scale, ranks, rows, _ = _inputs(CASES[0])
    dy = np.random.default_rng(5).standard_normal(
        (x.shape[0], x.shape[1], B.shape[2]), dtype=np.float32)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
    dyb = np.asarray(jnp.asarray(dy).astype(jnp.bfloat16))
    want = _jax_backward(xb, A, B, scale, ranks, rows, dyb)

    def bf16(a):
        return _t(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(
            torch.bfloat16)

    got = _port_backward(bf16(xb), _t(A), _t(B), _t(scale), _t(ranks),
                         _t(rows), bf16(dyb))
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    for name, g, w in zip(("s", "ds", "dx", "da", "db"), got, want):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        tol = (dict(rtol=2 ** -7, atol=1e-2) if g.dtype == torch.bfloat16
               else dict(rtol=1e-4, atol=1e-4 * np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


# ---------------------------------------------------------------------------
# (b) the autograd Function vs autograd through the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_function_gradients_match_autograd_through_plain(case, with_base):
    """On CPU tensors every wrapper takes its plain version, so the
    Function's hand-written backward (ds -> dx, da, db) and autograd
    through the composed plain forward differ only in fp32 sum order:
    rtol/atol 1e-5."""
    x, A, B, scale, ranks, rows, base = _inputs(case)
    dy = _t(np.random.default_rng(7).standard_normal(
        base.shape, dtype=np.float32))
    outs = []
    TRL.reset_launches()
    for fn in (TOPS.ranklocal_grouped_lora, TREF.ranklocal_lora_ref):
        leaves = [_t(a).requires_grad_(True) for a in (x, A, B, base)]
        y = fn(leaves[0], leaves[1], leaves[2], _t(scale), _t(ranks),
               _t(rows), leaves[3] if with_base else None)
        used = leaves if with_base else leaves[:3]
        outs.append([y] + list(torch.autograd.grad(y, used, dy)))
    assert set(TRL.LAUNCHES.values()) == {0}          # CPU: plain versions
    for got, want in zip(*outs):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("shape", [(2, 7, 33, 4, 17), (3, 100, 130, 12, 200)])
def test_dense_function_gradients_match_autograd_through_plain(shape,
                                                                with_base):
    """``ops.grouped_lora`` (the dense Function: ds -> dx, da, db) against
    autograd through ``grouped_lora_ref`` on CPU tensors: fp32 sum order
    only, rtol 1e-5 plus 1e-5 of the largest entry (dA sums up to 100
    products of unit-scale values, which cancel); no launch is counted."""
    Z, T, din, r, dout = shape
    rng = np.random.default_rng(8)
    x = rng.standard_normal((Z, T, din), dtype=np.float32)
    A = rng.standard_normal((Z, din, r), dtype=np.float32) / din ** 0.5
    B = rng.standard_normal((Z, r, dout), dtype=np.float32) / r ** 0.5
    base = rng.standard_normal((Z, T, dout), dtype=np.float32)
    scale = _t(rng.uniform(0.5, 2.0, Z).astype(np.float32))
    dy = _t(rng.standard_normal((Z, T, dout), dtype=np.float32))
    outs = []
    TGL.reset_launches()
    for fn in (TOPS.grouped_lora, TREF.grouped_lora_ref):
        leaves = [_t(a).requires_grad_(True) for a in (x, A, B, base)]
        y = fn(leaves[0], leaves[1], leaves[2], scale,
               leaves[3] if with_base else None)
        used = leaves if with_base else leaves[:3]
        outs.append([y] + list(torch.autograd.grad(y, used, dy)))
    assert set(TGL.LAUNCHES.values()) == {0}          # CPU: plain versions
    for got, want in zip(*outs):
        want = want.detach().numpy()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("shape", [(4, 37, 40, 16, 24, [37, 13, 0, 30]),
                                   (3, 100, 130, 12, 200, [100, 64, 1])])
def test_ragged_function_gradients_match_autograd_through_plain(shape,
                                                                 with_base):
    """``ops.ragged_grouped_lora`` (the ragged Function: ds -> dx, da, db)
    against autograd through ``ragged_lora_ref`` on CPU tensors: fp32 sum
    order only, rtol 1e-5 plus 1e-5 of the largest entry; dead rows get a
    zero gradient and no launch is counted."""
    Z, T, din, r, dout, rows = shape
    rng = np.random.default_rng(9)
    x = rng.standard_normal((Z, T, din), dtype=np.float32)
    A = rng.standard_normal((Z, din, r), dtype=np.float32) / din ** 0.5
    B = rng.standard_normal((Z, r, dout), dtype=np.float32) / r ** 0.5
    base = rng.standard_normal((Z, T, dout), dtype=np.float32)
    scale = _t(rng.uniform(0.5, 2.0, Z).astype(np.float32))
    dy = _t(rng.standard_normal((Z, T, dout), dtype=np.float32))
    rw = _t(np.asarray(rows, np.int32))
    outs = []
    TRG.reset_launches()
    for fn in (TOPS.ragged_grouped_lora, TREF.ragged_lora_ref):
        leaves = [_t(a).requires_grad_(True) for a in (x, A, B, base)]
        y = fn(leaves[0], leaves[1], leaves[2], scale, rw,
               leaves[3] if with_base else None)
        used = leaves if with_base else leaves[:3]
        outs.append([y] + list(torch.autograd.grad(y, used, dy)))
    assert set(TRG.LAUNCHES.values()) == {0}          # CPU: plain versions
    for got, want in zip(*outs):
        want = want.detach().numpy()
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    dx = outs[0][1].numpy()
    for z, nr in enumerate(rows):
        assert np.all(dx[z, nr:] == 0)


def test_lora_delta_backends_agree_in_gradient():
    """``lora_delta`` under ``slot_ranks`` + ``ragged_rows`` on
    [Z, b, S, d] activations: the kernel backend (Function) and the torch
    backend (autograd through the plain versions) give one gradient."""
    Z, T, din, dout, r, ranks, rows = CASES[0]
    x, A, B, scale, ranks, rows, _ = _inputs(CASES[0], seed=3)
    x4 = x.reshape(Z, 1, T, din)
    grads = []
    for name in TLORA.BACKENDS:
        leaves = [_t(a).requires_grad_(True) for a in (x4, A, B)]
        with TLORA.backend(name), TLORA.slot_ranks(_t(ranks)), \
                TLORA.ragged_rows(_t(rows)):
            y = TLORA.lora_delta(*leaves, 2.0)
        grads.append(torch.autograd.grad(y.square().sum(), leaves))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# (c) and (e): train and eval steps against the JAX package
# ---------------------------------------------------------------------------

Z, BSZ, SEQ = 4, 2, 16
ROWS = BSZ * SEQ
R_MAX = 8          # r_max of the reduced config
# (ranks, active, slot_rows); ranks None: every slot at r_max and no ranks
# bound, the executor's all-full-rank step (dense without rows, ragged with)
STEP_CASES = {
    "rows=T": ([2, 4, 6, 3], [1, 1, 1, 1], None),
    "ragged": ([2, 4, 6, 3], [1, 1, 1, 1], [ROWS, SEQ, ROWS, SEQ]),
    "mixed+empty": ([8, 3, 0, 5], [1, 1, 0, 1], None),
    "ragged x rank": ([1, 8, 5, 0], [1, 1, 1, 0], [ROWS, SEQ, SEQ, 0]),
    "dense": (None, [1, 1, 1, 1], None),
    "ragged full-rank": (None, [1, 1, 1, 1], [ROWS, SEQ, ROWS, SEQ]),
}


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
    jtrain = JSTEPS.make_train_step(jcfg)

    def jfn(params, lora, opt, hp, active, ranks, batch):
        """JAX gradients and the JAX train step in one compiled call
        (interpret-mode Pallas compiles slowly); ``batch`` carries
        ``slot_rows`` (all T when the port runs without them) and
        ``slot_ranks`` unless nothing is bound (the dense step)."""
        b = {k: v for k, v in batch.items()
             if k not in ("slot_rows", "slot_ranks")}
        with JLORA.backend("pallas_interpret"):
            with JLORA.ragged_rows(batch.get("slot_rows")), \
                    JLORA.slot_ranks(batch.get("slot_ranks")):
                grads = jax.grad(lambda l_: jsft_loss(
                    jcfg, params, l_, b, active)[0])(lora)
            return grads, jtrain(params, lora, opt, hp, active, ranks, batch)

    def jeval(params, lora, active, batch):
        with JLORA.backend("pallas_interpret"):
            return JSTEPS.make_eval_step(jcfg)(params, lora, active, batch)

    return jcfg, tcfg, jparams, tparams, jax.jit(jfn), jax.jit(jeval)


def _step_inputs(cfg, ranks, active, rows, seed=0):
    """Numpy adapters (non-zero B inside the rank, garbage in the pad),
    moments, hyperparameters and 3 batches (labels -1 on ragged pad)."""
    rng = np.random.default_rng(seed)
    r = cfg.lora.r_max
    L = cfg.num_layers
    lora, mu, nu = {}, {}, {}
    for t, (din, dout) in JM.target_shapes(cfg).items():
        lora[t] = {"A": rng.standard_normal((L, Z, din, r), np.float32)
                   / din ** 0.5,
                   "B": rng.standard_normal((L, Z, r, dout), np.float32)
                   * 0.05}
        mu[t] = {m: rng.standard_normal(x.shape, np.float32) * 1e-3
                 for m, x in lora[t].items()}
        nu[t] = {m: rng.uniform(0, 1e-5, x.shape).astype(np.float32)
                 for m, x in lora[t].items()}
    count = np.array([3, 1, 0, 2], np.int32)
    hp = {"lr": np.array([1e-3, 3e-3, 1e-2, 5e-4], np.float32),
          "wd": np.array([0.01, 0.0, 0.1, 0.01], np.float32),
          "beta1": np.full(Z, 0.9, np.float32),
          "beta2": np.full(Z, 0.999, np.float32),
          "grad_clip": np.array([1.0, 0.0, 0.5, 2.0], np.float32)}
    batches = []
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
        lab = rng.integers(0, cfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
        if rows is not None:
            for z, nrow in enumerate(rows):
                lab[z].reshape(-1)[nrow:] = -1
                tok[z].reshape(-1)[nrow:] = 0
        batches.append({"tokens": tok, "labels": lab})
    return (lora, JAD.AdamWState(mu, nu, count), JAD.SlotHParams(**hp),
            np.asarray(ranks, np.int32), np.asarray(active, np.int32),
            batches)


def _assert_tree_close(t_tree, j_tree, what, **tol):
    for k in j_tree:
        for m in j_tree[k]:
            np.testing.assert_allclose(
                t_tree[k][m].detach().numpy(), np.asarray(j_tree[k][m]),
                err_msg=f"{what} {k}.{m}", **tol)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_matches_jax_over_three_steps(env, name, monkeypatch):
    jcfg, tcfg, jparams, tparams, jstep, _ = env
    ranks, active, rows = STEP_CASES[name]
    bind = ranks is not None
    dense_calls = _spy(monkeypatch, TOPS, "grouped_lora")
    ragged_calls = _spy(monkeypatch, TOPS, "ragged_grouped_lora")
    lora, opt, hp, ranks, active, batches = _step_inputs(
        jcfg, ranks if bind else [R_MAX] * Z, active, rows)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    jo = jax.tree_util.tree_map(jnp.asarray, opt)
    jhp = jax.tree_util.tree_map(jnp.asarray, hp)
    tl = bridge.lora_from_numpy(lora, "cpu")
    to = bridge.adamw_state_from_numpy(opt, "cpu")
    thp = bridge.hparams_from_numpy(hp, "cpu")
    train = TSTEPS.make_train_step(tcfg)
    jrows = _full_rows(None if rows is None else np.asarray(rows, np.int32),
                       Z, ROWS)
    for i, nb in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        tb = {k: _t(v) for k, v in nb.items()}
        if bind:
            jb.update(slot_rows=jnp.asarray(jrows),
                      slot_ranks=jnp.asarray(ranks))
            tb["slot_ranks"] = _t(ranks)
        elif rows is not None:
            jb["slot_rows"] = jnp.asarray(jrows)
        if rows is not None:
            tb["slot_rows"] = _t(np.asarray(rows, np.int32))
        jgrads, (jl, jo, jm) = jstep(jparams, jl, jo, jhp,
                                     jnp.asarray(active), jnp.asarray(ranks),
                                     jb)
        _, tgrads = TSTEPS.lora_grads(tcfg, tparams, tl, tb, _t(active))
        _assert_tree_close(tgrads, jgrads, f"step {i} grad", **GTOL)
        tl, to, tm = train(tparams, tl, to, thp, _t(active), _t(ranks), tb)
        np.testing.assert_allclose(tm["per_slot_loss"].numpy(),
                                   np.asarray(jm["per_slot_loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i} loss")
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]),
                                   err_msg=f"step {i} norm", **GTOL)
    _assert_tree_close(tl, jl, "lora", **GTOL)
    _assert_tree_close(to.mu, jo.mu, "mu", **GTOL)
    np.testing.assert_array_equal(to.count.numpy(), np.asarray(jo.count))
    # the dense Function runs exactly when nothing is bound, the ragged one
    # when slot_rows is bound alone: once per LoRA projection of each
    # forward, and remat runs each forward twice, in lora_grads and in the
    # step, 3 steps
    calls = 3 * 2 * 2 * tcfg.num_layers * len(tcfg.lora.targets)
    ragged = not bind and rows is not None
    assert len(dense_calls) == (0 if bind or ragged else calls)
    assert len(ragged_calls) == (calls if ragged else 0)


def _eval_matches_jax(env, name):
    jcfg, tcfg, jparams, tparams, _, jeval = env
    ranks, active, _ = STEP_CASES[name]
    bind = ranks is not None
    lora, _, _, ranks, active, batches = _step_inputs(
        jcfg, ranks if bind else [R_MAX] * Z, active, None, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    tb = {k: _t(v) for k, v in batches[0].items()}
    if bind:
        jb["slot_ranks"] = jnp.asarray(ranks)
        tb["slot_ranks"] = _t(ranks)
    want = jeval(jparams, jax.tree_util.tree_map(jnp.asarray, lora),
                 jnp.asarray(active), jb)
    got = TSTEPS.make_eval_step(tcfg)(
        tparams, bridge.lora_from_numpy(lora, "cpu"), _t(active), tb)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOSS_RTOL)


def test_eval_step_matches_jax(env):
    _eval_matches_jax(env, "mixed+empty")


def test_dense_eval_step_matches_jax(env, monkeypatch):
    """Every slot at r_max, nothing bound: the port's eval step takes the
    dense Function (once per LoRA projection), the JAX one the dense
    Pallas kernels."""
    calls = _spy(monkeypatch, TOPS, "grouped_lora")
    _eval_matches_jax(env, "dense")
    cfg = env[1]
    assert len(calls) == cfg.num_layers * len(cfg.lora.targets)


def test_adamw_matches_jax_on_identical_gradients():
    """Per-slot clipping (one slot clipped, one unclipped, one with
    clipping off), an inactive slot and the rank re-mask, on identical
    numpy gradients: the same fp32 elementwise ops, bar 1e-6. The
    inactive slot stays bit-for-bit unchanged in the port."""
    cfg = reduced_f32("stablelm-3b", d_model=64, vocab=64)
    ranks, active = [2, 8, 5, 3], [1, 1, 0, 1]
    lora, opt, hp, ranks, active, _ = _step_inputs(cfg, ranks, active, None)
    rng = np.random.default_rng(9)
    grads = {t: {m: rng.standard_normal(x.shape, np.float32) * s
                 for m, x in ab.items()}
             for (t, ab), s in zip(lora.items(), (1.0, 0.01, 3.0, 0.1, 1.0,
                                                  0.2, 0.5))}
    jl, jo = JAD.apply_updates(
        jax.tree_util.tree_map(jnp.asarray, lora), grads,
        jax.tree_util.tree_map(jnp.asarray, opt),
        jax.tree_util.tree_map(jnp.asarray, hp), jnp.asarray(active),
        rank_masker=lambda t: JLORA.mask_lora_tree(t, jnp.asarray(ranks),
                                                   cfg.lora.r_max))
    tl = bridge.lora_from_numpy(lora, "cpu")
    before = {t: {m: x.clone() for m, x in ab.items()} for t, ab in tl.items()}
    tl, to = TAD.apply_updates(
        tl, bridge.lora_from_numpy(grads, "cpu"),
        bridge.adamw_state_from_numpy(opt, "cpu"),
        bridge.hparams_from_numpy(hp, "cpu"), _t(active),
        rank_masker=lambda t: TLORA.mask_lora_tree(t, _t(ranks),
                                                   cfg.lora.r_max))
    tol = dict(rtol=1e-6, atol=1e-6)
    _assert_tree_close(tl, jl, "lora", **tol)
    _assert_tree_close(to.mu, jo.mu, "mu", **tol)
    _assert_tree_close(to.nu, jo.nu, "nu", **tol)
    np.testing.assert_array_equal(to.count.numpy(), np.asarray(jo.count))
    np.testing.assert_allclose(
        TAD.per_slot_global_norm(bridge.lora_from_numpy(grads, "cpu")),
        np.asarray(JAD.per_slot_global_norm(grads)), rtol=1e-6)
    r2 = int(ranks[2])          # the inactive slot, inside its rank
    for t, ab in tl.items():
        assert torch.equal(ab["A"][:, 2, :, :r2], before[t]["A"][:, 2, :, :r2])
        assert torch.equal(ab["B"][:, 2, :r2], before[t]["B"][:, 2, :r2])


# ---------------------------------------------------------------------------
# (d) the padded rank region stays exactly zero without a re-mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", TLORA.BACKENDS)
def test_train_step_pad_region_stays_zero_without_remask(backend):
    """With ``slot_ranks`` bound, the padded rank region of A/B and of the
    moments stays EXACTLY zero across AdamW steps with NO rank re-mask:
    the gradient there is structurally zero (port of
    tests/test_kernels_ranklocal.py's invariant)."""
    cfg = dataclasses.replace(
        tget_arch("paper-llama-tiny").reduced(num_layers=2, d_model=64,
                                              vocab=128), dtype="float32")
    r_max = cfg.lora.r_max
    ranks = torch.tensor([2, r_max], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    params = TM.init_params(cfg, seed=0, device="cpu")
    lt = TLORA.init_lora_tree(gen, cfg, 2, ranks, TM.target_shapes(cfg))
    m = TLORA.rank_mask(ranks, r_max)
    for ab in lt.values():      # nonzero B inside the true rank
        ab["A"] += 0.01 * m[None, :, None, :]
        ab["B"] += 0.01 * m[None, :, :, None]
    opt = TAD.init_state(lt, 2)
    hp = TAD.SlotHParams.broadcast(2, lr=1e-2, wd=0.01, device="cpu")
    active = torch.ones(2, dtype=torch.int32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 8)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens, "slot_ranks": ranks}
    for _ in range(2):
        with TLORA.backend(backend):
            _, grads = TSTEPS.lora_grads(cfg, params, lt, batch, active)
        for t in grads:
            assert float(grads[t]["A"][:, 0, :, 2:].abs().max()) == 0.0
            assert float(grads[t]["B"][:, 0, 2:, :].abs().max()) == 0.0
            assert float(grads[t]["B"][:, 0, :2, :].abs().max()) > 0.0
        lt, opt = TAD.apply_updates(lt, grads, opt, hp, active,
                                    rank_masker=None)
    for t in lt:
        assert float(lt[t]["A"][:, 0, :, 2:].abs().max()) == 0.0
        assert float(lt[t]["B"][:, 0, 2:, :].abs().max()) == 0.0
        assert float(opt.mu[t]["A"][:, 0, :, 2:].abs().max()) == 0.0
        assert float(opt.nu[t]["B"][:, 0, 2:, :].abs().max()) == 0.0


def _tiny_cfg():
    return dataclasses.replace(
        tget_arch("paper-llama-tiny").reduced(num_layers=2, d_model=64,
                                              vocab=128), dtype="float32")


@pytest.mark.parametrize("mode", ["train", "no_grad", "cache"])
def test_forward_checkpoints_every_layer_of_training_forwards_only(
        monkeypatch, mode):
    """``forward`` rematerializes (one ``checkpoint`` per layer) exactly
    when gradients are recorded and no cache is written."""
    cfg = _tiny_cfg()
    params = TM.init_params(cfg, seed=0, device="cpu")
    ranks = torch.tensor([2, 4], dtype=torch.int32)
    gen = torch.Generator().manual_seed(0)
    lt = TLORA.init_lora_tree(gen, cfg, 2, ranks, TM.target_shapes(cfg))
    calls = []
    real = TM.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(TM, "checkpoint", counting)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 8)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens, "slot_ranks": ranks}
    active = torch.ones(2, dtype=torch.int32)
    if mode == "train":
        TSTEPS.lora_grads(cfg, params, lt, batch, active)
    elif mode == "no_grad":
        TSTEPS.make_eval_step(cfg)(params, lt, active, batch)
    else:
        cache = TM.init_cache(cfg, 2, 2, 8, device="cpu")
        with TLORA.slot_ranks(ranks):
            TM.forward(cfg, params, lt, tokens, cache=cache)
    assert len(calls) == (cfg.num_layers if mode == "train" else 0)


def test_train_step_without_remat_is_not_ported(monkeypatch):
    """``remat=False``: the train step's forward runs with no per-layer
    checkpoint, and its losses, gradient norms and updated adapters equal
    the rematerialized step's bit for bit."""
    cfg = _tiny_cfg()
    params = TM.init_params(cfg, seed=0, device="cpu")
    ranks = torch.tensor([2, 4], dtype=torch.int32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 2, 8)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens, "slot_ranks": ranks}
    active = torch.ones(2, dtype=torch.int32)
    calls = []
    real = TM.checkpoint

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(TM, "checkpoint", counting)
    out = {}
    for remat in (True, False):
        gen = torch.Generator().manual_seed(0)
        lt = TLORA.init_lora_tree(gen, cfg, 2, ranks, TM.target_shapes(cfg))
        opt = TAD.init_state(lt, 2)
        hp = TAD.SlotHParams.broadcast(2, lr=1e-2)
        calls.clear()
        lt, opt, m = TSTEPS.make_train_step(cfg, remat=remat)(
            params, lt, opt, hp, active, ranks, batch)
        assert len(calls) == (cfg.num_layers if remat else 0)
        out[remat] = (lt, m)
    (lt1, m1), (lt0, m0) = out[True], out[False]
    assert torch.equal(m1["per_slot_loss"], m0["per_slot_loss"])
    assert torch.equal(m1["grad_norm"], m0["grad_norm"])
    for t in lt1:
        for k in lt1[t]:
            assert torch.equal(lt1[t][k], lt0[t][k]), (t, k)
