"""PyTorch port: the grouped-LoRA kernels' plain versions and the port's
``lora_delta`` held against the JAX package.

Inputs come from a numpy seed and go to both packages. On the CPU the port's
wrappers (``ranklocal.*``, ``grouped_lora.*``, ``ragged.*``) take their
plain versions; the JAX side runs the Pallas kernels in interpret mode
(through ``ops._ranklocal_fwd_impl``, ``ops._fwd_impl``, ``ops._bwd_impl``,
``ops._ragged_fwd_impl`` and ``ops._ragged_bwd_impl``, which pad to TPU
tiles and slice back) and the pure-jnp oracle. Tolerance: float32
rtol/atol 5e-4 forward and 2e-3 for gradients, the JAX package's own
backend bars (tests/test_kernel_backends.py). The dense plain versions
equal the rank-local ones at full rank bit for bit, and the ragged ones
equal the dense ones at rows = T and the rank-local ones at full rank for
any rows bit for bit, as the CUDA kernels must on the card; those run only
there (tests/test_torch_cuda.py).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as JLORA
from repro.kernels.grouped_lora import ops as JOPS
from repro.kernels.grouped_lora import ref as JREF
from repro_torch.core import lora as TLORA
from repro_torch.kernels.grouped_lora import grouped_lora as TGL
from repro_torch.kernels.grouped_lora import ops as TOPS
from repro_torch.kernels.grouped_lora import ragged as TRG
from repro_torch.kernels.grouped_lora import ranklocal as TRL
from repro_torch.kernels.grouped_lora import ref as TREF

# the JAX package re-exports its wrapper function under the kernel
# module's name, so the module comes through importlib
JGL = importlib.import_module("repro.kernels.grouped_lora.grouped_lora")
JRG = importlib.import_module("repro.kernels.grouped_lora.ragged")

RTOL = ATOL = 5e-4      # float32 forward bar of the JAX package
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)    # its gradient bar

# (Z, T, din, dout, r, ranks, rows): ranks cover an empty slot (0), full
# r_max and non-multiples of 8; rows < T; T/din/dout off tile multiples
CASES = [
    (4, 13, 40, 24, 16, [0, 16, 5, 9], [13, 7, 13, 1]),
    (3, 8, 32, 48, 8, [8, 3, 0], None),
    (2, 21, 72, 17, 24, [11, 24], [21, 20]),
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small torch ops are slowed down many times over by torch's intra-op
    thread pool when other test processes hold the cores; one thread per
    process keeps a file's time independent of its neighbours'. Restored
    afterwards. The executor and train tests import it too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(case, seed=0, garbage_pad=True):
    Z, T, din, dout, r, ranks, rows = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Z, T, din), dtype=np.float32)
    A = rng.standard_normal((Z, din, r), dtype=np.float32) / din ** 0.5
    B = rng.standard_normal((Z, r, dout), dtype=np.float32) / r ** 0.5
    if not garbage_pad:
        keep = np.arange(r)[None, :] < np.asarray(ranks)[:, None]
        A = A * keep[:, None, :]
        B = B * keep[:, :, None]
    scale = rng.uniform(0.5, 2.0, Z).astype(np.float32)
    base = rng.standard_normal((Z, T, dout), dtype=np.float32)
    ranks = np.asarray(ranks, np.int32)
    rows = None if rows is None else np.asarray(rows, np.int32)
    return x, A, B, scale, ranks, rows, base


def _spy(monkeypatch, module, name):
    """Count the calls of ``module.name`` (still calling through)."""
    calls = []
    real = getattr(module, name)

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)
    monkeypatch.setattr(module, name, spy)
    return calls


def _t(a, dtype=None):
    if a is None:
        return None
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_kernels_match_jax_pallas_interpret(case, with_base):
    x, A, B, scale, ranks, rows, base = _inputs(case)
    T = x.shape[1]
    jrows = (jnp.asarray(rows) if rows is not None
             else jnp.full((x.shape[0],), T, jnp.int32))
    y_j, s_j = JOPS._ranklocal_fwd_impl(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(B), jnp.asarray(scale),
        jnp.asarray(ranks), jrows, jnp.asarray(base) if with_base else None,
        interpret=True)
    s_t = TRL.xa(_t(x), _t(A), _t(rows), _t(ranks))
    y_t = TRL.sb_add(s_t, _t(B), _t(scale), _t(rows), _t(ranks),
                     _t(base) if with_base else None)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j)[:, :, :A.shape[2]],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                               rtol=RTOL, atol=ATOL)
    # against the JAX pure-jnp oracle as well
    y_ref = JREF.ranklocal_lora_ref(
        jnp.asarray(x), jnp.asarray(A), jnp.asarray(B), jnp.asarray(scale),
        jnp.asarray(ranks), None if rows is None else jnp.asarray(rows),
        jnp.asarray(base) if with_base else None)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES)
def test_plain_kernels_exact_zeros_outside_rank_and_rows(case):
    """Garbage in the padded rank region never reaches the output: S is
    exactly 0 past ranks[z] / rows[z], an empty slot's delta is exactly 0,
    and dead rows pass the base through bitwise."""
    x, A, B, scale, ranks, rows, base = _inputs(case)
    s = TRL.xa(_t(x), _t(A), _t(rows), _t(ranks)).numpy()
    y0 = TRL.sb_add(_t(s), _t(B), _t(scale), _t(rows), _t(ranks)).numpy()
    yb = TRL.sb_add(_t(s), _t(B), _t(scale), _t(rows), _t(ranks),
                    _t(base)).numpy()
    T = x.shape[1]
    live_rows = rows if rows is not None else np.full(len(ranks), T)
    for z, rk in enumerate(ranks):
        assert np.all(s[z, :, rk:] == 0.0)
        assert np.all(s[z, live_rows[z]:, :] == 0.0)
        assert np.all(y0[z, live_rows[z]:] == 0.0)
        np.testing.assert_array_equal(yb[z, live_rows[z]:],
                                      base[z, live_rows[z]:])
        if rk == 0:
            assert np.all(y0[z] == 0.0)
            np.testing.assert_array_equal(yb[z], base[z])


def test_plain_kernels_bf16_round_where_the_jax_kernels_do():
    """bf16 activations: A/B rounded to bf16, fp32 sums, S stored in bf16,
    Y = fp32 acc * scale rounded once — the JAX kernels' rounding points.
    The two sides may differ by one bf16 rounding of S or Y (fp32 sums in
    another order), so the bar is 2 bf16 ulps (rtol 2**-7) plus 1e-2."""
    x, A, B, scale, ranks, rows, base = _inputs(CASES[0])
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y_j, s_j = JOPS._ranklocal_fwd_impl(
        xb, jnp.asarray(A), jnp.asarray(B), jnp.asarray(scale),
        jnp.asarray(ranks), jnp.asarray(rows), None, interpret=True)
    xt = _t(np.asarray(xb.astype(jnp.float32)), torch.bfloat16)
    s_t = TRL.xa(xt, _t(A), _t(rows), _t(ranks))
    y_t = TRL.sb_add(s_t, _t(B), _t(scale), _t(rows), _t(ranks))
    assert s_t.dtype == y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(s_t.float().numpy(),
                               np.asarray(s_j.astype(jnp.float32))[:, :, :16],
                               rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)


def test_ops_scale_float_equals_vector_and_counts_no_cpu_launch():
    x, A, B, scale, ranks, rows, base = _inputs(CASES[1])
    TRL.reset_launches()
    y_f = TOPS.ranklocal_grouped_lora(_t(x), _t(A), _t(B), 2.0, _t(ranks))
    y_v = TOPS.ranklocal_grouped_lora(_t(x), _t(A), _t(B),
                                      torch.full((3,), 2.0), _t(ranks))
    assert torch.equal(y_f, y_v)
    assert set(TRL.LAUNCHES.values()) == {0}        # plain versions only


def test_wrappers_refuse_devices_they_cannot_run():
    x = torch.zeros((1, 2, 4), device="meta")
    A = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError):
        TRL.xa(x, A, None, torch.zeros((1,), dtype=torch.int32,
                                       device="meta"))


@pytest.mark.parametrize("case", [CASES[0], CASES[2]])
@pytest.mark.parametrize("rows_bound", [False, True])
def test_lora_delta_under_slot_ranks_matches_jax(case, rows_bound):
    """Port ``lora_delta`` under ``slot_ranks`` (and ``ragged_rows``) vs
    the JAX one on the "pallas_interpret" and "jnp" backends, on
    [Z, b, S, din] activations; the padded rank region holds zeros here,
    as published adapters do."""
    Z, T, din, dout, r, ranks, rows = case
    x, A, B, scale, ranks, rows, _ = _inputs(case, seed=1, garbage_pad=False)
    b, S = 1, T
    x4 = x.reshape(Z, b, S, din)
    jrows = jnp.asarray(rows) if (rows_bound and rows is not None) else None
    trows = _t(rows) if (rows_bound and rows is not None) else None
    outs = {}
    for name in ("pallas_interpret", "jnp"):
        with JLORA.backend(name), JLORA.slot_ranks(jnp.asarray(ranks)), \
                JLORA.ragged_rows(jrows):
            outs[name] = np.asarray(JLORA.lora_delta(
                jnp.asarray(x4), jnp.asarray(A), jnp.asarray(B), 2.0))
    for tb in TLORA.BACKENDS:
        with TLORA.backend(tb), TLORA.slot_ranks(_t(ranks)), \
                TLORA.ragged_rows(trows):
            y = TLORA.lora_delta(_t(x4), _t(A), _t(B), 2.0).numpy()
        for name, ref in outs.items():
            np.testing.assert_allclose(y, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tb} vs jax {name}")
    # no ranks bound: the plain path of the JAX "jnp" backend
    with JLORA.backend("jnp"):
        ref = np.asarray(JLORA.lora_delta(jnp.asarray(x4), jnp.asarray(A),
                                          jnp.asarray(B), 2.0))
    y = TLORA.lora_delta(_t(x4), _t(A), _t(B), 2.0).numpy()
    np.testing.assert_allclose(y, ref, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# dense kernels (grouped_lora.py): every slot at full rank, every row live
# ---------------------------------------------------------------------------

# (Z, T, din, r, dout): the JAX package's own kernel-test shapes
# (tests/test_kernels_grouped_lora.py), aligned and deliberately unaligned
DENSE_SHAPES = [
    (1, 128, 256, 16, 256),
    (2, 64, 96, 8, 80),
    (3, 100, 130, 12, 200),
    (4, 256, 512, 64, 512),
    (8, 32, 64, 128, 64),
    (2, 7, 33, 4, 17),
]


def _dense_inputs(shape, seed=0):
    """x, A, B (fp32 masters), a different scale per slot, y_base and dy."""
    Z, T, din, r, dout = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Z, T, din), dtype=np.float32)
    A = rng.standard_normal((Z, din, r), dtype=np.float32) / din ** 0.5
    B = rng.standard_normal((Z, r, dout), dtype=np.float32) / r ** 0.5
    scale = rng.uniform(0.5, 2.0, Z).astype(np.float32)
    base = rng.standard_normal((Z, T, dout), dtype=np.float32)
    dy = rng.standard_normal((Z, T, dout), dtype=np.float32)
    return x, A, B, scale, base, dy


def _dense_port(x, A, B, scale, base, dy):
    """(S, Y, dS, dX, dA, dB) through the port's dense wrappers."""
    s = TGL.xa(x, A)
    ds = TGL.ds(dy, B, scale)
    return (s, TGL.sb_add(s, B, scale, base), ds, TGL.dx(ds, A),
            TGL.da(x, ds), TGL.db(s, dy, scale))


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_plain_kernels_match_jax_pallas_interpret(shape, with_base):
    """S and Y against ``ops._fwd_impl``, dS against ``grouped_lora.ds``
    and dX/dA/dB against ``ops._bwd_impl``, all in interpret mode."""
    x, A, B, scale, base, dy = _dense_inputs(shape)
    Z, T, din, r, dout = shape
    jx, jA, jB, jsc, jdy = (jnp.asarray(a) for a in (x, A, B, scale, dy))
    jbase = jnp.asarray(base) if with_base else None
    y_j, s_j = JOPS._fwd_impl(jx, jA, jB, jsc, jbase, interpret=True)
    dx_j, dA_j, dB_j = JOPS._bwd_impl(jx, jA, jB, jsc, s_j, jdy,
                                      interpret=True)
    _, _, Bp, _, dyp = JOPS._pad_bwd(jx, jA, jB, s_j, jdy)
    ds_j = JGL.ds(dyp, Bp, jsc, interpret=True)[:, :T, :r]
    TGL.reset_launches()
    s, y, ds, dx, dA, dB = _dense_port(_t(x), _t(A), _t(B), _t(scale),
                                       _t(base) if with_base else None,
                                       _t(dy))
    assert set(TGL.LAUNCHES.values()) == {0}     # CPU: plain versions
    for name, got, want in (("s", s, s_j[:, :, :r]), ("y", y, y_j),
                            ("ds", ds, ds_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for name, got, want in (("dx", dx, dx_j), ("da", dA, dA_j),
                            ("db", dB, dB_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=name, **GRAD_TOL)
    # and the JAX pure-jnp oracles
    np.testing.assert_allclose(
        y.numpy(), np.asarray(JREF.grouped_lora_ref(jx, jA, jB, jsc, jbase)),
        rtol=RTOL, atol=ATOL)
    for got, want in zip((dx, dA, dB), JREF.grouped_lora_bwd_ref(
            jx, jA, jB, jsc, s_j[:, :, :r], jdy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **GRAD_TOL)


def test_dense_plain_kernels_bf16_round_where_the_jax_kernels_do():
    """bf16 activations: A/B rounded to bf16, fp32 sums, S/Y/dS/dX stored
    in bf16, dA/dB fp32. The two sides may differ by one bf16 rounding
    (fp32 sums in another order): 2 bf16 ulps (rtol 2**-7) plus 1e-2;
    dA/dB rtol 1e-4 plus 1e-4 of their largest entry."""
    shape = DENSE_SHAPES[2]
    Z, T, din, r, dout = shape
    x, A, B, scale, base, dy = _dense_inputs(shape, seed=4)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jdy = jnp.asarray(dy).astype(jnp.bfloat16)
    jbase = jnp.asarray(base).astype(jnp.bfloat16)
    jA, jB, jsc = jnp.asarray(A), jnp.asarray(B), jnp.asarray(scale)
    y_j, s_j = JOPS._fwd_impl(jx, jA, jB, jsc, jbase, interpret=True)
    want = [s_j[:, :, :r], y_j, *JOPS._bwd_impl(jx, jA, jB, jsc, s_j, jdy,
                                               interpret=True)]

    def bf16(a):
        return _t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)

    s, y, _, dx, dA, dB = _dense_port(bf16(jx), _t(A), _t(B), _t(scale),
                                      bf16(jbase), bf16(jdy))
    got = [s, y, dx, dA, dB]
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32] * 2
    for name, g, w in zip(("s", "y", "dx", "da", "db"), got, want):
        w = np.asarray(w.astype(jnp.float32))
        tol = (dict(rtol=2 ** -7, atol=1e-2) if g.dtype == torch.bfloat16
               else dict(rtol=1e-4, atol=1e-4 * np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DENSE_SHAPES)
def test_dense_plain_equals_ranklocal_plain_at_full_rank(shape, dtype):
    """Each dense plain version gives, bit for bit, its rank-local plain
    version called with ranks = r and rows = None (and rows = T), the
    CPU side of the co-located == solo contract for a full-rank task."""
    Z, T, din, r, dout = shape
    x, A, B, scale, base, dy = (_t(a) for a in _dense_inputs(shape, seed=2))
    x, base, dy = x.to(dtype), base.to(dtype), dy.to(dtype)
    full = torch.full((Z,), r, dtype=torch.int32)
    s, y, ds, dx, dA, dB = _dense_port(x, A, B, scale, base, dy)
    for rows in (None, torch.full((Z,), T, dtype=torch.int32)):
        want = {"s": TREF.ranklocal_xa_ref(x, A, rows, full),
                "y": TREF.ranklocal_sb_add_ref(s, B, scale, rows, full,
                                               base),
                "ds": TREF.ranklocal_ds_ref(dy, B, scale, rows, full),
                "dx": TREF.ranklocal_dx_ref(ds, A, rows, full),
                "da": TREF.ranklocal_da_ref(x, ds, rows, full),
                "db": TREF.ranklocal_db_ref(s, dy, scale, rows, full)}
        for name, got in zip(("s", "y", "ds", "dx", "da", "db"),
                             (s, y, ds, dx, dA, dB)):
            assert got.dtype == want[name].dtype, name
            assert torch.equal(got, want[name]), name
    assert torch.equal(TOPS.grouped_lora(x, A, B, scale, base),
                       TOPS.ranklocal_grouped_lora(x, A, B, scale, full,
                                                   None, base))


def test_dense_wrappers_refuse_devices_they_cannot_run():
    x = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError):
        TGL.xa(x, torch.zeros((1, 4, 8), device="meta"))
    with pytest.raises(ValueError):
        TGL.ds(torch.zeros((1, 2, 4), device="meta"),
               torch.zeros((1, 8, 4), device="meta"),
               torch.ones((1,), device="meta"))


@pytest.mark.parametrize("shape", [DENSE_SHAPES[1], DENSE_SHAPES[5]])
def test_lora_delta_unbound_takes_the_dense_path_and_matches_jax(
        shape, monkeypatch):
    """With nothing bound, the port's ``"kernel"`` backend goes through
    ``ops.grouped_lora`` (the dense Function) and matches the JAX
    ``lora_delta`` on its ``"pallas_interpret"`` backend (the dense Pallas
    kernels) and its ``"jnp"`` backend, on [Z, b, S, din] activations."""
    Z, T, din, r, dout = shape
    x, A, B, scale, _, _ = _dense_inputs(shape, seed=3)
    x4 = x.reshape(Z, 1, T, din)
    calls = _spy(monkeypatch, TOPS, "grouped_lora")
    y = TLORA.lora_delta(_t(x4), _t(A), _t(B), _t(scale)).numpy()
    assert calls == [1]
    for name in ("pallas_interpret", "jnp"):
        with JLORA.backend(name):
            want = np.asarray(JLORA.lora_delta(
                jnp.asarray(x4), jnp.asarray(A), jnp.asarray(B),
                jnp.asarray(scale)))
        np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# ragged kernels (ragged.py): every slot at full rank, per-slot token rows
# ---------------------------------------------------------------------------

# (Z, T, din, r, dout, rows): a boundary inside a tile, an empty slot, a
# one-row slot, rows = T, and T/din/dout off tile multiples
RAGGED_SHAPES = [
    (4, 37, 40, 16, 24, [37, 13, 0, 30]),
    (2, 7, 33, 4, 17, [7, 7]),
    (3, 100, 130, 12, 200, [100, 64, 1]),
]


def _ragged_inputs(shape, seed=0):
    """x, A, B, scale, y_base, dy (numpy, fp32) and rows (int32)."""
    *dims, rows = shape
    return (*_dense_inputs(tuple(dims), seed), np.asarray(rows, np.int32))


def _ragged_port(x, A, B, scale, base, dy, rows):
    """(S, Y, dS, dX, dA, dB) through the port's ragged wrappers."""
    s = TRG.xa(x, A, rows)
    ds = TRG.ds(dy, B, scale, rows)
    return (s, TRG.sb_add(s, B, scale, rows, base), ds, TRG.dx(ds, A, rows),
            TRG.da(x, ds, rows), TRG.db(s, dy, scale, rows))


def _ragged_jax(x, A, B, scale, base, dy, rows):
    """(S, Y, dS, dX, dA, dB) of the JAX ragged VJP, interpret mode."""
    T, r = x.shape[1], A.shape[2]
    jx, jA, jB, jsc, jdy, jrows = (jnp.asarray(a)
                                   for a in (x, A, B, scale, dy, rows))
    jbase = None if base is None else jnp.asarray(base)
    y, s = JOPS._ragged_fwd_impl(jx, jA, jB, jsc, jrows, jbase,
                                 interpret=True)
    dx, dA, dB = JOPS._ragged_bwd_impl(jx, jA, jB, jsc, jrows, s, jdy,
                                       interpret=True)
    _, _, Bp, _, dyp = JOPS._pad_bwd(jx, jA, jB, s, jdy)
    ds = JRG.ds(dyp, Bp, jsc, jrows, interpret=True)[:, :T, :r]
    return s[:, :, :r], y, ds, dx, dA, dB


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_plain_kernels_match_jax_pallas_interpret(shape, with_base):
    """The six ragged plain versions against the JAX ragged kernels in
    interpret mode (S, Y through ``ops._ragged_fwd_impl``, dS through
    ``ragged.ds``, dX/dA/dB through ``ops._ragged_bwd_impl``) and the
    JAX pure-jnp oracles; exact zeros past rows[z], the base passed
    through bit for bit on dead rows."""
    x, A, B, scale, base, dy, rows = _ragged_inputs(shape)
    base = base if with_base else None
    want = _ragged_jax(x, A, B, scale, base, dy, rows)
    TRG.reset_launches()
    got = _ragged_port(_t(x), _t(A), _t(B), _t(scale), _t(base), _t(dy),
                       _t(rows))
    assert set(TRG.LAUNCHES.values()) == {0}     # CPU: plain versions
    for name, g, w in zip(("s", "y", "ds", "dx", "da", "db"), got, want):
        tol = GRAD_TOL if name in ("dx", "da", "db") else dict(rtol=RTOL,
                                                                atol=ATOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **tol)
    jargs = [jnp.asarray(a) for a in (x, A, B, scale)]
    np.testing.assert_allclose(
        got[1].numpy(), np.asarray(JREF.ragged_lora_ref(
            *jargs, jnp.asarray(rows), None if base is None
            else jnp.asarray(base))), rtol=RTOL, atol=ATOL)
    for g, w in zip(got[3:], JREF.ragged_lora_bwd_ref(
            *jargs, jnp.asarray(rows), jnp.asarray(got[0].numpy()),
            jnp.asarray(dy))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    s, y, ds, dx, _, _ = (g.numpy() for g in got)
    for z, nr in enumerate(rows):
        assert np.all(s[z, nr:] == 0) and np.all(ds[z, nr:] == 0)
        assert np.all(dx[z, nr:] == 0)
        if base is None:
            assert np.all(y[z, nr:] == 0)
        else:
            np.testing.assert_array_equal(y[z, nr:], base[z, nr:])


def test_ragged_plain_kernels_bf16_round_where_the_jax_kernels_do():
    """bf16 activations, with a base: A/B rounded to bf16, fp32 sums,
    S/Y/dS/dX stored in bf16, dA/dB fp32. The two sides may differ by one
    bf16 rounding (fp32 sums in another order): 2 bf16 ulps (rtol 2**-7)
    plus 1e-2; dA/dB rtol 1e-4 plus 1e-4 of their largest entry."""
    x, A, B, scale, base, dy, rows = _ragged_inputs(RAGGED_SHAPES[2], seed=4)

    def bf(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                          .astype(jnp.float32))

    x, base, dy = bf(x), bf(base), bf(dy)
    jx, jbase, jdy = (jnp.asarray(a).astype(jnp.bfloat16)
                      for a in (x, base, dy))
    want = _ragged_jax(jx, A, B, scale, jbase, jdy, rows)
    got = _ragged_port(_t(x).to(torch.bfloat16), _t(A), _t(B), _t(scale),
                       _t(base).to(torch.bfloat16),
                       _t(dy).to(torch.bfloat16), _t(rows))
    assert [g.dtype for g in got] == [torch.bfloat16] * 4 + [torch.float32] * 2
    for name, g, w in zip(("s", "y", "ds", "dx", "da", "db"), got, want):
        w = np.asarray(jnp.asarray(w).astype(jnp.float32))
        tol = (dict(rtol=2 ** -7, atol=1e-2) if g.dtype == torch.bfloat16
               else dict(rtol=1e-4, atol=1e-4 * np.abs(w).max()))
        np.testing.assert_allclose(g.float().numpy(), w, err_msg=name, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", RAGGED_SHAPES)
def test_ragged_plain_equals_dense_at_full_rows_and_ranklocal_at_full_rank(
        shape, dtype):
    """Each ragged plain version gives, bit for bit, its dense plain
    version at rows = T, and its rank-local plain version at ranks = r
    with the same rows (and at rows = T): the CPU side of the three-way
    co-located == solo contract for a full-rank task."""
    Z, T, din, r, dout, _ = shape
    x, A, B, scale, base, dy, rows = (_t(a) for a in _ragged_inputs(
        shape, seed=2))
    x, base, dy = x.to(dtype), base.to(dtype), dy.to(dtype)
    full = torch.full((Z,), r, dtype=torch.int32)
    every = torch.full((Z,), T, dtype=torch.int32)
    names = ("s", "y", "ds", "dx", "da", "db")
    dense = _dense_port(x, A, B, scale, base, dy)
    for got, want in zip(_ragged_port(x, A, B, scale, base, dy, every),
                         dense):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for rw in (rows, every):
        got = _ragged_port(x, A, B, scale, base, dy, rw)
        s, ds = got[0], got[2]
        twin = (TREF.ranklocal_xa_ref(x, A, rw, full),
                TREF.ranklocal_sb_add_ref(s, B, scale, rw, full, base),
                TREF.ranklocal_ds_ref(dy, B, scale, rw, full),
                TREF.ranklocal_dx_ref(ds, A, rw, full),
                TREF.ranklocal_da_ref(x, ds, rw, full),
                TREF.ranklocal_db_ref(s, dy, scale, rw, full))
        for name, g, w in zip(names, got, twin):
            assert g.dtype == w.dtype and torch.equal(g, w), name
        assert torch.equal(
            TOPS.ragged_grouped_lora(x, A, B, scale, rw, base),
            TOPS.ranklocal_grouped_lora(x, A, B, scale, full, rw, base))
    assert torch.equal(TOPS.ragged_grouped_lora(x, A, B, scale, every, base),
                       TOPS.grouped_lora(x, A, B, scale, base))


def test_lora_delta_ragged_rows_alone_stays_plain_math_on_the_cpu(
        monkeypatch):
    """``ragged_rows`` bound without ``slot_ranks`` (the full-rank
    mixed-width path): the port's ``"kernel"`` backend goes through
    ``ops.ragged_grouped_lora`` (the ragged Function, whose wrappers take
    their plain versions on CPU tensors) and neither of the other two,
    and both port backends match the JAX ``lora_delta`` under
    ``ragged_rows`` on its ``"pallas_interpret"`` backend (the ragged
    Pallas kernels) and its ``"jnp"`` backend, on [Z, b, S, din]
    activations. A tensor on a device the kernels cannot run on is
    refused, not computed there."""
    Z, T, din, dout, r, _, rows = CASES[0]
    x, A, B, _, _, rows, _ = _inputs(CASES[0], seed=6)
    x4 = x.reshape(Z, 1, T, din)
    calls = {name: _spy(monkeypatch, TOPS, name) for name in (
        "ragged_grouped_lora", "grouped_lora", "ranklocal_grouped_lora")}
    want = {}
    for name in ("pallas_interpret", "jnp"):
        with JLORA.backend(name), JLORA.ragged_rows(jnp.asarray(rows)):
            want[name] = np.asarray(JLORA.lora_delta(
                jnp.asarray(x4), jnp.asarray(A), jnp.asarray(B), 2.0))
    for tb in TLORA.BACKENDS:
        with TLORA.backend(tb), TLORA.ragged_rows(_t(rows)):
            y = TLORA.lora_delta(_t(x4), _t(A), _t(B), 2.0).numpy()
        for name, w in want.items():
            np.testing.assert_allclose(y, w, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tb} vs jax {name}")
    assert {k: len(v) for k, v in calls.items()} == {
        "ragged_grouped_lora": 1, "grouped_lora": 0,
        "ranklocal_grouped_lora": 0}
    with TLORA.ragged_rows(_t(rows)), pytest.raises(ValueError):
        TLORA.lora_delta(torch.zeros(x4.shape, device="meta"),
                         torch.zeros(A.shape, device="meta"),
                         torch.zeros(B.shape, device="meta"), 2.0)
