"""PyTorch port: the rank-local grouped-LoRA forward kernels' plain versions
and the port's ``lora_delta`` held against the JAX package.

Inputs come from a numpy seed and go to both packages. On the CPU the port's
wrappers (``ranklocal.xa`` / ``ranklocal.sb_add``) take their plain
versions; the JAX side runs the Pallas kernels in interpret mode (through
``ops._ranklocal_fwd_impl``, which pads to TPU tiles and slices back) and
the pure-jnp oracle. Tolerance: float32 rtol/atol 5e-4, the JAX package's
own backend bar (tests/test_kernel_backends.py). The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as JLORA
from repro.kernels.grouped_lora import ops as JOPS
from repro.kernels.grouped_lora import ref as JREF
from repro_torch.core import lora as TLORA
from repro_torch.kernels.grouped_lora import ops as TOPS
from repro_torch.kernels.grouped_lora import ranklocal as TRL

RTOL = ATOL = 5e-4      # float32 forward bar of the JAX package

# (Z, T, din, dout, r, ranks, rows): ranks cover an empty slot (0), full
# r_max and non-multiples of 8; rows < T; T/din/dout off tile multiples
CASES = [
    (4, 13, 40, 24, 16, [0, 16, 5, 9], [13, 7, 13, 1]),
    (3, 8, 32, 48, 8, [8, 3, 0], None),
    (2, 21, 72, 17, 24, [11, 24], [21, 20]),
]


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
