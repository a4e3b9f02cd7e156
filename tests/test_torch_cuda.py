"""PyTorch port on the card: the grouped-LoRA CUDA kernels (rank-local and
dense, forward and backward) against their plain PyTorch versions, the
dense kernels bitwise equal to the rank-local ones at full rank, the
autograd Functions' backward against autograd through the plain versions,
and ``lora_delta`` refusing the unported ragged path on the card.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py,
which imports JAX). Without a card the test skips itself.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import lora as LORA
from repro_torch.kernels.grouped_lora import grouped_lora as GL
from repro_torch.kernels.grouped_lora import ops
from repro_torch.kernels.grouped_lora import ranklocal as RL
from repro_torch.kernels.grouped_lora import ref

# (Z, T, din, dout, r, ranks, rows): an empty slot, full r_max, ranks off
# multiples of the 16-wide rank tile, rows < T, ragged T/din/dout
CASES = [
    (4, 13, 40, 24, 16, [0, 16, 5, 9], [13, 7, 13, 1]),
    (3, 8, 32, 48, 8, [8, 3, 0], None),
    (4, 4, 2560, 6912, 64, [8, 16, 32, 64], None),
    (4, 37, 6912, 2560, 64, [0, 13, 33, 64], [37, 36, 20, 0]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_kernels_match_plain(case):
    """Both kernels build, launch once each and agree with their plain
    versions: fp32 within 1e-5 (sum order), bf16 within one bf16 rounding
    (rtol 2**-7); S is exactly 0 past ranks[z] and rows[z], and dead rows
    pass the base through."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    Z, T, din, dout, r, ranks, rows = case
    rng = np.random.default_rng(0)
    dev = "cuda"

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    x = rng.standard_normal((Z, T, din), dtype=np.float32)
    A = t(rng.standard_normal((Z, din, r), dtype=np.float32) / din ** 0.5)
    B = t(rng.standard_normal((Z, r, dout), dtype=np.float32) / r ** 0.5)
    scale = t(rng.uniform(0.5, 2.0, Z).astype(np.float32))
    base = rng.standard_normal((Z, T, dout), dtype=np.float32)
    rk = t(np.asarray(ranks, np.int32))
    rw = None if rows is None else t(np.asarray(rows, np.int32))
    live_rows = rows if rows is not None else [T] * Z
    for dt, rtol, atol in ((torch.float32, 1e-5, 1e-5),
                           (torch.bfloat16, 2 ** -7, 1e-3)):
        xc, bc = t(x).to(dt), t(base).to(dt)
        RL.reset_launches()
        s = RL.xa(xc, A, rw, rk)
        y = RL.sb_add(s, B, scale, rw, rk, bc)
        torch.cuda.synchronize()
        assert RL.LAUNCHES == {"xa": 1, "sb_add": 1, "ds": 0, "dx": 0,
                               "da": 0, "db": 0}
        torch.testing.assert_close(s.float(),
                                   ref.ranklocal_xa_ref(xc, A, rw, rk).float(),
                                   rtol=rtol, atol=atol)
        torch.testing.assert_close(
            y.float(),
            ref.ranklocal_sb_add_ref(s, B, scale, rw, rk, bc).float(),
            rtol=rtol, atol=atol)
        for z in range(Z):
            assert torch.all(s[z, :, ranks[z]:] == 0)
            assert torch.all(s[z, live_rows[z]:] == 0)
            assert torch.equal(y[z, live_rows[z]:], bc[z, live_rows[z]:])


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def _bwd_inputs(case, dt, seed=0):
    """x, dy in ``dt``; fp32 masters with garbage past the true rank; S
    from the plain forward; scale, ranks, rows on the card."""
    Z, T, din, dout, r, ranks, rows = case
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to("cuda")

    x = t(rng.standard_normal((Z, T, din), dtype=np.float32)).to(dt)
    dy = t(rng.standard_normal((Z, T, dout), dtype=np.float32)).to(dt)
    A = t(rng.standard_normal((Z, din, r), dtype=np.float32) / din ** 0.5)
    B = t(rng.standard_normal((Z, r, dout), dtype=np.float32) / r ** 0.5)
    scale = t(rng.uniform(0.5, 2.0, Z).astype(np.float32))
    rk = t(np.asarray(ranks, np.int32))
    rw = None if rows is None else t(np.asarray(rows, np.int32))
    s = ref.ranklocal_xa_ref(x, A, rw, rk)
    return x, dy, A, B, scale, rk, rw, s


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_backward_kernels_match_plain(case):
    """ds/dx/da/db build, launch once each and agree with their plain
    versions: fp32 within 1e-5 relative (sum order); bf16 dS/dX within one
    bf16 rounding (rtol 2**-7); bf16-input dA/dB (fp32 out) within 1e-4
    relative to their largest entry (the same bf16 products summed in
    another order). Entries past ranks[z] / rows[z] are exactly 0."""
    _need_card()
    Z, T, din, dout, r, ranks, rows = case
    live_rows = rows if rows is not None else [T] * Z
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        x, dy, A, B, scale, rk, rw, s = _bwd_inputs(case, dt)
        RL.reset_launches()
        dS = RL.ds(dy, B, scale, rw, rk)
        dX = RL.dx(dS, A, rw, rk)
        dA = RL.da(x, dS, rw, rk)
        dB = RL.db(s, dy, scale, rw, rk)
        torch.cuda.synchronize()
        assert RL.LAUNCHES == {"xa": 0, "sb_add": 0, "ds": 1, "dx": 1,
                               "da": 1, "db": 1}
        want = {"ds": ref.ranklocal_ds_ref(dy, B, scale, rw, rk),
                "dx": ref.ranklocal_dx_ref(dS, A, rw, rk),
                "da": ref.ranklocal_da_ref(x, dS, rw, rk),
                "db": ref.ranklocal_db_ref(s, dy, scale, rw, rk)}
        for name, got in (("ds", dS), ("dx", dX), ("da", dA), ("db", dB)):
            w = want[name].float()
            if name in ("ds", "dx"):
                bar = rtol
                atol = (1e-5 if dt == torch.float32 else 1e-3) * float(
                    w.abs().max())
            else:
                bar = 1e-4
                atol = bar * float(w.abs().max())
            torch.testing.assert_close(got.float(), w, rtol=bar, atol=atol,
                                       msg=f"{name} {dt}")
        assert dA.dtype == dB.dtype == torch.float32
        for z in range(Z):
            assert torch.all(dS[z, :, ranks[z]:] == 0)
            assert torch.all(dS[z, live_rows[z]:] == 0)
            assert torch.all(dX[z, live_rows[z]:] == 0)
            assert torch.all(dA[z, :, ranks[z]:] == 0)
            assert torch.all(dB[z, ranks[z]:] == 0)


@pytest.mark.cuda
def test_cuda_function_backward_matches_torch_autograd():
    """One ``ranklocal_grouped_lora`` forward + backward through the
    kernels against autograd through the plain versions, in fp32 (1e-5
    relative: sum order only)."""
    _need_card()
    case = CASES[3]
    x, dy, A, B, scale, rk, rw, _ = _bwd_inputs(case, torch.float32, seed=1)
    base = torch.randn_like(dy)
    outs = []
    for fn in (ops.ranklocal_grouped_lora, ref.ranklocal_lora_ref):
        leaves = [t.clone().requires_grad_(True) for t in (x, A, B, base)]
        y = fn(leaves[0], leaves[1], leaves[2], scale, rk, rw, leaves[3])
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy)))
    for got, want in zip(*outs):
        torch.testing.assert_close(
            got.detach(), want.detach(), rtol=1e-5,
            atol=1e-5 * float(want.detach().abs().max()))


# (Z, T, din, dout, r): full rank, T/din/dout off every tile multiple, and
# the stablelm-3b MLP shape
DENSE_CASES = [(3, 37, 40, 24, 16), (2, 7, 33, 17, 8),
               (4, 64, 2560, 6912, 64), (4, 64, 6912, 2560, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DENSE_CASES)
def test_cuda_dense_kernels_match_plain_and_ranklocal_bitwise(case):
    """The six dense kernels launch once each, agree with their plain
    versions (the rank-local tests' bars), and equal the rank-local
    kernels at ranks = r, rows = None bit for bit, with and without a
    base, in fp32 and bf16."""
    _need_card()
    Z, T, din, dout, r = case
    full = torch.full((Z,), r, dtype=torch.int32, device="cuda")
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        x, dy, A, B, scale, _, _, _ = _bwd_inputs(
            (Z, T, din, dout, r, [r] * Z, None), dt)
        base = torch.randn_like(dy)
        GL.reset_launches()
        RL.reset_launches()
        s = GL.xa(x, A)
        y = GL.sb_add(s, B, scale, base)
        dS = GL.ds(dy, B, scale)
        got = {"xa": s, "sb_add": y, "ds": dS, "dx": GL.dx(dS, A),
               "da": GL.da(x, dS), "db": GL.db(s, dy, scale)}
        torch.cuda.synchronize()
        assert GL.LAUNCHES == dict.fromkeys(GL.LAUNCHES, 1)
        assert set(RL.LAUNCHES.values()) == {0}
        twin = {"xa": RL.xa(x, A, None, full),
                "sb_add": RL.sb_add(s, B, scale, None, full, base),
                "ds": RL.ds(dy, B, scale, None, full),
                "dx": RL.dx(dS, A, None, full),
                "da": RL.da(x, dS, None, full),
                "db": RL.db(s, dy, scale, None, full)}
        plain = {"xa": ref.grouped_xa_ref(x, A),
                 "sb_add": ref.grouped_sb_add_ref(s, B, scale, base),
                 "ds": ref.grouped_ds_ref(dy, B, scale),
                 "dx": ref.grouped_dx_ref(dS, A),
                 "da": ref.grouped_da_ref(x, dS),
                 "db": ref.grouped_db_ref(s, dy, scale)}
        for name, out in got.items():
            assert torch.equal(out, twin[name]), f"{name} {dt} not bitwise"
            w = plain[name].float()
            fp32_out = name in ("da", "db")
            bar = 1e-4 if (fp32_out and dt == torch.bfloat16) else rtol
            atol = (1e-5 if dt == torch.float32 else 1e-3) * float(
                w.abs().max())
            torch.testing.assert_close(out.float(), w, rtol=bar, atol=atol,
                                       msg=f"{name} {dt}")


@pytest.mark.cuda
def test_cuda_dense_function_backward_matches_torch_autograd():
    """One ``ops.grouped_lora`` forward + backward through the dense
    kernels against autograd through ``grouped_lora_ref``, in fp32 (1e-5
    relative: sum order only)."""
    _need_card()
    Z, T, din, dout, r = DENSE_CASES[0]
    x, dy, A, B, scale, _, _, _ = _bwd_inputs(
        (Z, T, din, dout, r, [r] * Z, None), torch.float32, seed=1)
    base = torch.randn_like(dy)
    outs = []
    for fn in (ops.grouped_lora, ref.grouped_lora_ref):
        leaves = [t.clone().requires_grad_(True) for t in (x, A, B, base)]
        y = fn(leaves[0], leaves[1], leaves[2], scale, leaves[3])
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy)))
    for got, want in zip(*outs):
        torch.testing.assert_close(
            got.detach(), want.detach(), rtol=1e-5,
            atol=1e-5 * float(want.detach().abs().max()))


@pytest.mark.cuda
def test_cuda_lora_delta_refuses_the_unported_ragged_path():
    """``ragged_rows`` bound without ``slot_ranks`` on a CUDA tensor raises
    (its ragged kernels are not ported) under the kernel backend; with
    nothing bound the dense kernels run."""
    _need_card()
    x = torch.randn(2, 1, 8, 16, device="cuda")
    A = torch.randn(2, 16, 8, device="cuda")
    B = torch.randn(2, 8, 12, device="cuda")
    rows = torch.tensor([8, 4], dtype=torch.int32, device="cuda")
    with LORA.ragged_rows(rows), pytest.raises(NotImplementedError,
                                               match="ROADMAP"):
        LORA.lora_delta(x, A, B, 2.0)
    GL.reset_launches()
    LORA.lora_delta(x, A, B, 2.0)
    torch.cuda.synchronize()
    assert GL.LAUNCHES["xa"] == GL.LAUNCHES["sb_add"] == 1
