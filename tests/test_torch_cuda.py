"""PyTorch port on the card: the grouped-LoRA CUDA kernels (rank-local,
dense and ragged, forward and backward) against their plain PyTorch
versions, the dense kernels bitwise equal to the rank-local ones at full
rank, the ragged kernels bitwise equal to the dense ones at rows = T and to
the rank-local ones at full rank for any rows, the autograd Functions'
backward against autograd through the plain versions, ``lora_delta``
under ``ragged_rows`` alone launching the ragged kernels; and the
flash-attention kernel against its plain version (fp32 and bf16, head dims
16 to 128, windows, Sq < Sk and Sq > Sk with fully masked rows exactly 0),
batch independent bit for bit, its autograd Function's gradients, and the
model's contiguous causal forwards launching it; and the chunked
linear-scan kernel against its plain version in both modes (RWKV with the
bonus, SSD), fp32 and bf16, with an initial state and at the decay clip,
batch independent bit for bit, a planted fault (the bonus dropped) outside
the bar, its autograd Function's gradients, and the rwkv model's scans
launching it; and, at hymba-1.5b's shapes, the bf16 LoRA contractions of
its five projections, flash attention with the window of 1,024 at S 2,048
and the scan in SSD mode at S 2,048, each with a planted fault outside
the bar, and the hybrid model's forwards launching both sequence kernels;
and the grouped-LoRA tile plans (``autotune.PLAN_SET``): the library's
compiled set equals it, every plan gives the default plan's bits in the
three Functions' forward and backward and dense == ragged == rank-local
under it, and the fp32 kernels refuse a plan.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py,
which imports JAX). Without a card the test skips itself.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import lora as LORA
from repro_torch.kernels.grouped_lora import autotune as AT
from repro_torch.kernels.grouped_lora import grouped_lora as GL
from repro_torch.kernels.grouped_lora import ops
from repro_torch.kernels.grouped_lora import ragged as RG
from repro_torch.kernels.grouped_lora import ranklocal as RL
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import ops as FOPS
from repro_torch.kernels.flash_attention import ref as FREF
from repro_torch.kernels.grouped_lora import ref
from repro_torch.kernels.linear_scan import linear_scan as LSK
from repro_torch.kernels.linear_scan import ops as LSOPS
from repro_torch.kernels.linear_scan import ref as LSREF

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


# (Z, T, din, dout, r, rows): a boundary inside a 4-row and a 32-row tile,
# an empty slot, rows = T; the stablelm-3b MLP shapes at the executor's
# b = 4 / b = 2 mix (in units of 16-token sequences)
RAGGED_CASES = [(4, 37, 40, 24, 16, [37, 13, 0, 30]),
                (2, 7, 33, 17, 8, [7, 7]),
                (4, 64, 2560, 6912, 64, [64, 32, 64, 32]),
                (4, 64, 6912, 2560, 64, [64, 30, 0, 64])]


@pytest.mark.cuda
@pytest.mark.parametrize("case", RAGGED_CASES)
def test_cuda_ragged_kernels_match_plain_and_twins_bitwise(case):
    """The six ragged kernels launch once each, agree with their plain
    versions (the rank-local tests' bars; exact zeros past rows[z], the
    base passed through on dead rows), equal the rank-local kernels at
    ranks = r with the same rows bit for bit, and the dense kernels at
    rows = T bit for bit, in fp32 and bf16."""
    _need_card()
    Z, T, din, dout, r, rows_l = case
    full = torch.full((Z,), r, dtype=torch.int32, device="cuda")
    all_rows = torch.full((Z,), T, dtype=torch.int32, device="cuda")
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        x, dy, A, B, scale, _, rows, _ = _bwd_inputs(
            (Z, T, din, dout, r, [r] * Z, rows_l), dt)
        base = torch.randn_like(dy)

        def run(mod, rw, *extra):
            s = mod.xa(x, A, rw, *extra)
            dS = mod.ds(dy, B, scale, rw, *extra)
            return {"xa": s,
                    "sb_add": mod.sb_add(s, B, scale, rw, *extra),
                    "sb_add+base": mod.sb_add(s, B, scale, rw, *extra,
                                              y_base=base),
                    "ds": dS, "dx": mod.dx(dS, A, rw, *extra),
                    "da": mod.da(x, dS, rw, *extra),
                    "db": mod.db(s, dy, scale, rw, *extra)}

        RG.reset_launches()
        RL.reset_launches()
        GL.reset_launches()
        got = run(RG, rows)
        torch.cuda.synchronize()
        assert RG.LAUNCHES == {"xa": 1, "sb_add": 2, "ds": 1, "dx": 1,
                               "da": 1, "db": 1}
        assert set(RL.LAUNCHES.values()) == set(GL.LAUNCHES.values()) == {0}
        twin = run(RL, rows, full)
        s, dS = got["xa"], got["ds"]
        plain = {"xa": ref.ragged_xa_ref(x, A, rows),
                 "sb_add": ref.ragged_sb_add_ref(s, B, scale, rows),
                 "sb_add+base": ref.ragged_sb_add_ref(s, B, scale, rows,
                                                      base),
                 "ds": ref.ragged_ds_ref(dy, B, scale, rows),
                 "dx": ref.ragged_dx_ref(dS, A, rows),
                 "da": ref.ragged_da_ref(x, dS, rows),
                 "db": ref.ragged_db_ref(s, dy, scale, rows)}
        for name, out in got.items():
            assert torch.equal(out, twin[name]), f"{name} {dt} vs rank-local"
            w = plain[name].float()
            fp32_out = name in ("da", "db")
            bar = 1e-4 if (fp32_out and dt == torch.bfloat16) else rtol
            atol = (1e-5 if dt == torch.float32 else 1e-3) * float(
                w.abs().max())
            torch.testing.assert_close(out.float(), w, rtol=bar, atol=atol,
                                       msg=f"{name} {dt}")
        for z, nr in enumerate(rows_l):
            for name in ("xa", "sb_add", "ds", "dx"):
                assert torch.all(got[name][z, nr:] == 0), name
            assert torch.equal(got["sb_add+base"][z, nr:], base[z, nr:])
        # at rows = T the dense kernels, bit for bit
        at_t = run(RG, all_rows)
        dense = {"xa": GL.xa(x, A), "sb_add": GL.sb_add(s, B, scale),
                 "sb_add+base": GL.sb_add(s, B, scale, base),
                 "ds": GL.ds(dy, B, scale), "dx": GL.dx(dS, A),
                 "da": GL.da(x, dS), "db": GL.db(s, dy, scale)}
        for name in ("xa", "ds"):
            assert torch.equal(at_t[name], dense[name]), f"{name} {dt} T"
        # sb_add, dx, da and db read S or dS, which depend on rows: hold
        # them on the same S and dS
        for name, out in (("sb_add", RG.sb_add(s, B, scale, all_rows)),
                          ("sb_add+base", RG.sb_add(s, B, scale, all_rows,
                                                    base)),
                          ("dx", RG.dx(dS, A, all_rows)),
                          ("da", RG.da(x, dS, all_rows)),
                          ("db", RG.db(s, dy, scale, all_rows))):
            assert torch.equal(out, dense[name]), f"{name} {dt} T"


@pytest.mark.cuda
def test_cuda_ragged_function_backward_matches_torch_autograd():
    """One ``ops.ragged_grouped_lora`` forward + backward through the
    ragged kernels against autograd through ``ragged_lora_ref``, in fp32
    (1e-5 relative: sum order only)."""
    _need_card()
    Z, T, din, dout, r, rows_l = RAGGED_CASES[0]
    x, dy, A, B, scale, _, rows, _ = _bwd_inputs(
        (Z, T, din, dout, r, [r] * Z, rows_l), torch.float32, seed=1)
    base = torch.randn_like(dy)
    outs = []
    for fn in (ops.ragged_grouped_lora, ref.ragged_lora_ref):
        leaves = [t.clone().requires_grad_(True) for t in (x, A, B, base)]
        y = fn(leaves[0], leaves[1], leaves[2], scale, rows, leaves[3])
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy)))
    for got, want in zip(*outs):
        torch.testing.assert_close(
            got.detach(), want.detach(), rtol=1e-5,
            atol=1e-5 * float(want.detach().abs().max()))


@pytest.mark.cuda
def test_cuda_lora_delta_ragged_rows_alone_launches_the_ragged_kernels():
    """``ragged_rows`` bound without ``slot_ranks`` on a CUDA tensor takes
    the ragged kernels under the kernel backend (and no other set), and
    agrees with the ``"torch"`` backend's row-masked plain math; with
    nothing bound the dense kernels run."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 1, 8, 16, device="cuda", generator=gen)
    A = torch.randn(2, 16, 8, device="cuda", generator=gen)
    B = torch.randn(2, 8, 12, device="cuda", generator=gen)
    rows = torch.tensor([8, 4], dtype=torch.int32, device="cuda")
    RG.reset_launches()
    RL.reset_launches()
    GL.reset_launches()
    with LORA.ragged_rows(rows):
        y = LORA.lora_delta(x, A, B, 2.0)
        with LORA.backend("torch"):
            want = LORA.lora_delta(x, A, B, 2.0)
    torch.cuda.synchronize()
    assert RG.LAUNCHES["xa"] == RG.LAUNCHES["sb_add"] == 1
    assert set(RL.LAUNCHES.values()) == set(GL.LAUNCHES.values()) == {0}
    torch.testing.assert_close(y, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))
    assert torch.all(y[1, 0, 4:] == 0)
    LORA.lora_delta(x, A, B, 2.0)
    torch.cuda.synchronize()
    assert GL.LAUNCHES["xa"] == GL.LAUNCHES["sb_add"] == 1


# the three sets: (wrapper module, prefix of the plain versions in ref.py)
LORA_SETS = {"dense": (GL, "grouped"), "ragged": (RG, "ragged"),
             "rank-local": (RL, "ranklocal")}


def _contract(fn, x, dy, A, B, scale, s, dS, *counts):
    """xa, ds, da, db, sb_add (without a base, and with dy as its base) and
    dx of one set; ``fn(name)`` is its function ``name`` (a kernel wrapper
    or a plain version), ``counts`` its rows / ranks."""
    return {"xa": fn("xa")(x, A, *counts),
            "ds": fn("ds")(dy, B, scale, *counts),
            "da": fn("da")(x, dS, *counts),
            "db": fn("db")(s, dy, scale, *counts),
            "sb_add": fn("sb_add")(s, B, scale, *counts),
            "sb_add+base": fn("sb_add")(s, B, scale, *counts, y_base=dy),
            "dx": fn("dx")(dS, A, *counts)}


# the outputs of one row per token row: dead rows exactly 0 (sb_add+base:
# the base passes through)
ROW_OUTPUTS = ("xa", "ds", "sb_add", "sb_add+base", "dx")


def _kernels(family):
    mod = LORA_SETS[family][0]
    return lambda name: getattr(mod, name)


def _plain(family):
    prefix = LORA_SETS[family][1]
    return lambda name: getattr(ref, f"{prefix}_{name}_ref")


def _train_inputs(Z, T, din, dout, r, seed=0):
    """bf16 x, dy, S and dS (S and dS from the plain versions), fp32
    masters and per-slot scales on the card."""
    x, dy, A, B, scale, _, _, _ = _bwd_inputs(
        (Z, T, din, dout, r, [r] * Z, None), torch.bfloat16, seed)
    return (x, dy, A, B, scale, ref.grouped_xa_ref(x, A),
            ref.grouped_ds_ref(dy, B, scale))


def _ints(values):
    return torch.tensor(values, dtype=torch.int32, device="cuda")


# (T, din, dout) at r_max 64: a train step's projections of stablelm-3b
# (2560 -> 64 and 6912 -> 64) and of rwkv6-3b's channel mix (2560 / 8960)
# at T = 1,024 rows a slot, and a DPO policy forward's T = 512
TRAIN_SHAPE_CASES = [(1024, 2560, 6912), (1024, 6912, 2560),
                     (1024, 2560, 8960), (1024, 8960, 2560),
                     (512, 2560, 2560)]
# hymba-1.5b's five projections (q/o, k/v, in_proj, gate/up, down) at its
# train step's T = 2 x 2,048 rows a slot: edges of 320, 1,600 and 5,504
# (43 x 128) inside the 128-wide tiles
HYMBA_SHAPE_CASES = [(4096, 1600, 1600), (4096, 1600, 320),
                     (4096, 1600, 6400), (4096, 1600, 5504),
                     (4096, 5504, 1600)]
# the last families' projections at T = 1,024 rows a slot: qwen2-vl-72b's
# q/o, k/v, gate/up and down (29,568 = 231 x 128); mistral-nemo-12b's q and
# o (q_dim 4,096 != d_model 5,120); glm4-9b's k/v (2 KV heads of 128) and
# down (13,696 = 107 x 128); musicgen-medium's gate/up
FAMILY_SHAPE_CASES = [(1024, 8192, 8192), (1024, 8192, 1024),
                      (1024, 8192, 29568), (1024, 29568, 8192),
                      (1024, 5120, 4096), (1024, 4096, 5120),
                      (1024, 4096, 256), (1024, 13696, 4096),
                      (1024, 1536, 6144)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TRAIN_SHAPE_CASES + HYMBA_SHAPE_CASES
                         + FAMILY_SHAPE_CASES)
def test_cuda_bf16_contractions_at_train_shapes(case):
    """bf16 xa, ds, da, db, sb_add (with and without a base) and dx of the
    three sets at the main paths' shapes: each within chip_smoke's bars of
    its plain version (bf16 outputs: one bf16 rounding, 2**-7 relative +
    1e-5 of the largest entry; fp32 dA and dB: 1e-4 relative + 1e-5 of the
    largest), exact zeros past rows[z] and ranks[z] (the base passed
    through), and the sets bitwise equal where they meet."""
    _need_card()
    T, din, dout = case
    Z, r = 4, 64
    x, dy, A, B, scale, s, dS = _train_inputs(Z, T, din, dout, r)
    rows_l, ranks_l = [T, T // 2, T, T // 2 - 3], [4, 8, 16, 33]
    counts = {"dense": (), "ragged": (_ints(rows_l),),
              "rank-local": (_ints(rows_l), _ints(ranks_l))}
    got = {}
    for fam, c in counts.items():
        got[fam] = _contract(_kernels(fam), x, dy, A, B, scale, s, dS, *c)
        want = _contract(_plain(fam), x, dy, A, B, scale, s, dS, *c)
        for name, out in got[fam].items():
            w = want[name].float()
            rtol = 1e-4 if name in ("da", "db") else 2 ** -7
            torch.testing.assert_close(out.float(), w, rtol=rtol,
                                       atol=1e-5 * float(w.abs().max()),
                                       msg=f"{fam} {name} {case}")
    for z in range(Z):
        nr, rk = rows_l[z], ranks_l[z]
        for fam in ("ragged", "rank-local"):
            for name in ROW_OUTPUTS:
                dead = got[fam][name][z, nr:]
                want = dy[z, nr:] if name == "sb_add+base" else 0
                assert torch.all(dead == want), (fam, name)
        for name in ("xa", "ds"):
            assert torch.all(got["rank-local"][name][z, :, rk:] == 0), name
        assert torch.all(got["rank-local"]["da"][z, :, rk:] == 0)
        assert torch.all(got["rank-local"]["db"][z, rk:] == 0)
    # where the sets meet: dense == ragged at rows = T == rank-local at
    # ranks = r_max, and ragged == rank-local at ranks = r_max for any rows
    every, full = _ints([T] * Z), _ints([r] * Z)
    meet = {"ragged at rows = T": _contract(_kernels("ragged"), x, dy, A, B,
                                            scale, s, dS, every),
            "rank-local at r_max": _contract(_kernels("rank-local"), x, dy,
                                             A, B, scale, s, dS, None, full)}
    ragged_full = _contract(_kernels("rank-local"), x, dy, A, B, scale, s,
                            dS, _ints(rows_l), full)
    for name, out in got["dense"].items():
        for label, twin in meet.items():
            assert torch.equal(out, twin[name]), f"dense {name} vs {label}"
        assert torch.equal(got["ragged"][name], ragged_full[name]), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", [c[1:] for c in HYMBA_SHAPE_CASES])
def test_cuda_bf16_contractions_at_hymba_decode_rows(case):
    """hymba-1.5b's serve runs the six contractions' forward pair at T = 4
    decode rows a slot (ranks 8-64), where rank_sum takes its 16 x 64
    tile: at each of the family's five projection shapes the bf16 xa, ds,
    da, db, sb_add (with and without a base) and dx of the three sets are
    within chip_smoke's bars of their plain versions, and the rows of the
    T = 4 call equal the same rows of a T = 1,024 call bit for bit."""
    _need_card()
    din, dout = case
    Z, T, r = 4, 1024, 64
    x, dy, A, B, scale, s, dS = _train_inputs(Z, T, din, dout, r, seed=4)
    ops_ = (x, dy, A, B, scale, s, dS)
    small = [t[:, :4].contiguous() if t.dim() == 3 and t.shape[1] == T
             else t for t in ops_]
    rows_l, ranks_l = [1024, 512, 1024, 3], [8, 16, 32, 64]
    counts = {"dense": (), "ragged": (_ints(rows_l),),
              "rank-local": (_ints(rows_l), _ints(ranks_l))}
    for fam, c in counts.items():
        c4 = tuple(v.clamp(max=4) for v in c[:1]) + c[1:]
        got = _contract(_kernels(fam), *small, *c4)
        want = _contract(_plain(fam), *small, *c4)
        for name, out in got.items():
            w = want[name].float()
            rtol = 1e-4 if name in ("da", "db") else 2 ** -7
            torch.testing.assert_close(out.float(), w, rtol=rtol,
                                       atol=1e-5 * float(w.abs().max()),
                                       msg=f"{fam} {name} {case}")
        big = _contract(_kernels(fam), *ops_, *c)
        for name in ROW_OUTPUTS:
            assert torch.equal(got[name], big[name][:, :4]), (fam, name)


def _shifted(t):
    """``t``'s values in a contiguous tensor whose data starts one element
    past a 16-byte boundary (the kernels' masked scalar loads)."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    return out


INVARIANCE_KINDS = ["rows of T=4 in T=1024", "slot of Z=1 in Z=4",
                    "rows=512 of T=1024 is T=512", "unaligned is aligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", INVARIANCE_KINDS)
def test_cuda_bf16_contractions_invariant(kind):
    """Each output element of bf16 xa, ds, da, db, sb_add (with and without
    a base) and dx has one fp32 summation order, a function of the
    contraction length alone, in all three sets: the rows of a T = 4 call
    equal the same rows of a T = 1,024 call (every output of one row per
    token row); a Z = 1 call equals the same slot inside Z = 4; a
    slot with rows = 512 at T = 1,024 equals a T = 512 call (and the dense
    kernels there); operands that are not 16-byte aligned (the masked
    scalar loads) give the aligned call's bits. All bit for bit."""
    _need_card()
    Z, T, din, dout, r = 4, 1024, 2560, 6912, 64
    x, dy, A, B, scale, s, dS = _train_inputs(Z, T, din, dout, r, seed=3)
    rows_l, ranks_l = [1024, 512, 1024, 512], [64, 13, 32, 64]
    counts = {"dense": (), "ragged": (_ints(rows_l),),
              "rank-local": (_ints(rows_l), _ints(ranks_l))}
    ops_ = (x, dy, A, B, scale, s, dS)
    for fam, c in counts.items():
        run = _kernels(fam)
        big = _contract(run, *ops_, *c)
        if kind == "rows of T=4 in T=1024":
            small = [t[:, :4].contiguous() if t.dim() == 3 and t.shape[1] == T
                     else t for t in ops_]
            c4 = tuple(v.clamp(max=4) for v in c[:1]) + c[1:]
            out = _contract(run, *small, *c4)
            for name in ROW_OUTPUTS:
                assert torch.equal(out[name], big[name][:, :4]), (fam, name)
        elif kind == "slot of Z=1 in Z=4":
            for z in (1, 2):
                one = _contract(run, *(t[z:z + 1].contiguous() for t in ops_),
                                *(v[z:z + 1].contiguous() for v in c))
                for name, out in one.items():
                    assert torch.equal(out[0], big[name][z]), (fam, name, z)
        elif kind == "rows=512 of T=1024 is T=512":
            half = [t[:, :512].contiguous() if t.dim() == 3 and t.shape[1] == T
                    else t for t in ops_]
            c512 = tuple(v.clamp(max=512) for v in c[:1]) + c[1:]
            ref_fam = "ragged" if fam == "dense" else fam
            # a slot of rows = 512 in the T = 1,024 call of this set (the
            # dense set has none: its T = 512 call meets the ragged one's)
            slot = big if fam != "dense" else _contract(
                _kernels(ref_fam), *ops_, *counts[ref_fam])
            out = _contract(run, *half, *c512)
            for name in ROW_OUTPUTS:
                assert torch.equal(out[name][1], slot[name][1][:512]), \
                    (fam, name)
                dead = dy[1, 512:] if name == "sb_add+base" else 0
                assert torch.all(slot[name][1][512:] == dead), (fam, name)
            for name in ("da", "db"):
                assert torch.equal(out[name][1], slot[name][1]), (fam, name)
        else:
            out = _contract(run, *(_shifted(t) if t.dim() == 3 else t
                                   for t in ops_), *c)
            for name in out:
                assert torch.equal(out[name], big[name]), (fam, name)


# (B, Sq, Sk, hd, window): ragged lengths off the 64-row query tile and the
# 64-key (bf16) and 32-key (fp32) key tiles, suffix alignment, fully masked
# rows (Sq > Sk), windows, every instantiated hd
FLASH_CASES = [
    (3, 37, 37, 16, 0),
    (2, 64, 96, 32, 24),
    (4, 100, 40, 64, 0),
    (2, 130, 130, 80, 0),
    (2, 256, 256, 80, 64),
    (1, 72, 72, 16, 17),
    (2, 64, 64, 128, 0),
    (2, 200, 232, 80, 0),
    (3, 136, 100, 128, 48),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(case):
    """One launch per call; fp32 within 1e-5 of the plain version (sum
    order), bf16 within one bf16 rounding; rows that see no key exactly 0;
    the first rows of a batch bitwise equal to a call on them alone."""
    _need_card()
    B, Sq, Sk, hd, window = case
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, hd),
                                                    dtype=np.float32))
               .to("cuda") for S in (Sq, Sk, Sk))
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        qc, kc, vc = q.to(dt), k.to(dt), v.to(dt)
        FA.reset_launches()
        out = FA.flash_attention(qc, kc, vc, window=window)
        torch.cuda.synchronize()
        assert FA.LAUNCHES == {"flash_attention": 1}
        assert out.dtype == dt and out.shape == (B, Sq, hd)
        want = FREF.flash_attention_ref(qc, kc, vc, window=window)
        torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                                   atol=1e-5 * float(want.abs().max()))
        if Sq > Sk:
            assert torch.all(out[:, :Sq - Sk] == 0)
        one = FA.flash_attention(qc[:1].contiguous(), kc[:1].contiguous(),
                                 vc[:1].contiguous(), window=window)
        assert torch.equal(one, out[:1])
    noncausal = FA.flash_attention(q, k, v, causal=False)
    torch.testing.assert_close(
        noncausal, FREF.flash_attention_ref(q, k, v, causal=False),
        rtol=1e-5, atol=1e-5)


# the fused batch-heads of the stablelm-3b paths at S = 256, hd 80: an SFT
# train step (4 slots x 4 sequences x 32 heads), an eval step (x 16) and
# a DPO forward (x 2)
FLASH_PATH_B = [512, 2048, 256]


@pytest.mark.cuda
@pytest.mark.parametrize("B", FLASH_PATH_B)
def test_cuda_flash_attention_bf16_at_path_shapes(B):
    """The bf16 kernel at the shapes the main paths give it, within one
    bf16 rounding of the plain version (2**-7 relative + 1e-5 of the
    largest output), and the first 128 fused heads bitwise equal to a call
    on them alone."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(B)
    q, k, v = (torch.randn(B, 256, 80, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    out = FA.flash_attention(q, k, v)
    want = FREF.flash_attention_ref(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=2 ** -7,
                               atol=1e-5 * float(want.abs().max()))
    head = FA.flash_attention(*(t[:128].contiguous() for t in (q, k, v)))
    assert torch.equal(head, out[:128])


# hymba-1.5b at S 2,048, hd 64, window 1,024: its train step's fused
# batch-heads (4 slots x 2 sequences x 25 heads, K/V repeated to the query
# heads) and an eval step's (x 4)
FLASH_HYMBA_B = [200, 400]


@pytest.mark.cuda
@pytest.mark.parametrize("B", FLASH_HYMBA_B)
def test_cuda_flash_attention_bf16_at_hymba_shapes(B):
    """The bf16 kernel with hymba's window of 1,024 at S 2,048 (the window
    binds for every query past 1,024) within one bf16 rounding of the plain
    version; the plain version with the window one key wider leaves that
    bar; the first 128 fused heads bitwise equal to a call on them
    alone."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(B)
    q, k, v = (torch.randn(B, 2048, 64, device="cuda", generator=gen)
               .bfloat16() for _ in range(3))
    out = FA.flash_attention(q, k, v, window=1024)
    want = FREF.flash_attention_ref(q, k, v, window=1024).float()
    tol = dict(rtol=2 ** -7, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(out.float(), want, **tol)
    wider = FREF.flash_attention_ref(q, k, v, window=1025).float()
    assert not torch.allclose(out.float(), wider, **tol)
    head = FA.flash_attention(*(t[:128].contiguous() for t in (q, k, v)),
                              window=1024)
    assert torch.equal(head, out[:128])


# bf16 at hd 128 on the last families' paths: (B, S, KV groups) of
# qwen2-vl-72b's train check (4 slots x 2 sequences x 64 heads, S 512) and
# sweep (4 x 4 x 64, S 256), and glm4-9b's train step (4 x 4 x 32 heads, S
# 256), whose 2 KV heads are repeated 16 times before the kernel
FLASH_HD128_CASES = [(512, 512, 8), (1024, 256, 8), (512, 256, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_HD128_CASES)
def test_cuda_flash_attention_bf16_at_hd128_family_shapes(case):
    """The bf16 kernel at head dim 128 on K / V repeated from the KV heads,
    as the GQA path hands them over, within one bf16 rounding of the plain
    version; the first 128 fused heads bitwise equal to a call on them
    alone."""
    _need_card()
    B, S, G = case
    gen = torch.Generator(device="cuda").manual_seed(B + S)
    q = torch.randn(B, S, 128, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(B // G, S, 128, device="cuda", generator=gen)
            .bfloat16().repeat_interleave(G, dim=0) for _ in range(2))
    out = FA.flash_attention(q, k, v)
    want = FREF.flash_attention_ref(q, k, v).float()
    torch.testing.assert_close(out.float(), want, rtol=2 ** -7,
                               atol=1e-5 * float(want.abs().max()))
    head = FA.flash_attention(*(t[:128].contiguous() for t in (q, k, v)))
    assert torch.equal(head, out[:128])


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_what_it_does_not_take():
    _need_card()
    q = torch.randn(2, 8, 48, device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, q, q)
    q = torch.randn(2, 8, 64, device="cuda")
    with pytest.raises(TypeError):
        FA.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention(q, q.transpose(0, 1).contiguous().transpose(0, 1),
                           q)


@pytest.mark.cuda
def test_cuda_flash_function_backward_matches_autograd_through_plain():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(4, 70, 80, device="cuda", generator=gen)
               for _ in range(3))
    dy = torch.randn(4, 70, 80, device="cuda", generator=gen)
    outs = []
    for fn in (FOPS.flash_attention, FREF.flash_attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        y = fn(*leaves, window=30)
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_model_forward_launches_flash_per_layer():
    """A training forward and its remat recompute launch the kernel once
    per layer each, an eval forward once per layer, decode never; the
    "torch" backend agrees with it."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import backend as BK
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch("stablelm-3b").reduced(
        num_layers=2, d_model=160, vocab=256), head_dim=80, num_heads=2,
        num_kv_heads=2)
    params = M.init_params(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (2, 2, 40), device="cuda", generator=gen)
    lora = LORA.init_lora_tree(gen, cfg, 2, torch.tensor([4, 8],
                                                         device="cuda"),
                               M.target_shapes(cfg))
    for ab in lora.values():
        ab["A"].requires_grad_(True)
    FA.reset_launches()
    h, _, _ = M.forward(cfg, params, lora, tokens)
    h.float().sum().backward()
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == 2 * cfg.num_layers
    FA.reset_launches()
    with torch.no_grad():
        h1, _, _ = M.forward(cfg, params, lora, tokens)
        with BK.backend("torch"):
            h2, _, _ = M.forward(cfg, params, lora, tokens)
        cache = M.init_cache(cfg, 2, 2, 64, per_lane=True)
        M.decode_step(cfg, params, lora, cache, tokens[:, :, 0])
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == cfg.num_layers
    torch.testing.assert_close(h1.float(), h2.float(), rtol=0.05, atol=0.05)


# (B, S, K, V, chunk, decay_on_query, initial state, decay): small edges, an
# rwkv6-3b head (K = V = 64, chunk 128) at the decay clip -e^4 and with the
# even channels at the clip and the odd ones near 0, a chunk of 40 (blocks
# of 16, 16 and 8 tokens in the kernel's pivoted form), a hymba SSD head
# (K = 16), and V = 128 at chunk 128 (more rows of y than the kernel's y
# group holds in registers: its general path)
SCAN_CASES = [
    (3, 32, 16, 8, 8, False, True, 1.0),
    (2, 24, 8, 12, 12, True, False, 1.0),
    (5, 42, 4, 4, 21, False, False, 6.0),     # C not a multiple of 4
    (8, 256, 64, 64, 128, False, False, "clip"),
    (8, 256, 64, 64, 128, False, False, "mixed"),
    (8, 256, 64, 64, 128, False, True, 1.0),
    (4, 200, 64, 64, 40, False, True, 1.0),   # C not a multiple of 16
    (6, 256, 16, 64, 128, True, True, 1.0),
    (3, 256, 16, 128, 128, False, True, 1.0),
]


def _scan_inputs(case, dt, seed=0):
    B, S, K, V, chunk, doq, with_s0, decay = case
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k = (torch.randn(B, S, K, device="cuda", generator=gen).to(dt)
            for _ in range(2))
    v = torch.randn(B, S, V, device="cuda", generator=gen).to(dt)
    if decay == "clip":
        logw = torch.full((B, S, K), -float(np.exp(4.0)), device="cuda")
    elif decay == "mixed":
        logw = -1e-3 * torch.exp(torch.randn(B, S, K, device="cuda",
                                             generator=gen))
        logw[..., 0::2] = -float(np.exp(4.0))
    else:
        logw = -decay * torch.exp(torch.randn(B, S, K, device="cuda",
                                              generator=gen))
    bonus = None if doq else 0.3 * torch.randn(B, K, device="cuda",
                                               generator=gen)
    s0 = (torch.randn(B, K, V, device="cuda", generator=gen) if with_s0
          else None)
    return (q, k, v, logw), dict(bonus=bonus, decay_on_query=doq,
                                 initial_state=s0, chunk=chunk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_CASES)
def test_cuda_linear_scan_matches_plain(case):
    """One launch per call; y within one bf16 rounding of the plain
    version (fp32: 1e-5), the final state within 1e-5; the first rows of
    a batch bitwise equal to a call on them alone; with the bonus dropped
    from the plain version the RWKV cases leave the bar."""
    _need_card()
    for dt, rtol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)):
        args, kw = _scan_inputs(case, dt)
        LSK.reset_launches()
        y, st = LSK.linear_scan(*args, **kw)
        torch.cuda.synchronize()
        assert LSK.LAUNCHES == {"linear_scan": 1}
        assert y.dtype == dt and st.dtype == torch.float32
        assert bool(torch.isfinite(y).all())
        wy, ws = LSREF.linear_scan_ref(*args, **kw)
        torch.testing.assert_close(y.float(), wy.float(), rtol=rtol,
                                   atol=1e-5 * float(wy.abs().max()))
        torch.testing.assert_close(st, ws, rtol=1e-5,
                                   atol=1e-5 * float(ws.abs().max()))
        head = [t[:2].contiguous() for t in args]
        hkw = {k_: (v_[:2].contiguous() if torch.is_tensor(v_) else v_)
               for k_, v_ in kw.items()}
        y2, s2 = LSK.linear_scan(*head, **hkw)
        assert torch.equal(y2, y[:2]) and torch.equal(s2, st[:2])
        if kw["bonus"] is not None:
            fy, _ = LSREF.linear_scan_ref(*args, **dict(kw, bonus=None))
            assert not torch.allclose(y.float(), fy.float(), rtol=rtol,
                                      atol=1e-5 * float(fy.abs().max()))


# hymba-1.5b's Mamba heads in SSD mode at S 2,048 (16 chunks of 128; K =
# the state size 16, V = the head size 64, no bonus): its train step's
# rows (4 slots x 2 sequences x 50 heads) and an eval step's (x 4)
SCAN_HYMBA_B = [400, 800]


@pytest.mark.cuda
@pytest.mark.parametrize("B", SCAN_HYMBA_B)
def test_cuda_linear_scan_ssd_at_hymba_shapes(B):
    """The bf16 scan in SSD mode at hymba's shapes within one bf16
    rounding of the plain version (the final state within 1e-5); the plain
    version in RWKV's order (the query reads the state before the token's
    decay and write) leaves that bar; the first 128 rows bitwise equal to
    a call on them alone."""
    _need_card()
    args, kw = _scan_inputs((B, 2048, 16, 64, 128, True, False, 1.0),
                            torch.bfloat16, seed=B)
    y, st = LSK.linear_scan(*args, **kw)
    wy, ws = LSREF.linear_scan_ref(*args, **kw)
    tol = dict(rtol=2 ** -7, atol=1e-5 * float(wy.float().abs().max()))
    torch.testing.assert_close(y.float(), wy.float(), **tol)
    torch.testing.assert_close(st, ws, rtol=1e-5,
                               atol=1e-5 * float(ws.abs().max()))
    fy, _ = LSREF.linear_scan_ref(*args, **dict(kw, decay_on_query=False))
    assert not torch.allclose(y.float(), fy.float(), **tol)
    y2, s2 = LSK.linear_scan(*(t[:128].contiguous() for t in args), **kw)
    assert torch.equal(y2, y[:128]) and torch.equal(s2, st[:128])


@pytest.mark.cuda
def test_cuda_linear_scan_refuses_what_it_does_not_take():
    _need_card()
    q = torch.randn(2, 16, 6, device="cuda")
    with pytest.raises(ValueError, match="multiples of 4"):
        LSK.linear_scan(q, q, q, -q.abs(), chunk=8)
    q = torch.randn(2, 16, 8, device="cuda")
    with pytest.raises(TypeError):
        LSK.linear_scan(q.half(), q.half(), q.half(), -q.abs(), chunk=8)
    with pytest.raises(ValueError, match="does not divide"):
        LSK.linear_scan(q, q, q, -q.abs(), chunk=6)
    with pytest.raises(TypeError):
        LSK.linear_scan(q, q, q, -q.abs().double(), chunk=8)
    big = torch.randn(1, 512, 64, device="cuda")
    with pytest.raises(ValueError, match="shared memory"):
        LSK.linear_scan(big, big, big, -big.abs(), chunk=512)


@pytest.mark.cuda
def test_cuda_linear_scan_function_backward_matches_autograd_through_plain():
    """The Function's gradients (autograd through the plain version on the
    saved inputs) equal autograd through the plain version; a None state
    cotangent is accepted."""
    _need_card()
    args, kw = _scan_inputs((3, 64, 16, 16, 32, False, True, 1.0),
                            torch.float32, seed=4)
    gen = torch.Generator(device="cuda").manual_seed(5)
    dy = torch.randn(3, 64, 16, device="cuda", generator=gen)
    outs = []
    for fn in (LSOPS.linear_scan, LSREF.linear_scan_ref):
        leaves = [t.clone().requires_grad_(True) for t in args]
        y, _ = fn(*leaves, **kw)
        outs.append([y] + list(torch.autograd.grad(y, leaves, dy)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got.detach(), want.detach(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_rwkv_model_scans_launch_the_kernel():
    """An rwkv training forward and its remat recompute launch the scan
    kernel once per layer each, an eval forward once per layer, decode
    never; the "torch" backend agrees with the kernel."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import backend as BK
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch("rwkv6-3b").reduced(
        num_layers=2, d_model=128, vocab=256), dtype="float32")
    params = M.init_params(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (2, 2, 32), device="cuda", generator=gen)
    lora = LORA.init_lora_tree(gen, cfg, 2, torch.tensor([4, 8],
                                                         device="cuda"),
                               M.target_shapes(cfg))
    for ab in lora.values():
        ab["A"].requires_grad_(True)
    LSK.reset_launches()
    h, _, _ = M.forward(cfg, params, lora, tokens)
    h.sum().backward()
    torch.cuda.synchronize()
    assert LSK.LAUNCHES["linear_scan"] == 2 * cfg.num_layers
    LSK.reset_launches()
    with torch.no_grad():
        h1, _, _ = M.forward(cfg, params, lora, tokens)
        with BK.backend("torch"):
            h2, _, _ = M.forward(cfg, params, lora, tokens)
        cache = M.init_cache(cfg, 2, 2, 64, per_lane=True)
        M.decode_step(cfg, params, lora, cache, tokens[:, :, 0])
    torch.cuda.synchronize()
    assert LSK.LAUNCHES["linear_scan"] == cfg.num_layers
    torch.testing.assert_close(h1, h2, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_hybrid_model_forwards_launch_flash_and_the_scan():
    """A hymba training forward and its remat recompute launch flash
    attention and the scan once per layer each, an eval forward once per
    layer, decode over a ring cache neither; the "torch" backend agrees
    with the kernels at S 96 past the reduced window of 64."""
    _need_card()
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.models import backend as BK
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_arch("hymba-1.5b").reduced(
        num_layers=2, d_model=128, vocab=256), dtype="float32")
    params = M.init_params(cfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, 256, (2, 2, 96), device="cuda", generator=gen)
    lora = LORA.init_lora_tree(gen, cfg, 2, torch.tensor([4, 8],
                                                         device="cuda"),
                               M.target_shapes(cfg))
    for ab in lora.values():
        ab["A"].requires_grad_(True)
    counts = lambda: {**FA.LAUNCHES, **LSK.LAUNCHES}
    FA.reset_launches()
    LSK.reset_launches()
    h, _, _ = M.forward(cfg, params, lora, tokens)
    h.sum().backward()
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert counts() == {"flash_attention": 2 * L, "linear_scan": 2 * L}
    FA.reset_launches()
    LSK.reset_launches()
    with torch.no_grad():
        h1, _, _ = M.forward(cfg, params, lora, tokens)
        with BK.backend("torch"):
            h2, _, _ = M.forward(cfg, params, lora, tokens)
        cache = M.init_cache(cfg, 2, 2, 64, ring=True, per_lane=True)
        M.decode_step(cfg, params, lora, cache, tokens[:, :, 0])
    torch.cuda.synchronize()
    assert counts() == {"flash_attention": L, "linear_scan": L}
    torch.testing.assert_close(h1, h2, rtol=1e-4, atol=1e-4)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
def test_cuda_compiled_plan_set_is_autotunes():
    _need_card()
    import ctypes
    lib = RL._load()
    out = (ctypes.c_int * 3)()
    got = []
    for i in range(lib.gl_plan_count()):
        assert lib.gl_plan_tiles(i, out) == 0
        got.append(tuple(out))
    assert got == [(p.bm, p.bn, p.br) for p in AT.PLAN_SET]
    assert lib.gl_plan_tiles(len(got), out) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 300])
def test_cuda_tile_plans_are_bitwise_in_the_three_functions(T):
    """Every compiled plan: forward and backward of the dense, ragged and
    rank-local Functions in bf16 equal the default plan's bit for bit, and
    at full rank with every row live the three equal each other."""
    _need_card()
    Z, din, dout, r = 4, 640, 896, 64
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(Z, T, din, generator=g, device="cuda").bfloat16()
    A = torch.randn(Z, din, r, generator=g, device="cuda") / din ** 0.5
    B = torch.randn(Z, r, dout, generator=g, device="cuda") / 8
    dy = torch.randn(Z, T, dout, generator=g, device="cuda").bfloat16()
    scale = torch.tensor([0.5, 1.0, 1.5, 2.0], device="cuda")
    full = torch.full((Z,), r, dtype=torch.int32, device="cuda")
    rows = torch.full((Z,), T, dtype=torch.int32, device="cuda")
    mixed = torch.tensor([8, 16, 33, 64], dtype=torch.int32, device="cuda")
    tail = torch.tensor([T, T // 2, T, 1], dtype=torch.int32, device="cuda")

    def run(fn, plan):
        xs, As, Bs = (t.clone().requires_grad_(True) for t in (x, A, B))
        y = fn(xs, As, Bs, plan)
        y.backward(dy)
        return [y.detach(), xs.grad, As.grad, Bs.grad]

    fns = {"dense": lambda a, b, c, p: ops.grouped_lora(a, b, c, scale,
                                                        plan=p),
           "ragged": lambda a, b, c, p: ops.ragged_grouped_lora(
               a, b, c, scale, rows, plan=p),
           "rank-local": lambda a, b, c, p: ops.ranklocal_grouped_lora(
               a, b, c, scale, full, rows, plan=p),
           "rank-local mixed": lambda a, b, c, p: ops.ranklocal_grouped_lora(
               a, b, c, scale, mixed, tail, plan=p)}
    base = {fam: run(fn, None) for fam, fn in fns.items()}
    for plan in AT.PLAN_SET:
        outs = {fam: run(fn, plan) for fam, fn in fns.items()}
        for fam in fns:
            assert all(torch.equal(a, b) for a, b in zip(outs[fam],
                                                         base[fam])), (
                fam, plan)
        assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in
                   zip(outs["dense"], outs["ragged"], outs["rank-local"]))


@pytest.mark.cuda
def test_cuda_fp32_kernels_refuse_a_plan():
    _need_card()
    x = torch.zeros((2, 8, 64), device="cuda")
    A = torch.zeros((2, 64, 16), device="cuda")
    with pytest.raises(ValueError):
        GL.xa(x, A, plan=AT.PLAN_SET[0])
    with pytest.raises(ValueError):
        RL.xa(x, A, None, torch.full((2,), 16, dtype=torch.int32,
                                     device="cuda"), plan=AT.PLAN_SET[0])
    assert torch.equal(GL.xa(x, A), GL.xa(x, A, plan=None))


_CARD_SHARE = """
import sys, torch, torch.distributed as dist
from repro_torch.launch import collectives as C
rank, init = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
g = dist.group.WORLD
gen = torch.Generator().manual_seed(rank)
for dt in (torch.float32, torch.bfloat16):
    # larger than a workspace, so the chunks are exercised
    n = C.WORKSPACE_BYTES // 2 + 37
    x = torch.randn(2 * n, generator=gen).to(dt)
    card, host = x.to("cuda"), x
    assert C._card_share(g, card) is not None
    assert C._card_share(g, host) is None
    for name, fn in (("gather", lambda t: C._gather(t, 0, g)),
                     ("sum", lambda t: C._sum(t.float(), g).to(dt)),
                     ("max", lambda t: C._sum(t, g, dist.ReduceOp.MAX)),
                     ("scatter", lambda t: C._scatter(t.float(), 0, g)
                      .to(dt))):
        a, b = fn(card).cpu(), fn(host)
        assert torch.equal(a, b), (name, dt, (a - b).abs().max())
C.release_shares()
dist.destroy_process_group()
print("ok")
"""


@pytest.mark.cuda
def test_cuda_card_share_collectives_equal_gloo_on_the_host(tmp_path):
    """Two gloo ranks on one card: the card-memory data path
    (``collectives._CardShare``) gives the host gloo path's bits for an
    all-gather, a sum, a max and a reduce-scatter, in chunks larger than a
    workspace, fp32 and bf16 (the sums taken in fp32 on both paths)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA IPC has no CPU mode)")
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen([sys.executable, "-c", _CARD_SHARE, str(r),
                               init], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and out.strip().endswith("ok"), out
