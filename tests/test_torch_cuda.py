"""PyTorch port on the card: the rank-local grouped-LoRA CUDA kernels
against their plain PyTorch versions.

Imports neither JAX nor the JAX package, so it runs on a machine with a
card and no JAX: ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py,
which imports JAX). Without a card the test skips itself.
"""
import numpy as np
import pytest
import torch

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
        assert RL.LAUNCHES == {"xa": 1, "sb_add": 1}
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
