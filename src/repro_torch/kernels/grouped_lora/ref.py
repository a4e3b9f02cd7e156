"""Plain PyTorch versions of the rank-local grouped-LoRA kernels.

Shapes (slot-stacked, paper §A.1 rank-only padding):
    x:      [Z, T, d_in]      (bf16 on the serving path, fp32 in tests)
    A:      [Z, d_in, r]      fp32 master (cast to x's dtype before use)
    B:      [Z, r, d_out]     fp32 master (cast to x's dtype before use)
    S:      [Z, T, r]         stored in x's dtype between the two kernels
    scale:  [Z] fp32          (alpha / r; paper default alpha=2r => 2.0)
    rows:   [Z] int32         valid token rows per slot (None = all T)
    ranks:  [Z] int32         true rank per slot (0 = empty slot)
    y_base: [Z, T, d_out]     frozen-backbone output for the fused add
    dy:     [Z, T, d_out]     output cotangent, in x's dtype
    dS, dX: [Z, T, r], [Z, T, d_in] in x's dtype; dA, dB fp32

Each function repeats its kernel's arithmetic: operands rounded to x's
dtype, products summed in fp32, S rounded to x's dtype, and
``Y = fp32 acc * scale[z] (+ y_base)`` rounded to x's dtype; backward,
dS = fp32 acc * scale[z] and dX rounded to x's dtype, dA and dB (= fp32 acc
* scale[z]) kept in fp32. Entries past ``ranks[z]`` (rank) or ``rows[z]``
(token row) contribute nothing even when they hold garbage, and the S, dS,
dA and dB entries there are exactly zero. The CUDA
wrappers in ``ranklocal.py`` call these for CPU tensors, and the tests and
``chip_smoke.py`` hold the kernels against them.
"""
from __future__ import annotations

from typing import Optional

import torch


def _keep_rows(Z: int, T: int, rows: Optional[torch.Tensor],
               device) -> torch.Tensor:
    """[Z, T] bool: token row t of slot z is live."""
    t = torch.arange(T, device=device)[None, :]
    if rows is None:
        return t < T
    return t < rows.to(device).reshape(Z, 1)


def _keep_ranks(Z: int, r: int, ranks: torch.Tensor, device) -> torch.Tensor:
    """[Z, r] bool: rank column j of slot z is live."""
    return torch.arange(r, device=device)[None, :] < \
        ranks.to(device).reshape(Z, 1)


def _scaled(y: torch.Tensor, scale: torch.Tensor | float) -> torch.Tensor:
    return y * (scale.float().reshape(-1, 1, 1)
                if isinstance(scale, torch.Tensor) else float(scale))


def ranklocal_xa_ref(x: torch.Tensor, A: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """S = X @ A over rows < rows[z] and rank columns < ranks[z]; every
    other S entry is exactly 0. Returns [Z, T, r] in x's dtype."""
    Z, T, _ = x.shape
    r = A.shape[2]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    xf = torch.where(_keep_rows(Z, T, rows, x.device)[:, :, None],
                     x.float(), zero)
    Af = torch.where(_keep_ranks(Z, r, ranks, x.device)[:, None, :],
                     A.to(x.dtype).float(), zero)
    return torch.bmm(xf, Af).to(x.dtype)


def ranklocal_sb_add_ref(s: torch.Tensor, B: torch.Tensor,
                         scale: torch.Tensor | float,
                         rows: Optional[torch.Tensor], ranks: torch.Tensor,
                         y_base: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Y = (S @ B over rank < ranks[z], rows < rows[z]) * scale[z]
    (+ y_base); dead rows and empty slots give a zero delta (the base
    passes through). Returns [Z, T, d_out] in s's dtype."""
    Z, T, r = s.shape
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    keep_r = _keep_ranks(Z, r, ranks, s.device)
    sf = torch.where(_keep_rows(Z, T, rows, s.device)[:, :, None]
                     & keep_r[:, None, :], s.float(), zero)
    Bf = torch.where(keep_r[:, :, None], B.to(s.dtype).float(), zero)
    y = _scaled(torch.bmm(sf, Bf), scale)
    if y_base is not None:
        y = y + y_base.float()
    return y.to(s.dtype)


def ranklocal_lora_ref(x, A, B, scale, ranks, rows=None,
                       y_base=None) -> torch.Tensor:
    """Rank-local oracle: both kernels' plain versions composed."""
    return ranklocal_sb_add_ref(ranklocal_xa_ref(x, A, rows, ranks), B,
                                scale, rows, ranks, y_base)


def ranklocal_ds_ref(dy: torch.Tensor, B: torch.Tensor, scale,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dS = scale[z] * dY @ B^T with dY rows >= rows[z] and B rows >=
    ranks[z] zeroed. Returns [Z, T, r] in dy's dtype."""
    Z, T, _ = dy.shape
    r = B.shape[1]
    zero = torch.zeros((), dtype=torch.float32, device=dy.device)
    dyf = torch.where(_keep_rows(Z, T, rows, dy.device)[:, :, None],
                      dy.float(), zero)
    Bf = torch.where(_keep_ranks(Z, r, ranks, dy.device)[:, :, None],
                     B.to(dy.dtype).float(), zero)
    return _scaled(torch.bmm(dyf, Bf.transpose(1, 2)), scale).to(dy.dtype)


def ranklocal_dx_ref(ds: torch.Tensor, A: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dX = dS @ A^T with dS rows >= rows[z] and A columns >= ranks[z]
    zeroed. Returns [Z, T, d_in] in ds's dtype."""
    Z, T, r = ds.shape
    zero = torch.zeros((), dtype=torch.float32, device=ds.device)
    keep_r = _keep_ranks(Z, r, ranks, ds.device)
    dsf = torch.where(_keep_rows(Z, T, rows, ds.device)[:, :, None]
                      & keep_r[:, None, :], ds.float(), zero)
    Af = torch.where(keep_r[:, None, :], A.to(ds.dtype).float(), zero)
    return torch.bmm(dsf, Af.transpose(1, 2)).to(ds.dtype)


def ranklocal_da_ref(x: torch.Tensor, ds: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dA = X^T @ dS over rows < rows[z]; columns >= ranks[z] exactly 0.
    Returns [Z, d_in, r] fp32."""
    Z, T, _ = x.shape
    r = ds.shape[2]
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    keep_t = _keep_rows(Z, T, rows, x.device)[:, :, None]
    xf = torch.where(keep_t, x.float(), zero)
    dsf = torch.where(keep_t & _keep_ranks(Z, r, ranks, x.device)[:, None, :],
                      ds.float(), zero)
    return torch.bmm(xf.transpose(1, 2), dsf)


def ranklocal_db_ref(s: torch.Tensor, dy: torch.Tensor, scale,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dB = scale[z] * S^T @ dY over rows < rows[z]; rows >= ranks[z]
    exactly 0. Returns [Z, r, d_out] fp32."""
    Z, T, r = s.shape
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    keep_t = _keep_rows(Z, T, rows, s.device)[:, :, None]
    sf = torch.where(keep_t & _keep_ranks(Z, r, ranks, s.device)[:, None, :],
                     s.float(), zero)
    dyf = torch.where(keep_t, dy.float(), zero)
    return _scaled(torch.bmm(sf.transpose(1, 2), dyf), scale)
