"""Plain PyTorch versions of the grouped-LoRA kernels: the dense set
(every slot at full rank, every token row live), the ragged set (full rank,
per-slot token rows) and the rank-local set (per-slot ranks and rows).

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
dA and dB entries there are exactly zero. The dense versions are the same
arithmetic with nothing masked; each ragged version is its dense one on
operands whose dead token rows are zeroed, and each rank-local version
its dense one on operands whose dead rows and rank columns are zeroed. At
rows = T nothing is zeroed, so ragged == dense bit for bit; at ranks = r
the rank masks zero nothing, so rank-local == ragged with the same rows
(== dense at rows = None or T) bit for bit, as the CUDA kernels agree on
the card. The CUDA wrappers in ``grouped_lora.py``, ``ragged.py`` and
``ranklocal.py`` call these for CPU tensors, and the tests and
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


# ---------------------------------------------------------------------------
# dense: grouped_lora.py's kernels
# ---------------------------------------------------------------------------

def grouped_xa_ref(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """S = X @ A, fp32 sums; returns [Z, T, r] in x's dtype."""
    return torch.bmm(x.float(), A.to(x.dtype).float()).to(x.dtype)


def grouped_sb_add_ref(s: torch.Tensor, B: torch.Tensor,
                       scale: torch.Tensor | float,
                       y_base: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Y = (S @ B) * scale[z] (+ y_base), rounded once; returns
    [Z, T, d_out] in s's dtype."""
    y = _scaled(torch.bmm(s.float(), B.to(s.dtype).float()), scale)
    if y_base is not None:
        y = y + y_base.float()
    return y.to(s.dtype)


def grouped_lora_ref(x, A, B, scale, y_base=None) -> torch.Tensor:
    """Dense oracle: both forward kernels' plain versions composed."""
    return grouped_sb_add_ref(grouped_xa_ref(x, A), B, scale, y_base)


def grouped_ds_ref(dy: torch.Tensor, B: torch.Tensor,
                   scale) -> torch.Tensor:
    """dS = scale[z] * dY @ B^T; returns [Z, T, r] in dy's dtype."""
    Bf = B.to(dy.dtype).float()
    return _scaled(torch.bmm(dy.float(), Bf.transpose(1, 2)),
                   scale).to(dy.dtype)


def grouped_dx_ref(ds: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """dX = dS @ A^T; returns [Z, T, d_in] in ds's dtype."""
    Af = A.to(ds.dtype).float()
    return torch.bmm(ds.float(), Af.transpose(1, 2)).to(ds.dtype)


def grouped_da_ref(x: torch.Tensor, ds: torch.Tensor) -> torch.Tensor:
    """dA = X^T @ dS; returns [Z, d_in, r] fp32."""
    return torch.bmm(x.float().transpose(1, 2), ds.float())


def grouped_db_ref(s: torch.Tensor, dy: torch.Tensor,
                   scale) -> torch.Tensor:
    """dB = scale[z] * S^T @ dY; returns [Z, r, d_out] fp32."""
    return _scaled(torch.bmm(s.float().transpose(1, 2), dy.float()), scale)


def _live(keep: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` where ``keep`` holds, exactly 0 elsewhere (garbage, NaN
    included, never reaches a product)."""
    return torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                            device=t.device))


# ---------------------------------------------------------------------------
# ragged: ragged.py's kernels (full rank, per-slot token rows)
# ---------------------------------------------------------------------------

def _live_rows(t: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Z, T, d] ``t`` with token rows >= rows[z] exactly 0."""
    Z, T = t.shape[:2]
    return _live(_keep_rows(Z, T, rows, t.device)[:, :, None], t)


def ragged_xa_ref(x: torch.Tensor, A: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """S = X @ A over rows < rows[z]; S rows past rows[z] are exactly 0.
    Returns [Z, T, r] in x's dtype."""
    return grouped_xa_ref(_live_rows(x, rows), A)


def ragged_sb_add_ref(s: torch.Tensor, B: torch.Tensor,
                      scale: torch.Tensor | float, rows: torch.Tensor,
                      y_base: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Y = (S @ B) * scale[z] (+ y_base) over rows < rows[z]; dead rows
    give a zero delta (0, or the base passed through). Returns
    [Z, T, d_out] in s's dtype."""
    return grouped_sb_add_ref(_live_rows(s, rows), B, scale, y_base)


def ragged_lora_ref(x, A, B, scale, rows, y_base=None) -> torch.Tensor:
    """Ragged oracle: both forward kernels' plain versions composed."""
    return ragged_sb_add_ref(ragged_xa_ref(x, A, rows), B, scale, rows,
                             y_base)


def ragged_ds_ref(dy: torch.Tensor, B: torch.Tensor, scale,
                  rows: torch.Tensor) -> torch.Tensor:
    """dS = scale[z] * dY @ B^T with dY rows >= rows[z] zeroed. Returns
    [Z, T, r] in dy's dtype."""
    return grouped_ds_ref(_live_rows(dy, rows), B, scale)


def ragged_dx_ref(ds: torch.Tensor, A: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """dX = dS @ A^T with dS rows >= rows[z] zeroed. Returns [Z, T, d_in]
    in ds's dtype."""
    return grouped_dx_ref(_live_rows(ds, rows), A)


def ragged_da_ref(x: torch.Tensor, ds: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """dA = X^T @ dS over rows < rows[z]. Returns [Z, d_in, r] fp32."""
    return grouped_da_ref(_live_rows(x, rows), _live_rows(ds, rows))


def ragged_db_ref(s: torch.Tensor, dy: torch.Tensor, scale,
                  rows: torch.Tensor) -> torch.Tensor:
    """dB = scale[z] * S^T @ dY over rows < rows[z]. Returns [Z, r, d_out]
    fp32."""
    return grouped_db_ref(_live_rows(s, rows), _live_rows(dy, rows), scale)


# ---------------------------------------------------------------------------
# rank-local: ranklocal.py's kernels
# ---------------------------------------------------------------------------

def ranklocal_xa_ref(x: torch.Tensor, A: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """S = X @ A over rows < rows[z] and rank columns < ranks[z]; every
    other S entry is exactly 0. Returns [Z, T, r] in x's dtype."""
    Z, T, _ = x.shape
    r = A.shape[2]
    return grouped_xa_ref(
        _live(_keep_rows(Z, T, rows, x.device)[:, :, None], x),
        _live(_keep_ranks(Z, r, ranks, x.device)[:, None, :], A))


def ranklocal_sb_add_ref(s: torch.Tensor, B: torch.Tensor,
                         scale: torch.Tensor | float,
                         rows: Optional[torch.Tensor], ranks: torch.Tensor,
                         y_base: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Y = (S @ B over rank < ranks[z], rows < rows[z]) * scale[z]
    (+ y_base); dead rows and empty slots give a zero delta (the base
    passes through). Returns [Z, T, d_out] in s's dtype."""
    Z, T, r = s.shape
    keep_r = _keep_ranks(Z, r, ranks, s.device)
    return grouped_sb_add_ref(
        _live(_keep_rows(Z, T, rows, s.device)[:, :, None]
              & keep_r[:, None, :], s),
        _live(keep_r[:, :, None], B), scale, y_base)


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
    return grouped_ds_ref(
        _live(_keep_rows(Z, T, rows, dy.device)[:, :, None], dy),
        _live(_keep_ranks(Z, r, ranks, dy.device)[:, :, None], B), scale)


def ranklocal_dx_ref(ds: torch.Tensor, A: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dX = dS @ A^T with dS rows >= rows[z] and A columns >= ranks[z]
    zeroed. Returns [Z, T, d_in] in ds's dtype."""
    Z, T, r = ds.shape
    keep_r = _keep_ranks(Z, r, ranks, ds.device)
    return grouped_dx_ref(
        _live(_keep_rows(Z, T, rows, ds.device)[:, :, None]
              & keep_r[:, None, :], ds),
        _live(keep_r[:, None, :], A))


def ranklocal_da_ref(x: torch.Tensor, ds: torch.Tensor,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dA = X^T @ dS over rows < rows[z]; columns >= ranks[z] exactly 0.
    Returns [Z, d_in, r] fp32."""
    Z, T, _ = x.shape
    r = ds.shape[2]
    keep_t = _keep_rows(Z, T, rows, x.device)[:, :, None]
    return grouped_da_ref(
        _live(keep_t, x),
        _live(keep_t & _keep_ranks(Z, r, ranks, x.device)[:, None, :], ds))


def ranklocal_db_ref(s: torch.Tensor, dy: torch.Tensor, scale,
                     rows: Optional[torch.Tensor],
                     ranks: torch.Tensor) -> torch.Tensor:
    """dB = scale[z] * S^T @ dY over rows < rows[z]; rows >= ranks[z]
    exactly 0. Returns [Z, r, d_out] fp32."""
    Z, T, r = s.shape
    keep_t = _keep_rows(Z, T, rows, s.device)[:, :, None]
    return grouped_db_ref(
        _live(keep_t & _keep_ranks(Z, r, ranks, s.device)[:, None, :], s),
        _live(keep_t, dy), scale)
