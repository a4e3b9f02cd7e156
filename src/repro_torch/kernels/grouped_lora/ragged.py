"""Ragged grouped-LoRA kernels: CUDA wrappers and launch counts.

Port of ``src/repro/kernels/grouped_lora/ragged.py``'s six kernels, every
slot at full rank and slot z confined to its first ``rows[z]`` token rows
(the full-rank mixed-width co-location path):

  * ``xa``     — S = X @ A over rows < rows[z] (``ragged.py:xa`` :71 /
                 pallas_call :80);
  * ``sb_add`` — Y = (S @ B) * scale[z] (+ y_base) on live rows, dead rows
                 0 or y_base passed through (``ragged.py:sb_add`` :133 /
                 :152);
  * ``ds``     — dS = scale[z] * dY @ B^T (``ragged.py:ds`` :190 / :198);
  * ``dx``     — dX = dS @ A^T (``ragged.py:dx`` :236 / :244);
  * ``da``     — dA = X^T @ dS, fp32 (``ragged.py:da`` :286 / :295);
  * ``db``     — dB = scale[z] * S^T @ dY, fp32 (``ragged.py:db``
                 :333 / :341).

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/ragged.cu``: the
rank-local kernels' templates with the row tests kept and the rank tests
compiled out, so each output equals the dense kernel's at rows = T and the
rank-local kernel's at ranks = r for any rows, bit for bit. They are built
into the rank-local kernels' library (``ranklocal.build``) and called
through ``ctypes``. A wrapper takes its plain PyTorch version (``ref.py``)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. ``LAUNCHES`` counts these kernels' launches, apart from the other
two sets' counts.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.grouped_lora import autotune as AT
from repro_torch.kernels.grouped_lora import ranklocal as RL
from repro_torch.kernels.grouped_lora import ref

# launches of each kernel since the last ``reset_launches()``
LAUNCHES = {"xa": 0, "sb_add": 0, "ds": 0, "dx": 0, "da": 0, "db": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launched(err: int, name: str) -> None:
    RL._raise_if(err, name, family="ragged")
    LAUNCHES[name] += 1


def xa(x: torch.Tensor, A: torch.Tensor, rows: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """x: [Z,T,din], A: [Z,din,r] fp32, rows: [Z] int32 -> S [Z,T,r] in
    x's dtype; rows past rows[z] are exactly 0."""
    p = RL._plan(plan, x, x.shape[1], x.shape[0])
    if not RL._on_card("xa", x):
        return ref.ragged_xa_ref(x, A, rows)
    Z, T, din = x.shape
    r = A.shape[2]
    RL._check("x", x, x.dtype, (Z, T, din), x.device)
    RL._check("A", A, torch.float32, (Z, din, r), x.device)
    RL._check("rows", rows, torch.int32, (Z,), x.device)
    s = torch.empty((Z, T, r), dtype=x.dtype, device=x.device)
    _launched(RL._load().rg_xa(x.data_ptr(), A.data_ptr(), s.data_ptr(),
                               rows.data_ptr(), Z, T, din, r,
                               RL._DTYPE_CODE[x.dtype],
                               p, RL._stream(x.device)), "xa")
    return s


def sb_add(s: torch.Tensor, B: torch.Tensor, scale: torch.Tensor,
           rows: torch.Tensor,
           y_base: Optional[torch.Tensor] = None, *,
           plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """s: [Z,T,r], B: [Z,r,dout] fp32, scale: [Z] fp32, rows: [Z] int32 ->
    Y [Z,T,dout] in s's dtype; dead rows give a zero delta (the base passes
    through)."""
    p = RL._plan(plan, s, s.shape[1], s.shape[0])
    if not RL._on_card("sb_add", s):
        return ref.ragged_sb_add_ref(s, B, scale, rows, y_base)
    Z, T, r = s.shape
    dout = B.shape[2]
    RL._check("s", s, s.dtype, (Z, T, r), s.device)
    RL._check("B", B, torch.float32, (Z, r, dout), s.device)
    RL._check("scale", scale, torch.float32, (Z,), s.device)
    RL._check("rows", rows, torch.int32, (Z,), s.device)
    if y_base is not None:
        RL._check("y_base", y_base, s.dtype, (Z, T, dout), s.device)
    y = torch.empty((Z, T, dout), dtype=s.dtype, device=s.device)
    _launched(RL._load().rg_sb_add(s.data_ptr(), B.data_ptr(),
                                   scale.data_ptr(), RL._ptr(y_base),
                                   y.data_ptr(), rows.data_ptr(), Z, T, r,
                                   dout, RL._DTYPE_CODE[s.dtype],
                                   p, RL._stream(s.device)), "sb_add")
    return y


def ds(dy: torch.Tensor, B: torch.Tensor, scale: torch.Tensor,
       rows: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """dy: [Z,T,dout] (x's dtype), B: [Z,r,dout] fp32, scale: [Z] fp32 ->
    dS = scale[z] * dY @ B^T [Z,T,r] in dy's dtype; rows past rows[z] are
    exactly 0."""
    p = RL._plan(plan, dy, dy.shape[1], dy.shape[0])
    if not RL._on_card("ds", dy):
        return ref.ragged_ds_ref(dy, B, scale, rows)
    Z, T, dout = dy.shape
    r = B.shape[1]
    RL._check("dy", dy, dy.dtype, (Z, T, dout), dy.device)
    RL._check("B", B, torch.float32, (Z, r, dout), dy.device)
    RL._check("scale", scale, torch.float32, (Z,), dy.device)
    RL._check("rows", rows, torch.int32, (Z,), dy.device)
    out = torch.empty((Z, T, r), dtype=dy.dtype, device=dy.device)
    _launched(RL._load().rg_ds(dy.data_ptr(), B.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), rows.data_ptr(), Z, T, dout,
                               r, RL._DTYPE_CODE[dy.dtype],
                               p, RL._stream(dy.device)), "ds")
    return out


def dx(ds_: torch.Tensor, A: torch.Tensor,
       rows: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """ds: [Z,T,r], A: [Z,din,r] fp32 -> dX = dS @ A^T [Z,T,din] in ds's
    dtype; rows past rows[z] are exactly 0."""
    p = RL._plan(plan, ds_, ds_.shape[1], ds_.shape[0])
    if not RL._on_card("dx", ds_):
        return ref.ragged_dx_ref(ds_, A, rows)
    Z, T, r = ds_.shape
    din = A.shape[1]
    RL._check("ds", ds_, ds_.dtype, (Z, T, r), ds_.device)
    RL._check("A", A, torch.float32, (Z, din, r), ds_.device)
    RL._check("rows", rows, torch.int32, (Z,), ds_.device)
    out = torch.empty((Z, T, din), dtype=ds_.dtype, device=ds_.device)
    _launched(RL._load().rg_dx(ds_.data_ptr(), A.data_ptr(), out.data_ptr(),
                               rows.data_ptr(), Z, T, din, r,
                               RL._DTYPE_CODE[ds_.dtype],
                               p, RL._stream(ds_.device)), "dx")
    return out


def da(x: torch.Tensor, ds_: torch.Tensor,
       rows: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """x: [Z,T,din], ds: [Z,T,r] (one dtype) -> dA = X^T @ dS [Z,din,r]
    fp32 over rows < rows[z]."""
    p = RL._plan(plan, x, x.shape[1], x.shape[0])
    if not RL._on_card("da", x):
        return ref.ragged_da_ref(x, ds_, rows)
    Z, T, din = x.shape
    r = ds_.shape[2]
    RL._check("x", x, x.dtype, (Z, T, din), x.device)
    RL._check("ds", ds_, x.dtype, (Z, T, r), x.device)
    RL._check("rows", rows, torch.int32, (Z,), x.device)
    out = torch.empty((Z, din, r), dtype=torch.float32, device=x.device)
    _launched(RL._load().rg_da(x.data_ptr(), ds_.data_ptr(), out.data_ptr(),
                               rows.data_ptr(), Z, T, din, r,
                               RL._DTYPE_CODE[x.dtype],
                               p, RL._stream(x.device)), "da")
    return out


def db(s: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
       rows: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """s: [Z,T,r], dy: [Z,T,dout] (one dtype), scale: [Z] fp32 ->
    dB = scale[z] * S^T @ dY [Z,r,dout] fp32 over rows < rows[z]."""
    p = RL._plan(plan, s, s.shape[1], s.shape[0])
    if not RL._on_card("db", s):
        return ref.ragged_db_ref(s, dy, scale, rows)
    Z, T, r = s.shape
    dout = dy.shape[2]
    RL._check("s", s, s.dtype, (Z, T, r), s.device)
    RL._check("dy", dy, s.dtype, (Z, T, dout), s.device)
    RL._check("scale", scale, torch.float32, (Z,), s.device)
    RL._check("rows", rows, torch.int32, (Z,), s.device)
    out = torch.empty((Z, r, dout), dtype=torch.float32, device=s.device)
    _launched(RL._load().rg_db(s.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), rows.data_ptr(), Z, T, dout,
                               r, RL._DTYPE_CODE[s.dtype],
                               p, RL._stream(s.device)), "db")
    return out
