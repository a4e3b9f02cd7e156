"""Rank-local grouped-LoRA kernels: CUDA wrappers and launch counts.

Port of ``src/repro/kernels/grouped_lora/ranklocal.py``'s six kernels:

  * ``xa``     — S = X @ A over rows < rows[z] and rank columns < ranks[z]
                 (``ranklocal.py:xa`` :88 / pallas_call :97);
  * ``sb_add`` — Y = (S @ B over rank < ranks[z]) * scale[z] (+ y_base)
                 (``ranklocal.py:sb_add`` :165 / pallas_call :187);
  * ``ds``     — dS = scale[z] * dY @ B^T (``ranklocal.py:ds`` :231 / :240);
  * ``dx``     — dX = dS @ A^T (``ranklocal.py:dx`` :288 / :297);
  * ``da``     — dA = X^T @ dS, fp32 (``ranklocal.py:da`` :346 / :355);
  * ``db``     — dB = scale[z] * S^T @ dY, fp32 (``ranklocal.py:db``
                 :398 / :407).

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/ranklocal.cu`` (forward)
and ``csrc/ranklocal_bwd.cu`` (backward), compiled by ``nvcc`` — one
process per source, started together — and linked, with the dense kernels
of ``csrc/grouped_lora.cu`` (wrapped in ``grouped_lora.py``) and the
ragged ones of ``csrc/ragged.cu`` (wrapped in ``ragged.py``), into one
shared library with a plain C interface under ``build/`` beside this file
at first use, and called through ``ctypes``. A wrapper takes its plain
PyTorch version (``ref.py``) only for tensors on the CPU; for CUDA tensors
it launches the kernel or raises — there is no fallback. ``LAUNCHES``
counts kernel launches (plain-version calls do not count). Every wrapper of
the three sets takes ``plan=`` (``autotune.TilePlan``; None = each
launcher's default tile): a bf16 tile plan of the compiled set, passed to
the C entry point as its index; an illegal plan raises, and the plain
versions validate a plan and ignore it.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.grouped_lora import autotune as AT
from repro_torch.kernels.grouped_lora import ref
from repro_torch.kernels.nvcc import NVCC_FLAGS, build_library

_HERE = Path(__file__).resolve().parent
# the dense (grouped_lora.py) and ragged (ragged.py) kernels share this
# library and its build
SOURCES = tuple(_HERE / "csrc" / name for name in (
    "ranklocal.cu", "ranklocal_bwd.cu", "grouped_lora.cu", "ragged.cu"))
HEADERS = (_HERE / "csrc" / "ranklocal_common.cuh",
           _HERE.parent / "tensor_core.cuh")
BUILD_DIR = _HERE / "build"

# launches of each kernel since the last ``reset_launches()``
LAUNCHES = {"xa": 0, "sb_add": 0, "ds": 0, "dx": 0, "da": 0, "db": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile ``SOURCES`` (one ``nvcc -c`` per source, all started
    together) and link them into ``build/grouped_lora-<hash>.so``, unless a
    library of the same sources, headers and flags is already there;
    returns its path."""
    return build_library("grouped_lora", SOURCES, HEADERS, BUILD_DIR,
                         NVCC_FLAGS)


_P, _I = ctypes.c_void_p, ctypes.c_int
# argument types of every C entry point in the library (all return int)
_SIGNATURES = {
    "rl_xa": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rl_sb_add": [_P, _P, _P, ctypes.c_float, _P, _P, _P, _P, _I, _I, _I,
                  _I, _I, _I, _P],
    "rl_ds": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rl_dx": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rl_da": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rl_db": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_xa": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_sb_add": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_ds": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_dx": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_da": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_db": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rg_xa": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rg_sb_add": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rg_ds": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rg_dx": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rg_da": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rg_db": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "gl_plan_count": [],
    "gl_plan_tiles": [_I, _P],
}


def _load() -> ctypes.CDLL:
    """The kernel library, built at first use, with its entry points
    typed."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, _I
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_if(err: int, name: str, family: str = "rank-local") -> None:
    if err != 0:
        raise RuntimeError(f"{family} {name} kernel launch failed: CUDA "
                           f"error {err}")


def _on_card(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor of a type the kernels take, False for a CPU
    tensor (the plain version runs); raises for anything else."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: activations must be fp32 or bf16, "
                        f"not {t.dtype}")
    return True


def _plan(plan: Optional[AT.TilePlan], t: torch.Tensor, T: int,
          Z: int) -> int:
    """The C entry points' plan argument for a call on ``t`` (raises for
    an illegal plan, and for a plan on fp32 tensors on the card, whose
    kernels have one tile each); on the CPU the plan is validated and the
    plain version ignores it."""
    idx = AT.plan_index(plan, T, Z)
    if idx >= 0 and t.device.type == "cuda" and t.dtype != torch.bfloat16:
        raise ValueError(f"tile plans select bf16 tiles; {t.dtype} kernels "
                         "have one tile each")
    return idx


def _check_counts(rows: Optional[torch.Tensor], ranks: torch.Tensor, Z: int,
                  device: torch.device) -> None:
    _check("ranks", ranks, torch.int32, (Z,), device)
    if rows is not None:
        _check("rows", rows, torch.int32, (Z,), device)


def xa(x: torch.Tensor, A: torch.Tensor, rows: Optional[torch.Tensor],
       ranks: torch.Tensor, *, plan: Optional[AT.TilePlan] = None
       ) -> torch.Tensor:
    """x: [Z,T,din], A: [Z,din,r] fp32 -> S [Z,T,r] in x's dtype; entries
    past rows[z] / ranks[z] are exactly 0. ``rows=None`` = every row;
    ``plan``: a tile plan of ``autotune.PLAN_SET`` (None = the default)."""
    p = _plan(plan, x, x.shape[1], x.shape[0])
    if not _on_card("xa", x):
        return ref.ranklocal_xa_ref(x, A, rows, ranks)
    Z, T, din = x.shape
    r = A.shape[2]
    _check("x", x, x.dtype, (Z, T, din), x.device)
    _check("A", A, torch.float32, (Z, din, r), x.device)
    _check_counts(rows, ranks, Z, x.device)
    s = torch.empty((Z, T, r), dtype=x.dtype, device=x.device)
    err = _load().rl_xa(x.data_ptr(), A.data_ptr(), s.data_ptr(),
                        _ptr(rows), ranks.data_ptr(), Z, T, din, r,
                        _DTYPE_CODE[x.dtype], p, _stream(x.device))
    _raise_if(err, "xa")
    LAUNCHES["xa"] += 1
    return s


def sb_add(s: torch.Tensor, B: torch.Tensor, scale: torch.Tensor | float,
           rows: Optional[torch.Tensor], ranks: torch.Tensor,
           y_base: Optional[torch.Tensor] = None, *,
           plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """s: [Z,T,r], B: [Z,r,dout] fp32 -> Y [Z,T,dout] in s's dtype;
    ``scale`` is a float for every slot or a [Z] fp32 tensor. Dead rows and
    empty slots (rank 0) give a zero delta: the base passes through."""
    p = _plan(plan, s, s.shape[1], s.shape[0])
    if not _on_card("sb_add", s):
        return ref.ranklocal_sb_add_ref(s, B, scale, rows, ranks, y_base)
    Z, T, r = s.shape
    dout = B.shape[2]
    _check("s", s, s.dtype, (Z, T, r), s.device)
    _check("B", B, torch.float32, (Z, r, dout), s.device)
    _check_counts(rows, ranks, Z, s.device)
    if y_base is not None:
        _check("y_base", y_base, s.dtype, (Z, T, dout), s.device)
    if isinstance(scale, torch.Tensor):
        _check("scale", scale, torch.float32, (Z,), s.device)
        scale_ptr, scale_all = scale.data_ptr(), 0.0
    else:
        scale_ptr, scale_all = None, float(scale)
    y = torch.empty((Z, T, dout), dtype=s.dtype, device=s.device)
    err = _load().rl_sb_add(s.data_ptr(), B.data_ptr(), scale_ptr, scale_all,
                            _ptr(y_base), y.data_ptr(), _ptr(rows),
                            ranks.data_ptr(), Z, T, r, dout,
                            _DTYPE_CODE[s.dtype], p, _stream(s.device))
    _raise_if(err, "sb_add")
    LAUNCHES["sb_add"] += 1
    return y


def ds(dy: torch.Tensor, B: torch.Tensor, scale: torch.Tensor,
       rows: Optional[torch.Tensor], ranks: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """dy: [Z,T,dout] (x's dtype), B: [Z,r,dout] fp32, scale: [Z] fp32 ->
    dS = scale[z] * dY @ B^T [Z,T,r] in dy's dtype; entries past ranks[z]
    / rows[z] are exactly 0."""
    p = _plan(plan, dy, dy.shape[1], dy.shape[0])
    if not _on_card("ds", dy):
        return ref.ranklocal_ds_ref(dy, B, scale, rows, ranks)
    Z, T, dout = dy.shape
    r = B.shape[1]
    _check("dy", dy, dy.dtype, (Z, T, dout), dy.device)
    _check("B", B, torch.float32, (Z, r, dout), dy.device)
    _check("scale", scale, torch.float32, (Z,), dy.device)
    _check_counts(rows, ranks, Z, dy.device)
    out = torch.empty((Z, T, r), dtype=dy.dtype, device=dy.device)
    err = _load().rl_ds(dy.data_ptr(), B.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), _ptr(rows), ranks.data_ptr(), Z, T,
                        dout, r, _DTYPE_CODE[dy.dtype], p,
                        _stream(dy.device))
    _raise_if(err, "ds")
    LAUNCHES["ds"] += 1
    return out


def dx(ds_: torch.Tensor, A: torch.Tensor, rows: Optional[torch.Tensor],
       ranks: torch.Tensor, *, plan: Optional[AT.TilePlan] = None
       ) -> torch.Tensor:
    """ds: [Z,T,r], A: [Z,din,r] fp32 -> dX = dS @ A^T [Z,T,din] in ds's
    dtype; only ranks < ranks[z] and rows < rows[z] contribute."""
    p = _plan(plan, ds_, ds_.shape[1], ds_.shape[0])
    if not _on_card("dx", ds_):
        return ref.ranklocal_dx_ref(ds_, A, rows, ranks)
    Z, T, r = ds_.shape
    din = A.shape[1]
    _check("ds", ds_, ds_.dtype, (Z, T, r), ds_.device)
    _check("A", A, torch.float32, (Z, din, r), ds_.device)
    _check_counts(rows, ranks, Z, ds_.device)
    out = torch.empty((Z, T, din), dtype=ds_.dtype, device=ds_.device)
    err = _load().rl_dx(ds_.data_ptr(), A.data_ptr(), out.data_ptr(),
                        _ptr(rows), ranks.data_ptr(), Z, T, din, r,
                        _DTYPE_CODE[ds_.dtype], p, _stream(ds_.device))
    _raise_if(err, "dx")
    LAUNCHES["dx"] += 1
    return out


def da(x: torch.Tensor, ds_: torch.Tensor, rows: Optional[torch.Tensor],
       ranks: torch.Tensor, *, plan: Optional[AT.TilePlan] = None
       ) -> torch.Tensor:
    """x: [Z,T,din], ds: [Z,T,r] (one dtype) -> dA = X^T @ dS [Z,din,r]
    fp32 over rows < rows[z]; columns past ranks[z] are exactly 0."""
    p = _plan(plan, x, x.shape[1], x.shape[0])
    if not _on_card("da", x):
        return ref.ranklocal_da_ref(x, ds_, rows, ranks)
    Z, T, din = x.shape
    r = ds_.shape[2]
    _check("x", x, x.dtype, (Z, T, din), x.device)
    _check("ds", ds_, x.dtype, (Z, T, r), x.device)
    _check_counts(rows, ranks, Z, x.device)
    out = torch.empty((Z, din, r), dtype=torch.float32, device=x.device)
    err = _load().rl_da(x.data_ptr(), ds_.data_ptr(), out.data_ptr(),
                        _ptr(rows), ranks.data_ptr(), Z, T, din, r,
                        _DTYPE_CODE[x.dtype], p, _stream(x.device))
    _raise_if(err, "da")
    LAUNCHES["da"] += 1
    return out


def db(s: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
       rows: Optional[torch.Tensor], ranks: torch.Tensor, *,
       plan: Optional[AT.TilePlan] = None) -> torch.Tensor:
    """s: [Z,T,r], dy: [Z,T,dout] (one dtype), scale: [Z] fp32 ->
    dB = scale[z] * S^T @ dY [Z,r,dout] fp32 over rows < rows[z]; rows
    past ranks[z] are exactly 0."""
    p = _plan(plan, s, s.shape[1], s.shape[0])
    if not _on_card("db", s):
        return ref.ranklocal_db_ref(s, dy, scale, rows, ranks)
    Z, T, r = s.shape
    dout = dy.shape[2]
    _check("s", s, s.dtype, (Z, T, r), s.device)
    _check("dy", dy, s.dtype, (Z, T, dout), s.device)
    _check("scale", scale, torch.float32, (Z,), s.device)
    _check_counts(rows, ranks, Z, s.device)
    out = torch.empty((Z, r, dout), dtype=torch.float32, device=s.device)
    err = _load().rl_db(s.data_ptr(), dy.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), _ptr(rows), ranks.data_ptr(), Z, T,
                        dout, r, _DTYPE_CODE[s.dtype], p, _stream(s.device))
    _raise_if(err, "db")
    LAUNCHES["db"] += 1
    return out
