"""Rank-local grouped-LoRA forward kernels: CUDA wrappers and launch counts.

Port of ``src/repro/kernels/grouped_lora/ranklocal.py``'s forward pair:

  * ``xa``     — S = X @ A over rows < rows[z] and rank columns < ranks[z]
                 (``ranklocal.py:xa`` :88 / pallas_call :97);
  * ``sb_add`` — Y = (S @ B over rank < ranks[z]) * scale[z] (+ y_base)
                 (``ranklocal.py:sb_add`` :165 / pallas_call :187).

The kernels are CUDA C++ for ``sm_90a`` in ``csrc/ranklocal.cu``, compiled
by ``nvcc`` into a shared library with a plain C interface under ``build/``
beside this file at first use, and called through ``ctypes``. A wrapper
takes its plain PyTorch version (``ref.py``) only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises — there is no fallback.
``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.grouped_lora import ref

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "ranklocal.cu",)
BUILD_DIR = _HERE / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# launches of each kernel since the last ``reset_launches()``
LAUNCHES = {"xa": 0, "sb_add": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the rank-local LoRA kernels are "
                           "built from csrc/ at first use on the card")
    return found


def build() -> Path:
    """Compile ``csrc/*.cu`` into ``build/ranklocal-<hash>.so`` unless a
    library of the same sources and flags is already there; returns its
    path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    out = BUILD_DIR / f"ranklocal-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.rl_xa.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
            lib.rl_xa.restype = I
            lib.rl_sb_add.argtypes = [P, P, P, ctypes.c_float, P, P, P, P,
                                      I, I, I, I, I, P]
            lib.rl_sb_add.restype = I
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


def _raise_if(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"rank-local {name} kernel launch failed: CUDA "
                           f"error {err}")


def xa(x: torch.Tensor, A: torch.Tensor, rows: Optional[torch.Tensor],
       ranks: torch.Tensor) -> torch.Tensor:
    """x: [Z,T,din], A: [Z,din,r] fp32 -> S [Z,T,r] in x's dtype; entries
    past rows[z] / ranks[z] are exactly 0. ``rows=None`` = every row."""
    if x.device.type == "cpu":
        return ref.ranklocal_xa_ref(x, A, rows, ranks)
    if x.device.type != "cuda":
        raise ValueError(f"xa: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"xa: activations must be fp32 or bf16, not {x.dtype}")
    Z, T, din = x.shape
    r = A.shape[2]
    _check("x", x, x.dtype, (Z, T, din), x.device)
    _check("A", A, torch.float32, (Z, din, r), x.device)
    _check("ranks", ranks, torch.int32, (Z,), x.device)
    if rows is not None:
        _check("rows", rows, torch.int32, (Z,), x.device)
    s = torch.empty((Z, T, r), dtype=x.dtype, device=x.device)
    err = _load().rl_xa(x.data_ptr(), A.data_ptr(), s.data_ptr(),
                        _ptr(rows), ranks.data_ptr(), Z, T, din, r,
                        _DTYPE_CODE[x.dtype], _stream(x.device))
    _raise_if(err, "xa")
    LAUNCHES["xa"] += 1
    return s


def sb_add(s: torch.Tensor, B: torch.Tensor, scale: torch.Tensor | float,
           rows: Optional[torch.Tensor], ranks: torch.Tensor,
           y_base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """s: [Z,T,r], B: [Z,r,dout] fp32 -> Y [Z,T,dout] in s's dtype;
    ``scale`` is a float for every slot or a [Z] fp32 tensor. Dead rows and
    empty slots (rank 0) give a zero delta: the base passes through."""
    if s.device.type == "cpu":
        return ref.ranklocal_sb_add_ref(s, B, scale, rows, ranks, y_base)
    if s.device.type != "cuda":
        raise ValueError(f"sb_add: unsupported device {s.device}")
    if s.dtype not in _DTYPE_CODE:
        raise TypeError(f"sb_add: activations must be fp32 or bf16, "
                        f"not {s.dtype}")
    Z, T, r = s.shape
    dout = B.shape[2]
    _check("s", s, s.dtype, (Z, T, r), s.device)
    _check("B", B, torch.float32, (Z, r, dout), s.device)
    _check("ranks", ranks, torch.int32, (Z,), s.device)
    if rows is not None:
        _check("rows", rows, torch.int32, (Z,), s.device)
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
                            _DTYPE_CODE[s.dtype], _stream(s.device))
    _raise_if(err, "sb_add")
    LAUNCHES["sb_add"] += 1
    return y
