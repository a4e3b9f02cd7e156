"""Causal flash-attention forward: CUDA wrapper and launch count.

Port of ``src/repro/kernels/flash_attention/flash_attention.py:
flash_attention`` (def :77, pallas_call :89): q [B,Sq,hd], k/v [B,Sk,hd]
-> [B,Sq,hd] in q's dtype, fp32 inside, suffix-aligned causal mask with an
optional sliding window, fully masked rows exactly 0. The kernel is CUDA
C++ for ``sm_90a`` in ``csrc/flash_attention.cu``, compiled by ``nvcc`` into
``build/`` beside this file at first use and called through ``ctypes``.
The wrapper takes its plain PyTorch version (``ref.py``) only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches (plain-version calls do not count).

The TPU kernel's tiles (BQ = 256, BK = 512) were VMEM choices and are not
carried over: the CUDA kernel tiles 64 query rows by 64 keys (bf16, on the
tensor cores) or 32 keys (fp32, on the FMA units) and masks its own edges,
so no length needs to divide a tile. Grouped-query attention
is the caller's: ``models/attention.py`` repeats K/V to the query heads
before the call, as the JAX package does.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import ref
from repro_torch.kernels.nvcc import NVCC_FLAGS, build_library

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "flash_attention.cu",)
HEADERS = (_HERE.parent / "tensor_core.cuh",)
BUILD_DIR = _HERE / "build"
HEAD_DIMS = (16, 32, 64, 80, 128)    # the kernel's instantiations

# launches since the last ``reset_launches()``
LAUNCHES = {"flash_attention": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` into
    ``build/flash_attention-<hash>.so`` unless it is already there."""
    return build_library("flash_attention", SOURCES, HEADERS, BUILD_DIR,
                         NVCC_FLAGS)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.fa_forward.argtypes = [P, P, P, P, I, I, I, I,
                                       ctypes.c_float, I, I, I, P]
            lib.fa_forward.restype = I
            _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B,Sq,hd]; k, v: [B,Sk,hd] (one dtype, fp32 or bf16) ->
    [B,Sq,hd] in q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError("flash_attention takes q [B,Sq,hd], k/v [B,Sk,hd]")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: q must be fp32 or bf16, "
                        f"not {q.dtype}")
    B, Sq, hd = q.shape
    Sk = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in {HEAD_DIMS}")
    _check("q", q, q, (B, Sq, hd))
    _check("k", k, q, (B, Sk, hd))
    _check("v", v, q, (B, Sk, hd))
    o = torch.empty_like(q)
    err = _load().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        hd, hd ** -0.5, int(bool(causal)), int(window),
        _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["flash_attention"] += 1
    return o
