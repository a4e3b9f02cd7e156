"""Chunked gated linear scan: CUDA wrapper and launch count.

Port of ``src/repro/kernels/linear_scan/linear_scan.py:linear_scan`` (def
:89, pallas_call :111, body ``_kernel`` :36): q, k, logw [B,S,K], v
[B,S,V], an optional bonus [B,K] and initial state [B,K,V] -> (y [B,S,V]
in q's dtype, final state [B,K,V] fp32), in the RWKV mode (bonus on the
diagonal, pairs t > i) or the SSD mode (``decay_on_query``, pairs t >= i).
The kernel is CUDA C++ for ``sm_90a`` in ``csrc/linear_scan.cu``, compiled
by ``nvcc`` into ``build/`` beside this file at first use and called
through ``ctypes``. The wrapper takes its plain PyTorch version
(``ref.py``) only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises. ``LAUNCHES`` counts kernel launches (plain-version calls
do not count).
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.linear_scan import ref
from repro_torch.kernels.nvcc import NVCC_FLAGS, build_library

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "linear_scan.cu",)
BUILD_DIR = _HERE / "build"

# launches since the last ``reset_launches()``
LAUNCHES = {"linear_scan": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile ``csrc/linear_scan.cu`` into ``build/linear_scan-<hash>.so``
    unless it is already there."""
    return build_library("linear_scan", SOURCES, (), BUILD_DIR, NVCC_FLAGS)


def _load() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ls_forward.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I,
                                       I, I, P]
            lib.ls_forward.restype = I
            lib.ls_smem_bytes.argtypes = [I, I, I]
            lib.ls_smem_bytes.restype = LL
            lib.ls_smem_max.argtypes = []
            lib.ls_smem_max.restype = LL
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


def linear_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, *,
                bonus: Optional[torch.Tensor] = None,
                decay_on_query: bool = False,
                initial_state: Optional[torch.Tensor] = None,
                chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: [B,S,K] and v: [B,S,V] of one dtype (fp32 or bf16); logw:
    [B,S,K] fp32; bonus: [B,K] fp32 or None; initial_state: [B,K,V] fp32 or
    None. Chunks of ``C = min(chunk, S)`` tokens, which must divide S.
    Returns (y [B,S,V] in q's dtype, final state [B,K,V] fp32)."""
    if q.device.type == "cpu":
        return ref.linear_scan_ref(q, k, v, logw, bonus=bonus,
                                   decay_on_query=decay_on_query,
                                   initial_state=initial_state, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"linear_scan: unsupported device {q.device}")
    if q.dim() != 3 or v.dim() != 3:
        raise ValueError("linear_scan takes q/k/logw [B,S,K], v [B,S,V]")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"linear_scan: q must be fp32 or bf16, not {q.dtype}")
    B, S, K = q.shape
    V = v.shape[-1]
    C = min(int(chunk), S)
    if C < 1 or S % C:
        raise ValueError(f"linear_scan: chunk {C} does not divide S = {S}")
    if K % 4 or V % 4:
        raise ValueError(f"linear_scan: K = {K} and V = {V} must be "
                         "multiples of 4")
    dev = q.device
    _check("k", k, q.dtype, (B, S, K), dev)
    _check("q", q, q.dtype, (B, S, K), dev)
    _check("v", v, q.dtype, (B, S, V), dev)
    _check("logw", logw, torch.float32, (B, S, K), dev)
    if bonus is not None:
        _check("bonus", bonus, torch.float32, (B, K), dev)
    if initial_state is not None:
        _check("initial_state", initial_state, torch.float32, (B, K, V), dev)
    lib = _load()
    need, most = lib.ls_smem_bytes(C, K, V), lib.ls_smem_max()
    if need > most:
        raise ValueError(f"linear_scan: chunk {C} at K = {K}, V = {V} needs "
                         f"{need} bytes of shared memory, more than {most}")
    y = torch.empty((B, S, V), dtype=q.dtype, device=dev)
    state = torch.empty((B, K, V), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = lib.ls_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        ptr(bonus), ptr(initial_state), y.data_ptr(), state.data_ptr(),
        B, S, C, K, V, int(bool(decay_on_query)), _DTYPE_CODE[q.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_scan kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["linear_scan"] += 1
    return y, state
