"""Counts of one traced call, taken from torch: FLOPs, materialised bytes,
collectives.

The port of ``repro.roofline.hlo``, which parses XLA's optimized HLO text.
The port has no HLO, so it counts from torch's own dispatch instead, and
keeps the reference's module name so that each port file has one
counterpart. ``Counter`` gives the reference's ``analyze`` keys:

  * flops         — ``torch.utils.flop_counter.FlopCounterMode`` over the
                   call (2*M*N*K a matmul). Activation checkpointing's
                   recompute runs inside the call and is counted, as the
                   reference's trip weighting counts it.
  * bytes_written — the output bytes of every non-view aten op of the call
                   (the reference's "materialized result bytes"; HBM
                   traffic ~ 2x this: one write + one read per buffer).
  * collectives   — every functional collective that
                   ``torch.distributed.tensor.debug.CommDebugMode`` sees,
                   with its result bytes and its group size, under the
                   reference's ring model (``_traffic``, verbatim):
        all-gather / all-to-all / reduce-scatter: (n-1)/n * bytes
        all-reduce: 2 (n-1)/n * bytes
        collective-permute: bytes

The reference's HLO text helpers (``parse_shape``, ``shape_bytes``,
``HloModule``, ``top_bytes``, ``parse_collectives``) parse XLA's output,
which the port does not have, and have no counterpart here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# c10d functional op -> the reference's kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = ("_c10d_functional", "c10d_functional", "c10d",
         "_c10d_functional_autograd")


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    trip_count: float
    traffic_bytes: float
    line: str


def _traffic(kind: str, result_bytes: int, group: int) -> float:
    frac = (group - 1) / max(group, 1)
    if kind == "all-reduce":
        return 2.0 * frac * result_bytes
    if kind == "collective-permute":
        return float(result_bytes)
    return frac * result_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(group_name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name).size()


class _Collectives(CommDebugMode):
    """``CommDebugMode`` that also keeps, for each collective it counts, its
    kind, result bytes and group size as a ``CollectiveOp``."""

    def __init__(self):
        super().__init__()
        self.ops: List[CollectiveOp] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(
                func, torch._ops.HigherOrderOperator):
            return out
        name = func._overloadpacket.__name__
        if name in _KINDS and func.namespace in _C10D:
            kind = _KINDS[name]
            rb = _nbytes(out)
            grp = _group_size(args[-1])      # every one ends in group_name
            self.ops.append(CollectiveOp(
                kind=kind, result_bytes=rb, group_size=grp, trip_count=1.0,
                traffic_bytes=_traffic(kind, rb, grp),
                line=f"{func} group={args[-1]} size={grp}"))
        return out


class _BytesWritten(TorchDispatchMode):
    """Sums the output bytes of every non-view aten op (collectives aside:
    they are counted as collectives)."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # counted once DTensor desugars
        out = func(*args, **(kwargs or {}))
        if not func.is_view and func.namespace not in _C10D:
            flat = out if isinstance(out, (tuple, list)) else (out,)
            self.total += sum(_nbytes(t) for t in flat
                              if isinstance(t, torch.Tensor))
        return out


class Counter:
    """Counts what runs inside its ``with`` block (eager, fake or DTensor
    tensors alike): ``analyze()`` gives the reference's ``analyze`` keys."""

    def __enter__(self) -> "Counter":
        self._flops = FlopCounterMode(display=False)
        self._bytes = _BytesWritten()
        self._comm = _Collectives()
        self._stack = contextlib.ExitStack()
        for mode in (self._comm, self._flops, self._bytes):
            self._stack.enter_context(mode)
        return self

    def __exit__(self, *exc) -> bool:
        return self._stack.__exit__(*exc)

    @property
    def flops(self) -> int:
        return self._flops.get_total_flops()

    @property
    def bytes_written(self) -> int:
        return self._bytes.total

    @property
    def collectives(self) -> List[CollectiveOp]:
        return self._comm.ops

    def analyze(self) -> Dict:
        colls = self.collectives
        return {
            "flops": float(self.flops),
            "bytes_written": float(self.bytes_written),
            "collective_traffic": total_traffic(colls),
            "collectives": summarize(colls),
        }


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def summarize(ops: List[CollectiveOp]) -> Dict[str, Dict[str, float]]:
    out: Dict[str, Dict[str, float]] = {}
    for op in ops:
        d = out.setdefault(op.kind, {"count": 0.0, "traffic_bytes": 0.0,
                                     "result_bytes": 0.0})
        d["count"] += op.trip_count
        d["traffic_bytes"] += op.traffic_bytes
        d["result_bytes"] += op.result_bytes * op.trip_count
    return out


def total_traffic(ops: List[CollectiveOp]) -> float:
    return sum(op.traffic_bytes for op in ops)
