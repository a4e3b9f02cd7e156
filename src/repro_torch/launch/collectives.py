"""Collectives over one named axis of a mesh, autograd-aware and logged.

The sharded train step (``launch/partitioning.py``'s ``SpmdPlan``) issues
every collective through this module, on the local shards of a real
multi-rank ``DeviceMesh``. Gradients follow the "replicated" convention of
tensor parallelism: a tensor that every rank of the axis holds whole has
its whole gradient on every rank, and a partial sum (the ranks' tensors
add up to the true value) has a gradient that every rank holds whole. So:

  * ``gather``     — all-gather along ``dim``; backward: reduce-scatter
                     (each rank's gradient of the gathered tensor is a
                     partial sum);
  * ``scatter``    — reduce-scatter along ``dim`` (a partial sum becomes a
                     shard of the sum); backward: all-gather;
  * ``reduce``     — all-reduce of a partial sum; backward: identity;
  * ``broadcast_grad`` — identity; backward: all-reduce (a whole tensor
                     entering computations that split over the axis);
  * ``all_gather`` / ``all_reduce`` — no autograd: frozen weights,
                     gradients after the backward, metrics, the MoE
                     router's int32 expert counts.

Every call appends a ``Record`` (axis, kind, role, shape, dtype, bytes) to
the ``log`` list its caller passes (the step's ``SpmdPlan.log``): ``role``
is "base_weight", "activation", "adapter_grad", "metric", "route" (the
MoE router's per-expert counts of a token group that spans data or pod
ranks) or "loss" (the per-slot loss sums added over "pod");
``shape`` and ``bytes`` are those of the result (the gathered tensor, the
scattered shard, the reduced tensor), as the dry run's counter charges
them (``roofline/hlo.py``). A call over an axis of size 1 moves nothing
and logs nothing.

Transport: ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_reduce`` on the tensors where they lie, over NCCL (a card a rank) or
gloo (the CPU). A gloo group whose ranks share one card (NCCL takes one
card a rank) moves CUDA tensors through the card's memory instead
(``_CardShare``: a workspace a rank, mapped into the others by CUDA IPC,
gloo barriers between the copies; sums in fp32 in rank order), chosen when
the group first meets on the card by comparing the ranks' device UUIDs:
the same path every run on the same machine. Torch's gloo carries all
three collectives on CUDA tensors too (checked on the H100 with torch
2.11), through the host and TCP (``PERF.md`` has both paths' step times).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
import torch.distributed as dist

ROLES = ("base_weight", "activation", "adapter_grad", "metric",
         "route", "loss")


@dataclasses.dataclass(frozen=True)
class Record:
    axis: str
    kind: str             # "all-gather", "reduce-scatter" or "all-reduce"
    role: str
    shape: Tuple[int, ...]
    dtype: str
    bytes: int


def _log(log: List[Record], axis: str, kind: str, role: str,
         out: torch.Tensor) -> None:
    if role not in ROLES:
        raise ValueError(f"unknown collective role {role!r}")
    log.append(Record(axis, kind, role, tuple(out.shape),
                      str(out.dtype).replace("torch.", ""),
                      out.numel() * out.element_size()))


def axis_group(mesh, axis: str):
    return mesh.get_group(axis)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


# ---------------------------------------------------------------------------
# transport (no autograd, no log)
# ---------------------------------------------------------------------------

# bytes of the card-memory workspace each rank of a card-sharing group holds
WORKSPACE_BYTES = 64 << 20


class _CardShare:
    """The data path of a gloo group whose ranks share one card: each rank
    holds a workspace on the card, mapped into every other rank of the
    group (CUDA IPC), in two halves used in turn. A collective copies this
    rank's part into its next half, meets the group at a gloo barrier
    (after its own copies are done), and reads the parts it needs from the
    group's halves (a sum in fp32, over the ranks in order, so every rank
    computes the same bits). A half is written again only two collectives
    later, after every rank has met the group once more, so its last reads
    are done. Tensors larger than a half go through in chunks.
    ``release`` waits for the last reads and unmaps the workspaces."""

    def __init__(self, group, device: torch.device):
        from torch.multiprocessing.reductions import reduce_tensor
        self.group, self.device = group, device
        self.n, self.rank = dist.get_world_size(group), dist.get_rank(group)
        self.buf = torch.empty(WORKSPACE_BYTES, dtype=torch.uint8,
                               device=device)
        got = [None] * self.n
        dist.all_gather_object(got, reduce_tensor(self.buf), group=group)
        self.peers = [self.buf if i == self.rank else fn(*args)
                      for i, (fn, args) in enumerate(got)]
        self.half = 0

    def _meet(self) -> None:
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)

    def _next(self):
        """This collective's half of each workspace, and its size."""
        h, size = self.half, WORKSPACE_BYTES // 2
        self.half ^= 1
        return [p[h * size:(h + 1) * size] for p in self.peers], size

    @staticmethod
    def _view(buf, dtype, k: int, at: int = 0) -> torch.Tensor:
        return buf.view(dtype)[at:at + k]

    @staticmethod
    def _sum(views, op) -> torch.Tensor:
        acc = views[0].float()
        for v in views[1:]:
            acc = (acc + v.float() if op == dist.ReduceOp.SUM
                   else torch.maximum(acc, v.float()))
        return acc

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """x: 1-D; returns the n ranks' x concatenated."""
        m, out = x.numel(), x.new_empty(self.n * x.numel())
        step = WORKSPACE_BYTES // 2 // x.element_size()
        for c in range(0, m, step):
            k = min(step, m - c)
            halves, _ = self._next()
            self._view(halves[self.rank], x.dtype, k).copy_(x[c:c + k])
            self._meet()
            for i, p in enumerate(halves):
                out[i * m + c:i * m + c + k].copy_(self._view(p, x.dtype, k))
        return out

    def reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        """x: 1-D; returns the elementwise sum (or max) over the ranks."""
        m, out = x.numel(), torch.empty_like(x)
        step = WORKSPACE_BYTES // 2 // x.element_size()
        for c in range(0, m, step):
            k = min(step, m - c)
            halves, _ = self._next()
            self._view(halves[self.rank], x.dtype, k).copy_(x[c:c + k])
            self._meet()
            out[c:c + k].copy_(self._sum(
                [self._view(p, x.dtype, k) for p in halves], op))
        return out

    def scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x: 1-D of n equal shards; returns the sum of this rank's shard
        over the ranks."""
        L = x.numel() // self.n
        out = x.new_empty(L)
        step = WORKSPACE_BYTES // 2 // (self.n * x.element_size())
        for c in range(0, L, step):
            k = min(step, L - c)
            halves, _ = self._next()
            for j in range(self.n):
                self._view(halves[self.rank], x.dtype, k, j * k).copy_(
                    x[j * L + c:j * L + c + k])
            self._meet()
            out[c:c + k].copy_(self._sum(
                [self._view(p, x.dtype, k, self.rank * k) for p in halves],
                dist.ReduceOp.SUM))
        return out

    def release(self) -> None:
        self._meet()
        self.peers = []
        torch.cuda.synchronize(self.device)
        dist.barrier(group=self.group)


_SHARES: dict = {}


def _card_share(group, t: torch.Tensor):
    """The group's ``_CardShare`` when it is a gloo group of ranks on one
    card and ``t`` lies there, else None (the group's own collectives).
    Made at the group's first collective on the card, in every rank."""
    if t.device.type != "cuda" or dist.get_backend(group) != "gloo":
        return None
    key = id(group)
    if key not in _SHARES:
        uuid = str(torch.cuda.get_device_properties(t.device).uuid)
        got = [None] * dist.get_world_size(group)
        dist.all_gather_object(got, uuid, group=group)
        _SHARES[key] = (_CardShare(group, t.device) if len(set(got)) == 1
                        else None)
    return _SHARES[key]


def release_shares() -> None:
    """Wait for every card-sharing group's last reads and unmap its
    workspaces (each rank of each such group calls it, before the groups
    are destroyed)."""
    for share in _SHARES.values():
        if share is not None:
            share.release()
    _SHARES.clear()


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = t.detach().movedim(dim, 0).contiguous()
    share = _card_share(group, x)
    if share is not None:
        out = share.gather(x.view(-1)).view(
            (n * x.shape[0],) + tuple(x.shape[1:]))
    else:
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _sum(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    share = _card_share(group, t)
    if share is not None:
        return share.reduce(t.detach().contiguous().view(-1),
                            op).view(t.shape)
    out = t.detach().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce-scatter of dim {dim} of {tuple(t.shape)} "
                         f"over {n} ranks")
    x = t.detach().movedim(dim, 0).contiguous()
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    share = _card_share(group, x)
    if share is not None:
        out = share.scatter(x.view(-1)).view(shape)
    else:
        out = x.new_empty(shape)
        dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# autograd Functions
# ---------------------------------------------------------------------------

class _Gather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, role, log):
        ctx.mesh, ctx.axis, ctx.dim, ctx.role, ctx.log = (mesh, axis, dim,
                                                         role, log)
        out = _gather(x, dim, axis_group(mesh, axis))
        _log(log, axis, "all-gather", role, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        dx = _scatter(dy, ctx.dim, axis_group(ctx.mesh, ctx.axis))
        _log(ctx.log, ctx.axis, "reduce-scatter", ctx.role, dx)
        return dx, None, None, None, None, None


class _Scatter(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, dim, role, log):
        ctx.mesh, ctx.axis, ctx.dim, ctx.role, ctx.log = (mesh, axis, dim,
                                                         role, log)
        out = _scatter(x, dim, axis_group(mesh, axis))
        _log(log, axis, "reduce-scatter", role, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        dx = _gather(dy, ctx.dim, axis_group(ctx.mesh, ctx.axis))
        _log(ctx.log, ctx.axis, "all-gather", ctx.role, dx)
        return dx, None, None, None, None, None


class _Reduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, role, log):
        out = _sum(x, axis_group(mesh, axis))
        _log(log, axis, "all-reduce", role, out)
        return out

    @staticmethod
    def backward(ctx, dy):
        return dy, None, None, None, None


class _BroadcastGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, mesh, axis, role, log):
        ctx.mesh, ctx.axis, ctx.role, ctx.log = mesh, axis, role, log
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        dx = _sum(dy, axis_group(ctx.mesh, ctx.axis))
        _log(ctx.log, ctx.axis, "all-reduce", ctx.role, dx)
        return dx, None, None, None, None


def gather(x: torch.Tensor, mesh, axis: str, dim: int, role: str,
           log: List[Record]) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``axis`` (rank order);
    backward: reduce-scatter."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim(), role, log)


def scatter(x: torch.Tensor, mesh, axis: str, dim: int, role: str,
            log: List[Record]) -> torch.Tensor:
    """Reduce-scatter the partial sum ``x`` along ``dim`` over ``axis``:
    this rank's shard of the sum; backward: all-gather."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Scatter.apply(x, mesh, axis, dim % x.dim(), role, log)


def reduce(x: torch.Tensor, mesh, axis: str, role: str,
           log: List[Record]) -> torch.Tensor:
    """All-reduce (sum) the partial sum ``x`` over ``axis``; backward:
    identity."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Reduce.apply(x, mesh, axis, role, log)


def broadcast_grad(x: torch.Tensor, mesh, axis: str, role: str,
                   log: List[Record]) -> torch.Tensor:
    """Identity; backward: all-reduce of the gradient over ``axis``."""
    if axis_size(mesh, axis) == 1:
        return x
    return _BroadcastGrad.apply(x, mesh, axis, role, log)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int, role: str,
               log: List[Record]) -> torch.Tensor:
    """All-gather along ``dim`` over ``axis``, outside autograd."""
    if axis_size(mesh, axis) == 1:
        return x
    out = _gather(x, dim % x.dim(), axis_group(mesh, axis))
    _log(log, axis, "all-gather", role, out)
    return out


def all_reduce(x: torch.Tensor, mesh, axis: str, role: str,
               log: List[Record], op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce over ``axis`` (a new tensor), outside autograd."""
    if axis_size(mesh, axis) == 1:
        return x
    out = _sum(x, axis_group(mesh, axis), op)
    _log(log, axis, "all-reduce", role, out)
    return out
