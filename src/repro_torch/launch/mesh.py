"""Mesh construction (the port of ``repro.launch.mesh``).

Defined as functions, so that importing this module touches no device or
process-group state.

Axis semantics (the reference's DESIGN.md §5):
  "pod"   : cross-pod data parallelism over the per-adapter batch
  "data"  : ADAPTER PARALLELISM — each data-rank owns a disjoint slice of
            the adapter slots Z; adapter params/grads/opt-state never cross
            this axis (the paper's rank-local AP)
  "model" : tensor/sequence sharding of the frozen backbone

A real mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over an
initialized process group (``process_group`` makes one of any number of
ranks, torchrun-style: NCCL when each rank has its card, gloo on the CPU
or for ranks that share one card; ``fake_group`` makes a many-rank one that
moves nothing, for the shapes-only dry run). The sharded train step runs
on a real mesh of several ranks (``launch/partitioning.py``).
``abstract_mesh``
is a plain object with the same ``shape`` / ``axis_names`` view and no
devices, for the spec tests and the production meshes' spec trees.
"""
from __future__ import annotations

import contextlib
import os
import socket
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import MeshConfig
from repro_torch.launch import collectives as C
from repro_torch.models.common import resolve_device

SINGLE_POD = MeshConfig(shape=(16, 16), axes=("data", "model"))
MULTI_POD = MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))


class AbstractMesh:
    """A mesh by axis names and sizes alone: ``shape`` maps each name to
    its size (as ``jax.sharding.AbstractMesh.shape`` does) and
    ``axis_names`` keeps their order."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...]):
        if len(shape) != len(axes):
            raise ValueError(f"{len(shape)} sizes for {len(axes)} axes")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def abstract_mesh(shape: Tuple[int, ...],
                  axes: Tuple[str, ...]) -> AbstractMesh:
    return AbstractMesh(shape, axes)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def mesh_config(mesh) -> MeshConfig:
    sizes = axis_sizes(mesh)
    names = axis_names(mesh)
    return MeshConfig(shape=tuple(sizes[a] for a in names), axes=names)


def free_port() -> int:
    """A free TCP port on this machine."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(device=None, init_method: Optional[str] = None, *,
                  backend: Optional[str] = None, rank: Optional[int] = None,
                  world_size: Optional[int] = None):
    """A process group for the duration of the context, destroyed at its
    end even on failure; yields this rank's device.

    ``rank`` and ``world_size`` default to torchrun's ``RANK`` and
    ``WORLD_SIZE`` (else 0 and 1); ``init_method`` to ``env://`` when
    ``MASTER_ADDR`` and ``MASTER_PORT`` are set, else, for one rank,
    ``tcp://127.0.0.1:<a free port>`` (a ``file://`` path works too).
    ``backend`` is the caller's choice: "nccl" when each rank has a card
    of its own, "gloo" on the CPU or for ranks that share one card; left
    out, it is "nccl" on the card and "gloo" on the CPU. It is never
    switched on a failure. On the card a device without an index is
    ``cuda:<LOCAL_RANK>`` under NCCL and ``cuda:<LOCAL_RANK mod the cards>``
    under gloo (one card: every rank on ``cuda:0``)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs the card")
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://127.0.0.1:{free_port()}"
        else:
            raise ValueError(f"{world_size} ranks need an init_method or "
                             "MASTER_ADDR and MASTER_PORT")
    if dev.type == "cuda":      # the communicator's device, before the mesh
        if dev.index is None:
            local = int(env.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local if backend == "nccl"
                               else local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    try:
        yield dev
        C.release_shares()        # every rank got here: no one still reads
    finally:
        dist.destroy_process_group()


def make_local_mesh(shape: Tuple[int, ...] = (1, 1),
                    axes: Tuple[str, ...] = ("data", "model"), *,
                    device=None) -> DeviceMesh:
    """A mesh over the ranks of the initialized process group (whose world
    size must be the mesh's size), rank-major in ``shape``, with one
    subgroup per axis, on the card unless ``device`` says otherwise."""
    dev = resolve_device(device)
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized process "
                           "group (launch.mesh.process_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The 16 x 16 (or 2 x 16 x 16) production mesh over a process group
    of exactly that many ranks (the reference asserts the device count,
    ``mesh.py:39-46``), on the card unless ``device_type`` says otherwise
    (the dry run's "cpu" mesh over ``fake_group``)."""
    cfg = MULTI_POD if multi_pod else SINGLE_POD
    n = cfg.num_devices
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(f"the production mesh needs {n} ranks, the "
                           f"process group has {have}")
    return DeviceMesh(device_type, torch.arange(n).reshape(cfg.shape),
                      mesh_dim_names=cfg.axes)


@contextlib.contextmanager
def fake_group(world_size: int):
    """A ``world_size``-rank process group on torch's ``fake`` backend, in
    this one process, for the duration of the context: its collectives
    return tensors of the right shapes and move no data, so a mesh over it
    serves a shapes-only trace (``launch/dryrun.py``). Destroyed at its end,
    even on failure."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    # registers the "fake" backend; torch keeps it under a private path
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_fake(mesh) -> bool:
    """Whether ``mesh`` is a ``DeviceMesh`` over a ``fake_group``."""
    return (isinstance(mesh, DeviceMesh)
            and dist.get_backend(mesh.get_group(0)) == "fake")
