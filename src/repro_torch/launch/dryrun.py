"""Multi-pod dry run: trace every (arch x shape x mesh) combination, shapes
only, on the CPU.

The port of ``repro.launch.dryrun``. The reference fakes 512 host devices
and lowers and compiles each step under pjit. The port opens a ``fake``
process group of 256 ranks (single pod, 16 x 16) or 512 (two pods, 2 x 16 x
16) in this one process (``launch.mesh.fake_group``), builds the production
``DeviceMesh`` over it on the CPU, and traces the step under
``FakeTensorMode``: no weights, no card, no data moved. Running on the CPU
is its nature, not a fallback, so it takes no ``device``.

Each step is built by ``steps_dist.make_{train,prefill,serve}_step(cfg,
mesh)``, so the activation policy resolves its decisions on the production
mesh, and traced on GLOBAL fake tensors. The record holds per-device
figures:

  * FLOPs: ``FlopCounterMode``'s global count (remat's recompute included)
    divided by the chip count. The step is traced at 2 and 3 layers and the
    counts extrapolated linearly to ``num_layers``, as the reference's trip
    weighting does for its scan over layers: every family's layers run the
    same code on the same shapes.
  * Bytes: ``hlo_bytes`` is 2x the materialised result bytes (one write and
    one read a buffer; ``roofline/hlo.py``), extrapolated the same way,
    divided by the chip count. ``argument_bytes`` are exact: the local
    shards that the placements (``partitioning.to_named``) give each leaf of
    params, LoRA, optimizer state, hyper-parameters, batch and cache.
    ``temp_bytes`` is ``MemTracker``'s peak of the tensors the global trace
    creates (activations and temporaries), extrapolated, divided by the chip
    count: an estimate, and one of the CPU's path, where attention runs the
    plain oracle both ways. ``memory_per_device`` is their sum.
  * Collectives: a schedule derived from the spec trees, what an
    implementation of those placements must move. Each collective is
    realised once by ``DTensor.redistribute`` of a fake-backed DTensor on
    the fake mesh under ``roofline.hlo.Counter`` (kind, result bytes, group
    size, ring traffic) and weighted by the times a step runs it:
      - a base weight sharded over "data" is all-gathered over "data" once
        per forward pass over its layer (the forward, and remat's recompute
        when remat is on), and the gathered weight is kept for the
        backward; the unembedding once; the embedding table once for the
        lookup and, tied to the unembedding, once more for it. This is what
        the sharded step moves (``launch/partitioning.py``): its logged
        data-axis gathers equal this count (``tests/test_torch_ap.py``);
      - a weight that runs whole over "model" in the sharded step is
        all-gathered over "model" too, after its "data" gather and as
        often: Mamba's bc_proj and dt_proj, q/k/v/o where attention's
        heads do not split (``partitioning.whole_heads``), and the scan
        branch's weights where its heads do not (``partitioning
        .whole_scan``: RWKV's r/k/v/g/o, Mamba's in_proj, conv and
        out_proj). Their data- and model-axis gathers equal what the
        sharded step logs (``tests/test_torch_ap_ssm.py``,
        ``tests/test_torch_ap_uneven.py``);
      - Mamba's fp32 partial products of bc_proj and dt_proj ([Z, b, S,
        2N + H]) are all-reduced over "model" in each forward pass and once
        in the backward, where its heads split;
      - the residual stream, where the policy sequence-shards it over
        "model", is all-gathered before each of a layer's two sublayers and
        reduce-scattered after it, in each pass (Hymba reduce-scatters its
        two branch outputs apart, and attention that runs whole needs no
        reduce-scatter: this schedule charges two a layer);
      - adapters, their gradients and their optimizer state move over no
        axis where they are sharded with the batch (Adapter Parallelism).
        Over an axis that shards the batch but not the adapters ("pod", or
        "data" in ``sharding_variants``' FSDP variant) a training step
        all-reduces the adapter gradients once, as one bucket;
      - prefill and decode have forward passes only.
    Left out: the tensor-parallel partial sums of a residual that is not
    sequence-sharded (decode's one-token rows), the loss head's
    vocabulary-parallel reductions, and the partial sums over "model" that
    the adapters' backward needs where a base weight's output is split over
    "model" (dS = dY B^T summed over the split), in both variants of
    ``sharding_variants`` alike: no adapter traffic is put on "model".

This is a model of the placements, not a compiler's schedule, and the
reference's GSPMD numbers are not expected to match it. The XLA-only
fields keep their names: ``lower_s`` holds the trace's seconds,
``compile_s`` and the ``cost_analysis_*`` fields 0.0.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-3b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
Results land in experiments/dryrun_torch/<mesh>/<arch>__<shape>.json.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._guards import active_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.core import lora as LORA
from repro_torch.launch import mesh as MESH
from repro_torch.launch import partitioning as PT
from repro_torch.launch import steps_dist
from repro_torch.models import model as M
from repro_torch.models.common import dtype_of
from repro_torch.optim import adamw
from repro_torch.roofline import hlo as HLO

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# the depths each step is traced at: its counts are extrapolated from them
# to num_layers. FLOPs and bytes are linear in depth from the first layer
# on; the temporaries' peak takes its per-layer slope from the second on
# (the first layer's step adds more), in every full-width case checked
DEPTHS = (2, 3)

# sublayers a layer adds to the residual stream: attention (hymba: beside
# its Mamba branch, on the same normed input) or RWKV's time mix, then the
# MLP, the MoE layer or RWKV's channel mix (models/blocks.py)
SUBLAYERS = 2


def _fake():
    """The active ``FakeTensorMode``, or a new one: every tensor of one
    trace must come from one mode."""
    mode = active_fake_mode()
    return contextlib.nullcontext(mode) if mode else FakeTensorMode()


def sds(shape, dtype) -> torch.Tensor:
    """A fake CPU tensor of ``shape`` and ``dtype`` (no storage): the port's
    ``jax.ShapeDtypeStruct``."""
    with _fake():
        return torch.empty(shape, dtype=dtype)


def _use_ring(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Ring (sliding-window) caches apply to DECODE shapes only: prefill
    fills a full-length cache (the spec's 'KV cache of seq_len')."""
    if cfg.family == "ssm" or shape.kind != "decode":
        return False
    if cfg.attn_kind == "sliding":
        return True   # hymba: windowed attention is the arch's semantics
    return shape.name == "long_500k" and cfg.long_context_mode == "window"


def abstract_state(cfg: ModelConfig, Z: int) -> Tuple[Any, Any, Any]:
    """Fake (params, lora, opt_state) trees: shapes and dtypes only."""
    with _fake():
        params = M.init_params(cfg, device="cpu")
        ranks = torch.full((Z,), min(16, cfg.lora.r_max), dtype=torch.int32)
        lora = LORA.init_lora_tree(torch.Generator().manual_seed(0), cfg, Z,
                                   ranks, M.target_shapes(cfg))
        opt = adamw.init_state(lora, Z)
    return params, lora, opt


def _inputs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    Z, b = shape.decompose()
    S = shape.seq_len
    out: Dict[str, Any] = {"Z": Z, "b": b, "S": S, "kind": shape.kind}
    with _fake():
        if shape.kind in ("train", "prefill"):
            batch = {"tokens": sds((Z, b, S), torch.int32)}
            if shape.kind == "train":
                batch["labels"] = sds((Z, b, S), torch.int32)
            if cfg.input_mode == "mixed":
                batch["modal_embeds"] = sds(
                    (Z, b, cfg.num_modality_tokens, cfg.d_model),
                    torch.bfloat16)
            out["batch"] = batch
            if shape.kind == "prefill":
                out["cache"] = M.init_cache(cfg, Z, b, S,
                                            ring=_use_ring(cfg, shape),
                                            device="cpu")
        else:   # decode
            out["tokens"] = sds((Z, b), torch.int32)
            out["cache"] = M.init_cache(cfg, Z, b, S,
                                        ring=_use_ring(cfg, shape),
                                        device="cpu")
    return out


def input_specs(arch: str, shape_name: str) -> Dict[str, Any]:
    """Fake stand-ins for every model input of this combo."""
    return _inputs(get_arch(arch), get_shape(shape_name))


@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    lower_s: float = 0.0
    compile_s: float = 0.0
    flops: float = 0.0
    hlo_bytes: float = 0.0
    collective_traffic: float = 0.0
    cost_analysis_flops: float = 0.0
    cost_analysis_bytes: float = 0.0
    collectives: Optional[Dict] = None
    memory_per_device: Optional[float] = None
    memory_analysis: str = ""
    error: str = ""

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               seq_shard: bool = True, remat: bool = True,
               opt_level: int = 0) -> Dict[str, Any]:
    """Global counts of one step of ``cfg`` (at its own ``num_layers``) at
    ``shape``, built on ``mesh`` and traced on fake tensors: {"flops",
    "bytes_written", "temp_bytes" (MemTracker's peak of what the trace
    creates), "residual" (the policy's spec of the [Z, b, S, d] residual
    stream, None if it made no decision)}."""
    Z, b = shape.decompose()
    with _fake():
        inp = _inputs(cfg, shape)
        params, lora, opt = abstract_state(cfg, Z)
        if shape.kind == "train":
            step = steps_dist.make_train_step(cfg, mesh, remat=remat,
                                              seq_shard=seq_shard,
                                              opt_level=opt_level)
            vec = sds((Z,), torch.int32)
            args = (params, lora, opt, adamw.SlotHParams.broadcast(Z), vec,
                    vec, inp["batch"])
        elif shape.kind == "prefill":
            step = steps_dist.make_prefill_step(cfg, mesh,
                                                opt_level=opt_level)
            args = (params, lora, inp["cache"], inp["batch"])
        else:
            step = steps_dist.make_serve_step(cfg, mesh, opt_level=opt_level)
            args = (params, lora, inp["cache"], inp["tokens"])
        tracker = MemTracker()
        with tracker, HLO.Counter() as counter:
            step(*args)
        peak = tracker.get_tracker_snapshot("peak")
    residual = (Z, b, shape.seq_len if shape.kind != "decode" else 1,
                cfg.d_model)
    return {"flops": counter.flops, "bytes_written": counter.bytes_written,
            "temp_bytes": sum(d["Total"] for d in peak.values()),
            "residual": step.policy.decisions.get(("residual", residual))}


def _extrapolate(counts: Dict[int, Dict], layers: int, key: str) -> int:
    """The count at ``layers`` layers, on the line through the counts at
    two consecutive depths ({depth: counts})."""
    (d, lo), (_, hi) = sorted(counts.items())
    return lo[key] + (layers - d) * (hi[key] - lo[key])


# ---------------------------------------------------------------------------
# placements: local shards and the collective schedule
# ---------------------------------------------------------------------------

def _local_shape(mesh, shape, placements) -> Tuple[int, ...]:
    out = list(shape)
    sizes = MESH.axis_sizes(mesh)
    for axis, pl in zip(MESH.axis_names(mesh), placements):
        if isinstance(pl, Shard):
            out[pl.dim] //= sizes[axis]
    return tuple(out)


def _leaves(tree, specs) -> List[Tuple[str, torch.Tensor, PT.P]]:
    """[(path, leaf, spec)] of a tree and its spec tree."""
    out: List = []
    PT._map_with_path(tree, lambda path, leaf: out.append(
        (PT._leaf_path_str(path), leaf, PT._lookup(specs, path))))
    return out


def _local_bytes(mesh, leaf: torch.Tensor, spec) -> int:
    shp = _local_shape(mesh, leaf.shape, PT.placements(mesh, spec))
    return math.prod(shp) * leaf.element_size()


def _names(spec, axis: str) -> bool:
    return any(axis in (e if isinstance(e, tuple) else (e,))
               for e in spec if e is not None)


def _swap(placements, mesh, axis: str, new) -> Tuple:
    i = MESH.axis_names(mesh).index(axis)
    return tuple(new if j == i else p for j, p in enumerate(placements))


def _schedule(cfg: ModelConfig, shape: ShapeConfig, mesh, params, p_specs,
              lora, l_specs, tokens_spec, residual, remat: bool) -> List:
    """[(axis, what, global shape, dtype, src placements, dst placements,
    times a step runs it)]: the module docstring's schedule. An axis of
    size 1 moves nothing."""
    train = shape.kind == "train"
    passes = (3 if remat else 2) if train else 1    # the activations'
    forward = 2 if train and remat else 1           # the weights'
    L = cfg.num_layers
    sizes = MESH.axis_sizes(mesh)
    moves = [a for a in MESH.axis_names(mesh) if sizes[a] > 1]
    out: List = []
    for path, leaf, spec in _leaves(params, p_specs):
        if "data" not in moves or not _names(spec, "data"):
            continue
        if path.startswith("layers/"):        # one layer's slice, [1:]
            shp, spec, trips = leaf.shape[1:], PT.P(*spec[1:]), L * forward
        else:
            shp = leaf.shape
            trips = 1 + (path == "embed" and cfg.tie_embeddings)
        src = PT.placements(mesh, spec)
        out.append(("data", f"weight {path}", shp, leaf.dtype, src,
                    _swap(src, mesh, "data", Replicate()), trips))
    for path, leaf, spec in _leaves(params, p_specs):
        name = path.rsplit("/", 1)[-1]
        if ("model" not in moves or not _names(spec, "model")
                or not path.startswith("layers/")
                or name not in _model_whole(cfg, sizes["model"])):
            continue
        src = _swap(PT.placements(mesh, PT.P(*spec[1:])), mesh, "data",
                    Replicate())
        out.append(("model", f"weight {path}", leaf.shape[1:], leaf.dtype,
                    src, _swap(src, mesh, "model", Replicate()),
                    L * forward))
    if ("model" in moves and cfg.family == "hybrid" and train
            and not PT.whole_scan(cfg, sizes["model"])):
        Z, b = shape.decompose()
        H = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_size
        shp = (Z, b, shape.seq_len, 2 * cfg.ssm.state_size + H)
        src = PT.placements(mesh, PT.P(*tokens_spec[:2]))
        out.append(("model", "mamba bc/dt partial products", shp,
                    torch.float32, _swap(src, mesh, "model", Partial()), src,
                    L * passes))
    if ("model" in moves and residual is not None and len(residual) > 2
            and _names((residual[2],), "model")):
        Z, b = shape.decompose()
        shp = (Z, b, shape.seq_len, cfg.d_model)
        src = PT.placements(mesh, residual)
        trips = SUBLAYERS * L * passes
        dtype = dtype_of(cfg.dtype)
        out.append(("model", "residual", shp, dtype, src,
                    _swap(src, mesh, "model", Replicate()), trips))
        out.append(("model", "residual", shp, dtype,
                    _swap(src, mesh, "model", Partial()), src, trips))
    for axis in ("pod", "data") if train else ():
        if axis not in moves or not _names(tokens_spec, axis):
            continue
        bucket = [(leaf, spec) for _, leaf, spec in _leaves(lora, l_specs)
                  if not _names(spec, axis)]
        if not bucket:
            continue
        dtype = bucket[0][0].dtype
        n = sum(_local_bytes(mesh, leaf, spec)
                for leaf, spec in bucket) // bucket[0][0].element_size()
        src = tuple(Partial() if a == axis else Replicate()
                    for a in MESH.axis_names(mesh))
        out.append((axis, "adapter grads", (n,), dtype, src,
                    (Replicate(),) * len(src), 1))
    return out


def _model_whole(cfg: ModelConfig, m: int) -> Tuple[str, ...]:
    """The layer weights the sharded step gathers over "model" (forward
    only): Mamba's bc_proj and dt_proj, attention's q/k/v/o where its
    heads do not split over the m ranks, and the scan branch's weights
    where its heads do not (RWKV's r/k/v/g/o, Mamba's in_proj, conv and
    out_proj)."""
    names: Tuple[str, ...] = ()
    if cfg.family == "hybrid":
        names += ("bc_proj", "dt_proj")
    if PT.whole_heads(cfg, m):
        names += ("q_proj", "k_proj", "v_proj", "o_proj")
    if PT.whole_scan(cfg, m):
        names += (("r_proj", "k_proj", "v_proj", "g_proj", "o_proj")
                  if cfg.family == "ssm" else
                  ("in_proj", "conv", "out_proj"))
    return names


def _realise(mesh, counter: HLO.Counter, shp, dtype, src,
             dst) -> HLO.CollectiveOp:
    """The one collective that redistributing a fake tensor of global
    shape ``shp`` from ``src`` to ``dst`` placements runs."""
    n = len(counter.collectives)
    local = torch.empty(_local_shape(mesh, shp, src), dtype=dtype)
    DTensor.from_local(local, mesh, src, run_check=False).redistribute(
        mesh, dst)
    new = counter.collectives[n:]
    if len(new) != 1:
        raise RuntimeError(f"{src} -> {dst} ran {len(new)} collectives")
    return new[0]


# ---------------------------------------------------------------------------
# one step on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Lowered:
    """Per-device figures of one step on a mesh (see the module docstring):
    ``collectives`` trip-weighted, each ``line`` "<axis>: <what moved>";
    ``arguments`` the argument bytes of each input (params, lora, opt, hp,
    active, ranks, batch; cache; tokens)."""
    flops: float
    bytes_written: float
    argument_bytes: float
    arguments: Dict[str, float]
    temp_bytes: float
    collectives: List[HLO.CollectiveOp]
    seconds: float

    def by_axis(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        axes: Dict[str, List[HLO.CollectiveOp]] = {}
        for op in self.collectives:
            axes.setdefault(op.line.split(":")[0], []).append(op)
        return {a: HLO.summarize(ops) for a, ops in sorted(axes.items())}


def lower_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               seq_shard: bool = True, remat: bool = True,
               opt_level: int = 0, lora_specs=None, opt_specs=None,
               hp_specs=None, vec_spec=None) -> Lowered:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh`` (a ``DeviceMesh``
    over ``mesh.fake_group``) with the partitioning rules' spec trees; a
    training step's adapter, optimizer, hyper-parameter and [Z]-vector
    specs may be given instead (``sharding_variants``)."""
    t0 = time.perf_counter()
    ndev = mesh.size()
    Z, b = shape.decompose()
    L = cfg.num_layers
    counts = {n: trace_step(dataclasses.replace(cfg, num_layers=n), shape,
                            mesh, seq_shard=seq_shard, remat=remat,
                            opt_level=opt_level) for n in DEPTHS}
    with FakeTensorMode():
        inp = _inputs(cfg, shape)
        params, lora, opt = abstract_state(cfg, Z)
        p_specs = PT.base_param_specs(mesh, params)
        l_specs = (lora_specs if lora_specs is not None
                   else PT.lora_param_specs(mesh, lora))
        trees = {"params": (params, p_specs), "lora": (lora, l_specs)}
        if shape.kind == "train":
            hp = adamw.SlotHParams.broadcast(Z)
            vec = sds((Z,), torch.int32)
            v_spec = (vec_spec if vec_spec is not None else
                      PT.pick_spec(mesh, (Z,), [{0: "data"}, {}]))
            b_specs = PT.batch_specs(mesh, inp["batch"])
            trees.update(
                opt=(opt, opt_specs if opt_specs is not None
                     else PT.opt_state_specs(mesh, opt)),
                hp=(hp, hp_specs if hp_specs is not None
                    else PT.hp_specs(mesh, hp)),
                active=(vec, v_spec), ranks=(vec, v_spec),
                batch=(inp["batch"], b_specs))
            tokens_spec = b_specs["tokens"]
        else:
            trees["cache"] = (inp["cache"], PT.cache_specs(mesh, inp["cache"]))
            if shape.kind == "prefill":
                trees["batch"] = (inp["batch"],
                                  PT.batch_specs(mesh, inp["batch"]))
            else:
                pod = [{0: "data", 1: "pod"}] if PT.has_pod(mesh) else []
                trees["tokens"] = (inp["tokens"], PT.pick_spec(
                    mesh, (Z, b), pod + [{0: "data"}, {}]))
            tokens_spec = PT.P()
        arguments = {name: float(sum(_local_bytes(mesh, leaf, spec)
                                     for _, leaf, spec in _leaves(*ts)))
                     for name, ts in trees.items()}
        sched = _schedule(cfg, shape, mesh, params, p_specs, lora, l_specs,
                          tokens_spec, counts[DEPTHS[0]]["residual"], remat)
        colls = []
        with HLO.Counter() as counter:
            for axis, what, shp, dtype, src, dst, trips in sched:
                op = _realise(mesh, counter, shp, dtype, src, dst)
                colls.append(dataclasses.replace(
                    op, trip_count=float(trips),
                    traffic_bytes=op.traffic_bytes * trips,
                    line=f"{axis}: {what}"))
    per_dev = lambda key: _extrapolate(counts, L, key) / ndev  # noqa: E731
    return Lowered(flops=per_dev("flops"),
                   bytes_written=per_dev("bytes_written"),
                   argument_bytes=sum(arguments.values()),
                   arguments=arguments,
                   temp_bytes=per_dev("temp_bytes"), collectives=colls,
                   seconds=time.perf_counter() - t0)


def dryrun_one(arch: str, shape_name: str, multi_pod: bool = False,
               *, seq_shard: bool = True, remat: bool = True,
               save: bool = True, verbose: bool = True,
               opt_level: int = 0) -> DryrunResult:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    res = DryrunResult(arch=arch, shape=shape_name, mesh=mesh_name, ok=False)
    try:
        cfg = get_arch(arch)
        shape = get_shape(shape_name)
        with MESH.fake_group(512 if multi_pod else 256):
            mesh = MESH.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
            low = lower_step(cfg, shape, mesh, seq_shard=seq_shard,
                             remat=remat, opt_level=opt_level)
        res.lower_s = low.seconds
        res.flops = low.flops
        res.hlo_bytes = 2.0 * low.bytes_written   # write + read per buffer
        res.collectives = HLO.summarize(low.collectives)
        res.collective_traffic = HLO.total_traffic(low.collectives)
        res.memory_per_device = low.argument_bytes + low.temp_bytes
        res.memory_analysis = (
            f"argument_bytes={low.argument_bytes:.0f} "
            f"temp_bytes={low.temp_bytes:.0f} (temp: an estimate, "
            f"MemTracker's peak of the global fake trace / {mesh.size()})")
        res.ok = True
        if verbose:
            print(f"[OK] {arch} x {shape_name} x {mesh_name}: "
                  f"lower {res.lower_s:.1f}s compile {res.compile_s:.1f}s "
                  f"flops {res.flops:.3e} bytes {res.hlo_bytes:.3e} "
                  f"coll {res.collective_traffic:.3e}")
            print(f"     memory_analysis: {res.memory_analysis[:200]}")
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        res.error = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: "
                  f"{type(e).__name__}: {str(e)[:300]}")
    if save:
        root = OUT_DIR if opt_level == 0 else OUT_DIR + f"_opt{opt_level}"
        d = os.path.join(root, mesh_name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{arch}__{shape_name}.json"), "w") as f:
            json.dump(res.to_json(), f, indent=1, default=str)
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ASSIGNED + ["all"])
    ap.add_argument("--shape", default=None,
                    choices=sorted(SHAPES) + ["all"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt-level", type=int, default=0,
                    help="0=paper baseline; 1=+weight-gather+attn layouts; "
                         "2=+inner-scan remat & chunk=32 (§Perf)")
    args = ap.parse_args()

    archs = ASSIGNED if (args.all or args.arch in (None, "all")) \
        else [args.arch]
    shapes = sorted(SHAPES) if (args.all or args.shape in (None, "all")) \
        else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]

    results = []
    for mp in meshes:
        for a in archs:
            for s in shapes:
                results.append(dryrun_one(a, s, mp,
                                          opt_level=args.opt_level))
    ok = sum(r.ok for r in results)
    print(f"\n=== dry-run: {ok}/{len(results)} combos traced ===")
    if ok < len(results):
        for r in results:
            if not r.ok:
                print(f"  FAILED: {r.arch} x {r.shape} x {r.mesh}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
