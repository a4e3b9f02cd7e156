"""Production training launcher of the PyTorch port: the Adapter-Parallel
multi-LoRA train step with the production sharding rules on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --shape train_4k --steps 10 [--reduced] [--mesh dxm]

The reference's flags (``python -m repro.launch.train``), plus ``--device``
(the card by default; ``--device cpu`` runs on the CPU over gloo) and
``--seed`` (the random weights, adapters and data). ``--reduced`` takes the
tiny fp32 variant of the architecture at Z 4, b 2, S 64; otherwise Z and b
come from the shape (``train_4k``: Z 64, b 4, S 4,096), and the step tries
them as they are: nothing cuts Z. The mesh is a world-size-1 process group
(NCCL on the card) under a ``DeviceMesh`` named ("data", "model"); the
spec trees of ``launch/partitioning.py`` place every tensor, and the step
runs on the local shards, which on one rank are whole. A mesh of more than
one rank raises ``NotImplementedError``.

``run(cfg, Z, b, S, mesh, steps, ...)`` is the body, for callers that build
their own config or mesh; ``main(argv)`` parses the flags and calls it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.configs.shapes import get_shape
from repro_torch.core import lora as LORA
from repro_torch.data.synthetic import SlotBatcher, make_task_dataset
from repro_torch.launch import mesh as MESH
from repro_torch.launch import partitioning as PT
from repro_torch.launch import steps_dist
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.optim import adamw


def build_mesh(spec: str, device=None):
    """``--mesh dxm`` over the initialized process group. Only 1x1 runs:
    sharded execution needs more than one card."""
    d, m = (int(x) for x in spec.split("x"))
    if d * m != 1:
        raise NotImplementedError(PT.SHARDED_EXECUTION)
    return MESH.make_local_mesh((d, m), ("data", "model"), device=device)


def run(cfg: ModelConfig, Z: int, b: int, S: int, mesh, steps: int, *,
        lr: float = 1e-3, rank: int = 8, seed: int = 0, device=None,
        step_hook: Optional[Callable[[int, Dict, float], None]] = None,
        log: Callable[[str], None] = print) -> Dict:
    """``steps`` Adapter-Parallel train steps of ``cfg`` on ``mesh`` with
    Z slots of b sequences of S tokens, every slot at ``min(rank, r_max)``.
    ``step_hook(t, metrics, seconds)`` runs after each step. Returns
    {"losses": per step the [Z] per-slot losses, "step_s": seconds per
    step, "peak_gib": the card's peak allocated GiB over the steps (None
    on the CPU)}."""
    dev = resolve_device(device)
    if isinstance(mesh, DeviceMesh) and mesh.size() > 1:
        raise NotImplementedError(PT.SHARDED_EXECUTION)
    log(f"arch={cfg.name} Z={Z} b={b} S={S} layers={cfg.num_layers} "
        f"mesh={MESH.axis_sizes(mesh)} devices="
        f"{torch.distributed.get_world_size()} device={dev}")

    params = M.init_params(cfg, seed=seed, device=dev)
    ranks = torch.full((Z,), min(rank, cfg.lora.r_max), dtype=torch.int32,
                       device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    lora = LORA.init_lora_tree(gen, cfg, Z, ranks, M.target_shapes(cfg))
    opt = adamw.init_state(lora, Z)
    hp = adamw.SlotHParams.broadcast(Z, lr=lr, device=dev)
    active = torch.ones((Z,), dtype=torch.int32, device=dev)

    def placed(tree, specs):
        return PT.distribute(mesh, tree, PT.to_named(mesh, specs))

    l_specs = PT.lora_param_specs(mesh, lora)
    o_specs = PT.opt_state_specs(mesh, opt)
    params = placed(params, PT.base_param_specs(mesh, params))
    lora, opt = placed(lora, l_specs), placed(opt, o_specs)
    hp = placed(hp, PT.hp_specs(mesh, hp))
    v_spec = PT.pick_spec(mesh, (Z,), [{0: "data"}, {}])
    active, ranks = (placed(t, v_spec) for t in (active, ranks))

    ds = make_task_dataset("launch", cfg.vocab_size, seq_len=S,
                           num_train=max(4 * Z * b, 64), difficulty=0.3,
                           seed=seed)
    batcher = SlotBatcher(ds, Z, b, seed=seed)
    step = steps_dist.make_train_step(cfg, mesh)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict = {"losses": [], "step_s": [], "peak_gib": None}
    for t in range(steps):
        tokens, labels = batcher.next_batch()
        batch = {"tokens": torch.as_tensor(tokens, device=dev),
                 "labels": torch.as_tensor(labels, device=dev)}
        batch = placed(batch, PT.batch_specs(mesh, batch))
        t0 = time.perf_counter()
        lora, opt, metrics = step(params, lora, opt, hp, active, ranks,
                                  batch)
        # the step updated the local shards in place and returns them
        lora, opt = placed(lora, l_specs), placed(opt, o_specs)
        loss = metrics["per_slot_loss"].float().cpu()   # waits for the card
        dt = time.perf_counter() - t0
        out["losses"].append(loss.tolist())
        out["step_s"].append(dt)
        log(f"step {t:4d}  {dt:6.2f}s  loss/slot: "
            f"{[round(v, 3) for v in loss.tolist()]}")
        if step_hook is not None:
            step_hook(t, metrics, dt)
    if on_card:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"peak {out['peak_gib']:.2f} GiB allocated")
    out["policy_decisions"] = len(step.policy.decisions)
    log("done")
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=ASSIGNED + ["paper-llama-tiny"])
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny fp32 variant of the arch")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    shape = get_shape(args.shape)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        Z, b, S = 4, 2, 64
    else:
        Z, b = shape.decompose()
        S = shape.seq_len
    with MESH.process_group(args.device) as dev:
        mesh = build_mesh(args.mesh, dev)
        return run(cfg, Z, b, S, mesh, args.steps, lr=args.lr,
                   rank=args.rank, seed=args.seed, device=dev)


if __name__ == "__main__":
    main()
