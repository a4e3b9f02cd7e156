"""Production training launcher of the PyTorch port: the Adapter-Parallel
multi-LoRA train step with the production sharding rules on a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
        --shape train_4k --steps 10 [--reduced] [--mesh dxm]

The reference's flags (``python -m repro.launch.train``), plus ``--device``
(the card by default; ``--device cpu`` runs on the CPU), ``--backend``
(``nccl`` or ``gloo``; the default is NCCL on the card, gloo on the CPU),
``--ranks`` (per-slot adapter ranks, bound to the rank-local kernels),
``--seed`` (the random weights, adapters and data), ``--layers`` (a depth
cut: the first N layers of the architecture) and ``--out`` (rank 0 writes
the per-slot losses and the updated adapters of every slot as ``.npz``). ``--reduced`` takes the tiny fp32 variant of the architecture at
Z 4, b 2, S 64; otherwise Z and b come from the shape (``train_4k``: Z 64,
b 4, S 4,096), and the step tries them as they are: nothing cuts Z.

``--mesh dxm`` runs over d·m ranks, started torchrun-style (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); 1x1 needs
none of them. Every rank builds the same full weights, adapters and batches
from the seed, and ``partitioning.distribute`` keeps its shards: the slots
of its data rank (Adapter Parallelism) and its blocks of the backbone over
"model". The dense, MoE, ssm, hybrid, vlm and audio families run sharded
(``partitioning.check_sharded`` names what does not); an MoE rank routes
its data rank's tokens and runs its block of the experts, an RWKV or Mamba
rank its block of the scan heads. A ``mixed`` config's batch (Qwen2-VL's)
holds what the reference's dry run gives it: the stub vision tower's
``num_modality_tokens`` patch embeddings a sequence (``modal_embeds``,
N(0, 0.02) from the seed, labels -1 over them) and the M-RoPE positions of
their patch grid and the text after it, one grid for the first half of the
slots and another for the second (``patch_grids``). After the steps one
sharded eval step runs on the next batch with the trained adapters. Four
ranks on the CPU:

    for r in 0 1 2 3; do RANK=$r WORLD_SIZE=4 MASTER_ADDR=127.0.0.1 \\
      MASTER_PORT=29511 PYTHONPATH=src python -m repro_torch.launch.train \\
      --reduced --mesh 2x2 --steps 2 --device cpu --backend gloo & done; wait

On one card shared by several ranks pass ``--backend gloo`` (NCCL takes one
card a rank).

``run(cfg, Z, b, S, mesh, steps, ...)`` is the body, for callers that build
their own config or mesh; ``main(argv)`` parses the flags and calls it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.configs.shapes import get_shape
from repro_torch.core import lora as LORA
from repro_torch.data.synthetic import SlotBatcher, make_task_dataset
from repro_torch.launch import mesh as MESH
from repro_torch.launch import partitioning as PT
from repro_torch.launch import steps_dist
from repro_torch.models import model as M
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.optim import adamw


def build_mesh(spec: str, device=None):
    """``--mesh dxm`` over the initialized process group (d·m ranks)."""
    d, m = (int(x) for x in spec.split("x"))
    return MESH.make_local_mesh((d, m), ("data", "model"), device=device)


def init_bytes(cfg: ModelConfig) -> int:
    """The card bytes a rank holds while it draws ``cfg``'s full weights:
    three times the weights' bytes (the weights, the fp32 draws of the
    largest leaves and the allocator's slack: llama4-scout's 2 layers, 13
    GB of weights, reserve ~24 GB while they are drawn)."""
    return 3 * cfg.param_count() * dtype_of(cfg.dtype).itemsize


def _card_turns(cfg: ModelConfig, dev) -> tuple:
    """(this rank's turn, the turns): the ranks of the group that share
    this rank's card build the full weights and keep their shards as many
    at a time as the card holds (``init_bytes`` a rank), in rank order
    (three llama4-scout ranks at 2 layers at once do not fit an 80 GB card
    beside other processes). A rank with a card of its own, or on the CPU:
    (0, 1)."""
    world = torch.distributed.get_world_size()
    if dev.type != "cuda" or world == 1:
        return 0, 1
    me = (str(torch.cuda.get_device_properties(dev).uuid),
          torch.cuda.mem_get_info(dev)[0])
    got = [None] * world
    torch.distributed.all_gather_object(got, me)
    need = init_bytes(cfg)
    cards = {u: [r for r, (v, _) in enumerate(got) if v == u]
             for u, _ in got}
    # ranks at once: the fewest any card holds
    at_once = max(1, min(min(got[r][1] for r in rs) // need
                         for rs in cards.values()))
    turns = max(-(-len(rs) // at_once) for rs in cards.values())
    return (cards[me[0]].index(torch.distributed.get_rank()) // at_once,
            turns)


def _launch_counts() -> Dict[str, Dict[str, int]]:
    """Every kernel's launch counter, by kernel set."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.grouped_lora import grouped_lora as GL
    from repro_torch.kernels.grouped_lora import ragged as RG
    from repro_torch.kernels.grouped_lora import ranklocal as RL
    from repro_torch.kernels.linear_scan import linear_scan as LS
    return {"dense": dict(GL.LAUNCHES), "ragged": dict(RG.LAUNCHES),
            "rank-local": dict(RL.LAUNCHES), "flash": dict(FA.LAUNCHES),
            "scan": dict(LS.LAUNCHES)}


def patch_grids(P: int) -> tuple:
    """Two (rows, cols) grids of ``P`` patches: the squarest, and one with
    half its rows and twice its columns (a single row where its rows are
    odd): 16 x 16 and 8 x 32 for Qwen2-VL's 256."""
    a = max(r for r in range(1, P + 1) if P % r == 0 and r * r <= P)
    return (a, P // a), ((a // 2, 2 * P // a) if a % 2 == 0 else (1, P))


def image_positions(grid, S: int, device=None) -> torch.Tensor:
    """[3, S] M-RoPE positions of a patch-grid prefix and the text after
    it: patch (row, col) at (0, row, col), text token i at (G + i, G + i,
    G + i) with G = max(grid) (Qwen2-VL's rule for one still image at the
    start of a sequence)."""
    rows, cols = grid
    idx = torch.arange(rows * cols, device=device)
    text = max(grid) + torch.arange(S - rows * cols, device=device)
    return torch.stack([torch.cat([torch.zeros_like(idx), text]),
                        torch.cat([idx // cols, text]),
                        torch.cat([idx % cols, text])]).to(torch.int32)


def modal_inputs(cfg: ModelConfig, Z: int, b: int, S: int, gen,
                 device) -> Dict[str, torch.Tensor]:
    """A ``mixed`` config's stub inputs for a [Z, b, S] batch:
    "modal_embeds" [Z, b, P, d] in the model dtype, N(0, 0.02) from
    ``gen``, and "positions" [3, Z, b, S], the first half of the slots on
    ``patch_grids(P)[0]``, the rest on its second grid."""
    P = cfg.num_modality_tokens
    emb = 0.02 * torch.randn(Z, b, P, cfg.d_model, generator=gen,
                             device=device)
    grids = patch_grids(P)
    pos = torch.stack([image_positions(grids[z >= Z // 2 and Z > 1], S,
                                       device) for z in range(Z)], dim=1)
    return {"modal_embeds": emb.to(dtype_of(cfg.dtype)),
            "positions": pos[:, :, None].expand(3, Z, b, S).contiguous()}


def batches(cfg: ModelConfig, Z: int, b: int, S: int, seed: int = 0,
            device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """``run``'s batches, whole (every slot), in order: tokens and labels
    of the seed's synthetic task and, for a ``mixed`` config,
    ``modal_inputs`` from the seed with labels -1 over the prefix."""
    ds = make_task_dataset("launch", cfg.vocab_size, seq_len=S,
                           num_train=max(4 * Z * b, 64), difficulty=0.3,
                           seed=seed)
    batcher = SlotBatcher(ds, Z, b, seed=seed)
    modal_gen = torch.Generator(device=device).manual_seed(seed + 2)
    while True:
        tokens, labels = batcher.next_batch()
        batch = {"tokens": torch.as_tensor(tokens, device=device),
                 "labels": torch.as_tensor(labels, device=device)}
        if cfg.input_mode == "mixed":
            batch.update(modal_inputs(cfg, Z, b, S, modal_gen, device))
            batch["labels"][:, :, :cfg.num_modality_tokens] = -1
        yield batch


def run(cfg: ModelConfig, Z: int, b: int, S: int, mesh, steps: int, *,
        lr: float = 1e-3, rank: int = 8,
        ranks: Optional[Sequence[int]] = None, seed: int = 0, device=None,
        step_hook: Optional[Callable[[int, Dict, float], None]] = None,
        eval_trees: Optional[Callable[[], Sequence[Dict]]] = None,
        widths: Optional[Sequence[int]] = None,
        log: Callable[[str], None] = print) -> Dict:
    """``steps`` Adapter-Parallel train steps of ``cfg`` on ``mesh`` with
    Z slots of b sequences of S tokens, every slot at ``min(rank, r_max)``,
    or slot z at ``ranks[z]`` with the ranks bound (``slot_ranks``: the
    rank-local kernels). With ``widths``, slot z keeps the first
    ``widths[z]`` <= b rows of each batch and the rest is padding (tokens
    0, labels -1, as the executor's ``_assemble`` pads a lane), its
    ``slot_rows`` (widths[z] · S) bound: ragged slot widths.
    ``step_hook(t, metrics, seconds)`` runs after each
    step. The batches are ``batches``'s. After the steps (but with
    ``widths``: the eval step takes no slot rows, in the reference as
    here), one eval step on
    the next batch with the trained adapters, then, on the same weights and
    batch, one with each adapter tree that ``eval_trees()`` returns (whole
    trees of every slot, {target: {"A", "B"}}). Returns {"losses": per
    step the [Z] per-slot losses (all slots, gathered over "data"),
    "eval": the [Z] per-slot eval losses, "evals": those of each of
    ``eval_trees()``, "step_s": seconds per step, "peak_gib" and
    "eval_peak_gib": the card's peak allocated GiB over the steps and over
    the eval step (None on the CPU), "lora": this rank's updated adapters
    (its slots), "collectives": the records the steps logged
    (``launch/collectives.py``), "launches" and "eval_launches": the
    kernel launches of the steps and of the eval step, by set}."""
    dev = resolve_device(device)
    t_setup = time.perf_counter()
    log(f"arch={cfg.name} Z={Z} b={b} S={S} layers={cfg.num_layers} "
        f"mesh={MESH.axis_sizes(mesh)} devices="
        f"{torch.distributed.get_world_size()} device={dev}")

    per_slot = [min(rank, cfg.lora.r_max)] * Z if ranks is None else \
        list(ranks)
    if len(per_slot) != Z:
        raise ValueError(f"{len(per_slot)} ranks for {Z} slots")
    ranks_t = torch.tensor(per_slot, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    lora = LORA.init_lora_tree(gen, cfg, Z, ranks_t, M.target_shapes(cfg))
    opt = adamw.init_state(lora, Z)
    hp = adamw.SlotHParams.broadcast(Z, lr=lr, device=dev)
    active = torch.ones((Z,), dtype=torch.int32, device=dev)

    def placed(tree, specs):
        return PT.distribute(mesh, tree, PT.to_named(mesh, specs))

    l_named = PT.to_named(mesh, PT.lora_param_specs(mesh, lora))
    o_named = PT.to_named(mesh, PT.opt_state_specs(mesh, opt))
    turn, turns = _card_turns(cfg, dev)
    for t in range(turns):
        if t == turn:
            params = M.init_params(cfg, seed=seed, device=dev)
            params = placed(params, PT.base_param_specs(mesh, params))
            if dev.type == "cuda" and turns > 1:
                torch.cuda.empty_cache()   # the full weights, for the next
        if turns > 1:
            torch.distributed.barrier()
    lora = PT.distribute(mesh, lora, l_named)
    opt = PT.distribute(mesh, opt, o_named)
    hp = placed(hp, PT.hp_specs(mesh, hp))
    v_spec = PT.pick_spec(mesh, (Z,), [{0: "data"}, {}])
    active, ranks_t = (placed(t, v_spec) for t in (active, ranks_t))

    stream = batches(cfg, Z, b, S, seed, dev)
    step = steps_dist.make_train_step(cfg, mesh)

    def next_batch() -> Dict:
        batch = next(stream)
        if widths is not None:
            for z, w in enumerate(widths):
                batch["tokens"][z, w:] = 0
                batch["labels"][z, w:] = -1
            batch["slot_rows"] = torch.tensor([w * S for w in widths],
                                              dtype=torch.int32, device=dev)
        batch = placed(batch, PT.batch_specs(mesh, batch))
        if ranks is not None:
            batch["slot_ranks"] = ranks_t
        return batch

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out: Dict = {"losses": [], "step_s": [], "peak_gib": None}
    log(f"set-up {time.perf_counter() - t_setup:.2f} s (weights, adapters, "
        f"placement)")
    before = _launch_counts()
    for t in range(steps):
        batch = next_batch()
        t0 = time.perf_counter()
        lora, opt, metrics = step(params, lora, opt, hp, active, ranks_t,
                                  batch)
        # the step updated the local shards in place and returns them
        lora = PT.from_local(mesh, lora, l_named)
        opt = PT.from_local(mesh, opt, o_named)
        loss = metrics["per_slot_loss"].float().cpu()   # waits for the card
        dt = time.perf_counter() - t0
        out["losses"].append(loss.tolist())
        out["step_s"].append(dt)
        log(f"step {t:4d}  {dt:6.2f}s  loss/slot: "
            f"{[round(v, 3) for v in loss.tolist()]}")
        if step_hook is not None:
            step_hook(t, metrics, dt)
    after = _launch_counts()
    out["launches"] = {fam: {k: after[fam][k] - before[fam][k] for k in ks}
                       for fam, ks in after.items()}
    records = step.policy.spmd.log if step.policy.spmd is not None else []
    out["collectives"] = list(records)
    if on_card:
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"peak {out['peak_gib']:.2f} GiB allocated")
    out["policy_decisions"] = len(step.policy.decisions)
    if widths is not None:
        out["lora"] = PT.local(lora)
        log(f"launches {json.dumps(out['launches'])}")
        log("done")
        return out
    eval_step, batch = steps_dist.make_eval_step(cfg, mesh), next_batch()
    out["eval_peak_gib"] = None
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    before = _launch_counts()
    out["eval"] = eval_step(params, lora, active, batch).float().cpu(
        ).tolist()
    after = _launch_counts()
    out["eval_launches"] = {fam: {k: after[fam][k] - before[fam][k]
                                  for k in ks} for fam, ks in after.items()}
    log(f"eval loss/slot: {[round(v, 3) for v in out['eval']]}")
    if on_card:
        out["eval_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        log(f"eval peak {out['eval_peak_gib']:.2f} GiB allocated")
    out["evals"] = []
    for tree in eval_trees() if eval_trees is not None else ():
        other = PT.distribute(mesh, {
            t: {k: v.to(dev, lora[t][k].dtype) for k, v in ab.items()}
            for t, ab in tree.items()}, l_named)
        out["evals"].append(
            eval_step(params, other, active, batch).float().cpu().tolist())
    out["lora"] = PT.local(lora)
    log(f"launches {json.dumps(out['launches'])}")
    log(f"eval launches {json.dumps(out['eval_launches'])}")
    log(f"collective bytes {json.dumps(collective_bytes(records))}")
    log(f"collective shapes {json.dumps(collective_shapes(records))}")
    log("done")
    return out


def collective_bytes(records) -> Dict[str, Dict[str, int]]:
    """{axis: {role: bytes}} of collective records."""
    out: Dict[str, Dict[str, int]] = {}
    for r in records:
        by_role = out.setdefault(r.axis, {})
        by_role[r.role] = by_role.get(r.role, 0) + r.bytes
    return out


def collective_shapes(records) -> list:
    """The distinct [axis, role, kind, last dim] of collective records."""
    return sorted({(r.axis, r.role, r.kind, r.shape[-1] if r.shape else 0)
                   for r in records})


def write_out(path: str, mesh, res: Dict) -> None:
    """Rank 0 writes ``path`` (.npz): "losses" [steps, Z], "eval" [Z]
    (where ``res`` has it) and each adapter leaf "lora/<target>/<A|B>"
    [L, Z, ...] of every slot. The first model rank of each other data
    rank (on a pod mesh, of pod rank 0: the pod ranks hold the same
    adapters) leaves its slots in a file beside it, which rank 0 merges
    and removes (a file, so that no adapter crosses the data axis)."""
    import numpy as np
    sizes = MESH.axis_sizes(mesh)
    d = sizes.get("data", 1)
    me = mesh.get_local_rank("data") if d > 1 else 0
    first = all(sizes.get(a, 1) == 1 or mesh.get_local_rank(a) == 0
                for a in ("model", "pod"))
    mine = ({f"lora/{t}/{k}": v.detach().float().cpu().numpy()
             for t, ab in res["lora"].items() for k, v in ab.items()}
            if first else {})
    losses = {"losses": np.asarray(res["losses"], np.float32)}
    if "eval" in res:
        losses["eval"] = np.asarray(res["eval"], np.float32)
    parts = [f"{path}.data{i}.npz" for i in range(d)]
    if d == 1:
        if first:
            np.savez(path, **losses, **mine)
        return
    if first and me:
        np.savez(parts[me], **mine)
    torch.distributed.barrier()
    if torch.distributed.get_rank() == 0:
        got = [mine] + [dict(np.load(p)) for p in parts[1:]]
        np.savez(path, **losses,
                 **{k: np.concatenate([g[k] for g in got], axis=1)
                    for k in mine})
        for p in parts[1:]:
            os.remove(p)
    torch.distributed.barrier()


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
    ap.add_argument("--ranks", default=None,
                    help="per-slot ranks, comma-separated (binds them)")
    ap.add_argument("--slots", type=int, default=None, help="override Z")
    ap.add_argument("--batch", type=int, default=None, help="override b")
    ap.add_argument("--seq", type=int, default=None, help="override S")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: nccl on the card, gloo on the CPU")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to the first N layers")
    ap.add_argument("--out", default=None,
                    help="rank 0 writes losses and adapters here (.npz)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    shape = get_shape(args.shape)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        Z, b, S = 4, 2, 64
    else:
        Z, b = shape.decompose()
        S = shape.seq_len
    Z, b, S = args.slots or Z, args.batch or b, args.seq or S
    ranks = ([int(r) for r in args.ranks.split(",")] if args.ranks
             else None)
    with MESH.process_group(args.device, backend=args.backend) as dev:
        mesh = build_mesh(args.mesh, dev)
        res = run(cfg, Z, b, S, mesh, args.steps, lr=args.lr,
                  rank=args.rank, ranks=ranks, seed=args.seed, device=dev)
        if args.out:
            write_out(args.out, mesh, res)
    return res


if __name__ == "__main__":
    main()
