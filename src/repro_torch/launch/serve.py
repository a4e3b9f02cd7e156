"""Batched multi-adapter serving driver (decode path) of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \
        --reduced --requests 8 --max-new 16 --seed 3 --ranks 2,4,8

Same flags as ``python -m repro.launch.serve``, plus ``--device`` (the
card by default; ``--device cpu`` runs on the CPU). Publishes a set of
adapters into an ``AdapterPool`` (per-slot TRUE ranks via ``--ranks``),
then drives prefill + decode for a batch of requests through the
``ServingReplica``/``ServingFrontend`` path. The prompts are the JAX CLI's
for the same seed; the weights are random from ``torch.Generator``s.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import ASSIGNED, get_arch
from repro_torch.core import lora as LORA
from repro_torch.data.synthetic import make_task_dataset
from repro_torch.models import model as M
from repro_torch.models.common import resolve_device
from repro_torch.serve import AdapterPool, ServingFrontend, ServingReplica


def _parse_ranks(spec: str, Z: int, r_max: int) -> list:
    """``--ranks 2,4,8``: one TRUE rank per slot (repeating the last entry
    to fill); empty spec keeps the default min(8, r_max)."""
    if not spec:
        return [min(8, r_max)] * Z
    vals = [int(v) for v in spec.split(",") if v]
    if not vals or not all(1 <= v <= r_max for v in vals):
        raise SystemExit(f"--ranks entries must be in [1, {r_max}]")
    return (vals + [vals[-1]] * Z)[:Z]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b",
                    choices=ASSIGNED + ["paper-llama-tiny"])
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per adapter slot")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="base-model + adapter init seed")
    ap.add_argument("--ranks", default="",
                    help="comma-separated per-slot TRUE ranks, e.g. 2,4,8 "
                         "(default: uniform min(8, r_max))")
    ap.add_argument("--ring", action="store_true",
                    help="sliding-window ring cache (long-context mode)")
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "round"],
                    help="continuous = per-lane positions, zero join "
                         "barrier; round = epoch batching")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy, the default)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="top-k truncation for sampling (0 = full vocab)")
    ap.add_argument("--sample-seed", type=int, default=0,
                    help="replica-level seed for sampling")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    Z, b, P = args.slots, args.requests, args.prompt_len
    params = M.init_params(cfg, seed=args.seed, device=dev)
    ranks = _parse_ranks(args.ranks, Z, cfg.lora.r_max)

    pool = AdapterPool(cfg, Z, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    stack = LORA.init_lora_tree(gen, cfg, Z,
                                torch.tensor(ranks, dtype=torch.int32),
                                M.target_shapes(cfg))
    for z in range(Z):
        adapter = {t: {m: x[:, z] for m, x in ab.items()}
                   for t, ab in stack.items()}
        pool.publish(f"adapter-{z}", adapter, ranks[z])

    replica = ServingReplica(cfg, params, pool, lanes=b,
                             max_len=P + args.max_new, ring=args.ring,
                             sample_seed=args.sample_seed, device=dev)
    frontend = ServingFrontend(replica, mode=args.mode)

    ds = make_task_dataset("serve", cfg.vocab_size, seq_len=P,
                           num_train=Z * b, difficulty=0.3, seed=args.seed)
    prompts = ds.train[:Z * b, :P].reshape(Z, b, P)
    rids = [[frontend.submit(f"adapter-{z}", prompts[z, i], args.max_new,
                             temperature=args.temperature,
                             top_k=args.top_k, seed=z * b + i)
             for i in range(b)] for z in range(Z)]

    t0 = time.perf_counter()
    out = frontend.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0

    toks_per_s = replica.total_generated / max(wall, 1e-9)
    print(f"arch={cfg.name} Z={Z} b={b} ranks={ranks} seed={args.seed} "
          f"ring={replica.ring} mode={args.mode} device={dev} "
          f"temperature={args.temperature} top_k={args.top_k}")
    print(f"served {replica.total_generated} tokens in {wall:.2f}s over "
          f"{replica.total_decode_steps} fused steps "
          f"({toks_per_s:.1f} tok/s aggregate, {dev})")
    for z in range(Z):
        print(f"  adapter {z} (rank {ranks[z]}) req 0 continuation: "
              f"{out[rids[z][0]][:12]}")


if __name__ == "__main__":
    main()
