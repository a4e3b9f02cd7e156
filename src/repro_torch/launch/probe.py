"""How many slots the training launcher fits on one card.

    PYTHONPATH=src python -m repro_torch.launch.probe [--arch stablelm-3b] \
        [--z 1,2] [--steps 1]

For each Z, one world-size-1 NCCL process group and a 1x1 mesh, then
``launch.train.run`` at train_4k's b = 4 and S = 4,096 with all layers;
prints each run's step seconds and peak GiB, or the out-of-memory error
the card raised, beside the card's name and power limit. It needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import TRAIN_4K
from repro_torch.launch import mesh as MESH
from repro_torch.launch import train as TRAIN


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--z", default="1,2")
    ap.add_argument("--steps", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA device is available", file=sys.stderr)
        return 1

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cfg = get_arch(args.arch)
    _, b = TRAIN_4K.decompose()
    for Z in (int(v) for v in args.z.split(",")):
        torch.cuda.empty_cache()
        with MESH.process_group("cuda"):
            mesh = MESH.make_local_mesh((1, 1))
            try:
                res = TRAIN.run(cfg, Z, b, TRAIN_4K.seq_len, mesh,
                                args.steps, device="cuda", log=lambda m: None)
            except torch.OutOfMemoryError as e:   # the card's answer for Z
                print(f"Z {Z}: out of memory: {str(e).splitlines()[0]}")
                continue
        print(f"Z {Z}: {args.steps} step(s) of "
              f"{[round(v, 3) for v in res['step_s']]} s, peak "
              f"{res['peak_gib']:.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
