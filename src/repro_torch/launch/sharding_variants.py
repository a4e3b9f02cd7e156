"""Paper Fig. 13: Adapter Parallelism vs FSDP-style multi-LoRA.

The port of ``repro.launch.sharding_variants``. Traces the SAME train step
on the production mesh (a ``fake`` 256-rank group, ``launch/dryrun.py``)
under two sharding policies and compares the collective traffic that each
one's placements must move, the per-device argument bytes and the roofline
step bound:

  AP   (ours)   : adapter slots Z sharded over "data"; adapter params,
                  grads, optimizer state rank-local (zero adapter
                  collectives over "data").
  FSDP (baseline): adapters REPLICATED over "data" (the paper's "redundant
                  replication"), batch slots still sharded for compute, so
                  every step pays an adapter-gradient all-reduce over
                  "data" (one bucket, 2 (n-1)/n of the adapters' bytes)
                  plus 16x adapter/optimizer memory.

The two share everything else: the traced FLOPs and temporaries, the base
weights' gathers over "data" and the residual's all-gathers and
reduce-scatters over "model". Neither puts adapter traffic on "model": the
dry run's schedule leaves out the adapters' partial sums over a base
weight's output split (``launch/dryrun.py``), in both variants alike.

    PYTHONPATH=src python -m repro_torch.launch.sharding_variants [--arch X]
Writes experiments/ap_vs_fsdp_torch/<arch>__<shape>__<variant>.json.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import mesh as MESH
from repro_torch.launch import partitioning as PT
from repro_torch.launch.dryrun import Lowered, abstract_state, lower_step
from repro_torch.optim import adamw
from repro_torch.roofline import hlo as HLO

OUT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                   "experiments", "ap_vs_fsdp_torch")


def lower(cfg: ModelConfig, shape: ShapeConfig, mesh,
          variant: str) -> Lowered:
    """The train step of ``cfg`` at ``shape`` on ``mesh`` under
    ``variant`` ("ap" or "fsdp")."""
    if variant == "ap":
        return lower_step(cfg, shape, mesh)
    if variant != "fsdp":
        raise ValueError(variant)
    Z, _ = shape.decompose()
    _, lora, _ = abstract_state(cfg, Z)
    # adapters + optimizer replicated over "data" (paper's FSDP mode)
    l_specs = PT._map(lora, lambda _: PT.P())
    o_specs = adamw.AdamWState(mu=l_specs, nu=l_specs, count=PT.P())
    hp_specs = adamw.SlotHParams(*[PT.P()] * len(adamw.SlotHParams._fields))
    return lower_step(cfg, shape, mesh, lora_specs=l_specs,
                      opt_specs=o_specs, hp_specs=hp_specs,
                      vec_spec=PT.P())


def lower_variant(arch: str, shape_name: str, variant: str) -> dict:
    cfg = get_arch(arch)
    with MESH.fake_group(256):
        mesh = MESH.make_production_mesh(device_type="cpu")
        low = lower(cfg, get_shape(shape_name), mesh, variant)
    rec = {
        "arch": arch, "shape": shape_name, "variant": variant,
        "flops": low.flops, "hlo_bytes": 2.0 * low.bytes_written,
        "collective_traffic": HLO.total_traffic(low.collectives),
        "collectives": HLO.summarize(low.collectives),
        "collectives_by_axis": low.by_axis(),
        "argument_bytes": low.argument_bytes,
        "argument_bytes_by_input": low.arguments,
        "temp_bytes": low.temp_bytes,
    }
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(
            OUT, f"{arch}__{shape_name}__{variant}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--shape", default="train_4k")
    args = ap.parse_args()
    for variant in ("ap", "fsdp"):
        r = lower_variant(args.arch, args.shape, variant)
        print(f"{variant}: coll={r['collective_traffic']:.3e} "
              f"bytes={r['hlo_bytes']:.3e} args={r['argument_bytes']:.3e}")


if __name__ == "__main__":
    main()
