"""Roofline report CLI: load dry-run artifacts, print the baseline table,
nominate hillclimb candidates.

The port of ``repro.roofline.report``: it reads the port's dry run
(``experiments/dryrun_torch``) and takes the peak from the port's planner
(one NVIDIA H100). ``--autotune`` has no default file: give it a tile-plan
sweep artifact to print the gap section.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh pod16x16] \\
        [--md]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import (HEADER, Roofline, load_all,
                                     ranklocal_savings)
from repro_torch.sched.profiler import PEAK_FLOPS_BF16

DEFAULT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")

# the rank-sweep tuning mix the rank-local bench trains (r = 4..64)
RANK_SWEEP = (4, 8, 16, 32, 64)


def print_ranklocal(archs: List[str], tokens_per_slot: int = 4096,
                    md: bool = False) -> None:
    """Rank-local FLOP/byte savings per config: the adapter-GEMM work the
    dead rank-tile skip reclaims vs r_max-padded execution on the
    rank-sweep mix, and the arithmetic-intensity shift that comes with
    it."""
    from repro_torch.configs.registry import get_arch
    rows = [ranklocal_savings(get_arch(a), RANK_SWEEP, tokens_per_slot)
            for a in archs]
    print("\nRank-local adapter savings (true-rank vs r_max-padded, "
          f"ranks={list(RANK_SWEEP)}, {tokens_per_slot} tok/slot):")
    if md:
        print("| arch | r_max | flops saved | bytes saved | AI padded | "
              "AI true |")
        print("|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r.arch} | {r.r_max} | x{r.flop_saving:.2f} | "
                  f"x{r.byte_saving:.2f} | {r.intensity_padded:.1f} | "
                  f"{r.intensity_true:.1f} |")
    else:
        for r in rows:
            print("  " + r.row())


def print_autotune_gap(path: Optional[str], md: bool = False,
                       mfu: float = 0.4) -> None:
    """Tuned-vs-default-vs-ceiling gap per autotuned shape key, from a
    tile-plan sweep artifact (the ``BENCH_autotune.json`` format). Three
    columns of headroom: what the tile-plan autotuner already reclaimed over
    the static constants (tuned/default), and what remains between the
    tuned kernels and the roofline ceiling (the target MFU fraction of the
    tensor cores' peak). The artifact's timings come from whatever backend
    produced it; the tuned/default ratio is the portable signal."""
    if not path or not os.path.exists(path):
        print(f"\n(no autotune artifact at {path}; pass --autotune "
              "<artifact> to populate the gap section)")
        return
    with open(path) as f:
        bench = json.load(f)
    ceiling = PEAK_FLOPS_BF16 * mfu
    sweeps = bench.get("kernel_sweeps", [])
    print(f"\nTile-plan autotune gap (ceiling = {mfu:.0%} of peak "
          f"tensor-core, {ceiling/1e12:.1f} TFLOP/s; backend: "
          f"{bench.get('backend', 'unknown')}):")
    if md:
        print("| key | default GF/s | tuned GF/s | tuned/default | "
              "bitwise | x to ceiling |")
        print("|---|---|---|---|---|---|")
    for s in sweeps:
        key = (f"d{s['d_in']}x{s['d_out']} r{s['r_max']} Z{s['Z']} "
               f"T{s['tokens']}")
        dflt = s["default_flops_per_s"]
        tuned = s["tuned_flops_per_s"]
        gap = ceiling / max(tuned, 1e-12)
        if md:
            print(f"| {key} | {dflt/1e9:.3f} | {tuned/1e9:.3f} | "
                  f"x{s['speedup']:.2f} | {s['bitwise_equal']} | "
                  f"x{gap:.3g} |")
        else:
            print(f"  {key:28s} default {dflt/1e9:8.3f} GF/s  tuned "
                  f"{tuned/1e9:8.3f} GF/s  x{s['speedup']:.2f}  "
                  f"bitwise={s['bitwise_equal']}  ceiling-gap x{gap:.3g}")
    fit = bench.get("fitted_model")
    if fit:
        print(f"  fitted step model: rel err {fit['fitted_rel_error']:.4f} "
              f"vs analytic {fit['analytic_rel_error']:.4f} on "
              f"{fit['heldout_points']} held-out points "
              f"({fit['observations']} training observations)")


def pick_hillclimb(rows: List[Roofline]) -> Dict[str, Roofline]:
    """The three §Perf pairs, chosen among compute-carrying shapes
    (train/prefill — decode MFU is intrinsically ~0 and would always win):
      * worst roofline fraction: lowest bounded MFU,
      * most collective-bound: largest absolute collective term,
      * paper-representative: the multi-LoRA train_4k with the largest
        model (the paper's AP setting at production scale).
    Ties across categories resolve to distinct pairs."""
    big = [r for r in rows if r.shape in ("train_4k", "prefill_32k")]
    rep = max((r for r in big if r.shape == "train_4k"),
              key=lambda r: r.model_flops)
    coll = max((r for r in big if (r.arch, r.shape) !=
                (rep.arch, rep.shape)), key=lambda r: r.collective_s)
    taken = {(rep.arch, rep.shape), (coll.arch, coll.shape)}
    rest = [r for r in big if (r.arch, r.shape) not in taken]
    # prefer a pair whose dominant term differs from the two collective
    # picks, so the three hillclimbs exercise different bottlenecks
    diverse = [r for r in rest if r.dominant not in (rep.dominant,
                                                     coll.dominant)]
    worst = min(diverse or rest, key=lambda r: r.mfu_bound)
    return {"worst-roofline": worst, "most-collective-bound": coll,
            "paper-representative": rep}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR)
    ap.add_argument("--mesh", default="pod16x16",
                    help="mesh for the main table (roofline is single-pod)")
    ap.add_argument("--md", action="store_true", help="markdown output")
    ap.add_argument("--autotune", default=None,
                    help="a tile-plan sweep artifact (BENCH_autotune.json "
                         "format) for the tuned-vs-default-vs-ceiling gap "
                         "section")
    args = ap.parse_args()

    rl = load_all(args.dir)
    rows = sorted((r for r in rl.values() if r.mesh == args.mesh),
                  key=lambda r: (r.arch, r.shape))
    if args.md:
        print("| arch | shape | compute_s | memory_s | collective_s | "
              "dominant | useful | MFU<= |")
        print("|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r.arch} | {r.shape} | {r.compute_s:.4f} | "
                  f"{r.memory_s:.4f} | {r.collective_s:.4f} | {r.dominant} |"
                  f" {r.useful_flops_ratio:.3f} | {r.mfu_bound:.3f} |")
    else:
        print(HEADER)
        for r in rows:
            print(r.row())
    print(f"\n{len(rows)} combos on {args.mesh} "
          f"(+{sum(1 for r in rl.values() if r.mesh != args.mesh)} on the "
          f"other mesh)")
    picks = pick_hillclimb(rows)
    print("\nHillclimb candidates (§Perf):")
    for why, r in picks.items():
        print(f"  {why:24s} -> {r.arch} x {r.shape} "
              f"(dominant={r.dominant}, MFU<={r.mfu_bound:.3f})")
    print_ranklocal(sorted({r.arch for r in rows}), md=args.md)
    print_autotune_gap(args.autotune, md=args.md)


if __name__ == "__main__":
    main()
