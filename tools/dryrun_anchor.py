"""The dry run at the training launcher's own step: stablelm-3b at full
width and depth, Z 1, b 4, S 4,096, on a 1 x 1 mesh over a one-rank fake
group (``launch/train.py`` runs the same step on one card). Prints the
dry run's per-device argument and temporary bytes, the temporary peak of
one direct trace at all 32 layers beside the 1-and-2-layer extrapolation,
the FLOPs and bytes, and the roofline terms and step lower bound at one
H100's constants, with ``model_flops`` at the launcher's rank 8.

    PYTHONPATH=src python3 tools/dryrun_anchor.py

Shapes only, on the CPU; no card. Run from the root of a checkout."""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import KIND_TRAIN, ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402

GIB = 2 ** 30


def main() -> None:
    cfg = get_arch("stablelm-3b")
    shape = ShapeConfig("launch", 4096, 4, KIND_TRAIN, num_slots=1,
                        per_adapter_batch=4)
    with MESH.fake_group(1):
        mesh = MESH.make_local_mesh((1, 1), device="cpu")
        low = DR.lower_step(cfg, shape, mesh)
        direct = DR.trace_step(cfg, shape, mesh)
    args = {k: round(v / GIB, 3) for k, v in low.arguments.items()}
    print(f"arguments (GiB): {args}; total {low.argument_bytes / GIB:.3f}")
    print(f"temp (GiB): extrapolated from {DR.DEPTHS} layers "
          f"{low.temp_bytes / GIB:.3f}; one trace at {cfg.num_layers} layers "
          f"{direct['temp_bytes'] / GIB:.3f}")
    print(f"memory_per_device (GiB): "
          f"{(low.argument_bytes + low.temp_bytes) / GIB:.3f}")
    r = RA.Roofline(
        arch=cfg.name, shape=shape.name, mesh="1x1",
        compute_s=low.flops / RA.PEAK_FLOPS,
        memory_s=2.0 * low.bytes_written / RA.HBM_BW,
        collective_s=0.0,
        model_flops=RA.model_flops(cfg, shape, lora_rank=8),
        hlo_flops=low.flops, hlo_bytes=2.0 * low.bytes_written,
        collective_bytes=0.0, chips=1)
    print(f"flops {low.flops:.4e} (direct at {cfg.num_layers} layers "
          f"{direct['flops']:.4e}); hlo_bytes {r.hlo_bytes:.4e}; "
          f"model_flops (rank 8) {r.model_flops:.4e}")
    print(f"roofline (H100: {RA.PEAK_FLOPS:.3g} FLOP/s, {RA.HBM_BW:.3g} B/s): "
          f"compute {r.compute_s:.4f} s, memory {r.memory_s:.4f} s, "
          f"dominant {r.dominant}, step >= {r.step_time_lb:.4f} s, useful "
          f"{r.useful_flops_ratio:.3f}, MFU <= {r.mfu_bound:.3f}")


if __name__ == "__main__":
    main()
