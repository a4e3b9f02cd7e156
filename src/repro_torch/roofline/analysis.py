"""Three-term roofline from the dry run's record (one NVIDIA H100 a chip).

    compute term    = FLOPs / (chips * peak_FLOP/s)
    memory term     = bytes / (chips * HBM_bw)
    collective term = collective_bytes / (chips * link_bw)

A copy of ``repro.roofline.analysis`` with the target constants of the H100
in place of the TPU v5e's; the rest is verbatim. Sources: the dry run's
counts taken from torch (``roofline/hlo.py``): FLOPs from
``FlopCounterMode`` over the traced step, remat's recompute included; memory
bytes = 2x the materialised result bytes (one write + one read per buffer);
collective bytes from the placements' collective schedule under the ring
model. All terms are PER-DEVICE per step: ``launch/dryrun.py`` divides the
global trace's counts by the chip count, so no further division here.

Hardware constants (one NVIDIA H100 SXM; NVIDIA's data sheet): the dense
bf16 peak and the HBM3 rate are the planner's (``sched/profiler.py``), so
the port has one source for each. ``ICI_BW`` is the data sheet's NVLink
figure, 900 GB/s bidirectional, taken as 450 GB/s a direction; ``DCN_BW``
is one NDR InfiniBand port, 400 Gb/s = 50 GB/s. A 16-wide mesh axis is
wider than one 8-GPU HGX board, whose NVLink domain ends at 8 cards, so the
collective term is a lower bound. Neither rate is measured: the machine
with the card holds one.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Sequence, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.configs.shapes import get_shape
from repro_torch.sched.profiler import HBM_BYTES_PER_S, PEAK_FLOPS_BF16

PEAK_FLOPS = PEAK_FLOPS_BF16   # bf16 per chip
HBM_BW = HBM_BYTES_PER_S       # bytes/s per chip
ICI_BW = 450e9                 # bytes/s per direction (NVLink 4)
DCN_BW = 50e9                  # cross-pod (one NDR port)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float          # useful 6ND-style flops (global)
    hlo_flops: float            # per-device, trip-weighted
    hlo_bytes: float            # per-device traffic estimate
    collective_bytes: float     # per-device
    chips: int

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Roofline step-time lower bound (no overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs * chips): how much compiled compute is
        useful — catches remat/redundancy waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Best-achievable MFU at this roofline: useful flops / peak over
        the binding term."""
        t = self.step_time_lb
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * PEAK_FLOPS * t)

    def row(self) -> str:
        return (f"{self.arch:24s} {self.shape:12s} {self.mesh:10s} "
                f"{self.compute_s:9.4f} {self.memory_s:9.4f} "
                f"{self.collective_s:10.4f} {self.dominant:10s} "
                f"{self.useful_flops_ratio:6.3f} {self.mfu_bound:6.3f}")


def model_flops(cfg: ModelConfig, shape: ShapeConfig,
                lora_rank: int = 16) -> float:
    """Useful FLOPs per step: training 4ND (frozen base: fwd + act-grad
    only) + 6N_lora*D; prefill 2ND; decode 2N per token * batch."""
    n_active = cfg.param_count(active_only=True)
    n_lora = cfg.lora_param_count(lora_rank)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return (4.0 * n_active + 6.0 * n_lora) * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * (n_active + n_lora) * tokens
    # decode: one token per sequence
    return 2.0 * (n_active + n_lora) * shape.global_batch


@dataclasses.dataclass
class RankLocalSavings:
    """Adapter-GEMM FLOP/byte accounting for one slot stack, true-rank
    (rank-local kernels: dead rank tiles skip) vs r_max-padded (the
    historical zero-masked execution, every slot billed at r_max).

    FLOPs: 6 * N_lora(r) * tokens per slot (fwd XA/SB + bwd dS/dX/dA/dB).
    Bytes (estimate): adapter params 8B/param (bf16 fwd read + bwd read +
    fp32 grad write) plus the rank-scaled S/dS activations (~8B per
    token*rank per adapter site). Arithmetic intensity = FLOPs/byte —
    padding inflates both axes, so the savings report shows how much MXU
    work AND HBM traffic true-rank compute reclaims per config."""
    arch: str
    r_max: int
    ranks: Tuple[int, ...]
    tokens_per_slot: int
    flops_true: float
    flops_padded: float
    bytes_true: float
    bytes_padded: float

    @property
    def flop_saving(self) -> float:
        return self.flops_padded / self.flops_true if self.flops_true else 0.0

    @property
    def byte_saving(self) -> float:
        return self.bytes_padded / self.bytes_true if self.bytes_true else 0.0

    @property
    def intensity_true(self) -> float:
        return self.flops_true / self.bytes_true if self.bytes_true else 0.0

    @property
    def intensity_padded(self) -> float:
        return (self.flops_padded / self.bytes_padded
                if self.bytes_padded else 0.0)

    def row(self) -> str:
        rk = ",".join(map(str, self.ranks))
        return (f"{self.arch:24s} r_max={self.r_max:<3d} ranks=[{rk:20s}] "
                f"flops x{self.flop_saving:5.2f} bytes x{self.byte_saving:5.2f} "
                f"AI {self.intensity_padded:6.1f}->{self.intensity_true:6.1f}")


def _adapter_gemm_accounting(cfg: ModelConfig, rank: int,
                             tokens: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one adapter's six grouped GEMMs at ``rank``."""
    n = cfg.lora_param_count(rank)
    flops = 6.0 * n * tokens
    sites = len(cfg.lora.targets) * cfg.num_layers
    bytes_ = 8.0 * n + 8.0 * tokens * rank * sites
    return flops, bytes_


def ranklocal_savings(cfg: ModelConfig, ranks: Sequence[int],
                      tokens_per_slot: int = 4096,
                      r_max: int = 0) -> RankLocalSavings:
    """Rank-local vs r_max-padded adapter arithmetic for a slot stack
    with per-slot true ranks ``ranks`` (each slot trains
    ``tokens_per_slot`` tokens per step)."""
    r_max = r_max or cfg.lora.r_max
    ft = fp = bt = bp = 0.0
    for r in ranks:
        f, b = _adapter_gemm_accounting(cfg, min(int(r), r_max),
                                        tokens_per_slot)
        ft += f
        bt += b
        f, b = _adapter_gemm_accounting(cfg, r_max, tokens_per_slot)
        fp += f
        bp += b
    return RankLocalSavings(
        arch=cfg.name, r_max=r_max, ranks=tuple(int(r) for r in ranks),
        tokens_per_slot=tokens_per_slot, flops_true=ft, flops_padded=fp,
        bytes_true=bt, bytes_padded=bp)


def from_dryrun(d: Dict) -> Roofline:
    """Build the roofline from a dryrun JSON record (analyzer fields)."""
    chips = 512 if d["mesh"] == "pod2x16x16" else 256
    cfg = get_arch(d["arch"])
    shape = get_shape(d["shape"])
    flops = d["flops"]
    bytes_ = d["hlo_bytes"]
    coll = d["collective_traffic"]
    return Roofline(
        arch=d["arch"], shape=d["shape"], mesh=d["mesh"],
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes_ / HBM_BW,
        collective_s=coll / ICI_BW,
        model_flops=model_flops(cfg, shape),
        hlo_flops=flops, hlo_bytes=bytes_, collective_bytes=coll,
        chips=chips)


HEADER = (f"{'arch':24s} {'shape':12s} {'mesh':10s} "
          f"{'compute_s':>9s} {'memory_s':>9s} {'collect_s':>10s} "
          f"{'dominant':10s} {'useful':>6s} {'MFU<=':>6s}")


def load_all(dryrun_dir: str) -> Dict[str, Roofline]:
    out = {}
    for mesh_name in sorted(os.listdir(dryrun_dir)):
        mdir = os.path.join(dryrun_dir, mesh_name)
        if not os.path.isdir(mdir):
            continue
        for fn in sorted(os.listdir(mdir)):
            if not fn.endswith(".json"):
                continue
            with open(os.path.join(mdir, fn)) as f:
                d = json.load(f)
            if not d.get("ok"):
                continue
            r = from_dryrun(d)
            out[f"{r.arch}|{r.shape}|{r.mesh}"] = r
    return out
