"""The grouped-LoRA kernel sources against the profile parser that reads
their names (CPU only).

``chip_smoke.py`` charges each profiled grouped-LoRA kernel to a set
(rank-local, ragged, dense) by its template name and its last two template
arguments, ROWS and RANKS, and the per-set and per-kernel device times in
PERF.md rest on that attribution. These tests read
``csrc/ranklocal_common.cuh``: every ``__global__`` template keeps ``bool
ROWS, bool RANKS`` as its last two parameters, and a demangled name of each
template's three instantiations, as the profiler reports it, maps to its
set.
"""
import importlib.util
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
HEADER = (ROOT / "src" / "repro_torch" / "kernels" / "grouped_lora" / "csrc"
          / "ranklocal_common.cuh")
KERNELS = ("narrow_out_kernel", "rank_sum_kernel", "tn_kernel")
SETS = {"rank-local": ("true", "true"), "ragged": ("true", "false"),
        "dense": ("false", "false")}


def _templates():
    """{kernel name: [template parameters]} of every __global__ template."""
    src = re.sub(r"//[^\n]*", "", HEADER.read_text())
    found = re.findall(r"template\s*<([^>]*)>\s*__global__\s+void\s+"
                       r"(?:__launch_bounds__\((?:[^()]|\([^()]*\))*\)\s*)?"
                       r"(\w+)\s*\(", src)
    return {name: [p.strip() for p in params.split(",")]
            for params, name in found}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _demangled(name, params, rows, ranks):
    """The name the profiler gives one instantiation: bf16 activations, tile
    sizes 64, other flags false, ROWS and RANKS last."""
    args = []
    for p in params[:-2]:
        kind = p.split()[0]
        args.append({"typename": "__nv_bfloat16", "bool": "false"}.get(kind,
                                                                       "64"))
    args += [rows, ranks]
    return (f"void (anonymous namespace)::{name}<{', '.join(args)}>"
            f"(__nv_bfloat16 const*, float const*, int const*, int const*, "
            f"int, int, int)")


def test_every_global_template_is_a_known_kernel():
    assert sorted(_templates()) == sorted(KERNELS)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_template_ends_with_rows_and_ranks(kernel):
    params = _templates()[kernel]
    assert params[0] == "typename T", params
    assert params[-2:] == ["bool ROWS", "bool RANKS"], params


@pytest.mark.parametrize("family", sorted(SETS))
@pytest.mark.parametrize("kernel", KERNELS)
def test_profile_parser_maps_each_instantiation_to_its_set(kernel, family):
    cs = _chip_smoke()
    name = _demangled(kernel, _templates()[kernel], *SETS[family])
    assert cs._kernel_family(name) == family, name


def test_profile_parser_ignores_other_kernels():
    cs = _chip_smoke()
    for name in ("void flash_fwd<80>(float const*)",
                 "void linear_scan_kernel<true>(float const*)",
                 "ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_nn"):
        assert cs._kernel_family(name) == ""
