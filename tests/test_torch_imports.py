"""PyTorch port: package rules.

(e) No file under ``src/repro_torch/`` nor ``chip_smoke.py`` imports
``jax`` or the JAX package ``repro`` (``repro_torch`` itself is fine): the
scheduler (``sched/``, the journal and chaos harness among it), the engine
(``core/engine.py``), the tuning service (``core/service.py``) and the
serving lease (``serve/driver.py``) included.
(f) Entry points run on the card by default: called without ``device`` on
a machine without one they raise instead of running on the CPU (the
training CLI, its process group and the tile autotuner among them).
"""
import ast
import pathlib

import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.adapter_state import SlotManager
from repro_torch.core.engine import Engine
from repro_torch.core.executor import BatchedExecutor, SharedBackboneExecutor
from repro_torch.core.service import TuningService
from repro_torch.data.synthetic import make_task_dataset
from repro_torch.kernels.grouped_lora import autotune as AT
from repro_torch.launch import mesh as MESH
from repro_torch.launch import serve as cli
from repro_torch.launch import train as train_cli
from repro_torch.models import model as M
from repro_torch.serve import AdapterPool, ServingReplica

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_collectives_module_is_scanned():
    """``launch/collectives.py`` (the sharded step's collectives) is among
    the files the import rule covers, and imports neither."""
    path = ROOT / "src" / "repro_torch" / "launch" / "collectives.py"
    assert path in PORT_FILES
    assert not {m for m in _imported_roots(path) if m in FORBIDDEN}


def test_scan_tells_repro_torch_from_repro(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.models\nfrom repro_torch import x\n")
    bad = tmp_path / "bad.py"
    bad.write_text("from repro.core import lora\nimport jax.numpy\n")
    assert not [m for m in _imported_roots(ok) if m in FORBIDDEN]
    assert sorted(m for m in _imported_roots(bad) if m in FORBIDDEN) == [
        "jax", "repro"]


def _one_rank_group():
    with MESH.process_group():
        pass


def _tiny():
    return get_arch("paper-llama-tiny").reduced(num_layers=1, d_model=64,
                                                vocab=64)


ENTRY_POINTS = {
    "init_params": lambda: M.init_params(_tiny()),
    "init_cache": lambda: M.init_cache(_tiny(), 1, 1, 8),
    "AdapterPool": lambda: AdapterPool(_tiny(), 1),
    "ServingReplica": lambda: ServingReplica(
        _tiny(), M.init_params(_tiny(), device="cpu"),
        AdapterPool(_tiny(), 1, device="cpu")),
    "cli": lambda: cli.main(["--arch", "paper-llama-tiny", "--reduced"]),
    "train_cli": lambda: train_cli.main(["--arch", "paper-llama-tiny",
                                         "--reduced", "--steps", "1"]),
    "process_group": _one_rank_group,
    "autotune_tile_plan": lambda: AT.autotune_tile_plan(72, 40, 24, Z=3,
                                                        tokens=5),
    "SlotManager": lambda: SlotManager(_tiny(), 1,
                                       M.target_shapes(_tiny())),
    "SharedBackboneExecutor": lambda: SharedBackboneExecutor(
        _tiny(), M.init_params(_tiny(), device="cpu"), Z=1,
        per_adapter_batch=1),
    "Engine": lambda: Engine(total_gpus=1).batched_execution(
        [], None, strategy="static"),
    "TuningService": lambda: TuningService(total_gpus=1),
    "BatchedExecutor": lambda: BatchedExecutor(
        _tiny(), M.init_params(_tiny(), device="cpu"),
        make_task_dataset("t", 64, 8, num_train=4, num_val=2), Z=1,
        per_adapter_batch=1),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()
