"""PyTorch port: the vlm and audio families' sharded train and eval steps on
a real multi-rank mesh — Qwen2-VL's patch prefix and M-RoPE positions under
the sequence-sharded residual, and MusicGen — held against the JAX
package's GSPMD steps on 4 forced CPU devices.

The settings are ``tests/_ap_common.py``'s ``MODAL_RUNS``: reduced fp32
qwen2-vl-72b (d 128, 4 heads and 4 KV heads of 32) with a 40-row prefix at
S 64 (at 2x2 it crosses the model ranks' boundary at 32), with an 8-row
prefix inside model rank 0's block, and with the 40-row prefix and a
vocabulary of 515 that does not split over "model"; and musicgen-medium at
S 32; 2 layers, Z 4, b 4, ranks [8, 8, 4, 4], 3 steps. The reference's init
(this process) and a numpy seed's prefix (N(0, 0.02), labels -1 over it)
and per-slot M-RoPE positions (a 5 x 8 or 2 x 4 patch grid for slots 0-1,
4 x 10 or 1 x 8 for slots 2-3, then the text) reach both sides through
``init_<run>.npz``. One module fixture starts the reference, in two
processes (``tests/_ap_reference.py --modal``), and the port's 4 gloo ranks
(``tests/_ap_worker.py --modal``) together.

(a) Every run (``common.modal_runs()``) against the reference's on the same
    mesh: per-slot losses of every step within 1e-5 relative, every updated
    adapter leaf within ``tests/test_torch_ap.py``'s bars with at most
    ``common.MOE_ADAM_SHARE`` of its entries past rtol 1e-5 (vlm515, whose
    one-rank steps already differ between the packages by more,
    ``common.MODAL_ONE_RANK``: both packages' one-rank losses and evals
    within 1e-5, every adapter entry within the per-entry bound of the
    reference's, and each package's sharded adapters within that share of
    its own one-rank run's); and the
    sharded eval step after the steps (the first batch, the trained
    adapters) within 1e-5 relative of the reference's ``make_eval_step``.
(b) ``chip_smoke.py`` phase 38's planted faults, each alone in a 2x2 run of
    vlm40, break parity on their own data rank's slots (train and eval
    losses) and leave the other rank's within the bars: (c) data rank 0's
    model ranks write the prefix at the head of their own sequence blocks,
    (d) data rank 1 takes data rank 0's positions.
(c) The AP invariant from every rank's collective log, of the train steps
    and of the eval step: "data" carries only "base_weight" all-gathers and
    the "metric" gather; no adapter gradient crosses it, and nothing over
    "data" but a base weight is r_max-wide.
(d) The data-axis and model-axis weight gathers a step equal
    ``launch/dryrun.py``'s count for qwen2-vl on 2x2, byte for byte.
(e) One sharded DPO step and the DPO eval step of vlm40 and audio on 2x2
    against the reference's (``tests/test_torch_ap.py``'s
    ``family_dpo_held``); the prefill step (vlm40: its prefix and M-RoPE
    positions, the prefix crossing the model ranks' boundary at 2x2) and 8
    greedy serve steps of vlm40 and audio on 2x2 and 4x1 against the
    reference's, the streams equal to the reference's and to the port's
    one-rank run's (``_serve_held``).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lora as JLORA
from repro.data.synthetic import SlotBatcher, make_task_dataset
from repro.models import model as JM
from repro_torch.configs.base import KIND_TRAIN, ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import partitioning as TPT
from repro_torch.launch import train as TTRAIN
from tests import _ap_common as common
from tests.test_torch_ap import ADAM_BOUND, LOSS, ROOT, TIMEOUT, \
    _adapters_close, _env, _leaves, _one_rank, _ranks, _serve_held, \
    family_dpo_held, one_rank_serve

RUNS = common.modal_runs()


def _tag(name, mesh):
    return f"{name}_%dx%d" % mesh


def _init(work, name):
    """``init_<name>.npz``: the reference's weights and adapters, the run's
    batches and, for a vlm run, its prefix and positions."""
    jcfg = common.modal_config(name, "repro")
    S = common.MODAL_RUNS[name][1]
    key = jax.random.PRNGKey(0)
    params = JM.init_params(key, jcfg)
    lora = JLORA.init_lora_tree(key, jcfg, common.Z,
                                jnp.asarray(common.RANKS),
                                JM.target_shapes(jcfg))
    ds = make_task_dataset("ap-demo", jcfg.vocab_size, seq_len=S,
                           num_train=64, difficulty=0.25)
    batcher = SlotBatcher(ds, common.Z, common.B)
    toks, labs = (np.stack(x) for x in zip(*(batcher.next_batch()
                                             for _ in range(common.STEPS))))
    extra = {"labels": labs}
    if common.MODAL_RUNS[name][3]:
        extra = common.modal_batches(name, toks, labs, jcfg.d_model)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    np.savez(os.path.join(work, f"init_{name}.npz"),
             **common.flat(np_(params), "params/"),
             **common.flat(np_(lora), "lora/"), tokens=toks, **extra)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ap_modal"))
    for name in common.MODAL_RUNS:
        _init(work, name)
    refs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_ap_reference.py"),
         work, "--modal", *names], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        for names in (("vlm40", "audio"), ("vlm8", "vlm515"))]
    workers = _ranks([sys.executable, os.path.join(ROOT, "tests",
                                                   "_ap_worker.py"), work,
                      "--modal"], 4, TMESH.free_port(), work, "worker")
    for p in refs:
        out = p.communicate(timeout=TIMEOUT)[0]
        assert p.returncode == 0, out
    for r, (p, f) in enumerate(workers):
        rc = p.wait(timeout=TIMEOUT)
        f.close()
        with open(os.path.join(work, f"worker{r}.log")) as f:
            assert rc == 0, f.read()
    return work


def _load(work, name):
    return dict(np.load(os.path.join(work, name)))


def _log(work, tag, rank, kind="log"):
    """Rank ``rank``'s collective records of the train steps ("log") or of
    the eval step ("eval_log")."""
    with open(os.path.join(work, f"{kind}_{tag}_rank{rank}.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# (a) against the reference's GSPMD steps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(runs, tmp_path_factory):
    """The port's one-rank runs of ``common.MODAL_ONE_RANK`` (this process,
    a one-rank gloo group)."""
    return {name: _one_rank(_load(runs, f"init_{name}.npz"),
                            tmp_path_factory.mktemp(f"one_{name}"),
                            common.modal_config(name, "repro_torch"))
            for name in common.MODAL_ONE_RANK}


@pytest.mark.parametrize("name,mesh", RUNS, ids=[_tag(*r) for r in RUNS])
def test_modal_sharded_step_matches_the_reference(runs, one_rank, name,
                                                  mesh):
    tag = _tag(name, mesh)
    got = _load(runs, f"port_{tag}.npz")
    want = _load(runs, f"jax_{tag}.npz")
    assert got["losses"].shape == (common.STEPS, common.Z)
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    if name not in common.MODAL_ONE_RANK:
        _adapters_close(got, want, f"port {tag} vs reference",
                        common.MOE_ADAM_SHARE)
        return
    # the packages differ at one rank already: each package's sharding
    # moves its adapters only by sum order, every entry stays within the
    # per-entry bound of the reference's, and the one-rank losses agree
    one, jone = one_rank[name], _load(runs, f"jax_{name}_1x1.npz")
    np.testing.assert_allclose(one["losses"], jone["losses"], **LOSS)
    np.testing.assert_allclose(one["eval"], jone["eval"], **LOSS)
    for k in _leaves(want):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ADAM_BOUND,
                                   err_msg=f"port {tag} {k}")
    _adapters_close(got, one, f"port {tag} vs port 1x1",
                    common.MOE_ADAM_SHARE)
    _adapters_close(want, jone, f"reference {tag} vs reference 1x1",
                    common.MOE_ADAM_SHARE)


@pytest.mark.parametrize("name,mesh", RUNS, ids=[_tag(*r) for r in RUNS])
def test_modal_sharded_eval_matches_the_reference(runs, name, mesh):
    tag = _tag(name, mesh)
    got = _load(runs, f"port_{tag}.npz")["eval"]
    want = _load(runs, f"jax_{tag}.npz")["eval"]
    assert got.shape == (common.Z,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOSS)


def test_the_prefix_cases_are_the_ones_asked_for(runs):
    """vlm40's prefix crosses the 2x2 model ranks' boundary and vlm8's does
    not; vlm515's vocabulary stays whole over "model" while the others'
    split; the two halves of the slots have different positions."""
    m = 2
    for name, cross in (("vlm40", True), ("vlm8", False)):
        _, S, _, P, _ = common.MODAL_RUNS[name]
        assert (P > S // m) == cross, name
        init = _load(runs, f"init_{name}.npz")
        pos = init["positions"]
        assert pos.shape == (3, common.Z, common.B, S)
        assert not np.array_equal(pos[:, 1], pos[:, 2])
        assert (init["labels"][..., :P] == -1).all()
    splits = {}
    for name in common.MODAL_RUNS:
        cfg = common.modal_config(name, "repro_torch")
        amesh = TMESH.abstract_mesh((2, 2), ("data", "model"))
        spec = TPT.base_param_specs(amesh, {"embed": torch.empty(
            cfg.vocab_size, cfg.d_model, device="meta")})["embed"]
        splits[name] = "model" in spec
    assert splits == {"vlm40": True, "vlm8": True, "vlm515": False,
                      "audio": True}


# ---------------------------------------------------------------------------
# (b) the planted faults break parity on their own slots
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fault", list(common.MODAL_FAULTS))
def test_a_planted_modal_fault_breaks_parity(runs, fault):
    tag = _tag(common.MODAL_FAULT_RUN, (2, 2))
    bad = _load(runs, f"port_{tag}_{fault}.npz")
    want = _load(runs, f"jax_{tag}.npz")
    hit = list(common.MODAL_FAULTS[fault])
    kept = [z for z in range(common.Z) if z not in hit]
    for key, b, w in (("losses", bad["losses"], want["losses"]),
                      ("eval", bad["eval"][None], want["eval"][None])):
        np.testing.assert_allclose(b[:, kept], w[:, kept], **LOSS,
                                   err_msg=key)
        off = np.abs(b[:, hit] - w[:, hit])
        assert (off > LOSS["rtol"] * np.abs(w[:, hit])).any(), (key, off)


# ---------------------------------------------------------------------------
# (c) the AP invariant from the collective log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mesh", RUNS, ids=[_tag(*r) for r in RUNS])
def test_modal_no_adapter_collective_crosses_the_data_axis(runs, name, mesh):
    cfg = common.modal_config(name, "repro_torch")
    d, m = mesh
    for r in range(4):
        for kind, steps in (("log", common.STEPS), ("eval_log", 1)):
            log = _log(runs, _tag(name, mesh), r, kind)
            data = [c for c in log if c["axis"] == "data"]
            model = [c for c in log if c["axis"] == "model"]
            assert {c["role"] for c in data} == {"base_weight", "metric"}
            assert all(c["kind"] == "all-gather" for c in data)
            metric = [c for c in data if c["role"] == "metric"]
            assert len(metric) == steps
            assert all(c["shape"][0] == common.Z for c in metric)
            assert not any(c["shape"][-1] == cfg.lora.r_max for c in data
                           if c["role"] != "base_weight")
            if m == 1:
                assert not model
                continue
            grads = [c for c in model if c["role"] == "adapter_grad"]
            assert all(c["kind"] == "all-reduce" for c in grads)
            # the eval takes no gradient
            assert len(grads) == (kind == "log") * common.STEPS * 2 * len(
                cfg.lora.targets)
            assert {c["role"] for c in model} == {"activation"} | (
                {"adapter_grad"} if kind == "log" else set())


# ---------------------------------------------------------------------------
# (d) the dry run's gathers against the logged ones
# ---------------------------------------------------------------------------

def test_vlm_dryrun_weight_gathers_equal_the_logged_bytes(runs):
    name = common.MODAL_FAULT_RUN
    cfg = common.modal_config(name, "repro_torch")
    S = common.MODAL_RUNS[name][1]
    shape = ShapeConfig("ap_train", S, common.Z * common.B, KIND_TRAIN,
                        num_slots=common.Z, per_adapter_batch=common.B)
    with TMESH.fake_group(4):
        mesh = TMESH.DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                mesh_dim_names=("data", "model"))
        low = DR.lower_step(cfg, shape, mesh)
    for axis in ("data", "model"):
        want = sum(op.result_bytes * op.trip_count for op in low.collectives
                   if op.line.startswith(f"{axis}: weight"))
        for r in range(4):
            got = sum(c["bytes"] for c in _log(runs, _tag(name, (2, 2)), r)
                      if c["axis"] == axis and c["role"] == "base_weight")
            assert got == want * common.STEPS, (axis, got / common.STEPS,
                                                want)
        assert (want > 0) == (axis == "data")


# ---------------------------------------------------------------------------
# the launcher's batch for a mixed config
# ---------------------------------------------------------------------------

def test_the_launcher_grids_follow_the_reference_rule():
    """``launch.train``'s patch grids and positions: 16 x 16 and 8 x 32 for
    qwen2-vl's 256 patches, and the positions of ``common.grid_positions``
    (the rule the tests give both packages)."""
    assert TTRAIN.patch_grids(256) == ((16, 16), (8, 32))
    assert TTRAIN.patch_grids(8) == ((2, 4), (1, 8))
    for grid in ((16, 16), (8, 32), (5, 8)):
        np.testing.assert_array_equal(
            TTRAIN.image_positions(grid, 384).numpy(),
            common.grid_positions(grid, 384))
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("qwen2-vl-72b").reduced()
    gen = torch.Generator().manual_seed(0)
    out = TTRAIN.modal_inputs(cfg, 4, 2, 64, gen, "cpu")
    assert out["modal_embeds"].shape == (4, 2, 8, cfg.d_model)
    pos = out["positions"]
    assert pos.shape == (3, 4, 2, 64)
    assert torch.equal(pos[:, 0], pos[:, 1]) and torch.equal(pos[:, 2],
                                                             pos[:, 3])
    assert not torch.equal(pos[:, 1], pos[:, 2])


# ---------------------------------------------------------------------------
# (e) the DPO loss and the prefill and serve steps against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in common.DPO_RUNS
                                  if n in common.MODAL_RUNS])
def test_modal_sharded_dpo_matches_the_reference(runs, name):
    family_dpo_held(runs, name)


SERVE_NAMES = [n for n in common.SERVE_RUNS if n in common.MODAL_RUNS]
SERVES = [(name, mesh) for name in SERVE_NAMES
          for mesh in common.MODAL_RUNS[name][4]]


@pytest.fixture(scope="module")
def one_serve(runs, tmp_path_factory):
    """The port's one-rank serving runs of ``SERVE_NAMES``."""
    return {name: one_rank_serve(_load(runs, f"init_{name}.npz"),
                                 tmp_path_factory.mktemp(f"serve_{name}"),
                                 common.modal_config(name, "repro_torch"))
            for name in SERVE_NAMES}


@pytest.mark.parametrize("name,mesh", SERVES, ids=[_tag(*r) for r in SERVES])
def test_modal_sharded_serve_matches_the_reference(runs, one_serve, name,
                                                   mesh):
    """vlm40: the 40-row prefix and its M-RoPE positions in the prefill
    (crossing the model ranks' boundary at 2x2), then decode at the
    sequence index; audio: EnCodec tokens."""
    tag = _tag(name, mesh)
    _serve_held(common.served(runs, f"serve_{tag}", mesh),
                _load(runs, f"jax_serve_{tag}.npz"), one_serve[name],
                f"serve {tag}")
