"""PyTorch port: the MoE family's sharded train step on a real multi-rank
mesh — experts over "model", capacity routing across data ranks — held
against the JAX package's GSPMD step on 4 forced CPU devices.

The settings are ``tests/_ap_common.py``'s MoE cases: reduced fp32
granite-moe-1b-a400m (E 4, top-2, tied embedding) and llama4-scout-17b-a16e
(E 4, top-1, a shared expert), 2 layers, d 128, Z 4, ranks [8, 8, 4, 4], 3
steps, the reference's init (this process) handed to both sides through
``init_<run>.npz``. One module fixture starts the reference, one process
an arch (``tests/_ap_reference.py --moe``), and the port's 4 gloo ranks
(``tests/_ap_worker.py --moe``) together.

(a) Every run (arch x case x mesh, ``common.moe_runs()``) against the
    reference's on the same mesh: per-slot losses of every step and every
    updated adapter leaf within ``tests/test_torch_ap.py``'s bars, but for
    the share of a leaf's entries that may flip with sum order
    (``common.MOE_ADAM_SHARE``); the reference's own meshes against its
    1x1 run within the same bars (llama4's inside case, where it needs the
    share). The cases: one token group spanning
    every data rank (S 32), groups inside a data rank at 2x2 and spanning
    two at 4x1 (b 4, S 512), a vocabulary of 515, which does not split
    over "model", and 3 experts, which do not either.
(b) Capacity binds where it matters: the reference drops choices of data
    rank 1's slots in the span case's group, which spans both data ranks
    at 2x2; and the port with fault (a) planted (data rank 1 routes one
    layer without rank 0's counts) leaves the bars on those slots while
    rank 0's stay within them.
(c) The reference's co-tenant dependence across data ranks: slot 0
    repeating a token (the moved case) moves the losses of slots 2-3,
    held by the other data rank at 2x2, by the same amounts in both
    packages (``ROADMAP.md`` §3: the MoE family breaks slot isolation, in
    the reference too).
(d) The AP invariant from every rank's collective log: "data" carries
    only "base_weight" and "route" all-gathers and the "metric" gather, no
    "adapter_grad" and nothing r_max-wide; "route" appears exactly where a
    group spans data ranks; "model" all-reduces the adapter gradients.
(e) The data-axis weight gathers a step equal ``launch/dryrun.py``'s count
    for granite's span case on 2x2, byte for byte; opt level 2 (the
    reference's ``dims:data+pod`` hints) gives opt level 0's numbers bit for
    bit there.
(f) The sharded eval step after the steps (the first batch, the trained
    adapters) of ``common.MOE_EVALS``' runs against the reference's
    ``make_eval_step`` on the same mesh, within 1e-5 relative; the planted
    route fault breaks it on slots 2-3 too.
(g) One sharded DPO step and the DPO eval step of granite's span case on
    2x2 against the reference's (``tests/test_torch_ap.py``'s
    ``family_dpo_held``).
(h) The prefill step and 8 greedy serve steps of granite's span case on
    2x2 and 4x1 against the reference's GSPMD steps on the same mesh
    (``tests/test_torch_ap.py``'s ``_serve_held``: every step's logits and
    every leaf of the prefilled cache within 1e-5 of their scale, the greedy
    stream equal to the reference's and to the port's one-rank run's): the
    prefill's one token group spans the data ranks and its capacity binds
    (one count exchange over "data" a layer), and each decode step's Z·b
    one-token rows form one lossless group across the data ranks. A
    per-lane cache on 2x2 with ``common.IDLE_LANES`` idle in a last step
    (``lanes_held``: every leaf and position of an idle lane bitwise
    untouched on every rank); phase 36's route fault, planted in layer 0 of
    the prefill, breaks data rank 1's slots only.
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
from repro_torch.models.moe import pick_group_size
from tests import _ap_common as common
from tests.test_torch_ap import LOSS, ROOT, TIMEOUT, _adapters_close, \
    _env, _ranks, _serve_held, close_logits, family_dpo_held, lanes_held, \
    one_rank_serve

RUNS = common.moe_runs()
MOVES = 1e-3                 # (c): the smallest relative move held


def _init(work, name, weights):
    """``init_<name>.npz``: the reference's weights and adapters (made once
    a config, kept in ``weights``) and the case's batches."""
    arch, case = name.split("_")
    b, S, vocab, repeat, _ = common.MOE_CASES[case]
    key = (arch, vocab, common.MOE_EXPERTS.get(case))
    if key not in weights:
        jcfg = common.moe_config(name, "repro")
        rng = jax.random.PRNGKey(0)
        lora = JLORA.init_lora_tree(rng, jcfg, common.Z,
                                    jnp.asarray(common.RANKS),
                                    JM.target_shapes(jcfg))
        weights[key] = JM.init_params(rng, jcfg), lora
    params, lora = weights[key]
    ds = make_task_dataset("ap-demo", vocab, seq_len=S, num_train=64,
                           difficulty=0.25)
    batcher = SlotBatcher(ds, common.Z, b)
    toks, labs = (np.stack(x) for x in zip(*(batcher.next_batch()
                                             for _ in range(common.STEPS))))
    for z in repeat:
        toks[:, z, :, 1::4] = toks[:, z, :, 2::4] = common.REPEAT
        toks[:, z, :, 3::4] = common.REPEAT
        labs[:, z] = np.where(toks[:, z] == common.REPEAT, common.REPEAT,
                              labs[:, z])
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    np.savez(os.path.join(work, f"init_{name}.npz"),
             **common.flat(np_(params), "params/"),
             **common.flat(np_(lora), "lora/"), tokens=toks, labels=labs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ap_moe"))
    weights = {}
    for name in sorted({r[0] for r in RUNS}):
        _init(work, name, weights)
    # the reference in four processes: an arch's S 512 case (three
    # meshes), and its S 32 cases
    refs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_ap_reference.py"),
         work, "--moe", arch, *cases], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
        for arch in common.MOE_ARCHS
        for cases in (("inside",), ("span", "moved", "v515", "e3"))]
    workers = _ranks([sys.executable, os.path.join(ROOT, "tests",
                                                   "_ap_worker.py"), work,
                      "--moe"], 4, TMESH.free_port(), work, "worker")
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


def _tag(name, mesh):
    return f"{name}_%dx%d" % mesh


def _log(work, tag, rank):
    with open(os.path.join(work, f"log_{tag}_rank{rank}.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# (a) against the reference's GSPMD step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mesh", [(r[0], r[3]) for r in RUNS],
                         ids=[_tag(r[0], r[3]) for r in RUNS])
def test_moe_sharded_step_matches_the_reference(runs, name, mesh):
    tag = _tag(name, mesh)
    got = _load(runs, f"port_{tag}.npz")
    want = _load(runs, f"jax_{tag}.npz")
    steps = common.MOE_STEPS.get(name.split("_")[1], common.STEPS)
    assert got["losses"].shape == (steps, common.Z)
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    _adapters_close(got, want, f"port {tag} vs reference",
                    common.MOE_ADAM_SHARE)


SELF = [r for r in RUNS if r[0] == common.MOE_SELF_RUN]


EVALS = [(n, mesh) for n, _, _, mesh in RUNS if n in common.MOE_EVALS]


@pytest.mark.parametrize("name,mesh", EVALS,
                         ids=[_tag(*r) for r in EVALS])
def test_moe_sharded_eval_matches_the_reference(runs, name, mesh):
    """The sharded eval step after the steps (the first batch, the trained
    adapters; its token group spans every data rank) against the
    reference's ``make_eval_step`` on the same mesh."""
    tag = _tag(name, mesh)
    got = _load(runs, f"port_{tag}.npz")["eval"]
    want = _load(runs, f"jax_{tag}.npz")["eval"]
    assert got.shape == (common.Z,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOSS)


@pytest.mark.parametrize("name,mesh", [(r[0], r[3]) for r in SELF],
                         ids=[_tag(r[0], r[3]) for r in SELF])
def test_the_moe_reference_moves_with_its_own_sum_order(runs, name, mesh):
    one = _load(runs, f"jax_{_tag(name, (1, 1))}.npz")
    many = _load(runs, f"jax_{_tag(name, mesh)}.npz")
    np.testing.assert_allclose(many["losses"], one["losses"], **LOSS)
    _adapters_close(many, one, f"reference {_tag(name, mesh)} vs 1x1",
                    common.MOE_ADAM_SHARE)


# ---------------------------------------------------------------------------
# (b) capacity binds across data ranks, and fault (a) breaks parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(common.MOE_ARCHS))
def test_the_reference_drops_choices_of_the_second_data_rank(runs, arch):
    with open(os.path.join(runs, f"drops_{arch}_span.json")) as f:
        per_call = json.load(f)
    assert len(per_call) == common.MOE_DIMS["num_layers"]
    # slots 2-3: data rank 1 at 2x2, in the one group of T 512
    assert sum(c[2] + c[3] for c in per_call) > 0, per_call


def test_a_planted_route_fault_breaks_parity(runs):
    tag = _tag(common.FAULT_CASE, common.FAULT_MESH)
    bad = _load(runs, f"port_{tag}_fault.npz")
    want = _load(runs, f"jax_{tag}.npz")
    with open(os.path.join(runs, f"drops_{common.FAULT_CASE}.json")) as f:
        drops = json.load(f)[common.FAULT_LAYER]
    assert drops[2] + drops[3] > 0, drops
    np.testing.assert_allclose(bad["losses"][:, :2], want["losses"][:, :2],
                               **LOSS)
    off = np.abs(bad["losses"][:, 2:] - want["losses"][:, 2:])
    assert (off > LOSS["rtol"] * np.abs(want["losses"][:, 2:])).any(), off
    # the eval step routes that layer blind too
    np.testing.assert_allclose(bad["eval"][:2], want["eval"][:2], **LOSS)
    off = np.abs(bad["eval"][2:] - want["eval"][2:])
    assert (off > LOSS["rtol"] * np.abs(want["eval"][2:])).any(), off


# ---------------------------------------------------------------------------
# (c) the reference's co-tenant dependence across data ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(common.MOE_ARCHS))
def test_co_tenant_dependence_across_data_ranks_equals_reference(runs,
                                                                 arch):
    got, want = ({case: _load(runs, f"{pkg}_{arch}_{case}_2x2.npz")["losses"]
                  for case in ("span", "moved")} for pkg in ("port", "jax"))
    d_got = got["moved"][:, 2:] - got["span"][:, 2:]
    d_want = want["moved"][:, 2:] - want["span"][:, 2:]
    scale = np.abs(want["span"][:, 2:])
    print(f"{arch}: slots 2-3 move by {d_want.tolist()} (reference), "
          f"{d_got.tolist()} (port)")
    assert (np.abs(d_want) > MOVES * scale).any(), d_want
    np.testing.assert_allclose(d_got, d_want, rtol=0,
                               atol=2 * LOSS["rtol"] * scale.max())


# ---------------------------------------------------------------------------
# (d) the AP invariant from the collective log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mesh", [(r[0], r[3]) for r in RUNS],
                         ids=[_tag(r[0], r[3]) for r in RUNS])
def test_moe_no_adapter_collective_crosses_the_data_axis(runs, name, mesh):
    cfg = common.moe_config(name, "repro_torch")
    b, S = common.MOE_CASES[name.split("_")[1]][:2]
    d, m = mesh
    # a group's rows against a data rank's Z/d·b·S
    spans = pick_group_size(common.Z * b * S) > common.Z // d * b * S
    for r in range(4):
        log = _log(runs, _tag(name, mesh), r)
        data = [c for c in log if c["axis"] == "data"]
        model = [c for c in log if c["axis"] == "model"]
        roles = {c["role"] for c in data}
        assert roles == {"base_weight", "metric"} | (
            {"route"} if spans else set()), roles
        assert all(c["kind"] == "all-gather" for c in data)
        route = [c for c in data if c["role"] == "route"]
        assert all(c["dtype"] == "int32" and c["shape"][0] == d
                   and c["shape"][-1] == cfg.moe.num_experts for c in route)
        assert not any(c["shape"][-1] == cfg.lora.r_max for c in data)
        if m == 1:
            assert not model
            continue
        grads = [c for c in model if c["role"] == "adapter_grad"]
        assert all(c["kind"] == "all-reduce" for c in grads)
        steps = common.MOE_STEPS.get(name.split("_")[1], common.STEPS)
        assert len(grads) == steps * 8              # 4 targets x (A, B)
        assert {c["role"] for c in model} == {"activation", "adapter_grad"}


# ---------------------------------------------------------------------------
# (e) the dry run's data-axis gathers against the logged ones
# ---------------------------------------------------------------------------

def test_moe_opt_levels_agree_bitwise(runs):
    tag = _tag(common.FAULT_CASE, common.FAULT_MESH)
    base, opt2 = _load(runs, f"port_{tag}.npz"), _load(runs,
                                                       f"port_{tag}_opt2.npz")
    assert sorted(base) == sorted(opt2)
    for k in base:
        assert np.array_equal(base[k], opt2[k]), k


def test_moe_dryrun_data_gathers_equal_the_logged_bytes(runs):
    name = "granite_span"
    cfg = common.moe_config(name, "repro_torch")
    b, S = common.MOE_CASES["span"][:2]
    shape = ShapeConfig("ap_train", S, common.Z * b, KIND_TRAIN,
                        num_slots=common.Z, per_adapter_batch=b)
    with TMESH.fake_group(4):
        mesh = TMESH.DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                mesh_dim_names=("data", "model"))
        low = DR.lower_step(cfg, shape, mesh)
    want = sum(op.result_bytes * op.trip_count for op in low.collectives
               if op.line.startswith("data: weight"))
    assert any("moe/w_gate" in op.line for op in low.collectives)
    for r in range(4):
        got = sum(c["bytes"] for c in _log(runs, _tag(name, (2, 2)), r)
                  if c["axis"] == "data" and c["role"] == "base_weight")
        assert got == want * common.STEPS, (got / common.STEPS, want)


# ---------------------------------------------------------------------------
# (g) the DPO loss against the reference's GSPMD DPO step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in common.DPO_RUNS
                                  if n.split("_")[0] in common.MOE_ARCHS])
def test_moe_sharded_dpo_matches_the_reference(runs, name):
    """One DPO step of granite's span case, whose token group spans every
    data rank in each of the four forwards (no load-balance term: the
    reference's DPO loss takes none), and the DPO eval after it."""
    family_dpo_held(runs, name)


# ---------------------------------------------------------------------------
# (h) the prefill and serve steps against the reference's
# ---------------------------------------------------------------------------

SERVE_RUN = "granite_span"
SERVES = [(SERVE_RUN, mesh) for mesh in common.MOE_CASES["span"][4]]


@pytest.fixture(scope="module")
def one_serve(runs, tmp_path_factory):
    """The port's one-rank serving runs of granite's span case: a global
    position, and per lane with ``common.IDLE_LANES`` idle in one more
    step."""
    init = _load(runs, f"init_{SERVE_RUN}.npz")
    cfg = common.moe_config(SERVE_RUN, "repro_torch")
    return {"global": one_rank_serve(init, tmp_path_factory.mktemp("sg"),
                                     cfg),
            "lanes": one_rank_serve(init, tmp_path_factory.mktemp("sl"), cfg,
                                    per_lane=True, idle=common.IDLE_LANES)}


@pytest.mark.parametrize("name,mesh", SERVES, ids=[_tag(*r) for r in SERVES])
def test_moe_sharded_serve_matches_the_reference(runs, one_serve, name,
                                                 mesh):
    tag = _tag(name, mesh)
    _serve_held(common.served(runs, f"serve_{tag}", mesh),
                _load(runs, f"jax_serve_{tag}.npz"), one_serve["global"],
                f"serve {tag}")


def test_moe_idle_lanes_stay_bitwise_on_every_rank(runs, one_serve):
    lanes_held(common.served(runs, f"lanes_{SERVE_RUN}",
                             common.SERVE_IDLE[SERVE_RUN]),
               one_serve["lanes"], f"{SERVE_RUN} lanes")


def test_a_planted_route_fault_breaks_serving_on_its_slots(runs):
    """Data rank 1 routes the prefill's layer 0 without rank 0's counts:
    its queue places start at 0, so it keeps the choices the group's
    capacity drops there (the reference drops some of slot 3's, none of
    slot 2's: ``drops_<run>.json``), and the K/V of layer 1 and every
    later step move on those slots; every other slot stays within the
    bars."""
    got = common.served(runs, f"serve_{SERVE_RUN}_route_blind", (2, 2))
    want = _load(runs, f"jax_serve_{_tag(SERVE_RUN, (2, 2))}.npz")
    with open(os.path.join(runs, f"drops_{SERVE_RUN}.json")) as f:
        dropped = json.load(f)[0]
    hit = [z for z in common.SERVE_FAULTS["route_blind"] if dropped[z]]
    kept = [z for z in range(common.Z) if z not in hit]
    assert hit == [3], dropped
    close_logits(got["logits"][:, kept], want["logits"][:, kept],
                 "the slots with no dropped choice in layer 0")
    scale = np.abs(want["logits"]).max()
    for z in hit:
        off = np.abs(got["logits"][1:, z] - want["logits"][1:, z]).max()
        assert off > 1e-3 * scale, (z, off, scale)
