"""PyTorch port: the pod axis — the sharded train, eval, prefill and serve
steps of the dense and MoE families on a real ("pod", "data", "model")
mesh, held against the JAX package's GSPMD steps on 8 forced CPU devices
with the same axes.

The runs are ``tests/_ap_common.py``'s ``POD_RUNS`` of this file
(``POD_FILES["pod"]``) on a 2x2x2 mesh: the dense example (reduced fp32
paper-llama-tiny, Z 4, b 4, S 32; 3 SFT steps and the eval step, 2 DPO
steps and the DPO eval step, the prefill and 8 greedy serve steps, and a
per-lane cache whose last step has ``common.IDLE_LANES`` idle, lane (1, 0)
on pod rank 0 and lane (2, 3) on pod rank 1), and granite-moe's span case
(T 512: one token group over all 8 ranks; train and serve), inside case
(T 8,192: groups of 4,096 inside each data rank, each spanning its two pod
ranks; train) and odd case (T 384, groups of 128, a rank's runs of 48 rows:
pieces of 16; 2 train steps, ``common.POD_STEPS``). "pod" splits each
slot's 4 rows, 2 a pod rank. The other AP tests' inits reach both sides
through their ``init`` files; one module fixture starts the reference
(``tests/_ap_reference.py --pod``) and the port's 8 gloo ranks
(``tests/_ap_worker.py --pod``) together.

(a) Every run against the reference's on the same mesh: per-slot losses
    within 1e-5 relative (DPO: ``DPO_LOSS``), the eval steps too, every
    adapter leaf within ``tests/test_torch_ap.py``'s bars (MoE: with
    ``common.MOE_ADAM_SHARE`` of a leaf's entries past rtol 1e-5).
(b) The prefill and the greedy serve steps: logits and every leaf of the
    prefilled cache within 1e-5 of their scale, streams equal to the
    reference's and to the port's one-rank run's; the idle lanes' entries
    of every cache leaf and their positions bitwise untouched on every
    rank.
(c) The pod ranks hold the same adapters, bitwise, after every step.
(d) The pod invariant, from every rank's collective log: "pod" carries
    only the one all-reduce of the adapter gradients a train step (its
    bytes the rank's adapter bytes), the per-slot loss sums and the MoE
    route counts; nothing crosses "data" but base weights, the metric
    gather and route counts; a dense serve step sends nothing over "pod".
(e) Ragged slot rows on a pod mesh (naming the reference's
    ``batch_specs``) and axes in another order raise
    ``NotImplementedError`` naming ``ROADMAP.md``; ``serve_cache_specs``
    splits the lanes over "pod".
(f) The dry run's pod-axis "adapter grads" bucket for the dense example
    on 2x2x2 equals, byte for byte, what a train step logged over "pod"
    in role "adapter_grad".
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import KIND_TRAIN, ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import partitioning as TPT
from tests import _ap_common as common
from tests.test_torch_ap import DPO_LOSS, LOSS, ROOT, TIMEOUT, \
    _adapters_close, _env, _init as dense_init, _ranks, _serve_held, \
    lanes_held, one_rank_serve

NAMES = common.POD_FILES["pod"]
SHARE = {"dense": 0.002}          # test_torch_ap.ADAM_SHARE
SERVES = [n for n in NAMES if "serve" in common.POD_RUNS[n]]


def start(work, names):
    """The reference process and the port's 8 ranks of ``names``, started
    together; returns when both are done."""
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_ap_reference.py"),
         work, "--pod", *names], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    workers = _ranks([sys.executable, os.path.join(ROOT, "tests",
                                                   "_ap_worker.py"), work,
                      "--pod", *names], 8, TMESH.free_port(), work, "worker")
    out = ref.communicate(timeout=TIMEOUT)[0]
    assert ref.returncode == 0, out
    for r, (p, f) in enumerate(workers):
        rc = p.wait(timeout=TIMEOUT)
        f.close()
        with open(os.path.join(work, f"worker{r}.log")) as f:
            assert rc == 0, f.read()
    return work


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_ap_moe import _init as moe_init
    work = str(tmp_path_factory.mktemp("ap_pod"))
    dense_init(work)
    weights = {}
    for name in NAMES[1:]:
        moe_init(work, name, weights)
    return start(work, NAMES)


def load(work, name):
    return dict(np.load(os.path.join(work, name)))


def logs(work, tag):
    """Every rank's ``log_<tag>_rank<r>.json``."""
    out = []
    for r in range(8):
        with open(os.path.join(work, f"log_{tag}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def one_serves(work, names, tmp_path_factory):
    """The port's one-rank serving runs of ``names``: a global position,
    and for the runs with "lanes" a per-lane cache with
    ``common.IDLE_LANES`` idle in one more step."""
    out = {}
    for name in names:
        init = load(work, common.pod_init(name))
        cfg = common.pod_config(name, "repro_torch")
        out[name] = {"global": one_rank_serve(
            init, tmp_path_factory.mktemp(f"sg_{name}"), cfg)}
        if "lanes" in common.POD_RUNS[name]:
            out[name]["lanes"] = one_rank_serve(
                init, tmp_path_factory.mktemp(f"sl_{name}"), cfg,
                per_lane=True, idle=common.IDLE_LANES)
    return out


@pytest.fixture(scope="module")
def one_serve(runs, tmp_path_factory):
    return one_serves(runs, SERVES, tmp_path_factory)


def sft_steps(name) -> int:
    """The SFT steps of pod run ``name``."""
    return common.POD_STEPS.get(name, common.STEPS)


def step_held(work, name, share):
    """(a) for the SFT steps of run ``name``."""
    got = load(work, f"port_pod_{name}.npz")
    want = load(work, f"jax_pod_{name}.npz")
    assert got["losses"].shape == (sft_steps(name), common.Z)
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    _adapters_close(got, want, f"port pod {name} vs reference", share)
    if name in common.POD_EVALS:
        assert got["eval"].shape == (common.Z,)
        assert np.isfinite(got["eval"]).all()
        np.testing.assert_allclose(got["eval"], want["eval"], **LOSS)


def same_adapters(work, name):
    """(c): every rank's adapters' digest after each SFT step (and after
    the DPO steps) equals its pod peer's; the steps moved them."""
    parts = logs(work, f"pod_{name}")
    keys = ["digests"] + ["dpo_digest"] * ("dpo" in common.POD_RUNS[name])
    for r, part in enumerate(parts):
        pod, data, model = common.pod_coords(r)
        peer = parts[((1 - pod) * 2 + data) * 2 + model]
        for key in keys:
            assert part[key] == peer[key], (name, r, key)
        assert len({tuple(d) for d in part["digests"]}) == sft_steps(name), (
            name, r)


def pod_invariant(work, name, cfg):
    """(d) from every rank's collective log of the train steps (and the
    eval step), and of its serving steps where the run serves."""
    moe = cfg.is_moe
    route = {"route"} if moe else set()
    parts = logs(work, f"pod_{name}")
    port = load(work, f"port_pod_{name}.npz")
    # the rank's adapter bytes: its data rank's Z/2 slots of every leaf
    lora = sum(v.nbytes for k, v in port.items()
               if k.startswith("lora/")) // 2
    for r, part in enumerate(parts):
        for kind in ("log", "eval_log"):
            log = part.get(kind)
            if log is None:
                continue
            pod = [c for c in log if c["axis"] == "pod"]
            data = [c for c in log if c["axis"] == "data"]
            roles = {c["role"] for c in pod}
            assert roles <= {"adapter_grad", "loss"} | route, (
                name, r, kind, roles)
            assert {c["role"] for c in data} <= (
                {"base_weight", "metric"} | route), (name, r, kind)
            assert all(c["kind"] == "all-gather" for c in pod
                       if c["role"] == "route")
            loss = [c for c in pod if c["role"] == "loss"]
            assert loss and all(c["kind"] == "all-reduce"
                                and c["shape"] == [2, common.Z // 2]
                                for c in loss), (name, r, kind)
            grads = [c for c in pod if c["role"] == "adapter_grad"]
            if kind == "eval_log":
                assert not grads
                continue
            assert len(grads) == sft_steps(name), (name, r)
            assert all(c["kind"] == "all-reduce" and c["bytes"] == lora
                       for c in grads), (name, r, grads[0], lora)
            if moe:
                assert "route" in roles, (name, r)
    for tag in (f"serve_pod_{name}", f"lanes_pod_{name}"):
        if not os.path.exists(os.path.join(work, f"{tag}_log_rank0.json")):
            continue
        for r in range(8):
            with open(os.path.join(work, f"{tag}_log_rank{r}.json")) as f:
                steps = json.load(f)
            for step, log in steps.items():
                roles = {c["role"] for c in log if c["axis"] == "pod"}
                assert roles == route, (tag, r, step, roles)


# ---------------------------------------------------------------------------
# (a) against the reference's GSPMD steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_pod_step_matches_the_reference(runs, name):
    step_held(runs, name, SHARE.get(name, common.MOE_ADAM_SHARE))


def test_pod_dpo_matches_the_reference(runs):
    got = load(runs, "port_pod_dense_dpo.npz")
    want = load(runs, "jax_pod_dense_dpo.npz")
    assert got["losses"].shape == (common.DPO_STEPS, common.Z)
    # the first step reads log 2 exactly: B is 0, the policy is the base
    np.testing.assert_array_equal(got["losses"][0], want["losses"][0])
    for key in ("losses", "eval"):
        np.testing.assert_allclose(got[key], want[key], **DPO_LOSS)
    assert (np.abs(want["eval"] - np.log(2.0)) > 1e-4).all(), want["eval"]
    _adapters_close(got, want, "port pod DPO vs reference", SHARE["dense"])


# ---------------------------------------------------------------------------
# (b) the prefill and serve steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVES)
def test_pod_serve_matches_the_reference(runs, one_serve, name):
    _serve_held(common.served(runs, f"serve_pod_{name}", common.POD_MESH),
                load(runs, f"jax_pod_{name}_serve.npz"),
                one_serve[name]["global"], f"serve pod {name}")


def test_pod_idle_lanes_stay_bitwise_on_every_rank(runs, one_serve):
    """A per-lane cache on 2x2x2: after the prefill and the greedy steps of
    every lane, a serve step with ``common.IDLE_LANES`` idle (one on each
    pod rank) leaves their entries of every local cache leaf and their
    positions bitwise untouched on every rank, and the live lanes match
    the port's one-rank run."""
    # lane l of a slot lies on pod rank l // (b/p)
    assert [lane * 2 // common.B for _, lane in common.IDLE_LANES] == [0, 1]
    lanes_held(common.served(runs, "lanes_pod_dense", common.POD_MESH),
               one_serve["dense"]["lanes"], "dense pod lanes")


# ---------------------------------------------------------------------------
# (c) and (d): the pod ranks' adapters, and what crosses "pod"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_pod_ranks_hold_the_same_adapters(runs, name):
    same_adapters(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_pod_axis_carries_only_grads_loss_sums_and_routes(runs, name):
    pod_invariant(runs, name, common.pod_config(name, "repro_torch"))


# ---------------------------------------------------------------------------
# (e) what a pod mesh refuses, and the serving layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what,names", [
    ("pod ragged rows", ("ragged", "pod", "batch_specs")),
    ("pod axis order", ("'data', 'pod', 'model'", "(pod, data, model)")),
])
def test_pod_unported_splits_raise_by_name(runs, what, names):
    with open(os.path.join(runs, "refusals_pod.json")) as f:
        msg = json.load(f)[what]
    assert msg, f"{what}: no NotImplementedError"
    for n in names:
        assert n in msg, (what, msg)
    assert "ROADMAP.md" in msg


def test_pod_serve_cache_layout():
    """``serve_cache_specs`` on a pod mesh: every leaf but the positions
    splits its slots over "data" and its lanes over "pod", as
    ``cache_specs`` does, beside what this rank's heads write over
    "model"."""
    from repro_torch.models import model as M
    mesh = TMESH.abstract_mesh(common.POD_MESH, common.POD_AXES)
    cfg = common.pod_config("dense", "repro_torch")
    cache = M.init_cache(cfg, common.Z, common.B, 8, per_lane=True,
                         device="cpu")
    got = TPT.serve_cache_specs(cfg, mesh, cache)
    assert got["pos"] == TPT.P()
    for key in ("k", "v"):
        assert got["layers"]["attn"][key] == TPT.P(None, "data", "pod", None,
                                                   "model")
    assert got == TPT.cache_specs(mesh, cache)


# ---------------------------------------------------------------------------
# (f) the dry run's pod-axis bucket against the logged bytes
# ---------------------------------------------------------------------------

def test_dryrun_pod_adapter_grads_equal_the_logged_bytes(runs):
    cfg = common.pod_config("dense", "repro_torch")
    shape = ShapeConfig("ap_train", common.S, common.Z * common.B,
                        KIND_TRAIN, num_slots=common.Z,
                        per_adapter_batch=common.B)
    with TMESH.fake_group(8):
        mesh = TMESH.DeviceMesh("cpu", torch.arange(8).reshape(
            common.POD_MESH), mesh_dim_names=common.POD_AXES)
        low = DR.lower_step(cfg, shape, mesh)
    want = [op.result_bytes * op.trip_count for op in low.collectives
            if op.line.startswith("pod: adapter grads")]
    assert len(want) == 1 and want[0] > 0, [op.line for op in
                                            low.collectives]
    for r, part in enumerate(logs(runs, "pod_dense")):
        got = [c["bytes"] for c in part["log"]
               if c["axis"] == "pod" and c["role"] == "adapter_grad"]
        assert got == want * common.STEPS, (r, got, want)
