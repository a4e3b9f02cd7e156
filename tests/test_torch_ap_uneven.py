"""PyTorch port: the last sharded refusals — ragged slot rows over a split
model axis, scan heads that do not divide the model axis, and MoE token
groups that neither divide nor are divided by a rank's run of rows — on a
real multi-rank mesh, held against the JAX package's GSPMD steps on 4
forced CPU devices.

The runs are ``tests/_ap_common.py``'s ``UNEVEN_RUNS``: reduced fp32
configs, 2 layers, vocab 512, Z 4, ranks [8, 8, 4, 4], 3 steps, the
reference's init (this process) handed to both sides through
``init_<run>.npz``. One module fixture starts one reference process
(``tests/_ap_reference.py --uneven``) and one group of 4 gloo port ranks
(``tests/_ap_worker.py --uneven``), and makes the port's one-rank runs in
this process while they work.

(a) Ragged rows: the dense example (b 4, S 32) on 2x2 with ``slot_rows``
    (128, 80, 96, 40) handed whole (the step cuts them to the data rank's
    slots; the ragged Function), and hymba-1.5b d 160 (b 4, S 128; 5
    attention heads, whole at m 2) on 2x2 with (512, 320, 384, 160) and
    the slot ranks bound (the rank-local Function with rows; whole
    attention's o_proj on a sequence block of 64, where the rows are
    ``SpmdPlan.block_rows``'s). Two slots of each end mid-sequence and
    every row is labelled, so a row mapped wrongly moves a loss.
(b) Whole scan heads: hymba d 160 on 1x4 (10 Mamba heads and 5 attention
    heads, both whole on every model rank): the steps, the eval step, the
    prefill and 8 greedy serve steps, and a per-lane cache whose last step
    has ``common.IDLE_LANES`` idle; rwkv6-3b d 96 (3 heads of 32) on 2x2:
    the steps, the eval step, the prefill and serve steps. The packages'
    one-rank rwkv steps already drift apart (``common.SSM_ONE_RANK``), so
    rwkv's runs are held against the port's own one-rank run.
(c) MoE pieces: granite-moe's odd case (b 4, S 24: T 384, groups of 128)
    on 2x2 (runs of 192 rows: pieces of 64) with the eval, prefill and
    serve steps, and on 4x1 (runs of 96: pieces of 32).
(d) Bars, as the other AP files: losses within 1e-5 relative (``LOSS``);
    adapters within ``tests/test_torch_ap.py``'s per-entry bars and bound,
    with ``common.MOE_ADAM_SHARE`` of a leaf's entries past rtol 1e-5 (the
    reference's own 2x2 run of the ragged dense example moves past the
    dense example's ``ADAM_SHARE`` from its 1x1, asserted here); logits
    and every leaf of the
    prefilled cache within 1e-5 of their scale; greedy streams equal to the
    reference's and to the port's one-rank run's.
(e) Invariants: each whole-scan run's model ranks hold bitwise equal
    ``wkv`` / ``ssm`` / ``conv`` leaves after the prefill; idle lanes stay
    bitwise untouched on every rank; from every rank's collective log, the
    whole-scan path adds only forward "base_weight" all-gathers over
    "model" (two a weight and layer a step: the forward and remat's
    recompute), and no adapter collective crosses "data".
(f) The dry run (``launch/dryrun.py`` on a fake 4-rank group): its
    model-axis weight gathers for hymba d 160 on 1x4 and rwkv d 96 on 2x2
    equal, byte for byte, what a train step logged.
(g) What needs no mesh: ``SpmdPlan.block_rows`` against the row mask of
    the whole sequence cut to each model rank's block, ``moe_groups``'
    pieces each inside one group, and ``serve_cache_specs`` keeping the
    scan states whole where ``whole_scan`` holds.
"""
import json
import math
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
import chip_smoke
from tests import _ap_common as common
from tests.test_torch_ap import ADAM_SHARE, LOSS, ROOT, TIMEOUT, \
    _adapters_close, _env, _one_rank, _ranks, _serve_held, close_logits, \
    lanes_held, one_rank_serve

RUNS = [(name, mesh) for name, spec in common.UNEVEN_RUNS.items()
        for mesh in spec[4]]
REF_RUNS = [r for r in RUNS if r[0] not in common.UNEVEN_ONE_RANK]
SERVES = [name for name, spec in common.UNEVEN_RUNS.items()
          if "serve" in spec[5]]
WHOLE = ("hymba_whole", "rwkv_whole")


def _tag(name, mesh):
    return f"{name}_%dx%d" % mesh


def _init(work, name):
    """``init_<name>.npz``: the reference's weights and adapters and the
    run's batches."""
    jcfg = common.uneven_config(name, "repro")
    _, _, b, S, _, _ = common.UNEVEN_RUNS[name]
    key = jax.random.PRNGKey(0)
    params = JM.init_params(key, jcfg)
    lora = JLORA.init_lora_tree(key, jcfg, common.Z,
                                jnp.asarray(common.RANKS),
                                JM.target_shapes(jcfg))
    ds = make_task_dataset("ap-demo", jcfg.vocab_size, seq_len=S,
                           num_train=64, difficulty=0.25)
    batcher = SlotBatcher(ds, common.Z, b)
    toks, labs = zip(*(batcher.next_batch() for _ in range(common.STEPS)))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    np.savez(os.path.join(work, f"init_{name}.npz"),
             **common.flat(np_(params), "params/"),
             **common.flat(np_(lora), "lora/"),
             tokens=np.stack(toks), labels=np.stack(labs))


def _load(work, name):
    return dict(np.load(os.path.join(work, name)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The work directory after the reference and the port's ranks ran
    every run; "one": the port's one-rank runs made here meanwhile (rwkv's
    steps and serving, and the serving runs' one-rank streams)."""
    work = str(tmp_path_factory.mktemp("ap_uneven"))
    for name in common.UNEVEN_RUNS:
        _init(work, name)
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_ap_reference.py"),
         work, "--uneven", *(n for n in common.UNEVEN_RUNS
                             if n not in common.UNEVEN_ONE_RANK)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    workers = _ranks([sys.executable, os.path.join(ROOT, "tests",
                                                   "_ap_worker.py"), work,
                      "--uneven", *common.UNEVEN_RUNS], 4,
                     TMESH.free_port(), work, "worker")
    one = {}
    for name in SERVES:
        init = _load(work, f"init_{name}.npz")
        cfg = common.uneven_config(name, "repro_torch")
        one[name] = {"global": one_rank_serve(
            init, tmp_path_factory.mktemp(f"sg_{name}"), cfg)}
        if "lanes" in common.UNEVEN_RUNS[name][5]:
            one[name]["lanes"] = one_rank_serve(
                init, tmp_path_factory.mktemp(f"sl_{name}"), cfg,
                per_lane=True, idle=common.IDLE_LANES)
        if name in common.UNEVEN_ONE_RANK:
            one[name]["train"] = _one_rank(
                init, tmp_path_factory.mktemp(f"one_{name}"), cfg)
    out = ref.communicate(timeout=TIMEOUT)[0]
    assert ref.returncode == 0, out
    for r, (p, f) in enumerate(workers):
        rc = p.wait(timeout=TIMEOUT)
        f.close()
        with open(os.path.join(work, f"worker{r}.log")) as f:
            assert rc == 0, f.read()
    return {"dir": work, "one": one}


def _log(runs, tag, rank):
    with open(os.path.join(runs["dir"], f"log_{tag}_rank{rank}.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# (a)-(c) against the reference's GSPMD steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mesh", REF_RUNS,
                         ids=[_tag(*r) for r in REF_RUNS])
def test_uneven_step_matches_the_reference(runs, name, mesh):
    tag = _tag(name, mesh)
    got = _load(runs["dir"], f"port_{tag}.npz")
    want = _load(runs["dir"], f"jax_{tag}.npz")
    assert got["losses"].shape == (common.UNEVEN_STEPS, common.Z)
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    _adapters_close(got, want, f"port {tag} vs reference",
                    common.MOE_ADAM_SHARE)


def test_the_reference_moves_ragged_rows_past_the_dense_share(runs):
    """The reference's own 2x2 run of dense_rows against its 1x1: losses
    within ``LOSS``, adapters within (a)'s bars at ``common
    .MOE_ADAM_SHARE`` but past the dense example's ``ADAM_SHARE``, the
    share every uneven run takes."""
    name = common.UNEVEN_SELF_RUN
    two = _load(runs["dir"], f"jax_{name}_2x2.npz")
    one = _load(runs["dir"], f"jax_{name}_1x1.npz")
    np.testing.assert_allclose(two["losses"], one["losses"], **LOSS)
    worst = _adapters_close(two, one, f"reference {name} 2x2 vs 1x1",
                            common.MOE_ADAM_SHARE)
    assert worst > ADAM_SHARE, worst


EVALS = [r for r in REF_RUNS if "eval" in common.UNEVEN_RUNS[r[0]][5]
         and r[1] == common.UNEVEN_RUNS[r[0]][4][0]]


@pytest.mark.parametrize("name,mesh", EVALS, ids=[_tag(*r) for r in EVALS])
def test_uneven_eval_matches_the_reference(runs, name, mesh):
    tag = _tag(name, mesh)
    got = _load(runs["dir"], f"port_{tag}.npz")["eval"]
    want = _load(runs["dir"], f"jax_{tag}.npz")["eval"]
    assert got.shape == (common.Z,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOSS)


def test_rwkv_whole_scan_matches_the_one_rank_run(runs):
    """rwkv d 96's 3 heads whole on both model ranks of 2x2: the losses,
    the eval step and the adapters against the port's one-rank run."""
    name = "rwkv_whole"
    got = _load(runs["dir"], f"port_{_tag(name, (2, 2))}.npz")
    one = runs["one"][name]["train"]
    np.testing.assert_allclose(got["losses"], one["losses"], **LOSS)
    np.testing.assert_allclose(got["eval"], one["eval"], **LOSS)
    _adapters_close(got, one, "port rwkv_whole 2x2 vs port 1x1",
                    common.MOE_ADAM_SHARE)


@pytest.mark.parametrize("name", [n for n in SERVES
                                  if n not in common.UNEVEN_ONE_RANK])
def test_uneven_serve_matches_the_reference(runs, name):
    mesh = common.UNEVEN_RUNS[name][4][0]
    tag = _tag(name, mesh)
    _serve_held(common.served(runs["dir"], f"serve_{tag}", mesh),
                _load(runs["dir"], f"jax_serve_{tag}.npz"),
                runs["one"][name]["global"], f"serve {tag}")


def test_rwkv_whole_serve_matches_the_one_rank_run(runs):
    """rwkv d 96's prefill and greedy serve steps on 2x2 against the
    port's one-rank run: every step's logits and every leaf of the
    prefilled cache within 1e-5 of their scale, the streams equal."""
    name = "rwkv_whole"
    got = common.served(runs["dir"], f"serve_{_tag(name, (2, 2))}", (2, 2))
    one = runs["one"][name]["global"]
    close_logits(got["logits"], one["logits"], "rwkv_whole logits")
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    cache = {k: v.float().numpy() for k, v in one["cache"].items()
             if k.startswith("cache/")}
    assert sorted(cache) == sorted(k for k in got if k.startswith("cache/"))
    for key, want in cache.items():
        close_logits(got[key], want, f"rwkv_whole {key}")


# ---------------------------------------------------------------------------
# (e) invariants
# ---------------------------------------------------------------------------

def test_whole_scan_idle_lanes_stay_bitwise_on_every_rank(runs):
    got = common.served(runs["dir"], "lanes_hymba_whole", (1, 4))
    lanes_held(got, runs["one"]["hymba_whole"]["lanes"], "hymba_whole lanes")


@pytest.mark.parametrize("name,served", [("hymba_whole", "serve"),
                                         ("hymba_whole", "lanes"),
                                         ("rwkv_whole", "serve")])
def test_whole_scan_state_is_bitwise_equal_on_every_model_rank(runs, name,
                                                               served):
    """After the prefill every model rank of a data rank holds the same
    whole ``wkv`` / ``ssm`` / ``conv`` leaves, bit for bit, laid out whole
    over "model"."""
    d, m = common.UNEVEN_RUNS[name][4][0]
    tag = (f"serve_{_tag(name, (d, m))}" if served == "serve"
           else f"lanes_{name}")
    parts = common.served(runs["dir"], tag, (d, m))["ranks"]
    keys = [k for k in parts[0] if k.startswith("cache/")
            and k.rsplit("/", 1)[-1] in ("wkv", "ssm", "conv")]
    assert keys, sorted(parts[0])
    for key in keys:
        assert int(parts[0]["split/" + key[len("cache/"):]]) == -1, key
        for i in range(d):
            first = parts[i * m][key]
            for j in range(1, m):
                assert np.array_equal(parts[i * m + j][key], first), (
                    key, i, j)


def _whole_weights(cfg, m):
    """The layer weights the sharded step gathers over "model"."""
    return DR._model_whole(cfg, m)


@pytest.mark.parametrize("name,mesh", RUNS, ids=[_tag(*r) for r in RUNS])
def test_uneven_collective_invariant(runs, name, mesh):
    """No adapter collective crosses "data" (only base weights, the metric
    gather and, for MoE, route counts); over "model" the adapter gradients'
    all-reduces, activations and, where something runs whole, forward
    base-weight all-gathers: for a whole scan branch exactly two a whole
    weight and layer a step (the forward and remat's recompute)."""
    cfg = common.uneven_config(name, "repro_torch")
    d, m = mesh
    targets = len(cfg.lora.targets)
    route = {"route"} if cfg.is_moe else set()
    for r in range(4):
        log = _log(runs, _tag(name, mesh), r)["log"]
        data = [c for c in log if c["axis"] == "data"]
        model = [c for c in log if c["axis"] == "model"]
        assert {c["role"] for c in data} <= {"base_weight", "metric"} | route
        assert all(c["kind"] == "all-gather" for c in data)
        assert not any(c["shape"][-1] == cfg.lora.r_max for c in data
                       if c["role"] != "base_weight")
        if m == 1:
            assert not model
            continue
        grads = [c for c in model if c["role"] == "adapter_grad"]
        assert len(grads) == common.UNEVEN_STEPS * 2 * targets
        assert all(c["kind"] == "all-reduce" for c in grads)
        assert {c["role"] for c in model} <= {"activation", "adapter_grad",
                                              "base_weight"}
        weights = [c for c in model if c["role"] == "base_weight"]
        assert all(c["kind"] == "all-gather" for c in weights)
        if TPT.whole_scan(cfg, m):
            params, _, _ = DR.abstract_state(cfg, common.Z)
            split = {path.rsplit("/", 1)[-1] for path, _, spec in DR._leaves(
                params, TPT.base_param_specs(
                    TMESH.abstract_mesh(mesh, ("data", "model")), params))
                if DR._names(spec, "model")}
            whole = [w for w in _whole_weights(cfg, m) if w in split]
            assert len(weights) == (common.UNEVEN_STEPS * 2
                                    * cfg.num_layers * len(whole)), (
                len(weights), whole)
            # no Mamba partial products are summed over "model"
            assert not any(c["kind"] == "all-reduce"
                           and c["role"] == "activation"
                           and c["dtype"] == "float32"
                           and len(c["shape"]) == 4
                           and c["shape"][-1] != cfg.d_model for c in model)


# ---------------------------------------------------------------------------
# (f) the dry run's model-axis gathers against the logged ones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", WHOLE)
def test_dryrun_model_gathers_equal_the_logged_bytes(runs, name):
    cfg = common.uneven_config(name, "repro_torch")
    _, _, b, S, (mesh,), _ = common.UNEVEN_RUNS[name]
    shape = ShapeConfig("ap_train", S, common.Z * b, KIND_TRAIN,
                        num_slots=common.Z, per_adapter_batch=b)
    with TMESH.fake_group(4):
        fake = TMESH.DeviceMesh("cpu", torch.arange(4).reshape(mesh),
                                mesh_dim_names=("data", "model"))
        low = DR.lower_step(cfg, shape, fake)
    assert TPT.whole_scan(cfg, mesh[1])
    want = sum(op.result_bytes * op.trip_count for op in low.collectives
               if op.line.startswith("model: weight"))
    assert want > 0
    assert not any("partial products" in op.line for op in low.collectives)
    for r in range(4):
        got = sum(c["bytes"] for c in _log(runs, _tag(name, mesh), r)["log"]
                  if c["axis"] == "model" and c["role"] == "base_weight")
        assert got == want * common.UNEVEN_STEPS, (r, got, want)


# ---------------------------------------------------------------------------
# (g) what needs no mesh
# ---------------------------------------------------------------------------

def _plan(m, r, S):
    """A bare ``SpmdPlan`` at model rank ``r`` of ``m``, sequence ``S``."""
    plan = TPT.SpmdPlan.__new__(TPT.SpmdPlan)
    plan.m, plan.model_rank, plan.seq_len = m, r, S
    return plan


@pytest.mark.parametrize("b,S,m", [(4, 32, 2), (4, 128, 2), (2, 24, 4),
                                   (1, 64, 4)])
def test_block_rows_are_the_prefix_of_the_block(b, S, m):
    """For every count of valid rows R of a slot (its flat b·S order), the
    valid rows of each model rank's block [b, S/m] are a prefix of the
    block's flat order, of ``block_rows``' length."""
    rows = torch.arange(b * S + 1, dtype=torch.int32)
    valid = (torch.arange(b * S).reshape(b, S)[None]
             < rows[:, None, None])                    # [R, b, S]
    n = S // m
    for r in range(m):
        got = _plan(m, r, S).block_rows(rows)
        assert got.dtype == torch.int32
        block = valid[:, :, r * n:(r + 1) * n].reshape(len(rows), -1)
        want = block.sum(-1)
        assert torch.equal(got.long(), want)
        prefix = torch.arange(b * n)[None] < want[:, None]
        assert torch.equal(block, prefix)


@pytest.mark.parametrize("tokens,group,d,p,z_local", [
    (192, 128, 2, 1, 2), (96, 128, 4, 1, 1), (96, 128, 2, 2, 2),
    (3072, 2048, 2, 1, 2), (2048, 4096, 2, 1, 2), (4096, 2048, 1, 1, 4)])
def test_moe_pieces_each_lie_inside_one_group(tokens, group, d, p, z_local):
    """``moe_groups``' pieces are gcd(run, group) rows; at every rank
    each piece's flat offsets lie inside one group, and the pieces of all
    ranks cover the flat Z·b·S once."""
    seen = []
    for data_rank in range(d):
        for pod_rank in range(p):
            plan = TPT.SpmdPlan.__new__(TPT.SpmdPlan)
            plan.d, plan.p, plan.z_local = d, p, z_local
            n, piece = plan.moe_groups(tokens, group, 4)
            run = tokens if p == 1 else tokens // z_local
            assert piece == math.gcd(run, group) and n * piece == tokens
            starts = plan._offsets(tokens, piece, data_rank, pod_rank)
            assert torch.equal(starts // group,
                               (starts + piece - 1) // group)
            seen += [int(s) + i for s in starts for i in range(piece)]
    assert sorted(seen) == list(range(tokens * d * p))


@pytest.mark.parametrize("name,mesh", [("hymba_whole", (1, 4)),
                                       ("rwkv_whole", (2, 2))])
def test_whole_scan_cache_layout(name, mesh):
    """Where the scan heads do not split, ``serve_cache_specs`` keeps the
    scan state (and Mamba's conv buffer) whole over "model", and
    ``check_sharded`` takes every step."""
    from repro_torch.models import model as TM
    cfg = common.uneven_config(name, "repro_torch")
    amesh = TMESH.abstract_mesh(mesh, ("data", "model"))
    assert TPT.whole_scan(cfg, mesh[1])
    cache = TM.init_cache(cfg, common.Z, 4, 32, per_lane=True,
                          device="meta")
    flat = chip_smoke._flat_leaves(
        TPT.serve_cache_specs(cfg, amesh, cache)["layers"])
    for key, spec in flat.items():
        assert tuple(spec)[:2] == (None, "data"), (key, spec)
        assert ("model" in tuple(spec)) == (
            key in ("attn/k", "attn/v") and not TPT.whole_heads(cfg,
                                                                mesh[1])), (
            key, spec)
    for step in TPT.SHARDED_STEPS:
        TPT.check_sharded(cfg, amesh, step)
