"""PyTorch port: the shapes-only dry run (``repro_torch.launch.dryrun``) and
Adapter Parallelism vs FSDP (``launch/sharding_variants.py``).

(a) ``input_specs`` and ``_use_ring`` equal the reference's, shape and
    dtype, for every assigned arch x shape; ``abstract_state``'s leaves
    equal ``jax.eval_shape``'s (here for three archs; every arch's through
    ``tests/test_torch_launch.py``, whose port trees it builds).
(b) The fake group: a mesh over ``fake_group`` passes the activation
    policy's guard (``distribute`` still refuses it); a real two-rank gloo
    mesh (two processes) distributes, steps and agrees with one rank, and
    runs the prefill step of an RWKV config whose 3 scan heads do not
    split over its model axis (whole on both ranks), its logits one
    rank's within 1e-5; the group refuses a second one and is destroyed
    after a failure.
(c) ``dryrun_one`` on a reduced config over a fake 16 x 16 group: ok, its
    FLOPs the direct global count / 256, its collective schedule the
    placements' (weight gathers per pass, residual all-gathers and
    reduce-scatters), and no group left behind, a planted failure
    included.
(d) FLOPs and bytes are linear in depth: the line through the counts at 1
    and 2 layers meets the direct count at 3, for each family's train step
    and the dense and hybrid families' prefill and decode (the dry run
    traces 2 and 3 layers and extrapolates to the full depth).
(e) AP vs FSDP on a reduced config whose Z is a multiple of the data axis:
    AP moves no adapter bytes; FSDP all-reduces the adapter gradients once
    over "data" at 2 (n-1)/n of their per-device bytes and holds 16x AP's
    adapter, optimizer and hyper-parameter bytes; everything else equal.
(f) The train step's FLOPs against the reference's: the reference's step
    compiled on a 1 x 1 mesh and counted from its HLO (2MNK over every dot,
    trip-weighted), the port's traced on a one-rank fake mesh. They differ
    by three named sets of dots, each counted from the config, and by
    nothing else.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs.registry import ASSIGNED
from repro.configs.registry import get_arch as jget_arch
from repro.configs.shapes import SHAPES
from repro.launch import dryrun as JDR
from repro.launch import steps_dist as JSD
from repro.optim import adamw as JAD
from repro.roofline import hlo as JHLO
from repro_torch.configs.base import KIND_TRAIN, ShapeConfig
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.configs.shapes import get_shape
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch import partitioning as PT
from repro_torch.launch import sharding_variants as SV
from repro_torch.launch import train as TTRAIN
from repro_torch.models import model as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILY_ARCHS = ["stablelm-3b", "granite-moe-1b-a400m", "rwkv6-3b",
                "hymba-1.5b", "qwen2-vl-72b", "musicgen-medium"]
# Z 32 slots of b 1 over a 16-wide "data" axis; S 32 over "model"
TINY_TRAIN = ShapeConfig("tiny_train", 32, 32, KIND_TRAIN, num_slots=32,
                         per_adapter_batch=1)


def _reduced(arch, layers=3):
    return tget_arch(arch).reduced(num_layers=layers, d_model=64, vocab=64)


def _tiny(kind):
    """A shape of ``kind`` cut to Z 16 (train: 32) and S 32 (decode: one
    token against a 32-row cache)."""
    return {"train": TINY_TRAIN,
            "prefill": ShapeConfig("tiny_prefill", 32, 32, "prefill",
                                   num_slots=16, per_adapter_batch=2),
            "decode": ShapeConfig("tiny_decode", 32, 32, "decode",
                                  num_slots=16, per_adapter_batch=2)}[kind]


def _flat_jax(tree):
    return sorted((jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
                  for p, x in jax.tree_util.tree_flatten_with_path(tree)[0])


def _flat_torch(tree):
    out = []

    def key(path):
        return "".join(f".{k}" if isinstance(k, str) and k in fields else
                       f"[{k!r}]" for k, fields in path)

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + ((k, ()),))
        elif hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + ((f, t._fields),))
        else:
            out.append((key(path), tuple(t.shape),
                        str(t.dtype).replace("torch.", "")))

    walk(tree, ())
    return sorted(out)


# ---------------------------------------------------------------------------
# (a) the front end
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_and_state_equal_the_reference(arch):
    jcfg, tcfg = jget_arch(arch), tget_arch(arch)
    for name in sorted(SHAPES):
        want, got = JDR.input_specs(arch, name), DR.input_specs(arch, name)
        assert DR._use_ring(tcfg, get_shape(name)) == JDR._use_ring(
            jcfg, SHAPES[name]), (arch, name)
        for k in ("Z", "b", "S", "kind"):
            assert got[k] == want[k], (arch, name, k)
        assert sorted(got) == sorted(want)
        for k in ("batch", "cache", "tokens"):
            if k in want:
                assert _flat_torch({k: got[k]}) == _flat_jax({k: want[k]}), (
                    arch, name, k)


@pytest.mark.parametrize("arch", ["stablelm-3b", "granite-moe-1b-a400m",
                                  "rwkv6-3b"])
def test_abstract_state_equals_eval_shape(arch):
    Z, _ = SHAPES["train_4k"].decompose()
    for j, t in zip(JDR.abstract_state(jget_arch(arch), Z),
                    DR.abstract_state(tget_arch(arch), Z)):
        assert _flat_torch({"x": t}) == _flat_jax({"x": j}), arch


# ---------------------------------------------------------------------------
# (b) the fake group and the guard
# ---------------------------------------------------------------------------

def test_a_fake_mesh_passes_the_guard():
    with MESH.fake_group(256):
        mesh = MESH.make_production_mesh(device_type="cpu")
        assert MESH.is_fake(mesh) and mesh.size() == 256
        assert not PT._real_multi_rank(mesh)
        policy = PT.activation_policy(mesh)
        assert policy.hints["model_size"] == 16
        # nothing places whole tensors as shards of a many-rank mesh
        with pytest.raises(NotImplementedError, match="sharded execution"):
            PT.distribute(mesh, {"w": torch.zeros(2)},
                          {"w": PT.placements(mesh, PT.P())})
        with pytest.raises(RuntimeError):       # one group at a time
            with MESH.fake_group(4):
                pass
        with pytest.raises(RuntimeError):       # 256 ranks, not 512
            MESH.make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()
    with pytest.raises(ValueError):
        with MESH.fake_group(512):
            mesh = MESH.make_production_mesh(multi_pod=True,
                                             device_type="cpu")
            assert MESH.axis_sizes(mesh) == {"pod": 2, "data": 16,
                                             "model": 16}
            raise ValueError("planted")
    assert not dist.is_initialized()


_TWO_RANKS = textwrap.dedent("""
    import dataclasses, json, sys, torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import partitioning as PT
    from repro_torch.launch import steps_dist as SD
    from repro_torch.launch import train as TRAIN
    rank, init = int(sys.argv[1]), sys.argv[2]
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_arch("stablelm-3b").reduced(
        num_layers=2, d_model=64, vocab=64), dtype="float32")
    with MESH.process_group("cpu", init, backend="gloo", rank=rank,
                            world_size=2):
        mesh = TRAIN.build_mesh("1x2", "cpu")
        assert PT._real_multi_rank(mesh)
        res = TRAIN.run(cfg, 2, 2, 16, mesh, 2, device="cpu",
                        log=lambda m: None)
        # 3 scan heads, whole on both model ranks
        rwkv = dataclasses.replace(get_arch("rwkv6-3b").reduced(
            num_layers=2, d_model=96, vocab=64), dtype="float32")
        assert PT.whole_scan(rwkv, 2)
        params = M.init_params(rwkv, seed=0, device="cpu")
        tokens = torch.randint(0, 64, (2, 2, 16), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(1))
        cache = M.init_cache(rwkv, 2, 2, 16, device="cpu")

        def place(tree, specs):
            return PT.distribute(mesh, tree, PT.to_named(mesh, specs))

        batch = {"tokens": tokens}
        logits, _ = SD.make_prefill_step(rwkv, mesh)(
            place(params, PT.base_param_specs(mesh, params)), {},
            place(cache, PT.serve_cache_specs(rwkv, mesh, cache)),
            place(batch, PT.batch_specs(mesh, batch)))
    print(json.dumps({"losses": res["losses"],
                      "logits": logits.tolist()}))
""")


def test_a_real_two_rank_mesh_steps_and_prefills_whole_scan_heads(
        tmp_path):
    """A real two-rank gloo mesh (two processes, model axis 2) distributes
    the weights, takes two sharded train steps whose per-slot losses agree
    with one rank's, and runs the prefill step of an RWKV config whose 3
    scan heads do not split over the model axis of 2 (each rank runs them
    whole): both ranks' logits equal, one rank's within 1e-5."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    init = f"file://{tmp_path / 'pg'}"
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r),
                               init], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    two = [json.loads(out.strip().splitlines()[-1]) for out in outs]
    assert two[0] == two[1]
    cfg = dataclasses.replace(tget_arch("stablelm-3b").reduced(
        num_layers=2, d_model=64, vocab=64), dtype="float32")
    with MESH.process_group("cpu", f"file://{tmp_path / 'pg1'}"):
        mesh = MESH.make_local_mesh((1, 1), device="cpu")
        one = TTRAIN.run(cfg, 2, 2, 16, mesh, 2, device="cpu",
                          log=lambda m: None)["losses"]
    np.testing.assert_allclose(two[0]["losses"], one, rtol=1e-5)
    from repro_torch.core import steps as TS
    rwkv = dataclasses.replace(tget_arch("rwkv6-3b").reduced(
        num_layers=2, d_model=96, vocab=64), dtype="float32")
    tokens = torch.randint(0, 64, (2, 2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = TS.make_prefill_step(rwkv)(
            TM.init_params(rwkv, seed=0, device="cpu"), {},
            TM.init_cache(rwkv, 2, 2, 16, device="cpu"), {"tokens": tokens})
    got = np.asarray(two[0]["logits"], np.float32)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# (c) dryrun_one
# ---------------------------------------------------------------------------

@pytest.fixture
def reduced_stablelm(monkeypatch):
    cfg = _reduced("stablelm-3b", layers=4)    # traced at 2 and 3
    monkeypatch.setattr(DR, "get_arch", lambda name: cfg)
    monkeypatch.setattr(DR, "get_shape", lambda name: TINY_TRAIN)
    return cfg


def test_dryrun_one_on_a_reduced_config(reduced_stablelm):
    cfg = reduced_stablelm
    res = DR.dryrun_one("stablelm-3b", "tiny_train", save=False,
                        verbose=False)
    assert res.ok, res.error
    assert not dist.is_initialized()
    with MESH.fake_group(256):
        mesh = MESH.make_production_mesh(device_type="cpu")
        direct = DR.trace_step(cfg, TINY_TRAIN, mesh)
        params, _, _ = DR.abstract_state(cfg, TINY_TRAIN.decompose()[0])
        p_specs = PT.base_param_specs(mesh, params)
    assert res.flops == direct["flops"] / 256 and res.flops > 0
    assert res.hlo_bytes == 2 * direct["bytes_written"] / 256
    assert (res.compile_s, res.cost_analysis_flops) == (0.0, 0.0)
    assert res.memory_per_device > 0 and "estimate" in res.memory_analysis
    # the schedule: each "data"-sharded layer weight gathered in the
    # forward and remat's recompute (the gathered weight kept for the
    # backward, as the sharded step does); lm_head and the embedding once;
    # the residual's all-gather and reduce-scatter around 2 sublayers a
    # layer in the forward, the recompute and the backward; the 2 heads do
    # not split over the 16-way model axis, so attention runs whole there:
    # q/k/v/o gathered over "model" too, as often as over "data"
    L, passes = cfg.num_layers, 3
    layer_w = sum(1 for path, _, spec in DR._leaves(params, p_specs)
                  if path.startswith("layers/") and DR._names(spec, "data"))
    assert layer_w == 7 and direct["residual"] == ("data", None, "model")
    assert PT.whole_heads(cfg, 16) and cfg.num_heads == 2
    model_w = sum(1 for path, _, spec in DR._leaves(params, p_specs)
                  if path.split("/")[-1] in ("q_proj", "k_proj", "v_proj",
                                             "o_proj")
                  and DR._names(spec, "model"))
    want_ag = (layer_w + model_w) * L * 2 + 1 + 1 + 2 * L * passes
    assert res.collectives["all-gather"]["count"] == want_ag
    assert res.collectives["reduce-scatter"]["count"] == 2 * L * passes
    assert "all-reduce" not in res.collectives
    assert res.collective_traffic == pytest.approx(sum(
        v["traffic_bytes"] for v in res.collectives.values()), rel=1e-12)


def test_dryrun_one_reports_a_failure_and_leaves_no_group(
        reduced_stablelm, monkeypatch, tmp_path):
    def planted(*a, **k):
        assert dist.is_initialized()
        raise RuntimeError("planted")

    monkeypatch.setattr(DR, "lower_step", planted)
    monkeypatch.setattr(DR, "OUT_DIR", str(tmp_path / "dryrun_torch"))
    res = DR.dryrun_one("stablelm-3b", "tiny_train", verbose=False)
    assert not res.ok and "planted" in res.error
    assert not dist.is_initialized()
    saved = tmp_path / "dryrun_torch" / "pod16x16" / \
        "stablelm-3b__tiny_train.json"
    assert saved.exists() and '"ok": false' in saved.read_text()


# ---------------------------------------------------------------------------
# (d) the layer extrapolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,kind", [(a, "train") for a in FAMILY_ARCHS
                                       if a != "stablelm-3b"]
                         + [(a, k) for a in ("stablelm-3b", "hymba-1.5b")
                            for k in ("prefill", "decode")])
def test_extrapolation_is_exact_at_three_layers(arch, kind):
    shape = _tiny(kind)
    with MESH.fake_group(256):
        mesh = MESH.make_production_mesh(device_type="cpu")
        c = [DR.trace_step(_reduced(arch, n), shape, mesh)
             for n in (1, 2, 3)]
    for key in ("flops", "bytes_written"):
        assert DR._extrapolate({1: c[0], 2: c[1]}, 3, key) == c[2][key], (
            key, c)
        assert c[1][key] > c[0][key] > 0, key
    # the memory peak moves between phases as layers are added, so its
    # extrapolation is an estimate; it still grows with depth
    assert c[2]["temp_bytes"] > c[1]["temp_bytes"] > c[0]["temp_bytes"]


# ---------------------------------------------------------------------------
# (e) Adapter Parallelism vs FSDP
# ---------------------------------------------------------------------------

def test_ap_and_fsdp_move_what_their_placements_need():
    cfg = _reduced("stablelm-3b", layers=2)
    with MESH.fake_group(256):
        mesh = MESH.make_production_mesh(device_type="cpu")
        ap, fsdp = (SV.lower(cfg, TINY_TRAIN, mesh, v) for v in ("ap",
                                                                 "fsdp"))
        with pytest.raises(ValueError):
            SV.lower(cfg, TINY_TRAIN, mesh, "zero3")
    assert not any("adapter" in op.line for op in ap.collectives)
    grads = [op for op in fsdp.collectives if "adapter" in op.line]
    (op,) = grads
    assert op.line == "data: adapter grads" and op.kind == "all-reduce"
    assert (op.trip_count, op.group_size) == (1.0, 16)
    assert op.result_bytes == fsdp.arguments["lora"]
    assert op.traffic_bytes == 2 * 15 / 16 * fsdp.arguments["lora"]
    for name in ("lora", "opt", "hp"):
        assert fsdp.arguments[name] == 16 * ap.arguments[name], name
    for name in ("params", "batch"):
        assert fsdp.arguments[name] == ap.arguments[name], name
    # everything else is the same step on the same placements
    assert (fsdp.flops, fsdp.bytes_written, fsdp.temp_bytes) == (
        ap.flops, ap.bytes_written, ap.temp_bytes)
    rest = [o for o in fsdp.collectives if o not in grads]
    assert rest == ap.collectives
    by = fsdp.by_axis()
    assert by["model"] == ap.by_axis()["model"]
    assert by["data"]["all-reduce"]["count"] == 1.0
    assert "all-reduce" not in ap.by_axis()["data"]
    assert np.isclose(sum(o.traffic_bytes for o in fsdp.collectives),
                      sum(o.traffic_bytes for o in ap.collectives)
                      + op.traffic_bytes, rtol=1e-12)


# ---------------------------------------------------------------------------
# (f) FLOPs against the reference's compiled step
# ---------------------------------------------------------------------------

def _dot(m, k, n):
    return 2 * m * k * n


def test_train_step_flops_equal_the_reference_but_for_named_dots():
    jcfg = jget_arch("stablelm-3b").reduced(num_layers=2, d_model=64,
                                            vocab=64)
    cfg = _reduced("stablelm-3b", layers=2)
    Z, b, S = 4, 2, 16
    shape = ShapeConfig("tiny", S, Z * b, KIND_TRAIN, num_slots=Z,
                        per_adapter_batch=b)
    # Auto axes: the reference's constraints refer to them (jax >= 0.7
    # makes Explicit axes by default, which its constraints cannot name)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params, lora, opt = JDR.abstract_state(jcfg, Z)
    vec = JDR.sds((Z,), jnp.int32)
    batch = {k: JDR.sds((Z, b, S), jnp.int32) for k in ("tokens", "labels")}
    step = jax.jit(JSD.make_train_step(jcfg, jmesh))     # remat on
    with jmesh:
        hlo = step.lower(params, lora, opt, JAD.SlotHParams.broadcast(Z),
                         vec, vec, batch).compile().as_text()
    ref = JHLO.analyze(hlo)["flops"]
    with MESH.fake_group(1):
        mesh = MESH.make_local_mesh((1, 1), device="cpu")
        got = DR.trace_step(cfg, shape, mesh)["flops"]   # remat on

    T, L, r = Z * b * S, cfg.num_layers, cfg.lora.r_max
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    ts = TM.target_shapes(cfg)
    # the reference's scan over layers computes the first layer's q / k / v
    # input gradients (base dY W^T and LoRA dS A^T) and drops them; the
    # port's autograd never asks for them, the embeddings being frozen
    first = sum(_dot(T, ts[t][1], ts[t][0]) + _dot(T, r, ts[t][0])
                for t in ("q_proj", "k_proj", "v_proj"))
    # the port's attention backward recomputes the forward's Q K^T and P V
    # (its plain oracle, as the flash kernel's backward does on the card)
    flash = L * 2 * _dot(Z * b * H * S, hd, S)
    # torch's checkpoint recomputes each whole layer; XLA's remat leaves
    # out the last projection, whose output the backward never reads
    din, dout = ts["down_proj"]
    tail = L * (_dot(T, din, dout) + _dot(T, r, dout))
    assert ref > 0 and got == ref - first + flash + tail, (got, ref)
