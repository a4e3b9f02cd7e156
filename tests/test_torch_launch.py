"""PyTorch port: the training launcher and its sharding rules held against
the JAX package (the counterpart of ``tests/test_sharding.py``,
``tests/test_dryrun_specs.py`` and ``repro.launch.train``).

(a) Spec trees — base params, LoRA, optimizer state, hyper-parameters,
    batch and cache — equal the reference's, as tuples, for every assigned
    arch and paper-llama-tiny on the single- and multi-pod abstract meshes.
    The port's trees are built under ``FakeTensorMode`` (shapes only; no
    full-size weight is allocated; the state by the dry run's
    ``abstract_state``), the reference's by ``jax.eval_shape``.
(b) ``pick_spec``'s divisibility fallback, the activation policy's
    decisions (kind, shape) -> spec and its hints, ``shapes.py`` and
    ``ShapeConfig.decompose`` equal the reference's; the reference's
    decisions are read by patching ``with_sharding_constraint`` and
    ``NamedSharding`` inside this file's tests only.
(c) The decisions each model family's loss makes under the policy equal
    the reference's call site for call site (the MoE one-hot dispatch and
    combine aside: the port's index route has no such tensors).
(d) Attention's grouped, repeat and kshard layouts against the reference
    in the same mode (an identity policy with hints model_size 16, opt
    levels 1 and 2), forward within 5e-4 and gradients within 2e-3
    (float32, the JAX package's backend bars); the flash dispatch sees a
    contiguous causal forward under every opt level.
(e) ``scan_chunk`` 32 against the reference on reduced rwkv6 (forward
    5e-4, gradients 2e-3); ``remat=False`` equal to ``remat=True`` bit for
    bit in the port and within 2e-3 of the reference's gradients.
(f) The port's ``steps_dist.make_train_step`` over a one-rank gloo mesh
    against the reference's on a 1x1 JAX CPU mesh for 2 steps (per-slot
    losses within 5e-4, adapters within 2e-3), the mesh helpers, and the
    CLI on the CPU. The sharded step over several ranks is held against
    the reference in ``tests/test_torch_ap.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as JBASE
from repro.configs import shapes as JSHAPES
from repro.configs.registry import ASSIGNED, get_arch as jget_arch
from repro.core import lora as JLORA
from repro.core import losses as JLS
from repro.launch import mesh as JMESH
from repro.launch import partitioning as JPT
from repro.launch import steps_dist as JSD
from repro.models import attention as JATT
from repro.models import linear_scan as JSCAN
from repro.models import model as JM
from repro.models import shardctx as JCTX
from repro.optim import adamw as JAD
from repro_torch import bridge
from repro_torch.configs import base as TBASE
from repro_torch.configs import shapes as TSHAPES
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.core import losses as TLS
from repro_torch.core import steps as TSTEPS
from repro_torch.kernels.flash_attention import ops as TFA
from repro_torch.kernels.linear_scan import ref as TSCANREF
from repro_torch.launch import dryrun as TDR
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import partitioning as TPT
from repro_torch.launch import steps_dist as TSD
from repro_torch.launch import train as TTRAIN
from repro_torch.models import attention as TATT
from repro_torch.models import backend as TBK
from repro_torch.models import linear_scan as TSCAN
from repro_torch.models import model as TM
from repro_torch.models import shardctx as TCTX
from repro_torch.optim import adamw as TAD
from tests.conftest import reduced_f32
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401

FWD = dict(rtol=5e-4, atol=5e-4)
GRAD = dict(rtol=2e-3, atol=2e-3)
ARCHS = ASSIGNED + ["paper-llama-tiny"]
MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    shape, axes = MESHES[name]
    return JMESH.abstract_mesh(shape, axes), TMESH.abstract_mesh(shape, axes)


# ---------------------------------------------------------------------------
# flattening both packages' spec trees
# ---------------------------------------------------------------------------

def _flat_jax(specs):
    """[(path, spec tuple)] of a reference spec tree, in JAX's order."""
    leaves = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), tuple(s)) for p, s in leaves]


def _flat_torch(specs, path=""):
    """The same for a port spec tree: dicts in sorted-key order and
    NamedTuples in field order, as JAX flattens them."""
    if isinstance(specs, TPT.PartitionSpec):
        return [(path, tuple(specs))]
    if isinstance(specs, dict):
        return [x for k in sorted(specs)
                for x in _flat_torch(specs[k], f"{path}['{k}']")]
    if hasattr(specs, "_fields"):
        return [x for f in specs._fields
                for x in _flat_torch(getattr(specs, f), f"{path}.{f}")]
    raise TypeError(type(specs))


def _jax_trees(cfg, Z, b, S, Zc, bc, Sc):
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(lambda k: JM.init_params(k, cfg), key)
    ranks = jnp.full((Z,), min(16, cfg.lora.r_max), jnp.int32)
    lora = jax.eval_shape(lambda k: JLORA.init_lora_tree(
        k, cfg, Z, ranks, JM.target_shapes(cfg)), key)
    opt = jax.eval_shape(lambda t: JAD.init_state(t, Z), lora)
    hp = jax.eval_shape(lambda: JAD.SlotHParams.broadcast(Z))
    batch = {"tokens": jax.ShapeDtypeStruct((Z, b, S), jnp.int32),
             "labels": jax.ShapeDtypeStruct((Z, b, S), jnp.int32)}
    if cfg.input_mode == "mixed":
        batch["modal_embeds"] = jax.ShapeDtypeStruct(
            (Z, b, cfg.num_modality_tokens, cfg.d_model), jnp.bfloat16)
    cache = jax.eval_shape(lambda: JM.init_cache(cfg, Zc, bc, Sc))
    return params, lora, opt, hp, batch, cache


def _port_trees(cfg, Z, b, S, Zc, bc, Sc):
    with FakeTensorMode():
        params, lora, opt = TDR.abstract_state(cfg, Z)
        hp = TAD.SlotHParams.broadcast(Z)
        batch = {"tokens": torch.zeros((Z, b, S), dtype=torch.int32),
                 "labels": torch.zeros((Z, b, S), dtype=torch.int32)}
        if cfg.input_mode == "mixed":
            batch["modal_embeds"] = torch.zeros(
                (Z, b, cfg.num_modality_tokens, cfg.d_model),
                dtype=torch.bfloat16)
        cache = TM.init_cache(cfg, Zc, bc, Sc, device="cpu")
    return params, lora, opt, hp, batch, cache


BUILDERS = ("base_param_specs", "lora_param_specs", "opt_state_specs",
            "hp_specs", "batch_specs", "cache_specs")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_the_reference(arch, mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = jget_arch(arch), tget_arch(arch)
    # train_4k's slots and batch; decode_32k's cache
    Z, b = JSHAPES.TRAIN_4K.decompose()
    Zc, bc = JSHAPES.DECODE_32K.decompose()
    jt = _jax_trees(jcfg, Z, b, JSHAPES.TRAIN_4K.seq_len, Zc, bc,
                    JSHAPES.DECODE_32K.seq_len)
    tt = _port_trees(tcfg, Z, b, TSHAPES.TRAIN_4K.seq_len, Zc, bc,
                     TSHAPES.DECODE_32K.seq_len)
    for name, j, t in zip(BUILDERS, jt, tt):
        # the same leaves, in the same places, of the same shapes
        jshapes = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in
                   jax.tree_util.tree_flatten_with_path(j)[0]]
        want = _flat_jax(getattr(JPT, name)(jmesh, j))
        got = _flat_torch(getattr(TPT, name)(tmesh, t))
        assert [s for _, s in got] == [s for _, s in want], (arch, name)
        if isinstance(t, dict):
            assert [p for p, _ in got] == [p for p, _ in want], (arch, name)
        tshapes = [s for _, s in _flat_torch(TPT._map(
            t, lambda x: TPT.P(*x.shape)))]
        assert tshapes == [s for _, s in jshapes], (arch, name)


def test_pick_spec_fallback_matches_the_reference():
    cases = [((32, 25, 64), [{1: "model"}, {2: "model"}, {}]),
             ((64, 4, 4096), [{0: "data", 1: "pod", 2: "model"},
                              {0: "data", 1: "pod"}, {0: "data"}]),
             ((3, 5), [{0: "data"}, {1: "model"}]),
             ((48, 32), [{0: "pod", 1: "model"}, {1: "model"}]),
             ((16,), [{0: "nope"}, {0: "data"}]),
             ((7, 9), [{}])]
    for name in MESHES:
        jmesh, tmesh = _meshes(name)
        for shape, cands in cases:
            want = JPT.pick_spec(jmesh, shape, cands)
            got = TPT.pick_spec(tmesh, shape, cands)
            assert tuple(got) == tuple(want), (name, shape, cands)
    assert TPT.pick_spec(tmesh, (5,), [{0: "data"}]) == TPT.P()


# ---------------------------------------------------------------------------
# activation decisions
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_decisions(monkeypatch):
    """Patch the reference's constraint so that it returns its input and
    leaves the spec it was given in ``holder``."""
    holder = {}

    def wsc(x, spec):
        holder["spec"] = spec
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", wsc)
    monkeypatch.setattr(JPT, "NamedSharding", lambda mesh, spec: spec)
    return holder


def _jax_decide(policy, holder, shape, kind):
    holder.pop("spec", None)
    policy(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
    spec = holder.get("spec")
    return None if spec is None else tuple(spec)


KINDS = [
    ("residual", (64, 4, 4096, 2560)), ("residual", (64, 4, 1, 2560)),
    ("residual", (2, 4096, 2560)),
    ("attn_qkv", (64, 4, 4096, 32, 80)), ("attn_qkv", (16, 8, 1, 25, 64)),
    ("attn_qkv", (2, 3, 5, 7, 9)),
    ("ffn_hidden", (64, 4, 4096, 6912)), ("ffn_hidden", (64, 3, 7, 13)),
    ("logits", (64, 4, 512, 50304)), ("logits", (64, 4, 50304)),
    ("logits", (3, 5, 7)),
    ("moe_expert", (32, 64, 256, 1024)), ("moe_expert", (40, 3, 5, 7)),
    ("weight:q_proj", (2560, 2560)), ("weight:o_proj", (2560, 2560)),
    ("weight:lm_head", (2560, 50304)), ("weight:w_gate", (32, 1024, 512)),
    ("weight:w_down", (32, 512, 1024)), ("weight:shared/gate", (5120, 8192)),
    ("weight:in_proj", (1600, 6400)), ("weight:norm", (2560,)),
    ("dims:data,pod,model", (64, 4, 4096, 32, 80)),
    ("dims:data,pod,-,model", (64, 4, 4096, 8, 4, 80)),
    ("dims:data+pod", (2048, 128, 1024)),
    ("dims:data+pod,-,model", (2048, 128, 32, 64)),
    ("dims:data,pod,model", (64, 4, 25)),
    ("unknown", (64, 4, 4096)),
]


@pytest.mark.parametrize("mesh_name", sorted(MESHES) + ["one"])
def test_activation_decisions_match_the_reference(mesh_name, jax_decisions):
    if mesh_name == "one":
        jmesh = JMESH.abstract_mesh((1, 1), ("data", "model"))
        tmesh = TMESH.abstract_mesh((1, 1), ("data", "model"))
    else:
        jmesh, tmesh = _meshes(mesh_name)
    for opt in (0, 1, 2):
        for kind_ in ("train", "prefill", "decode"):
            for seq in (True, False):
                kw = dict(seq_shard=seq, opt_level=opt, step_kind=kind_)
                jp = JPT.activation_policy(jmesh, **kw)
                tp = TPT.activation_policy(tmesh, **kw)
                assert tp.hints == jp.hints, kw
                for kind, shape in KINDS:
                    want = _jax_decide(jp, jax_decisions, shape, kind)
                    x = torch.empty(shape, device="meta")
                    assert tp(x, kind) is x
                    got = tp.decisions[(kind, shape)]
                    got = None if got is None else tuple(got)
                    assert got == want, (mesh_name, kw, kind, shape)


def test_shapes_and_configs_equal_the_reference():
    assert set(TSHAPES.SHAPES) == set(JSHAPES.SHAPES)
    for name, js in JSHAPES.SHAPES.items():
        ts = TSHAPES.get_shape(name)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert ts.decompose() == js.decompose() and ts.is_decode == \
            js.is_decode
    bad = TBASE.ShapeConfig("odd", 8, 10, TBASE.KIND_TRAIN, num_slots=3)
    with pytest.raises(AssertionError):
        JBASE.ShapeConfig("odd", 8, 10, JBASE.KIND_TRAIN,
                          num_slots=3).decompose()
    with pytest.raises(AssertionError):
        bad.decompose()
    auto = TBASE.ShapeConfig("auto", 8, 256, TBASE.KIND_PREFILL)
    assert auto.decompose() == JBASE.ShapeConfig(
        "auto", 8, 256, JBASE.KIND_PREFILL).decompose() == (64, 4)
    with pytest.raises(KeyError):
        TSHAPES.get_shape("nope")
    assert (TBASE.KIND_TRAIN, TBASE.KIND_PREFILL, TBASE.KIND_DECODE) == (
        JBASE.KIND_TRAIN, JBASE.KIND_PREFILL, JBASE.KIND_DECODE)
    for t, j in ((TMESH.SINGLE_POD, JMESH.SINGLE_POD),
                 (TMESH.MULTI_POD, JMESH.MULTI_POD)):
        assert (t.shape, t.axes, t.num_devices) == (j.shape, j.axes,
                                                     j.num_devices)
    m = TMESH.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert TMESH.mesh_config(m) == TBASE.MeshConfig((2, 16, 16),
                                                    ("pod", "data", "model"))


# ---------------------------------------------------------------------------
# the model's call sites
# ---------------------------------------------------------------------------

def _recording(policy, holder=None):
    """A policy that records (kind, shape, spec) of every call: the port's
    own decisions, or the reference's read through ``holder``."""
    seen = set()

    def rec(x, kind):
        if holder is None:
            out = policy(x, kind)
            spec = policy.decisions[(kind, tuple(x.shape))]
        else:
            holder.pop("spec", None)
            out = policy(x, kind)
            spec = holder.get("spec")
        seen.add((kind, tuple(x.shape),
                  None if spec is None else tuple(spec)))
        return out

    rec.hints = policy.hints
    rec.seen = seen
    return rec


FAMILY_ARCHS = ["paper-llama-tiny", "granite-moe-1b-a400m", "rwkv6-3b",
                "hymba-1.5b", "qwen2-vl-72b"]


@pytest.mark.parametrize("opt", [0, 1, 2])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_model_call_sites_match_the_reference(arch, opt, jax_decisions):
    jcfg = reduced_f32(arch, num_layers=2, d_model=64, vocab=64)
    tcfg = dataclasses.replace(
        tget_arch(arch).reduced(num_layers=2, d_model=64, vocab=64),
        dtype="float32")
    Z, b, S = 2, 2, 16
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jranks = jnp.full((Z,), jcfg.lora.r_max, jnp.int32)
    jlora = JLORA.init_lora_tree(jax.random.PRNGKey(1), jcfg, Z, jranks,
                                 JM.target_shapes(jcfg))
    tlora = bridge.lora_from_numpy(
        jax.tree_util.tree_map(np.asarray, jlora), "cpu")
    tok = np.random.default_rng(0).integers(0, 64, (Z, b, S)).astype(
        np.int32)
    active = np.ones(Z, np.int32)
    jmesh, tmesh = _meshes("single_pod")
    jrec = _recording(JPT.activation_policy(jmesh, opt_level=opt),
                      jax_decisions)
    trec = _recording(TPT.activation_policy(tmesh, opt_level=opt))
    with JCTX.sharding_policy(jrec):
        jl = JLS.sft_loss(jcfg, jparams, jlora,
                          {"tokens": tok, "labels": tok}, active)[1]
    with TCTX.sharding_policy(trec), TBK.backend("torch"), \
            torch.no_grad():
        tl = TLS.sft_loss(tcfg, tparams, tlora,
                          {"tokens": torch.from_numpy(tok),
                           "labels": torch.from_numpy(tok)},
                          torch.from_numpy(active))[1]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    # the reference's one-hot dispatch/combine constraints have no tensor
    # in the port's index route
    want = {d for d in jrec.seen if d[0] != "dims:data+pod,-,model"}
    assert trec.seen == want, (sorted(trec.seen ^ want, key=str))


# ---------------------------------------------------------------------------
# attention layouts and the flash dispatch
# ---------------------------------------------------------------------------

def _identity(x, kind):
    return x


@pytest.mark.parametrize("opt", [1, 2])
@pytest.mark.parametrize("mode,H,KV", [("grouped", 16, 16),
                                       ("repeat", 16, 4),
                                       ("kshard", 8, 2)])
def test_attention_layouts_match_the_reference(mode, H, KV, opt):
    hints = {"model_size": 16, "opt_level": opt}
    Z, b, S, hd = 2, 1, 32, 8
    rng = np.random.default_rng(1)
    q = rng.standard_normal((Z, b, S, H, hd), dtype=np.float32)
    k = rng.standard_normal((Z, b, S, KV, hd), dtype=np.float32)
    v = rng.standard_normal((Z, b, S, KV, hd), dtype=np.float32)
    w = rng.standard_normal((Z, b, S, H, hd), dtype=np.float32)
    pos = np.arange(S, dtype=np.int32)
    with JCTX.sharding_policy(_identity, hints):
        assert JATT._pick_mode(H, KV) == mode

        def jf(q_, k_, v_):
            out = JATT.attention(q_, k_, v_, jnp.asarray(pos),
                                 jnp.asarray(pos), window=0, q_chunk=8)
            return jnp.sum(out * w), out

        (_, jout), jg = jax.value_and_grad(jf, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    with TCTX.sharding_policy(_identity, hints), TBK.backend("torch"):
        assert TATT._pick_mode(H, KV) == mode
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        tout = TATT.attention(qt, kt, vt, torch.from_numpy(pos),
                              torch.from_numpy(pos), window=0, q_chunk=8)
        (tout * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **FWD)
    for a, g in zip((qt, kt, vt), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD)
    # without hints, and at model_size 1, the mode is the baseline
    assert TATT._pick_mode(H, KV) == "baseline"
    with TCTX.sharding_policy(_identity, {"model_size": 1,
                                          "opt_level": opt}):
        assert TATT._pick_mode(H, KV) == "baseline"


@pytest.mark.parametrize("opt", [0, 1, 2])
def test_flash_dispatch_sees_contiguous_causal_forwards(opt, monkeypatch):
    cfg = dataclasses.replace(
        tget_arch("paper-llama-tiny").reduced(num_layers=2, d_model=64,
                                              vocab=64), dtype="float32")
    params = TM.init_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 64, (2, 2, 16)).astype(np.int32))
    calls = []
    real = TFA.flash_attention

    def spy(q, k, v, **kw):
        calls.append(all(t.is_contiguous() for t in (q, k, v))
                     and kw.get("causal"))
        return real(q, k, v, **kw)

    monkeypatch.setattr(TFA, "flash_attention", spy)
    with torch.no_grad():
        h0 = TM.forward(cfg, params, {}, tok)[0]
        calls.clear()
        hints = {"model_size": 16, "opt_level": opt}
        with TCTX.sharding_policy(_identity, hints):
            h1 = TM.forward(cfg, params, {}, tok)[0]
    assert calls == [True] * cfg.num_layers
    assert torch.equal(h0, h1)


# ---------------------------------------------------------------------------
# scan_chunk, remat=False
# ---------------------------------------------------------------------------

def test_scan_chunk_32_matches_the_reference(monkeypatch):
    cfg = jget_arch("rwkv6-3b").reduced()
    Z, b, S, H, K = 2, 1, 64, 2, 8
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((Z, b, S, H, K), dtype=np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-3, 1, (Z, b, S, H, K))).astype(np.float32)
    bonus = rng.standard_normal((H, K), dtype=np.float32) * 0.1
    w = rng.standard_normal((Z, b, S, H, K), dtype=np.float32)
    hints = {"scan_chunk": 32, "opt_level": 2, "scan_opt": True}
    chunks = []
    real = TSCANREF.linear_scan_ref

    def spy(*a, **kw):
        chunks.append(kw["chunk"])
        return real(*a, **kw)

    monkeypatch.setattr(TSCANREF, "linear_scan_ref", spy)
    with JCTX.sharding_policy(_identity, hints):
        def jf(q_, k_, v_):
            y, st = JSCAN.chunked_linear_attention(
                q_, k_, v_, jnp.asarray(logw), bonus=jnp.asarray(bonus),
                chunk=cfg.ssm.chunk_size)
            return jnp.sum(y * w), (y, st)

        (_, (jy, jst)), jg = jax.value_and_grad(
            jf, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    with TCTX.sharding_policy(_identity, hints), TBK.backend("torch"):
        qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                      for a in (q, k, v))
        ty, tst = TSCAN.chunked_linear_attention(
            qt, kt, vt, torch.from_numpy(logw),
            bonus=torch.from_numpy(bonus), chunk=cfg.ssm.chunk_size)
        (ty * torch.from_numpy(w)).sum().backward()
    assert chunks == [32] and cfg.ssm.chunk_size != 32
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **FWD)
    np.testing.assert_allclose(tst.detach().numpy(), np.asarray(jst), **FWD)
    for a, g in zip((qt, kt, vt), jg):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), **GRAD)


def test_remat_false_is_bitwise_remat_true_and_matches_the_reference():
    jcfg = reduced_f32("stablelm-3b", num_layers=2, d_model=64, vocab=64)
    tcfg = dataclasses.replace(
        tget_arch("stablelm-3b").reduced(num_layers=2, d_model=64, vocab=64),
        dtype="float32")
    Z = 2
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    jlora = JLORA.init_lora_tree(jax.random.PRNGKey(1), jcfg, Z,
                                 jnp.full((Z,), 8, jnp.int32),
                                 JM.target_shapes(jcfg))
    jlora = jax.tree_util.tree_map(lambda a: a + 0.01, jlora)
    tok = np.random.default_rng(0).integers(0, 64, (Z, 2, 16)).astype(
        np.int32)
    active = np.ones(Z, np.int32)
    jg = jax.grad(lambda l_: JLS.sft_loss(
        jcfg, jparams, l_, {"tokens": tok, "labels": tok}, active,
        remat=False)[0])(jlora)
    batch = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    got = {}
    for remat in (True, False):
        tlora = bridge.lora_from_numpy(
            jax.tree_util.tree_map(np.asarray, jlora), "cpu")
        got[remat] = TSTEPS.lora_grads(tcfg, tparams, tlora, batch,
                                       torch.from_numpy(active), remat=remat)
    assert torch.equal(got[True][0], got[False][0])
    for t in jg:
        for m in jg[t]:
            assert torch.equal(got[True][1][t][m], got[False][1][t][m])
            np.testing.assert_allclose(got[False][1][t][m].numpy(),
                                       np.asarray(jg[t][m]), **GRAD)


# ---------------------------------------------------------------------------
# the step over a one-rank mesh, the mesh helpers, the CLI
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_group(tmp_path):
    """A one-rank gloo group through a FileStore under ``tmp_path``,
    destroyed after the test."""
    with TMESH.process_group("cpu", f"file://{tmp_path / 'pg'}"):
        yield


def test_step_over_a_one_rank_mesh_matches_the_jax_1x1_mesh(gloo_group):
    jcfg = reduced_f32("stablelm-3b", num_layers=2, d_model=64, vocab=64)
    tcfg = dataclasses.replace(
        tget_arch("stablelm-3b").reduced(num_layers=2, d_model=64, vocab=64),
        dtype="float32")
    Z, b, S = 4, 2, 16
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    jranks = jnp.asarray([4, 8, 8, 2], jnp.int32)
    jlora = JLORA.init_lora_tree(jax.random.PRNGKey(1), jcfg, Z, jranks,
                                 JM.target_shapes(jcfg))
    jopt = JAD.init_state(jlora, Z)
    jhp = JAD.SlotHParams.broadcast(Z, lr=1e-2)
    active = np.ones(Z, np.int32)
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, 64, (Z, b, S)).astype(np.int32),
                "labels": rng.integers(0, 64, (Z, b, S)).astype(np.int32)}
               for _ in range(2)]
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    tparams = bridge.params_from_numpy(tcfg, np_(jparams), "cpu")
    tlora = bridge.lora_from_numpy(np_(jlora), "cpu")
    topt = bridge.adamw_state_from_numpy(np_(jopt), "cpu")
    thp = bridge.hparams_from_numpy(np_(jhp), "cpu")
    tranks = torch.from_numpy(np.array(jranks))
    tactive = torch.from_numpy(active)

    # Auto axes: the reference's constraints refer to them (jax >= 0.7
    # makes Explicit axes by default, which its constraints cannot name)
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jstep = jax.jit(JSD.make_train_step(jcfg, jmesh))
    mesh = TMESH.make_local_mesh((1, 1), device="cpu")
    assert TMESH.axis_sizes(mesh) == {"data": 1, "model": 1}
    tstep = TSD.make_train_step(tcfg, mesh)

    def placed(tree, specs):
        return TPT.distribute(mesh, tree, TPT.to_named(mesh, specs))

    tparams = placed(tparams, TPT.base_param_specs(mesh, tparams))
    tlora = placed(tlora, TPT.lora_param_specs(mesh, tlora))
    topt = placed(topt, TPT.opt_state_specs(mesh, topt))
    for batch in batches:
        with jmesh:
            jlora, jopt, jm = jstep(jparams, jlora, jopt, jhp, active,
                                    jranks, batch)
        tlora, topt, tm = tstep(tparams, tlora, topt, thp, tactive, tranks,
                                {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        np.testing.assert_allclose(tm["per_slot_loss"].numpy(),
                                   np.asarray(jm["per_slot_loss"]), **FWD)
    for t in jlora:
        for m in jlora[t]:
            np.testing.assert_allclose(tlora[t][m].numpy(),
                                       np.asarray(jlora[t][m]), **GRAD)
    # the policy resolved the step's constraints on the one-rank mesh
    assert tstep.policy.decisions
    assert all(s is None or all(a is None or a in ("data", "model")
                                for a in s)
               for s in tstep.policy.decisions.values())


def test_placements_and_one_rank_execution(gloo_group):
    mesh = TMESH.make_local_mesh((1, 1), device="cpu")
    P = TPT.P
    assert TPT.placements(mesh, P("data", "model")) == (
        TPT.Shard(0), TPT.Shard(1))
    assert TPT.placements(mesh, P(None, "data")) == (TPT.Shard(1),
                                                     TPT.Replicate())
    assert TPT.placements(mesh, P()) == (TPT.Replicate(), TPT.Replicate())
    t = torch.randn(4, 3)
    d = TPT.distribute(mesh, {"w": t}, {"w": TPT.placements(mesh,
                                                            P("data"))})
    assert isinstance(d["w"], TPT.DTensor)
    assert TPT.local(d)["w"].data_ptr() == t.data_ptr()     # no copy
    with pytest.raises(RuntimeError):
        TMESH.make_local_mesh((2, 1), device="cpu")
    with pytest.raises(RuntimeError):
        TMESH.make_production_mesh()
    # a 2x1 mesh needs two ranks (tests/test_torch_ap.py runs four)
    with pytest.raises(RuntimeError):
        TTRAIN.build_mesh("2x1", "cpu")
    with pytest.raises(RuntimeError):        # one group at a time
        with TMESH.process_group("cpu"):
            pass


def test_train_cli_on_the_cpu(capsys):
    out = TTRAIN.main(["--reduced", "--device", "cpu", "--steps", "2"])
    assert not dist.is_initialized()         # the group was destroyed
    assert len(out["losses"]) == 2
    assert all(np.isfinite(v) for row in out["losses"] for v in row)
    assert out["policy_decisions"] > 0
    text = capsys.readouterr().out
    assert "step    1" in text and text.rstrip().endswith("done")
