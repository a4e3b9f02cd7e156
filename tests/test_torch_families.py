"""PyTorch port: the last model families — ``qwen2-vl-72b`` (``vlm``:
M-RoPE and a patch-embedding prefix), ``musicgen-medium`` (``audio``) and
the dense ``glm4-9b``, ``granite-8b`` and ``mistral-nemo-12b`` — held
against the JAX package, and their bitwise contracts inside the port.

(a) The registry: all eleven configs equal the JAX package's field by field,
    and ``ASSIGNED`` equals its list.
(b) ``rope_angles`` / ``text_positions`` under M-RoPE for ``[3, S]`` and
    ``[3, Z, b, S]`` positions; M-RoPE on (t, t, t) equals RoPE bitwise.
(c) Model level, on float32 ``reduced()`` configs (2 layers, d 256, head
    dim 32; mistral at ``head_dim=16`` so that q_dim 128 != d_model 256, as
    the full config has it) with bridged weights (initialized by the JAX
    package, carried over by ``repro_torch.bridge``) and numpy inputs, at
    the JAX package's backend bars (forward 5e-4, loss 1e-4, gradients
    2e-3; tests/test_kernel_backends.py): qwen2-vl's forward with 8 patch
    embeddings over a 2 x 4 grid — patch (row, col) at (0, row, col), the
    text after it at (4 + i, 4 + i, 4 + i) — under both backends; three
    train steps of each of the five architectures (qwen2-vl image-prefixed,
    labels -1 on the prefix); eval and ``make_prefill_step`` with the
    prefix, and global decode after it; per-lane prefill and decode under
    M-RoPE with idle lanes bitwise untouched.
(d) Serving and the executor, reduced qwen2-vl: greedy streams of
    ``ServingReplica`` equal the JAX replica's; co-located rank sweeps equal
    each alone, bitwise; a rank sweep through ``BatchedExecutor.run_task``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.core import lora as JLORA
from repro.core import steps as JSTEPS
from repro.core.losses import sft_loss as jsft_loss
from repro.models import backend as JBK
from repro.models import model as JM
from repro.models import rope as JROPE
from repro.optim import adamw as JAD
from repro.serve import AdapterPool as JPool
from repro.serve import ServingFrontend as JFrontend
from repro.serve import ServingReplica as JReplica
from repro_torch import bridge
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import RoPEConfig, TrainConfig
from repro_torch.core import early_exit as TEE
from repro_torch.core import lora as TLORA
from repro_torch.core import steps as TSTEPS
from repro_torch.core.executor import (BatchedExecutor,
                                       SharedBackboneExecutor, TaskLifecycle,
                                       TaskResult, run_colocated)
from repro_torch.data import synthetic as TSYN
from repro_torch.kernels.flash_attention import flash_attention as TFAK
from repro_torch.kernels.flash_attention import ops as TFAOPS
from repro_torch.kernels.grouped_lora import ranklocal as TRL
from repro_torch.launch import serve as cli
from repro_torch.models import backend as TBK
from repro_torch.models import model as TM
from repro_torch.models import rope as TROPE
from repro_torch.serve import AdapterPool, ServingFrontend, ServingReplica
from tests.test_torch_grouped_lora import _one_torch_thread  # noqa: F401

FWD_TOL = dict(rtol=5e-4, atol=5e-4)
GTOL = dict(rtol=2e-3, atol=2e-3)
LOSS_RTOL = 1e-4
Z, BSZ, SEQ = 2, 2, 32
RANKS = [3, 6]
VLM = "qwen2-vl-72b"
FAMILY_ARCHS = (VLM, "musicgen-medium", "glm4-9b", "granite-8b",
                "mistral-nemo-12b")
GRID = (2, 4)                   # the reduced prefix: 8 patches


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _cfgs(arch, **kw):
    """The reduced float32 config in both packages; mistral keeps q_dim !=
    d_model (``reduced()`` makes them equal)."""
    jcfg = dataclasses.replace(JREG.get_arch(arch).reduced(**kw),
                               dtype="float32")
    tcfg = dataclasses.replace(TREG.get_arch(arch).reduced(**kw),
                               dtype="float32")
    if arch == "mistral-nemo-12b":
        jcfg = dataclasses.replace(jcfg, head_dim=16)
        tcfg = dataclasses.replace(tcfg, head_dim=16)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def image_positions(grid, S):
    """[3, S] M-RoPE positions of a patch-grid prefix and the text after it:
    patch (row, col) at (0, row, col), text i at (G + i, G + i, G + i) with
    G = max(grid)."""
    rows, cols = grid
    P = rows * cols
    r, c = np.divmod(np.arange(P), cols)
    text = max(grid) + np.arange(S - P)
    return np.stack([np.concatenate([np.zeros(P), text]),
                     np.concatenate([r, text]),
                     np.concatenate([c, text])]).astype(np.int32)


def _image_inputs(cfg, rng, lanes=(Z, BSZ), S=SEQ):
    """(modal_embeds [*lanes, P, d] at scale 0.02, positions [3, *lanes,
    S])."""
    P = cfg.num_modality_tokens
    assert P == GRID[0] * GRID[1]
    emb = 0.02 * rng.standard_normal((*lanes, P, cfg.d_model))
    pos = np.broadcast_to(image_positions(GRID, S)[:, None, None],
                          (3, *lanes, S))
    return emb.astype(np.float32), np.ascontiguousarray(pos)


def _random_lora(cfg, shapes, rng):
    L, r = cfg.num_layers, cfg.lora.r_max
    mask = (np.arange(r)[None, :] < np.asarray(RANKS)[:, None]).astype(
        np.float32)                                            # [Z, r]
    return {t: {"A": (rng.standard_normal((L, Z, din, r), np.float32)
                      / din ** 0.5 * mask[None, :, None, :]),
                "B": (rng.standard_normal((L, Z, r, dout), np.float32)
                      * 0.05 * mask[None, :, :, None])}
            for t, (din, dout) in shapes.items()}


def _bridged(arch, **kw):
    jcfg, tcfg = _cfgs(arch, **kw)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


# ---------------------------------------------------------------------------
# (a) the registry
# ---------------------------------------------------------------------------

def test_registry_equals_jax_field_by_field():
    assert TREG.ASSIGNED == JREG.ASSIGNED
    assert TREG.list_archs() == JREG.list_archs()
    assert len(TREG.list_archs()) == 11
    assert not hasattr(TREG, "NOT_PORTED")
    for arch in JREG.list_archs():
        assert (dataclasses.asdict(TREG.get_arch(arch))
                == dataclasses.asdict(JREG.get_arch(arch))), arch
    q = TREG.get_arch(VLM)
    assert (q.family, q.rope.mrope_sections, q.num_modality_tokens,
            q.input_mode) == ("vlm", (16, 24, 24), 256, "mixed")
    m = TREG.get_arch("mistral-nemo-12b")
    assert (m.q_dim, m.d_model) == (4096, 5120)
    g = TREG.get_arch("glm4-9b")
    assert (g.kv_dim, g.d_ff) == (256, 13696)
    assert TREG.get_arch("musicgen-medium").family == "audio"


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cli_serves_each_new_arch_reduced(arch, capsys):
    """Each new architecture is a ``--arch`` choice and serves reduced on
    the CPU (2 slots, one 6-token prompt each, 3 new tokens); an unknown
    arch is refused."""
    cli.main(["--arch", arch, "--reduced", "--device", "cpu", "--slots",
              "2", "--requests", "1", "--prompt-len", "6", "--max-new", "3",
              "--ranks", "2,4"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "served 6 tokens" in out
    with pytest.raises(SystemExit):
        cli.main(["--arch", "not-an-arch", "--device", "cpu"])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bridge_carries_the_new_configs(arch):
    """Every leaf of the JAX package's parameters arrives with its shape
    (the untied ``lm_head``; o_proj [q_dim, d] with q_dim != d_model for
    mistral), the port's own init has the same keys and shapes, and an
    o_proj of the wrong shape is refused."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    want = dict(_leaves(jparams))
    got = dict(_leaves(tparams))
    own = dict(_leaves(TM.init_params(tcfg, seed=0, device="cpu")))
    assert set(got) == set(want) == set(own) and "lm_head" in got
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape == tuple(own[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    assert tuple(got["layers.o_proj"].shape[1:]) == (tcfg.q_dim, tcfg.d_model)
    if arch == "mistral-nemo-12b":
        assert tcfg.q_dim != tcfg.d_model
    assert TM.target_shapes(tcfg) == JM.target_shapes(jcfg)
    bad = jax.tree_util.tree_map(np.asarray, jparams)
    bad["layers"]["o_proj"] = bad["layers"]["o_proj"][:, :, :8]
    with pytest.raises(ValueError, match="projections"):
        bridge.params_from_numpy(tcfg, bad, "cpu")


# ---------------------------------------------------------------------------
# (b) M-RoPE
# ---------------------------------------------------------------------------

MROPE = RoPEConfig(theta=1_000_000.0, mrope_sections=(8, 4, 4))


@pytest.mark.parametrize("lead", [(), (Z, BSZ)], ids=["3xS", "3xZxbxS"])
def test_mrope_angles_and_text_positions_match_jax(lead):
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 4096, (3, *lead, 24)).astype(np.int32)
    want = np.asarray(JROPE.rope_angles(jnp.asarray(pos), 32, MROPE))
    got = TROPE.rope_angles(_t(pos), 32, MROPE)
    assert tuple(got.shape) == (*lead, 24, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for off in (0, 7):
        jt = JROPE.text_positions(lead, 24, MROPE, offset=off)
        tt = TROPE.text_positions(lead, 24, MROPE, offset=off)
        assert tuple(tt.shape) == (3, *lead, 24)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    with pytest.raises(AssertionError):
        TROPE.rope_angles(_t(pos[:2]), 32, MROPE)
    with pytest.raises(AssertionError):
        TROPE.rope_angles(_t(pos), 48, MROPE)


def test_mrope_on_text_positions_equals_rope():
    plain = RoPEConfig(theta=MROPE.theta)
    t = TROPE.text_positions((Z, BSZ), 24, plain, offset=5)
    ttt = TROPE.text_positions((Z, BSZ), 24, MROPE, offset=5)
    assert torch.equal(ttt[0], t) and torch.equal(ttt[2], t)
    assert torch.equal(TROPE.rope_angles(ttt, 32, MROPE),
                       TROPE.rope_angles(t, 32, plain))


# ---------------------------------------------------------------------------
# (c) model level against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    jcfg, tcfg, jparams, tparams = _bridged(VLM)
    assert (tcfg.family, tcfg.head_dim, tcfg.rope.mrope_sections,
            tcfg.num_modality_tokens) == ("vlm", 32, (8, 4, 4), 8)
    rng = np.random.default_rng(1)
    lora = _random_lora(tcfg, JM.target_shapes(jcfg), rng)
    tokens = rng.integers(0, jcfg.vocab_size, (Z, BSZ, SEQ)).astype(np.int32)
    emb, pos = _image_inputs(tcfg, rng)
    return jcfg, tcfg, jparams, tparams, lora, tokens, emb, pos


def _spy_flash(monkeypatch):
    calls = []
    real = TFAOPS._FlashAttention.apply

    def spy(*args):
        calls.append((tuple(args[0].shape),
                      all(a.is_contiguous() for a in args[:3])))
        return real(*args)
    monkeypatch.setattr(TFAOPS._FlashAttention, "apply", spy)
    return calls


@pytest.mark.parametrize("lead", ["3xS", "3xZxbxS"])
@pytest.mark.parametrize("backends", [("kernel", "pallas_interpret"),
                                      ("torch", "jnp")])
def test_image_prefixed_forward_matches_jax(vlm, backends, lead,
                                            monkeypatch):
    """Hidden states of qwen2-vl's forward with the patch embeddings over
    the first 8 positions and the grid's (t, h, w) positions, shared
    ([3, S]) or per lane ([3, Z, b, S]), against the JAX forward under its
    Pallas (interpret) and jnp backends; under "kernel" the flash Function
    runs once per layer on the 1-D ``q_pos``. The text positions (t, t, t)
    give other hidden states (the positions reach the angles)."""
    jcfg, tcfg, jparams, tparams, lora, tokens, emb, pos = vlm
    pos = pos[:, 0, 0] if lead == "3xS" else pos
    tb, jb = backends
    with JBK.backend(jb):
        want, _, _ = jax.jit(lambda p, l_, t, e, q: JM.forward(
            jcfg, p, l_, t, positions=q, modal_embeds=e, remat=False))(
                jparams, jax.tree_util.tree_map(jnp.asarray, lora),
                jnp.asarray(tokens), jnp.asarray(emb), jnp.asarray(pos))
    calls = _spy_flash(monkeypatch)
    tl = bridge.lora_from_numpy(lora, "cpu")
    with TBK.backend(tb), torch.no_grad(), TLORA.slot_ranks(_t(RANKS)):
        got, aux, _ = TM.forward(tcfg, tparams, tl, _t(tokens),
                                 positions=_t(pos), modal_embeds=_t(emb))
        text, _, _ = TM.forward(tcfg, tparams, tl, _t(tokens),
                                modal_embeds=_t(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    assert float(aux) == 0.0
    L, H, hd = tcfg.num_layers, tcfg.num_heads, tcfg.head_dim
    assert calls == ([((Z * BSZ * H, SEQ, hd), True)] * 2 * L
                     if tb == "kernel" else [])
    assert float((text - got)[:, :, 1:].abs().max()) > 1e-3


def test_embed_writes_the_prefix_out_of_place(vlm):
    _, tcfg, _, tparams, _, tokens, emb, _ = vlm
    x = TM._embed(tparams, _t(tokens), _t(emb))
    P = emb.shape[2]
    assert torch.equal(x[:, :, :P], _t(emb))
    assert torch.equal(x[:, :, P:], tparams["embed"][_t(tokens[:, :, P:])
                                                     .long()])
    assert torch.equal(TM._embed(tparams, _t(tokens)),
                       tparams["embed"][_t(tokens).long()])


def test_single_image_forward_hands_flash_contiguous_rows(vlm, monkeypatch):
    """One image (Z = b = 1): the flattened rows are made contiguous for
    the flash Function, and "kernel" agrees with "torch"."""
    _, tcfg, _, tparams, lora, tokens, emb, pos = vlm
    one = {t: {m: x[:, :1] for m, x in ab.items()}
           for t, ab in bridge.lora_from_numpy(lora, "cpu").items()}
    calls = _spy_flash(monkeypatch)
    out = {}
    with torch.no_grad(), TLORA.slot_ranks(_t(RANKS[:1])):
        for tb in ("kernel", "torch"):
            with TBK.backend(tb):
                out[tb], _, _ = TM.forward(
                    tcfg, tparams, one, _t(tokens[:1, :1]),
                    positions=_t(pos[:, :1, :1]),
                    modal_embeds=_t(emb[:1, :1]))
    assert [c[1] for c in calls] == [True] * tcfg.num_layers
    np.testing.assert_allclose(out["kernel"].numpy(), out["torch"].numpy(),
                               **FWD_TOL)


def _step_inputs(cfg, rng):
    """Numpy moments, hyperparameters and 3 batches (qwen2-vl: with the
    image prefix, labels -1 over it)."""
    lora = _random_lora(cfg, JM.target_shapes(cfg), rng)
    mu = {t: {m: rng.standard_normal(x.shape).astype(np.float32) * 1e-3
              for m, x in ab.items()} for t, ab in lora.items()}
    nu = {t: {m: rng.uniform(0, 1e-5, x.shape).astype(np.float32)
              for m, x in ab.items()} for t, ab in lora.items()}
    opt = JAD.AdamWState(mu, nu, np.array([3, 1], np.int32))
    hp = JAD.SlotHParams(lr=np.array([1e-3, 3e-3], np.float32),
                         wd=np.array([0.01, 0.0], np.float32),
                         beta1=np.full(Z, 0.9, np.float32),
                         beta2=np.full(Z, 0.999, np.float32),
                         grad_clip=np.array([1.0, 0.5], np.float32))
    batches = []
    for _ in range(3):
        nb = {"tokens": rng.integers(0, cfg.vocab_size, (Z, BSZ, SEQ)),
              "labels": rng.integers(0, cfg.vocab_size, (Z, BSZ, SEQ))}
        nb = {k: v.astype(np.int32) for k, v in nb.items()}
        if cfg.input_mode == "mixed":
            nb["modal_embeds"], nb["positions"] = _image_inputs(cfg, rng)
            nb["labels"][:, :, :cfg.num_modality_tokens] = -1
        batches.append(nb)
    return lora, opt, hp, batches


def _assert_tree_close(t_tree, j_tree, what, **tol):
    assert set(t_tree) == set(j_tree)
    for k in j_tree:
        for m in j_tree[k]:
            np.testing.assert_allclose(
                t_tree[k][m].detach().numpy(), np.asarray(j_tree[k][m]),
                err_msg=f"{what} {k}.{m}", **tol)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_three_train_steps_match_jax(arch):
    """Three make_train_step calls at mixed ranks (slot_ranks bound, the
    rank-local path): per-slot loss (1e-4), grad norm, every LoRA gradient
    of each step, and the adapters and first moments after the third
    (2e-3) against the JAX package's step."""
    jcfg, tcfg, jparams, tparams = _bridged(arch)
    lora, opt, hp, batches = _step_inputs(tcfg, np.random.default_rng(2))
    ranks, active = np.asarray(RANKS, np.int32), np.ones(Z, np.int32)
    jtrain = JSTEPS.make_train_step(jcfg)

    @jax.jit
    def jstep(lora_, opt_, batch_):
        b = {k: v for k, v in batch_.items() if k != "slot_ranks"}
        with JLORA.slot_ranks(batch_["slot_ranks"]):
            grads = jax.grad(lambda l_: jsft_loss(
                jcfg, jparams, l_, b, jnp.asarray(active))[0])(lora_)
        return grads, jtrain(jparams, lora_, opt_,
                             jax.tree_util.tree_map(jnp.asarray, hp),
                             jnp.asarray(active), jnp.asarray(ranks), batch_)

    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    jo = jax.tree_util.tree_map(jnp.asarray, opt)
    tl = bridge.lora_from_numpy(lora, "cpu")
    to = bridge.adamw_state_from_numpy(opt, "cpu")
    thp = bridge.hparams_from_numpy(hp, "cpu")
    train = TSTEPS.make_train_step(tcfg)
    for i, nb in enumerate(batches):
        jb = {k: jnp.asarray(v) for k, v in nb.items()}
        jb["slot_ranks"] = jnp.asarray(ranks)
        tb = {k: _t(v) for k, v in nb.items()}
        tb["slot_ranks"] = _t(ranks)
        jgrads, (jl, jo, jm) = jstep(jl, jo, jb)
        _, tgrads = TSTEPS.lora_grads(tcfg, tparams, tl, tb, _t(active))
        _assert_tree_close(tgrads, jgrads, f"step {i} grad", **GTOL)
        tl, to, tm = train(tparams, tl, to, thp, _t(active), _t(ranks), tb)
        np.testing.assert_allclose(tm["per_slot_loss"].numpy(),
                                   np.asarray(jm["per_slot_loss"]),
                                   rtol=LOSS_RTOL, err_msg=f"step {i} loss")
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]),
                                   err_msg=f"step {i} norm", **GTOL)
    _assert_tree_close(tl, jl, "lora", **GTOL)
    _assert_tree_close(to.mu, jo.mu, "mu", **GTOL)


def _cache_close(tc, jc):
    for m in ("k", "v"):
        np.testing.assert_allclose(tc["layers"]["attn"][m].numpy(),
                                   np.asarray(jc["layers"]["attn"][m]),
                                   err_msg=m, **FWD_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_image_prefixed_eval_prefill_and_decode_match_jax(vlm):
    """The eval step's per-slot loss (labels -1 over the prefix), the
    prefill step's last-token logits and cache, and 4 global decode steps
    after it (positions (p, p, p) at the sequence index p, as the JAX
    package continues) against the JAX package."""
    jcfg, tcfg, jparams, tparams, lora, tokens, emb, pos = vlm
    ranks, active = np.asarray(RANKS, np.int32), np.ones(Z, np.int32)
    labels = tokens.copy()
    labels[:, :, :tcfg.num_modality_tokens] = -1
    batch = {"tokens": tokens, "labels": labels, "modal_embeds": emb,
             "positions": pos}
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want = jax.jit(JSTEPS.make_eval_step(jcfg))(
        jparams, jl, jnp.asarray(active), dict(jb, slot_ranks=jnp.asarray(
            ranks)))
    got = TSTEPS.make_eval_step(tcfg)(tparams, tl, _t(active),
                                      dict(tb, slot_ranks=_t(ranks)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOSS_RTOL)
    pre = {k: batch[k] for k in ("tokens", "modal_embeds", "positions")}
    jc = JM.init_cache(jcfg, Z, BSZ, SEQ + 4)
    tc = TM.init_cache(tcfg, Z, BSZ, SEQ + 4, device="cpu")
    jpre = jax.jit(JSTEPS.make_prefill_step(jcfg))
    jdec = jax.jit(JSTEPS.make_serve_step(jcfg))
    rng = np.random.default_rng(4)
    with torch.no_grad(), TLORA.slot_ranks(_t(ranks)):
        with JLORA.slot_ranks(jnp.asarray(ranks)):
            jlog, jc = jpre(jparams, jl, jc,
                            {k: jnp.asarray(v) for k, v in pre.items()})
        tlog, tc = TSTEPS.make_prefill_step(tcfg)(
            tparams, tl, tc, {k: _t(v) for k, v in pre.items()})
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **FWD_TOL)
        _cache_close(tc, jc)
        for i in range(4):
            cur = rng.integers(0, tcfg.vocab_size, (Z, BSZ)).astype(np.int32)
            with JLORA.slot_ranks(jnp.asarray(ranks)):
                jlog, jc = jdec(jparams, jl, jc, jnp.asarray(cur))
            tlog, tc = TSTEPS.make_serve_step(tcfg)(tparams, tl, tc, _t(cur))
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       err_msg=f"decode {i}", **FWD_TOL)
        _cache_close(tc, jc)
        assert int(tc["pos"]) == SEQ + 4


def test_per_lane_prefill_and_decode_under_mrope_match_jax(vlm):
    """Per-lane caches under M-RoPE: block-prefill two lanes, decode with
    an ``active`` mask (the (3, Z, b, 1) positions), join the other lanes
    mid-decode. Logits and the cache match the JAX package; the lanes a call
    does not own stay bitwise untouched."""
    jcfg, tcfg, jparams, tparams, lora, _, _, _ = vlm
    ranks = np.asarray(RANKS, np.int32)
    P, max_len = 8, 16
    rng = np.random.default_rng(5)
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = bridge.lora_from_numpy(lora, "cpu")
    jc = JM.init_cache(jcfg, Z, BSZ, max_len, per_lane=True)
    tc = TM.init_cache(tcfg, Z, BSZ, max_len, per_lane=True, device="cpu")
    masks = [np.array([[1, 0], [0, 1]], bool),
             np.array([[0, 1], [1, 0]], bool)]
    plens = [np.array([[5, 1], [1, 8]], np.int32),
             np.array([[1, 3], [7, 1]], np.int32)]

    def ranked(fn):
        def run(r, *a):
            with JLORA.slot_ranks(r):
                return fn(jcfg, jparams, jl, *a)
        return jax.jit(run)

    jpre, jdec = ranked(JM.prefill_lanes), ranked(JM.decode_step)

    def lanes(cache):
        out = {m: cache["layers"]["attn"][m].transpose(0, 2)
               .transpose(0, 1).clone() for m in ("k", "v")}
        out["pos"] = cache["pos"].clone()
        return out

    def untouched(before, after, own):
        for k, v in after.items():
            assert torch.equal(v[~_t(own)], before[k][~_t(own)]), k

    active = np.zeros((Z, BSZ), bool)
    with torch.no_grad(), TLORA.slot_ranks(_t(ranks)):
        for join in range(2):
            toks = rng.integers(0, jcfg.vocab_size, (Z, BSZ, P))
            jlog, jc = jpre(jnp.asarray(ranks), jc, jnp.asarray(toks),
                            jnp.asarray(masks[join]),
                            jnp.asarray(plens[join]))
            before = lanes(tc)
            tlog, tc = TM.prefill_lanes(tcfg, tparams, tl, tc, _t(toks),
                                        _t(masks[join]), _t(plens[join]))
            untouched(before, lanes(tc), masks[join])
            m = masks[join]
            np.testing.assert_allclose(tlog.numpy()[m], np.asarray(jlog)[m],
                                       **FWD_TOL)
            active |= m
            for step in range(3):
                act = active.copy()
                act[0, 0] &= step != 1          # a lane idles for one step
                cur = rng.integers(0, jcfg.vocab_size, (Z, BSZ))
                jlog, jc = jdec(jnp.asarray(ranks), jc, jnp.asarray(cur),
                                jnp.asarray(act))
                before = lanes(tc)
                tlog, tc = TM.decode_step(tcfg, tparams, tl, tc, _t(cur),
                                          active=_t(act))
                untouched(before, lanes(tc), act)
                np.testing.assert_allclose(tlog.numpy()[act],
                                           np.asarray(jlog)[act], **FWD_TOL)
            _cache_close(tc, jc)


# ---------------------------------------------------------------------------
# (d) serving and the executor, reduced qwen2-vl
# ---------------------------------------------------------------------------

SERVE_RANKS, LANES, MAX_LEN, MAX_NEW = [4, 8, 2], 2, 24, 5


@pytest.fixture(scope="module")
def serve_env():
    jcfg, tcfg, jparams, tparams = _bridged(VLM, num_layers=2, d_model=64,
                                            vocab=128)
    key = jax.random.PRNGKey(0)
    ranks = jnp.asarray(SERVE_RANKS, jnp.int32)

    @jax.jit
    def adapters_of(k):
        lt = JLORA.init_lora_tree(k, jcfg, 3, ranks, JM.target_shapes(jcfg))
        lt = jax.tree_util.tree_map(
            lambda x: x + 0.05 * jax.random.normal(k, x.shape), lt)
        return JLORA.mask_lora_tree(lt, ranks, jcfg.lora.r_max)

    lt = adapters_of(key)
    adapters = {z: jax.tree_util.tree_map(lambda x: np.asarray(x[:, z]), lt)
                for z in range(3)}
    rng = np.random.default_rng(11)
    prompts = {z: [rng.integers(0, 128, size=int(rng.integers(3, 9)))
                   .astype(np.int32) for _ in range(3)] for z in range(3)}
    return jcfg, tcfg, jparams, tparams, adapters, prompts


def _submit(fe, prompts):
    for z in range(3):
        for p in prompts[z]:
            fe.submit(f"a{z}", p, MAX_NEW)
    return fe.drain()


@pytest.mark.parametrize("mode", ["continuous", "round"])
def test_vlm_greedy_streams_match_jax(serve_env, mode):
    """Three text requests per adapter over two lanes: the port's greedy
    streams of ``AdapterPool -> ServingReplica -> ServingFrontend`` equal
    the JAX replica's, token for token (block prefill, then decode at the
    per-lane (3, Z, b, 1) M-RoPE positions)."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = serve_env
    jpool = JPool(jcfg, 3)
    pool = AdapterPool(tcfg, 3, device="cpu")
    for z in range(3):
        jpool.publish(f"a{z}", adapters[z], SERVE_RANKS[z], slot=z)
        pool.publish(f"a{z}", adapters[z], SERVE_RANKS[z], slot=z)
    jout = _submit(JFrontend(JReplica(jcfg, jparams, jpool, lanes=LANES,
                                      max_len=MAX_LEN), mode=mode), prompts)
    rep = ServingReplica(tcfg, tparams, pool, lanes=LANES, max_len=MAX_LEN,
                         device="cpu")
    assert rep._block_prefill
    tout = _submit(ServingFrontend(rep, mode=mode), prompts)
    assert len(tout) == 9 and all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout


@pytest.fixture(scope="module")
def small():
    _, cfg = _cfgs(VLM, num_layers=2, d_model=64, vocab=128)
    params = TM.init_params(cfg, seed=0, device="cpu")
    ds = [TSYN.make_task_dataset(f"task-{i}", cfg.vocab_size, seq_len=32,
                                 num_train=32, num_val=8,
                                 difficulty=0.2 + 0.4 * i, seed=1 + i)
          for i in range(2)]
    return cfg, params, ds


def _hists(lc):
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def test_colocated_vlm_rank_sweeps_bitwise_equal_solo(small):
    """Two qwen2-vl rank sweeps (true ranks 2/4 and 3/5 of r_max 8) fused
    on one executor give each task's loss histories alone, bit for bit; on
    the CPU no kernel launches."""
    cfg, params, ds = small
    specs = [("A", ds[0], 3, (2, 4)), ("B", ds[1], 4, (3, 5))]

    def run(chosen):
        ex = SharedBackboneExecutor(cfg, params, Z=4, per_adapter_batch=2,
                                    eval_every=2, seed=0, device="cpu")
        lcs = []
        for name, d, seed, ranks in chosen:
            jobs = {f"{name}/j{i}": TrainConfig(learning_rate=lr,
                                                lora_rank=rk, max_steps=6)
                    for i, (lr, rk) in enumerate(zip((3e-3, 1e-3), ranks))}
            lcs.append(TaskLifecycle(
                ex, name, jobs, 6, max_slots=2, seed=seed,
                ee=TEE.EarlyExitConfig(warmup_ratio=0.25, select_ratio=1.0),
                batcher=TSYN.SlotBatcher(d, 2, ex.b_cap, seed=seed)))
        return run_colocated(ex, lcs), {lc.task_name: _hists(lc)
                                        for lc in lcs}

    for m in (TFAK, TRL):
        m.reset_launches()
    fused, fused_h = run(specs)
    solo_a, solo_a_h = run(specs[:1])
    solo_b, solo_b_h = run(specs[1:])
    assert fused_h["A"] == solo_a_h["A"] and fused_h["B"] == solo_b_h["B"]
    assert fused["A"].best_val == solo_a["A"].best_val
    assert fused["B"].best_val == solo_b["B"].best_val
    assert np.isfinite(fused["A"].best_val)
    assert TFAK.LAUNCHES == {"flash_attention": 0}
    assert set(TRL.LAUNCHES.values()) == {0}


def test_vlm_rank_sweep_through_run_task(small):
    """8 jobs (ranks 2/3/4/6 x two learning rates) on 4 slots of the
    reduced qwen2-vl: warmup, selection and continue, a TaskResult with
    finite losses — the chip smoke's qwen2-vl rank sweep at a reduced
    size."""
    cfg, params, ds = small
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=2)
            for r in (2, 3, 4, 6) for lr in (1e-3, 1e-2)}
    bx = BatchedExecutor(cfg, params, ds[0], Z=4, per_adapter_batch=2,
                         ee=TEE.EarlyExitConfig(warmup_ratio=0.25,
                                                select_ratio=0.25),
                         eval_every=2, device="cpu")
    result = bx.run_task("vlm-sweep", jobs, total_steps=8)
    assert isinstance(result, TaskResult) and result.best_job in jobs
    assert sum(result.exit_counts.values()) == 8
    winner = result.job_results[result.best_job].adapter
    assert set(winner) == set(cfg.lora.targets)
    assert np.isfinite(result.job_results[result.best_job].best_val)
