"""PyTorch port: the tile autotuner (``kernels/grouped_lora/autotune.py``)
against the JAX package's (``tests/test_autotune.py`` is its counterpart).

The key and token bucket equal the reference's apart from the spec
version; candidates are Hopper-legal members of the compiled plan set with
the contraction fields pinned; the default plan is the launchers' shape
rule, read from the CUDA source; illegal plans and TPU-written specs are
refused; winners live in the in-process cache and persist through
``ProfileStore`` (atomic save); the sweep's gate discards a planted
non-bitwise candidate; and ``plan=`` threads through the dense, ragged and
rank-local Functions. On the CPU the wrappers take their plain versions,
which validate a plan and ignore it, so every plan gives the default's
bits there; the CUDA instantiations are held to that on the card
(``chip_smoke.autotune_phase``, ``tests/test_torch_cuda.py``). Forward
parity with the JAX Function under a plan: float32, rtol/atol 5e-4 (the
JAX package's backend bar) forward and 2e-3 for gradients.
"""
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_lora import autotune as JAT
from repro.kernels.grouped_lora import ops as JOPS
from repro_torch.kernels.grouped_lora import autotune as AT
from repro_torch.kernels.grouped_lora import grouped_lora as GL
from repro_torch.kernels.grouped_lora import ops
from repro_torch.kernels.grouped_lora import ragged as RG
from repro_torch.kernels.grouped_lora import ranklocal as RL
from repro_torch.sched.profiler import ProfileStore

ROOT = Path(__file__).resolve().parents[1]
COMMON = (ROOT / "src" / "repro_torch" / "kernels" / "grouped_lora" / "csrc"
          / "ranklocal_common.cuh")
Z, T, DIN, DOUT, RMAX = 3, 24, 64, 48, 16
RTOL = ATOL = 5e-4
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)
# stablelm-3b's projection shapes, the keys the card phase tunes
STABLELM = ((2560, 2560), (2560, 6912), (6912, 2560))


@pytest.fixture(autouse=True)
def _fresh_cache():
    AT.clear_plan_cache()
    yield
    AT.clear_plan_cache()


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Z, T, DIN), dtype=np.float32)
    A = 0.1 * rng.standard_normal((Z, DIN, RMAX), dtype=np.float32)
    B = 0.1 * rng.standard_normal((Z, RMAX, DOUT), dtype=np.float32)
    dy = rng.standard_normal((Z, T, DOUT), dtype=np.float32)
    scale = np.asarray([0.5, 1.0, 2.0], np.float32)
    ranks = np.asarray([8, 16, 5], np.int32)
    rows = np.asarray([T, T // 2, T], np.int32)
    return x, A, B, dy, scale, ranks, rows


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def test_token_bucket_and_plan_key_match_the_reference():
    for t in range(1, 5001):
        assert AT.token_bucket(t) == JAT.token_bucket(t), t
        mine = AT.plan_key(DIN, DOUT, RMAX, Z, t)
        ref = JAT.plan_key(DIN, DOUT, RMAX, Z, t)
        assert mine[1] == AT.PLAN_SPEC_VERSION != ref[1]
        assert mine[:1] + mine[2:] == ref[:1] + ref[2:], t
    assert AT.plan_key(DIN, DOUT, RMAX, Z, 100) == AT.plan_key(
        DIN, DOUT, RMAX, Z, 128)
    assert AT.plan_key(DIN, DOUT, RMAX, Z, 129) != AT.plan_key(
        DIN, DOUT, RMAX, Z, 128)


# ---------------------------------------------------------------------------
# legality and the default
# ---------------------------------------------------------------------------

def test_compiled_plan_set_matches_the_cuda_source():
    text = COMMON.read_text()
    body = text[text.index("#define GL_PLANS(X)"):]
    body = body[:body.index("template <int BM, int BN, int BR>")]
    got = [tuple(int(v) for v in m)
           for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", body)]
    assert [g[0] for g in got] == list(range(len(AT.PLAN_SET)))
    assert [g[1:] for g in got] == [(p.bm, p.bn, p.br) for p in AT.PLAN_SET]


@pytest.mark.parametrize("tokens,din,dout", [(T, DIN, DOUT), (1024, 2560,
                                                              6912),
                                             (4, 6912, 2560), (1, 16, 16)])
def test_candidates_are_hopper_legal(tokens, din, dout):
    plans = AT.candidate_plans(tokens, din, dout, 64, max_candidates=64, Z=4)
    assert plans[0] == AT.DEFAULT_PLAN
    assert len(plans) == 1 + len(AT.PLAN_SET)
    for p in plans[1:]:
        assert p in AT.PLAN_SET and AT.is_legal(p, tokens, din, dout, 64, 4)
        # MMA fragments: m16 rows, n8 columns; tn's warps are 32 x 16
        assert p.bm % 16 == 0 and p.bn % 32 == 0 and p.br % 32 == 0, p
        for w_kn in (True, False):
            stages, smem = AT.narrow_out_smem(p.bm, p.br, w_kn)
            assert stages >= 2 and smem <= 227 * 1024, p
        assert AT.rank_sum_ok(p.bm, p.bn), p
        assert AT.tn_ok(p.bn, p.br) and AT.tn_ok(p.br, p.bn), p
        assert -(-tokens // p.bm) <= 65535


def test_candidates_pin_contraction_fields_and_subsample():
    for p in AT.candidate_plans(1024, 2560, 2560, 64, max_candidates=64):
        assert (p.bk, p.bt) == (AT.NO_BK, AT.TC_BK), p
    few = AT.candidate_plans(1024, 2560, 2560, 64, max_candidates=3)
    assert len(few) == 3 and few[0] == AT.DEFAULT_PLAN
    assert all(p in AT.PLAN_SET for p in few[1:])


def test_default_plan_is_the_launchers_shape_rule():
    text = COMMON.read_text()
    # the launchers' own constants, read from the source
    assert "launch_narrow_out<Act, W_KN, 16, 8, ROWS, RANKS>" in text
    assert "launch_narrow_out<Act, W_KN, RANKS ? 32 : 64, 32, ROWS, " in text
    assert "launch_rank_sum_tile<Act, W_T, 16, 64, ROWS, RANKS>" in text
    assert "launch_rank_sum_tile<Act, W_T, 128, 128, ROWS, RANKS>" in text
    assert "constexpr int TC_TILE = 64;" in text
    assert text.count("else if (T <= 16)") == 2
    for tokens in (1, 4, 16):
        for rank_local in (True, False):
            assert AT.plan_tiles(AT.DEFAULT_PLAN, tokens, rank_local) == {
                "narrow_out": (16, 8), "rank_sum": (16, 64),
                "tn_da": (64, 64), "tn_db": (64, 64)}
    for tokens in (17, 1024):
        assert AT.plan_tiles(AT.DEFAULT_PLAN, tokens, True)[
            "narrow_out"] == (32, 32)
        assert AT.plan_tiles(AT.DEFAULT_PLAN, tokens, False)[
            "narrow_out"] == (64, 32)
        assert AT.plan_tiles(AT.DEFAULT_PLAN, tokens, False)[
            "rank_sum"] == (128, 128)
    p = AT.PLAN_SET[0]
    assert AT.plan_tiles(p, 1024, True) == {
        "narrow_out": (p.bm, p.br), "rank_sum": (p.bm, p.bn),
        "tn_da": (p.bn, p.br), "tn_db": (p.br, p.bn)}


def test_illegal_plans_rejected():
    x, A, B, dy, scale, ranks, rows = (torch.from_numpy(a)
                                       for a in _operands())
    bad = [AT.TilePlan(bm=48, bn=128, br=32),      # not in the compiled set
           AT.TilePlan(bm=64, bn=128, br=32, bk=128),   # contraction moved
           AT.TilePlan(bm=64, bn=128, br=32, bt=64),
           AT.TilePlan(bm=12, bn=128, br=32)]      # not an m16 multiple
    for p in bad:
        assert not AT.is_legal(p, T, DIN, DOUT, RMAX, Z), p
        with pytest.raises(ValueError):
            AT.plan_index(p, T, Z)
        with pytest.raises(ValueError):          # never the default quietly
            RL.xa(x, A, rows, ranks, plan=p)
        with pytest.raises(ValueError):
            ops.grouped_lora(x, A, B, scale, plan=p)
    # a grid past 65,535 row tiles
    big = AT.PLAN_SET[3]                          # bm 16
    assert not AT.is_legal(big, 16 * 65535 + 1, DIN, DOUT, RMAX)
    assert AT.is_legal(big, 16 * 65535, DIN, DOUT, RMAX)
    assert AT.plan_index(None, T, Z) == AT.plan_index(AT.DEFAULT_PLAN, T,
                                                      Z) == -1
    assert [AT.plan_index(p, T, Z) for p in AT.PLAN_SET] == list(
        range(len(AT.PLAN_SET)))


def test_a_spec_written_for_a_tpu_is_never_served(tmp_path):
    # the reference's spec (version 1, no target) and one for another
    # target parse to nothing
    assert AT.TilePlan.from_json(JAT.TilePlan().to_json()) is None
    assert AT.TilePlan.from_json(JAT.TilePlan(bm=16).to_json()) is None
    other = dict(AT.PLAN_SET[0].to_json(), target="tpu_v5e")
    assert AT.TilePlan.from_json(other) is None
    assert AT.TilePlan.from_json(AT.PLAN_SET[0].to_json()) == AT.PLAN_SET[0]
    # a store holding the reference's winner under the port's key still
    # sweeps, and the reference's key is not the port's
    store = ProfileStore()
    key = AT.plan_key(DIN, DOUT, RMAX, Z, T)
    assert key != JAT.plan_key(DIN, DOUT, RMAX, Z, T)
    store.put_spec(key, JAT.TilePlan(bm=8, bn=128).to_json(), durable=True)
    n0 = len(AT.SWEEPS)
    plan = AT.autotune_tile_plan(DIN, DOUT, RMAX, Z, T, device="cpu",
                                 store=store, max_candidates=2, iters=1,
                                 repeats=1)
    assert len(AT.SWEEPS) == n0 + 1
    assert AT.TilePlan.from_json(store.get_spec(key)) == plan


# ---------------------------------------------------------------------------
# cache, persistence, the gate
# ---------------------------------------------------------------------------

def test_autotune_in_process_cache():
    n0 = len(AT.SWEEPS)
    p1 = AT.autotune_tile_plan(DIN, DOUT, RMAX, Z, T, device="cpu",
                               max_candidates=3, iters=1, repeats=1)
    assert AT.plan_key(DIN, DOUT, RMAX, Z, T) in AT._PLANS
    p2 = AT.autotune_tile_plan(DIN, DOUT, RMAX, Z, T, device="cpu")
    assert p1 == p2 and len(AT.SWEEPS) == n0 + 1
    assert AT.plan_for((Z, T, DIN, DOUT, RMAX), device="cpu") == p1
    assert len(AT.SWEEPS) == n0 + 1


def test_winner_persists_and_reloads_through_profile_store(tmp_path):
    store = ProfileStore()
    p1 = AT.autotune_tile_plan(DIN, DOUT, RMAX, Z, T, device="cpu",
                               store=store, max_candidates=3, iters=1,
                               repeats=1)
    key = AT.plan_key(DIN, DOUT, RMAX, Z, T)
    spec = store.get_spec(key)
    assert spec["target"] == "sm_90a" and AT.TilePlan.from_json(spec) == p1
    store.record(("arch", 1), realized_duration=1.0, estimated_duration=2.0)
    assert store.get_spec(key) is not None     # durable: survives versions
    path = tmp_path / "profile.json"
    leftover = tmp_path / "profile.json.tmp.99999"
    leftover.write_text("{corrupt")            # a dead writer's tmp file
    store.save(str(path))
    with open(path) as f:
        assert json.load(f)["durable_specs"]
    assert not any(p.name.startswith("profile.json.tmp.")
                   and p != leftover for p in tmp_path.iterdir())
    assert os.path.exists(leftover)
    AT.clear_plan_cache()
    n0 = len(AT.SWEEPS)
    fresh = ProfileStore.load(str(path))
    assert AT.autotune_tile_plan(DIN, DOUT, RMAX, Z, T, device="cpu",
                                 store=fresh) == p1
    assert len(AT.SWEEPS) == n0                # served, not swept


def _faulty(bad):
    """``six_kernel_step`` whose plan ``bad`` moves one output entry to the
    next float above it."""
    real = AT.six_kernel_step

    def step_of(plan):
        step = real(plan)
        if plan != bad:
            return step

        def faulted(*args):
            outs = list(step(*args))
            s = outs[0].clone()
            s.view(-1)[0] = torch.nextafter(s.view(-1)[0],
                                            torch.tensor(float("inf")))
            outs[0] = s
            return tuple(outs)

        return faulted

    return step_of


def test_sweep_gate_discards_a_planted_candidate(monkeypatch):
    bad = AT.PLAN_SET[1]
    monkeypatch.setattr(AT, "six_kernel_step", _faulty(bad))
    res = AT.sweep(DIN, DOUT, RMAX, Z, T, device="cpu", iters=1, repeats=1)
    assert res.discarded == [bad]
    assert res.plan != bad
    winner = [c for c in res.candidates if c.plan == res.plan]
    assert winner and winner[0].bitwise_equal_default
    assert res.best_s <= res.default_s and res.speedup >= 1.0
    assert [c.plan for c in res.candidates] == AT.candidate_plans(
        T, DIN, DOUT, RMAX, Z=Z)


def test_six_kernel_step_runs_the_three_sets():
    args = AT._probe_operands(Z, T, DIN, DOUT, RMAX, device="cpu")
    outs = AT.six_kernel_step(AT.DEFAULT_PLAN)(*args)
    assert len(outs) == 18
    x, A, B, dy, scale, rows, ranks = args
    s_rl, s_rg, s_gl = outs[0], outs[6], outs[12]
    for z in range(Z):
        assert not s_rl[z, rows[z]:].any() and not s_rl[z, :, ranks[z]:].any()
        assert not s_rg[z, rows[z]:].any()
    assert torch.equal(s_gl, GL.xa(x, A))
    assert torch.equal(s_rg, RG.xa(x, A, rows))
    for p in AT.PLAN_SET:
        got = AT.six_kernel_step(p)(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, outs))


# ---------------------------------------------------------------------------
# plan= through the three Functions
# ---------------------------------------------------------------------------

def _grads(fn, x, A, B, dy):
    xs, As, Bs = (t.clone().requires_grad_(True) for t in (x, A, B))
    y = fn(xs, As, Bs)
    y.backward(dy)
    return [y.detach(), xs.grad, As.grad, Bs.grad]


@pytest.mark.parametrize("plan", [None] + list(AT.PLAN_SET),
                         ids=lambda p: "default" if p is None
                         else f"{p.bm}x{p.bn}x{p.br}")
def test_plan_threads_through_the_three_functions(plan, monkeypatch):
    x, A, B, dy, scale, ranks, rows = (torch.from_numpy(a)
                                       for a in _operands())
    seen = []
    for mod in (GL, RG, RL):
        for name in ("xa", "sb_add", "ds", "dx", "da", "db"):
            real = getattr(mod, name)

            def spy(*a, _real=real, _name=f"{mod.__name__}.{name}", **kw):
                seen.append((_name, kw.get("plan")))
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, spy)
    fns = {"dense": lambda a, b, c, p: ops.grouped_lora(a, b, c, scale,
                                                        plan=p),
           "ragged": lambda a, b, c, p: ops.ragged_grouped_lora(
               a, b, c, scale, rows, plan=p),
           "rank-local": lambda a, b, c, p: ops.ranklocal_grouped_lora(
               a, b, c, scale, ranks, rows, plan=p)}
    for fam, fn in fns.items():
        seen.clear()
        got = _grads(lambda a, b, c: fn(a, b, c, plan), x, A, B, dy)
        default = _grads(lambda a, b, c: fn(a, b, c, None), x, A, B, dy)
        assert all(torch.equal(u, v) for u, v in zip(got, default)), fam
        # forward and backward launches all took the plan
        names = {n.rsplit(".", 1)[1] for n, _ in seen}
        assert names == {"xa", "sb_add", "ds", "dx", "da", "db"}, fam
        assert all(p == plan for _, p in seen[:len(seen) // 2]), fam
    # the rank-local Function under the plan against the JAX one
    y_j = JOPS.ranklocal_grouped_lora(
        jnp.asarray(x.numpy()), jnp.asarray(A.numpy()),
        jnp.asarray(B.numpy()), jnp.asarray(scale.numpy()),
        jnp.asarray(ranks.numpy()), jnp.asarray(rows.numpy()),
        interpret=True)
    y_t = ops.ranklocal_grouped_lora(x, A, B, scale, ranks, rows, plan=plan)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=RTOL,
                               atol=ATOL)

    def jloss(x_, A_, B_):
        y = JOPS.ranklocal_grouped_lora(
            x_, A_, B_, jnp.asarray(scale.numpy()),
            jnp.asarray(ranks.numpy()), jnp.asarray(rows.numpy()),
            interpret=True)
        return jnp.sum(y * jnp.asarray(dy.numpy()))

    gj = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x.numpy()), jnp.asarray(A.numpy()),
        jnp.asarray(B.numpy()))
    gt = _grads(lambda a, b, c: ops.ranklocal_grouped_lora(
        a, b, c, scale, ranks, rows, plan=plan), x, A, B, dy)[1:]
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)


def test_fp32_plans_are_card_only_refusals():
    """The plain versions take any legal plan in fp32 (and ignore it); the
    card's fp32 kernels have one tile each and refuse one — the wrapper
    check that raises is ``ranklocal._plan``, read here on a CPU tensor:
    it validates and passes the index through."""
    x = torch.zeros((Z, T, DIN))
    assert RL._plan(AT.PLAN_SET[2], x, T, Z) == 2
    assert RL._plan(None, x, T, Z) == -1


@pytest.mark.parametrize("din,dout", STABLELM)
def test_stablelm_keys_have_every_plan_as_a_candidate(din, dout):
    for tokens in (1024, 4):
        plans = AT.candidate_plans(tokens, din, dout, 64, Z=4)
        assert plans == [AT.DEFAULT_PLAN] + list(AT.PLAN_SET)
