"""PyTorch port: the serving tier (AdapterPool -> ServingReplica ->
ServingFrontend) held against the JAX package, and its bitwise contracts
proved again inside the port.

Both packages get the same backbone weights and adapters (initialized by the
JAX package, carried over by ``repro_torch.bridge``) and the same prompts
(numpy seed), on a float32 ``reduced("paper-llama-tiny")``. Greedy token
streams must be identical across packages; inside the port, continuous
batching equals the round baseline, fused per-slot logits equal solo ones
bitwise, and mid-decode joins leave resident lanes bitwise unchanged.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import load_pytree as jload_pytree
from repro.checkpoint.checkpoint import save_pytree as jsave_pytree
from repro.core import lora as JLORA
from repro.models import model as JM
from repro.serve import AdapterPool as JPool
from repro.serve import ServingFrontend as JFrontend
from repro.serve import ServingReplica as JReplica
from repro_torch import bridge
from repro_torch.checkpoint.checkpoint import save_pytree as tsave_pytree
from repro_torch.configs.registry import get_arch as tget_arch
from repro_torch.serve import (SPEC_VERSION, AdapterPool, PoolFull,
                               ServeRequest, ServingFrontend, ServingReplica)
from tests.conftest import reduced_f32

RANKS = [4, 8, 2]
LANES, MAX_LEN, MAX_NEW = 2, 24, 6


@pytest.fixture(scope="module")
def env():
    kw = dict(num_layers=2, d_model=64, vocab=128)
    jcfg = reduced_f32("paper-llama-tiny", **kw)
    tcfg = dataclasses.replace(tget_arch("paper-llama-tiny").reduced(**kw),
                               dtype="float32")
    key = jax.random.PRNGKey(0)
    jparams = jax.jit(lambda k: JM.init_params(k, jcfg))(key)
    ranks = jnp.asarray(RANKS, jnp.int32)

    @jax.jit
    def init_stack(k):
        lt = JLORA.init_lora_tree(k, jcfg, 3, ranks, JM.target_shapes(jcfg))
        lt = jax.tree_util.tree_map(   # nonzero B: every delta is live
            lambda x: x + 0.05 * jax.random.normal(k, x.shape), lt)
        return JLORA.mask_lora_tree(lt, ranks, jcfg.lora.r_max)

    stack = init_stack(key)
    adapters = {z: jax.tree_util.tree_map(lambda x: np.asarray(x[:, z]),
                                          stack) for z in range(3)}
    tparams = bridge.params_from_numpy(
        tcfg, jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(11)
    prompts = {z: [rng.integers(0, 128, size=int(rng.integers(3, 9)))
                   .astype(np.int32) for _ in range(3)] for z in range(3)}
    return jcfg, tcfg, jparams, tparams, adapters, prompts


def _port_pool(tcfg, adapters, publish=(0, 1, 2)):
    pool = AdapterPool(tcfg, 3, device="cpu")
    for z in publish:
        pool.publish(f"a{z}", adapters[z], RANKS[z], slot=z)
    return pool


def _drain(frontend, prompts):
    for z in range(3):
        for p in prompts[z]:
            frontend.submit(f"a{z}", p, MAX_NEW)
    return frontend.drain()


@pytest.mark.parametrize("mode", ["continuous", "round"])
def test_frontend_drain_greedy_streams_match_jax(env, mode):
    """Three requests per adapter over two lanes (lane reuse, ragged
    prompts): every greedy stream equals the JAX package's."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = env
    jpool = JPool(jcfg, 3)
    for z in range(3):
        jpool.publish(f"a{z}", adapters[z], RANKS[z], slot=z)
    jout = _drain(JFrontend(JReplica(jcfg, jparams, jpool, lanes=LANES,
                                     max_len=MAX_LEN), mode=mode), prompts)
    rep = ServingReplica(tcfg, tparams, _port_pool(tcfg, adapters),
                         lanes=LANES, max_len=MAX_LEN, device="cpu")
    tout = _drain(ServingFrontend(rep, mode=mode), prompts)
    assert len(tout) == 9 and all(len(v) == MAX_NEW for v in tout.values())
    assert tout == jout


def test_continuous_equals_round_inside_the_port(env):
    jcfg, tcfg, jparams, tparams, adapters, prompts = env
    outs = {}
    for mode in ("continuous", "round"):
        rep = ServingReplica(tcfg, tparams, _port_pool(tcfg, adapters),
                             lanes=LANES, max_len=MAX_LEN, device="cpu")
        outs[mode] = _drain(ServingFrontend(rep, mode=mode), prompts)
    assert outs["continuous"] == outs["round"]


def _round(tcfg, tparams, adapters, prompts, publish):
    rep = ServingReplica(tcfg, tparams, _port_pool(tcfg, adapters, publish),
                         lanes=LANES, max_len=MAX_LEN, device="cpu")
    # equal-length prompts: a round lasts as long as its longest stream
    reqs = [ServeRequest(f"r{z}{i}", f"a{z}", prompts[z][i][:3], MAX_NEW)
            for z in publish for i in range(2)]
    stats = rep.serve_round(reqs, record_logits=True)
    return {r.request_id: tuple(r.tokens) for r in reqs}, stats.logits


def test_fused_decode_bitwise_equal_solo_in_port(env):
    """N adapters fused on one replica give every request decode logits
    bitwise identical to serving its adapter alone."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = env
    fused_toks, fused_log = _round(tcfg, tparams, adapters, prompts,
                                   [0, 1, 2])
    for z in range(3):
        solo_toks, solo_log = _round(tcfg, tparams, adapters, prompts, [z])
        for i in range(2):
            assert fused_toks[f"r{z}{i}"] == solo_toks[f"r{z}{i}"]
        assert len(fused_log) == len(solo_log)
        for (tf, lf), (ts, ls) in zip(fused_log, solo_log):
            assert tf == ts
            np.testing.assert_array_equal(lf[z], ls[z])        # bitwise


@pytest.mark.parametrize("ring", [False, True])
def test_mid_decode_join_leaves_resident_bitwise_unchanged(env, ring):
    """Requests joining free lanes mid-decode (block prefill, or a ring
    lane reset streamed through decode) never move a resident lane's
    logits or tokens by a bit."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = env

    def run(join):
        rep = ServingReplica(tcfg, tparams, _port_pool(tcfg, adapters),
                             lanes=LANES, max_len=MAX_LEN, ring=ring,
                             device="cpu")
        resident = ServeRequest("res", "a0", prompts[0][0], 10)
        assert rep.try_join(resident)
        for step in range(24):
            if join and step == 4:
                for z, i in ((0, 1), (1, 0), (2, 1)):
                    assert rep.try_join(ServeRequest(
                        f"j{z}{i}", f"a{z}", prompts[z][i], 6))
            rep.step_continuous(record_logits=True)
            if resident.done:
                break
        assert resident.done
        return (tuple(resident.tokens),
                [(t, lg[0, 0]) for t, lg in rep.step_logits])

    toks_solo, log_solo = run(join=False)
    toks_join, log_join = run(join=True)
    assert toks_solo == toks_join
    assert len(log_solo) == len(log_join)
    for (ts, ls), (tj, lj) in zip(log_solo, log_join):
        assert ts == tj
        np.testing.assert_array_equal(ls, lj)                  # bitwise


def test_pool_publish_retire_and_checkpoints_cross_packages(env, tmp_path):
    """Pool slot bookkeeping, and adapters checkpointed by either package
    publish into the other's pool bitwise."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = env
    pool = AdapterPool(tcfg, 2, device="cpu")
    pool.publish("a0", adapters[0], RANKS[0])
    pool.publish_many([("a1", adapters[1], RANKS[1])])
    assert pool.slot_rank == [4, 8] and pool.ranks.tolist() == [4, 8]
    with pytest.raises(PoolFull):
        pool.publish("a2", adapters[2], RANKS[2])
    pool.retire("a0")
    assert all(float(np.abs(ab[m]).max()) == 0.0
               for ab in pool.adapter_at(0).values() for m in ("A", "B"))
    # a JAX-saved adapter publishes into the port's pool bitwise
    path = str(tmp_path / "jax_adapter.npz")
    jsave_pytree(path, adapters[2], meta={"adapter_id": "ck", "rank": 2,
                                          "arch": tcfg.name,
                                          "spec_version": SPEC_VERSION})
    aid, slot = pool.publish_checkpoint(path)
    assert (aid, slot) == ("ck", 0)
    got = pool.adapter_at(0)
    for t, ab in adapters[2].items():
        for m in ("A", "B"):
            np.testing.assert_array_equal(got[t][m], ab[m])
    # and a port-saved one loads in the JAX package bitwise
    path2 = str(tmp_path / "port_adapter.npz")
    port_tree = {t: {m: torch.from_numpy(np.array(v)) for m, v in ab.items()}
                 for t, ab in adapters[1].items()}
    tsave_pytree(path2, port_tree, meta={"rank": 8})
    like = jax.tree_util.tree_map(jnp.zeros_like, adapters[1])
    back, meta = jload_pytree(path2, like)
    assert meta == {"rank": 8}
    for t, ab in adapters[1].items():
        for m in ("A", "B"):
            np.testing.assert_array_equal(np.asarray(back[t][m]), ab[m])


def test_sampled_requests_are_deterministic(env):
    """temperature > 0 draws from per-(seed, request, token) generators:
    the same seeds give the same tokens, within the vocabulary."""
    jcfg, tcfg, jparams, tparams, adapters, prompts = env

    def run():
        rep = ServingReplica(tcfg, tparams, _port_pool(tcfg, adapters),
                             lanes=LANES, max_len=MAX_LEN, sample_seed=3,
                             device="cpu")
        fe = ServingFrontend(rep)
        rids = [fe.submit(f"a{z}", prompts[z][0], MAX_NEW, temperature=0.8,
                          top_k=20, seed=z) for z in range(3)]
        out = fe.drain()
        return [out[r] for r in rids]

    a, b = run(), run()
    assert a == b
    assert all(0 <= t < tcfg.vocab_size for s in a for t in s)


def test_frontend_admission_against_the_memory_model(env):
    """Round-mode publish admission bills TRUE ranks over lanes x max_len
    (a publish over budget is refused before the pool changes; retiring
    frees its charge); continuous mode defers a join that does not fit
    until in-flight requests release their charge."""
    from repro_torch.sched.intra_task import MemoryModel
    from repro_torch.serve import AdmissionError

    jcfg, tcfg, jparams, tparams, adapters, prompts = env
    pool = AdapterPool(tcfg, 3, device="cpu")
    rep = ServingReplica(tcfg, tparams, pool, lanes=2, max_len=16,
                         device="cpu")
    lane_toks = 2 * 16
    cap = (2 * lane_toks * 1.0 + (4 + 8) * lane_toks * 0.5) / 0.9 + 1.0
    mem = MemoryModel(k0=0.0, k1=1.0, seq_len=16, capacity=cap, k2=0.5,
                      r_max=tcfg.lora.r_max)
    fe = ServingFrontend(rep, mem=mem, mode="round")
    fe.publish("a0", adapters[0], 4)
    fe.publish("a1", adapters[1], 8)
    with pytest.raises(AdmissionError):
        fe.publish("a2", adapters[2], 2)
    assert "a2" not in pool.resident()
    fe.retire("a1")
    fe.publish("a2", adapters[2], 2)
    assert set(pool.resident()) == {"a0", "a2"}

    # continuous: room for one request's footprint at a time
    pool = _port_pool(tcfg, adapters)
    rep = ServingReplica(tcfg, tparams, pool, lanes=LANES, max_len=MAX_LEN,
                         device="cpu")
    one = (3 + MAX_NEW) * (1.0 + 0.5 * 8)
    mem = MemoryModel(k0=0.0, k1=1.0, seq_len=MAX_LEN,
                      capacity=1.5 * one / 0.9, k2=0.5,
                      r_max=tcfg.lora.r_max)
    fe = ServingFrontend(rep, mem=mem)
    rids = [fe.submit("a1", prompts[1][i][:3], MAX_NEW) for i in range(2)]
    out = fe.drain()
    assert fe.deferred_joins > 0
    assert all(len(out[r]) == MAX_NEW for r in rids)
