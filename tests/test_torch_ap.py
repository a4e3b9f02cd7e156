"""PyTorch port: Adapter Parallelism on a real multi-rank mesh — the
launcher's sharded train step over ("data", "model") ranks, held against
the JAX package's GSPMD step on 4 forced CPU devices.

The shared setting is ``examples/adapter_parallel.py``'s: reduced
paper-llama-tiny (2 layers, d 128, 4 heads, vocab 512) in fp32, Z 4, b 4,
S 32, ranks [8, 8, 4, 4], 3 steps, the reference's init (this process)
handed to both sides through ``init.npz``. The reference runs in a
subprocess with ``--xla_force_host_platform_device_count=4``
(``tests/_ap_reference.py``; this worker's JAX is already initialised with
one device), the port as 4 gloo processes on the CPU
(``tests/_ap_worker.py``), and the launcher's CLI as 4 more; all start
together in one module fixture.

(a) The 2x2 and 4x1 sharded steps against the reference's on the same mesh:
    per-slot losses of every step within 1e-5 relative; every updated
    adapter leaf within rtol 1e-5 / atol 1e-6 but for a few entries a leaf
    (``ADAM_SHARE``), each within 2 lr a step of the reference's. Why sum
    order needs that: AdamW's step m / (sqrt(v) + eps) is about lr times
    the sign of a gradient entry near zero, so a last-bit difference in
    such an entry moves the updated entry by up to 2 lr a step. The
    reference differs from itself the same way between its 1x1 and 2x2
    meshes (asserted here).
(b) The AP invariant, from the collective log of every rank: the data axis
    carries only "base_weight" all-gathers and the one [Z] "metric"
    gather; no "adapter_grad" collective and no collective whose last dim
    is r_max crosses it; the model axis all-reduces the adapter gradients
    (2x2), and a 1-wide model axis carries nothing (4x1).
(c) The example's lrs [3e-3, 1e-3, 1e-2, 300] with no clipping, 6 steps
    (the batches cycled): slot 3 diverges, and slots 0-2 are bit for bit
    those of a run whose slot 3 has lr 3e-3 — slot isolation across and
    within ranks.
(d) Opt levels 0 and 2 agree within rtol 2e-4 on the 2x2 mesh (one
    schedule: they are in fact equal); the one-rank step (this process, a
    one-rank gloo group) agrees with the 2x2 and 4x1 steps within (a)'s
    bars.
(e) What was refused here runs now: ragged slot rows over a split model
    axis, scan heads that do not divide by m and MoE token groups that
    divide neither way are held against the reference in
    ``tests/test_torch_ap_uneven.py`` (every family's train, eval, prefill
    and serve steps run: ``tests/test_torch_ap_moe.py``,
    ``tests/test_torch_ap_ssm.py``, ``tests/test_torch_ap_modal.py``, and
    on a ("pod", "data", "model") mesh ``tests/test_torch_ap_pod.py`` and
    ``tests/test_torch_ap_pod_families.py``, which hold what a pod mesh
    refuses); so does the eval step, whose per-slot losses after the 2x2
    and 4x1 runs are held within 1e-5 relative of the reference's
    ``make_eval_step`` on the same mesh.
(f) ``launch.train.main(["--reduced", "--mesh", "2x2", "--steps", "2",
    "--backend", "gloo", "--device", "cpu"])`` runs under 4 spawned
    processes.
(g) The dry run's data-axis weight gathers for the same config and 2x2
    mesh (``launch/dryrun.py`` on a fake 4-rank group) equal, byte for
    byte, what the 2x2 step logged per step.
(h) The DPO loss (``common.dpo_batch``'s pairs, lr ``common.DPO_LR``): 2
    sharded DPO steps and the DPO eval step on 2x2 and 4x1 against the
    reference's GSPMD DPO steps on the same mesh, the losses within
    ``DPO_LOSS`` (the reference's own meshes differ by more than ``LOSS``:
    asserted within ``DPO_LOSS``) and the adapters within (a)'s bars;
    ``chip_smoke.py``'s planted fault "dpo_swap" breaks only data rank 1's
    slots.
(i) The prefill step (a cache of S + 8 rows laid out by
    ``serve_cache_specs``, the K/V by KV heads as the reference's
    ``cache_specs``) and 8 greedy serve steps on 2x2 and 4x1 with
    ``common.serve_lora``'s adapters against the reference's: every step's
    logits and the prefilled cache within 1e-5 relative to their scale,
    the greedy stream equal to the reference's and to the port's one-rank
    run's; a per-lane cache on 2x2 whose step with ``common.IDLE_LANES``
    idle leaves their K/V rows and positions bitwise untouched on every
    rank, its live lanes as the one-rank run's; the planted fault "kv_roll"
    breaks only data rank 0's slots. The other families' DPO and serving
    runs (``common.DPO_RUNS``, ``common.SERVE_RUNS``) are held in their own
    files through ``family_dpo_held``, ``_serve_held`` and ``lanes_held``.
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
from repro_torch import bridge
from repro_torch.configs.base import KIND_TRAIN, ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as TMESH
from repro_torch.launch import steps_dist as TSD
from repro_torch.optim import adamw as TAD
from tests import _ap_common as common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS = dict(rtol=1e-5, atol=0.0)
LEAF = dict(rtol=1e-5, atol=1e-6)
# the DPO losses: the margin is beta times a difference of per-slot sums
# of log-probabilities (about -800 for the dense example's 128 tokens a
# slot), so fp32 sum order moves a loss by more than LOSS allows: the
# reference's own 2x2 and 4x1 DPO steps differ by up to 4.1e-5 relative
# (asserted within this bar)
DPO_LOSS = dict(rtol=1e-4, atol=0.0)
ADAM_SHARE = 0.002          # entries of a leaf allowed past LEAF
ADAM_BOUND = 2 * common.LR * common.STEPS
TIMEOUT = 600


def _env(**kw):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    env.update(kw)
    return env


def _ranks(cmd, n, port, log_dir, tag):
    """``n`` processes of ``cmd``, torchrun-style, output to files."""
    procs = []
    for r in range(n):
        out = open(os.path.join(log_dir, f"{tag}{r}.log"), "w")
        procs.append((subprocess.Popen(
            cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT,
            env=_env(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))), out))
    return procs


def _init(work):
    jcfg = common.jax_config()
    key = jax.random.PRNGKey(0)
    params = JM.init_params(key, jcfg)
    ranks = jnp.asarray(common.RANKS)
    lora = JLORA.init_lora_tree(key, jcfg, common.Z, ranks,
                                JM.target_shapes(jcfg))
    ds = make_task_dataset("ap-demo", jcfg.vocab_size, seq_len=common.S,
                           num_train=64, difficulty=0.25)
    batcher = SlotBatcher(ds, common.Z, common.B)
    toks, labs = zip(*(batcher.next_batch() for _ in range(common.STEPS)))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    np.savez(os.path.join(work, "init.npz"),
             **common.flat(np_(params), "params/"),
             **common.flat(np_(lora), "lora/"),
             tokens=np.stack(toks), labels=np.stack(labs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("ap"))
    _init(work)
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_ap_reference.py"),
         work], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    workers = _ranks([sys.executable, os.path.join(ROOT, "tests",
                                                   "_ap_worker.py"), work],
                     4, TMESH.free_port(), work, "worker")
    cli = _ranks([sys.executable, "-m", "repro_torch.launch.train",
                  "--reduced", "--mesh", "2x2", "--steps", "2", "--backend",
                  "gloo", "--device", "cpu"], 4, TMESH.free_port(), work,
                 "cli")
    jax_out = jax_proc.communicate(timeout=TIMEOUT)[0]
    codes = {}
    for tag, procs in (("worker", workers), ("cli", cli)):
        for r, (p, f) in enumerate(procs):
            codes[f"{tag}{r}"] = p.wait(timeout=TIMEOUT)
            f.close()

    def text(name):
        with open(os.path.join(work, f"{name}.log")) as f:
            return f.read()

    assert jax_proc.returncode == 0, jax_out
    for name, rc in codes.items():
        if name.startswith("worker"):
            assert rc == 0, text(name)
    return {"dir": work, "codes": codes, "text": text}


def _load(runs, name):
    return dict(np.load(os.path.join(runs["dir"], name)))


def _leaves(d):
    return sorted(k for k in d if k.startswith("lora/"))


def _adapters_close(got, want, what, share=ADAM_SHARE):
    """(a)'s bar on every adapter leaf, with at most ``share`` of a leaf's
    entries past LEAF; returns the largest share of entries past LEAF."""
    worst = 0.0
    assert _leaves(got) == _leaves(want)
    for k in _leaves(want):
        a, b = got[k], want[k]
        assert a.shape == b.shape, (what, k)
        past = np.abs(a - b) > LEAF["atol"] + LEAF["rtol"] * np.abs(b)
        worst = max(worst, past.mean())
        assert past.mean() <= share, (what, k, past.mean())
        np.testing.assert_allclose(a, b, rtol=0, atol=ADAM_BOUND,
                                   err_msg=f"{what} {k}")
    return worst


# ---------------------------------------------------------------------------
# (a) against the reference's GSPMD step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_step_matches_the_reference(runs, mesh):
    got = _load(runs, f"port_{mesh}.npz")
    want = _load(runs, f"jax_{mesh}.npz")
    assert got["losses"].shape == (common.STEPS, common.Z)
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    _adapters_close(got, want, f"port {mesh} vs reference {mesh}")


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_eval_matches_the_reference(runs, mesh):
    got = _load(runs, f"port_{mesh}.npz")["eval"]
    want = _load(runs, f"jax_{mesh}.npz")["eval"]
    assert got.shape == (common.Z,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **LOSS)


def test_the_reference_moves_with_its_own_sum_order(runs):
    """The reference's 2x2 mesh against its 1x1: the same kind of
    differences as (a)'s, within the same bars."""
    one, four = _load(runs, "jax_1x1.npz"), _load(runs, "jax_2x2.npz")
    np.testing.assert_allclose(four["losses"], one["losses"], **LOSS)
    _adapters_close(four, one, "reference 2x2 vs 1x1")


# ---------------------------------------------------------------------------
# (b) the AP invariant from the collective log
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_no_adapter_collective_crosses_the_data_axis(runs, mesh):
    r_max = common.port_config().lora.r_max
    d, m = (int(x) for x in mesh.split("x"))
    for r in range(4):
        with open(os.path.join(runs["dir"], f"log_{mesh}_rank{r}.json")) as f:
            log = json.load(f)
        data = [c for c in log if c["axis"] == "data"]
        model = [c for c in log if c["axis"] == "model"]
        assert {c["role"] for c in data} == {"base_weight", "metric"}
        assert all(c["kind"] == "all-gather" for c in data)
        metric = [c for c in data if c["role"] == "metric"]
        assert len(metric) == common.STEPS
        assert all(c["shape"][0] == common.Z for c in metric)
        assert not any(c["shape"][-1] == r_max for c in data)
        if m == 1:
            assert not model
            continue
        grads = [c for c in model if c["role"] == "adapter_grad"]
        assert grads and all(c["kind"] == "all-reduce" for c in grads)
        assert len(grads) == common.STEPS * 14      # 7 targets x (A, B)
        assert {c["role"] for c in model} == {"activation", "adapter_grad"}


# ---------------------------------------------------------------------------
# (c) slot isolation
# ---------------------------------------------------------------------------

def test_a_diverging_slot_leaves_the_others_bitwise(runs):
    div = _load(runs, "port_2x2_div.npz")
    ctl = _load(runs, "port_2x2_div_ctl.npz")
    last = div["losses"][-1]
    # the example's reading: slot 3 no longer learns while slot 0 does,
    # and its adapters blow up (AdamW at lr 300 with decay 0.01 doubles
    # them each step)
    assert not np.isfinite(last[3]) or last[3] > last[0], div["losses"]
    big = np.abs(div["lora/q_proj/B"][:, 3]).max()
    assert big > 1e4 * np.abs(div["lora/q_proj/B"][:, :3]).max(), big
    assert np.array_equal(div["losses"][:, :3], ctl["losses"][:, :3])
    for k in _leaves(ctl):
        assert np.array_equal(div[k][:, :3], ctl[k][:, :3]), k
        assert not np.array_equal(div[k][:, 3], ctl[k][:, 3]), k


# ---------------------------------------------------------------------------
# (d) opt levels, and one rank against many
# ---------------------------------------------------------------------------

def _one_rank(init, tmp_path, cfg=None):
    """The port's steps on a one-rank mesh (this process), then its eval
    step on the first batch ("eval")."""
    cfg = cfg or common.port_config()
    with TMESH.process_group("cpu", f"file://{tmp_path / 'pg'}"):
        mesh = TMESH.make_local_mesh((1, 1), device="cpu")
        params = bridge.params_from_numpy(cfg, common.unflat(init,
                                                             "params/"),
                                          "cpu")
        lora = bridge.lora_from_numpy(common.unflat(init, "lora/"), "cpu")
        opt = TAD.init_state(lora, common.Z)
        hp = TAD.SlotHParams.broadcast(common.Z, lr=common.LR)
        ranks = torch.tensor(common.RANKS, dtype=torch.int32)
        active = torch.ones((common.Z,), dtype=torch.int32)
        step = TSD.make_train_step(cfg, mesh)
        losses = []
        for t in range(common.STEPS):
            lora, opt, m = step(params, lora, opt, hp, active, ranks,
                                common.port_batch(init, t))
            losses.append(m["per_slot_loss"].numpy())
        evals = TSD.make_eval_step(cfg, mesh)(params, lora, active,
                                              common.port_batch(init, 0))
    out = {"losses": np.stack(losses), "eval": evals.numpy()}
    out.update({f"lora/{t}/{k}": v.numpy() for t, ab in lora.items()
                for k, v in ab.items()})
    return out


def test_opt_levels_and_one_rank_agree(runs, tmp_path):
    base, opt2 = _load(runs, "port_2x2.npz"), _load(runs, "port_2x2_opt2.npz")
    np.testing.assert_allclose(opt2["losses"], base["losses"], rtol=2e-4)
    for k in _leaves(base):
        np.testing.assert_allclose(opt2[k], base[k], rtol=2e-4, atol=1e-7)
    one = _one_rank(_load(runs, "init.npz"), tmp_path)
    np.testing.assert_allclose(base["losses"], one["losses"], **LOSS)
    _adapters_close(base, one, "port 2x2 vs port 1x1")
    four = _load(runs, "port_4x1.npz")
    np.testing.assert_allclose(four["losses"], one["losses"], **LOSS)
    _adapters_close(four, one, "port 4x1 vs port 1x1")


# ---------------------------------------------------------------------------
# (f) the launcher's CLI over 4 ranks
# ---------------------------------------------------------------------------

def test_the_launcher_runs_on_four_ranks(runs):
    for r in range(4):
        text = runs["text"](f"cli{r}")
        assert runs["codes"][f"cli{r}"] == 0, text
        assert "mesh={'data': 2, 'model': 2} devices=4" in text
        lines = [ln for ln in text.splitlines() if ln.startswith("step")]
        assert len(lines) == 2, text
        losses = [float(v) for v in
                  lines[-1].split("[")[1].rstrip("]").split(",")]
        assert len(losses) == 4 and all(np.isfinite(losses))
        assert text.rstrip().endswith("done")


# ---------------------------------------------------------------------------
# (g) the dry run's data-axis gathers against the logged ones
# ---------------------------------------------------------------------------

def test_dryrun_data_gathers_equal_the_logged_bytes(runs):
    cfg = common.port_config()
    shape = ShapeConfig("ap_train", common.S, common.Z * common.B,
                        KIND_TRAIN, num_slots=common.Z,
                        per_adapter_batch=common.B)
    with TMESH.fake_group(4):
        mesh = TMESH.DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                                mesh_dim_names=("data", "model"))
        low = DR.lower_step(cfg, shape, mesh)
    want = sum(op.result_bytes * op.trip_count for op in low.collectives
               if op.line.startswith("data: weight"))
    for r in range(4):
        with open(os.path.join(runs["dir"], f"log_2x2_rank{r}.json")) as f:
            log = json.load(f)
        got = sum(c["bytes"] for c in log
                  if c["axis"] == "data" and c["role"] == "base_weight")
        assert got == want * common.STEPS, (got / common.STEPS, want)
    assert want > 0


# ---------------------------------------------------------------------------
# (h) the DPO loss against the reference's GSPMD DPO step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_dpo_matches_the_reference(runs, mesh):
    got = _load(runs, f"port_dpo_{mesh}.npz")
    want = _load(runs, f"jax_dpo_{mesh}.npz")
    assert got["losses"].shape == (common.DPO_STEPS, common.Z)
    # the first step reads log 2 exactly: B is 0, the policy is the base
    np.testing.assert_array_equal(got["losses"][0], want["losses"][0])
    np.testing.assert_allclose(got["losses"], want["losses"], **DPO_LOSS)
    _adapters_close(got, want, f"port DPO {mesh} vs reference {mesh}")


def test_the_reference_dpo_moves_with_its_own_sum_order(runs):
    """The reference's 2x2 DPO step against its 4x1: past LOSS, within
    DPO_LOSS and (a)'s adapter bars."""
    two, four = _load(runs, "jax_dpo_2x2.npz"), _load(runs, "jax_dpo_4x1.npz")
    for key in ("losses", "eval"):
        spread = np.abs(two[key] - four[key]) / np.abs(four[key])
        print(f"reference DPO {key}, 2x2 vs 4x1: {spread.max():.3e}")
        np.testing.assert_allclose(two[key], four[key], **DPO_LOSS)
    _adapters_close(two, four, "reference DPO 2x2 vs 4x1")


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_sharded_dpo_eval_matches_the_reference(runs, mesh):
    got = _load(runs, f"port_dpo_{mesh}.npz")["eval"]
    want = _load(runs, f"jax_dpo_{mesh}.npz")["eval"]
    assert got.shape == (common.Z,) and np.isfinite(got).all()
    # the trained adapters move the policy off the reference: log 2 no more
    assert (np.abs(want - np.log(2.0)) > 1e-4).all(), want
    np.testing.assert_allclose(got, want, **DPO_LOSS)


def test_a_planted_dpo_fault_breaks_parity_on_its_slots(runs):
    """``chip_smoke._planted_serve(("dpo_swap",))``: data rank 1's policy
    forwards swap the pairs; its slots' losses (from the first step on)
    and eval break, data rank 0's stay within the bars."""
    bad = _load(runs, "port_dpo_2x2_dpo_swap.npz")
    want = _load(runs, "jax_dpo_2x2.npz")
    hit = list(common.SERVE_FAULTS["dpo_swap"])
    kept = [z for z in range(common.Z) if z not in hit]
    for key in ("losses", "eval"):
        np.testing.assert_allclose(bad[key][..., kept], want[key][..., kept],
                                   **DPO_LOSS)
        off = np.abs(bad[key][..., hit] - want[key][..., hit])
        assert (off > 1e-3 * np.abs(want[key][..., hit])).all(), (key, off)


# ---------------------------------------------------------------------------
# (i) the prefill and serve steps against the reference's
# ---------------------------------------------------------------------------

def close_logits(got, want, what):
    """Logits (or cache rows) within 1e-5 relative of ``want``'s scale:
    |got - want| <= 1e-5 |want| + 1e-5 max|want|."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


def one_rank_serve(init, tmp_path, cfg, **kw):
    """The port's prefill and greedy serve steps on a one-rank mesh (this
    process, a one-rank gloo group): ``chip_smoke.ap_serve`` with
    ``serve_lora``'s adapters, as the sharded runs take them."""
    import chip_smoke
    with TMESH.process_group("cpu", f"file://{tmp_path / 'pg'}"):
        mesh = TMESH.make_local_mesh((1, 1), device="cpu")
        params = bridge.params_from_numpy(cfg, common.unflat(init,
                                                             "params/"),
                                          "cpu")
        lora = bridge.lora_from_numpy(common.serve_lora(init), "cpu")
        batch = {k: torch.from_numpy(v)
                 for k, v in common.serve_batch(init).items()}
        res = chip_smoke.ap_serve(torch, cfg, mesh, params, lora, batch,
                                  None, common.SERVE_DECODES, **kw)
    return {k: (v.float().numpy() if torch.is_tensor(v) else v)
            for k, v in res.items()}


@pytest.fixture(scope="module")
def one_serve(runs, tmp_path_factory):
    """The dense example's one-rank serving runs: a global position, and
    per lane with ``common.IDLE_LANES`` idle in one more step."""
    init = _load(runs, "init.npz")
    return {"global": one_rank_serve(init, tmp_path_factory.mktemp("sg"),
                                     common.port_config()),
            "lanes": one_rank_serve(init, tmp_path_factory.mktemp("sl"),
                                    common.port_config(), per_lane=True,
                                    idle=common.IDLE_LANES)}


def _serve_held(got, want, one, what):
    """(i)'s bars: every step's logits and every leaf of the prefilled
    cache against the reference's, and the greedy stream equal to the
    reference's and to the port's one-rank run."""
    assert got["logits"].shape == want["logits"].shape, what
    assert np.isfinite(got["logits"]).all(), what
    close_logits(got["logits"], want["logits"], f"{what} logits")
    leaves = sorted(k for k in want if k.startswith("cache/"))
    assert leaves and leaves == sorted(k for k in got
                                       if k.startswith("cache/")), what
    for key in leaves:
        close_logits(got[key], want[key], f"{what} {key}")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["tokens"], one["tokens"])


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1)], ids=["2x2", "4x1"])
def test_sharded_serve_matches_the_reference(runs, one_serve, mesh):
    tag = "%dx%d" % mesh
    _serve_held(common.served(runs["dir"], f"serve_{tag}", mesh),
                _load(runs, f"jax_serve_{tag}.npz"), one_serve["global"],
                f"serve {tag}")


def lanes_held(got, one, what):
    """A per-lane cache's idle step (``common.IDLE_LANES``): on every rank
    the idle lanes' entries of every local cache leaf and their positions
    stay bitwise untouched and the live lanes' change; every step's logits
    of every lane, and the idle step's of the live lanes, match the port's
    one-rank run (``one``)."""
    for r, part in enumerate(got["ranks"]):
        assert int(part["idle_changed"]) == 0, (what, r)
        assert int(part["live_changed"]) > 0, (what, r)
    close_logits(got["logits"], one["logits"], f"{what} per-lane logits")
    np.testing.assert_array_equal(got["tokens"], one["tokens"])
    live = np.ones(got["idle_logits"].shape[:2], bool)
    for z, lane in common.IDLE_LANES:
        live[z, lane] = False
    close_logits(got["idle_logits"][live], one["idle_logits"][live],
                 f"{what}: the idle step's live lanes")


def test_idle_lanes_stay_bitwise_on_every_rank(runs, one_serve):
    """A per-lane cache on 2x2: after the prefill and the greedy steps of
    every lane, a serve step with ``common.IDLE_LANES`` idle (one on each
    data rank) leaves their local K/V rows and positions bitwise untouched
    on every rank and writes the live ones; every step's logits of every
    lane, and the idle step's of the live lanes, match the port's
    one-rank run."""
    lanes_held(common.served(runs["dir"], "lanes_2x2", (2, 2)),
               one_serve["lanes"], "dense 2x2")


def test_a_planted_cache_fault_breaks_parity_on_its_slots(runs):
    """``chip_smoke._planted_serve(("kv_roll",))``: on data rank 0 the last
    model rank writes its KV heads rolled; data rank 0's slots' logits
    break from the prefill on, data rank 1's stay within the bars."""
    got = common.served(runs["dir"], "serve_2x2_kv_roll", (2, 2))
    want = _load(runs, "jax_serve_2x2.npz")
    hit = list(common.SERVE_FAULTS["kv_roll"])
    kept = [z for z in range(common.Z) if z not in hit]
    close_logits(got["logits"][:, kept], want["logits"][:, kept],
                 "the other data rank's slots")
    np.testing.assert_array_equal(got["tokens"][:, kept],
                                  want["tokens"][:, kept])
    off = np.abs(got["logits"][0, hit] - want["logits"][0, hit]).max()
    assert off > 1e-2 * np.abs(want["logits"][0, hit]).max(), off


def family_dpo_held(work, name, share=common.MOE_ADAM_SHARE):
    """Run ``name`` of another AP test file (``common.DPO_RUNS``): its one
    sharded DPO step on ``common.DPO_MESH`` and the DPO eval step after it
    against the reference's, losses within DPO_LOSS and adapters within
    (a)'s bars with at most ``share`` of a leaf's entries past LEAF."""
    tag = f"{name}_dpo_%dx%d" % common.DPO_MESH
    got = dict(np.load(os.path.join(work, f"port_{tag}.npz")))
    want = dict(np.load(os.path.join(work, f"jax_{tag}.npz")))
    assert got["losses"].shape == (1, common.Z)
    assert got["eval"].shape == (common.Z,) and np.isfinite(got["eval"]).all()
    for key in ("losses", "eval"):
        np.testing.assert_allclose(got[key], want[key], **DPO_LOSS)
    assert (np.abs(want["eval"] - np.log(2.0)) > 1e-5).all(), want["eval"]
    _adapters_close(got, want, f"port {tag} vs reference", share)
