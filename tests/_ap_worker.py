"""One rank of the port's side of ``tests/test_torch_ap.py``: a 4-rank gloo
group on the CPU (8 ranks with ``--pod``), started torchrun-style
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``).

    python tests/_ap_worker.py <workdir>

Reads ``<workdir>/init.npz`` (the reference's weights, adapters and
batches) and writes, rank 0 for the group:
  * ``port_<d>x<m>.npz`` — 3 steps of ``steps_dist.make_train_step`` on
    each mesh of ``PORT_MESHES`` (losses and every slot's adapters, merged
    over "data" by ``launch.train.write_out``); ``port_2x2_opt2.npz`` at
    opt level 2; ``port_2x2_div.npz`` with the example's diverging lrs and
    no clipping over ``DIVERGE_STEPS`` steps, and ``port_2x2_div_ctl.npz``
    with slot 3 at 3e-3;
  * ``log_<d>x<m>_rank<r>.json`` — each rank's collective records of the
    opt-level-0 run on each mesh;
  * ``port_dpo_<d>x<m>.npz`` — 2 sharded DPO steps and the DPO eval step
    on each mesh (``chip_smoke.ap_dpo``), and ``port_dpo_2x2_dpo_swap.npz``
    with ``chip_smoke._planted_serve``'s "dpo_swap";
  * ``serve_<d>x<m>_rank<r>.npz`` — each rank's prefill and greedy serve
    steps (``chip_smoke.ap_serve``), ``serve_2x2_kv_roll_rank<r>.npz``
    with the planted "kv_roll", and ``lanes_2x2_rank<r>.npz`` over a
    per-lane cache with ``common.IDLE_LANES`` idle in a last step.

Each ``port_<d>x<m>.npz`` also holds "eval": the sharded eval step after
the steps, on the first batch with the trained adapters (so do the MoE
runs of ``common.MOE_EVALS``, the ssm runs of ``common.SSM_EVALS`` and
every modal run).

    python tests/_ap_worker.py <workdir> --moe

runs the MoE family instead (``tests/test_torch_ap_moe.py``): for each run
of ``common.moe_runs()``, ``init_<name>.npz`` in, ``port_<name>_<d>x<m>
.npz`` and ``log_<name>_<d>x<m>_rank<r>.json`` out; on ``FAULT_CASE`` at
``FAULT_MESH`` also the planted fault (a), ``port_<tag>_fault.npz`` (data
rank 1 routes ``FAULT_LAYER`` without the lower ranks' counts), and opt
level 2, ``port_<tag>_opt2.npz``.

    python tests/_ap_worker.py <workdir> --ssm

runs the ssm and hybrid families and the whole-heads attention instead
(``tests/test_torch_ap_ssm.py``): for each run of ``common.ssm_runs()``,
``init_<name>.npz`` in, ``port_<name>_<d>x<m>.npz`` and
``log_<name>_<d>x<m>_rank<r>.json`` out; for each run of
``common.SSM_FAULTS``, that fault planted at 2x2
(``chip_smoke._planted_ssm``), ``port_<name>_2x2_fault.npz``; opt level 2
of rwkv at 2x2, ``port_rwkv_2x2_opt2.npz``; and ``layout_refusals.json``,
the ``ValueError`` of the sharded prefill and serve steps given rwkv's
cache laid out by ``cache_specs`` on 2x2.

    python tests/_ap_worker.py <workdir> --modal

runs the vlm and audio families instead (``tests/test_torch_ap_modal.py``):
for each run of ``common.modal_runs()``, ``init_<name>.npz`` in,
``port_<name>_<d>x<m>.npz``, ``log_<name>_<d>x<m>_rank<r>.json`` (the
train steps' collective records) and ``eval_log_<...>.json`` (the eval
step's) out; on
``common.MODAL_FAULT_RUN`` at 2x2 also each fault of
``common.MODAL_FAULTS`` planted alone (``chip_smoke._planted_modal``),
``port_<tag>_<fault>.npz``.

    python tests/_ap_worker.py <workdir> --pod <run>...

runs the pod runs instead (``tests/test_torch_ap_pod.py`` and
``tests/test_torch_ap_pod_families.py``, 8 ranks): those runs of
``common.POD_RUNS`` on a ``common.POD_MESH`` ("pod", "data", "model") mesh
(``pod_main``), and, with "dense", ``refusals_pod.json``.

    python tests/_ap_worker.py <workdir> --uneven <run>...

runs those runs of ``common.UNEVEN_RUNS`` instead
(``tests/test_torch_ap_uneven.py``, ``uneven_main``).

The MoE, ssm and modal runs of ``common.DPO_RUNS`` also write
``port_<name>_dpo_2x2.npz`` (one DPO step and the DPO eval step), and those
of ``common.SERVE_RUNS`` ``serve_<name>_<d>x<m>_rank<r>.npz`` on each of
their meshes, with the per-lane idle step, the planted serving faults and
the ring stream where ``common`` names them (``extras``).
"""
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.launch import mesh as MESH  # noqa: E402
from repro_torch.launch import partitioning as PT  # noqa: E402
from repro_torch.launch import steps_dist as SD  # noqa: E402
from repro_torch.launch import train as TRAIN  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
import chip_smoke  # noqa: E402
from tests import _ap_common as common  # noqa: E402

def train(cfg, init, mesh, *, lrs=None, clip=1.0, opt_level=0,
          steps=common.STEPS, evals=False, extra=None, whole=False):
    """``steps`` sharded train steps; with ``evals`` then the sharded eval
    step on the first batch with the trained adapters ("eval");
    "digests", this rank's adapters' per-slot digests after each step
    (``chip_smoke._digests``). ``extra`` ({name: array}, per-slot [Z]
    leaves) joins every train batch, laid out as ``batch_specs`` lays out
    the batch or, with ``whole``, whole (the step cuts them)."""
    Z = common.Z
    params = bridge.params_from_numpy(cfg, common.unflat(init, "params/"),
                                      "cpu")
    lora = bridge.lora_from_numpy(common.unflat(init, "lora/"), "cpu")
    opt = adamw.init_state(lora, Z)
    hp = adamw.SlotHParams.broadcast(Z, lr=common.LR, grad_clip=clip)
    for slot, lr in enumerate(lrs or ()):
        hp = hp.replace_slot(slot, lr=lr)
    ranks = torch.tensor(common.RANKS, dtype=torch.int32)
    active = torch.ones((Z,), dtype=torch.int32)

    def placed(tree, specs):
        return PT.distribute(mesh, tree, PT.to_named(mesh, specs))

    l_named = PT.to_named(mesh, PT.lora_param_specs(mesh, lora))
    o_named = PT.to_named(mesh, PT.opt_state_specs(mesh, opt))
    params = placed(params, PT.base_param_specs(mesh, params))
    lora = PT.distribute(mesh, lora, l_named)
    opt = PT.distribute(mesh, opt, o_named)
    hp = placed(hp, PT.hp_specs(mesh, hp))
    v_spec = PT.pick_spec(mesh, (Z,), [{0: "data"}, {}])
    active, ranks = (placed(t, v_spec) for t in (active, ranks))
    step = SD.make_train_step(cfg, mesh, opt_level=opt_level)
    more = {k: torch.from_numpy(v) for k, v in (extra or {}).items()}
    if more and not whole:
        more = placed(more, PT.batch_specs(mesh, more))
    losses, digests = [], []
    for t in range(steps):
        batch = common.port_batch(init, t % common.STEPS)
        batch = {**placed(batch, PT.batch_specs(mesh, batch)), **more}
        lora, opt, metrics = step(params, lora, opt, hp, active, ranks,
                                  batch)
        lora = PT.from_local(mesh, lora, l_named)
        opt = PT.from_local(mesh, opt, o_named)
        losses.append(metrics["per_slot_loss"].numpy())
        digests.append(chip_smoke._digests(PT.local(lora)))
    out = {"losses": np.stack(losses), "lora": PT.local(lora),
           "log": [dataclasses.asdict(r) for r in step.policy.spmd.log],
           "digests": digests}
    if evals:
        batch = common.port_batch(init, 0)
        ev = SD.make_eval_step(cfg, mesh, opt_level=opt_level)
        out["eval"] = ev(params, lora, active,
                         placed(batch, PT.batch_specs(mesh, batch))).numpy()
        out["eval_log"] = [dataclasses.asdict(r) for r in ev.policy.spmd.log]
    return out


def dpo(cfg, init, mesh, steps=1):
    """``steps`` sharded DPO steps on ``common.dpo_batch``'s pairs, then
    the DPO eval step on DPO batch 0 with the trained adapters
    (``chip_smoke.ap_dpo``, ranks unbound as in the reference's step)."""
    params = bridge.params_from_numpy(cfg, common.unflat(init, "params/"),
                                      "cpu")
    lora = bridge.lora_from_numpy(common.unflat(init, "lora/"), "cpu")
    batches = [{k: torch.from_numpy(v) for k, v in
                common.dpo_batch(init, t).items()}
               for t in (*range(steps), 0)]
    return chip_smoke.ap_dpo(torch, cfg, mesh, params, lora, batches,
                             torch.tensor(common.RANKS, dtype=torch.int32),
                             lr=common.DPO_LR, bind_ranks=False)


def serve(workdir, name, cfg, init, mesh, **kw) -> None:
    """The sharded prefill step and ``common.SERVE_DECODES`` greedy serve
    steps (``chip_smoke.ap_serve``: ``serve_lora``'s adapters, ranks
    unbound as in the reference's steps; with ``ring``, the ring stream
    fed the first batch); each rank writes its results, its data rank's
    slots and its cache shards, to ``<name>_rank<r>.npz``."""
    params = bridge.params_from_numpy(cfg, common.unflat(init, "params/"),
                                      "cpu")
    lora = bridge.lora_from_numpy(common.serve_lora(init), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in common.serve_batch(init).items()}
    n = common.SERVE_DECODES
    if kw.get("ring"):
        n, kw["feed"] = common.RING_STEPS, batch["tokens"].movedim(2, 0)
    res = chip_smoke.ap_serve(torch, cfg, mesh, params, lora, batch, None,
                              n, **kw)
    out = {k: res[k].numpy() for k in ("logits", "tokens")}
    out.update({k: np.asarray(v) for k, v in res["cache"].items()})
    if "idle_logits" in res:
        out.update(idle_logits=res["idle_logits"].float().numpy(),
                   idle_changed=res["idle_changed"],
                   live_changed=res["live_changed"])
    np.savez(os.path.join(workdir, f"{name}_rank{dist.get_rank()}.npz"),
             **out)
    with open(os.path.join(workdir, f"{name}_log_rank{dist.get_rank()}"
                           ".json"), "w") as f:
        json.dump(res["log"], f)


def extras(workdir, name, cfg, init, meshes, shapes=()) -> None:
    """The DPO and serving runs of run ``name`` (``common.DPO_RUNS``,
    ``common.SERVE_RUNS``): ``port_<name>_dpo_<d>x<m>.npz`` on
    ``common.DPO_MESH``; ``serve_<name>_<d>x<m>_rank<r>.npz`` on each of
    ``shapes`` (``meshes``: {shape: mesh}), ``lanes_<name>_rank<r>.npz``
    over a per-lane cache with ``common.IDLE_LANES`` idle in a last step
    on its ``common.SERVE_IDLE`` mesh, its planted fault of
    ``common.SERVE_FAULT_RUNS`` at 2x2 (``serve_<name>_<fault>_rank<r>
    .npz``), and the ring stream of ``common.RING_RUN``
    (``ring_<name>_rank<r>.npz``)."""
    if name in common.DPO_RUNS:
        mesh = meshes[common.DPO_MESH]
        TRAIN.write_out(os.path.join(
            workdir, f"port_{name}_dpo_%dx%d.npz" % common.DPO_MESH), mesh,
            dpo(cfg, init, mesh))
    if name not in common.SERVE_RUNS:
        return
    for shape in shapes:
        serve(workdir, f"serve_{name}_%dx%d" % shape, cfg, init,
              meshes[shape])
    if name in common.SERVE_IDLE:
        serve(workdir, f"lanes_{name}", cfg, init,
              meshes[common.SERVE_IDLE[name]], per_lane=True,
              idle=common.IDLE_LANES)
    for fault, run in common.SERVE_FAULT_RUNS.items():
        if run == name:
            with chip_smoke._serve_fault(cfg, fault):
                serve(workdir, f"serve_{name}_{fault}", cfg, init,
                      meshes[(2, 2)])
    if name == common.RING_RUN:
        serve(workdir, f"ring_{name}", cfg, init, meshes[common.RING_MESH],
              ring=True)


def refusal(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def layout_refusals(cfg, mesh) -> dict:
    """{step: the ``ValueError`` message} of the sharded prefill and serve
    steps given a cache laid out by ``cache_specs`` (the reference's
    layout, which splits rwkv's wkv by its key channel, not its heads)."""
    from repro_torch.models import model as M
    cache = M.init_cache(cfg, common.Z, common.B, 1, device="cpu")
    cache = chip_smoke._placed(mesh, cache, PT.cache_specs(mesh, cache))
    tokens = torch.zeros((common.Z, common.B, 1), dtype=torch.int32)
    args = {"prefill": ({"tokens": tokens},), "serve": (tokens[:, :, 0],)}
    out = {}
    for step, rest in args.items():
        try:
            getattr(SD, f"make_{step}_step")(cfg, mesh)({}, {}, cache, *rest)
            out[step] = ""
        except ValueError as e:
            out[step] = str(e)
    return out


def moe_main(workdir: str) -> None:
    with MESH.process_group("cpu", backend="gloo"):
        me = dist.get_rank()
        meshes = {s: MESH.make_local_mesh(s, device="cpu")
                  for s in ((2, 2), (4, 1))}
        for name, _, case, shape in common.moe_runs():
            init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
            cfg = common.moe_config(name, "repro_torch")
            if shape == common.MOE_CASES[case][4][0]:
                extras(workdir, name, cfg, init, meshes,
                       common.MOE_CASES[case][4])
            tag = f"{name}_%dx%d" % shape
            res = train(cfg, init, meshes[shape],
                        steps=common.MOE_STEPS.get(case, common.STEPS),
                        evals=name in common.MOE_EVALS)
            TRAIN.write_out(os.path.join(workdir, f"port_{tag}.npz"),
                            meshes[shape], res)
            with open(os.path.join(workdir, f"log_{tag}_rank{me}.json"),
                      "w") as f:
                json.dump(res["log"], f)
            if (name, shape) == (common.FAULT_CASE, common.FAULT_MESH):
                # chip_smoke.py's fault (a), as phase 36 plants it
                with chip_smoke._planted_moe(("route_blind",),
                                             common.FAULT_LAYER,
                                             common.FAULT_LAYER):
                    res = train(cfg, init, meshes[shape],
                                evals=name in common.MOE_EVALS)
                TRAIN.write_out(os.path.join(workdir,
                                             f"port_{tag}_fault.npz"),
                                meshes[shape], res)
                TRAIN.write_out(os.path.join(workdir, f"port_{tag}_opt2.npz"),
                                meshes[shape],
                                train(cfg, init, meshes[shape], opt_level=2,
                                      evals=name in common.MOE_EVALS))
        dist.barrier()
    print("done")


def ssm_main(workdir: str) -> None:
    with MESH.process_group("cpu", backend="gloo"):
        me = dist.get_rank()
        meshes = {s: MESH.make_local_mesh(s, device="cpu")
                  for s in ((2, 2), (4, 1), (1, 4))}
        for name, shape in common.ssm_runs():
            init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
            cfg = common.ssm_config(name, "repro_torch")
            if shape == common.SSM_RUNS[name][3][0]:
                extras(workdir, name, cfg, init, meshes,
                       common.SSM_RUNS[name][3])
            tag = f"{name}_%dx%d" % shape
            res = train(cfg, init, meshes[shape],
                        evals=name in common.SSM_EVALS)
            TRAIN.write_out(os.path.join(workdir, f"port_{tag}.npz"),
                            meshes[shape], res)
            with open(os.path.join(workdir, f"log_{tag}_rank{me}.json"),
                      "w") as f:
                json.dump(res["log"], f)
            if shape != (2, 2):
                continue
            if name in common.SSM_FAULTS:
                fault = common.SSM_FAULTS[name][0]
                with chip_smoke._planted_ssm((fault,),
                                             common.SSM_FAULT_LAYER):
                    res = train(cfg, init, meshes[shape])
                TRAIN.write_out(os.path.join(workdir,
                                             f"port_{tag}_fault.npz"),
                                meshes[shape], res)
            if name == "rwkv":
                TRAIN.write_out(os.path.join(workdir, f"port_{tag}_opt2.npz"),
                                meshes[shape],
                                train(cfg, init, meshes[shape], opt_level=2))
                msgs = layout_refusals(cfg, meshes[shape])
                if me == 0:
                    with open(os.path.join(workdir, "layout_refusals.json"),
                              "w") as f:
                        json.dump(msgs, f)
        dist.barrier()
    print("done")


def modal_main(workdir: str) -> None:
    with MESH.process_group("cpu", backend="gloo"):
        me = dist.get_rank()
        meshes = {s: MESH.make_local_mesh(s, device="cpu")
                  for s in ((2, 2), (4, 1))}
        for name, shape in common.modal_runs():
            init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
            cfg = common.modal_config(name, "repro_torch")
            if shape == common.MODAL_RUNS[name][4][0]:
                extras(workdir, name, cfg, init, meshes,
                       common.MODAL_RUNS[name][4])
            tag = f"{name}_%dx%d" % shape
            res = train(cfg, init, meshes[shape], evals=True)
            TRAIN.write_out(os.path.join(workdir, f"port_{tag}.npz"),
                            meshes[shape], res)
            for kind in ("log", "eval_log"):
                with open(os.path.join(workdir,
                                       f"{kind}_{tag}_rank{me}.json"),
                          "w") as f:
                    json.dump(res[kind], f)
            if (name, shape) != (common.MODAL_FAULT_RUN, (2, 2)):
                continue
            for fault in common.MODAL_FAULTS:
                with chip_smoke._planted_modal((fault,)):
                    res = train(cfg, init, meshes[shape], evals=True)
                TRAIN.write_out(os.path.join(
                    workdir, f"port_{tag}_{fault}.npz"), meshes[shape], res)
        dist.barrier()
    print("done")


def pod_refusals(mesh) -> dict:
    """{case: the ``NotImplementedError`` message} of what a pod mesh
    refuses: ragged slot rows on the 2x2x2 mesh, and a mesh whose axes are
    in another order."""
    cfg = common.port_config()
    embed = {"embed": PT.distribute(mesh, torch.zeros(cfg.vocab_size,
                                                      cfg.d_model),
                                    PT.placements(mesh, PT.P()))}
    tokens = torch.zeros(2, 1, 8, dtype=torch.int32)
    msgs = {"pod ragged rows": refusal(
        lambda: SD.make_train_step(cfg, mesh)(
            embed, {}, None, None, None, None,
            {"tokens": tokens, "slot_rows": torch.full((2,), 8)}))}
    order = MESH.make_local_mesh((2, 2, 2), ("data", "pod", "model"),
                                 device="cpu")
    msgs["pod axis order"] = refusal(lambda: SD.make_train_step(cfg, order))
    return msgs


def pod_main(workdir: str, names) -> None:
    """The pod runs ``names`` (``common.POD_RUNS``) on a
    ``common.POD_MESH`` mesh of 8 ranks: ``port_pod_<name>.npz`` (the SFT
    steps and, for ``common.POD_EVALS``, the eval step; ``write_out``),
    ``log_pod_<name>_rank<r>.json`` (this rank's collective records of the
    train and eval steps, its adapters' digest after each SFT step and
    after the DPO steps), ``port_pod_<name>_dpo.npz``,
    ``serve_pod_<name>_rank<r>.npz`` and ``lanes_pod_<name>_rank<r>.npz``
    (``serve``, each with its ``_log_rank<r>.json``), as the run's parts
    say; with "dense", ``refusals_pod.json`` (``pod_refusals``)."""
    with MESH.process_group("cpu", backend="gloo"):
        me = dist.get_rank()
        mesh = MESH.make_local_mesh(common.POD_MESH, common.POD_AXES,
                                    device="cpu")
        for name in names:
            init = dict(np.load(os.path.join(workdir,
                                             common.pod_init(name))))
            cfg = common.pod_config(name, "repro_torch")
            parts = common.POD_RUNS[name]
            tag = f"pod_{name}"
            res = train(cfg, init, mesh, evals=name in common.POD_EVALS,
                        steps=common.POD_STEPS.get(name, common.STEPS))
            TRAIN.write_out(os.path.join(workdir, f"port_{tag}.npz"), mesh,
                            res)
            log = {k: res[k] for k in ("log", "eval_log", "digests")
                   if k in res}
            if "dpo" in parts:
                res = dpo(cfg, init, mesh, common.DPO_STEPS)
                TRAIN.write_out(os.path.join(workdir, f"port_{tag}_dpo.npz"),
                                mesh, res)
                log["dpo_digest"] = chip_smoke._digests(res["lora"])
            with open(os.path.join(workdir, f"log_{tag}_rank{me}.json"),
                      "w") as f:
                json.dump(log, f)
            if "serve" in parts:
                serve(workdir, f"serve_{tag}", cfg, init, mesh)
            if "lanes" in parts:
                serve(workdir, f"lanes_{tag}", cfg, init, mesh,
                      per_lane=True, idle=common.IDLE_LANES)
            if name == "dense":
                msgs = pod_refusals(mesh)
                if me == 0:
                    with open(os.path.join(workdir, "refusals_pod.json"),
                              "w") as f:
                        json.dump(msgs, f)
        dist.barrier()
    print("done")


def uneven_main(workdir: str, names) -> None:
    """The uneven runs ``names`` (``common.UNEVEN_RUNS``) on 4 ranks: for
    each of a run's meshes ``port_<name>_<d>x<m>.npz`` (the SFT steps with
    the run's per-slot leaves, ``common.uneven_extra``: whole for
    "dense_rows", laid out as the batch for the others; and, on its first
    mesh, the eval step where its parts name one) and
    ``log_<name>_<d>x<m>_rank<r>.json`` (this rank's collective records of
    the train steps, "log", and of the eval step, "eval_log"); on its first
    mesh ``serve_<name>_<d>x<m>_rank<r>.npz`` and
    ``lanes_<name>_rank<r>.npz`` (``serve``), as its parts say."""
    with MESH.process_group("cpu", backend="gloo"):
        me = dist.get_rank()
        meshes = {}
        for name in names:
            init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
            cfg = common.uneven_config(name, "repro_torch")
            *_, shapes, parts = common.UNEVEN_RUNS[name]
            for shape in shapes:
                if shape not in meshes:
                    meshes[shape] = MESH.make_local_mesh(shape, device="cpu")
                tag = f"{name}_%dx%d" % shape
                res = train(cfg, init, meshes[shape],
                            steps=common.UNEVEN_STEPS,
                            evals="eval" in parts and shape == shapes[0],
                            extra=common.uneven_extra(name),
                            whole=name == "dense_rows")
                TRAIN.write_out(os.path.join(workdir, f"port_{tag}.npz"),
                                meshes[shape], res)
                with open(os.path.join(workdir, f"log_{tag}_rank{me}.json"),
                          "w") as f:
                    json.dump({k: res[k] for k in ("log", "eval_log")
                               if k in res}, f)
            mesh = meshes[shapes[0]]
            if "serve" in parts:
                serve(workdir, f"serve_{name}_%dx%d" % shapes[0], cfg, init,
                      mesh)
            if "lanes" in parts:
                serve(workdir, f"lanes_{name}", cfg, init, mesh,
                      per_lane=True, idle=common.IDLE_LANES)
        dist.barrier()
    print("done")


def main(workdir: str) -> None:
    torch.set_num_threads(1)
    if sys.argv[2:3] == ["--pod"]:
        return pod_main(workdir, sys.argv[3:])
    if sys.argv[2:3] == ["--uneven"]:
        return uneven_main(workdir, sys.argv[3:])
    if sys.argv[2:3] == ["--moe"]:
        return moe_main(workdir)
    if sys.argv[2:3] == ["--ssm"]:
        return ssm_main(workdir)
    if sys.argv[2:3] == ["--modal"]:
        return modal_main(workdir)
    init = dict(np.load(os.path.join(workdir, "init.npz")))
    cfg = common.port_config()
    with MESH.process_group("cpu", backend="gloo"):
        me = dist.get_rank()
        meshes = {s: MESH.make_local_mesh(s, device="cpu")
                  for s in common.PORT_MESHES}

        def save(name, res, mesh):
            TRAIN.write_out(os.path.join(workdir, name), mesh, res)

        for shape in common.PORT_MESHES:
            res = train(cfg, init, meshes[shape], evals=True)
            tag = "%dx%d" % shape
            save(f"port_{tag}.npz", res, meshes[shape])
            with open(os.path.join(workdir, f"log_{tag}_rank{me}.json"),
                      "w") as f:
                json.dump(res["log"], f)
        m22 = meshes[(2, 2)]
        save("port_2x2_opt2.npz", train(cfg, init, m22, opt_level=2), m22)
        div = dict(clip=0.0, steps=common.DIVERGE_STEPS)
        save("port_2x2_div.npz", train(cfg, init, m22,
                                       lrs=common.DIVERGE_LRS, **div), m22)
        ctl = common.DIVERGE_LRS[:3] + (common.LR,)
        save("port_2x2_div_ctl.npz", train(cfg, init, m22, lrs=ctl, **div),
             m22)
        for shape in common.PORT_MESHES:
            tag, mesh = "%dx%d" % shape, meshes[shape]
            save(f"port_dpo_{tag}.npz",
                 dpo(cfg, init, mesh, common.DPO_STEPS), mesh)
            serve(workdir, f"serve_{tag}", cfg, init, mesh)
        with chip_smoke._planted_serve(("dpo_swap",)):
            save("port_dpo_2x2_dpo_swap.npz",
                 dpo(cfg, init, m22, common.DPO_STEPS), m22)
        with chip_smoke._planted_serve(("kv_roll",)):
            serve(workdir, "serve_2x2_kv_roll", cfg, init, m22)
        serve(workdir, "lanes_2x2", cfg, init, m22, per_lane=True,
              idle=common.IDLE_LANES)
        dist.barrier()
    print("done")


if __name__ == "__main__":
    main(sys.argv[1])
