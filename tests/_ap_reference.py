"""The JAX package's sharded train step on forced CPU host devices, for
``tests/test_torch_ap.py``, ``tests/test_torch_ap_moe.py``,
``tests/test_torch_ap_ssm.py``, ``tests/test_torch_ap_modal.py``,
``tests/test_torch_ap_pod.py``, ``tests/test_torch_ap_pod_families.py``
and ``tests/test_torch_ap_uneven.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_ap_reference.py <workdir> [--moe <arch key> <case>...
            | --ssm <run>... | --modal <run>... | --pod <run>...
            | --uneven <run>...]

Reads ``<workdir>/init.npz`` (the shared weights, adapters and batches, see
``tests/_ap_common.py``) and writes ``<workdir>/jax_<d>x<m>.npz`` (per-step
per-slot losses and the updated adapters) for each mesh of
``common.JAX_MESHES``, built as ``examples/adapter_parallel.py`` builds its
mesh, with Auto axes (jax >= 0.7 makes Explicit axes by default, which the
reference's constraints cannot name).

With ``--moe <key> <case>...`` (a key of ``common.MOE_ARCHS`` and keys of
``common.MOE_CASES``) it runs those MoE cases of that arch instead:
``init_<key>_<case>.npz`` in, ``jax_<key>_<case>_<d>x<m>.npz`` out for
each of the case's meshes (and 1x1 for ``common.MOE_SELF_RUN``), and, for
the span case, ``drops_<key>_span.json``: the choices the reference's
``moe_block`` drops in each call of a one-device forward of the first
batch, per slot (read from its one ``jnp.where`` by a debug callback).

With ``--ssm <run>...`` (keys of ``common.SSM_RUNS``) it runs those ssm,
hybrid and whole-heads runs: ``init_<run>.npz`` in,
``jax_<run>_<d>x<m>.npz`` out for each of the run's meshes (and 1x1 for
those of ``common.SSM_ONE_RANK``).

With ``--pod <run>...`` (keys of ``common.POD_RUNS``, with
``--xla_force_host_platform_device_count=8``) it runs those runs on a
("pod", "data", "model") mesh of ``common.POD_MESH`` (``pod_main``).

With ``--uneven <run>...`` (keys of ``common.UNEVEN_RUNS``) it runs those
runs of the last sharded refusals (``uneven_main``): ragged slot rows on a
split model axis, scan heads that do not divide the model axis, MoE token
groups that divide neither way.

With ``--modal <run>...`` (keys of ``common.MODAL_RUNS``) it runs those vlm
and audio runs: ``init_<run>.npz`` in (with the stub prefix ``modal`` and
the per-slot M-RoPE ``positions`` for the vlm runs),
``jax_<run>_<d>x<m>.npz`` out for each of the run's meshes (and 1x1 for
those of ``common.MODAL_ONE_RANK``).

Every run of the dense example, of ``common.MOE_EVALS``, of
``common.SSM_EVALS`` and of ``common.MODAL_RUNS`` also writes "eval": the
reference's ``make_eval_step`` on the same mesh after the steps, on the
first batch with the trained adapters. The dense example also writes
``jax_dpo_<d>x<m>.npz`` (``common.DPO_STEPS`` GSPMD DPO steps and the DPO
eval step) and ``jax_serve_<d>x<m>.npz`` (the GSPMD prefill step and
``common.SERVE_DECODES`` greedy serve steps, ``serve``) on each mesh of
``common.PORT_MESHES``; the runs of ``common.DPO_RUNS`` write
``jax_<name>_dpo_2x2.npz`` and those of ``common.SERVE_RUNS``
``jax_serve_<name>_<d>x<m>.npz`` (``extras``).
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import partitioning as PT  # noqa: E402
from repro.launch import steps_dist as SD  # noqa: E402
from repro.optim import adamw  # noqa: E402
from tests import _ap_common as common  # noqa: E402


def _batch(init, t):
    """Step ``t``'s batch of ``init``: tokens and labels, and, where
    ``init`` holds them, the stub prefix and the per-slot positions."""
    batch = {"tokens": jnp.asarray(init["tokens"][t]),
             "labels": jnp.asarray(init["labels"][t])}
    if "modal" in init:
        batch["modal_embeds"] = jnp.asarray(init["modal"][t])
        batch["positions"] = jnp.asarray(init["positions"])
    return batch


def _mesh(shape):
    """A (d, m) ("data", "model") or (p, d, m) ("pod", "data", "model")
    mesh with Auto axes."""
    axes = ("pod", "data", "model")[-len(shape):]
    return jax.make_mesh(shape, axes,
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def run(cfg, init, shape, steps=common.STEPS, evals=False,
        loss_kind="sft", extra=None):
    """``steps`` steps of the GSPMD train step on a ``shape`` mesh; with
    ``evals`` also its eval step after them, on the first batch with the
    trained adapters ("eval": the [Z] per-slot losses). With ``loss_kind``
    "dpo", the DPO loss on ``common.dpo_batch``'s pairs. ``extra`` ({name:
    array}) joins every train batch (``slot_rows``, ``slot_ranks``)."""
    mesh = _mesh(shape)
    more = {k: jnp.asarray(v) for k, v in (extra or {}).items()}
    if loss_kind == "dpo":
        batch_of = lambda t: {k: jnp.asarray(v) for k, v in  # noqa: E731
                              common.dpo_batch(init, t).items()}
    else:
        batch_of = lambda t: {**_batch(init, t), **more}  # noqa: E731
    params = jax.tree_util.tree_map(jnp.asarray, common.unflat(init,
                                                               "params/"))
    lora = jax.tree_util.tree_map(jnp.asarray, common.unflat(init, "lora/"))
    Z = common.Z
    opt = adamw.init_state(lora, Z)
    hp = adamw.SlotHParams.broadcast(
        Z, lr=common.DPO_LR if loss_kind == "dpo" else common.LR)
    ranks = jnp.asarray(common.RANKS, jnp.int32)
    active = jnp.ones((Z,), jnp.int32)
    batch = batch_of(0)
    ns = lambda t: PT.to_named(mesh, t)  # noqa: E731
    p_sh = ns(PT.base_param_specs(mesh, params))
    l_sh = ns(PT.lora_param_specs(mesh, lora))
    o_sh = ns(PT.opt_state_specs(mesh, opt))
    h_sh = ns(PT.hp_specs(mesh, hp))
    v_sh = PT.to_named(mesh, PT.pick_spec(mesh, (Z,), [{0: "data"}, {}]))
    b_sh = ns(PT.batch_specs(mesh, batch))
    step = jax.jit(SD.make_train_step(cfg, mesh, loss_kind=loss_kind),
                   in_shardings=(p_sh, l_sh, o_sh, h_sh, v_sh, v_sh, b_sh),
                   out_shardings=(l_sh, o_sh, None))
    params = jax.device_put(params, p_sh)
    lora = jax.device_put(lora, l_sh)
    opt = jax.device_put(opt, o_sh)
    losses = []
    with mesh:
        for t in range(steps):
            lora, opt, metrics = step(params, lora, opt, hp, active, ranks,
                                      batch_of(t))
            losses.append(np.asarray(metrics["per_slot_loss"]))
        if evals:
            # the eval step takes no ragged rows (the reference's eval
            # step binds none)
            first = {k: v for k, v in batch.items() if k not in more}
            ev = jax.jit(SD.make_eval_step(cfg, mesh, loss_kind=loss_kind),
                         in_shardings=(p_sh, l_sh, v_sh,
                                       ns(PT.batch_specs(mesh, first))))
            per_slot = np.asarray(ev(params, lora, active, first))
    out = {"losses": np.stack(losses)}
    if evals:
        out["eval"] = per_slot
    out.update(common.flat(jax.tree_util.tree_map(np.asarray, lora),
                           "lora/"))
    return out


def serve(cfg, init, shape, n=common.SERVE_DECODES, ring=False):
    """The GSPMD prefill step on ``common.serve_batch`` into a cache of S +
    ``n`` rows laid out by ``cache_specs``, then ``n`` greedy serve steps,
    with ``common.serve_lora``'s adapters on a ``shape`` mesh: "logits"
    [n + 1, Z, b, V] (the prefill's last token's, then each step's),
    "tokens" [n, Z, b] (the greedy stream) and every leaf of the prefilled
    cache, "cache/<path>" (K/V [L, Z, b, S + n, KV, hd], the recurrent
    states). With ``ring``, no prefill: a per-lane ring cache of the
    sliding window takes ``n`` serve steps fed the batch's tokens 0..n-1,
    "logits" [n, Z, b, V]."""
    from repro.models import model as JM
    mesh = _mesh(shape)
    params = jax.tree_util.tree_map(jnp.asarray, common.unflat(init,
                                                               "params/"))
    lora = jax.tree_util.tree_map(jnp.asarray, common.serve_lora(init))
    batch = {k: jnp.asarray(v) for k, v in common.serve_batch(init).items()}
    Z, b, S = batch["tokens"].shape
    cache = JM.init_cache(cfg, Z, b, S + n, ring=ring, per_lane=ring)
    ns = lambda t: PT.to_named(mesh, t)  # noqa: E731
    p_sh = ns(PT.base_param_specs(mesh, params))
    l_sh = ns(PT.lora_param_specs(mesh, lora))
    c_sh = ns(PT.cache_specs(mesh, cache))
    b_sh = ns(PT.batch_specs(mesh, batch))
    # a serve step's [Z, b] tokens, laid out as the batch's
    t_sh = ns(PT.batch_specs(mesh, {"t": batch["tokens"][..., 0]}))["t"]
    pre = jax.jit(SD.make_prefill_step(cfg, mesh),
                  in_shardings=(p_sh, l_sh, c_sh, b_sh),
                  out_shardings=(None, c_sh))
    dec = jax.jit(SD.make_serve_step(cfg, mesh),
                  in_shardings=(p_sh, l_sh, c_sh, t_sh),
                  out_shardings=(None, c_sh))
    params = jax.device_put(params, p_sh)
    lora = jax.device_put(lora, l_sh)
    cache = jax.device_put(cache, c_sh)
    out, logs, toks = {}, [], []
    with mesh:
        if ring:
            for i in range(n):
                cur = batch["tokens"][:, :, i]
                toks.append(np.asarray(cur))
                logits, cache = dec(params, lora, cache, cur)
                logs.append(np.asarray(logits))
        else:
            logits, cache = pre(params, lora, cache, batch)
            out = common.flat(jax.tree_util.tree_map(np.asarray,
                                                     cache["layers"]),
                              "cache/")
            logs.append(np.asarray(logits))
            for _ in range(n):
                cur = jnp.argmax(logits, axis=-1).astype(jnp.int32)
                toks.append(np.asarray(cur))
                logits, cache = dec(params, lora, cache, cur)
                logs.append(np.asarray(logits))
    out.update(logits=np.stack(logs), tokens=np.stack(toks))
    return out


def extras(workdir, name, cfg, init, shapes) -> None:
    """The DPO and serving runs of run ``name`` (``common.DPO_RUNS``,
    ``common.SERVE_RUNS``): ``jax_<name>_dpo_<d>x<m>.npz`` on
    ``common.DPO_MESH``, ``jax_serve_<name>_<d>x<m>.npz`` on each of
    ``shapes`` and, for ``common.RING_RUN``, ``jax_ring_<name>_<d>x<m>.npz``
    (``common.RING_STEPS`` steps over a ring cache) on
    ``common.RING_MESH``."""
    if name in common.DPO_RUNS:
        np.savez(os.path.join(workdir, f"jax_{name}_dpo_%dx%d.npz"
                              % common.DPO_MESH),
                 **run(cfg, init, common.DPO_MESH, 1, evals=True,
                       loss_kind="dpo"))
    if name in common.SERVE_RUNS:
        for shape in shapes:
            np.savez(os.path.join(workdir,
                                  f"jax_serve_{name}_%dx%d.npz" % shape),
                     **serve(cfg, init, shape))
    if name == common.RING_RUN:
        np.savez(os.path.join(workdir, f"jax_ring_{name}_%dx%d.npz"
                              % common.RING_MESH),
                 **serve(cfg, init, common.RING_MESH, common.RING_STEPS,
                         ring=True))


class _Over:
    """A module with some attributes replaced (the rest read through)."""

    def __init__(self, base, **over):
        self._base = base
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(self._base, name)


def drops(cfg, init) -> list:
    """Per ``moe_block`` call of a forward of the first batch, the dropped
    choices of each slot."""
    from repro.models import model as JM
    from repro.models import moe as JMOE
    seen = []

    def where(c, a, b):
        jax.debug.callback(lambda k: seen.append(np.asarray(k)), c)
        return jnp.where(c, a, b)

    params = jax.tree_util.tree_map(jnp.asarray, common.unflat(init,
                                                               "params/"))
    real = JMOE.jnp
    JMOE.jnp = _Over(jnp, where=where)
    try:
        fwd = jax.jit(lambda p, t: JM.forward(cfg, p, {}, t, remat=False)[0])
        fwd(params, jnp.asarray(init["tokens"][0])).block_until_ready()
    finally:
        JMOE.jnp = real
    return [[int((~q).sum()) for q in np.split(k.reshape(-1), common.Z)]
            for k in seen]


def ssm_main(workdir: str, names) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    for name in names:
        init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
        cfg = common.ssm_config(name, "repro")
        for shape in ((1, 1),) * (name in common.SSM_ONE_RANK) + \
                common.SSM_RUNS[name][3]:
            np.savez(os.path.join(workdir, f"jax_{name}_%dx%d.npz" % shape),
                     **run(cfg, init, shape,
                           evals=name in common.SSM_EVALS))
        extras(workdir, name, cfg, init, common.SSM_RUNS[name][3])
    print("done")


def modal_main(workdir: str, names) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    for name in names:
        init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
        cfg = common.modal_config(name, "repro")
        for shape in ((1, 1),) * (name in common.MODAL_ONE_RANK) + \
                common.MODAL_RUNS[name][4]:
            np.savez(os.path.join(workdir, f"jax_{name}_%dx%d.npz" % shape),
                     **run(cfg, init, shape, evals=True))
        extras(workdir, name, cfg, init, common.MODAL_RUNS[name][4])
    print("done")


def pod_main(workdir: str, names) -> None:
    """The pod runs ``names`` (keys of ``common.POD_RUNS``) on a
    ``common.POD_MESH`` ("pod", "data", "model") mesh:
    ``<common.pod_init(name)>`` in, ``jax_pod_<name>.npz`` (the SFT steps,
    with the eval step for ``common.POD_EVALS``), ``jax_pod_<name>_dpo
    .npz`` and ``jax_pod_<name>_serve.npz`` out, as the run's parts say,
    and, for ``common.SSM_ONE_RANK``, the SFT steps at 1x1
    (``jax_pod_<name>_1x1.npz``)."""
    assert len(jax.devices()) == 8, jax.devices()
    shape = common.POD_MESH
    for name in names:
        init = dict(np.load(os.path.join(workdir, common.pod_init(name))))
        cfg = common.pod_config(name, "repro")
        parts = common.POD_RUNS[name]
        out = os.path.join(workdir, f"jax_pod_{name}")
        np.savez(out + ".npz", **run(cfg, init, shape,
                                     common.POD_STEPS.get(name,
                                                          common.STEPS),
                                     evals=name in common.POD_EVALS))
        if name in common.SSM_ONE_RANK:
            np.savez(out + "_1x1.npz", **run(cfg, init, (1, 1)))
        if "dpo" in parts:
            np.savez(out + "_dpo.npz", **run(cfg, init, shape,
                                             common.DPO_STEPS, evals=True,
                                             loss_kind="dpo"))
        if "serve" in parts:
            np.savez(out + "_serve.npz", **serve(cfg, init, shape))
    print("done")


def uneven_main(workdir: str, names) -> None:
    """The uneven runs ``names`` (keys of ``common.UNEVEN_RUNS``):
    ``init_<name>.npz`` in, ``jax_<name>_<d>x<m>.npz`` out for each of the
    run's meshes (``common.UNEVEN_STEPS`` SFT steps with its
    ``common.uneven_extra`` leaves in every batch, and on its first mesh
    the eval step where its parts name one), and
    ``jax_serve_<name>_<d>x<m>.npz`` on its first mesh where they name
    "serve"; ``common.UNEVEN_SELF_RUN`` at 1x1 too."""
    assert len(jax.devices()) == 4, jax.devices()
    for name in names:
        init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
        cfg = common.uneven_config(name, "repro")
        *_, meshes, parts = common.UNEVEN_RUNS[name]
        for shape in ((1, 1),) * (name == common.UNEVEN_SELF_RUN) + meshes:
            np.savez(os.path.join(workdir, f"jax_{name}_%dx%d.npz" % shape),
                     **run(cfg, init, shape, common.UNEVEN_STEPS,
                           evals="eval" in parts and shape == meshes[0],
                           extra=common.uneven_extra(name)))
        if "serve" in parts:
            np.savez(os.path.join(workdir, f"jax_serve_{name}_%dx%d.npz"
                                  % meshes[0]), **serve(cfg, init, meshes[0]))
    print("done")


def main(workdir: str, moe: str = "", cases=()) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    if not moe:
        init = dict(np.load(os.path.join(workdir, "init.npz")))
        cfg = common.jax_config()
        for shape in common.JAX_MESHES:
            out = run(cfg, init, shape, evals=True)
            np.savez(os.path.join(workdir, "jax_%dx%d.npz" % shape), **out)
        for shape in common.PORT_MESHES:
            tag = "%dx%d" % shape
            np.savez(os.path.join(workdir, f"jax_dpo_{tag}.npz"),
                     **run(cfg, init, shape, common.DPO_STEPS, evals=True,
                           loss_kind="dpo"))
            np.savez(os.path.join(workdir, f"jax_serve_{tag}.npz"),
                     **serve(cfg, init, shape))
        print("done")
        return
    for case in cases:
        name = f"{moe}_{case}"
        init = dict(np.load(os.path.join(workdir, f"init_{name}.npz")))
        cfg = common.moe_config(name, "repro")
        meshes = common.MOE_CASES[case][4]
        for shape in ((1, 1),) * (name == common.MOE_SELF_RUN) + meshes:
            out = run(cfg, init, shape,
                      common.MOE_STEPS.get(case, common.STEPS),
                      evals=name in common.MOE_EVALS)
            np.savez(os.path.join(workdir, f"jax_{name}_%dx%d.npz" % shape),
                     **out)
        extras(workdir, name, cfg, init, meshes)
        if case == "span":
            with open(os.path.join(workdir, f"drops_{name}.json"),
                      "w") as f:
                json.dump(drops(cfg, init), f)
    print("done")


if __name__ == "__main__":
    if sys.argv[2:3] == ["--moe"]:
        main(sys.argv[1], sys.argv[3], sys.argv[4:])
    elif sys.argv[2:3] == ["--ssm"]:
        ssm_main(sys.argv[1], sys.argv[3:])
    elif sys.argv[2:3] == ["--modal"]:
        modal_main(sys.argv[1], sys.argv[3:])
    elif sys.argv[2:3] == ["--pod"]:
        pod_main(sys.argv[1], sys.argv[3:])
    elif sys.argv[2:3] == ["--uneven"]:
        uneven_main(sys.argv[1], sys.argv[3:])
    else:
        main(sys.argv[1])
