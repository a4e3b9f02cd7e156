"""The JAX package's sharded train step on forced CPU host devices, for
``tests/test_torch_ap.py``.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_ap_reference.py <workdir>

Reads ``<workdir>/init.npz`` (the shared weights, adapters and batches, see
``tests/_ap_common.py``) and writes ``<workdir>/jax_<d>x<m>.npz`` (per-step
per-slot losses and the updated adapters) for each mesh of
``common.JAX_MESHES``, built as ``examples/adapter_parallel.py`` builds its
mesh, with Auto axes (jax >= 0.7 makes Explicit axes by default, which the
reference's constraints cannot name).
"""
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


def run(cfg, init, shape):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    params = jax.tree_util.tree_map(jnp.asarray, common.unflat(init,
                                                               "params/"))
    lora = jax.tree_util.tree_map(jnp.asarray, common.unflat(init, "lora/"))
    Z = common.Z
    opt = adamw.init_state(lora, Z)
    hp = adamw.SlotHParams.broadcast(Z, lr=common.LR)
    ranks = jnp.asarray(common.RANKS, jnp.int32)
    active = jnp.ones((Z,), jnp.int32)
    batch = {"tokens": jnp.asarray(init["tokens"][0]),
             "labels": jnp.asarray(init["labels"][0])}
    ns = lambda t: PT.to_named(mesh, t)  # noqa: E731
    p_sh = ns(PT.base_param_specs(mesh, params))
    l_sh = ns(PT.lora_param_specs(mesh, lora))
    o_sh = ns(PT.opt_state_specs(mesh, opt))
    h_sh = ns(PT.hp_specs(mesh, hp))
    v_sh = PT.to_named(mesh, PT.pick_spec(mesh, (Z,), [{0: "data"}, {}]))
    b_sh = ns(PT.batch_specs(mesh, batch))
    step = jax.jit(SD.make_train_step(cfg, mesh),
                   in_shardings=(p_sh, l_sh, o_sh, h_sh, v_sh, v_sh, b_sh),
                   out_shardings=(l_sh, o_sh, None))
    params = jax.device_put(params, p_sh)
    lora = jax.device_put(lora, l_sh)
    opt = jax.device_put(opt, o_sh)
    losses = []
    with mesh:
        for t in range(common.STEPS):
            batch = {"tokens": jnp.asarray(init["tokens"][t]),
                     "labels": jnp.asarray(init["labels"][t])}
            lora, opt, metrics = step(params, lora, opt, hp, active, ranks,
                                      batch)
            losses.append(np.asarray(metrics["per_slot_loss"]))
    out = {"losses": np.stack(losses)}
    out.update(common.flat(jax.tree_util.tree_map(np.asarray, lora),
                           "lora/"))
    return out


def main(workdir: str) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    init = dict(np.load(os.path.join(workdir, "init.npz")))
    cfg = common.jax_config()
    for shape in common.JAX_MESHES:
        out = run(cfg, init, shape)
        np.savez(os.path.join(workdir, "jax_%dx%d.npz" % shape), **out)
    print("done")


if __name__ == "__main__":
    main(sys.argv[1])
