"""PyTorch port: the pod axis for the ssm, hybrid, vlm and audio families —
their sharded train, eval, prefill and serve steps on a real ("pod",
"data", "model") mesh, held against the JAX package's GSPMD steps on 8
forced CPU devices with the same axes.

The runs are ``tests/_ap_common.py``'s ``POD_RUNS`` of this file
(``POD_FILES["pod_families"]``) on a 2x2x2 mesh, each slot's b = 4 rows 2
a pod rank: reduced rwkv6-3b (4 scan heads, 2 a model rank; train and
serve), hymba-1.5b at d 160 (5 attention heads, whole on every model rank
at m 2, and 10 Mamba heads, 5 a rank, at S 128; train and serve), qwen2-vl
with a 40-row prefix at S 64 and per-slot M-RoPE positions, both cut by
pod rows (train, eval and serve), and musicgen-medium (train). The
settings and the checks are ``tests/test_torch_ap_pod.py``'s, whose module
fixture this file's mirrors: (a) losses within 1e-5 relative of the
reference's on the same mesh, the adapters within
``common.MOE_ADAM_SHARE``'s bars; (b) serving within 1e-5 of the logits'
scale and streams equal; (c) the pod ranks' adapters bitwise equal after
every step; (d) the pod invariant from every rank's collective log.

rwkv's one-rank steps already differ between the packages
(``common.SSM_ONE_RANK``: up to 12% of a B leaf's entries past rtol 1e-5
after 3 steps at one rank), so its pod run is held as
``tests/test_torch_ap_ssm.py`` holds its 2x2 and 4x1 runs: the losses
within 1e-5 of the reference's, every adapter entry within
``ADAM_BOUND`` of the reference's, and on ``chip_smoke.py``'s relative RMS
adapter reading the port's pod run against its own one-rank run at most
``SELF_MOVES`` times the reference's pod run against the reference's
one-rank run, and the two pod runs at most ``ONE_RANK_GAP`` times the two
one-rank runs apart.
"""
import numpy as np
import pytest

import chip_smoke
from tests import _ap_common as common
from tests.test_torch_ap import ADAM_BOUND, LOSS, _one_rank, _serve_held
from tests.test_torch_ap_ssm import ONE_RANK_GAP, SELF_MOVES
from tests.test_torch_ap_pod import load, one_serves, pod_invariant, \
    same_adapters, start, step_held

NAMES = common.POD_FILES["pod_families"]
SERVES = [n for n in NAMES if "serve" in common.POD_RUNS[n]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from tests.test_torch_ap_modal import _init as modal_init
    from tests.test_torch_ap_ssm import _init as ssm_init
    work = str(tmp_path_factory.mktemp("ap_pod_families"))
    for name in NAMES:
        (ssm_init if name in common.SSM_RUNS else modal_init)(work, name)
    return start(work, NAMES)


@pytest.fixture(scope="module")
def one_serve(runs, tmp_path_factory):
    return one_serves(runs, SERVES, tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_pod_family_step_matches_the_reference(runs, name, tmp_path):
    if name not in common.SSM_ONE_RANK:
        step_held(runs, name, common.MOE_ADAM_SHARE)
        return
    got = load(runs, f"port_pod_{name}.npz")
    want = load(runs, f"jax_pod_{name}.npz")
    jone = load(runs, f"jax_pod_{name}_1x1.npz")
    init = load(runs, common.pod_init(name))
    np.testing.assert_allclose(got["losses"], want["losses"], **LOSS)
    for k in (k for k in want if k.startswith("lora/")):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=ADAM_BOUND,
                                   err_msg=f"port pod {name} {k}")
    one = _one_rank(init, tmp_path, common.pod_config(name, "repro_torch"))
    np.testing.assert_allclose(one["losses"], jone["losses"], **LOSS)

    def reading(a, b):
        return chip_smoke._ap_readings(np, a, b, init, range(common.Z))[1]

    port_moves, ref_moves = reading(got, one), reading(want, jone)
    gap_one, gap = reading(one, jone), reading(got, want)
    print(f"pod {name}: adapter readings: port pod vs port 1x1 "
          f"{port_moves:.3e}, reference pod vs reference 1x1 "
          f"{ref_moves:.3e}; port vs reference at 1x1 {gap_one:.3e}, on "
          f"the pod mesh {gap:.3e}")
    assert port_moves <= SELF_MOVES * ref_moves, (port_moves, ref_moves)
    assert gap <= ONE_RANK_GAP * gap_one, (gap, gap_one)


@pytest.mark.parametrize("name", SERVES)
def test_pod_family_serve_matches_the_reference(runs, one_serve, name):
    _serve_held(common.served(runs, f"serve_pod_{name}", common.POD_MESH),
                load(runs, f"jax_pod_{name}_serve.npz"),
                one_serve[name]["global"], f"serve pod {name}")


@pytest.mark.parametrize("name", NAMES)
def test_pod_family_ranks_hold_the_same_adapters(runs, name):
    same_adapters(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_pod_family_axis_carries_only_grads_and_loss_sums(runs, name):
    pod_invariant(runs, name, common.pod_config(name, "repro_torch"))
