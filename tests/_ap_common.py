"""Settings and helpers shared by ``tests/test_torch_ap.py``, its JAX
reference process (``tests/_ap_reference.py``) and its port ranks
(``tests/_ap_worker.py``): the example's reduced paper-llama-tiny (2
layers, d 128, 4 heads, vocab 512) in fp32, Z 4, b 4, S 32, ranks
[8, 8, 4, 4], 3 steps."""
import dataclasses

import numpy as np

Z, B, S, STEPS = 4, 4, 32, 3
RANKS = (8, 8, 4, 4)
LR = 3e-3
# the example's per-slot lrs with no clipping: slot 3 diverges
DIVERGE_LRS = (3e-3, 1e-3, 1e-2, 300.0)
DIVERGE_STEPS = 6           # the batches cycled: by then slot 3 lags
JAX_MESHES = ((1, 1), (2, 2), (4, 1))
PORT_MESHES = ((2, 2), (4, 1))
DIMS = dict(num_layers=2, d_model=128, vocab=512)


def jax_config():
    from repro.configs.registry import get_arch
    return dataclasses.replace(get_arch("paper-llama-tiny").reduced(**DIMS),
                               dtype="float32")


def port_config(name: str = "paper-llama-tiny"):
    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(name).reduced(**DIMS),
                               dtype="float32")


def flat(tree, prefix: str = "") -> dict:
    """A nested dict of arrays as {"<prefix>a/b": array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def unflat(arrays: dict, prefix: str) -> dict:
    """The nested dict of the keys under ``prefix``."""
    out: dict = {}
    for key, v in arrays.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out
