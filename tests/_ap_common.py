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


# The MoE family on the same meshes (``tests/test_torch_ap_moe.py``):
# reduced fp32 granite-moe-1b-a400m (E 4, top-2, tied embedding) and
# llama4-scout-17b-a16e (E 4, top-1, a shared expert), 2 layers, d 128, at
# Z 4 and the example's ranks and lr, 3 steps. Case -> (b, S, vocab, the
# slots that repeat one token, REPEAT, at three of every four positions,
# the meshes):
#   span   — T 512: one group spanning every data rank; slots 1-2 repeat,
#            so their experts' capacity binds for slots 2-3;
#   moved  — span with slot 0 repeating too: the co-tenant dependence of
#            slots 2-3 (the other data rank at 2x2) on slot 0's tokens;
#   inside — T 8,192: groups of 4,096 inside each data rank at 2x2 and
#            spanning two ranks at 4x1 (natural data; capacity binds);
#   v515   — a vocabulary that does not split over "model" (whole there);
#   odd    — T 384, groups of 128 that neither divide nor are divided by a
#            rank's run of rows (``UNEVEN_RUNS``);
#   e3     — 3 routed experts, which do not split over "model": every model
#            rank runs all of them (granite: the output sliced along S;
#            llama4: beside its split shared expert, one partial sum); one
#            step (MOE_STEPS): at its third step a token of granite's slot 1
#            changes its route with sum order, in the port's one-rank step
#            and in the reference's own 2x2 against its 1x1 alike.
MOE_ARCHS = {"granite": "granite-moe-1b-a400m",
             "llama4": "llama4-scout-17b-a16e"}
MOE_CASES = {"span": (4, 32, 512, (1, 2), ((2, 2), (4, 1))),
             "moved": (4, 32, 512, (0, 1, 2), ((2, 2),)),
             "inside": (4, 512, 512, (), ((2, 2), (4, 1))),
             "v515": (4, 32, 515, (), ((2, 2), (4, 1))),
             "e3": (4, 32, 512, (), ((2, 2),)),
             # T 384 (Z 4, b 4, S 24), groups of 128: run by
             # tests/test_torch_ap_uneven.py and tests/test_torch_ap_pod.py
             # (UNEVEN_RUNS, POD_RUNS), no mesh of this file's own
             "odd": (4, 24, 512, (), ())}
MOE_EXPERTS = {"e3": 3}
MOE_STEPS = {"e3": 1}
MOE_DIMS = dict(num_layers=2, d_model=128)
# a slot of one token alone would give its attention equal values and
# its q/k adapters a gradient of rounding noise: every fourth position
# keeps its own token
REPEAT = 7
# AdamW's first steps move an entry by about lr times the sign of its
# gradient, so sum order flips the entries whose gradient is near 0: more
# of them in the MoE runs than in the dense example. The reference's own
# meshes differ from its 1x1 run in up to 0.65% of a leaf's entries
# (llama4, b 4, S 512, 2x2: q_proj A), past the dense example's
# ``ADAM_SHARE``; the MoE runs take this share instead, with the same
# per-entry bars and bound (``tests/test_torch_ap.py``). The reference
# runs that case at 1x1 too, for the comparison
MOE_ADAM_SHARE = 0.02
MOE_SELF_RUN = "llama4_inside"
# the port's planted fault (a): data rank 1 routes FAULT_LAYER without the
# lower ranks' counts, on the span case of granite at 2x2
FAULT_CASE, FAULT_MESH, FAULT_LAYER = "granite_span", (2, 2), 1


def moe_runs():
    """[(name "<arch>_<case>", arch, case, mesh)] of every MoE run."""
    return [(f"{a}_{c}", arch, c, mesh) for a, arch in MOE_ARCHS.items()
            for c, spec in MOE_CASES.items() for mesh in spec[4]]


def moe_config(name: str, package: str):
    """The reduced fp32 config of run ``name`` in ``package`` ("repro" or
    "repro_torch")."""
    import importlib
    a, c = name.split("_")
    get_arch = importlib.import_module(f"{package}.configs.registry").get_arch
    cfg = get_arch(MOE_ARCHS[a]).reduced(vocab=MOE_CASES[c][2], **MOE_DIMS)
    moe = dataclasses.replace(cfg.moe, num_experts=MOE_EXPERTS.get(
        c, cfg.moe.num_experts))
    return dataclasses.replace(cfg, moe=moe, dtype="float32")


# The ssm and hybrid families, and attention whose heads do not split
# (``tests/test_torch_ap_ssm.py``): reduced fp32 configs, 2 layers, vocab
# 512, at Z 4, b 4 and the example's ranks and lr, 3 steps. Run -> (arch,
# d_model, S, the meshes):
#   rwkv     — rwkv6-3b, 4 heads of 32: S 32 is two scan chunks of 16, and
#              each model rank's block of 16 tokens starts with a token
#              whose shift reads across the block boundary;
#   hymba128 — hymba-1.5b, 4 heads, 4 KV heads and 8 Mamba heads: every
#              head splits over "model";
#   hymba160 — hymba-1.5b, 5 heads, 5 KV heads (which do not split at 2x2:
#              attention runs whole on every model rank) and 10 Mamba
#              heads, at S 128, where the reduced window of 64 binds;
#   glm4     — glm4-9b, 4 heads and 2 KV heads on a 1x4 mesh: the KV
#              heads do not split over a model axis of 4.
SSM_RUNS = {"rwkv": ("rwkv6-3b", 128, 32, ((2, 2), (4, 1))),
            "hymba128": ("hymba-1.5b", 128, 32, ((2, 2), (4, 1))),
            "hymba160": ("hymba-1.5b", 160, 128, ((2, 2), (4, 1))),
            "glm4": ("glm4-9b", 128, 32, ((1, 4),))}
# chip_smoke.py phase 37's planted faults, planted in the port's 2x2 step
# in SSM_FAULT_LAYER: (a) data rank 0 shifts each model rank's sequence
# block alone (slots 0-1), (b) data rank 1 takes in_proj's contiguous
# column block for its x/z split (slots 2-3)
SSM_FAULTS = {"rwkv": ("shift_local", (0, 1)),
              "hymba128": ("in_proj_cols", (2, 3))}
SSM_FAULT_LAYER = 0
# The runs whose one-rank steps differ between the packages by more than
# the sharded step's sum order: the port's RWKV scan and its backward take
# another formulation than the reference's (``tests/test_torch_rwkv.py``
# holds their gradients at 2e-3), and after 3 AdamW steps up to 12% of a B
# leaf's entries differ past ``LEAF`` at one rank already. The reference
# runs them at 1x1 too, and the test holds the sharded runs' shares against
# the one-rank runs' own
SSM_ONE_RANK = ("rwkv",)


def ssm_runs():
    """[(name, mesh)] of every run of ``SSM_RUNS``."""
    return [(name, mesh) for name, spec in SSM_RUNS.items()
            for mesh in spec[3]]


def ssm_config(name: str, package: str):
    """The reduced fp32 config of run ``name`` in ``package`` ("repro" or
    "repro_torch")."""
    import importlib
    arch, d, _, _ = SSM_RUNS[name]
    get_arch = importlib.import_module(f"{package}.configs.registry").get_arch
    return dataclasses.replace(get_arch(arch).reduced(
        num_layers=2, d_model=d, vocab=512), dtype="float32")


# The sharded eval step (``steps_dist.make_eval_step``) after the steps, on
# the first batch with the trained adapters, against the reference's on the
# same mesh: every run of the dense example and of ``MODAL_RUNS``, and these
# runs of the MoE and ssm tests (on every mesh each runs)
MOE_EVALS = ("granite_span",)
SSM_EVALS = ("rwkv", "hymba128", "hymba160")

# The vlm and audio families (``tests/test_torch_ap_modal.py``): reduced
# fp32 qwen2-vl-72b (4 heads and 4 KV heads of 32, M-RoPE sections (8, 4,
# 4)) and musicgen-medium, 2 layers, d 128, at Z 4, b 4 and the example's
# ranks and lr, 3 steps. Run -> (arch, S, vocab, the stub prefix's rows P,
# the meshes):
#   vlm40  — a 40-row prefix at S 64: at 2x2 it crosses the model ranks'
#            boundary at 32 (rank 1's block starts with 8 prefix rows);
#   vlm8   — an 8-row prefix inside model rank 0's block;
#   vlm515 — vlm40 with a vocabulary that does not split over "model": the
#            whole-vocabulary lookup, cut to the rank's block, carries the
#            prefix;
#   audio  — musicgen-medium's EnCodec tokens, no prefix.
# A vlm batch's M-RoPE positions are those of a patch grid and the text
# after it, one grid for slots 0-1 and another for slots 2-3
# (``MODAL_GRIDS``), so that the data ranks' positions differ.
MODAL_RUNS = {"vlm40": ("qwen2-vl-72b", 64, 512, 40, ((2, 2), (4, 1))),
              "vlm8": ("qwen2-vl-72b", 64, 512, 8, ((2, 2), (4, 1))),
              "vlm515": ("qwen2-vl-72b", 64, 515, 40, ((2, 2),)),
              "audio": ("musicgen-medium", 32, 512, 0, ((2, 2), (4, 1)))}
MODAL_GRIDS = {40: ((5, 8), (4, 10)), 8: ((2, 4), (1, 8))}
# The runs whose one-rank steps already differ between the packages by
# more than the sharded step's sum order: with a vocabulary of 515 the
# logits' sums round differently in the two packages, and AdamW's sign
# steps take that past MOE_ADAM_SHARE of a leaf's entries (rtol 1e-5)
# after 3 steps at one rank. The reference runs them at 1x1 too, and the
# test holds each package's sharded run against its own one-rank run
MODAL_ONE_RANK = ("vlm515",)
# chip_smoke.py phase 38's planted faults, each in a 2x2 run of its own on
# MODAL_FAULT_RUN: (c) data rank 0's model ranks write the prefix at the
# head of their own sequence blocks (slots 0-1); (d) data rank 1 takes data
# rank 0's positions (slots 2-3)
MODAL_FAULTS = {"prefix_head": (0, 1), "positions_rank0": (2, 3)}
MODAL_FAULT_RUN = "vlm40"


def port_batch(init: dict, t: int) -> dict:
    """Step ``t``'s batch of ``init`` as the port's tensors: tokens and
    labels, and, where ``init`` holds them, the stub prefix
    ("modal_embeds") and the per-slot positions."""
    import torch
    batch = {"tokens": torch.from_numpy(init["tokens"][t]),
             "labels": torch.from_numpy(init["labels"][t])}
    if "modal" in init:
        batch["modal_embeds"] = torch.from_numpy(init["modal"][t])
        batch["positions"] = torch.from_numpy(init["positions"])
    return batch


def modal_runs():
    """[(name, mesh)] of every run of ``MODAL_RUNS``."""
    return [(name, mesh) for name, spec in MODAL_RUNS.items()
            for mesh in spec[4]]


def modal_config(name: str, package: str):
    """The reduced fp32 config of run ``name`` in ``package`` ("repro" or
    "repro_torch")."""
    import importlib
    arch, _, vocab, P, _ = MODAL_RUNS[name]
    get_arch = importlib.import_module(f"{package}.configs.registry").get_arch
    cfg = get_arch(arch).reduced(num_layers=2, d_model=128, vocab=vocab)
    return dataclasses.replace(cfg, num_modality_tokens=P, dtype="float32")


def grid_positions(grid, S: int) -> np.ndarray:
    """[3, S] int32 M-RoPE positions of a (rows, cols) patch-grid prefix and
    the text after it: patch (row, col) at (0, row, col), text token i at
    G + i in all three with G = max(grid) (Qwen2-VL's rule)."""
    rows, cols = grid
    idx = np.arange(rows * cols)
    text = max(grid) + np.arange(S - rows * cols)
    return np.stack([np.concatenate([np.zeros_like(idx), text]),
                     np.concatenate([idx // cols, text]),
                     np.concatenate([idx % cols, text])]).astype(np.int32)


def modal_batches(name: str, tokens: np.ndarray, labels: np.ndarray,
                  d_model: int, seed: int = 0) -> dict:
    """The vlm run ``name``'s extra batch entries for ``tokens``/``labels``
    [steps, Z, b, S]: "modal" [steps, Z, b, P, d] fp32 N(0, 0.02) from a
    numpy seed, "positions" [3, Z, b, S] (``MODAL_GRIDS``: the first grid
    for slots 0-1, the second for slots 2-3), and "labels" -1 over the
    prefix."""
    _, S, _, P, _ = MODAL_RUNS[name]
    steps, Zs, b, _ = tokens.shape
    rng = np.random.default_rng(seed)
    modal = (0.02 * rng.standard_normal((steps, Zs, b, P, d_model))
             ).astype(np.float32)
    pos = np.stack([grid_positions(MODAL_GRIDS[P][z >= Zs // 2], S)
                    for z in range(Zs)], axis=1)
    labels = labels.copy()
    labels[..., :P] = -1
    return {"modal": modal, "labels": labels,
            "positions": np.ascontiguousarray(np.broadcast_to(
                pos[:, :, None], (3, Zs, b, S)))}


# The DPO loss and the prefill and serve steps on the same meshes. DPO
# batch t pairs the run's batch t (chosen) with its next batch (rejected,
# cycled); the dense example takes DPO_STEPS steps on every mesh of
# PORT_MESHES, and each run of DPO_RUNS (a key of the other AP test files'
# runs) one step on DPO_MESH; each ends with the DPO eval step on DPO batch
# 0 with the trained adapters. The prefill step fills a cache of S +
# SERVE_DECODES rows with the run's first batch (its prefix and positions
# too), then SERVE_DECODES greedy serve steps decode, with the adapters of
# ``serve_lora`` (B nonzero, so that every LoRA term counts): the dense
# example and the runs of SERVE_RUNS, on their meshes.
DPO_STEPS = 2
# the DPO steps' lr: at LR two steps carry the margins past 17, where
# -log sigmoid is 0 in fp32 and the eval step would read nothing
DPO_LR = 1e-4
DPO_RUNS = ("granite_span", "rwkv", "hymba128", "vlm40", "audio")
DPO_MESH = (2, 2)
SERVE_DECODES = 8
# every family's prefill and serve steps, each run on the meshes of its
# train steps: vlm40 and audio; granite's span case (one token group of
# the prefill spans the data ranks, and capacity binds); rwkv (the wkv
# state by heads over "model"); hymba160 (whole attention heads at 2x2
# beside the Mamba state by heads, S 128 past the window of 64); glm4 on
# 1x4 (whole heads, dense)
SERVE_RUNS = ("vlm40", "audio", "granite_span", "rwkv", "hymba160", "glm4")
# the per-lane check of the dense example on 2x2 (``tests/test_torch_ap.py``
# (h)) and of these runs on these meshes: after the prefill and the greedy
# steps of every lane, a serve step with these (slot, lane) idle, one on
# each data rank (the 1x4 mesh has one data rank: both there)
IDLE_LANES = ((1, 0), (2, 3))
SERVE_IDLE = {"granite_span": (2, 2), "rwkv": (2, 2), "hymba160": (2, 2),
              "glm4": (1, 4)}
# a per-lane ring cache of hymba160's reduced window of 64 on 2x2, no
# prefill: RING_STEPS serve steps fed the run's first batch, past the
# window, against the reference's serve steps over its own ring cache
RING_RUN, RING_MESH, RING_STEPS = "hymba160", (2, 2), 72
# chip_smoke.py's planted faults of the new paths, each planted alone in a
# 2x2 run: "dpo_swap", data rank 1's policy forwards score the rejected
# sequences as chosen and the chosen as rejected (slots 2-3); "kv_roll", on
# data rank 0 the last model rank writes its KV heads into the cache rolled
# by one head (slots 0-1), both in the dense example; "state_roll" (rwkv),
# on data rank 1 the last model rank's wkv heads of layer 0 are rolled by
# one head after the prefill (slots 2-3); "conv_roll" (hymba160), on data
# rank 0 the last model rank's conv block of layer 0 is rolled by one row
# along W-1 after the prefill (slots 0-1); and phase 36's "route_blind" on
# granite's span case (data rank 1 routes the prefill's layer 0 without the
# lower ranks' counts, slots 2-3)
SERVE_FAULTS = {"dpo_swap": (2, 3), "kv_roll": (0, 1), "state_roll": (2, 3),
                "conv_roll": (0, 1), "route_blind": (2, 3)}
SERVE_FAULT_RUNS = {"state_roll": "rwkv", "conv_roll": "hymba160",
                    "route_blind": "granite_span"}


def dpo_batch(init: dict, t: int) -> dict:
    """DPO batch ``t`` of ``init`` as numpy arrays: its batch t chosen, its
    batch t + 1 (cycled) rejected."""
    r = (t + 1) % init["tokens"].shape[0]
    return {"tokens_chosen": init["tokens"][t],
            "labels_chosen": init["labels"][t],
            "tokens_rejected": init["tokens"][r],
            "labels_rejected": init["labels"][r]}


def serve_lora(init: dict, seed: int = 1) -> dict:
    """The serving runs' adapters: ``init``'s, each B drawn N(0, 0.01) from
    a numpy seed (A's columns past a slot's rank are 0, so its rank
    holds)."""
    rng = np.random.default_rng(seed)
    lora = unflat(init, "lora/")
    for ab in lora.values():
        ab["B"] = (0.01 * rng.standard_normal(ab["B"].shape)).astype(
            ab["B"].dtype)
    return lora


def serve_batch(init: dict) -> dict:
    """The prefill step's batch as numpy arrays: the run's first batch's
    tokens and, where ``init`` holds them, its prefix and positions."""
    batch = {"tokens": init["tokens"][0]}
    if "modal" in init:
        batch["modal_embeds"] = init["modal"][0]
        batch["positions"] = init["positions"]
    return batch


def served(work: str, name: str, shape) -> dict:
    """The serving results ``<name>_rank<r>.npz`` of every rank of a
    ``shape`` (d, m) or (p, d, m) mesh (rank r at pod rank r // (d·m), data
    rank r // m mod d, model rank r % m), assembled: "logits" [n + 1, Z, b,
    V] and "tokens" [n, Z, b] (and "idle_logits" [Z, b, V]) from each
    (pod, data) rank's model rank 0, after checking that its other model
    ranks returned the same bitwise, its lanes joined over "pod" and its
    slots over "data"; "cache/<path>" every leaf of the prefilled cache
    from every rank's shard (``chip_smoke.cache_whole``); "ranks", every
    rank's file."""
    import os

    import chip_smoke
    p, d, m = (1,) * (3 - len(shape)) + tuple(shape)
    parts = [dict(np.load(os.path.join(work, f"{name}_rank{r}.npz")))
             for r in range(p * d * m)]
    out = {"ranks": parts}
    for key in ("logits", "tokens", "idle_logits"):
        if key not in parts[0]:
            continue
        lead = key == "idle_logits"         # [Z, b, V]: no step dim
        rows = []
        for i in range(d):
            lanes = []
            for k in range(p):
                first = (k * d + i) * m
                for j in range(1, m):
                    assert np.array_equal(parts[first + j][key],
                                          parts[first][key]), (name, key,
                                                               k, i, j)
                lanes.append(parts[first][key])
            rows.append(np.concatenate(lanes, axis=2 - lead))
        out[key] = np.concatenate(rows, axis=1 - lead)
    out.update(chip_smoke.cache_whole(parts, d, m, np.concatenate, p))
    return out


# The pod axis (``tests/test_torch_ap_pod.py``: dense and MoE;
# ``tests/test_torch_ap_pod_families.py``: ssm, hybrid, vlm and audio):
# every run on a real ("pod", "data", "model") mesh of POD_MESH, 8 gloo
# ranks, against the reference's GSPMD steps on 8 forced CPU devices with
# the same axes. "pod" splits each slot's b = 4 rows, 2 a pod rank. Run ->
# its parts: "train" (STEPS SFT steps; with the eval step after them for
# POD_EVALS), "dpo" (DPO_STEPS DPO steps and the DPO eval step), "serve"
# (the prefill and SERVE_DECODES greedy serve steps) and "lanes" (the same
# over a per-lane cache, then one step with IDLE_LANES idle: lane (1, 0)
# on pod rank 0, lane (2, 3) on pod rank 1). The MoE runs are granite's
# span case (T 512: one token group over all 8 ranks, each rank's 2 slots
# 64-row pieces of it, interleaved with its pod peer's), its inside
# case (groups of 4,096 inside each data rank, each spanning its two pod
# ranks in pieces of 1,024) and its odd case (POD_STEPS); rwkv and
# hymba160 (whole attention heads at m 2, 5 Mamba heads a rank) are the
# ssm and hybrid runs of SSM_RUNS,
# vlm40 and audio those of MODAL_RUNS.
POD_MESH = (2, 2, 2)
POD_AXES = ("pod", "data", "model")
POD_RUNS = {"dense": ("train", "dpo", "serve", "lanes"),
            "granite_span": ("train", "serve"),
            "granite_inside": ("train",),
            "granite_odd": ("train",),
            "rwkv": ("train", "serve"), "hymba160": ("train", "serve"),
            "vlm40": ("train", "serve"), "audio": ("train",)}
POD_EVALS = ("dense", "vlm40")
# the SFT steps of a pod run, where they are not STEPS: granite's odd case
# (T 384, groups of 128; a rank's runs of (b/p)·S = 48 rows, pieces of 16)
POD_STEPS = {"granite_odd": 2}
# the runs of each test file: its fixture's one reference process and one
# group of 8 port ranks run them all
POD_FILES = {"pod": ("dense", "granite_span", "granite_inside",
                     "granite_odd"),
             "pod_families": ("rwkv", "hymba160", "vlm40", "audio")}


def pod_config(name: str, package: str):
    """The reduced fp32 config of pod run ``name`` in ``package``."""
    import importlib
    if name in SSM_RUNS:
        return ssm_config(name, package)
    if name in MODAL_RUNS:
        return modal_config(name, package)
    if name != "dense":
        return moe_config(name, package)
    get_arch = importlib.import_module(f"{package}.configs.registry").get_arch
    return dataclasses.replace(get_arch("paper-llama-tiny").reduced(**DIMS),
                               dtype="float32")


def pod_init(name: str) -> str:
    """The file the other AP tests' ``_init`` writes for run ``name``."""
    return "init.npz" if name == "dense" else f"init_{name}.npz"


def pod_coords(rank: int, shape=POD_MESH) -> tuple:
    """(pod, data, model) rank of global rank ``rank`` on a (p, d, m)
    mesh."""
    _, d, m = shape
    return rank // (d * m), rank // m % d, rank % m


# The last sharded refusals (``tests/test_torch_ap_uneven.py``): reduced
# fp32 configs, 2 layers, vocab 512, Z 4 and the example's ranks and lr.
# Run -> (arch, d_model, b, S, the meshes, its parts):
#   dense_rows  — the dense example with ragged ``slot_rows`` (UNEVEN_ROWS)
#                 on 2x2, nothing else bound: the ragged Function over a
#                 split model axis;
#   hymba_rows  — hymba-1.5b d 160 (5 heads: attention whole at m 2) with
#                 ``slot_rows`` and ``slot_ranks`` bound on 2x2: the
#                 rank-local Function with rows, and whole attention's
#                 o_proj on a sequence block of 64 of S 128;
#   hymba_whole — hymba-1.5b d 160 on 1x4: its 10 Mamba heads and 5
#                 attention heads do not split over 4, both run whole;
#   rwkv_whole  — rwkv6-3b d 96, 3 heads of 32, on 2x2;
#   granite_odd — granite-moe's odd case (T 384, groups of 128): runs of
#                 192 rows at 2x2 (pieces of 64), 96 at 4x1 (pieces of 32).
# Parts: "train" (UNEVEN_STEPS SFT steps), "eval" (the eval step after
# them), "serve" (the prefill and SERVE_DECODES greedy serve steps on the
# run's first mesh), "lanes" (a per-lane cache, then a step with
# IDLE_LANES idle). The rows of both row runs end mid-sequence in two
# slots, and every row is labelled, so that a row mapped wrongly moves a
# loss. rwkv's one-rank steps already drift from the reference's
# (SSM_ONE_RANK): its runs are held against the port's own one-rank run,
# and the reference does not run them.
UNEVEN_RUNS = {
    "dense_rows": ("paper-llama-tiny", 128, 4, 32, ((2, 2),), ("train",)),
    "hymba_rows": ("hymba-1.5b", 160, 4, 128, ((2, 2),), ("train",)),
    "hymba_whole": ("hymba-1.5b", 160, 4, 128, ((1, 4),),
                    ("train", "eval", "serve", "lanes")),
    "rwkv_whole": ("rwkv6-3b", 96, 4, 32, ((2, 2),),
                   ("train", "eval", "serve")),
    "granite_odd": ("granite-moe-1b-a400m", 128, 4, 24, ((2, 2), (4, 1)),
                    ("train", "eval", "serve")),
}
UNEVEN_STEPS = 3
UNEVEN_ROWS = {"dense_rows": (128, 80, 96, 40),
               "hymba_rows": (512, 320, 384, 160)}
# the row runs whose slot ranks are bound in the batch
UNEVEN_RANKS_BOUND = ("hymba_rows",)
UNEVEN_ONE_RANK = ("rwkv_whole",)
# ragged rows flip the signs of more near-zero gradient entries than the
# dense example's full rows: the reference's own 2x2 and 1x1 runs of
# dense_rows differ past ADAM_SHARE (0.0054 of a leaf's entries), so the
# uneven runs take MOE_ADAM_SHARE; the reference runs dense_rows at 1x1
# too, for that comparison
UNEVEN_SELF_RUN = "dense_rows"


def uneven_config(name: str, package: str):
    """The reduced fp32 config of uneven run ``name`` in ``package``."""
    import importlib
    if name == "granite_odd":
        return moe_config(name, package)
    arch, d, _, _, _, _ = UNEVEN_RUNS[name]
    get_arch = importlib.import_module(f"{package}.configs.registry").get_arch
    return dataclasses.replace(get_arch(arch).reduced(
        num_layers=2, d_model=d, vocab=512), dtype="float32")


def uneven_extra(name: str) -> dict:
    """Run ``name``'s per-slot batch leaves as numpy arrays: its
    ``slot_rows`` and, where bound, its ``slot_ranks``."""
    out = {}
    if name in UNEVEN_ROWS:
        out["slot_rows"] = np.asarray(UNEVEN_ROWS[name], np.int32)
    if name in UNEVEN_RANKS_BOUND:
        out["slot_ranks"] = np.asarray(RANKS, np.int32)
    return out
