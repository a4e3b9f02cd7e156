#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: multi-adapter serving of stablelm-3b
on one NVIDIA card, through the port's hand-written CUDA kernels.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card (it exits
non-zero, printing no result, without a card or without the repository's
``src/repro_torch`` beside it). Imports nothing of JAX nor of the JAX
package. Phases, none of them caught:

1. card   — name and power limit (nvidia-smi), torch and CUDA versions;
            TF32 off for matmuls and cuDNN.
2. build  — nvcc builds the rank-local grouped-LoRA kernels from
            ``src/repro_torch/kernels/grouped_lora/csrc``.
3. kernels — each kernel against its plain PyTorch version at stablelm-3b
            shapes (bf16 activations, fp32 adapter masters, Z = 4 slots):
            times (CUDA events around a replayed CUDA graph of many calls,
            and around the same calls made eagerly; median of 21), a
            ``torch.bmm`` yardstick the port never calls, and the bound
            (max of bytes / 3.35 TB/s and flops / 989 TFLOP/s).
4. serve  — full-width, full-depth stablelm-3b (bf16, random weights from a
            seed), 4 adapters at true ranks 8/16/32/64, 4 lanes, max_len
            256: 16 greedy requests (prompts of 32-128 tokens, 32 new
            tokens each) through AdapterPool -> ServingReplica ->
            ServingFrontend in continuous mode; every request returns 32
            tokens, both kernels' launch counters grow by exactly one
            launch per LoRA projection, and the first fused join+decode
            step's logits match, slot by slot, a rerun of that step on the
            plain versions, while three reruns with a planted LoRA fault
            (every delta dropped, one slot's delta halved) must not;
            then a warm join step is timed and four decode steps run
            under torch.profiler (device busy time, top kernels).

The last line is ``{"ok": true, "device": {...}}``; the line before it the
kernel table as JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (NVIDIA data sheet)
H100_BYTES_S = 3.35e12        # HBM3 bandwidth (NVIDIA data sheet)

# kernel vs plain, bf16 outputs: the two sum the same fp32 products in
# another order, so an output may round to the neighbouring bf16 value:
# |diff| <= 2**-7 * |plain| (one bf16 ulp) + 1e-5 * max|plain|
KERNEL_RTOL = 2 ** -7
KERNEL_ATOL_REL = 1e-5
# whole-model logits of each slot, kernels vs plain versions after 2 x 32
# layers in bf16: the one-ulp differences above compound through every
# layer, so the bar is set on the scale of the slot's logits: max|diff| <=
# 5% of max|logit| and ||diff|| <= 3% of ||logits||. On an H100 the sound
# run reads at most 0.026 and 0.023; the mildest planted fault (one
# rank-8 slot's delta halved) reads 0.33 and 0.33 (see PERF.md).
LOGITS_ATOL_REL = 0.05
LOGITS_REL_RMS = 0.03

RANKS = (8, 16, 32, 64)
LANES, MAX_LEN, MAX_NEW, N_REQ = 4, 256, 32, 16


def require(ok: bool, what: str) -> None:
    """A check that stays under ``python -O`` (unlike ``assert``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def card_line() -> str:
    return sh("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader").splitlines()[0]


def time_ms(torch, fn, n_inner: int, samples: int = 21):
    """Per-call time of ``fn(i)`` on the card, two ways: replaying a CUDA
    graph that holds ``n_inner`` calls (device time alone), and calling it
    ``n_inner`` times from Python (host dispatch included). Each is the
    median over ``samples`` of CUDA-event timings, after a warm-up."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(n_inner):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_inner):
            fn(i)

    def eager():
        for i in range(n_inner):
            fn(i)

    def median_ms(run):
        out = []
        for _ in range(samples):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            run()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / n_inner)
        return statistics.median(out)

    return median_ms(graph.replay), median_ms(eager)


def kernel_phase(torch, RL, ref):
    """Each kernel against its plain version; returns per-kernel results
    at the decode shape the serving path launches most (T = lanes,
    din = dout = d_model = 2560) and prints every case."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    Z, r = 4, 64
    cases = [  # (label, T, din, dout, ranks, rows)
        ("decode", LANES, 2560, 2560, RANKS, None),
        ("decode", LANES, 2560, 6912, RANKS, None),
        ("decode", LANES, 6912, 2560, RANKS, None),
        ("prefill", LANES * 128, 2560, 2560, RANKS, None),
        ("prefill", LANES * 128, 6912, 2560, RANKS, None),
        ("edge", LANES * 128, 2560, 6912, (0, 13, 32, 64),
         (LANES * 128, LANES * 128 - 1, 200, 7)),
    ]
    results = {}
    print("times in ms per call: graph replay (device time); after '|' the "
          "same calls made eagerly from Python (host dispatch included)")
    print("kernel  case     T    din   dout  ranks            rows"
          "            ms        plain_ms  library_ms bound_ms  bound_by"
          "   max_abs_err  | eager ms, plain, library")
    for label, T, din, dout, ranks_t, rows_t in cases:
        ranks = torch.tensor(ranks_t, dtype=torch.int32, device=dev)
        rows = (None if rows_t is None else
                torch.tensor(rows_t, dtype=torch.int32, device=dev))
        live = [min(rk, r) for rk in ranks_t]
        nrows = [T] * Z if rows_t is None else list(rows_t)
        # enough copies of the adapters that a timing loop streams them
        # from device memory (a decode step reads every layer's adapters
        # once, far more than the 50 MB L2 holds)
        n_copies = max(1, int(200e6 // (Z * r * (din + dout) * 4)))
        xs = [torch.randn(Z, T, din, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        As = [torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
              for _ in range(n_copies)]
        Bs = [torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
              for _ in range(n_copies)]
        keep = (torch.arange(r, device=dev)[None, :] < ranks[:, None])
        As_lib = [(A * keep[:, None, :]).to(torch.bfloat16) for A in As]
        Bs_lib = [(B * keep[:, :, None]).to(torch.bfloat16) for B in Bs]
        x = xs[0]
        # --- correctness
        s = RL.xa(x, As[0], rows, ranks)
        y = RL.sb_add(s, Bs[0], 2.0, rows, ranks)
        torch.cuda.synchronize()
        s_ref = ref.ranklocal_xa_ref(x, As[0], rows, ranks)
        y_ref = ref.ranklocal_sb_add_ref(s, Bs[0], 2.0, rows, ranks)
        errs = {}
        for name, out, want in (("xa", s, s_ref), ("sb_add", y, y_ref)):
            o, w = out.float(), want.float()
            torch.testing.assert_close(
                o, w, rtol=KERNEL_RTOL,
                atol=KERNEL_ATOL_REL * float(w.abs().max()))
            errs[name] = float((o - w).abs().max())
        for z in range(Z):                   # exact zeros where nothing lives
            require(bool((s[z, :, live[z]:] == 0).all()),
                    "xa: padded rank region not exactly 0")
            require(bool((s[z, nrows[z]:] == 0).all()),
                    "xa: dead rows not exactly 0")
            require(bool((y[z, nrows[z]:] == 0).all()),
                    "sb_add: dead rows not exactly 0")
            if live[z] == 0:
                require(bool((y[z] == 0).all()),
                        "sb_add: rank-0 slot delta not exactly 0")
        # --- timing, rotating through the adapter copies
        n = len(As)
        ss = [RL.xa(xs[i % 2], As[i % n], rows, ranks) for i in range(2)]
        timing = {
            "xa": (lambda i: RL.xa(xs[i % 2], As[i % n], rows, ranks),
                   lambda i: ref.ranklocal_xa_ref(xs[i % 2], As[i % n], rows,
                                                  ranks),
                   lambda i: torch.bmm(xs[i % 2], As_lib[i % n])),
            "sb_add": (lambda i: RL.sb_add(ss[i % 2], Bs[i % n], 2.0, rows,
                                           ranks),
                       lambda i: ref.ranklocal_sb_add_ref(
                           ss[i % 2], Bs[i % n], 2.0, rows, ranks),
                       lambda i: torch.bmm(ss[i % 2], Bs_lib[i % n])),
        }
        # the bytes each function must move (inputs read once, outputs
        # written once, live rows/ranks only) and its flops
        sum_rr = sum(rk * nr for rk, nr in zip(live, nrows))
        work = {
            "xa": (sum(nr * din * 2 for nr, rk in zip(nrows, live) if rk)
                   + sum(live) * din * 4 + Z * T * r * 2,
                   2 * sum_rr * din),
            "sb_add": (sum_rr * 2 + sum(live) * dout * 4 + Z * T * dout * 2,
                       2 * sum_rr * dout),
        }
        for name, (kern, plain, lib) in timing.items():
            inner = 50 if T <= 64 else 10
            ms, eager_ms = time_ms(torch, kern, inner)
            plain_ms, plain_eager = time_ms(torch, plain, inner)
            lib_ms, lib_eager = time_ms(torch, lib, inner)
            nbytes, flops = work[name]
            t_bytes, t_ops = nbytes / H100_BYTES_S, flops / H100_BF16_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            print(f"{name:7s} {label:8s} {T:4d} {din:5d} {dout:5d}  "
                  f"{str(ranks_t):16s} {str(rows_t):15s} {ms:9.5f} "
                  f"{plain_ms:9.5f} {lib_ms:9.5f}  {bound_ms:9.6f} "
                  f"{bound_by:10s} {errs[name]:.3g}  | eager {eager_ms:.5f} "
                  f"{plain_eager:.5f} {lib_eager:.5f}")
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], errs[name])
            if (label, din, dout) == ("decode", 2560, 2560):
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        del xs, As, Bs, As_lib, Bs_lib, ss
        torch.cuda.empty_cache()
    return results


def serve_phase(torch, RL, cfg):
    """Serve N_REQ requests on ``cfg`` (stablelm-3b at full size in
    ``main``) on the card."""
    import numpy as np

    from repro_torch.core import lora as LORA
    from repro_torch.core.steps import make_join_decode_step
    from repro_torch.data.synthetic import make_task_dataset
    from repro_torch.models import model as M
    from repro_torch.serve import (AdapterPool, ServingFrontend,
                                   ServingReplica)

    dev = "cuda"
    sync = torch.cuda.synchronize
    Z = len(RANKS)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    stack = LORA.init_lora_tree(gen, cfg, Z,
                                torch.tensor(RANKS, dtype=torch.int32),
                                M.target_shapes(cfg))
    for ab in stack.values():     # nonzero B so every LoRA delta is live
        ab["B"].normal_(0.0, 0.003, generator=gen)
    pool = AdapterPool(cfg, Z, device=dev)
    pool.publish_many([(f"a{z}", {t: {m: x[:, z] for m, x in ab.items()}
                                  for t, ab in stack.items()}, RANKS[z])
                       for z in range(Z)])
    del stack
    sync()
    print(f"serve: {cfg.name} L={cfg.num_layers} d={cfg.d_model} "
          f"H={cfg.num_heads} hd={cfg.resolved_head_dim} ff={cfg.d_ff} "
          f"V={cfg.vocab_size} {cfg.dtype}; ranks={RANKS} lanes={LANES} "
          f"max_len={MAX_LEN}; init {time.perf_counter() - t0:.1f} s")

    rep = ServingReplica(cfg, params, pool, lanes=LANES, max_len=MAX_LEN,
                         device=dev)
    fe = ServingFrontend(rep, mode="continuous")
    ds = make_task_dataset("serve", cfg.vocab_size, seq_len=128,
                           num_train=N_REQ, difficulty=0.3, seed=0)
    lens = [int(v) for v in np.random.default_rng(0).integers(32, 129,
                                                              N_REQ)]
    # request i goes to adapter i % Z; the frontend gives it lane i // Z
    rids = [fe.submit(f"a{i % Z}", ds.train[i, :lens[i]], MAX_NEW)
            for i in range(N_REQ)]

    RL.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    t_serve = time.perf_counter()
    first = True
    # ServingFrontend.drain()'s loop, with a clock around every step
    while fe.queued() or rep.busy_lanes():
        sync()
        t = time.perf_counter()
        fe.step_continuous(record_logits=first)
        sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
        first = False
    wall = time.perf_counter() - t_serve
    launches = dict(RL.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()

    out = {rid: fe.result(rid) for rid in rids}
    require(all(len(v) == MAX_NEW for v in out.values()),
            f"token counts {[len(v) for v in out.values()]}")
    forwards = rep.total_decode_steps + rep.block_prefills
    per_forward = len(cfg.lora.targets) * cfg.num_layers
    want = per_forward * forwards
    require(forwards > 0 and launches["xa"] == launches["sb_add"] == want,
            f"launches {launches}, expected {want} each")
    print(f"serve: {len(out)} requests x {MAX_NEW} tokens; "
          f"{rep.total_decode_steps} fused steps ({rep.block_prefills} "
          f"with a join), {forwards} forwards; launches {launches} "
          f"= {per_forward} per forward; per decode step "
          f"{2 * per_forward} kernels")
    decode_ms = step_ms[1:]
    print(f"serve: {rep.total_generated} tokens in {wall:.3f} s = "
          f"{rep.total_generated / wall:.1f} tok/s; first step (join of "
          f"{N_REQ} prompts + decode) {step_ms[0]:.2f} ms; median decode "
          f"step {statistics.median(decode_ms):.2f} ms (min "
          f"{min(decode_ms):.2f}, max {max(decode_ms):.2f}) = "
          f"{N_REQ / statistics.median(decode_ms) * 1e3:.1f} tok/s "
          f"while all {N_REQ} lanes decode; peak memory "
          f"{peak / 2**30:.2f} GiB")

    # the first fused join+decode step again on fresh caches: once through
    # make_join_decode_step with the kernels (it must reproduce the served step),
    # once with the kernels' plain versions (LoRA backend "torch"). The
    # plain runs decode from the kernel run's first tokens: a prefill
    # argmax over 50k bf16 logits can flip on a one-ulp difference, and a
    # flipped token would compare two different decode inputs.
    P = min(1 << (max(lens) - 1).bit_length(), MAX_LEN)
    toks = torch.zeros((Z, LANES, P), dtype=torch.int32)
    plens = torch.ones((Z, LANES), dtype=torch.int32)
    for i in range(N_REQ):
        z, k = i % Z, i // Z
        toks[z, k, :lens[i]] = torch.from_numpy(ds.train[i, :lens[i]])
        plens[z, k] = lens[i]
    toks, plens = toks.to(dev), plens.to(dev)
    everyone = torch.ones((Z, LANES), dtype=torch.bool, device=dev)
    nobody = torch.zeros_like(everyone)
    cur0 = torch.zeros((Z, LANES), dtype=torch.int32, device=dev)
    with torch.inference_mode(), LORA.slot_ranks(pool.ranks):
        cache = M.init_cache(cfg, Z, LANES, MAX_LEN, per_lane=True,
                             device=dev)
        first, k_logits, _, _ = make_join_decode_step(cfg)(
            params, pool.lora, cache, toks, everyone, plens, cur0, nobody)
        del cache

    def plain(lora, ranks):
        """Prefill and first decode logits on the plain versions."""
        cache = M.init_cache(cfg, Z, LANES, MAX_LEN, per_lane=True,
                             device=dev)
        with (torch.inference_mode(), LORA.backend("torch"),
              LORA.slot_ranks(ranks)):
            pre, cache = M.prefill_lanes(cfg, params, lora, cache, toks,
                                         everyone, plens)
            logits, _ = M.decode_step(cfg, params, lora, cache,
                                      first.to(torch.int32), active=everyone)
        return pre, logits.float()

    def gap(a, b):
        """Per slot: max|a-b| / max|b| and ||a-b|| / ||b||."""
        d, b = (a - b).flatten(1), b.flatten(1)
        return (d.abs().amax(1) / b.abs().amax(1)).tolist(), \
            (d.norm(dim=1) / b.norm(dim=1)).tolist()

    def within(g):
        return (max(g[0]) <= LOGITS_ATOL_REL
                and max(g[1]) <= LOGITS_REL_RMS)

    def show(g):
        return (f"max|diff|/max|logit| {[round(v, 5) for v in g[0]]}, "
                f"relative RMS {[round(v, 5) for v in g[1]]}")

    k = k_logits.float()
    p_pre, p = plain(pool.lora, pool.ranks)
    served = torch.from_numpy(rep.step_logits[0][1]).to(dev)
    sound = gap(k, p)
    agree = float((k.argmax(-1) == p.argmax(-1)).float().mean())
    first_agree = float((first == p_pre.argmax(-1)).float().mean())
    err_served = float((served - k).abs().max())
    print(f"serve: first-step logits per slot, kernels vs plain versions: "
          f"{show(sound)} (bars {LOGITS_ATOL_REL}, {LOGITS_REL_RMS}); "
          f"greedy agreement: decode {agree:.3f}, prefill {first_agree:.3f}; "
          f"served step vs rerun max|diff| {err_served:.4g}")
    require(bool(torch.isfinite(k).all())
            and tuple(k.shape) == (Z, LANES, cfg.vocab_size),
            f"logits {tuple(k.shape)} not finite or misshapen")
    require(within(sound), "kernel logits too far from the plain versions'")
    require(err_served <= LOGITS_ATOL_REL * float(p.abs().max()),
            "rerun of the first step does not reproduce the served one")

    # controls: the plain versions with a planted LoRA fault, held to the
    # same bars against the sound plain run; each must fail them, or the
    # bars could not tell such a fault in the kernels from rounding
    def halved(z):
        return {t: {"A": ab["A"], "B": torch.cat(
            [ab["B"][:, :z], ab["B"][:, z:z + 1] * 0.5, ab["B"][:, z + 1:]],
            dim=1)} for t, ab in pool.lora.items()}

    controls = [("every LoRA delta dropped", pool.lora,
                 torch.zeros_like(pool.ranks))]
    controls += [(f"slot {z} (rank {RANKS[z]}) delta halved", halved(z),
                  pool.ranks) for z in (0, Z - 1)]
    for what, lora, ranks in controls:
        g = gap(plain(lora, ranks)[1], p)
        print(f"serve: control, {what}: {show(g)}")
        require(not within(g), f"control '{what}' passes the logits bars")
        del lora

    # the same 16-lane load again on the warm replica: its join step is
    # timed (the first one above also paid one-time CUDA and cuBLAS set-up),
    # then four decode steps run under torch.profiler
    for i in range(N_REQ):
        fe.submit(f"a{i % Z}", ds.train[i, :lens[i]], 8)
    sync()
    t = time.perf_counter()
    fe.step_continuous()
    sync()
    print(f"serve: warm join step (prefill of {N_REQ} prompts, P={P}, + one "
          f"decode) {(time.perf_counter() - t) * 1e3:.2f} ms")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        t = time.perf_counter()
        for _ in range(4):
            fe.step_continuous()
        sync()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in kernels.values())
    print(f"profile: 4 decode steps (profiler on) {wall_us / 4e3:.2f} "
          f"ms/step wall, device busy {busy / 4e3:.2f} ms/step = "
          f"{busy / wall_us:.3f} of the wall, "
          f"{sum(n for n, _ in kernels.values()) / 4:.0f} device "
          f"events/step" if busy else
          "profile: no device events traced: not measured")
    for name, (n, us) in sorted(kernels.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        print(f"profile:   {us / 4e3:8.3f} ms/step {n // 4:5d}/step "
              f"{name[:90]}")
    fe.drain()
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run "
              "from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.grouped_lora import ranklocal as RL
    from repro_torch.kernels.grouped_lora import ref

    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    lib = RL.build()
    print(f"build: {lib.name} in {time.perf_counter() - t:.2f} s")

    print(f"kernels on {card}:")
    kern = kernel_phase(torch, RL, ref)
    from repro_torch.configs.registry import get_arch
    launches = serve_phase(torch, RL, get_arch("stablelm-3b"))

    src = "src/repro_torch/kernels/grouped_lora/csrc/ranklocal.cu"
    table = {"kernels": [
        {"name": "ranklocal_xa", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/grouped_lora/ranklocal.py:97",
         "launches": launches["xa"], **kern["xa"]},
        {"name": "ranklocal_sb_add", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/grouped_lora/ranklocal.py:187",
         "launches": launches["sb_add"], **kern["sb_add"]},
    ]}
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
