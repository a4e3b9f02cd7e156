#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: multi-adapter serving, rank-sweep
and full-rank learning-rate-sweep LoRA training, heterogeneous multi-task
co-location, DPO preference tuning, the engine (paper Listing 1)
scheduling and running three tuning tasks statically and elastically, a
live tuning-service session with tune-to-serve, and crash-and-resume of
stablelm-3b, at the executor and through the service's journal, then
serving and rank-sweep LoRA training of rwkv6-3b and of hymba-1.5b, on one
NVIDIA card, through the port's hand-written CUDA kernels.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card (it exits
non-zero, printing no result, without a card or without the repository's
``src/repro_torch`` beside it). Imports nothing of JAX nor of the JAX
package. Phases, none of them caught:

1. card   — name and power limit (nvidia-smi), torch and CUDA versions;
            TF32 off for matmuls and cuDNN.
2. build  — nvcc builds the eighteen grouped-LoRA kernels from the four
            sources in ``src/repro_torch/kernels/grouped_lora/csrc``
            (ranklocal.cu, ranklocal_bwd.cu, grouped_lora.cu, ragged.cu),
            the flash-attention kernel from
            ``src/repro_torch/kernels/flash_attention/csrc/
            flash_attention.cu`` and the linear-scan kernel from
            ``src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu``:
            one nvcc per source, all six started together; then
            ``cuobjdump`` of the grouped-LoRA and flash-attention
            libraries: every bf16 narrow_out_kernel, tn_kernel,
            rank_sum_kernel and flash_fwd_kernel instantiation holds
            tensor-core (HMMA) instructions, no fp32 one does, none spills
            to local memory, and each template has exactly its listed
            instantiations (registers and local bytes printed); and of
            the linear-scan library: both linear_scan_kernel
            instantiations are there, none spills to local memory
            (registers and local bytes printed).
3. kernels — each rank-local kernel against its plain PyTorch version at
            stablelm-3b shapes (bf16 activations, fp32 adapter masters,
            Z = 4 slots): the forward pair at serving shapes and the
            eval-step shape (4,096 token rows per slot), all six at
            training shapes (1,024 token rows per slot, ranks 4/8/16/32,
            one case with rows < T and a dead slot) and at the DPO step's
            (512 rows per slot in each policy forward, not timed); then
            each dense kernel
            at r = 64 (T = 1,024, din x dout in 2560 x 2560, 2560 x 6912,
            6912 x 2560; the forward pair also at T = 4,096; sb_add with
            and without a base; non-zero B, a different scale per slot)
            against its plain version and, bit for bit, against its
            rank-local twin at ranks (64, 64, 64, 64); then each ragged
            kernel at r = 64, T = 1,024 and the same three shapes, at rows
            (1024, 512, 1024, 512) and (1024, 300, 0, 1024), against its
            plain version (exact zeros and the base passed through on dead
            rows), bit for bit against its rank-local twin at ranks 64 with
            the same rows and against its dense twin at rows = T. Times
            (CUDA events around a replayed CUDA graph of many calls; median
            of 21), a ``torch.bmm`` yardstick the port never calls, and the
            bound (max of bytes / 3.35 TB/s and flops / 989 TFLOP/s, at the
            live rows and ranks); the rank-local forward pair's row is its
            decode time, its eval and train times kept beside it
            (``shapes`` in the kernel JSON).
3a. invariance — one fp32 summation order per output element of the bf16
            xa, ds, da, db, sb_add (with and without a base) and dx (the
            tensor-core kernels) in all three sets, at Z = 4, T = 1,024,
            r_max 64, 2560 -> 2560 and 2560 -> 6912, bit for bit: the rows
            of a T = 4 call equal the same rows of the T = 1,024 call
            (every output of one row per token row), a Z = 1 call its slot
            inside Z = 4, a slot of rows = 512 a T = 512 call (the dense
            set's too), and operands off 16-byte alignment the aligned
            call.
3b. flash — the flash-attention kernel against its plain PyTorch version
            at the shapes the path gives it (bf16, hd 80, causal: the SFT
            train step's B = Z*b*H = 512, the eval step's 2,048, a DPO
            forward's 256; S = 256) and at window 64, Sq 128 < Sk 256, Sq
            256 > Sk 128 (fully masked rows must be exactly 0), hd 64 and
            128, and fp32 inputs. The reading is the largest |diff| in
            units of one bf16 rounding (fp32: 1e-5 relative) and must be
            <= 1, while two faults planted in the plain version (the second
            32-key tile dropped, the softmax scale off by 1%) must read > 1;
            entries 0-127 of the B = 512 call must equal a B = 128 call
            bit for bit. Times (graph replay) of the kernel, the plain
            version and a yardstick the port never calls
            (``scaled_dot_product_attention(is_causal=True)`` on [Z*b, H,
            S, hd]), beside the bound.
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
            under torch.profiler (device busy time, top kernels). Serving
            prefills into a longer cache and decodes: the flash kernel
            must launch 0 times.
5. train  — one full-size make_train_step (4 slots at ranks 4/8/16/32,
            b = 4, S = 256, non-zero B) with the kernels against the same
            step on the plain versions: per slot loss, grad norm and the
            relative RMS of dA and dB, while four planted faults in the
            plain run (one slot's dA zeroed, the rank-32 slot's dB halved,
            the LoRA branch's dX dropped, the rank-4 slot's delta halved
            in the forward) must break the bars, the last the loss bar.
            The kernel run takes flash attention (2 launches per layer:
            forward and remat), the plain run the baseline einsum
            attention (model backend "torch"); a fifth planted fault in
            the plain run, every query seeing one future key, must break
            the loss bar too. Then one step's gradients under
            torch.profiler with flash attention and with the baseline
            attention (the LoRA kernels in both): device busy time each.
6. rank sweep — BatchedExecutor.run_task on full-size stablelm-3b: 8 jobs
            (ranks 4/8/16/32 x lr 1e-4/1e-3) on 4 slots, two warmup waves
            with rotation, selection, continue; every fused train step must
            launch the rank-local xa/sb_add 448 times and ds/da/db 224 (dx
            221) and flash attention 64, every eval step xa/sb_add 224
            times and flash 32, and the dense and ragged kernels never; real tokens/s over the whole run_task
            wall, the median train-step call by resident slots, eval step,
            peak memory, and two train steps under torch.profiler (device
            busy, the top kernels, and the per-step time and launches of
            each grouped-LoRA kernel template: narrow_out_kernel,
            rank_sum_kernel, tn_kernel).
7. dense train — phase 5 with every slot at r_max 64 and nothing bound
            (the dense kernels), the same bars and planted faults; then the
            same step with slot_ranks bound to (64, 64, 64, 64), through
            the rank-local kernels, must give bitwise the per-slot losses
            and every dA and dB.
8. ragged train — phase 7 with slot_rows bound to (1024, 512, 1024, 512)
            (labels -1 on the pad; the ragged kernels), the same bars and
            faults plus one of this path (the narrow slots' last live
            32-row tile treated as dead in the plain forward), which must
            break the loss bar; then the same step with slot_ranks bound to
            (64, 64, 64, 64) must give bitwise the per-slot losses, dA
            and dB.
9. co-located — stablelm-3b at full width and 4 layers: a full-rank task
            (64/64) and a low-rank one (4/8) fused on one
            SharedBackboneExecutor through run_colocated, and each alone:
            loss histories and best validation losses bitwise equal (the
            full-rank task takes the dense kernels alone, the rank-local
            ones fused).
10. co-located, mixed widths — the same at 4 layers for full-rank tasks of
            different widths: a b = 4 host beside a b = 2 guest (the ragged
            kernels fused, the dense ones for the host alone), beside an
            S = 128 guest on a seq_cap = 256 executor, and beside a rank
            4/8, b = 2 guest (the rank-local kernels): every task's
            histories bitwise equal alone and fused.
11. lr sweep — phase 6 with 8 jobs all at rank 64 (lr 1e-4/3e-4/1e-3/3e-3
            x weight decay 0/0.01), at full width and 8 of the 32 layers
            (depth cut for time): every step on the dense
            kernels (the launch counts of 8 layers), the rank-local and
            ragged kernels never.
12. heterogeneous co-location — the slice's main path: three full-rank
            tuning tasks of widths (b, S) = (4, 256), (2, 256) and
            (4, 128), 4 jobs each on 2 slots each, through run_colocated
            over one SharedBackboneExecutor (Z = 4, b_cap = 4, seq_cap =
            256) on full-size stablelm-3b; the third waits at the admission
            gate until a running task frees its slots. Every train step
            launches the kernel set its dense flag selects (ragged when a
            slot is narrower than the lane, dense otherwise; the rank-local
            set never), every eval step the dense forward pair; real
            tokens/s over the whole run, the padded share, the wall's
            breakdown, the median step per resident mix, peak memory, and
            two mixed-width steps under torch.profiler. Every step launches
            flash attention 64 times (train) or 32 (eval).
13. DPO train — phase 5 with the DPO loss on 2 preference pairs a slot
            (four forwards: policy chosen and rejected through the LoRA
            kernels at 512 rows per slot, reference chosen and rejected
            without adapters). The DPO loss reads beta times a difference
            of four per-slot sums of 512 token NLLs, which amplifies the
            backbone's bf16 rounding (printed, not held); so the loss bar
            holds each forward's per-slot summed NLL, and the grad-norm,
            dA and dB bars the gradients of the margin (each run's
            per-slot gradients divided by its own |d loss / d margin| = 1
            - exp(-loss)). The same planted faults must break the same
            bars.
14. DPO    — the slice's main path: BatchedExecutor(Z = 4,
            per_adapter_batch = 2, loss_kind = "dpo", PairSlotBatcher,
            EarlyExitConfig(0.25, 0.25), eval_every = 2).run_task on
            full-size stablelm-3b, 8 jobs (ranks 4/8/16/32 x lr 1e-4/1e-3),
            S = 256: two warmup waves with rotation, selection, continue.
            Every slot's first DPO loss must read log 2 within 1e-3 (B = 0:
            the policy is the reference); every train step must launch
            flash 192 times (two policy forwards with remat, two reference
            forwards), the rank-local xa/sb_add 896, ds/da/db 448, dx 442,
            every eval step flash 128 and xa/sb_add 448, the dense and
            ragged kernels never; the same measurements as phase 6, with
            flash attention's share of the device time.
14a. engine — the slice's main path: Listing 1 through the port's entry
            points. Engine(total_gpus = 2, eval_every = 2) on full-size
            stablelm-3b (its own backbone, random weights from seed 0)
            with three tasks at S = 256, max_steps = 8, Z from the memory
            model at the card's HBM_BYTES (num_slots = 0) and
            EarlyExit(0.25, 0.5): "rank-sweep" (ranks 8/32 x lr
            1e-4/1e-3, one GPU; the rank-local kernels), "lr-sweep" (rank
            64, lr 1e-4/1e-3 x weight decay 0/0.01, which Task.jobs()
            labels as two jobs, as the JAX package does; two GPUs; the
            dense kernels) and "mixed-batch" (rank 64, b 2 and 4, one GPU;
            the ragged kernels while both widths are resident).
            Engine.schedule(method = "cp") places them on the virtual
            cluster of 2 GPUs at the H100 constants; then
            batched_execution(strategy = "static"), then
            batched_execution elastic (the default: a one-shot
            TuningService session under the strict adoption rule, without
            co-location), from the same schedule. One card trains every
            task in turn; the strategies differ in the virtual timeline.
            Every train step must launch exactly one
            LoRA set at phase 6's counts and flash 64 times, every eval
            step one set's forward pair (224 each) and flash 32 times, the
            scan never; each strategy must launch all three sets. Each
            task's results (best job and value, every job's exit, steps,
            samples, loss and validation histories, the kept adapters)
            must be equal in both runs bit for bit, and the elastic
            virtual makespan no larger than the static one (the runtime's
            epsilon, 1e-9 s). The planner's HBM_BYTES must not exceed the
            card's memory. Printed: the placements with their analytic
            durations, each strategy's virtual makespan, utilization,
            replans and real tokens/s over its wall; per task Z, the
            memory model's M_hat(Z b) beside the measured peak, the
            analytic step time beside the observed wall step
            (ExecutorTaskDriver.observed_wall_step_s), real tokens/s.
14b. service — one live TuningService session on full-size stablelm-3b (its
            own backbone from seed 0): Engine(total_gpus = 2, eval_every =
            2) with the service's defaults (bounded-delay adoption at
            delta 2, co-location, fusion planning, migration), winners
            written under a temporary serve_dir, and phase 4's frontend
            shape (an empty AdapterPool of 4, 4 lanes, max_len 256) over
            the same backbone attached as a serving lease of one virtual
            GPU. Phase 14a's tasks under their names: rank-sweep (tenant-a)
            at 0, mixed-batch (tenant-b) at 0.25 x rank-sweep's admitted
            duration, lr-sweep (tenant-c, 2 GPUs) at 2 x, cancelled at
            0.25 x. Driven through the handles; then the lease is
            cancelled. Checked: the states (lr-sweep's result() raises
            TaskCancelled, it never trains); mixed-batch fused onto
            rank-sweep's replica, ending inside it; each completed task
            equal to phase 14a's static run bit for bit; two artifacts
            with rank, spec version, arch, fuse key and best job in their
            metadata, both published from the file (ADAPTER_PUBLISHED);
            8 greedy requests (4 per winner, prompts 32-128, 32 new) equal
            to a fresh pool holding the live winners, with the rank-local
            forward pair and no flash launch; the feedback loop's two
            observations of the key and its two step observations (the
            memory model's peak printed beside the card's); every step's
            launches as in 14a.
15. recovery — the DPO task of phase 14 at full width and 4 layers, run
            uninterrupted, then again with a TaskCheckpointer(every=1) as
            its ckpt_hook and a SimulatedCrash after the third durable
            checkpoint (the one exception caught, by type), then resumed
            from the latest file on a fresh executor with
            resume_task_chunks: the tail's per-step per-slot losses, every
            job's loss history, the best job, its value and the winner's
            adapter must equal the uninterrupted run's bit for bit, with
            fewer steps run; the same file with one AdamW moment of the
            uninterrupted run's winner perturbed must change the loss
            histories and the winner's adapter.
15a. service recovery — kill and recover through the service at full
            width and 4 layers: a task of 8 jobs (lr 1e-4/1e-3, rank
            8/32, b 2/4) on 4 slots, 12 steps a job, EarlyExit(0.2, 0.5),
            run by an uninterrupted session; then by a session with a
            state_dir (the write-ahead journal and a checkpoint every
            chunk) and a serve_dir that a SimulatedCrash ends after the
            third durable checkpoint; then TuningService.recover(state_dir,
            tasks, serve_frontend, device = "cuda"). The recovered result
            equals the uninterrupted one bit for bit with fewer steps, one
            TASK_RECOVERED "resumed"; the journal holds the session, one
            submit, the checkpoints and the task's end; the winner is
            published once from its artifact and served as the live winner
            on a fresh pool, also after the serving pod is replaced
            (republish_served). Control: a second crash with every
            snapshot trashed recovers by requeue, equal, with as many
            steps.

The stablelm-3b backbone is freed; the rwkv6-3b phases (32 layers, d_model
2560, 40 heads of 64, d_ff 8960, vocab 65536, scan chunk 128, bf16, random
weights from a seed; LoRA on r/k/v/g/o and ffn_k/ffn_v, 224 projections
per forward) follow:

16. scan kernel — the linear-scan kernel against its plain PyTorch version
            at the path's shapes (S = 256, chunk 128, K = V = 64, bf16
            q/k/v: the train step's B = Z*b*H = 640 rows and the eval
            step's 2,560), at hymba's SSD shape (K = 16, V = 64, no bonus),
            with an initial state, at the decay clip (logw = -e^4 every
            token), with the even channels at the clip and the odd ones
            near 0, and in fp32. The reading (largest |diff| of y and the
            final state in units of one bf16 rounding; fp32 y and the
            state: 1e-5 relative) must be <= 1, while three faults planted
            in the plain version (the state not carried across chunks, the
            bonus dropped, the causal mask off by one) must read > 1 (at
            the clip a state is forgotten within one token: the carry
            fault cannot show there); rows 0-127 of the B = 640 call must
            equal a B = 128 call bit for bit. Times (graph replay) of the
            kernel and the plain version beside the bound: the largest of
            the bytes over the memory rate, the kernel's exponentials
            (its pivoted form, ``scan_form_work``) over the
            special-function units' rate (16 a clock per SM at the card's
            maximum SM clock) and its multiply-adds over the fp32 rate;
            beside it the bound of the form with one exponential per
            visible pair. No single
            PyTorch call computes the function: no yardstick.
17. rwkv serve — 8 greedy requests (prompts of 16-48 tokens, 16 new) on 4
            adapters through AdapterPool -> ServingReplica ->
            ServingFrontend; the family streams prompts through the
            recurrent decode step: the linear-scan and flash kernels
            launch 0 times, the LoRA forward pair once per projection of
            every fused step; every join (lane reset) and every decode
            step leaves the other lanes' state bitwise untouched.
18. rwkv train — phase 5 on rwkv6-3b at full width, in fp32 (the
            kernels' fp32 instantiations): at its random init the
            backward amplifies rounding past any bar at full depth (the
            plain step against itself with 1e-7 noise on the scan's output
            reads as the kernels do; RWKV_GRAD_LAYERS), so at 32 layers
            the loss bar is held with the two forward faults (slot 0's
            delta halved; the bonus dropped from the plain scan) and the
            gradient readings are printed, and at 2 layers every bar and
            every planted fault of phase 5 is held. The kernel runs launch
            the linear-scan kernel twice per layer (forward and remat) and
            flash attention never. The backward of the scan is autograd
            through the plain version (as the JAX package's custom VJP),
            one chunk at a time (``torch.utils.checkpoint`` per chunk).
19. rwkv rank sweep — the slice's main path: phase 6 on rwkv6-3b at full
            width and depth (8 jobs, ranks 4/8/16/32 x lr 1e-4/1e-3, Z = 4,
            b = 4, S = 256): every fused train step must launch the
            rank-local xa/sb_add 448 times, ds/da/db 224, dx 220 (the
            first layer's r/k/v/g read the embedding's token-shift
            lerps), the linear scan 64 and flash 0; every eval step
            xa/sb_add 224 and the linear scan 32; the dense and ragged
            kernels never. The same measurements as phase 6, with the scan
            kernel's share of the device time.

The rwkv6-3b backbone is freed; the hymba-1.5b phases (32 layers, d_model
1600, 25 heads of 64 with 5 KV heads, sliding window 1,024, d_ff 5504,
vocab 32001, a Mamba branch of 50 heads of 64 with state 16 and scan chunk
128, bf16, random weights from a seed; LoRA on in_proj, q/k/v/o and
gate/up/down, 256 projections per forward) follow, at S = 2,048 so that
the window binds in every forward:

20. hymba kernels — the six rank-local kernels against their plain
            versions at the train step's T = 2 x 2,048 rows a slot, ranks
            4/8/16/32 of r_max 64, at each projection's din x dout (1600 x
            1600, 1600 x 320, 1600 x 6400, 1600 x 5504, 5504 x 1600), timed
            beside the bound and ``torch.bmm``; at full rank the dense,
            ragged (rows = T) and rank-local kernels bit for bit equal at
            each shape; flash attention (bf16, hd 64, window 1,024, S
            2,048; B = 200 for a train step, 400 for an eval step) with
            phase 3b's bars and faults plus the window one key wider, and
            batch independence; the scan in SSD mode (K 16, V 64, no bonus,
            chunk 128, S 2,048; B = 400 and 800) with phase 16's bars and
            faults and batch independence. SDPA with the band as a boolean
            mask is flash's yardstick.
21. hymba serve — phase 17 on hymba-1.5b over ring caches of 1,024 slots:
            prompts stream through the decode step (no block prefill), so
            the scan and flash launch 0 times; every join (lane reset) and
            every decode step leaves the other lanes' K/V, k_pos, conv and
            ssm state bitwise untouched (phase 17 holds the same for
            rwkv6-3b's state).
22. hymba train — phase 5 on hymba-1.5b at S = 2,048, b = 2, in fp32 at
            full width and depth (the kernels' fp32 instantiations): every
            bar and every planted fault of phase 5 (the loss bar an fp32
            one, HYMBA_LOSS_REL), with two more forward faults that must
            break the loss bar: the plain scan's decay applied before the
            query reads the state (RWKV's order), and every query seeing
            one key beyond the window. Unlike rwkv6-3b's, hymba's backward
            at random init does not amplify rounding (the kernels read
            8e-06 on dA / dB at 32 layers). The kernel runs launch flash
            and the scan twice per layer each.
23. hymba rank sweep — the slice's main path: phase 6 on hymba-1.5b at full
            width and depth (8 jobs, ranks 4/8/16/32 x lr 1e-4/1e-3, Z = 4,
            b = 2, S = 2,048, eval b = 4): every fused train step must
            launch the rank-local xa/sb_add 512 times, ds/da/db 256, dx
            252 (the first layer's q/k/v and in_proj read the normed
            embedding), flash 64 and the scan 64; every eval step xa/sb_add
            256, flash 32 and the scan 32; the dense and ragged kernels
            never. The same measurements as phase 6, with flash's and the
            scan's shares of the device time.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
kernel table as JSON (twenty kernels), with each kernel's launches by
path (``engine_static`` and ``engine_elastic`` for the engine phase's two
runs, ``service`` and ``service_recovery`` for the service's trainings,
``service_serve`` for its served requests).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's dense bf16 tensor-core peak and HBM3 bandwidth (NVIDIA data
# sheet): main() reads them from repro_torch.sched.profiler, so that the
# bounds and the engine's planner use one copy of the numbers
H100_BF16_FLOPS = H100_BYTES_S = None
H100_FP32_FLOPS = 67e12       # fp32 outside the tensor cores (data sheet)
# instantiations of each kernel template, (bf16, fp32): every bf16 one
# holds tensor-core (HMMA) instructions, no fp32 one does. narrow_out: xa
# and ds of three sets at two tiles, fp32 one in each of the four sources;
# tn: da and db of three sets; rank_sum: sb_add and dx of three sets at two
# tiles (bf16) or one (fp32); flash: one per head dim
TC_INSTANTIATIONS = {"narrow_out_kernel": (12, 4), "tn_kernel": (6, 6),
                     "rank_sum_kernel": (12, 6), "flash_fwd_kernel": (5, 5)}

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

# training: 4 slots at these true ranks (r_max 64), b sequences of S tokens
TRAIN_RANKS = (4, 8, 16, 32)
TRAIN_B, TRAIN_S = 4, 256
# the full-rank learning-rate sweep: every slot at r_max 64
FULL_RANKS = (64, 64, 64, 64)
# layers of the co-located == solo phases (full width, depth cut for time)
COLO_LAYERS = 4
# layers of the lr sweep (full width; cut from 32 so that the rwkv6-3b
# phases fit in half the script's time limit)
LR_SWEEP_LAYERS = 8
# token rows per slot of the executor's b = 4 / b = 2 mix (S = 256), and a
# pattern with a boundary inside a tile and an empty slot
RAGGED_ROWS = (1024, 512, 1024, 512)
RAGGED_EDGE_ROWS = (1024, 300, 0, 1024)
ROW_TILE = 32         # token rows the ragged train check's tile fault drops
EVAL_B = 16                   # sequences per slot in an executor eval step
# backward kernels with fp32 outputs (dA, dB), kernel vs plain: both sum
# the same 1,024 bf16 products per entry in fp32, in another order, so an
# entry may differ by a few fp32 roundings of the running sum:
# |diff| <= 1e-4 * |plain| + 1e-5 * max|plain|
GRAD_KERNEL_RTOL = 1e-4
GRAD_KERNEL_ATOL_REL = 1e-5
# flash attention, kernel vs plain: both take the same fp32 scores and
# weights to the output in another order (online vs two-pass softmax) and
# round once, so a bf16 output may land on the neighbouring bf16 value:
# |diff| <= 2**-7 * |plain| + 1e-5 * max|plain| (fp32 outputs: 1e-5
# relative). The phase prints the largest |diff| in units of that bar.
FLASH_RTOL = {"bf16": 2 ** -7, "fp32": 1e-5}
FLASH_ATOL_REL = 1e-5
# linear scan, kernel vs plain: both take the same fp32 terms to y in
# another order and round once, so a bf16 y may land on the neighbouring
# bf16 value: |diff| <= 2**-7 |plain| + 1e-5 max|plain| (fp32 y and the
# final state: 1e-5 relative)
SCAN_RTOL = {"bf16": 2 ** -7, "fp32": 1e-5}
SCAN_ATOL_REL = 1e-5
SFU_PER_CLOCK_SM = 16         # exponentials per clock per SM (cc 9.0)
# rwkv6-3b's backward at its random init amplifies rounding past any bar:
# at full depth in fp32 the plain |dB| falls from ~2e6 at layer 0 to ~1 at
# the top, and the plain step against itself with the scan's y moved by
# 1e-7 relative reads per-slot gradient gaps of 0.3-10, as large as the
# kernels' 0.2-5.5 (phase 18 prints both; PERF.md). Its train check
# therefore runs in fp32 at full width twice: at full depth holding the
# loss bar and the forward faults, and at RWKV_GRAD_LAYERS layers, where
# the kernels read <= 3.6e-4 against the 0.05 gradient bars, holding every
# bar and every fault
RWKV_GRAD_LAYERS = 2
# hymba-1.5b's paths: S = 2048 (its sliding window of 1024 binds in every
# forward), b = 2 sequences a slot in a train step, HYMBA_EVAL_B in an eval
# step; its LoRA projections (din, dout): q/o, k/v, in_proj, gate/up, down
HYMBA_S, HYMBA_B, HYMBA_EVAL_B = 2048, 2, 4
HYMBA_SHAPES = ((1600, 1600), (1600, 320), (1600, 6400), (1600, 5504),
                (5504, 1600))
# hymba-1.5b's train check runs in fp32 at full depth (its backward at
# random init does not amplify rounding as rwkv6-3b's does: on an NVIDIA
# H100 80GB HBM3 at 700 W the kernels read at most 8.8e-08 on the loss,
# one fp32 rounding of it, and 8.1e-06 on dA / dB against the 0.05 bars),
# so its loss bar is an fp32 one: 2e-6 sits between that reading and the
# mildest planted forward fault's (slot 0's rank-4 delta halved, 6.6e-05;
# see PERF.md)
HYMBA_LOSS_REL = 2e-6
# hymba-1.5b's ring past its wrap: two lanes prefilled with RING_PREFILL
# tokens, then one lane decodes RING_STEPS more (positions 1,000-1,063: the
# ring of 1,024 slots wraps after 24 steps), in fp32; its logits against
# the full forward's, as max |diff| / max |forward|
RING_PREFILL, RING_STEPS = 1000, 64
RING_LOGITS_REL = 1e-4
DPO_B = 2                     # preference pairs per slot in the DPO phase
RECOVERY_STEPS = 12           # steps per job of the recovery phase's task
ENGINE_G = 2                  # GPUs of the engine phase's virtual cluster
# virtual seconds per chunk of the service phase's serving lease: finer
# than the tasks' chunks (0.12-0.24 s), since the runtime admits an
# arrival only once its clock passes it, and the lease's default 60 s
# chunks carry that clock to 60 s before mixed-batch's arrival at 0.24 s
LEASE_CHUNK_S = 0.05
# full-size train step, kernels vs plain versions, per slot and relative
# to the plain run: |loss diff|, |grad-norm diff|, and the RMS of the dA
# (dB) differences over all 224 projections over the RMS of dA (dB). The
# one-ulp bf16 differences of the kernels compound through 32 layers
# forward and backward. The loss bar guards the forward: it sits between
# the sound reading and that of a planted forward fault (slot 0's delta
# halved), which must break it. On an H100, with every bf16 LoRA kernel
# and the flash forward on the tensor cores, the sound run reads at most
# (the fault in brackets): rank-local, ranks 4-32 and slot 0 at rank 4,
# 1.142e-04 (1.647e-03); dense, r = 64, 9.505e-05 (5.858e-03); ragged
# 1.723e-04 (5.858e-03; the narrow slots' dead tile 8.199e-04); DPO
# 1.836e-04 (1.256e-03); dA and dB at most 0.03733, against 0.05. With
# sb_add, dx and flash still on the FMA units they read 1.098e-04,
# 1.065e-04, 1.899e-04, 1.842e-04 and 0.03744 on the same seeds: the
# readings are set by the whole step's bf16 rounding, not by one kernel
# (PERF.md).
TRAIN_LOSS_REL = 3e-4
TRAIN_NORM_REL = 0.05
TRAIN_GRAD_REL_RMS = 0.05


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


def bound(nbytes: float, flops: float, peak: float | None = None):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the flops over the peak rate of
    the inputs' type (bf16 unless ``peak`` says otherwise)."""
    peak = H100_BF16_FLOPS if peak is None else peak
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def tensor_core_check(libs) -> None:
    """The machine code (``cuobjdump``) of the grouped-LoRA and the
    flash-attention libraries: every bf16 instantiation of the templates in
    ``TC_INSTANTIATIONS`` holds tensor-core (HMMA) instructions, no fp32 one
    does, no instantiation spills to local memory, and each template has
    exactly the instantiations listed; prints each one's HMMA count,
    registers and local bytes."""
    from repro_torch.kernels.nvcc import nvcc

    tool = str(Path(nvcc()).with_name("cuobjdump"))
    seen = {t: [0, 0] for t in TC_INSTANTIATIONS}
    for lib in libs:
        hmma, fn = {}, None
        for line in sh(tool, "-sass", str(lib)).splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                hmma[fn] = 0
            elif fn is not None and "HMMA" in line:
                hmma[fn] += 1
        usage = dict(re.findall(r"Function (\S+):\s*\n\s*(REG:\d+ "
                                r"STACK:\d+ SHARED:\d+ LOCAL:\d+)",
                                sh(tool, "-res-usage", str(lib))))
        for name in sorted(hmma):
            tmpl = next((t for t in TC_INSTANTIATIONS if t in name), None)
            if tmpl is None:
                continue
            at = name.find(tmpl)
            bf16 = f"{tmpl}I13__nv_bfloat16" in name
            res = usage.get(name, "no resource line")
            require(bf16 == (hmma[name] > 0),
                    f"{name}: {hmma[name]} HMMA instructions")
            require(res.endswith(" LOCAL:0"), f"{name}: {res}")
            seen[tmpl][0 if bf16 else 1] += 1
            print(f"build: {name[at:].split('EEv')[0]}> (mangled) HMMA "
                  f"{hmma[name]} {res}")
    for tmpl, (n_bf16, n_fp32) in seen.items():
        print(f"build: {n_bf16} bf16 {tmpl} instantiations with HMMA, "
              f"{n_fp32} fp32 ones without")
    require({t: tuple(n) for t, n in seen.items()} == TC_INSTANTIATIONS,
            f"instantiations (bf16, fp32) {seen}, expected "
            f"{TC_INSTANTIATIONS}")


def scan_resource_check(lib) -> None:
    """The machine code (``cuobjdump -res-usage``) of the linear-scan
    library: both instantiations of ``linear_scan_kernel`` are there and
    neither spills to local memory; prints each one's registers and local
    bytes."""
    from repro_torch.kernels.nvcc import nvcc

    tool = str(Path(nvcc()).with_name("cuobjdump"))
    usage = dict(re.findall(r"Function (\S*linear_scan_kernel\S*):\s*\n\s*"
                            r"(REG:\d+ STACK:\d+ SHARED:\d+ LOCAL:\d+)",
                            sh(tool, "-res-usage", str(lib))))
    for name, res in sorted(usage.items()):
        kind = "bf16" if "__nv_bfloat16" in name else "fp32"
        print(f"build: linear_scan_kernel<{kind}> {res}")
        require(res.endswith(" LOCAL:0"), f"{name}: {res}")
    require(len(usage) == 2, f"linear_scan_kernel instantiations: "
            f"{sorted(usage)}")


def device_events(torch, prof):
    """(name, us) of every device event of a finished torch.profiler run,
    read from the profiler's raw Kineto events: parsing them into
    FunctionEvents (``prof.events()``), which builds the whole CPU op tree
    too, is far slower at a hymba-1.5b train step's ~10^5 events."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), (e.end_ns() - e.start_ns()) / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


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


def kernel_phase(torch, RL, ref, cases=None, timed=None):
    """The forward pair against its plain versions at the serving shapes
    and the executor's eval-step shape (T = 4,096 rows per slot); returns
    per-kernel results at the decode shape the serving path launches most
    (T = lanes, din = dout = d_model = 2560; the eval step's 2560 -> 6912
    under ``shapes["eval"]``) and prints every case. ``cases`` replaces
    the shapes and ``timed`` maps the (label, din, dout) whose times are
    kept to their key under ``shapes``."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(1)
    Z, r = 4, 64
    timed = timed or {("decode", 2560, 2560): None,
                      ("eval", 2560, 6912): "eval"}
    cases = cases or [  # (label, T, din, dout, ranks, rows)
        ("decode", LANES, 2560, 2560, RANKS, None),
        ("decode", LANES, 2560, 6912, RANKS, None),
        ("decode", LANES, 6912, 2560, RANKS, None),
        ("prefill", LANES * 128, 2560, 2560, RANKS, None),
        ("prefill", LANES * 128, 6912, 2560, RANKS, None),
        ("edge", LANES * 128, 2560, 6912, (0, 13, 32, 64),
         (LANES * 128, LANES * 128 - 1, 200, 7)),
        # the executor's eval step: [Z, EVAL_B, TRAIN_S] tokens per slot
        ("eval", EVAL_B * TRAIN_S, 2560, 6912, TRAIN_RANKS, None),
        ("eval", EVAL_B * TRAIN_S, 6912, 2560, TRAIN_RANKS, None),
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
            bound_ms, bound_by = bound(*work[name])
            print(f"{name:7s} {label:8s} {T:4d} {din:5d} {dout:5d}  "
                  f"{str(ranks_t):16s} {str(rows_t):15s} {ms:9.5f} "
                  f"{plain_ms:9.5f} {lib_ms:9.5f}  {bound_ms:9.6f} "
                  f"{bound_by:10s} {errs[name]:.3g}  | eager {eager_ms:.5f} "
                  f"{plain_eager:.5f} {lib_eager:.5f}")
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], errs[name])
            times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
            if (label, din, dout) not in timed:
                continue
            key = timed[label, din, dout]
            if key is None:
                res.update(times)
            else:
                res.setdefault("shapes", {})[key] = times
        del xs, As, Bs, As_lib, Bs_lib, ss
        torch.cuda.empty_cache()
    return results


def serve_phase(torch, RL, cfg, params):
    """Serve N_REQ requests on ``cfg`` with backbone ``params``
    (stablelm-3b at full size in ``main``) on the card."""
    import numpy as np

    from repro_torch.core import lora as LORA
    from repro_torch.core.steps import make_join_decode_step
    from repro_torch.data.synthetic import make_task_dataset
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import model as M
    from repro_torch.serve import (AdapterPool, ServingFrontend,
                                   ServingReplica)

    dev = "cuda"
    sync = torch.cuda.synchronize
    Z = len(RANKS)
    t0 = time.perf_counter()
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
          f"max_len={MAX_LEN}; adapters {time.perf_counter() - t0:.1f} s")

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
    FA.reset_launches()
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
    # prefill into the longer cache and decode: no contiguous causal forward
    launches.update(FA.LAUNCHES)
    require(launches["flash_attention"] == 0,
            f"serving launched flash attention {FA.LAUNCHES}")
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
    for name, us_e in device_events(torch, prof):
        n, us = kernels.get(name, (0, 0.0))
        kernels[name] = (n + 1, us + us_e)
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


def backward_kernel_phase(torch, RL, ref, cases=None,
                          timed=("train", 2560, 2560)):
    """The four backward kernels, and the forward pair, against their
    plain versions at the training shapes (Z = 4 slots, T = TRAIN_B *
    TRAIN_S = 1024 token rows per slot, d in {2560, 6912}, true ranks
    4/8/16/32 of r_max 64, bf16 activations, fp32 masters with garbage
    past each rank) and at the DPO step's shapes (T = DPO_B * TRAIN_S =
    512 rows per slot in each policy forward; checked, not timed); returns
    per-kernel results (times of the backward four at the q/k/v/o shape,
    din = dout = 2560; the forward pair's there under ``shapes["train"]``)
    and prints every case. ``cases`` replaces the shapes: then the times of
    all six at ``timed`` (label, din, dout) go under ``shapes[label]``."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(2)
    Z, r = len(TRAIN_RANKS), 64
    T_train, T_dpo = TRAIN_B * TRAIN_S, DPO_B * TRAIN_S
    cases = cases or [  # (label, T, din, dout, ranks, rows)
        ("train", T_train, 2560, 2560, TRAIN_RANKS, None),
        ("train", T_train, 2560, 6912, TRAIN_RANKS, None),
        ("train", T_train, 6912, 2560, TRAIN_RANKS, None),
        ("ragged", T_train, 2560, 6912, TRAIN_RANKS,
         (T_train, T_train - TRAIN_S, 300, 0)),
        ("dpo", T_dpo, 2560, 2560, TRAIN_RANKS, None),
        ("dpo", T_dpo, 2560, 6912, TRAIN_RANKS, None),
        ("dpo", T_dpo, 6912, 2560, TRAIN_RANKS, None),
    ]
    results = {}
    print("backward kernels, times in ms per call (graph replay)")
    print("kernel  case     din   dout  rows                    ms        "
          "plain_ms  library_ms bound_ms  bound_by   max_abs_err")
    for label, T, din, dout, ranks_t, rows_t in cases:
        ranks = torch.tensor(ranks_t, dtype=torch.int32, device=dev)
        rows = (None if rows_t is None else
                torch.tensor(rows_t, dtype=torch.int32, device=dev))
        nrows = [T] * Z if rows_t is None else list(rows_t)
        live = [rk if nr else 0 for rk, nr in zip(ranks_t, nrows)]
        # two copies of the activations (2 x 4 x 1024 x 6912 bf16 = 113 MB,
        # more than the 50 MB L2), so a timing loop reads them from memory
        xs = [torch.randn(Z, T, din, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        dys = [torch.randn(Z, T, dout, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(2)]
        A = torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
        B = torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
        scale = torch.full((Z,), 2.0, device=dev)
        keep = (torch.arange(r, device=dev)[None, :] < ranks[:, None])
        A_lib = (A * keep[:, None, :]).to(torch.bfloat16).transpose(1, 2)
        B_lib = (B * keep[:, :, None]).to(torch.bfloat16).transpose(1, 2)
        ss = [RL.xa(x, A, rows, ranks) for x in xs]
        dss = [RL.ds(dy, B, scale, rows, ranks) for dy in dys]
        torch.cuda.synchronize()
        s, x, dy, dS = ss[0], xs[0], dys[0], dss[0]
        # --- correctness: the forward pair as a train step launches it
        # (the Function's forward and each layer's recompute), then the
        # backward four
        y = RL.sb_add(s, B, scale, rows, ranks)
        outs = {"xa": (s, ref.ranklocal_xa_ref(x, A, rows, ranks)),
                "sb_add": (y, ref.ranklocal_sb_add_ref(s, B, scale, rows,
                                                       ranks)),
                "ds": (dS, ref.ranklocal_ds_ref(dy, B, scale, rows, ranks)),
                "dx": (RL.dx(dS, A, rows, ranks),
                       ref.ranklocal_dx_ref(dS, A, rows, ranks)),
                "da": (RL.da(x, dS, rows, ranks),
                       ref.ranklocal_da_ref(x, dS, rows, ranks)),
                "db": (RL.db(s, dy, scale, rows, ranks),
                       ref.ranklocal_db_ref(s, dy, scale, rows, ranks))}
        torch.cuda.synchronize()
        errs = {}
        for name, (out, want) in outs.items():
            o, w = out.float(), want.float()
            bf16_out = name in ("xa", "sb_add", "ds", "dx")
            torch.testing.assert_close(
                o, w, rtol=KERNEL_RTOL if bf16_out else GRAD_KERNEL_RTOL,
                atol=(KERNEL_ATOL_REL if bf16_out else GRAD_KERNEL_ATOL_REL)
                * float(w.abs().max()), msg=f"{name} {label} {din}x{dout}")
            errs[name] = float((o - w).abs().max())
        for name, err in errs.items():
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], err)
        for z in range(Z):                   # exact zeros where nothing lives
            rk, nr = live[z], nrows[z]
            require(bool((outs["xa"][0][z, :, rk:] == 0).all()
                         and (outs["xa"][0][z, nr:] == 0).all()),
                    "xa: padded rank region or dead rows not exactly 0")
            require(bool((outs["sb_add"][0][z, nr:] == 0).all()
                         and (rk or (outs["sb_add"][0][z] == 0).all())),
                    "sb_add: dead rows or dead slot not exactly 0")
            require(bool((outs["ds"][0][z, :, rk:] == 0).all()
                         and (outs["ds"][0][z, nr:] == 0).all()),
                    "ds: padded rank region or dead rows not exactly 0")
            require(bool((outs["dx"][0][z, nr:] == 0).all()),
                    "dx: dead rows not exactly 0")
            require(bool((outs["da"][0][z, :, rk:] == 0).all()),
                    "da: columns past the rank not exactly 0")
            require(bool((outs["db"][0][z, rk:] == 0).all()),
                    "db: rows past the rank not exactly 0")
        print(f"xa, sb_add {label:8s} {din:5d} {dout:5d}  {str(rows_t):22s} "
              f"max_abs_err {errs['xa']:.3g}, {errs['sb_add']:.3g} (within "
              f"one bf16 ulp of the plain versions)")
        del outs, y
        if label == "dpo":
            print(f"ds, dx, da, db {label} T={T} {din:5d} {dout:5d}  "
                  f"max_abs_err " + ", ".join(
                      f"{errs[n]:.3g}" for n in ("ds", "dx", "da", "db"))
                  + " (within the bars; not timed)")
            del xs, dys, ss, dss
            torch.cuda.empty_cache()
            continue
        # --- timing, alternating between the two activation copies
        timing = {
            "xa": (lambda i: RL.xa(xs[i % 2], A, rows, ranks),
                   lambda i: ref.ranklocal_xa_ref(xs[i % 2], A, rows, ranks),
                   lambda i: torch.bmm(xs[i % 2], A_lib.transpose(1, 2))),
            "sb_add": (lambda i: RL.sb_add(ss[i % 2], B, scale, rows, ranks),
                       lambda i: ref.ranklocal_sb_add_ref(
                           ss[i % 2], B, scale, rows, ranks),
                       lambda i: torch.bmm(ss[i % 2], B_lib.transpose(1, 2))),
            "ds": (lambda i: RL.ds(dys[i % 2], B, scale, rows, ranks),
                   lambda i: ref.ranklocal_ds_ref(dys[i % 2], B, scale, rows,
                                                  ranks),
                   lambda i: torch.bmm(dys[i % 2], B_lib)),
            "dx": (lambda i: RL.dx(dss[i % 2], A, rows, ranks),
                   lambda i: ref.ranklocal_dx_ref(dss[i % 2], A, rows, ranks),
                   lambda i: torch.bmm(dss[i % 2], A_lib)),
            "da": (lambda i: RL.da(xs[i % 2], dss[i % 2], rows, ranks),
                   lambda i: ref.ranklocal_da_ref(xs[i % 2], dss[i % 2],
                                                  rows, ranks),
                   lambda i: torch.bmm(xs[i % 2].transpose(1, 2),
                                       dss[i % 2])),
            "db": (lambda i: RL.db(ss[i % 2], dys[i % 2], scale, rows,
                                   ranks),
                   lambda i: ref.ranklocal_db_ref(ss[i % 2], dys[i % 2],
                                                  scale, rows, ranks),
                   lambda i: torch.bmm(ss[i % 2].transpose(1, 2),
                                       dys[i % 2])),
        }
        # the bytes each function must move (inputs read once, outputs
        # written once, live rows/ranks only) and its flops
        sum_rr = sum(rk * nr for rk, nr in zip(live, nrows))
        rows_x = sum(nr for nr, rk in zip(nrows, live) if rk)
        work = {
            "xa": (rows_x * din * 2 + sum(live) * din * 4 + Z * T * r * 2,
                   2 * sum_rr * din),
            "sb_add": (sum_rr * 2 + sum(live) * dout * 4 + Z * T * dout * 2,
                       2 * sum_rr * dout),
            "ds": (rows_x * dout * 2 + sum(live) * dout * 4 + Z * T * r * 2,
                   2 * sum_rr * dout),
            "dx": (sum_rr * 2 + sum(live) * din * 4 + Z * T * din * 2,
                   2 * sum_rr * din),
            "da": (rows_x * din * 2 + sum_rr * 2 + Z * din * r * 4,
                   2 * sum_rr * din),
            "db": (sum_rr * 2 + rows_x * dout * 2 + Z * r * dout * 4,
                   2 * sum_rr * dout),
        }
        for name, (kern, plain, lib) in timing.items():
            ms, _ = time_ms(torch, kern, 10)
            plain_ms, _ = time_ms(torch, plain, 10)
            lib_ms, _ = time_ms(torch, lib, 10)
            bound_ms, bound_by = bound(*work[name])
            print(f"{name:7s} {label:8s} {din:5d} {dout:5d}  "
                  f"{str(rows_t):22s} {ms:9.5f} {plain_ms:9.5f} "
                  f"{lib_ms:9.5f}  {bound_ms:9.6f} {bound_by:10s} "
                  f"{errs[name]:.3g}")
            if (label, din, dout) != timed:
                continue
            times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
            if name in ("xa", "sb_add") or label != "train":
                # xa, sb_add: their rows are decode's
                results[name].setdefault("shapes", {})[label] = times
            else:
                results[name].update(times)
        del xs, dys, ss, dss, timing
        torch.cuda.empty_cache()
    return results


def dense_kernel_phase(torch, GL, RL, ref):
    """The six dense kernels at the shapes the lr sweep gives them (Z = 4
    slots at r = r_max = 64, T = 1,024 token rows per slot, din x dout in
    {2560 x 2560, 2560 x 6912, 6912 x 2560}; the forward pair also at the
    eval step's T = 4,096; bf16 activations, fp32 masters, non-zero B, a
    different scale per slot): each against its plain version (sb_add with
    and without a base), and bit for bit against its rank-local twin called
    with ranks = (64, 64, 64, 64), rows None, on the same inputs. Times
    (graph replay) of the kernel, the plain version, the rank-local twin
    and a ``torch.bmm`` yardstick; returns per-kernel results (times at
    T = 1,024, din = dout = 2560)."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(4)
    Z, r, T = 4, 64, TRAIN_B * TRAIN_S
    every = ("xa", "sb_add", "ds", "dx", "da", "db")
    cases = [  # (label, T, din, dout, kernels)
        ("train", T, 2560, 2560, every),
        ("train", T, 2560, 6912, every),
        ("train", T, 6912, 2560, every),
        ("eval", EVAL_B * TRAIN_S, 2560, 6912, every[:2]),
        ("eval", EVAL_B * TRAIN_S, 6912, 2560, every[:2]),
    ]
    full = torch.full((Z,), r, dtype=torch.int32, device=dev)
    scale = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
    results = {}
    print("dense kernels (every slot at r = 64), times in ms per call "
          "(graph replay); 'twin' = the rank-local kernel at ranks 64")
    print("kernel  case     T     din   dout  ms        plain_ms  twin_ms   "
          "library_ms bound_ms  bound_by   max_abs_err  bitwise")
    for label, T_, din, dout, names in cases:
        # two copies of the activations (more than the 50 MB L2), so a
        # timing loop reads them from memory
        xs = [torch.randn(Z, T_, din, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        dys = [torch.randn(Z, T_, dout, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(2)]
        base = torch.randn(Z, T_, dout, generator=gen,
                           device=dev).to(torch.bfloat16)
        A = torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
        B = torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
        A_lib = A.to(torch.bfloat16)
        B_lib = B.to(torch.bfloat16)
        ss = [GL.xa(x, A) for x in xs]
        dss = [GL.ds(dy, B, scale) for dy in dys]
        x, dy, s, dS = xs[0], dys[0], ss[0], dss[0]
        # --- correctness: kernel vs plain version, and vs the twin
        outs = {  # name: (dense kernel, rank-local twin, plain version)
            "xa": (s, RL.xa(x, A, None, full), ref.grouped_xa_ref(x, A)),
            "sb_add": (GL.sb_add(s, B, scale),
                       RL.sb_add(s, B, scale, None, full),
                       ref.grouped_sb_add_ref(s, B, scale)),
            "sb_add+base": (GL.sb_add(s, B, scale, base),
                            RL.sb_add(s, B, scale, None, full, base),
                            ref.grouped_sb_add_ref(s, B, scale, base)),
        }
        if "ds" in names:
            outs.update({
                "ds": (dS, RL.ds(dy, B, scale, None, full),
                       ref.grouped_ds_ref(dy, B, scale)),
                "dx": (GL.dx(dS, A), RL.dx(dS, A, None, full),
                       ref.grouped_dx_ref(dS, A)),
                "da": (GL.da(x, dS), RL.da(x, dS, None, full),
                       ref.grouped_da_ref(x, dS)),
                "db": (GL.db(s, dy, scale), RL.db(s, dy, scale, None, full),
                       ref.grouped_db_ref(s, dy, scale))})
        torch.cuda.synchronize()
        errs = {}
        for name, (out, twin, want) in outs.items():
            require(torch.equal(out, twin),
                    f"dense {name} {label} {din}x{dout} differs from its "
                    f"rank-local twin at ranks 64 (max |diff| "
                    f"{float((out.float() - twin.float()).abs().max()):.3g})")
            o, w = out.float(), want.float()
            bf16_out = name not in ("da", "db")
            torch.testing.assert_close(
                o, w, rtol=KERNEL_RTOL if bf16_out else GRAD_KERNEL_RTOL,
                atol=(KERNEL_ATOL_REL if bf16_out else GRAD_KERNEL_ATOL_REL)
                * float(w.abs().max()), msg=f"dense {name} {label} "
                f"{din}x{dout}")
            errs[name] = float((o - w).abs().max())
        require(bool(torch.isfinite(outs["sb_add"][0]).all()),
                "dense sb_add output not finite")
        print(f"sb_add+base {label:6s} {T_:5d} {din:5d} {dout:5d}  "
              f"max_abs_err {errs.pop('sb_add+base'):.3g}, bitwise equal to "
              f"the twin")
        del outs
        # --- timing, alternating between the two activation copies
        timing = {
            "xa": (lambda i: GL.xa(xs[i % 2], A),
                   lambda i: ref.grouped_xa_ref(xs[i % 2], A),
                   lambda i: RL.xa(xs[i % 2], A, None, full),
                   lambda i: torch.bmm(xs[i % 2], A_lib)),
            "sb_add": (lambda i: GL.sb_add(ss[i % 2], B, scale),
                       lambda i: ref.grouped_sb_add_ref(ss[i % 2], B, scale),
                       lambda i: RL.sb_add(ss[i % 2], B, scale, None, full),
                       lambda i: torch.bmm(ss[i % 2], B_lib)),
            "ds": (lambda i: GL.ds(dys[i % 2], B, scale),
                   lambda i: ref.grouped_ds_ref(dys[i % 2], B, scale),
                   lambda i: RL.ds(dys[i % 2], B, scale, None, full),
                   lambda i: torch.bmm(dys[i % 2], B_lib.transpose(1, 2))),
            "dx": (lambda i: GL.dx(dss[i % 2], A),
                   lambda i: ref.grouped_dx_ref(dss[i % 2], A),
                   lambda i: RL.dx(dss[i % 2], A, None, full),
                   lambda i: torch.bmm(dss[i % 2], A_lib.transpose(1, 2))),
            "da": (lambda i: GL.da(xs[i % 2], dss[i % 2]),
                   lambda i: ref.grouped_da_ref(xs[i % 2], dss[i % 2]),
                   lambda i: RL.da(xs[i % 2], dss[i % 2], None, full),
                   lambda i: torch.bmm(xs[i % 2].transpose(1, 2),
                                       dss[i % 2])),
            "db": (lambda i: GL.db(ss[i % 2], dys[i % 2], scale),
                   lambda i: ref.grouped_db_ref(ss[i % 2], dys[i % 2],
                                                scale),
                   lambda i: RL.db(ss[i % 2], dys[i % 2], scale, None, full),
                   lambda i: torch.bmm(ss[i % 2].transpose(1, 2),
                                       dys[i % 2])),
        }
        # the bytes each function must move (each input read once, each
        # output written once: one [Z,T,d] bf16 activation, the [Z,T,r] bf16
        # narrow operand, one fp32 master) and its flops
        act_in, act_out, narrow = Z * T_ * din * 2, Z * T_ * dout * 2, \
            Z * T_ * r * 2
        a_mst, b_mst = Z * din * r * 4, Z * r * dout * 4
        fl_in, fl_out = 2 * Z * T_ * r * din, 2 * Z * T_ * r * dout
        work = {"xa": (act_in + a_mst + narrow, fl_in),
                "sb_add": (narrow + b_mst + act_out, fl_out),
                "ds": (act_out + b_mst + narrow, fl_out),
                "dx": (narrow + a_mst + act_in, fl_in),
                "da": (act_in + narrow + a_mst, fl_in),
                "db": (narrow + act_out + b_mst, fl_out)}
        for name in names:
            kern, plain, twin, lib = timing[name]
            ms, _ = time_ms(torch, kern, 10)
            plain_ms, _ = time_ms(torch, plain, 10)
            twin_ms, _ = time_ms(torch, twin, 10)
            lib_ms, _ = time_ms(torch, lib, 10)
            bound_ms, bound_by = bound(*work[name])
            print(f"{name:7s} {label:6s} {T_:5d} {din:5d} {dout:5d}  "
                  f"{ms:9.5f} {plain_ms:9.5f} {twin_ms:9.5f} {lib_ms:9.5f}  "
                  f"{bound_ms:9.6f} {bound_by:10s} {errs[name]:.3g}  yes")
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res["max_abs_err"], errs[name])
            if (label, din, dout) == ("train", 2560, 2560):
                res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=bound_ms, bound_by=bound_by)
        del xs, dys, ss, dss, timing, base
        torch.cuda.empty_cache()
    return results


def ragged_kernel_phase(torch, RG, GL, RL, ref):
    """The six ragged kernels at the shapes the heterogeneous co-location
    gives them (Z = 4 slots at r = 64, T = 1,024 token rows per slot, din x
    dout in {2560 x 2560, 2560 x 6912, 6912 x 2560}, bf16 activations, fp32
    masters, non-zero B, a different scale per slot), at rows RAGGED_ROWS
    (the executor's b = 4 / b = 2 mix) and RAGGED_EDGE_ROWS (a boundary
    inside a tile, an empty slot): each against its plain version (sb_add
    with and without a base; exact zeros and the base passed through on
    dead rows), bit for bit against its rank-local twin at ranks (64, 64,
    64, 64) with the same rows, and at rows = T bit for bit against its
    dense twin, on the same inputs. Times (graph replay) at RAGGED_ROWS of
    the kernel, its plain version, the dense twin (every row), the ragged
    kernel at rows = T and a ``torch.bmm`` yardstick, beside the bound at
    the live rows; returns per-kernel results (times at din = dout =
    2560)."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    Z, r, T = 4, 64, TRAIN_B * TRAIN_S
    full = torch.full((Z,), r, dtype=torch.int32, device=dev)
    every = torch.full((Z,), T, dtype=torch.int32, device=dev)
    scale = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
    names = ("xa", "sb_add", "ds", "dx", "da", "db")
    results = {}
    print(f"ragged kernels (every slot at r = 64, T = {T}), times in ms per "
          f"call (graph replay) at rows {RAGGED_ROWS}; 'dense' = the dense "
          f"twin over every row, 'at T' = the ragged kernel at rows = T")
    print("kernel  din   dout  ms        plain_ms  dense_ms  at_T_ms   "
          "library_ms bound_ms  bound_by   max_abs_err")
    for din, dout in ((2560, 2560), (2560, 6912), (6912, 2560)):
        # two copies of the activations (more than the 50 MB L2), so a
        # timing loop reads them from memory
        xs = [torch.randn(Z, T, din, generator=gen, device=dev)
              .to(torch.bfloat16) for _ in range(2)]
        dys = [torch.randn(Z, T, dout, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(2)]
        base = torch.randn(Z, T, dout, generator=gen,
                           device=dev).to(torch.bfloat16)
        A = torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
        B = torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
        A_lib, B_lib = A.to(torch.bfloat16), B.to(torch.bfloat16)
        for rows_t in (RAGGED_ROWS, RAGGED_EDGE_ROWS):
            rows = torch.tensor(rows_t, dtype=torch.int32, device=dev)
            ss = [RG.xa(x, A, rows) for x in xs]
            dss = [RG.ds(dy, B, scale, rows) for dy in dys]
            x, dy, s, dS = xs[0], dys[0], ss[0], dss[0]
            # --- correctness: (ragged kernel, rank-local twin, plain)
            outs = {
                "xa": (s, RL.xa(x, A, rows, full),
                       ref.ragged_xa_ref(x, A, rows)),
                "sb_add": (RG.sb_add(s, B, scale, rows),
                           RL.sb_add(s, B, scale, rows, full),
                           ref.ragged_sb_add_ref(s, B, scale, rows)),
                "sb_add+base": (RG.sb_add(s, B, scale, rows, base),
                                RL.sb_add(s, B, scale, rows, full, base),
                                ref.ragged_sb_add_ref(s, B, scale, rows,
                                                      base)),
                "ds": (dS, RL.ds(dy, B, scale, rows, full),
                       ref.ragged_ds_ref(dy, B, scale, rows)),
                "dx": (RG.dx(dS, A, rows), RL.dx(dS, A, rows, full),
                       ref.ragged_dx_ref(dS, A, rows)),
                "da": (RG.da(x, dS, rows), RL.da(x, dS, rows, full),
                       ref.ragged_da_ref(x, dS, rows)),
                "db": (RG.db(s, dy, scale, rows),
                       RL.db(s, dy, scale, rows, full),
                       ref.ragged_db_ref(s, dy, scale, rows))}
            # at rows = T on the same operands: (ragged kernel, dense twin)
            at_t = {"xa": (RG.xa(x, A, every), GL.xa(x, A)),
                    "sb_add": (RG.sb_add(s, B, scale, every),
                               GL.sb_add(s, B, scale)),
                    "sb_add+base": (RG.sb_add(s, B, scale, every, base),
                                    GL.sb_add(s, B, scale, base)),
                    "ds": (RG.ds(dy, B, scale, every), GL.ds(dy, B, scale)),
                    "dx": (RG.dx(dS, A, every), GL.dx(dS, A)),
                    "da": (RG.da(x, dS, every), GL.da(x, dS)),
                    "db": (RG.db(s, dy, scale, every), GL.db(s, dy, scale))}
            torch.cuda.synchronize()
            errs = {}
            tag = f"ragged {din}x{dout} rows {rows_t}"
            for name, (out, twin, want) in outs.items():
                gap = float((out.float() - twin.float()).abs().max())
                require(torch.equal(out, twin),
                        f"{tag}: {name} differs from its rank-local twin at "
                        f"ranks 64 (max |diff| {gap:.3g})")
                got_t, dense_t = at_t[name]
                require(torch.equal(got_t, dense_t),
                        f"ragged {din}x{dout}: {name} at rows = T differs "
                        f"from its dense twin")
                o, w = out.float(), want.float()
                bf16_out = name not in ("da", "db")
                torch.testing.assert_close(
                    o, w, rtol=KERNEL_RTOL if bf16_out else GRAD_KERNEL_RTOL,
                    atol=(KERNEL_ATOL_REL if bf16_out else
                          GRAD_KERNEL_ATOL_REL) * float(w.abs().max()),
                    msg=f"{tag}: {name}")
                errs[name] = float((o - w).abs().max())
            for z, nr in enumerate(rows_t):      # dead rows: exact zeros
                for name in ("xa", "sb_add", "ds", "dx"):
                    require(bool((outs[name][0][z, nr:] == 0).all()),
                            f"{tag}: {name} dead rows of slot {z} not 0")
                require(torch.equal(outs["sb_add+base"][0][z, nr:],
                                    base[z, nr:]),
                        f"{tag}: sb_add does not pass the base through on "
                        f"slot {z}'s dead rows")
                if nr == 0:
                    require(bool((outs["da"][0][z] == 0).all()
                                 and (outs["db"][0][z] == 0).all()),
                            f"{tag}: empty slot {z} has a weight gradient")
            print(f"{tag}: max_abs_err "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + "; bitwise equal to the rank-local twin and, at rows = "
                  "T, to the dense twin")
            for name in names:
                res = results.setdefault(name, {"max_abs_err": 0.0})
                res["max_abs_err"] = max(res["max_abs_err"], errs[name],
                                         errs["sb_add+base"]
                                         if name == "sb_add" else 0.0)
            del outs, at_t
            if rows_t != RAGGED_ROWS:
                continue
            # --- timing at the executor's mix, alternating between the
            # two activation copies
            timing = {  # (ragged, plain, dense twin, ragged at T, library)
                "xa": (lambda i: RG.xa(xs[i % 2], A, rows),
                       lambda i: ref.ragged_xa_ref(xs[i % 2], A, rows),
                       lambda i: GL.xa(xs[i % 2], A),
                       lambda i: RG.xa(xs[i % 2], A, every),
                       lambda i: torch.bmm(xs[i % 2], A_lib)),
                "sb_add": (lambda i: RG.sb_add(ss[i % 2], B, scale, rows),
                           lambda i: ref.ragged_sb_add_ref(ss[i % 2], B,
                                                           scale, rows),
                           lambda i: GL.sb_add(ss[i % 2], B, scale),
                           lambda i: RG.sb_add(ss[i % 2], B, scale, every),
                           lambda i: torch.bmm(ss[i % 2], B_lib)),
                "ds": (lambda i: RG.ds(dys[i % 2], B, scale, rows),
                       lambda i: ref.ragged_ds_ref(dys[i % 2], B, scale,
                                                   rows),
                       lambda i: GL.ds(dys[i % 2], B, scale),
                       lambda i: RG.ds(dys[i % 2], B, scale, every),
                       lambda i: torch.bmm(dys[i % 2],
                                           B_lib.transpose(1, 2))),
                "dx": (lambda i: RG.dx(dss[i % 2], A, rows),
                       lambda i: ref.ragged_dx_ref(dss[i % 2], A, rows),
                       lambda i: GL.dx(dss[i % 2], A),
                       lambda i: RG.dx(dss[i % 2], A, every),
                       lambda i: torch.bmm(dss[i % 2],
                                           A_lib.transpose(1, 2))),
                "da": (lambda i: RG.da(xs[i % 2], dss[i % 2], rows),
                       lambda i: ref.ragged_da_ref(xs[i % 2], dss[i % 2],
                                                   rows),
                       lambda i: GL.da(xs[i % 2], dss[i % 2]),
                       lambda i: RG.da(xs[i % 2], dss[i % 2], every),
                       lambda i: torch.bmm(xs[i % 2].transpose(1, 2),
                                           dss[i % 2])),
                "db": (lambda i: RG.db(ss[i % 2], dys[i % 2], scale, rows),
                       lambda i: ref.ragged_db_ref(ss[i % 2], dys[i % 2],
                                                   scale, rows),
                       lambda i: GL.db(ss[i % 2], dys[i % 2], scale),
                       lambda i: RG.db(ss[i % 2], dys[i % 2], scale, every),
                       lambda i: torch.bmm(ss[i % 2].transpose(1, 2),
                                           dys[i % 2])),
            }
            # the bytes each function must move at these rows (live rows of
            # each input read once, the masters of non-empty slots once,
            # each output written once) and its flops
            L = sum(rows_t)
            live = sum(1 for nr in rows_t if nr)
            work = {
                "xa": (L * din * 2 + live * din * r * 4 + Z * T * r * 2,
                       2 * L * r * din),
                "sb_add": (L * r * 2 + live * r * dout * 4 + Z * T * dout * 2,
                           2 * L * r * dout),
                "ds": (L * dout * 2 + live * r * dout * 4 + Z * T * r * 2,
                       2 * L * r * dout),
                "dx": (L * r * 2 + live * din * r * 4 + Z * T * din * 2,
                       2 * L * r * din),
                "da": (L * din * 2 + L * r * 2 + Z * din * r * 4,
                       2 * L * r * din),
                "db": (L * r * 2 + L * dout * 2 + Z * r * dout * 4,
                       2 * L * r * dout)}
            for name in names:
                kern, plain, dense, at_T, lib = timing[name]
                ms, _ = time_ms(torch, kern, 10)
                plain_ms, _ = time_ms(torch, plain, 10)
                dense_ms, _ = time_ms(torch, dense, 10)
                at_t_ms, _ = time_ms(torch, at_T, 10)
                lib_ms, _ = time_ms(torch, lib, 10)
                bound_ms, bound_by = bound(*work[name])
                print(f"{name:7s} {din:5d} {dout:5d}  {ms:9.5f} "
                      f"{plain_ms:9.5f} {dense_ms:9.5f} {at_t_ms:9.5f} "
                      f"{lib_ms:9.5f}  {bound_ms:9.6f} {bound_by:10s} "
                      f"{errs[name]:.3g}")
                if (din, dout) == (2560, 2560):
                    results[name].update(ms=ms, plain_ms=plain_ms,
                                         library_ms=lib_ms,
                                         bound_ms=bound_ms,
                                         bound_by=bound_by)
            del timing
            del ss, dss
        del xs, dys, base
        torch.cuda.empty_cache()
    return results


def invariance_phase(torch, GL, RG, RL, shapes=((2560, 2560), (2560, 6912))):
    """One fp32 summation order per output element of the bf16 xa, ds, da,
    db, sb_add (with and without a base) and dx, in all three sets, at the
    main paths' shapes (Z = 4, T = 1,024 rows a slot, r_max 64, din x dout
    in ``shapes``; rows (1024, 512, 1024, 512), ranks (64, 13, 32, 64)),
    bit for bit: the rows of a T = 4 call (decode) equal the same
    rows of the T = 1,024 call (every output of one row per token row); a
    Z = 1 call equals its slot inside Z = 4; a slot of rows = 512 equals a
    T = 512 call (the DPO step's rows), the dense set's too; operands that
    are not 16-byte aligned (the masked scalar loads and stores) give the
    aligned call's bits."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    Z, T, r = 4, TRAIN_B * TRAIN_S, 64
    rows_t, ranks_t = (1024, 512, 1024, 512), (64, 13, 32, 64)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def contract(mod, x, dy, A, B, scale, s, dS, *c):
        return {"xa": mod.xa(x, A, *c), "ds": mod.ds(dy, B, scale, *c),
                "da": mod.da(x, dS, *c), "db": mod.db(s, dy, scale, *c),
                "sb_add": mod.sb_add(s, B, scale, *c),
                "sb_add+base": mod.sb_add(s, B, scale, *c, y_base=dy),
                "dx": mod.dx(dS, A, *c)}

    # one row of output per token row (dead rows: 0, or the base)
    row_outs = ("xa", "ds", "sb_add", "sb_add+base", "dx")

    def shifted(t):              # the same values, 2 or 4 bytes off 16
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=dev)
        out = buf[1:1 + t.numel()].view(t.shape)
        out.copy_(t)
        return out

    sets = {"dense": (GL, ()), "ragged": (RG, (ints(rows_t),)),
            "rank-local": (RL, (ints(rows_t), ints(ranks_t)))}
    for din, dout in shapes:
        x = torch.randn(Z, T, din, generator=gen, device=dev).bfloat16()
        dy = torch.randn(Z, T, dout, generator=gen, device=dev).bfloat16()
        A = torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
        B = torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
        scale = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
        s, dS = GL.xa(x, A), GL.ds(dy, B, scale)
        full = (x, dy, A, B, scale, s, dS)

        def rows_cut(n):         # the token-row operands' first n rows
            return [t[:, :n].contiguous() if i in (0, 1, 5, 6) else t
                    for i, t in enumerate(full)]

        for fam, (mod, c) in sets.items():
            tag = f"invariance {fam} {din}x{dout}"
            big = contract(mod, *full, *c)
            c4 = tuple(v.clamp(max=4) for v in c[:1]) + c[1:]
            small = contract(mod, *rows_cut(4), *c4)
            for name in row_outs:
                require(torch.equal(small[name], big[name][:, :4]),
                        f"{tag}: {name} rows of a T = 4 call differ from "
                        f"the T = {T} call's")
            for z in (1, 2):
                one = contract(mod, *(t[z:z + 1].contiguous() for t in full),
                               *(v[z:z + 1].contiguous() for v in c))
                for name, out in one.items():
                    require(torch.equal(out[0], big[name][z]),
                            f"{tag}: {name} of a Z = 1 call differs from "
                            f"slot {z} of the Z = 4 call")
            # slot 1 holds 512 rows: the ragged call's (the dense set's T =
            # 512 call meets the ragged one's)
            c512 = tuple(v.clamp(max=512) for v in c[:1]) + c[1:]
            half = contract(mod, *rows_cut(512), *c512)
            slot = big if fam != "dense" else contract(RG, *full,
                                                       *sets["ragged"][1])
            for name in row_outs:
                dead = dy[1, 512:] if name == "sb_add+base" else 0
                require(torch.equal(half[name][1], slot[name][1][:512])
                        and bool((slot[name][1][512:] == dead).all()),
                        f"{tag}: {name} of rows = 512 differs from a T = "
                        f"512 call")
            for name in ("da", "db"):
                require(torch.equal(half[name][1], slot[name][1]),
                        f"{tag}: {name} of rows = 512 differs from a T = "
                        f"512 call")
            moved = contract(mod, *(shifted(t) if t.dim() == 3 else t
                                    for t in full), *c)
            for name, out in moved.items():
                require(torch.equal(out, big[name]),
                        f"{tag}: {name} on unaligned operands differs from "
                        f"the aligned call")
            print(f"{tag}: xa, ds, da, db, sb_add (+base), dx bitwise "
                  f"equal across T = 4 / "
                  f"{T}, Z = 1 / {Z}, rows = 512 / T = 512 and unaligned / "
                  f"aligned operands")
        del x, dy, A, B, s, dS, full
        torch.cuda.empty_cache()


def _attention_plain(torch, q, k, v, window=0, scale_mul=1.0, drop=None):
    """The plain version's arithmetic (kernels/flash_attention/ref.py) with
    a fault planted on request: the softmax scale times ``scale_mul``, the
    keys of slice ``drop`` hidden."""
    B, Sq, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (
        hd ** -0.5 * scale_mul)
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    vis = kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    if drop is not None:
        vis &= (kpos < drop.start) | (kpos >= drop.stop)
    p = torch.softmax(torch.where(vis, s, float("-inf")), dim=-1)
    p = torch.where(torch.isfinite(p), p, 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_kernel_phase(torch, FA, fref, cfg, cases=None,
                       plain_labels=("train", "eval", "dpo")):
    """The flash-attention kernel against its plain version at the shapes
    the path gives it and at the edges of its mask; the reading of each
    case (largest |diff| in units of the bar) with two planted faults of
    the plain version beside it (with a window, a third: the window one
    key wider); the batch-independence check; times of the kernel, the
    plain version (cases labelled in ``plain_labels``) and the SDPA
    yardstick (with the window as a boolean mask) beside the bound.
    ``cases`` replaces stablelm-3b's. Returns (the results at the SFT
    train step's shape, every case's results by label)."""
    import torch.nn.functional as F

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(5)
    H, hd, S = cfg.num_heads, cfg.resolved_head_dim, TRAIN_S
    bf16, fp32 = torch.bfloat16, torch.float32
    B_train, Z = 4 * TRAIN_B * H, 4
    cases = cases or [  # (label, B, Sq, Sk, hd, window, dtype)
        ("train", B_train, S, S, hd, 0, bf16),
        ("eval", Z * EVAL_B * H, S, S, hd, 0, bf16),
        ("dpo", Z * DPO_B * H, S, S, hd, 0, bf16),
        ("window", B_train, S, S, hd, 64, bf16),
        ("Sq<Sk", B_train, S // 2, S, hd, 0, bf16),
        ("Sq>Sk", B_train, S, S // 2, hd, 0, bf16),
        ("hd64", B_train, S, S, 64, 0, bf16),
        ("hd128", B_train, S, S, 128, 0, bf16),
        ("fp32", B_train, S, S, hd, 0, fp32),
    ]
    print("flash attention: reading = max |kernel - plain| / (rtol |plain| "
          f"+ {FLASH_ATOL_REL} max|plain|), rtol {FLASH_RTOL}; bar 1; "
          "controls: the plain version with the second 32-key tile dropped, "
          "with the softmax scale x 1.01, with the window one key wider. "
          "Times in ms per call (graph replay)")
    print("case    B      Sq   Sk   hd  window dtype  reading    tile-drop "
          " scale+1%   window+1   ms         plain_ms   library_ms bound_ms "
          "  bound_by")
    results = {}
    for label, B, Sq, Sk, d, window, dt in cases:
        q, k, v = (torch.randn(B, n, d, generator=gen, device=dev).to(dt)
                   for n in (Sq, Sk, Sk))
        FA.reset_launches()
        out = FA.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        require(FA.LAUNCHES["flash_attention"] == 1,
                f"flash {label}: {FA.LAUNCHES} launches for one call")
        want = fref.flash_attention_ref(q, k, v, window=window)
        kind = "bf16" if dt == bf16 else "fp32"

        def reading(got):
            w = want.float()
            tol = FLASH_RTOL[kind] * w.abs() + FLASH_ATOL_REL * float(
                w.abs().max())
            return float(((got.float() - w).abs() / tol).max())

        sound = reading(out)
        faults = (reading(_attention_plain(torch, q, k, v, window,
                                           drop=slice(32, 64))),
                  reading(_attention_plain(torch, q, k, v, window,
                                           scale_mul=1.01)),
                  reading(_attention_plain(torch, q, k, v, window + 1))
                  if window else None)
        require(bool(torch.isfinite(out).all()) and sound <= 1.0,
                f"flash {label}: kernel reads {sound:.3g} of the bar")
        require(min(f for f in faults if f is not None) > 1.0,
                f"flash {label}: a planted fault passes the bar {faults}")
        if Sq > Sk:
            require(bool((out[:, :Sq - Sk] == 0).all()),
                    f"flash {label}: fully masked rows not exactly 0")
        if label == "train":
            head = [t[:128].contiguous() for t in (q, k, v)]
            require(torch.equal(FA.flash_attention(*head, window=window),
                                out[:128]),
                    f"flash: entries 0-127 of the B = {B} call differ from "
                    f"a B = 128 call")
            print(f"flash: the B = {B} call's entries 0-127 equal a B = 128 "
                  f"call on them bit for bit")
        # work: q, k, v read once and o written once; 4 * hd flops per
        # visible (query, key) pair (scores and weighted values)
        qpos = torch.arange(Sq)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk)[None, :]
        vis = kpos <= qpos
        if window > 0:
            vis &= kpos > qpos - window
        pairs = int(vis.sum()) * B
        nbytes = q.element_size() * d * B * (2 * Sq + 2 * Sk)
        bound_ms, bound_by = bound(nbytes, 4 * d * pairs,
                                   H100_BF16_FLOPS if dt == bf16
                                   else H100_FP32_FLOPS)
        inner = 10 if B <= B_train else 4
        ms, _ = time_ms(torch, lambda i: FA.flash_attention(
            q, k, v, window=window), inner)
        plain_ms = lib_ms = None
        if label in plain_labels:
            plain_ms, _ = time_ms(torch, lambda i: fref.flash_attention_ref(
                q, k, v, window=window), inner)
        if label in ("train", "eval", "dpo"):
            q4, k4, v4 = (t.view(B // H, H, -1, d) for t in (q, k, v))
            band = ((kpos <= qpos) & (kpos > qpos - window)).to(dev)
            sdpa = ((lambda i: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=band)) if window else
                (lambda i: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True)))
            lib_ms, _ = time_ms(torch, sdpa, inner)
        fmt = lambda x: "-" if x is None else f"{x:.5f}"
        fr = lambda x: "-" if x is None else f"{x:.4g}"
        print(f"{label:7s} {B:5d} {Sq:5d} {Sk:4d} {d:4d} {window:6d} "
              f"{kind:5s}  {sound:.4g}  {faults[0]:10.4g} {faults[1]:10.4g}"
              f" {fr(faults[2]):10s} {ms:.5f}  {fmt(plain_ms):10s} "
              f"{fmt(lib_ms):10s} {bound_ms:.6f}  {bound_by}")
        results[label] = {"max_abs_err": float((out.float()
                                                - want.float()).abs().max()),
                          "ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by}
        del q, k, v, out, want
        torch.cuda.empty_cache()
    res = dict(results["train"])
    res["max_abs_err"] = max(r["max_abs_err"] for lab, r in results.items()
                             if lab in ("train", "eval", "dpo"))
    return res, results


def _train_lora(torch, cfg, M, LORA, ranks_t):
    """Slot-stacked adapters at true ranks ``ranks_t``: A from the LoRA
    init, B ~ N(0, 0.003) inside each true rank (B = 0, the init, would
    make dS = 0 and hide ds, dx and da), garbage in the padded rank
    region."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(3)
    ranks = torch.tensor(ranks_t, dtype=torch.int32, device=dev)
    lora = LORA.init_lora_tree(gen, cfg, len(ranks_t), ranks,
                               M.target_shapes(cfg))
    pad = 1.0 - LORA.rank_mask(ranks, cfg.lora.r_max)          # [Z, r]
    for ab in lora.values():
        ab["B"].normal_(0.0, 0.003, generator=gen)
        ab["B"].mul_(1.0 - pad[None, :, :, None])
        ab["B"].add_(torch.randn(ab["B"].shape, generator=gen, device=dev)
                     * pad[None, :, :, None])
        ab["A"].add_(torch.randn(ab["A"].shape, generator=gen, device=dev)
                     * pad[None, :, None, :])
    return lora, ranks


def _task_data(cfg, name, S=TRAIN_S, num_val=EVAL_B):
    from repro_torch.data.synthetic import make_task_dataset
    return make_task_dataset(name, cfg.vocab_size, seq_len=S,
                             num_train=64, num_val=num_val, difficulty=0.3,
                             seed=0)


def train_check(torch, fams, cfg, params, ranks_t, path, rows_t=None,
                loss_kind="sft", hold_grads=True, S=TRAIN_S, b=TRAIN_B,
                loss_bar=TRAIN_LOSS_REL):
    """One full-size train step with the kernels against the same step on
    their plain versions (LoRA backend "torch": autograd through them),
    per slot: loss, grad norm, and the relative RMS of dA and dB over all
    224 projections; then four planted faults in the plain run, each of
    which must break the bars: three in the backward, and one in the
    forward (slot 0's LoRA delta halved) that must break the loss bar
    itself.

    ``path`` "rank-local": slots at the true ranks ``ranks_t`` < r_max,
    with ``slot_ranks`` bound (the rank-local kernels). "dense": every slot
    at r_max and nothing bound (the dense kernels). "ragged": every slot at
    r_max and ``slot_rows`` bound to ``rows_t`` alone (the ragged kernels;
    labels -1 and tokens 0 past each slot's rows), with one more planted
    fault: the narrow slots' last live ROW_TILE-row tile treated as dead in
    the plain forward, which must break the loss bar. In the last two the
    plain run binds ``slot_ranks`` = r_max, whose plain versions give
    bitwise the dense and ragged ones'; then the kernel step runs again
    with ``slot_ranks`` bound to r_max, through the rank-local kernels: its
    per-slot losses and every dA and dB must equal the first kernel step's
    bit for bit. ``fams`` maps each path to its kernel module.

    The kernel runs take the family's sequence kernels (model backend
    "kernel": flash attention, the linear scan for rwkv6-3b, both for
    hymba-1.5b; two launches per layer each, the forward and its remat
    recompute), the plain runs their plain versions (model backend
    "torch"); one more fault planted in the plain run, every query seeing
    one future key (rwkv6-3b: the bonus dropped from the scan; hymba-1.5b
    two: the scan's decay applied before the query reads the state, RWKV's
    order, and every query seeing one key beyond the window), must break
    the loss bar. On the rank-local SFT path of a dense model, one step's
    gradients then run under torch.profiler with each attention (the LoRA
    kernels in both) and the device busy times are printed. ``S`` and
    ``b`` are the batch's sequence length and sequences a slot;
    ``loss_bar`` the loss bar (hymba-1.5b's fp32 check: HYMBA_LOSS_REL).

    ``loss_kind`` "dpo" (rank-local path): the same step on DPO_B
    preference pairs per slot from the DPO phase's PairSlotBatcher, whose
    policy forwards give the LoRA kernels T = DPO_B * TRAIN_S rows per
    slot; the same bars and planted faults (the attention fault reaches the
    reference forwards too). Beside the bars it prints how far apart the
    two runs' per-slot sequence log-probabilities are, in each of the four
    forwards.

    ``hold_grads`` False holds the loss bar alone, with the two forward
    faults (slot 0's delta halved, the sequence fault), and prints the
    gradient readings: for a model whose backward amplifies rounding past
    any bar (rwkv6-3b at full depth, see RWKV_GRAD_LAYERS)."""
    from repro_torch.core import lora as LORA
    from repro_torch.core import steps as STEPS
    from repro_torch.data.synthetic import PairSlotBatcher, SlotBatcher
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.kernels.linear_scan import ref as LSREF
    from repro_torch.models import attention as ATT
    from repro_torch.models import backend as BK
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    dev = "cuda"
    Z = len(ranks_t)
    dpo = loss_kind == "dpo"
    require(not dpo or (path == "rank-local" and rows_t is None),
            "the DPO train check runs on the rank-local path")
    tag = f"{path}, {loss_kind}" if dpo else path
    lora, ranks = _train_lora(torch, cfg, M, LORA, ranks_t)
    if dpo:
        nb = PairSlotBatcher(*_pair_data(cfg), Z, DPO_B, seed=0)
    else:
        nb = SlotBatcher(_task_data(cfg, "rank-sweep", S), Z, b, seed=0)
    raw = nb.next_batch_dict()
    if rows_t is not None:     # the pad past each slot's rows
        for z, nr in enumerate(rows_t):
            raw["labels"][z].reshape(-1)[nr:] = -1
            raw["tokens"][z].reshape(-1)[nr:] = 0
    kbatch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    if rows_t is not None:
        kbatch["slot_rows"] = torch.tensor(rows_t, dtype=torch.int32,
                                           device=dev)
    pbatch = dict(kbatch, slot_ranks=ranks)
    if path == "rank-local":
        kbatch = pbatch
    active = torch.ones((Z,), dtype=torch.int32, device=dev)

    def batch_of(backend):
        return kbatch if backend == "kernel" else pbatch

    def step(backend):
        """make_train_step on copies of the adapters and fresh moments."""
        tree = {t: {m: x.clone() for m, x in ab.items()}
                for t, ab in lora.items()}
        opt = adamw.init_state(tree, Z)
        hp = adamw.SlotHParams.broadcast(Z, lr=1e-4, device=dev)
        with LORA.backend(backend), BK.backend(backend):
            _, _, met = STEPS.make_train_step(cfg, loss_kind=loss_kind)(
                params, tree, opt, hp, active, ranks, batch_of(backend))
        return met["per_slot_loss"], met["grad_norm"]

    def grads_of(tree, backend, batch=None):
        with LORA.backend(backend), BK.backend(backend):
            return STEPS.lora_grads(cfg, params, tree,
                                    batch or batch_of(backend), active,
                                    loss_kind=loss_kind)

    def grads(backend):
        return grads_of(lora, backend)

    torch.cuda.synchronize()
    t = time.perf_counter()
    k_loss, k_norm = step("kernel")
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t
    p_loss, p_norm = step("torch")
    torch.cuda.synchronize()
    print(f"train check ({tag}): {cfg.name} full width, "
          f"{cfg.num_layers} layers, {cfg.dtype}, Z={Z} ranks "
          f"{ranks_t}, b={DPO_B if dpo else b} "
          f"{'pairs ' if dpo else ''}S={S}, rows {rows_t or 'all'}; "
          f"one make_train_step with the kernels {t_k:.2f} s, then on the "
          f"plain versions")
    def launched_only(want):
        """Require the kernel set ``want`` launched and no other did."""
        counts = {k: dict(m.LAUNCHES) for k, m in fams.items()}
        require(min(counts[want].values()) > 0
                and all(set(c.values()) == {0} for k, c in counts.items()
                        if k != want),
                f"{path} train check launched {counts}, expected only "
                f"the {want} kernels")

    @contextlib.contextmanager
    def seq_logp(into):
        """Gather each forward's per-slot summed NLL (a DPO loss runs
        four: policy chosen, policy rejected, reference chosen, reference
        rejected)."""
        xent = M.per_slot_xent

        def kept(*args, **kw):
            out = xent(*args, **kw)
            into.append(out[0].detach().float())
            return out
        M.per_slot_xent = kept
        try:
            yield
        finally:
            M.per_slot_xent = xent

    for m in (*fams.values(), FA, LSK):
        m.reset_launches()
    nll_k, nll_p = [], []
    with seq_logp(nll_k):
        k_gloss, gk = grads("kernel")
    torch.cuda.synchronize()
    launched_only(path)
    with seq_logp(nll_p):
        _, gp = grads("torch")
    torch.cuda.synchronize()
    seq_want = _seq_counts(cfg, _step_launches(cfg, loss_kind)[2][0])
    seq_got = {**FA.LAUNCHES, **LSK.LAUNCHES}
    require(seq_got == seq_want,
            f"{tag} train check: the sequence kernels launched {seq_got}, "
            f"expected {seq_want} in the kernel run and 0 in the plain one")
    names = (("policy chosen", "policy rejected", "reference chosen",
              "reference rejected") if dpo else ("forward",))
    require(len(nll_k) == len(nll_p) == len(names),
            f"{tag} train check: {len(nll_k)}/{len(nll_p)} forwards, "
            f"expected {len(names)}")

    def dlm(loss):
        """Per slot |d loss / d margin| of a DPO loss -log sigmoid(m),
        from the loss itself: 1 - sigmoid(m) = 1 - exp(-loss); 1 for
        SFT."""
        return -torch.expm1(-loss) if dpo else torch.ones_like(loss)

    def rel_rms(a, b, m, fa, fb, fs):
        """Per slot ||a / fa - b / fb|| / ||gp / fs|| over leaf ``m`` of
        every target, normalized by the sound plain run's gradient."""
        num = den = 0.0
        for t in b:
            dims = (0, 2, 3)
            num = num + (a[t][m] / fa[None, :, None, None]
                         - b[t][m] / fb[None, :, None, None]
                         ).float().square().sum(dims)
            den = den + (gp[t][m] / fs[None, :, None, None]
                         ).float().square().sum(dims)
        return (num / den).sqrt()

    def gap(loss, norm, g, nll, raw=False):
        """Kernel run vs a plain run, relative to the sound plain run. SFT:
        the per-slot loss, grad norm, dA and dB. DPO (unless ``raw``):
        each of the four forwards' per-slot summed NLL (the SFT loss's
        quantity, summed), and the gradients of the margin (each run's
        per-slot gradients divided by its own |d loss / d margin|)."""
        margin = dpo and not raw
        fa, fb, fs = ((dlm(k_loss), dlm(loss), dlm(p_loss)) if margin
                      else (one, one, one))
        if margin:
            lg = torch.stack([(a - b).abs() / c.abs() for a, b, c in
                              zip(nll_k, nll, nll_p)]).amax(0)
        else:
            lg = (k_loss - loss).abs() / p_loss.abs()
        return {"loss": lg.tolist(),
                "grad_norm": ((k_norm / fa - norm / fb).abs()
                              / (p_norm / fs)).tolist(),
                "dA": rel_rms(gk, g, "A", fa, fb, fs).tolist(),
                "dB": rel_rms(gk, g, "B", fa, fb, fs).tolist()}

    def plain_run(tree=None, batch=None):
        """(per-slot loss, grads, per-forward summed NLL) of a plain
        run."""
        nll = []
        with seq_logp(nll):
            loss, g = grads_of(lora if tree is None else tree, "torch",
                               batch)
        return loss, g, nll

    bars = {"loss": loss_bar, "grad_norm": TRAIN_NORM_REL,
            "dA": TRAIN_GRAD_REL_RMS, "dB": TRAIN_GRAD_REL_RMS}

    def within(g):
        return all(max(g[k]) <= bars[k] for k in bars)

    def show(g):
        return "; ".join(f"{k} {[float(f'{v:.4g}') for v in g[k]]}"
                         for k in bars)

    one = torch.ones_like(p_loss)
    sound = gap(p_loss, p_norm, gp, nll_p)
    if dpo:
        print(f"train check ({tag}): the DPO loss -log sigmoid(beta x "
              f"margin) reads a difference of four per-slot sums of "
              f"{DPO_B * TRAIN_S} token NLLs (~{float(nll_p[0].mean()):.0f} "
              f"nats each), which amplifies the backbone's bf16 rounding; "
              f"raw per-slot readings, not held: "
              f"{show(gap(p_loss, p_norm, gp, nll_p, raw=True))}. Held "
              f"instead: 'loss' = the largest relative gap of the four "
              f"forwards' summed NLL (the SFT loss's quantity), the "
              f"gradients divided by each run's own |d loss / d margin| "
              f"{[float(f'{v:.4g}') for v in dlm(k_loss).tolist()]}")
    print(f"train check ({tag}): kernels vs plain per slot (relative): "
          f"{show(sound)}; bars {bars}")
    require(bool(torch.isfinite(k_loss).all()
                 and torch.isfinite(k_norm).all()),
            "train step losses or grad norms not finite")
    require(within(sound) if hold_grads
            else max(sound["loss"]) <= loss_bar,
            f"{tag} kernel train step too far from the plain one")
    if not hold_grads:
        # why: the same plain step again with the sequence kernel's plain
        # output moved by 1e-7 relative (rounding-sized noise, not a
        # fault), and the plain gradients' size by layer
        plain_scan = LSREF.linear_scan_ref
        noise_gen = torch.Generator(device=dev).manual_seed(11)

        def noisy_scan(*args, **kw):
            y, st = plain_scan(*args, **kw)
            eps = torch.randn(y.shape, generator=noise_gen, device=dev)
            return y + (y * 1e-7 * eps.to(y.dtype)).detach(), st
        LSREF.linear_scan_ref = noisy_scan
        try:
            n_loss, g_noise, _ = plain_run()
        finally:
            LSREF.linear_scan_ref = plain_scan
        n_norm = adamw.per_slot_global_norm(g_noise)
        noise = {"loss": ((n_loss - p_loss).abs() / p_loss.abs()).tolist(),
                 "grad_norm": ((n_norm - p_norm).abs() / p_norm).tolist(),
                 "dA": rel_rms(g_noise, gp, "A", one, one, one).tolist(),
                 "dB": rel_rms(g_noise, gp, "B", one, one, one).tolist()}
        by_layer = [float(sum(gp[t]["B"][lyr].float().square().sum()
                              for t in gp).sqrt())
                    for lyr in range(cfg.num_layers)]
        print(f"train check ({tag}): the plain step against itself with "
              f"the scan's y moved by 1e-7 relative: {show(noise)}; the "
              f"plain |dB| by layer (0 first): "
              f"{[float(f'{x:.3g}') for x in by_layer]}")
        print(f"train check ({tag}): gradients not held at {cfg.num_layers} "
              f"layers; the loss bar and the forward faults are")
        del g_noise

    # planted faults in the plain run, each held to the same bars
    def faulted(leaf, z, factor):
        g = {t: {m: x.clone() for m, x in ab.items()} for t, ab in gp.items()}
        for ab in g.values():
            ab[leaf][:, z] *= factor
        return g

    @contextlib.contextmanager
    def lora_dx_dropped():
        """The plain LoRA branch with its dX dropped (x detached): the
        earlier layers no longer see the adapters' share of the
        gradient."""
        plain = ref.ranklocal_lora_ref

        def no_dx(x, *args, **kw):
            return plain(x.detach(), *args, **kw)
        ref.ranklocal_lora_ref = no_dx
        try:
            yield
        finally:
            ref.ranklocal_lora_ref = plain

    if hold_grads:
        g0 = faulted("A", 0, 0.0)
        g3 = faulted("B", Z - 1, 0.5)
        with lora_dx_dropped():
            f_loss, g_nodx, f_nll = plain_run()
        controls = [
            (f"slot 0 (rank {ranks_t[0]}) dA zeroed", p_loss, g0, nll_p),
            (f"slot {Z - 1} (rank {ranks_t[-1]}) dB halved", p_loss, g3,
             nll_p),
            ("LoRA branch dX dropped", f_loss, g_nodx, f_nll),
        ]
        for label, loss, g, nll in controls:
            c = gap(loss, adamw.per_slot_global_norm(g), g, nll)
            print(f"train check ({tag}): control, {label}: {show(c)}")
            require(not within(c),
                    f"control '{label}' passes the train bars")
        del g0, g3, g_nodx
    # the forward fault: slot 0's delta halved (its B halved) in the plain
    # forward; the loss alone must tell it from the kernels' rounding
    half = {t: {"A": ab["A"], "B": ab["B"].clone()} for t, ab in lora.items()}
    for ab in half.values():
        ab["B"][:, 0] *= 0.5
    h_loss, g_half, h_nll = plain_run(half)
    c = gap(h_loss, adamw.per_slot_global_norm(g_half), g_half, h_nll)
    print(f"train check ({tag}): control, slot 0 (rank {ranks_t[0]}) delta "
          f"halved in the forward: {show(c)}")
    require(max(c["loss"]) > loss_bar,
            "control 'slot 0 delta halved' passes the loss bar")
    del g_half, half

    @contextlib.contextmanager
    def attention_peeks_ahead():
        """The plain (baseline) attention with every query seeing one
        future key."""
        plain = ATT.causal_mask_bias

        def ahead(q_pos, k_pos, window=0):
            return plain(q_pos + 1, k_pos, window)
        ATT.causal_mask_bias = ahead
        try:
            yield
        finally:
            ATT.causal_mask_bias = plain

    @contextlib.contextmanager
    def scan_without_bonus():
        """The plain linear scan with the bonus u dropped (the diagonal
        current-token term of every RWKV head)."""
        plain = LSREF.linear_scan_ref

        def no_bonus(*args, **kw):
            return plain(*args, **dict(kw, bonus=None))
        LSREF.linear_scan_ref = no_bonus
        try:
            yield
        finally:
            LSREF.linear_scan_ref = plain

    @contextlib.contextmanager
    def scan_decay_first():
        """The plain linear scan in RWKV's order: the query reads the state
        before the token's decay and write (pairs t > i), instead of after
        them (SSD, pairs t >= i)."""
        plain = LSREF.linear_scan_ref

        def rwkv_order(*args, **kw):
            return plain(*args, **dict(kw, decay_on_query=False))
        LSREF.linear_scan_ref = rwkv_order
        try:
            yield
        finally:
            LSREF.linear_scan_ref = plain

    @contextlib.contextmanager
    def attention_window_wider():
        """The plain (baseline) attention with every query seeing one key
        beyond its window."""
        plain = ATT.causal_mask_bias

        def wider(q_pos, k_pos, window=0):
            return plain(q_pos, k_pos, window + 1 if window else 0)
        ATT.causal_mask_bias = wider
        try:
            yield
        finally:
            ATT.causal_mask_bias = plain

    faults = {
        "ssm": [(scan_without_bonus, "the bonus dropped from the plain "
                 "linear scan")],
        "hybrid": [(scan_decay_first, "the plain scan's decay applied "
                    "before the query reads the state (RWKV's order)"),
                   (attention_window_wider, "every query sees one key "
                    "beyond the window in the plain attention")],
    }.get(cfg.family, [(attention_peeks_ahead, "every query sees one future "
                        "key in the plain attention")])
    for fault, what in faults:
        with fault():
            a_loss, g_att, a_nll = plain_run()
        c = gap(a_loss, adamw.per_slot_global_norm(g_att), g_att, a_nll)
        print(f"train check ({tag}): control, {what}: {show(c)}")
        require(max(c["loss"]) > loss_bar,
                f"control '{what}' passes the loss bar")
        del g_att
    if path == "rank-local" and not dpo and cfg.family == "dense":
        # one step's gradients, LoRA kernels both times: flash attention,
        # then the baseline einsum attention
        busy = {}
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        for attn in ("kernel", "torch"):
            with (LORA.backend("kernel"), BK.backend(attn),
                  torch.profiler.profile(activities=acts) as prof):
                STEPS.lora_grads(cfg, params, lora, kbatch, active)
                torch.cuda.synchronize()
            evs = device_events(torch, prof)
            busy[attn] = (sum(us for _, us in evs) / 1e3,
                          sum(us for n, us in evs if "flash_fwd" in n) / 1e3)
        print(f"train check ({path}): one step's gradients (lora_grads, "
              f"profiler on): device busy {busy['kernel'][0]:.2f} ms with "
              f"flash attention (the flash kernel {busy['kernel'][1]:.2f} ms "
              f"of it, {2 * cfg.num_layers} launches), "
              f"{busy['torch'][0]:.2f} ms with the baseline einsum attention "
              f"(difference {busy['torch'][0] - busy['kernel'][0]:.2f} ms)"
              if busy["kernel"][0] else
              f"train check ({path}): no device events traced: not measured")
    if rows_t is not None:
        # the narrow slots' last live row tile treated as dead in the plain
        # forward: its rows lose their LoRA delta
        cut = [nr - ROW_TILE if nr < max(rows_t) else nr for nr in rows_t]
        short = dict(pbatch, slot_rows=torch.tensor(cut, dtype=torch.int32,
                                                    device=dev))
        t_loss, g_tile, t_nll = plain_run(batch=short)
        c = gap(t_loss, adamw.per_slot_global_norm(g_tile), g_tile, t_nll)
        print(f"train check ({path}): control, the narrow slots' last live "
              f"{ROW_TILE}-row tile dead in the forward (rows {cut}): "
              f"{show(c)}")
        require(max(c["loss"]) > loss_bar,
                "control 'last live row tile dead' passes the loss bar")
        del g_tile
    if path != "rank-local":
        # the same step with slot_ranks bound to r_max: the rank-local
        # kernels, which must give the first step's numbers bit for bit
        for m in fams.values():
            m.reset_launches()
        r_loss, gr = grads_of(lora, "kernel", pbatch)
        torch.cuda.synchronize()
        launched_only("rank-local")
        same = [torch.equal(gr[t][m], gk[t][m]) for t in gk for m in gk[t]]
        print(f"train check ({path}): the step with slot_ranks bound to "
              f"{ranks_t} (rank-local kernels): per-slot loss bitwise equal "
              f"{torch.equal(r_loss, k_gloss)}, dA/dB bitwise equal on "
              f"{sum(same)} of {len(same)} leaves")
        require(torch.equal(r_loss, k_gloss) and all(same),
                f"rank-local kernels at full rank differ from the {path} "
                f"ones")
        del gr
    del gk, gp, lora
    torch.cuda.empty_cache()


# the projections whose inputs are the first layer's normed embedding (for
# RWKV: its token-shift lerps), which hang off no differentiable leaf
FIRST_LAYER_NO_DX = {"dense": {"q_proj", "k_proj", "v_proj"},
                     "ssm": {"r_proj", "k_proj", "v_proj", "g_proj"},
                     "hybrid": {"q_proj", "k_proj", "v_proj", "in_proj"}}
# the sequence kernels of each family: one launch each per layer of a
# forward
SEQ_KERNELS = {"dense": ("flash_attention",), "ssm": ("linear_scan",),
               "hybrid": ("flash_attention", "linear_scan")}


def _seq_counts(cfg, n):
    """Launch counts of the two sequence kernels when each of the family's
    own (flash attention, the linear scan, or both) launched ``n``
    times."""
    return {k: (n if k in SEQ_KERNELS[cfg.family] else 0)
            for k in ("flash_attention", "linear_scan")}


def _step_launches(cfg, loss_kind="sft"):
    """Launches per fused train step and per eval step: of each kernel of
    the path's grouped-LoRA set (remat runs each forward twice; the first
    layer's q/k/v — RWKV: r/k/v/g — read the normed embedding, which hangs
    off no differentiable leaf, so their LoRA dX is never asked for), and
    of each of the family's sequence kernels, flash attention and / or the
    linear scan (once per layer of every forward and every recompute). A DPO step runs
    two policy forwards (chosen, rejected) through the adapters and two
    reference forwards without them, under no_grad (no remat)."""
    policy, reference = (2, 2) if loss_kind == "dpo" else (1, 0)
    per_forward = len(cfg.lora.targets) * cfg.num_layers
    no_dx = len(FIRST_LAYER_NO_DX[cfg.family] & set(cfg.lora.targets))
    train = {"xa": 2 * policy * per_forward, "sb_add": 2 * policy * per_forward,
             "ds": policy * per_forward, "dx": policy * (per_forward - no_dx),
             "da": policy * per_forward, "db": policy * per_forward}
    evals = {k: (policy * per_forward if k in ("xa", "sb_add") else 0)
             for k in train}
    L = cfg.num_layers
    return train, evals, ((2 * policy + reference) * L,
                          (policy + reference) * L)


def _clock(torch, ex, spent):
    """Wrap the executor operations around the steps so that ``spent``
    gathers the seconds each takes (device work synced on both sides)."""
    sync = torch.cuda.synchronize

    def clocked(name):
        fn = getattr(ex, name)

        def run(*args, **kw):
            sync()
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t
            return out
        setattr(ex, name, run)

    for name in ("_assemble", "eval_task", "snapshot", "restore", "admit",
                 "evict", "adapter_at"):
        clocked(name)


def executor_phase(torch, fam, others, cfg, params, task, jobs,
                   loss_kind="sft", batcher=None, b=TRAIN_B, S=TRAIN_S,
                   eval_b=EVAL_B):
    """A sweep through the port's entry point: BatchedExecutor.run_task on
    ``cfg`` at full size (stablelm-3b, rwkv6-3b or hymba-1.5b; b sequences
    of S tokens a slot, eval_b in an eval step), ``jobs`` (8) on 4
    slots. Every fused train step and every eval step is wrapped to count
    the launches of the kernel set ``fam`` (the path's: rank-local for a
    rank sweep or DPO, dense for a full-rank lr sweep) and of the two
    sequence kernels (flash attention, the linear scan), and time it; the
    other sets, ``others``, must launch nothing in the run. Two train steps of
    the second warmup wave run under torch.profiler. ``loss_kind`` "dpo"
    trains preference pairs from ``batcher`` (a PairSlotBatcher), b pairs
    per slot; every slot's first loss must then read log 2."""
    from repro_torch.core.early_exit import EarlyExitConfig
    from repro_torch.core.executor import BatchedExecutor, TaskResult
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.linear_scan import linear_scan as LSK

    sync = torch.cuda.synchronize
    Z = 4
    lora_train, lora_eval, (seq_train, seq_eval) = _step_launches(
        cfg, loss_kind)
    want_train = {**lora_train, **_seq_counts(cfg, seq_train)}
    want_eval = {**lora_eval, **_seq_counts(cfg, seq_eval)}
    bx = BatchedExecutor(cfg, params,
                         _task_data(cfg, task, S, eval_b) if batcher is None
                         else None,
                         Z=Z, per_adapter_batch=b,
                         ee=EarlyExitConfig(warmup_ratio=0.25,
                                            select_ratio=0.25),
                         eval_every=2, loss_kind=loss_kind, batcher=batcher,
                         seq_cap=S)
    ex = bx.backbone
    # per step: (launch deltas, ms, real tokens, profiled, resident slots)
    log = {"train": [], "eval": []}
    prof = {"busy_us": 0.0, "wall_us": 0.0, "kernels": {}}
    traces = []
    first = {}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def counts():
        return {**fam.LAUNCHES, **FA.LAUNCHES, **LSK.LAUNCHES}

    def counted(fn, kind):
        def run(*args):
            tokens = ex.slots.occupied_tokens()
            residents = len(ex.slots.occupied())
            profiled = kind == "train" and len(log["train"]) in (2, 3)
            before = counts()
            sync()
            t = time.perf_counter()
            if profiled:
                with torch.profiler.profile(activities=acts) as p:
                    out = fn(*args)
                    sync()
            else:
                out = fn(*args)
                sync()
            dt = time.perf_counter() - t
            now = counts()
            delta = {k: now[k] - before[k] for k in before}
            if kind == "train" and not log["train"]:
                first.update(loss=out[2]["per_slot_loss"].float().cpu(),
                             active=ex.slots.active.cpu().clone())
            log[kind].append((delta, dt * 1e3, tokens, profiled, residents))
            if profiled:     # its events are read after run_task
                prof["wall_us"] += dt * 1e6
                traces.append(p)
            return out
        return run

    ex._train_step = counted(ex._train_step, "train")
    ex._eval_step = counted(ex._eval_step, "eval")
    # seconds of the run_task wall spent in each executor operation around
    # the steps
    spent = {}
    _clock(torch, ex, spent)
    # an earlier executor phase's executor lives on in the reference cycle
    # its wrapped methods make (its adapters and moments, ~4.8 GB at r_max
    # 64): free it before the peak is read
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for m in (fam, *others, FA, LSK):
        m.reset_launches()
    t0 = time.perf_counter()
    result = bx.run_task(task, jobs, total_steps=8)
    wall = time.perf_counter() - t0
    launches = counts()
    stray = [dict(m.LAUNCHES) for m in others]
    peak = torch.cuda.max_memory_allocated()
    t_read = time.perf_counter()
    for p in traces:
        for name, us_e in device_events(torch, p):
            n, us = prof["kernels"].get(name, (0, 0.0))
            prof["kernels"][name] = (n + 1, us + us_e)
            prof["busy_us"] += us_e
    del traces
    read_s = time.perf_counter() - t_read

    require(isinstance(result, TaskResult) and result.best_job in jobs,
            f"run_task returned {result!r}")
    tag = f"executor ({task})"
    if loss_kind == "dpo":
        live = first["active"].bool()
        gap = (first["loss"] - math.log(2.0)).abs()[live]
        print(f"{tag}: first train step's per-slot DPO losses "
              f"{first['loss'].tolist()} (active {first['active'].tolist()}); "
              f"largest |loss - log 2| {float(gap.max()):.3g} (bar 1e-3)")
        require(bool(live.any()) and float(gap.max()) <= 1e-3,
                "a slot's first DPO loss is not log 2 within 1e-3")
    finite = [r.best_val for r in result.job_results.values()
              if r.exit_reason is None or r.exit_reason.value != "diverging"]
    require(all(v == v and abs(v) < float("inf") for v in finite),
            f"non-finite val losses {finite}")
    for kind, want in (("train", want_train), ("eval", want_eval)):
        bad = [d for d, *_ in log[kind] if d != want]
        require(log[kind] and not bad,
                f"{kind} steps launched {bad[:2]}, expected {want} each")
    n_train, n_eval = len(log["train"]), len(log["eval"])
    require(all(launches[k] == n_train * want_train[k]
                + n_eval * want_eval[k] for k in launches),
            f"run launches {launches}")
    require(all(set(c.values()) == {0} for c in stray),
            f"the other kernel sets launched {stray} in the {task} run")
    # all work over all the time: the real tokens of every fused train
    # step over the whole run_task wall (batch assembly, copies to the
    # card, loss reads, evals, rotations, the cold first step and the two
    # profiled steps included), and the same without the profiled windows
    trained = sum(tok for _, _, tok, _, _ in log["train"])
    prof_tok = sum(tok for _, _, tok, p, _ in log["train"] if p)
    run_tok_s = trained / wall
    run_tok_s_np = (trained - prof_tok) / (wall - prof["wall_us"] / 1e6)
    # one _train_step call (its device work synced), warm and unprofiled,
    # by the number of resident slots
    by_res = {}
    for _, ms, tok, p, k in log["train"][1:]:
        if not p:
            by_res.setdefault(k, []).append((ms, tok))
    eval_ms = statistics.median(ms for _, ms, *_ in log["eval"][1:])
    print(f"{tag}: BatchedExecutor.run_task('{task}', {len(jobs)} jobs, "
          f"total_steps=8) on {cfg.name}: best {result.best_job} "
          f"(val {result.best_val:.4f}), exits {result.exit_counts}, "
          f"saved {result.samples_saved_frac:.3f} of the samples; "
          f"{n_train} fused train steps, {n_eval} eval steps in {wall:.1f} s")
    print(f"{tag}: launches per train step {want_train}, per eval step "
          f"{want_eval} (every step checked); run total {launches}")
    print(f"{tag}: run_task wall {wall:.3f} s for {trained} real trained "
          f"tokens = {run_tok_s:.1f} tokens/s over the whole run (every "
          f"step, eval and rotation included); {run_tok_s_np:.1f} tokens/s "
          f"without the two profiled steps' windows and tokens")
    train_s = sum(ms for _, ms, *_ in log["train"]) / 1e3
    eval_s = sum(ms for _, ms, *_ in log["eval"]) / 1e3
    parts = {"train steps": train_s, **spent}
    print(f"{tag}: run_task wall {wall:.3f} s = " + " + ".join(
        f"{k} {v:.3f} s" for k, v in parts.items())
        + f" + other {wall - sum(parts.values()):.3f} s (eval_task holds "
        f"the eval steps' {eval_s:.3f} s; the train steps hold the two "
        f"profiled ones' {prof['wall_us'] / 1e6:.3f} s)")
    for k, steps in sorted(by_res.items(), reverse=True):
        ms = [m for m, _ in steps]
        print(f"{tag}: {k} resident slots: median _train_step call "
              f"{statistics.median(ms):.2f} ms over {len(ms)} warm "
              f"unprofiled steps (min {min(ms):.2f}, max {max(ms):.2f}), "
              f"{sum(t for _, t in steps) / sum(ms) * 1e3:.1f} real tokens/s "
              f"within the calls")
    print(f"{tag}: first train step {log['train'][0][1]:.1f} ms (cold); "
          f"median eval step {eval_ms:.2f} ms ([{Z}, {eval_b}, {S}] "
          f"tokens); peak memory {peak / 2**30:.2f} GiB")
    busy, pw = prof["busy_us"], prof["wall_us"]
    seq_names = {"flash_attention": ("flash_fwd", "flash attention"),
                 "linear_scan": ("linear_scan_kernel", "the linear scan")}
    seq = []
    for kern in SEQ_KERNELS[cfg.family]:
        name, label = seq_names[kern]
        us = sum(u for n, (_, u) in prof["kernels"].items() if name in n)
        seq.append(f"{label} {us / 2e3:.2f} ms/step = "
                   f"{us / busy if busy else 0:.3f} of the device time")
    print(f"profile ({task}): 2 train steps (profiler on) {pw / 2e3:.2f} "
          f"ms/step wall, device busy {busy / 2e3:.2f} ms/step = "
          f"{busy / pw:.3f} of the wall, "
          f"{sum(n for n, _ in prof['kernels'].values()) / 2:.0f} "
          f"device events/step; " + "; ".join(seq)
          + f"; reading the two traces took {read_s:.1f} s" if busy else
          f"profile ({task}): no device events traced: not measured")
    if busy:
        print_template_sums(task, prof["kernels"], busy)
    for name, (n, us) in sorted(prof["kernels"].items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"profile ({task}):   {us / 2e3:8.3f} ms/step {n // 2:5d}/step "
              f"{name[:90]}")
    return launches


def colocated_phase(torch, fams, cfg):
    """Co-located == solo on the card, stablelm-3b at full width and
    COLO_LAYERS layers: ports of the JAX package's isolation tests
    (tests/test_lora_isolation.py), each task trained fused with a
    co-tenant through run_colocated on one SharedBackboneExecutor (Z = 4,
    b_cap = 4, seq_cap = 256), then alone on a fresh executor of the same
    shape. The full-rank b = 4 task "full" is the host of every pair:
      * beside "low" (ranks 4/8, b = 4;
        ``test_ranklocal_cross_task_losses_bitwise_equal_solo``): the
        rank-local kernels fused, the dense ones for "full" alone;
      * beside "narrow" (full rank, b = 2;
        ``test_ragged_cross_task_losses_bitwise_equal_solo`` and
        ``test_ragged_full_width_host_unperturbed_by_narrow_guest``): the
        ragged kernels fused and for "narrow" alone;
      * beside "short" (full rank, b = 2, S = 128;
        ``test_ragged_mixed_seq_len_cross_task_bitwise``): the ragged
        kernels, each lane padded mid-row;
      * beside "low-narrow" (ranks 4/8, b = 2;
        ``test_ranklocal_ragged_rank_and_width_compose_bitwise``): the
        rank-local kernels with rows bound.
    Loss histories and best validation losses must be equal bit for bit
    fused and alone; the kernel sets each run launched (train and eval
    steps; an eval step binds nothing unless a rank is below r_max) are
    printed and checked."""
    import dataclasses

    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.early_exit import EarlyExitConfig
    from repro_torch.core.executor import (SharedBackboneExecutor,
                                           TaskLifecycle, run_colocated)
    from repro_torch.data.synthetic import SlotBatcher, make_task_dataset
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg, num_layers=COLO_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda")
    r_max = cfg.lora.r_max
    full = (r_max, r_max)
    tasks = {  # name: (seed, ranks, per-adapter batch, seq len, difficulty)
        "full": (3, full, TRAIN_B, TRAIN_S, 0.2),
        "low": (4, (4, 8), TRAIN_B, TRAIN_S, 0.6),
        "narrow": (5, full, 2, TRAIN_S, 0.4),
        "short": (6, full, 2, TRAIN_S // 2, 0.4),
        "low-narrow": (7, (4, 8), 2, TRAIN_S, 0.6),
    }
    data = {name: make_task_dataset(name, cfg.vocab_size, seq_len=seq,
                                    num_train=32, num_val=8,
                                    difficulty=diff, seed=seed)
            for name, (seed, _, _, seq, diff) in tasks.items()}

    def run(chosen):
        ex = SharedBackboneExecutor(cfg, params, Z=4,
                                    per_adapter_batch=TRAIN_B, eval_every=2,
                                    seed=0, seq_cap=TRAIN_S)
        lcs = []
        for name in chosen:
            seed, ranks, b, _, _ = tasks[name]
            jobs = {f"{name}/j{i}": TrainConfig(
                        learning_rate=lr, lora_rank=rk, max_steps=8,
                        per_adapter_batch=b)
                    for i, (lr, rk) in enumerate(zip((3e-3, 1e-3), ranks))}
            lcs.append(TaskLifecycle(
                ex, name, jobs, 8,
                ee=EarlyExitConfig(warmup_ratio=0.25, select_ratio=1.0),
                max_slots=2, batcher=SlotBatcher(data[name], 2, ex.b_cap,
                                                 seed=seed), seed=seed))
        for m in (*fams.values(), FA):
            m.reset_launches()
        results = run_colocated(ex, lcs)
        torch.cuda.synchronize()
        hists = {lc.task_name: {j: (tuple(m.val_hist),
                                    tuple(m.raw_train_hist))
                                for j, m in lc.monitors.items()}
                 for lc in lcs}
        launched = {k: sum(m.LAUNCHES.values()) for k, m in fams.items()}
        launched["flash"] = FA.LAUNCHES["flash_attention"]
        print(f"colocated: {' + '.join(chosen)}: launches {launched}")
        require(launched["flash"] > 0,
                f"colocated {chosen}: flash attention never launched")
        return results, hists, launched

    t = time.perf_counter()
    print(f"colocated: {cfg.name} d={cfg.d_model} ff={cfg.d_ff} "
          f"L={cfg.num_layers}, Z=4, b_cap={TRAIN_B}, seq_cap={TRAIN_S}; "
          f"tasks (seed, ranks, b, S, difficulty) {tasks}")
    alone = {name: run([name]) for name in tasks}
    # the kernel set each run must launch (> 0) and those it must not (0)
    want = {("full",): ("dense", ("ragged", "rank-local")),
            ("low",): ("rank-local", ("dense", "ragged")),
            ("narrow",): ("ragged", ("rank-local",)),
            ("short",): ("ragged", ("rank-local",)),
            ("low-narrow",): ("rank-local", ("dense", "ragged")),
            ("full", "low"): ("rank-local", ("dense", "ragged")),
            ("full", "narrow"): ("ragged", ("rank-local",)),
            ("full", "short"): ("ragged", ("rank-local",)),
            ("full", "low-narrow"): ("rank-local", ("dense", "ragged"))}
    fused = {pair: run(list(pair)) for pair in want if len(pair) == 2}
    for chosen, (used, unused) in want.items():
        launched = (alone[chosen[0]] if len(chosen) == 1
                    else fused[chosen])[2]
        require(launched[used] > 0
                and all(launched[k] == 0 for k in unused),
                f"colocated {chosen}: launched {launched}, expected the "
                f"{used} kernels and none of {unused}")
    for (host, guest), (res, hists, _) in fused.items():
        for name in (host, guest):
            solo, solo_h, _ = alone[name]
            same = hists[name] == solo_h[name]  # bitwise: tuples of floats
            print(f"colocated: task '{name}' beside "
                  f"'{guest if name == host else host}': best val fused "
                  f"{res[name].best_val!r}, alone {solo[name].best_val!r}; "
                  f"loss histories bitwise equal {same}")
            require(same and res[name].best_val == solo[name].best_val,
                    f"task '{name}' co-located with "
                    f"{(host, guest)} differs from alone")
            require(math.isfinite(res[name].best_val),
                    f"task '{name}' best val not finite")
    print(f"colocated: {len(alone) + len(fused)} runs in "
          f"{time.perf_counter() - t:.1f} s")
    del params
    torch.cuda.empty_cache()


def _pair_data(cfg):
    """The DPO task's preference data: 'chosen' sequences from a
    low-entropy chain, 'rejected' from a near-uniform one."""
    from repro_torch.data.synthetic import make_task_dataset
    return tuple(make_task_dataset(name, cfg.vocab_size, seq_len=TRAIN_S,
                                   num_train=64, num_val=EVAL_B,
                                   difficulty=diff, seed=seed)
                 for name, diff, seed in (("dpo-chosen", 0.2, 5),
                                          ("dpo-rejected", 0.9, 6)))


def _dpo_jobs():
    from repro_torch.configs.base import TrainConfig
    return {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=DPO_B)
            for r in TRAIN_RANKS for lr in (1e-4, 1e-3)}


def _histories(lc):
    """Every job's validation and raw train-loss history."""
    return {j: (tuple(m.val_hist), tuple(m.raw_train_hist))
            for j, m in lc.monitors.items()}


def recovery_phase(torch, cfg):
    """Crash and resume of the DPO task on the card, stablelm-3b at full
    width and COLO_LAYERS layers, RECOVERY_STEPS steps per job (three
    warmup steps per wave, so the third chunk boundary falls inside the
    second wave, with the first wave's jobs rotated out: the crash lands
    mid-rotation): uninterrupted; crashed by a
    SimulatedCrash after the third durable checkpoint (TaskCheckpointer,
    every chunk); resumed from the latest file on a fresh executor. The
    tail's per-step losses of every resident job, every job's loss
    history, the best job and value and the winner's adapter must equal the
    uninterrupted run's bit for bit, with fewer steps run; resuming from the
    same file with one AdamW first moment of the uninterrupted run's winner
    perturbed must change the loss histories and the winner's adapter (the
    tail's losses may still read equal: the DPO losses saturate to 0 within
    a few steps here). The crash comes after the third save, or after
    the last if early exits end the task sooner (the checkpointer saves
    only at the chunk boundaries of a live task)."""
    import dataclasses

    from repro_torch.checkpoint.taskstate import (SimulatedCrash,
                                                  TaskCheckpointer,
                                                  load_task_checkpoint)
    from repro_torch.core.early_exit import EarlyExitConfig
    from repro_torch.core.executor import BatchedExecutor
    from repro_torch.data.synthetic import PairSlotBatcher
    from repro_torch.models import model as M

    cfg = dataclasses.replace(cfg, num_layers=COLO_LAYERS)
    params = M.init_params(cfg, seed=0, device="cuda")
    chosen, rejected = _pair_data(cfg)
    jobs = _dpo_jobs()
    task = "dpo-recovery"

    def executor(steps, seen):
        """A fresh executor whose train steps log each resident job's loss
        and keep the lifecycle, and whose hook counts the live chunk
        boundaries."""
        bx = BatchedExecutor(
            cfg, params, None, Z=4, per_adapter_batch=DPO_B,
            ee=EarlyExitConfig(warmup_ratio=0.25, select_ratio=0.25),
            eval_every=2, loss_kind="dpo",
            batcher=PairSlotBatcher(chosen, rejected, 4, DPO_B, seed=0),
            seq_cap=TRAIN_S)
        ex, step = bx.backbone, bx.backbone._train_step

        def logged(*args):
            out = step(*args)
            loss = out[2]["per_slot_loss"].cpu()
            (lc,) = ex.resident_tasks()
            steps.append({job: float(loss[slot])
                          for job, (_, slot) in lc.resident.items()})
            seen["lc"] = lc
            return out
        ex._train_step = logged

        def hook(lc, chunk_i):
            seen["boundaries"] = seen.get("boundaries", 0) + 1
        bx.ckpt_hook = hook
        return bx

    def drain(gen):
        while True:
            try:
                next(gen)
            except StopIteration as done:
                return done.value

    def same_winner(a, b):
        wa = a.job_results[a.best_job].adapter
        wb = b.job_results[b.best_job].adapter
        return (a.best_job == b.best_job and a.best_val == b.best_val
                and all(torch.equal(wa[t][m], wb[t][m])
                        for t in wa for m in wa[t]))

    t = time.perf_counter()
    steps0, seen0 = [], {}
    res0 = executor(steps0, seen0).run_task(task, jobs, RECOVERY_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t
    fail_after = min(3, seen0["boundaries"])
    print(f"recovery: the uninterrupted run passed {seen0['boundaries']} "
          f"live chunk boundaries: crash after save {fail_after}")
    with tempfile.TemporaryDirectory() as state_dir:
        ck = TaskCheckpointer(state_dir, every=1)
        ck.fail_after["*"] = fail_after
        bx = executor([], {})
        bx.ckpt_hook = ck.on_chunk
        crash = None
        t = time.perf_counter()
        try:
            bx.run_task(task, jobs, RECOVERY_STEPS)
        except SimulatedCrash as e:      # the check's own mechanism
            crash = e
        t_crash = time.perf_counter() - t
        require(crash is not None,
                f"the run did not crash at save {fail_after}")
        path = ck.latest(task)
        size = Path(path).stat().st_size
        del bx
        gc.collect()
        t = time.perf_counter()
        state = load_task_checkpoint(path)
        require(state is not None, f"checkpoint {path} did not load")
        steps1, seen1 = [], {}
        res1 = drain(executor(steps1, seen1).resume_task_chunks(
            task, jobs, RECOVERY_STEPS, state,
            start_chunk=state[1]["chunk"]))
        torch.cuda.synchronize()
        t_resume = time.perf_counter() - t
        # the same file with one first moment of the winner perturbed
        tree, meta = load_task_checkpoint(path)
        job = res0.best_job
        require(job in tree["snap"], f"the winner {job} has no state in the "
                f"checkpoint (jobs {sorted(tree['snap'])})")
        tree["snap"][job]["mu"]["q_proj"]["A"].reshape(-1)[0] += 1e-3
        steps2, seen2 = [], {}
        res2 = drain(executor(steps2, seen2).resume_task_chunks(
            task, jobs, RECOVERY_STEPS, (tree, meta),
            start_chunk=meta["chunk"]))
    tail = steps0[len(steps0) - len(steps1):]
    print(f"recovery: {cfg.name} d={cfg.d_model} L={cfg.num_layers}, DPO, "
          f"{len(jobs)} jobs on 4 slots: uninterrupted {len(steps0)} train "
          f"steps in {t_run:.1f} s; crashed ({crash}) in {t_crash:.1f} s "
          f"(checkpoint at chunk {state[1]['chunk']}, phase "
          f"{state[1]['phase']}, {size / 2**20:.0f} MiB); resumed "
          f"{len(steps1)} train steps in {t_resume:.1f} s")

    def versus(steps, seen, res):
        """(tail per-job losses, every loss history, every job's result,
        the winner and its adapter) each equal to the uninterrupted
        run's."""
        return (steps == tail,
                _histories(seen["lc"]) == _histories(seen0["lc"]),
                all((r.best_val, r.best_val_step, r.exit_reason,
                     r.steps_trained)
                    == (res0.job_results[j].best_val,
                        res0.job_results[j].best_val_step,
                        res0.job_results[j].exit_reason,
                        res0.job_results[j].steps_trained)
                    for j, r in res.job_results.items()),
                same_winner(res, res0))

    same = versus(steps1, seen1, res1)
    print(f"recovery: resumed vs uninterrupted, bitwise equal: tail per-job "
          f"losses, every loss history, every job's result, the winner and "
          f"its adapter {same}; best {res1.best_job} (val "
          f"{res1.best_val!r}) vs {res0.best_job} ({res0.best_val!r})")
    require(all(same), "the resumed run differs from the uninterrupted one")
    require(0 < len(steps1) < len(steps0),
            f"resumed {len(steps1)} steps, uninterrupted {len(steps0)}")
    moved = versus(steps2, seen2, res2)
    print(f"recovery: control, the winner {job}'s mu[q_proj.A][0] + 1e-3 in "
          f"the file: tail, histories, results, winner and adapter equal "
          f"{moved}")
    require(not moved[1] and not moved[3],
            "a perturbed AdamW moment of the winner left the loss histories "
            "or the winner's adapter unchanged")
    del params
    torch.cuda.empty_cache()


def _engine_tasks(alto, cfg):
    """The engine phase's three tasks: a rank sweep (the rank-local set), a
    full-rank lr sweep on the virtual cluster's two GPUs (the dense set)
    and a full-rank task of two widths (the ragged set while both are
    resident); Z from the memory model (``num_slots=0``)."""
    spaces = (("rank-sweep", 1, {"rank": [8, 32], "lr": [1e-4, 1e-3]}),
              ("lr-sweep", 2, {"rank": [64], "lr": [1e-4, 1e-3],
                               "wd": [0.0, 0.01]}),
              ("mixed-batch", 1, {"rank": [64], "batch_size": [2, 4],
                                  "lr": [3e-4]}))
    return [alto.Task(model=cfg, dataset=_task_data(cfg, name), name=name,
                      num_gpus=g, max_steps=8, search_space=space)
            for name, g, space in spaces]


def _same_task_result(torch, a, b, hists_a, hists_b):
    """(best job and value, every job's result, every loss and validation
    history, every kept adapter) of two runs of one task, bit for bit."""
    jobs = {j: (r.best_val, r.best_val_step, r.exit_reason, r.steps_trained,
                r.samples_trained) for j, r in a.job_results.items()}
    adapters = all(
        (ra.adapter is None) == (b.job_results[j].adapter is None)
        and (ra.adapter is None or all(
            torch.equal(ra.adapter[t][m], b.job_results[j].adapter[t][m])
            for t in ra.adapter for m in ra.adapter[t]))
        for j, ra in a.job_results.items())
    return ((a.best_job, a.best_val) == (b.best_job, b.best_val),
            jobs == {j: (r.best_val, r.best_val_step, r.exit_reason,
                         r.steps_trained, r.samples_trained)
                     for j, r in b.job_results.items()},
            hists_a == hists_b, adapters)


def _cpu_result(torch, res):
    """A TaskResult with every kept adapter moved to the CPU, so that a
    finished task's adapters hold no card memory while later phases run."""
    def cpu(ad):
        return None if ad is None else {
            t: {m: x.detach().cpu() for m, x in ab.items()}
            for t, ab in ad.items()}
    return dataclasses.replace(res, job_results={
        j: dataclasses.replace(r, adapter=cpu(r.adapter))
        for j, r in res.job_results.items()})


class LaunchProbe:
    """The engine phases' per-step checks, on every executor an engine
    makes: each train step must launch exactly one LoRA set at
    ``_step_launches(cfg)``' counts and flash attention once per layer of
    each forward and recompute, each eval step one set's forward pair and
    flash once per layer, the linear scan never. ``instrument`` also
    records each task's real trained tokens, steps by set, wall, peak
    memory and loss and validation histories."""

    def __init__(self, torch, fams, cfg):
        from repro_torch.kernels.flash_attention import flash_attention as FA
        from repro_torch.kernels.linear_scan import linear_scan as LSK
        self.torch = torch
        self.fams = fams
        self.mods = {**fams, "flash": FA, "scan": LSK}
        self.lora_train, self.lora_eval, (self.seq_train, self.seq_eval) = \
            _step_launches(cfg)

    def counts(self):
        return {k: dict(m.LAUNCHES) for k, m in self.mods.items()}

    def reset(self):
        for m in self.mods.values():
            m.reset_launches()

    def check_step(self, kind, delta):
        """Exactly one LoRA set, at its counts; flash at the family's."""
        want = self.lora_train if kind == "train" else self.lora_eval
        seq = self.seq_train if kind == "train" else self.seq_eval
        sets = [k for k in self.fams if any(delta[k].values())]
        ok = (len(sets) == 1 and delta[sets[0]] == want
              and delta["flash"]["flash_attention"] == seq
              and not any(delta["scan"].values()))
        require(ok, f"an engine {kind} step launched {delta}; expected one "
                    f"LoRA set at {want}, flash {seq}, no scan")
        return sets[0]

    def instrument(self, engine, log):
        """Wrap every executor ``engine`` makes from now on (replacing an
        earlier wrapping): per-step launch checks, real tokens, its
        lifecycle, and its task's wall and peak memory, into ``log``."""
        from repro_torch.core import engine as alto
        torch = self.torch

        def making(task, early_exit):
            bx = alto.Engine._make_executor(engine, task, early_exit)
            ex = bx.backbone
            rec = log.setdefault(task.task_name, {
                "sets": {}, "tokens": 0, "train": 0, "eval": 0})

            def counted(fn, kind):
                def run(*args):
                    tokens = ex.slots.occupied_tokens()
                    before = self.counts()
                    out = fn(*args)
                    now = self.counts()
                    s = self.check_step(kind, {
                        k: {n: now[k][n] - before[k][n] for n in now[k]}
                        for k in now})
                    by_set = rec["sets"].setdefault(kind, {})
                    by_set[s] = by_set.get(s, 0) + 1
                    rec[kind] += 1
                    if kind == "train":
                        rec["tokens"] += tokens
                    return out
                return run
            ex._train_step = counted(ex._train_step, "train")
            ex._eval_step = counted(ex._eval_step, "eval")
            add = ex.add_task

            def add_task(lc):
                rec["lc"] = lc
                add(lc)
            ex.add_task = add_task
            chunks = bx.run_task_chunks
            resume = bx.resume_task_chunks

            def timed(gen):
                gc.collect()        # the previous task's executor
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t = time.perf_counter()
                result = yield from gen
                torch.cuda.synchronize()
                rec["wall"] = time.perf_counter() - t
                rec["peak"] = torch.cuda.max_memory_allocated()
                # the lifecycle holds the executor: keep its histories only
                rec["hists"] = _histories(rec.pop("lc"))
                return result
            bx.run_task_chunks = lambda *a, **k: timed(chunks(*a, **k))
            bx.resume_task_chunks = lambda *a, **k: timed(resume(*a, **k))
            return bx
        engine._make_executor = making

    def keep_drivers(self, engine, drivers):
        """Keep every driver ``engine``'s factories make, by task name."""
        from repro_torch.core import engine as alto

        def keeping(task, early_exit):
            factory = alto.Engine.executor_driver_factory(engine, task,
                                                          early_exit)

            def make():
                drivers[task.task_name] = factory()
                return drivers[task.task_name]
            return make
        engine.executor_driver_factory = keeping


def engine_phase(torch, fams):
    """Listing 1 on the card: ``Engine(total_gpus=ENGINE_G, eval_every=2,
    device="cuda")`` on full-size stablelm-3b (its own backbone, random
    weights from seed 0) schedules three tasks on a virtual cluster of
    ENGINE_G GPUs and runs them twice, one card training every task in
    turn: through ``batched_execution(strategy="static")``, then through
    ``batched_execution`` elastic (the default: a one-shot ``TuningService``
    session under the strict adoption rule, without co-location) from the
    same schedule. Every executor the engine makes is wrapped
    (``LaunchProbe``): each train step must launch exactly one LoRA set
    with ``_step_launches``' counts and flash 64 times, each eval step one
    set's forward pair and flash 32 times, the linear scan never. Each
    task's results must be equal in both runs bit for bit and the elastic
    virtual makespan no larger than the static one; the three sets must
    each launch. Returns each strategy's launches by kernel module and,
    per task, the static result (adapters on the CPU) and its histories
    for the service phase."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import engine as alto
    from repro_torch.sched import cluster, profiler

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"engine: planner's HBM_BYTES {profiler.HBM_BYTES:.4g} B "
          f"({profiler.HBM_BYTES / 2**30:.2f} GiB), card {total} B "
          f"({total / 2**30:.2f} GiB); PEAK_FLOPS_BF16 "
          f"{profiler.PEAK_FLOPS_BF16:.4g}, HBM_BYTES_PER_S "
          f"{profiler.HBM_BYTES_PER_S:.4g}")
    require(profiler.HBM_BYTES <= total,
            f"the planner's HBM_BYTES {profiler.HBM_BYTES} exceeds the "
            f"card's {total} bytes")
    cfg = get_arch("stablelm-3b")
    ee = alto.EarlyExit(warmup_ratio=0.25, select_ratio=0.5)
    probe = LaunchProbe(torch, fams, cfg)

    t = time.perf_counter()
    engine = alto.Engine(total_gpus=ENGINE_G, eval_every=2, device="cuda")
    tasks = _engine_tasks(alto, cfg)
    schedule = engine.schedule(tasks, method="cp", early_exit=ee)
    schedule.validate(ENGINE_G)
    note = (f"virtual cluster of G = {ENGINE_G}; one card trains every task "
            f"in turn")
    print(f"engine: schedule ({note}), cp, {schedule.solve_time_s * 1e3:.2f}"
          f" ms to solve, optimal {schedule.optimal}, virtual makespan "
          f"{schedule.makespan!r} s at the H100 constants (analytic, mfu "
          f"0.4):")
    for p in sorted(schedule.placements, key=lambda p: p.start):
        task = next(x for x in tasks if x.task_name == p.task.name)
        print(f"engine:   {p.task.name}: start {p.start!r} s on GPUs "
              f"{p.gpu_ids}, duration {p.task.duration!r} s = "
              f"{len(task.jobs())} jobs on Z = {engine.pick_slots(task)} "
              f"at an analytic {engine.profiled_step_time(task) * 1e3:.3f} "
              f"ms a step")

    static_log, elastic_log, drivers = {}, {}, {}
    probe.instrument(engine, static_log)
    gc.collect()
    torch.cuda.empty_cache()
    probe.reset()
    t0 = time.perf_counter()
    static = engine.batched_execution(tasks, schedule, ee, strategy="static")
    static_wall = time.perf_counter() - t0
    static_launches = probe.counts()

    probe.instrument(engine, elastic_log)
    probe.keep_drivers(engine, drivers)
    gc.collect()
    torch.cuda.empty_cache()
    probe.reset()
    t0 = time.perf_counter()
    elastic = engine.batched_execution(tasks, schedule, ee)
    elastic_wall = time.perf_counter() - t0
    elastic_launches = probe.counts()
    require(elastic.execution == "elastic", f"batched_execution ran "
            f"{elastic.execution!r} by default")

    for label, rep, wall, log in (("static", static, static_wall, static_log),
                                  ("elastic", elastic, elastic_wall,
                                   elastic_log)):
        tokens = sum(r["tokens"] for r in log.values())
        print(f"engine: {label}: virtual makespan {rep.virtual_makespan!r} "
              f"s, utilization {rep.utilization:.4f}, replans {rep.replans} "
              f"({note}); wall {wall:.3f} s for {tokens} real trained "
              f"tokens = {tokens / wall:.1f} tokens/s over the whole run")
    for task in tasks:
        name = task.task_name
        s, e, d = static_log[name], elastic_log[name], drivers[name]
        Z = engine.pick_slots(task)
        b = max(tc.per_adapter_batch for tc in task.jobs().values())
        m_hat = engine.memory_model(task).predict(Z * b)
        same = _same_task_result(torch, elastic.task_results[name],
                                 static.task_results[name], e["hists"],
                                 s["hists"])
        res = static.task_results[name]
        print(f"engine: {name}: {len(task.jobs())} jobs on Z = {Z} "
              f"(pick_slots), b {b}, {task.num_gpus} virtual GPU(s); best "
              f"{res.best_job} (val {res.best_val!r}), exits "
              f"{res.exit_counts}; steps by LoRA set: static {s['sets']}, "
              f"elastic {e['sets']}")
        print(f"engine: {name}: M_hat(Z b = {Z * b}) {m_hat / 2**30:.2f} GiB "
              f"(per virtual GPU of {task.num_gpus}) vs measured peak "
              f"{e['peak'] / 2**30:.2f} GiB elastic, {s['peak'] / 2**30:.2f}"
              f" GiB static")
        step_s = engine.profiled_step_time(task)
        print(f"engine: {name}: analytic step {step_s * 1e3:.3f} ms (mfu "
              f"0.4, {task.num_gpus} GPU(s)) vs observed "
              f"wall step {d.observed_wall_step_s() * 1e3:.3f} ms "
              f"(ExecutorTaskDriver.observed_wall_step_s); real tokens/s "
              f"over the task's wall: elastic "
              f"{e['tokens'] / e['wall']:.1f}, static "
              f"{s['tokens'] / s['wall']:.1f}")
        print(f"engine: {name}: elastic == static, bit for bit (best, jobs, "
              f"histories, adapters): {same}")
        require(all(same), f"{name}: the elastic run's TaskResult differs "
                           f"from the static run's")
    eps = cluster._EPS
    mk, smk = elastic.virtual_makespan, static.virtual_makespan
    print(f"engine: elastic virtual makespan {mk!r} <= static {smk!r} (+ "
          f"the runtime's epsilon {eps:g}): {mk <= smk + eps}")
    require(mk <= smk + eps,
            "the elastic virtual makespan exceeds the static one")
    for label, launches in (("static", static_launches),
                            ("elastic", elastic_launches)):
        print(f"engine: {label} launches {launches}")
        require(all(any(launches[k].values()) for k in fams)
                and not any(launches["scan"].values()),
                f"the {label} run did not launch every LoRA set, or ran "
                f"the scan: {launches}")
    handover = {name: (_cpu_result(torch, res), static_log[name]["hists"])
                for name, res in static.task_results.items()}
    del engine, drivers, static, elastic, static_log, elastic_log
    gc.collect()
    torch.cuda.empty_cache()
    print(f"engine phase took {time.perf_counter() - t:.1f} s")
    return static_launches, elastic_launches, handover


def _serving_frontend(torch, cfg, params, Z=4):
    """The serve cell's frontend over ``params``: an empty AdapterPool of
    ``Z`` slots, a ServingReplica of LANES lanes and MAX_LEN positions."""
    from repro_torch.serve import AdapterPool, ServingFrontend, ServingReplica
    pool = AdapterPool(cfg, Z, device="cuda")
    rep = ServingReplica(cfg, params, pool, lanes=LANES, max_len=MAX_LEN,
                         device="cuda")
    return pool, ServingFrontend(rep, mode="continuous")


def _served_tokens(fe, requests):
    """Greedy token streams of ``requests`` ((adapter id, prompt) pairs)
    through ``fe``, in submission order."""
    rids = [fe.submit(aid, prompt, MAX_NEW) for aid, prompt in requests]
    fe.drain()
    return [fe.result(r) for r in rids]


def _fresh_tokens(torch, cfg, params, published, requests):
    """The same requests through a fresh pool, replica and frontend on the
    same backbone, into which each ``(adapter id, adapter, rank)`` of
    ``published`` was published from memory."""
    pool, fe = _serving_frontend(torch, cfg, params)
    for aid, adapter, rank in published:
        pool.publish(aid, adapter, rank)
    out = _served_tokens(fe, requests)
    del pool, fe
    return out


def _serve_requests(cfg, adapters, n_each, seed=7):
    """``n_each`` greedy requests per adapter id, prompts of 32-128
    tokens from a seeded task dataset."""
    import numpy as np

    from repro_torch.data.synthetic import make_task_dataset
    n = n_each * len(adapters)
    ds = make_task_dataset("served", cfg.vocab_size, seq_len=128,
                           num_train=n, difficulty=0.3, seed=seed)
    lens = np.random.default_rng(seed).integers(32, 129, n)
    return [(adapters[i % len(adapters)], ds.train[i, :int(lens[i])])
            for i in range(n)]


def service_phase(torch, fams, handover):
    """One live ``TuningService`` session on full-size stablelm-3b (its own
    backbone, random weights from seed 0): ``TuningService(engine=Engine(
    total_gpus=ENGINE_G, eval_every=2, device="cuda"), serve_dir=...)`` with
    the defaults (bounded-delay adoption at delta 2, co-location, fusion
    planning, migration) and the serve cell's frontend attached as a
    serving lease of one virtual GPU. The engine phase's tasks, under
    their names and tenants: rank-sweep at 0, mixed-batch at 0.25 x
    rank-sweep's admitted duration (the lease and rank-sweep hold both
    virtual GPUs, so it must fuse onto rank-sweep's replica), lr-sweep at
    2 x, cancelled at 0.25 x before it arrives. Driven through the
    handles, then the lease is cancelled. Checked: states; the fusion;
    each completed task equal to the engine phase's static result bit for
    bit; the two winners published from their artifacts with their
    metadata; 8 served requests equal to a fresh pool holding the live
    winners; the feedback loop's observations; every step's launches.
    Returns the training launches and the serving launches by module."""
    import numpy as np

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import engine as alto
    from repro_torch.core.service import (TaskCancelled, TaskState,
                                          TuningService)
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.grouped_lora import ranklocal as RL
    from repro_torch.sched.events import EventKind
    from repro_torch.serve import SPEC_VERSION

    t = time.perf_counter()
    cfg = get_arch("stablelm-3b")
    ee = alto.EarlyExit(warmup_ratio=0.25, select_ratio=0.5)
    probe = LaunchProbe(torch, fams, cfg)
    tasks = {x.task_name: x for x in _engine_tasks(alto, cfg)}
    engine = alto.Engine(total_gpus=ENGINE_G, eval_every=2, device="cuda")
    log, drivers = {}, {}
    probe.instrument(engine, log)
    probe.keep_drivers(engine, drivers)
    params = engine._base_params(cfg)
    serve_dir = tempfile.mkdtemp(prefix="service-serve-")
    try:
        svc = TuningService(engine=engine, serve_dir=serve_dir)
        pool, fe = _serving_frontend(torch, cfg, params)
        lease = svc.attach_serving(fe, gpus=1, horizon_s=10_000.0,
                                   chunk_s=LEASE_CHUNK_S)
        gc.collect()
        torch.cuda.empty_cache()
        probe.reset()
        t0 = time.perf_counter()
        h_rank = svc.submit(tasks["rank-sweep"], early_exit=ee,
                            tenant="tenant-a")
        dur = svc._meta["rank-sweep"].spec.duration
        h_mixed = svc.submit(tasks["mixed-batch"], at=0.25 * dur,
                             early_exit=ee, tenant="tenant-b")
        h_lr = svc.submit(tasks["lr-sweep"], at=2 * dur, early_exit=ee,
                          tenant="tenant-c")
        h_lr.cancel(at=0.25 * dur)
        res = {"rank-sweep": h_rank.result(),
               "mixed-batch": h_mixed.result()}
        lease.cancel()
        report = svc.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = probe.counts()

        # 1. states
        states = {h.name: h.status().state
                  for h in (h_rank, h_mixed, h_lr, lease)}
        print(f"service: {cfg.name} L={cfg.num_layers} d={cfg.d_model}, "
              f"virtual cluster of {ENGINE_G} (a 1-GPU serving lease and "
              f"the tasks), rank-sweep admitted for {dur!r} s: states "
              f"{ {n: s.value for n, s in states.items()} }; wall "
              f"{wall:.3f} s")
        require(states == {"rank-sweep": TaskState.COMPLETED,
                           "mixed-batch": TaskState.COMPLETED,
                           "lr-sweep": TaskState.CANCELLED,
                           "serve/replica-0": TaskState.CANCELLED},
                f"service states {states}")
        cancelled = False
        try:
            h_lr.result()
        except TaskCancelled:       # the check's own mechanism
            cancelled = True
        require(cancelled and "lr-sweep" not in log,
                "lr-sweep's result() did not raise TaskCancelled, or it "
                "trained")
        # 2. co-location on rank-sweep's replica
        fused = [e for e in report.events if e.kind is EventKind.TASK_FUSED]
        starts, ends = report.task_starts, report.task_ends
        print(f"service: co-located {report.colocated}, fused events "
              f"{[(e.task, e.time, e.detail) for e in fused]}; submitted "
              f"at {svc.status('mixed-batch').submitted_at!r}; starts "
              f"{starts}, ends {ends}; makespan {report.makespan!r}, "
              f"replans {report.replans}, adopted {report.plans_adopted}, "
              f"rejected {report.plans_rejected}")
        require(report.colocated == {"mixed-batch": "rank-sweep"}
                and [e.task for e in fused] == ["mixed-batch"]
                and starts["mixed-batch"] < ends["rank-sweep"]
                and ends["mixed-batch"] <= ends["rank-sweep"],
                f"mixed-batch did not run on rank-sweep's replica: "
                f"{report.colocated}, ends {ends}")
        # 3. bitwise against the engine phase's static runs
        for name, r in res.items():
            base, hists = handover[name]
            same = _same_task_result(torch, _cpu_result(torch, r), base,
                                     log[name]["hists"], hists)
            rec = log[name]
            print(f"service: {name}: best {r.best_job} (val "
                  f"{r.best_val!r}); {rec['tokens']} real trained tokens in "
                  f"{rec['wall']:.3f} s = {rec['tokens'] / rec['wall']:.1f} "
                  f"tokens/s; == the engine phase's static run, bit for bit "
                  f"(best, jobs, histories, adapters): {same}")
            require(all(same), f"{name}: the service's TaskResult differs "
                               f"from the static engine's")
        # 4. tune-to-serve artifacts and publish events
        pubs = [e for e in report.events
                if e.kind is EventKind.ADAPTER_PUBLISHED]
        arts = sorted(Path(serve_dir).glob("*.npz"))
        print(f"service: artifacts {[p.name for p in arts]} "
              f"({sum(p.stat().st_size for p in arts) / 2**20:.1f} MiB); "
              f"publish events {[(e.task, e.reason, e.detail) for e in pubs]}"
              f"; pool {pool.resident()}")
        require(len(arts) == 2 and sorted(e.task for e in pubs) == sorted(res)
                and all(e.reason == "published"
                        and "from=checkpoint" in e.detail for e in pubs)
                and set(pool.resident()) == set(res),
                "the winners were not both published from their artifacts")
        for name, r in res.items():
            meta = json.loads(str(np.load(svc._ckpt_paths[name],
                                          allow_pickle=False)["__meta__"]))
            jr = r.job_results[r.best_job]
            want = {"rank": jr.config.lora_rank, "spec_version": SPEC_VERSION,
                    "arch": cfg.name, "fuse_key": [cfg.name, 1, "sft"],
                    "job": r.best_job}
            require({k: meta[k] for k in want} == want,
                    f"{name}: artifact metadata {meta} != {want}")
        # 5. served answers against the live winners on a fresh pool
        requests = _serve_requests(cfg, sorted(res), 4)
        RL.reset_launches()
        FA.reset_launches()
        t1 = time.perf_counter()
        served = _served_tokens(fe, requests)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t1
        serve_launches = {"ranklocal": dict(RL.LAUNCHES),
                          "flash": dict(FA.LAUNCHES)}
        fresh = _fresh_tokens(torch, cfg, params, [
            (n, r.job_results[r.best_job].adapter,
             r.job_results[r.best_job].config.lora_rank)
            for n, r in res.items()], requests)
        n_tok = sum(len(s) for s in served)
        print(f"service: served {len(requests)} requests ({n_tok} tokens) "
              f"from the published artifacts in {serve_s:.3f} s = "
              f"{n_tok / serve_s:.1f} tok/s; == a fresh pool holding the "
              f"live winners, token for token: {served == fresh}; launches "
              f"{serve_launches}")
        require(served == fresh and all(len(s) == MAX_NEW for s in served),
                "served tokens from the artifacts differ from the live "
                "winners'")
        require(all(serve_launches["ranklocal"][k] > 0
                    for k in ("xa", "sb_add"))
                and not any(serve_launches["ranklocal"][k]
                            for k in ("ds", "dx", "da", "db"))
                and serve_launches["flash"]["flash_attention"] == 0,
                f"serving launched {serve_launches}")
        # 6. the feedback loop
        store = svc.profile_store
        done = sorted(res, key=lambda n: ends[n])   # the order recorded
        for name in done:
            key = engine.profile_key(tasks[name])
            est = svc._meta[name].unscaled_duration
            realized = ends[name] - starts[name]
            again = store.scaled_duration(
                key, engine.profile_raw(tasks[name], ee).duration)
            step_s = engine.profiled_step_time(tasks[name])
            print(f"service: {name}: key {key}: realized/estimated "
                  f"{realized!r} / {est!r} = {realized / est:.4f} (the "
                  f"runtime's recorded start to its end); wall step "
                  f"{drivers[name].observed_wall_step_s() * 1e3:.3f} ms vs "
                  f"analytic {step_s * 1e3:.3f} ms; a second submission "
                  f"would be admitted for {again!r} s (scale "
                  f"{store.duration_scale(key):.4f})")
        key = engine.profile_key(tasks["rank-sweep"])
        require(key == engine.profile_key(tasks["mixed-batch"]),
                "rank-sweep and mixed-batch have different profile keys")
        obs = store.step_observations(key)
        for name, o in zip(done, obs):
            print(f"service: step observation ({name}): tokens {o.tokens:g}, "
                  f"rank-tokens {o.rank_tokens:g}, wall {o.wall_s * 1e3:.3f} "
                  f"ms, recorded peak (the memory model's prediction) "
                  f"{o.peak_memory / 2**30:.2f} GiB vs the card's measured "
                  f"peak {log[name]['peak'] / 2**30:.2f} GiB")
        require(store.observations(key) == 2 and len(obs) == 2
                and store.wall_step_time(key) > 0,
                f"feedback: {store.observations(key)} observations, "
                f"{len(obs)} step observations")
        # 7. launches
        print(f"service: launches {launches}; steps by LoRA set "
              f"{ {n: r['sets'] for n, r in log.items()} }")
        require(set(log) == set(res)
                and not any(launches["scan"].values()),
                f"the service trained {sorted(log)} or ran the scan")
        del svc, lease, h_rank, h_mixed, h_lr, res, report, pool, fe
    finally:
        shutil.rmtree(serve_dir, ignore_errors=True)
    del engine, params, drivers, log
    gc.collect()
    torch.cuda.empty_cache()
    print(f"service phase took {time.perf_counter() - t:.1f} s")
    return launches, serve_launches


def service_recovery_phase(torch, fams):
    """Kill and recover through the service at full width and COLO_LAYERS
    layers: the reference's recovery task (8 jobs of lr 1e-4/1e-3, rank
    8/32, b 2/4 on 4 slots, 1 GPU, RECOVERY_STEPS steps a job,
    EarlyExit(0.2, 0.5)) run by an uninterrupted session; then by a
    session with ``state_dir``, ``serve_dir`` and ``ckpt_every=1`` that a
    SimulatedCrash ends after the third durable checkpoint; then
    ``TuningService.recover(state_dir, tasks=..., serve_frontend=fe4,
    device="cuda")``. The recovered result must equal the uninterrupted
    one bit for bit with fewer steps run, one TASK_RECOVERED "resumed",
    the journal must hold the session, one submit, the checkpoints and
    the task's end; the winner is published once from its artifact and
    served as the live winner on a fresh pool, also after a serving pod
    is replaced (``republish_served``). Control: a second crash with every
    snapshot trashed recovers by requeue, equal, with as many steps.
    Returns the launches by module of the recovered session."""
    from repro_torch.checkpoint.taskstate import SimulatedCrash
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import engine as alto
    from repro_torch.core.service import TuningService
    from repro_torch.models import model as M
    from repro_torch.sched.events import EventKind
    from repro_torch.sched.journal import replay_journal

    t = time.perf_counter()
    cfg = dataclasses.replace(get_arch("stablelm-3b"), num_layers=COLO_LAYERS)
    ee = alto.EarlyExit(warmup_ratio=0.2, select_ratio=0.5)
    probe = LaunchProbe(torch, fams, cfg)
    params = M.init_params(cfg, seed=0, device="cuda")
    name = "tenant-r"
    task = alto.Task(model=cfg, dataset=_task_data(cfg, name), name=name,
                     num_gpus=1, max_steps=RECOVERY_STEPS, num_slots=4,
                     search_space={"lr": [1e-4, 1e-3], "rank": [8, 32],
                                   "batch_size": [2, 4]})

    def engine(log):
        eng = alto.Engine(total_gpus=ENGINE_G, eval_every=2, device="cuda")
        eng._param_cache[cfg.name] = params
        probe.instrument(eng, log)
        return eng

    def timed_saves(ck, spent):
        """Gather the seconds of each durable save of ``ck`` (the lifecycle
        export, the fsynced file and the journal record) into ``spent``."""
        save = ck.on_chunk

        def on_chunk(lc, chunk_i):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            before = ck.saves.get(lc.task_name, 0)
            try:
                save(lc, chunk_i)
            finally:
                if ck.saves.get(lc.task_name, 0) > before:
                    spent.append(time.perf_counter() - t0)
        ck.on_chunk = on_chunk

    def crash(state_dir, serve_dir, spent):
        """A session that dies after its third durable checkpoint."""
        svc = TuningService(engine=engine({}), state_dir=state_dir,
                            serve_dir=serve_dir, ckpt_every=1)
        svc._ckpt.fail_after["*"] = 3
        timed_saves(svc._ckpt, spent)
        h = svc.submit(task, early_exit=ee)
        t0 = time.perf_counter()
        died = None
        try:
            h.result()
        except SimulatedCrash as e:      # the check's own mechanism
            died = e
        require(died is not None, "the session did not crash")
        saves = svc._ckpt.saves.get(name, 0)
        svc._journal.close()
        del svc, h
        gc.collect()
        torch.cuda.empty_cache()
        return died, saves, time.perf_counter() - t0

    def recover(state_dir, fe, spent):
        """(service, report, log, seconds to rebuild the session from the
        journal and the latest snapshot, seconds to drain it)."""
        log = {}
        t0 = time.perf_counter()
        svc = TuningService.recover(state_dir, tasks=[(task, ee)],
                                    serve_frontend=fe, device="cuda")
        t_load = time.perf_counter() - t0
        svc.engine._param_cache[cfg.name] = params
        probe.instrument(svc.engine, log)
        timed_saves(svc._ckpt, spent)
        t0 = time.perf_counter()
        rep = svc.run_until_idle()
        torch.cuda.synchronize()
        return svc, rep, log, t_load, time.perf_counter() - t0

    base_log = {}
    t0 = time.perf_counter()
    svc0 = TuningService(engine=engine(base_log))
    res0 = svc0.submit(task, early_exit=ee).result()
    torch.cuda.synchronize()
    t_base = time.perf_counter() - t0
    steps0 = svc0._meta[name].driver._steps
    del svc0
    win0 = res0.job_results[res0.best_job]
    requests = _serve_requests(cfg, [name], 2)
    want = _fresh_tokens(torch, cfg, params, [
        (name, win0.adapter, win0.config.lora_rank)], requests)
    with tempfile.TemporaryDirectory() as root:
        state_dir, serve_dir = f"{root}/state", f"{root}/serve"
        saves_s = []
        died, saves, t_crash = crash(state_dir, serve_dir, saves_s)
        journal = Path(state_dir, "journal")
        j_bytes = sum(p.stat().st_size for p in journal.glob("*.jsonl"))
        ckpts = sorted(Path(state_dir, "ckpt").rglob("*.npz"))
        print(f"service recovery: {cfg.name} d={cfg.d_model} "
              f"L={cfg.num_layers}, {len(task.jobs())} jobs on Z 4: "
              f"uninterrupted {steps0} steps in {t_base:.1f} s; crashed "
              f"({died}) after {saves} saves in {t_crash:.1f} s; journal "
              f"{len(replay_journal(state_dir).records)} records, {j_bytes} "
              f"B; snapshots kept {[p.name for p in ckpts]}, "
              f"{sum(p.stat().st_size for p in ckpts) / 2**20:.0f} MiB; "
              f"saves {[round(s, 3) for s in saves_s]} s")
        pool4, fe4 = _serving_frontend(torch, cfg, params)
        probe.reset()
        rec_saves = []
        svc, rep, log, t_load, t_rec = recover(state_dir, fe4, rec_saves)
        launches = probe.counts()
        res = rep.task_results[name]
        steps = svc._meta[name].driver._steps
        same = _same_task_result(torch, res, res0, log[name]["hists"],
                                 base_log[name]["hists"])
        recov = [(e.task, e.reason, e.detail) for e in rep.events
                 if e.kind is EventKind.TASK_RECOVERED]
        print(f"service recovery: recover() (journal replay, snapshot "
              f"load, resubmission) {t_load:.3f} s; then {steps} steps in "
              f"{t_rec:.1f} s with {len(rec_saves)} saves of "
              f"{sum(rec_saves):.1f} s together ({recov}); == uninterrupted, "
              f"bit for bit (best, jobs, histories, adapters): {same}; best "
              f"{res.best_job} (val {res.best_val!r})")
        require(all(same) and 0 < steps < steps0
                and [r[:2] for r in recov] == [(name, "resumed")],
                f"recovered {steps} steps (uninterrupted {steps0}), "
                f"{recov}, equal {same}")
        jr = replay_journal(state_dir)
        kinds = [r["rec"] for r in jr.records]
        j_bytes = sum(p.stat().st_size for p in journal.glob("*.jsonl"))
        print(f"service recovery: journal {len(kinds)} records, {j_bytes} "
              f"B ({ {k: kinds.count(k) for k in sorted(set(kinds))} }), "
              f"corrupt {jr.corrupt}, torn {jr.torn_tail}")
        require(jr.session() is not None and len(jr.submits()) == 1
                and kinds.count("ckpt") >= 3
                and name in jr.terminal_tasks() and not jr.corrupt,
                "the journal lacks the session, the submit, the "
                "checkpoints or the task's end")
        pubs = [(e.reason, e.detail) for e in rep.events
                if e.kind is EventKind.ADAPTER_PUBLISHED]
        got = _served_tokens(fe4, requests)
        print(f"service recovery: published {pubs}; served == the "
              f"uninterrupted run's live winner on a fresh pool: "
              f"{got == want}")
        require(len(pubs) == 1 and pubs[0][0] == "published"
                and "from=checkpoint" in pubs[0][1] and got == want
                and set(pool4.resident()) == {name},
                "the recovered winner was not served from its artifact")
        del pool4, fe4
        pool5, fe5 = _serving_frontend(torch, cfg, params)
        again = svc.republish_served(fe5)
        got5 = _served_tokens(fe5, requests)
        print(f"service recovery: a replaced serving pod republished "
              f"{again}; served == live winner: {got5 == want}")
        require(again == [name] and got5 == want,
                "the replaced serving pod did not serve the winner")
        del svc, rep, res, pool5, fe5
        gc.collect()
        torch.cuda.empty_cache()

        # control: every snapshot trashed, recovery requeues from zero
        state_dir, serve_dir = f"{root}/state2", f"{root}/serve2"
        crash(state_dir, serve_dir, [])
        for p in Path(state_dir, "ckpt").rglob("*.npz"):
            p.write_bytes(b"\x00" * 100)
        svc, rep, log, _, t_rec = recover(state_dir, None, [])
        res = rep.task_results[name]
        steps = svc._meta[name].driver._steps
        same = _same_task_result(torch, res, res0, log[name]["hists"],
                                 base_log[name]["hists"])
        recov = [(e.task, e.reason) for e in rep.events
                 if e.kind is EventKind.TASK_RECOVERED]
        print(f"service recovery: control, snapshots trashed: {recov}, "
              f"{steps} steps in {t_rec:.1f} s, == uninterrupted {same}")
        require(recov == [(name, "requeued")] and all(same)
                and steps == steps0,
                f"the control recovered {recov} with {steps} steps, equal "
                f"{same}")
        del svc, rep, res
    del params, res0, win0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"service recovery phase took {time.perf_counter() - t:.1f} s")
    return launches


def _kernel_family(name: str) -> str:
    """The kernel set a profiled grouped-LoRA kernel belongs to, read from
    its last two template arguments (ROWS, RANKS); "" for other kernels."""
    if not any(k in name for k in ("narrow_out_kernel", "rank_sum_kernel",
                                   "tn_kernel")):
        return ""
    flags = re.findall(r"(true|false), (true|false)>", name)
    return {("true", "true"): "rank-local", ("true", "false"): "ragged",
            ("false", "false"): "dense"}.get(flags[-1] if flags else None,
                                             "unidentified")


LORA_TEMPLATES = ("narrow_out_kernel", "rank_sum_kernel", "tn_kernel")


def print_template_sums(tag, kernels, busy_us, steps=2):
    """Per-step device time and launches of each grouped-LoRA kernel
    template (all three sets together) in a profile's ``kernels`` ({name:
    (launches, us)}), and their share of the device busy time."""
    sums = {t: [0, 0.0] for t in LORA_TEMPLATES}
    for name, (n, us) in kernels.items():
        for t in LORA_TEMPLATES:
            if t in name:
                sums[t][0] += n
                sums[t][1] += us
    total = sum(us for _, us in sums.values())
    print(f"profile ({tag}): grouped-LoRA templates per step: " + ", ".join(
        f"{t} {us / steps / 1e3:.2f} ms ({n // steps} launches)"
        for t, (n, us) in sums.items())
        + f"; together {total / steps / 1e3:.2f} ms = "
        f"{total / busy_us:.3f} of the device busy time")


def colocation_phase(torch, fams, cfg, params):
    """The slice's main path: heterogeneous multi-task co-location on
    full-size ``cfg``. Three full-rank tuning tasks, 4 jobs each (every job
    at r_max), each on at most 2 slots of one SharedBackboneExecutor (Z =
    4, b_cap = TRAIN_B, seq_cap = TRAIN_S), given to run_colocated in this
    order: "wide" (b = 4, S = 256, lr 1e-4/1e-3 x wd 0/0.01), "narrow"
    (b = 2, S = 256, lr 3e-4/3e-3 x wd 0/0.01), "short" (b = 4, S = 128,
    lr 1e-4/1e-3 x wd 0/0.01); 8 steps per job, warmup 0.25, select 0.5.
    "short" must wait at the admission gate until a running task frees its
    slots. Every fused train step must launch the kernel set that
    ``_assemble``'s dense flag selects (the ragged set when some slot is
    narrower than the lane, the dense set otherwise; xa/sb_add 448, ds/da/db
    224, dx 221) and no other, every eval step the dense forward pair
    (224 each), the rank-local set never. Reports real tokens/s over the
    whole run_colocated wall and the padded share of the capacity tokens,
    the wall's breakdown, the median _train_step call per resident mix,
    peak memory, each task's best job, and two mixed-width train steps
    under torch.profiler (device busy, the ragged kernels' share). Returns
    the run's launches per kernel set."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.early_exit import EarlyExitConfig
    from repro_torch.core.executor import (SharedBackboneExecutor,
                                           TaskLifecycle, run_colocated)
    from repro_torch.data.synthetic import make_task_dataset
    from repro_torch.kernels.flash_attention import flash_attention as FA

    sync = torch.cuda.synchronize
    Z = 4
    want_train, want_eval, (flash_train, flash_eval) = _step_launches(cfg)
    zero = dict.fromkeys(want_train, 0)
    fams = dict(fams, flash=FA)
    gc.collect()
    torch.cuda.empty_cache()
    ex = SharedBackboneExecutor(cfg, params, Z=Z, per_adapter_batch=TRAIN_B,
                                eval_every=2, seq_cap=TRAIN_S)
    ee = EarlyExitConfig(warmup_ratio=0.25, select_ratio=0.5)
    specs = [("wide", TRAIN_B, TRAIN_S, (1e-4, 1e-3), 1),
             ("narrow", 2, TRAIN_S, (3e-4, 3e-3), 2),
             ("short", TRAIN_B, TRAIN_S // 2, (1e-4, 1e-3), 3)]
    lcs = []
    for name, b, seq, lrs, seed in specs:
        ds = make_task_dataset(name, cfg.vocab_size, seq_len=seq,
                               num_train=64, num_val=EVAL_B, difficulty=0.3,
                               seed=seed)
        jobs = {f"{name}/lr{lr:g}-wd{wd:g}": TrainConfig(
                    learning_rate=lr, weight_decay=wd,
                    lora_rank=cfg.lora.r_max, per_adapter_batch=b)
                for lr in lrs for wd in (0.0, 0.01)}
        lcs.append(TaskLifecycle(ex, name, jobs, 8, ee=ee, max_slots=2,
                                 dataset=ds, seed=seed))
    # per train step: (mix, dense, launches per set, ms, real tokens,
    # profiled); per eval step: launches per set
    log = {"train": [], "eval": []}
    began = {}
    flag = {}
    prof = {"busy_us": 0.0, "wall_us": 0.0, "kernels": {}}
    traces = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def launches():
        return {k: dict(m.LAUNCHES) for k, m in fams.items()}

    def delta(before):
        now = launches()
        return {k: {n: now[k][n] - before[k][n] for n in now[k]}
                for k in now}

    real_assemble = ex._assemble

    def assemble():
        out = real_assemble()
        flag["dense"] = out[2]
        return out
    ex._assemble = assemble

    def counted(fn, kind):
        def run(*args):
            mix = "+".join(lc.task_name for lc in ex.resident_tasks())
            tokens = ex.slots.occupied_tokens()
            profiled = (kind == "train" and len(log["train"]) in (2, 3))
            before = launches()
            sync()
            t = time.perf_counter()
            if profiled:
                with torch.profiler.profile(activities=acts) as p:
                    out = fn(*args)
                    sync()
            else:
                out = fn(*args)
                sync()
            dt = time.perf_counter() - t
            if kind == "train":
                log["train"].append((mix, flag["dense"], delta(before),
                                     dt * 1e3, tokens, profiled))
            else:
                log["eval"].append(delta(before))
            if profiled:     # its events are read after the run
                prof["wall_us"] += dt * 1e6
                traces.append(p)
            return out
        return run

    ex._train_step = counted(ex._train_step, "train")
    ex._eval_step = counted(ex._eval_step, "eval")
    spent = {}
    _clock(torch, ex, spent)
    for lc in lcs:
        def begin(lc=lc, real=lc.begin):
            others = {o.task_name: (o.phase, o.slots_bound()) for o in lcs
                      if o is not lc and o.phase != "idle"}
            began[lc.task_name] = (len(log["train"]), others)
            real()
        lc.begin = begin
    torch.cuda.reset_peak_memory_stats()
    for m in fams.values():
        m.reset_launches()
    t0 = time.perf_counter()
    results = run_colocated(ex, lcs)
    wall = time.perf_counter() - t0
    totals = launches()
    peak = torch.cuda.max_memory_allocated()
    by_family = {}
    for p in traces:
        for name, us_e in device_events(torch, p):
            n, us = prof["kernels"].get(name, (0, 0.0))
            prof["kernels"][name] = (n + 1, us + us_e)
            prof["busy_us"] += us_e
            fam = _kernel_family(name)
            if fam:
                by_family[fam] = by_family.get(fam, 0.0) + us_e
    del traces

    tag = "colocation"
    require(set(results) == {name for name, *_ in specs},
            f"run_colocated returned {sorted(results)}")
    for lc in lcs:
        res = results[lc.task_name]
        require(res.best_job in lc.jobs and math.isfinite(res.best_val),
                f"task {lc.task_name}: best {res.best_job} {res.best_val}")
    step_short, others = began["short"]
    print(f"{tag}: 'short' admitted before fused train step {step_short} "
          f"(0-based), the other tasks then (phase, slots bound) {others}; "
          f"'wide' and 'narrow' at steps {began['wide'][0]} and "
          f"{began['narrow'][0]}")
    require(began["wide"][0] == began["narrow"][0] == 0 and step_short > 0,
            "'short' did not wait at the admission gate")
    require(sum(b for _, b in others.values()) <= Z - lcs[2].m,
            "'short' admitted before the running tasks freed its slots")
    for i, (mix, dense, d, *_rest) in enumerate(log["train"]):
        used, unused = ("dense", "ragged") if dense else ("ragged", "dense")
        require(d[used] == want_train and d[unused] == zero
                and d["rank-local"] == zero
                and d["flash"]["flash_attention"] == flash_train,
                f"train step {i} ({mix}, dense {dense}) launched {d}, "
                f"expected {want_train} of the {used} kernels only and "
                f"flash {flash_train}")
    for i, d in enumerate(log["eval"]):
        require(d["dense"] == want_eval and d["ragged"] == zero
                and d["rank-local"] == zero
                and d["flash"]["flash_attention"] == flash_eval,
                f"eval step {i} launched {d}, expected {want_eval} of the "
                f"dense kernels only and flash {flash_eval}")
    n_dense = sum(1 for _, dense, *_ in log["train"] if dense)
    require(not any(dense for _, dense, _, _, _, p in log["train"] if p),
            "a profiled train step was not a mixed-width one")
    require(set(totals["rank-local"].values()) == {0},
            f"the rank-local kernels launched {totals['rank-local']}")
    for lc in lcs:
        res = results[lc.task_name]
        print(f"{tag}: task '{lc.task_name}': best {res.best_job} (val "
              f"{res.best_val!r}), exits {res.exit_counts}, saved "
              f"{res.samples_saved_frac:.3f} of the samples")
    n_train, n_eval = len(log["train"]), len(log["eval"])
    print(f"{tag}: {n_train} fused train steps ({n_train - n_dense} ragged, "
          f"{n_dense} dense), {n_eval} eval steps; launches per train step "
          f"{want_train} of the set its dense flag selects and flash "
          f"{flash_train}, per eval step {want_eval} and flash {flash_eval} "
          f"(every step checked); run totals {totals}")
    trained = sum(tok for _, _, _, _, tok, _ in log["train"])
    capacity = n_train * Z * TRAIN_B * TRAIN_S
    prof_tok = sum(tok for _, _, _, _, tok, p in log["train"] if p)
    print(f"{tag}: run_colocated wall {wall:.3f} s for {trained} real "
          f"trained tokens = {trained / wall:.1f} tokens/s over the whole "
          f"run (every step, eval, rotation and admission included); "
          f"{(trained - prof_tok) / (wall - prof['wall_us'] / 1e6):.1f} "
          f"tokens/s without the two profiled steps; padded share of the "
          f"capacity tokens (Z x b_cap x seq_cap per step) "
          f"{1 - trained / capacity:.4f}")
    train_s = sum(ms for _, _, _, ms, _, _ in log["train"]) / 1e3
    parts = {"train steps": train_s, **spent}
    print(f"{tag}: run_colocated wall {wall:.3f} s = " + " + ".join(
        f"{k} {v:.3f} s" for k, v in parts.items())
        + f" + other {wall - sum(parts.values()):.3f} s (eval_task holds "
        f"the eval steps; the train steps hold the two profiled ones' "
        f"{prof['wall_us'] / 1e6:.3f} s)")
    by_mix = {}
    for mix, dense, _, ms, tok, p in log["train"][1:]:
        if not p:
            by_mix.setdefault((mix, dense), []).append((ms, tok))
    for (mix, dense), steps in by_mix.items():
        ms = [m for m, _ in steps]
        print(f"{tag}: resident {mix} ({'dense' if dense else 'ragged'}): "
              f"median _train_step call {statistics.median(ms):.2f} ms over "
              f"{len(ms)} warm unprofiled steps (min {min(ms):.2f}, max "
              f"{max(ms):.2f}), {sum(t for _, t in steps) / sum(ms) * 1e3:.1f}"
              f" real tokens/s within the calls")
    print(f"{tag}: first train step {log['train'][0][3]:.1f} ms (cold); "
          f"peak memory {peak / 2**30:.2f} GiB")
    busy, pw = prof["busy_us"], prof["wall_us"]
    if busy:
        flash_us = sum(us for name, (_, us) in prof["kernels"].items()
                       if "flash_fwd" in name)
        print(f"profile ({tag}): flash attention {flash_us / 2e3:.2f} "
              f"ms/step = {flash_us / busy:.3f} of the device time")
        print(f"profile ({tag}): 2 mixed-width train steps (profiler on) "
              f"{pw / 2e3:.2f} ms/step wall, device busy {busy / 2e3:.2f} "
              f"ms/step = {busy / pw:.3f} of the wall, "
              f"{sum(n for n, _ in prof['kernels'].values()) / 2:.0f} device "
              f"events/step; grouped-LoRA kernels by set (ms/step): "
              + ", ".join(f"{k} {v / 2e3:.2f} ({v / busy:.3f} of busy)"
                          for k, v in sorted(by_family.items())))
        print_template_sums(tag, prof["kernels"], busy)
    else:
        print(f"profile ({tag}): no device events traced: not measured")
    for name, (n, us) in sorted(prof["kernels"].items(),
                                key=lambda kv: -kv[1][1])[:10]:
        print(f"profile ({tag}):   {us / 2e3:8.3f} ms/step {n // 2:5d}/step "
              f"{name[:90]}")
    return totals


def sfu_exp_rate(torch) -> float:
    """Exponentials per second the card's special-function units give at
    most: 16 results per clock per SM (compute capability 9.0, the CUDA C++
    Programming Guide's arithmetic-instruction throughput table) times the
    SM count times the card's maximum SM clock (nvidia-smi)."""
    mhz = float(sh("nvidia-smi", "--query-gpu=clocks.max.sm",
                   "--format=csv,noheader,nounits").splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_SM * sms * mhz * 1e6


def _scan_mask_fault(torch, q, k, v, logw, bonus, s0, chunk, doq):
    """The plain scan (kernels/linear_scan/ref.py's arithmetic) with its
    causal mask off by one: RWKV sees pairs t >= i (the diagonal through
    the decay), SSD only t > i."""
    import torch.nn.functional as F
    B, S, K = q.shape
    C = min(chunk, S)
    qf, kf, vf, lw = (x.float() for x in (q, k, v, logw))
    state = (torch.zeros(B, K, v.shape[-1], device=q.device)
             if s0 is None else s0.float())
    t = torch.arange(C, device=q.device)
    visible = (t[:, None] > t[None, :]) if doq else (t[:, None] >= t[None, :])
    ys = []
    for c in range(0, S, C):
        qb, kb, vb = qf[:, c:c + C], kf[:, c:c + C], vf[:, c:c + C]
        L = torch.cumsum(lw[:, c:c + C], dim=1)
        Lq = L if doq else F.pad(L, (0, 0, 1, 0))[:, :-1]
        dd = torch.where(visible[..., None],
                         Lq[:, :, None, :] - L[:, None, :, :], -1e30)
        P = (qb[:, :, None, :] * kb[:, None, :, :] * torch.exp(dd)).sum(-1)
        if bonus is not None:
            P = P + ((qb * bonus[:, None, :] * kb).sum(-1)[:, :, None]
                     * torch.eye(C, device=q.device))
        ys.append(torch.bmm(qb * torch.exp(Lq), state) + torch.bmm(P, vb))
        L_end = L[:, -1:, :]
        state = (state * torch.exp(L_end[:, 0])[:, :, None]
                 + torch.bmm((kb * torch.exp(L_end - L)).transpose(1, 2),
                             vb))
    return torch.cat(ys, dim=1).to(q.dtype), state


def scan_form_work(C, K, V, doq, bonus):
    """(exponentials, multiply-adds) of one chunk-row in the kernel's form
    (csrc/linear_scan.cu), over the chunk's real tokens. Blocks of 16
    tokens, quads of 4 within them. Exponentials: q~ and k~ one per
    (token, channel), e^{PV[T]} one per (token quad, channel), the tables
    one per (block, channel), (block pair two or more apart, channel) and
    channel; a quad pair below a block's diagonal one per (token of either
    quad, channel) and one for the pair; a quad on the diagonal one per
    (visible pair, channel). Multiply-adds: every visible pair over K (the
    off-diagonal tiles, the quads below the diagonal, the quads on it),
    the state term and the update (C*K*V each), P v over every visible
    pair (and the diagonal with the bonus) over V, and the bonus over K."""
    sizes = [min(16, C - t) for t in range(0, C, 16)]
    nb = len(sizes)
    vis = (lambda s: s * (s + 1) // 2) if doq else (lambda s: s * (s - 1) // 2)
    exps = (2 * C * K + (C + 3) // 4 * K
            + (nb + (nb - 1) * (nb - 2) // 2 + 1) * K)
    pairs = 0
    for s in sizes:
        quads = [min(4, s - t) for t in range(0, s, 4)]
        for tq in range(len(quads)):
            for iq in range(tq):
                exps += (quads[tq] + quads[iq] + 1) * K
            exps += vis(quads[tq]) * K
        pairs += vis(s)
    pairs += (C * C - sum(s * s for s in sizes)) // 2
    with_diag = C if bonus and not doq else 0
    fmas = (pairs * K + 2 * C * K * V + (pairs + with_diag) * V
            + (C * K if bonus else 0))
    return exps, fmas


def scan_kernel_phase(torch, LSK, lsref, cfg, cases=None, S=TRAIN_S):
    """The linear-scan kernel against its plain version at the shapes the
    rwkv6-3b path gives it (the train step's B = Z*b*H = 640 rows and the
    eval step's 2,560, S = 256, chunk 128, K = V = 64, bf16 q/k/v, fp32
    logw and bonus), at hymba's SSD shape (K = 16, no bonus, H = 50), with
    an initial state, at the decay clip (logw = -e^4 every token), with
    the even channels at the clip and the odd ones near 0, and in fp32.
    The reading of y and the final state is the largest |diff| in units
    of the bar (bf16 y: one bf16 rounding; fp32 y and the state: 1e-5
    relative), beside three planted faults in the plain version: the state
    not carried across chunks, the bonus dropped, the causal mask off by
    one. Rows 0-127 of the B = 640 call must equal a B = 128 call bit for
    bit. Times (graph replay) of the kernel and the plain version beside
    the bound, the largest of the bytes, the pivoted form's exponentials
    at the special-function units' rate and its multiply-adds at the fp32
    rate (``scan_form_work``), printed beside the bound of the form with
    one exponential per visible pair (the bytes and C*C*K/2 exponentials
    per chunk). ``cases`` and ``S`` replace rwkv6-3b's (the plain version
    runs over slices of 4 * TRAIN_B * cfg.num_heads rows). Returns (the
    results at the train step's shape, the eval step's time under
    ``eval_ms``; every case's results by label)."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(6)
    H, hs, C = cfg.num_heads, cfg.ssm.head_size, cfg.ssm.chunk_size
    bf16, fp32 = torch.bfloat16, torch.float32
    B_train, Z = 4 * TRAIN_B * H, 4
    sfu = sfu_exp_rate(torch)
    cases = cases or [  # (label, B, K, V, SSD, initial state, decay, dtype)
        ("train", B_train, hs, hs, False, False, 1.0, bf16),
        ("eval", Z * EVAL_B * H, hs, hs, False, False, 1.0, bf16),
        ("ssd-K16", 4 * TRAIN_B * 50, 16, 64, True, True, 1.0, bf16),
        ("state", B_train, hs, hs, False, True, 1.0, bf16),
        ("clip", B_train, hs, hs, False, False, "clip", bf16),
        ("mixed", B_train, hs, hs, False, False, "mixed", bf16),
        ("fp32", B_train, hs, hs, False, True, 1.0, fp32),
    ]
    print(f"linear scan: reading = max |kernel - plain| / (rtol |plain| + "
          f"{SCAN_ATOL_REL} max|plain|) over y and the final state, rtol "
          f"{SCAN_RTOL} (the state 1e-5); bar 1; controls: the plain version "
          f"with the state not carried across chunks, the bonus dropped, the "
          f"mask off by one. S {S}, chunk {C}; SFU rate {sfu:.4g} exp/s. "
          f"Times in ms per call (graph replay)")
    print("case     B      K   V   mode  dtype  reading    no-carry   "
          "no-bonus   mask+-1    ms         plain_ms   bound_ms   bound_by"
          "    bytes_ms   sfu_ms     fma_ms     pair_exp_bound_ms")
    results = {}
    for label, B, K, V, doq, with_s0, decay, dt in cases:
        q, k = (torch.randn(B, S, K, generator=gen, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn(B, S, V, generator=gen, device=dev).to(dt)
        if decay == "clip":
            logw = torch.full((B, S, K), -math.exp(4.0), device=dev)
        elif decay == "mixed":     # even channels at the clip, odd near 0
            logw = -1e-3 * torch.exp(torch.randn(B, S, K, generator=gen,
                                                 device=dev))
            logw[..., 0::2] = -math.exp(4.0)
        else:
            logw = -decay * torch.exp(torch.randn(B, S, K, generator=gen,
                                                  device=dev))
        bonus = None if doq else 0.3 * torch.randn(B, K, generator=gen,
                                                   device=dev)
        s0 = (torch.randn(B, K, V, generator=gen, device=dev) if with_s0
              else None)
        kw = dict(bonus=bonus, decay_on_query=doq, initial_state=s0,
                  chunk=C)
        LSK.reset_launches()
        y, st = LSK.linear_scan(q, k, v, logw, **kw)
        torch.cuda.synchronize()
        require(LSK.LAUNCHES["linear_scan"] == 1,
                f"linear scan {label}: {LSK.LAUNCHES} launches for one call")
        kind = "bf16" if dt == bf16 else "fp32"

        def sliced(fn):
            """The plain function over 640-row slices (rows are
            independent; bounds its [B, C, C, K] temporaries)."""
            outs = []
            for i in range(0, B, B_train):
                sl = slice(i, i + B_train)
                part = lambda x: None if x is None else x[sl]
                outs.append(fn(q[sl], k[sl], v[sl], logw[sl], part(bonus),
                               part(s0)))
            return (torch.cat([o[0] for o in outs]),
                    torch.cat([o[1] for o in outs]))

        def plain(q_, k_, v_, lw_, u_, s0_):
            return lsref.linear_scan_ref(q_, k_, v_, lw_, bonus=u_,
                                         decay_on_query=doq,
                                         initial_state=s0_, chunk=C)

        def no_carry(q_, k_, v_, lw_, u_, s0_):
            parts = [lsref.linear_scan_ref(
                q_[:, c:c + C], k_[:, c:c + C], v_[:, c:c + C],
                lw_[:, c:c + C], bonus=u_, decay_on_query=doq,
                initial_state=s0_, chunk=C) for c in range(0, S, C)]
            return (torch.cat([p[0] for p in parts], dim=1), parts[-1][1])

        def no_bonus(q_, k_, v_, lw_, u_, s0_):
            return plain(q_, k_, v_, lw_, None, s0_)

        def mask(q_, k_, v_, lw_, u_, s0_):
            return _scan_mask_fault(torch, q_, k_, v_, lw_, u_, s0_, C, doq)

        want_y, want_s = sliced(plain)

        def reading(got):
            out = 0.0
            for g, w, rtol in ((got[0], want_y, SCAN_RTOL[kind]),
                               (got[1], want_s, 1e-5)):
                w = w.float()
                tol = rtol * w.abs() + SCAN_ATOL_REL * float(w.abs().max())
                r = torch.nan_to_num((g.float() - w).abs() / tol,
                                     nan=math.inf)
                out = max(out, float(r.max()))
            return out

        sound = reading((y, st))
        faults = {"no-carry": sliced(no_carry),
                  "no-bonus": None if doq else sliced(no_bonus),
                  "mask": sliced(mask)}
        faults = {n: (None if f is None else reading(f))
                  for n, f in faults.items()}
        require(bool(torch.isfinite(y).all()) and sound <= 1.0,
                f"linear scan {label}: kernel reads {sound:.3g} of the bar")
        # at the decay clip a state is forgotten within one token, so the
        # carried state cannot show: that control reads as 0 there
        shown = {n: r for n, r in faults.items() if r is not None
                 and not (n == "no-carry" and decay == "clip")}
        require(min(shown.values()) > 1.0,
                f"linear scan {label}: a planted fault passes the bar "
                f"{faults}")
        if label == "train":
            head = [x[:128].contiguous() for x in (q, k, v, logw)]
            cut = lambda x: None if x is None else x[:128].contiguous()
            y2, s2 = LSK.linear_scan(*head, **dict(
                kw, bonus=cut(bonus), initial_state=cut(s0)))
            require(torch.equal(y2, y[:128]) and torch.equal(s2, st[:128]),
                    f"linear scan: rows 0-127 of the B = {B} call differ "
                    f"from a B = 128 call")
            print(f"linear scan: the B = {B} call's rows 0-127 equal a "
                  f"B = 128 call on them bit for bit (y and state)")
        # work: q, k, v, logw, bonus and s0 read once, y and the state
        # written once; the pivoted form's exponentials at the
        # special-function units' rate and its multiply-adds at the fp32
        # rate; beside it, the bound of the form with one exponential per
        # visible pair
        n = S // C
        exps, fmas = scan_form_work(C, K, V, doq, bonus is not None)
        nbytes = (B * S * (2 * K + 2 * V) * q.element_size()
                  + B * S * K * 4 + B * K * V * 4 * (2 if with_s0 else 1)
                  + (0 if doq else B * K * 4))
        t_bytes, t_sfu = nbytes / H100_BYTES_S, B * n * exps / sfu
        t_fma = 2 * B * n * fmas / H100_FP32_FLOPS
        bound_ms = max(t_bytes, t_sfu, t_fma) * 1e3
        bound_by = "bytes" if t_bytes >= max(t_sfu, t_fma) else "operations"
        pairs = C * (C + 1) // 2 if doq else C * (C - 1) // 2
        pair_exp_bound_ms = max(t_bytes, B * n * pairs * K / sfu) * 1e3
        inner = 10 if B <= B_train else 4
        ms, _ = time_ms(torch, lambda i: LSK.linear_scan(q, k, v, logw, **kw),
                        inner)
        plain_ms = None
        if label == "train":
            plain_ms, _ = time_ms(torch, lambda i: plain(q, k, v, logw, bonus,
                                                         s0), 2)
        fmt = lambda x: "-" if x is None else f"{x:.5f}"
        fr = lambda x: "n/a" if x is None else f"{x:.4g}"
        print(f"{label:8s} {B:5d} {K:4d} {V:3d}  {'ssd' if doq else 'rwkv':4s}"
              f"  {kind:5s}  {sound:.4g}  {fr(faults['no-carry']):10s} "
              f"{fr(faults['no-bonus']):10s} {fr(faults['mask']):10s} "
              f"{ms:.5f}  {fmt(plain_ms):10s} {bound_ms:.6f}  {bound_by:10s}"
              f"  {t_bytes * 1e3:.6f}  {t_sfu * 1e3:.6f}  {t_fma * 1e3:.6f}"
              f"  {pair_exp_bound_ms:.6f}")
        results[label] = {"max_abs_err": float((y.float()
                                                - want_y.float()).abs().max()),
                          "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "pair_exp_bound_ms": pair_exp_bound_ms}
        del q, k, v, logw, bonus, s0, y, st, want_y, want_s
        torch.cuda.empty_cache()
    res = dict(results["train"])
    del res["pair_exp_bound_ms"]
    res["max_abs_err"] = max(results[lab]["max_abs_err"]
                             for lab in ("train", "eval"))
    res["eval_ms"] = results["eval"]["ms"]
    return res, results


def _lanes_first(cache):
    """Every per-lane tensor of a per-lane cache with the (Z, b) lane axes
    first: the layer leaves [L, Z, b, ...] moved to [Z, b, L, ...], and the
    positions (``pos``, a ring's ``k_pos``)."""
    def leaves(tree):
        for v in tree.values():
            yield from (leaves(v) if isinstance(v, dict) else (v,))
    out = [v.movedim(0, 2) for v in leaves(cache["layers"])]
    return out + [cache[k] for k in ("pos", "k_pos") if k in cache]


def streamed_serve_phase(torch, RL, cfg, params):
    """A short serve of rwkv6-3b or hymba-1.5b through AdapterPool ->
    ServingReplica -> ServingFrontend: 4 adapters at ranks RANKS, 4 lanes,
    8 greedy requests (prompts of 16-48 tokens, 16 new tokens); hymba over
    a ring cache of its window (1,024 slots; no stream here reaches 64
    positions, so the ring never wraps: ``ring_wrap_check`` decodes past
    it). Neither family has block prefill: prompts stream through the
    decode step, so the linear-scan and flash kernels must launch 0 times
    and the LoRA forward pair once per projection of every fused step. A
    first pass with lane guards: every lane reset (a join) and every
    decode step under ``active`` must leave the lanes it does not own
    bitwise untouched (K/V, ``k_pos``, the recurrent state, the
    position). Then the same requests again without the guards, timed and
    counted (the main path), must give the same tokens."""
    import numpy as np

    from repro_torch.core import lora as LORA
    from repro_torch.data.synthetic import make_task_dataset
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.models import model as M
    from repro_torch.serve import (AdapterPool, ServingFrontend,
                                   ServingReplica)

    dev, sync, Z, n_req, new = "cuda", torch.cuda.synchronize, len(RANKS), \
        8, 16
    gen = torch.Generator(device=dev).manual_seed(1)
    stack = LORA.init_lora_tree(gen, cfg, Z,
                                torch.tensor(RANKS, dtype=torch.int32),
                                M.target_shapes(cfg))
    for ab in stack.values():
        ab["B"].normal_(0.0, 0.003, generator=gen)
    pool = AdapterPool(cfg, Z, device=dev)
    pool.publish_many([(f"a{z}", {t: {m: x[:, z] for m, x in ab.items()}
                                  for t, ab in stack.items()}, RANKS[z])
                       for z in range(Z)])
    del stack
    ring = cfg.family == "hybrid"
    rep = ServingReplica(cfg, params, pool, lanes=LANES, max_len=MAX_LEN,
                         ring=ring, device=dev)
    require(rep.ring == ring and not rep._block_prefill,
            f"the {cfg.name} replica must stream prompts through decode")
    checked = {"reset": 0, "decode": 0}

    def guarded(fn, kind, cache_at, mask_at):
        def run(*args):
            before = [t.clone() for t in _lanes_first(args[cache_at])]
            out = fn(*args)
            keep = ~args[mask_at]
            after = _lanes_first(out[-1] if kind == "decode" else out)
            require(all(torch.equal(a[keep], b[keep])
                        for a, b in zip(after, before)),
                    f"serve ({cfg.name}): a {kind} changed a lane it does "
                    f"not own")
            checked[kind] += 1
            return out
        return run

    fe = ServingFrontend(rep, mode="continuous")
    name = {"ssm": "rwkv-serve", "hybrid": "hymba-serve"}[cfg.family]
    ds = make_task_dataset(name, cfg.vocab_size, seq_len=48,
                           num_train=n_req, difficulty=0.3, seed=0)
    lens = [int(x) for x in np.random.default_rng(0).integers(16, 49,
                                                              n_req)]

    def serve():
        rids = [fe.submit(f"a{i % Z}", ds.train[i, :lens[i]], new)
                for i in range(n_req)]
        sync()
        t = time.perf_counter()
        out = fe.drain()
        sync()
        return [out[r] for r in rids], time.perf_counter() - t

    plain = rep._reset_lanes, rep._decode_lanes
    rep._reset_lanes = guarded(plain[0], "reset", 0, 1)
    rep._decode_lanes = guarded(plain[1], "decode", 2, 4)
    want_out, guarded_wall = serve()
    require(checked["reset"] > 0 and checked["decode"] > 0,
            f"serve ({cfg.name}): lane guards ran {checked}")
    rep._reset_lanes, rep._decode_lanes = plain
    steps0, generated0 = rep.total_decode_steps, rep.total_generated
    for m in (RL, FA, LSK):
        m.reset_launches()
    out, wall = serve()
    launches = {**RL.LAUNCHES, **FA.LAUNCHES, **LSK.LAUNCHES}
    steps = rep.total_decode_steps - steps0
    generated = rep.total_generated - generated0
    require(all(len(o) == new for o in out),
            f"token counts {[len(o) for o in out]}")
    require(out == want_out, f"serve ({cfg.name}): the unguarded pass's "
            f"greedy tokens differ from the guarded pass's")
    want = len(cfg.lora.targets) * cfg.num_layers * steps
    require(rep.block_prefills == 0 and launches["xa"] == launches["sb_add"]
            == want and launches["flash_attention"] == 0
            and launches["linear_scan"] == 0,
            f"{cfg.name} serve launched {launches}; expected xa = sb_add = "
            f"{want} and no flash or scan launch")
    print(f"serve ({cfg.name}): {n_req} requests (prompts {min(lens)}-"
          f"{max(lens)} tokens streamed through decode) x {new} tokens on "
          f"{LANES} lanes x {Z} adapters{', ring cache' if ring else ''}: "
          f"{steps} fused steps in {wall:.3f} s, {generated / wall:.1f} "
          f"generated tok/s (lane guards off); launches {launches}; the "
          f"guarded pass before it ({guarded_wall:.3f} s, not counted) gave "
          f"the same tokens, and its {checked['reset']} lane resets (joins) "
          f"and {checked['decode']} decode steps left every other lane "
          f"bitwise untouched")
    del pool, rep, fe
    return launches


def full_rank_twins(torch, fams, T, din, dout):
    """At full rank the three kernel sets meet: the rank-local kernels at
    ranks (64, 64, 64, 64) with rows None, the dense kernels, and the
    ragged kernels at rows = T must give the same bits for all six
    functions (sb_add with and without a base) at the shape (T, din, dout)
    (bf16 activations, fp32 masters, non-zero B, a different scale per
    slot)."""
    dev, Z, r = "cuda", 4, 64
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(Z, T, din, generator=gen, device=dev).to(torch.bfloat16)
    dy = torch.randn(Z, T, dout, generator=gen, device=dev).to(torch.bfloat16)
    A = torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
    B = torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
    scale = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
    full = torch.full((Z,), r, dtype=torch.int32, device=dev)
    every = torch.full((Z,), T, dtype=torch.int32, device=dev)
    GL, RG, RL = fams["dense"], fams["ragged"], fams["rank-local"]
    s, dS = GL.xa(x, A), GL.ds(dy, B, scale)

    def outs(mod, *c):
        return {"xa": mod.xa(x, A, *c), "ds": mod.ds(dy, B, scale, *c),
                "da": mod.da(x, dS, *c), "db": mod.db(s, dy, scale, *c),
                "sb_add": mod.sb_add(s, B, scale, *c),
                "sb_add+base": mod.sb_add(s, B, scale, *c, y_base=dy),
                "dx": mod.dx(dS, A, *c)}

    dense, ragged, local = outs(GL), outs(RG, every), outs(RL, None, full)
    for name, out in dense.items():
        require(torch.equal(out, ragged[name])
                and torch.equal(out, local[name]),
                f"{name} at {din} x {dout}, T = {T}: the dense, ragged "
                f"(rows = T) and rank-local (ranks 64) kernels differ")
    print(f"full rank, T = {T}, {din} x {dout}: the dense, ragged and "
          f"rank-local kernels give the same bits for all {len(dense)} "
          f"outputs")


def _cut_layers(params, layers, dtype):
    """``params`` with the first ``layers`` of every stacked leaf (nested
    ones too), each leaf cast to ``dtype``."""
    def conv(x, stacked):
        return (x[:layers] if stacked else x).to(dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else conv(v, True)
                for k, v in tree.items()}
    return {k: walk(v) if k == "layers" else conv(v, False)
            for k, v in params.items()}


def ring_wrap_check(torch, cfg, params):
    """Windowed decode over a wrapped ring at full width, in fp32 (the
    train check's copy of the backbone): the two lanes of one slot take
    RING_PREFILL tokens through the forward into a per-lane ring of the
    window's size, then lane 0 alone decodes RING_STEPS tokens under
    ``active`` (rank-64 adapters on every target) while lane 1 waits.
    After the wrap every step overwrites the oldest slot. Each step's
    logits are held against the full forward over the same tokens (flash
    with the window binding, the scan over the whole prefix); the controls
    are that forward with the window one key wider and with no window cut
    (a ring that never evicts). Lane 1's K/V, ``k_pos``, ``conv``, ``ssm``
    and position must stay bitwise."""
    from repro_torch.core import lora as LORA
    from repro_torch.models import model as M

    dev, W, P, n = "cuda", cfg.sliding_window, RING_PREFILL, RING_STEPS
    require(P < W < P + n, "the ring check must decode past the wrap")
    gen = torch.Generator(device=dev).manual_seed(5)
    ranks = torch.tensor([cfg.lora.r_max], dtype=torch.int32)
    lora = LORA.init_lora_tree(gen, cfg, 1, ranks, M.target_shapes(cfg))
    for ab in lora.values():
        ab["B"].normal_(0.0, 0.003, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 2, P + n), generator=gen,
                           device=dev)
    active = torch.tensor([[True, False]], device=dev)

    def forward_logits(window):
        c = dataclasses.replace(cfg, sliding_window=window)
        x, _, _ = M.forward(c, params, lora, tokens[:, :1])
        return M._unembed(c, params, x[0, 0, P:])

    with torch.inference_mode(), LORA.slot_ranks(ranks.to(dev)):
        cache = M.init_cache(cfg, 1, 2, P + n, ring=True, per_lane=True,
                             device=dev)
        _, _, cache = M.forward(cfg, params, lora, tokens[:, :, :P],
                                cache=cache)
        idle = [t[0, 1].clone() for t in _lanes_first(cache)]
        got = []
        for i in range(n):
            logits, cache = M.decode_step(cfg, params, lora, cache,
                                          tokens[:, :, P + i], active)
            got.append(logits[0, 0])
        got = torch.stack(got)
        want = forward_logits(W)
        wider, unbounded = forward_logits(W + 1), forward_logits(2 * W)
    torch.cuda.synchronize()
    require(all(torch.equal(t[0, 1], b)
                for t, b in zip(_lanes_first(cache), idle)),
            "ring check: lane 0's decode changed the waiting lane 1")
    kpos = cache["k_pos"][0, 0].sort().values
    require(torch.equal(kpos, torch.arange(P + n - W, P + n, device=dev,
                                           dtype=kpos.dtype)),
            "ring check: the ring does not hold the last window's positions")
    top = float(want.abs().max())

    def reading(x):
        return float((x - want).abs().max()) / top
    err, wide, none = reading(got), reading(wider), reading(unbounded)
    print(f"ring check ({cfg.name}, {cfg.dtype}, {cfg.num_layers} layers, "
          f"ring of {W}): {P} tokens prefilled on 2 lanes, lane 0 decoded "
          f"positions {P}-{P + n - 1} ({P + n - W} past the wrap) while "
          f"lane 1 stayed bitwise; logits max |decode - forward| / max "
          f"|forward| {err:.3g} (bar {RING_LOGITS_REL}); controls: the "
          f"forward with the window one key wider {wide:.3g}, with no "
          f"window cut {none:.3g}")
    require(err <= RING_LOGITS_REL,
            f"ring check: decode past the wrap reads {err:.3g}")
    require(min(wide, none) > RING_LOGITS_REL,
            f"ring check: the controls read {wide:.3g} and {none:.3g}, "
            f"within the bar")


def hymba_phases(torch, fams, t_all):
    """Phases 20-23 on hymba-1.5b: the kernels at its shapes against their
    plain versions, a short serve over a ring cache, the train checks and
    the rank sweep at S = 2048 (the main path). ``fams`` maps each
    grouped-LoRA path to its kernel module. Returns (the rank-local
    kernels' results, flash's and the scan's results by case, the serve's
    launches, the sweep's launches)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.kernels.linear_scan import ref as lsref
    from repro_torch.models import model as M
    from repro_torch.models.mamba import mamba_dims

    RL = fams["rank-local"]
    hcfg = get_arch("hymba-1.5b")
    Z, S, T, bf16 = 4, HYMBA_S, HYMBA_B * HYMBA_S, torch.bfloat16
    lora = backward_kernel_phase(
        torch, RL, ref, timed=("hymba", 1600, 1600),
        cases=[("hymba", T, din, dout, TRAIN_RANKS, None)
               for din, dout in HYMBA_SHAPES])
    # the forward pair at the serve's decode rows (T = lanes) and the eval
    # step's (T = 4 x 2,048) at every projection shape
    fwd = kernel_phase(
        torch, RL, ref,
        cases=[("decode", LANES, din, dout, RANKS, None)
               for din, dout in HYMBA_SHAPES]
        + [("eval", HYMBA_EVAL_B * S, din, dout, TRAIN_RANKS, None)
           for din, dout in HYMBA_SHAPES],
        timed={("decode", 1600, 1600): "hymba_decode",
               ("eval", 1600, 1600): "hymba_eval"})
    for name, res in fwd.items():
        lora[name]["shapes"].update(res["shapes"])
        lora[name]["max_abs_err"] = max(lora[name]["max_abs_err"],
                                        res["max_abs_err"])
    invariance_phase(torch, fams["dense"], fams["ragged"], RL,
                     shapes=HYMBA_SHAPES)
    for din, dout in HYMBA_SHAPES:
        full_rank_twins(torch, fams, T, din, dout)
    H, hd, W = hcfg.num_heads, hcfg.resolved_head_dim, hcfg.sliding_window
    _, flash = flash_kernel_phase(
        torch, FA, fref, hcfg, plain_labels=("train",),
        cases=[("train", Z * HYMBA_B * H, S, S, hd, W, bf16),
               ("eval", Z * HYMBA_EVAL_B * H, S, S, hd, W, bf16)])
    _, Hs, hs = mamba_dims(hcfg)
    N = hcfg.ssm.state_size
    _, scan = scan_kernel_phase(
        torch, LSK, lsref, hcfg, S=S,
        cases=[("train", Z * HYMBA_B * Hs, N, hs, True, False, 1.0, bf16),
               ("eval", Z * HYMBA_EVAL_B * Hs, N, hs, True, False, 1.0,
                bf16)])
    print(f"hymba kernel phases done at {time.perf_counter() - t_all:.1f} s")
    t = time.perf_counter()
    hparams = M.init_params(hcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {hcfg.name} backbone in {time.perf_counter() - t:.1f} s")
    serve = streamed_serve_phase(torch, RL, hcfg, hparams)
    print(f"hymba serve phase done at {time.perf_counter() - t_all:.1f} s")
    ccfg = dataclasses.replace(hcfg, dtype="float32")
    cparams = _cut_layers(hparams, hcfg.num_layers, torch.float32)
    train_check(torch, fams, ccfg, cparams, TRAIN_RANKS, "rank-local", S=S,
                b=HYMBA_B, loss_bar=HYMBA_LOSS_REL)
    ring_wrap_check(torch, ccfg, cparams)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"hymba train and ring checks done at "
          f"{time.perf_counter() - t_all:.1f} s")
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=HYMBA_B)
            for r in TRAIN_RANKS for lr in (1e-4, 1e-3)}
    launches = executor_phase(torch, RL, (fams["dense"], fams["ragged"]),
                              hcfg, hparams, "hymba-rank-sweep", jobs,
                              b=HYMBA_B, S=S, eval_b=HYMBA_EVAL_B)
    print(f"hymba rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    return lora, flash, scan, serve, launches


def rwkv_phases(torch, fams, t_all):
    """Phases 16-19 on rwkv6-3b: the scan kernel against its plain version,
    a short serve, the train checks and the rank sweep (the main path).
    ``fams`` maps each grouped-LoRA path to its kernel module. Returns
    (the scan kernel's results, the serve's launches, the sweep's
    launches)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.kernels.linear_scan import ref as lsref
    from repro_torch.models import model as M

    RL = fams["rank-local"]
    rcfg = get_arch("rwkv6-3b")
    scan, _ = scan_kernel_phase(torch, LSK, lsref, rcfg)
    print(f"linear-scan kernel phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    t = time.perf_counter()
    rparams = M.init_params(rcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {rcfg.name} backbone in {time.perf_counter() - t:.1f} s")
    serve = streamed_serve_phase(torch, RL, rcfg, rparams)
    print(f"rwkv serve phase done at {time.perf_counter() - t_all:.1f} s")
    for layers, hold in ((rcfg.num_layers, False), (RWKV_GRAD_LAYERS, True)):
        ccfg = dataclasses.replace(rcfg, num_layers=layers, dtype="float32")
        cparams = _cut_layers(rparams, layers, torch.float32)
        train_check(torch, fams, ccfg, cparams, TRAIN_RANKS, "rank-local",
                    hold_grads=hold)
        del cparams
        gc.collect()
        torch.cuda.empty_cache()
    print(f"rwkv train checks done at {time.perf_counter() - t_all:.1f} s")
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=TRAIN_B)
            for r in TRAIN_RANKS for lr in (1e-4, 1e-3)}
    launches = executor_phase(torch, RL, (fams["dense"], fams["ragged"]),
                              rcfg, rparams, "rwkv-rank-sweep", jobs)
    print(f"rwkv rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    return scan, serve, launches


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
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.sched import profiler
    global H100_BF16_FLOPS, H100_BYTES_S
    H100_BF16_FLOPS = profiler.PEAK_FLOPS_BF16
    H100_BYTES_S = profiler.HBM_BYTES_PER_S

    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.synthetic import PairSlotBatcher
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import grouped_lora as GL
    from repro_torch.kernels.grouped_lora import ragged as RG
    from repro_torch.kernels.grouped_lora import ranklocal as RL
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.models import model as M

    t_all = time.perf_counter()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:     # every nvcc starts at once
        builds = [(m, pool.submit(m.build)) for m in (RL, FA, LSK)]
    for m, fut in builds:
        lib = fut.result()
        print(f"build: {lib.name} from {len(m.SOURCES)} sources "
              f"({', '.join(p.name for p in m.SOURCES)})")
    print(f"build: {sum(len(m.SOURCES) for m, _ in builds)} sources, one "
          f"nvcc each, started together, in {time.perf_counter() - t:.2f} s")
    tensor_core_check([builds[0][1].result(), builds[1][1].result()])
    scan_resource_check(builds[2][1].result())

    print(f"kernels on {card}:")
    kern = kernel_phase(torch, RL, ref)
    for name, res in backward_kernel_phase(torch, RL, ref).items():
        had = kern.setdefault(name, {})
        err = max(res["max_abs_err"], had.get("max_abs_err", 0.0))
        shapes = {**had.get("shapes", {}), **res.get("shapes", {})}
        had.update(res, max_abs_err=err)
        if shapes:              # xa, sb_add: eval and train beside decode
            had["shapes"] = shapes
    dense = dense_kernel_phase(torch, GL, RL, ref)
    ragged = ragged_kernel_phase(torch, RG, GL, RL, ref)
    invariance_phase(torch, GL, RG, RL)
    fams = {"dense": GL, "ragged": RG, "rank-local": RL}
    cfg = get_arch("stablelm-3b")
    flash, _ = flash_kernel_phase(torch, FA, fref, cfg)
    print(f"kernel phases done at {time.perf_counter() - t_all:.1f} s")

    t = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {cfg.name} backbone in {time.perf_counter() - t:.1f} s")
    serve_launches = serve_phase(torch, RL, cfg, params)
    torch.cuda.empty_cache()
    print(f"serve phase done at {time.perf_counter() - t_all:.1f} s")
    train_check(torch, fams, cfg, params, TRAIN_RANKS, "rank-local")
    print(f"train check done at {time.perf_counter() - t_all:.1f} s")
    rank_jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                               per_adapter_batch=TRAIN_B)
                 for r in TRAIN_RANKS for lr in (1e-4, 1e-3)}
    train_launches = executor_phase(torch, RL, (GL, RG), cfg, params,
                                    "rank-sweep", rank_jobs)
    print(f"rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    train_check(torch, fams, cfg, params, FULL_RANKS, "dense")
    print(f"full-rank train check done at {time.perf_counter() - t_all:.1f} s")
    train_check(torch, fams, cfg, params, FULL_RANKS, "ragged", RAGGED_ROWS)
    print(f"ragged train check done at {time.perf_counter() - t_all:.1f} s")
    colocated_phase(torch, fams, cfg)
    print(f"co-located phases done at {time.perf_counter() - t_all:.1f} s")
    lr_jobs = {f"lr{lr:g}-wd{wd:g}": TrainConfig(
                   learning_rate=lr, weight_decay=wd,
                   lora_rank=cfg.lora.r_max, per_adapter_batch=TRAIN_B)
               for lr in (1e-4, 3e-4, 1e-3, 3e-3) for wd in (0.0, 0.01)}
    # depth cut (LR_SWEEP_LAYERS) to keep the script within half its limit
    lr_cfg = dataclasses.replace(cfg, num_layers=LR_SWEEP_LAYERS)
    lr_params = _cut_layers(params, LR_SWEEP_LAYERS, torch.bfloat16)
    lr_launches = executor_phase(torch, GL, (RL, RG), lr_cfg, lr_params,
                                 "lr-sweep", lr_jobs)
    del lr_params
    print(f"lr-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    colo_launches = colocation_phase(torch, fams, cfg, params)
    print(f"heterogeneous co-location phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    train_check(torch, fams, cfg, params, TRAIN_RANKS, "rank-local",
                loss_kind="dpo")
    print(f"DPO train check done at {time.perf_counter() - t_all:.1f} s")
    chosen, rejected = _pair_data(cfg)
    dpo_launches = executor_phase(
        torch, RL, (GL, RG), cfg, params, "dpo", _dpo_jobs(),
        loss_kind="dpo", b=DPO_B,
        batcher=PairSlotBatcher(chosen, rejected, 4, DPO_B, seed=0))
    print(f"DPO executor phase done at {time.perf_counter() - t_all:.1f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng_static, eng_elastic, handover = engine_phase(torch, fams)
    print(f"engine phase done at {time.perf_counter() - t_all:.1f} s")
    svc_launches, svc_serve = service_phase(torch, fams, handover)
    del handover
    print(f"service phase done at {time.perf_counter() - t_all:.1f} s")
    recovery_phase(torch, cfg)
    print(f"recovery phase done at {time.perf_counter() - t_all:.1f} s")
    svc_rec_launches = service_recovery_phase(torch, fams)
    print(f"service recovery phase done at "
          f"{time.perf_counter() - t_all:.1f} s")

    scan, rwkv_serve, rwkv_launches = rwkv_phases(torch, fams, t_all)
    gc.collect()                 # the rwkv6-3b backbone
    torch.cuda.empty_cache()
    h_lora, h_flash, h_scan, h_serve, h_launches = hymba_phases(
        torch, fams, t_all)

    csrc = "src/repro_torch/kernels/grouped_lora/csrc"
    rows = [  # (name, kernel source, TPU kernel file, its pallas_call line)
        ("xa", "ranklocal.cu", "ranklocal.py", 97),
        ("sb_add", "ranklocal.cu", "ranklocal.py", 187),
        ("ds", "ranklocal_bwd.cu", "ranklocal.py", 240),
        ("dx", "ranklocal_bwd.cu", "ranklocal.py", 297),
        ("da", "ranklocal_bwd.cu", "ranklocal.py", 355),
        ("db", "ranklocal_bwd.cu", "ranklocal.py", 407)]
    rows += [(name, "grouped_lora.cu", "grouped_lora.py", line)
             for name, line in (("xa", 71), ("sb_add", 121), ("ds", 162),
                                ("dx", 197), ("da", 238), ("db", 275))]
    rows += [(name, "ragged.cu", "ragged.py", line)
             for name, line in (("xa", 80), ("sb_add", 152), ("ds", 198),
                                ("dx", 244), ("da", 295), ("db", 341))]
    table = {"kernels": []}
    for name, src, tpu, line in rows:
        if src == "grouped_lora.cu":
            prefix, by_path, res = "grouped_lora", {
                "lr_sweep": lr_launches[name],
                "colocation": colo_launches["dense"][name]}, dense[name]
        elif src == "ragged.cu":
            prefix, by_path, res = "ragged", {
                "colocation": colo_launches["ragged"][name]}, ragged[name]
        else:
            prefix, by_path, res = "ranklocal", {
                "train": train_launches[name],
                "dpo": dpo_launches[name],
                "rwkv_train": rwkv_launches[name],
                "hymba_train": h_launches[name]}, dict(kern[name])
            if name in serve_launches:
                by_path["serve"] = serve_launches[name]
                by_path["rwkv_serve"] = rwkv_serve[name]
                by_path["hymba_serve"] = h_serve[name]
            res["shapes"] = {**res.get("shapes", {}),
                             **h_lora[name]["shapes"]}
            res["max_abs_err"] = max(res["max_abs_err"],
                                     h_lora[name]["max_abs_err"])
        fam = {"grouped_lora": "dense", "ragged": "ragged"}.get(
            prefix, "rank-local")
        by_path["engine_static"] = eng_static[fam][name]
        by_path["engine_elastic"] = eng_elastic[fam][name]
        by_path["service"] = svc_launches[fam][name]
        by_path["service_recovery"] = svc_rec_launches[fam][name]
        if fam == "rank-local" and name in ("xa", "sb_add"):
            by_path["service_serve"] = svc_serve["ranklocal"][name]
        table["kernels"].append({
            "name": f"{prefix}_{name}", "route": "cuda",
            "source": f"{csrc}/{src}",
            "replaces": f"src/repro/kernels/grouped_lora/{tpu}:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **res})

    def with_hymba(res, cases):
        """The kernel's row with hymba's path shapes beside its own."""
        res = dict(res)
        res["shapes"] = {f"hymba_{lab}": {k: v for k, v in r.items()
                                          if k != "pair_exp_bound_ms"}
                         for lab, r in cases.items()}
        res["max_abs_err"] = max([res["max_abs_err"]]
                                 + [r["max_abs_err"] for r in cases.values()])
        return res

    by_path = {"serve": serve_launches["flash_attention"],
               "train": train_launches["flash_attention"],
               "lr_sweep": lr_launches["flash_attention"],
               "colocation": colo_launches["flash"]["flash_attention"],
               "dpo": dpo_launches["flash_attention"],
               "hymba_train": h_launches["flash_attention"],
               "hymba_serve": h_serve["flash_attention"],
               "engine_static": eng_static["flash"]["flash_attention"],
               "engine_elastic": eng_elastic["flash"]["flash_attention"],
               "service": svc_launches["flash"]["flash_attention"],
               "service_recovery":
                   svc_rec_launches["flash"]["flash_attention"],
               "service_serve": svc_serve["flash"]["flash_attention"]}
    table["kernels"].append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:89",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **with_hymba(flash, h_flash)})
    by_path = {"rwkv_train": rwkv_launches["linear_scan"],
               "rwkv_serve": rwkv_serve["linear_scan"],
               "hymba_train": h_launches["linear_scan"],
               "hymba_serve": h_serve["linear_scan"],
               "service": svc_launches["scan"]["linear_scan"],
               "service_recovery": svc_rec_launches["scan"]["linear_scan"]}
    table["kernels"].append({
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/linear_scan.py:111",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **with_hymba(scan, h_scan)})
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
