#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: multi-adapter serving, rank-sweep
and full-rank learning-rate-sweep LoRA training, heterogeneous multi-task
co-location, DPO preference tuning, the engine (paper Listing 1)
scheduling and running three tuning tasks statically and elastically, a
live tuning-service session with tune-to-serve, and crash-and-resume of
stablelm-3b, at the executor and through the service's journal, then
serving and rank-sweep LoRA training of rwkv6-3b, of hymba-1.5b, of the
MoE granite-moe-1b-a400m, of the vision-language qwen2-vl-72b (depth cut,
with image-prefixed train and serve checks) and of musicgen-medium, and
train checks of llama4-scout-17b-a16e, glm4-9b, granite-8b and
mistral-nemo-12b at full width, the grouped-LoRA tile autotuner, the
training launcher on a one-rank mesh at train_4k's sequence length, and
its sharded steps (SFT and DPO train and eval, prefill and serve) on a
2 x 2 (data, model) mesh of four processes sharing the card, on one NVIDIA
card, through the port's hand-written CUDA kernels.

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
3c. autotune — the tile autotuner (``kernels/grouped_lora/autotune.py``)
            at stablelm-3b's projection shapes (2560 x 2560, 2560 x 6912,
            6912 x 2560), r_max 64, Z 4, at 1,024 rows a slot and at decode
            (T 4): the library's compiled plan set (``gl_plan_tiles``)
            equals ``autotune.PLAN_SET``; a planted candidate one ulp off
            the default is discarded by the sweep's gate; each key's sweep
            (the six kernels of the three sets, 18 outputs, each candidate
            held bit for bit to the default and timed from a replayed CUDA
            graph) prints the candidates tried and discarded, the default
            and tuned ms and the speedup; the winners persist to a
            ``ProfileStore`` in a temporary directory and a fresh store on
            the same path serves them with zero sweeps; at each key the
            dense, ragged and rank-local Functions' forward and backward
            under the tuned plan and every other candidate equal the
            default plan's and each other's, bit for bit.
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
            x weight decay 0/0.01), at full width and SWEEP_LAYERS = 4
            of the 32 layers (depth cut for time): every step on the dense
            kernels (the launch counts of 4 layers), the rank-local and
            ragged kernels never.
12. heterogeneous co-location — the slice's main path: three full-rank
            tuning tasks of widths (b, S) = (4, 256), (2, 256) and
            (4, 128), 4 jobs each on 2 slots each, through run_colocated
            over one SharedBackboneExecutor (Z = 4, b_cap = 4, seq_cap =
            256) on stablelm-3b at full width and SWEEP_LAYERS (depth cut
            for time); the third waits at the admission
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
            stablelm-3b at full width and SWEEP_LAYERS (depth cut for
            time), 8 jobs (ranks 4/8/16/32 x lr 1e-4/1e-3),
            S = 256: two warmup waves with rotation, selection, continue.
            Every slot's first DPO loss must read log 2 within 1e-3 (B = 0:
            the policy is the reference); every train step must launch
            flash 24 times (two policy forwards with remat, two reference
            forwards), the rank-local xa/sb_add 112, ds/da/db 56, dx 50,
            every eval step flash 16 and xa/sb_add 56, the dense and
            ragged kernels never; the same measurements as phase 6, with
            flash attention's share of the device time.
14a. engine — the slice's main path: Listing 1 through the port's entry
            points. Engine(total_gpus = 2, eval_every = 2) on stablelm-3b
            at full width and SWEEP_LAYERS (depth cut for time; its own
            backbone, random weights from seed 0)
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
            LoRA set at its depth's counts and flash twice a layer, every
            eval step one set's forward pair and flash once a layer, the
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
14b. service — one live TuningService session on stablelm-3b at full
            width and SWEEP_LAYERS, as phase 14a (its own backbone from
            seed 0): Engine(total_gpus = 2, eval_every =
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
15. recovery — the DPO task of phase 14 at full width and RECOVERY_LAYERS
            = 2 layers (depth cut for time), run
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
            width and RECOVERY_LAYERS layers: a task of 8 jobs (lr
            1e-4/1e-3, rank 8/32, b 2/4) on 4 slots, 12 steps a job,
            EarlyExit(0.2, 0.5),
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
            reads as the kernels do; RWKV_GRAD_LAYERS), so at
            RWKV_CHECK_LAYERS = 8 of its 32 layers (cut for time) the loss
            bar is held with the two forward faults (slot 0's
            delta halved; the bonus dropped from the plain scan) and the
            gradient readings are printed, and at 2 layers every bar and
            every planted fault of phase 5 is held. The kernel runs launch
            the linear-scan kernel twice per layer (forward and remat) and
            flash attention never. The backward of the scan is autograd
            through the plain version (as the JAX package's custom VJP),
            one chunk at a time (``torch.utils.checkpoint`` per chunk).
19. rwkv rank sweep — the slice's main path: phase 6 on rwkv6-3b at full
            width and RWKV_SWEEP_LAYERS = 4 of its 32 layers (depth cut
            for time; 8 jobs, ranks 4/8/16/32 x lr 1e-4/1e-3, Z = 4, b =
            4, S = 256): every fused train step must launch the rank-local
            xa/sb_add 56 times, ds/da/db 28, dx 24 (the first layer's
            r/k/v/g read the embedding's token-shift lerps), the linear
            scan 8 and flash 0; every eval step xa/sb_add 28 and the
            linear scan 4; the dense and ragged kernels never. The same
            measurements as phase 6, with the scan kernel's share of the
            device time.

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
            full width and HYMBA_CHECK_LAYERS = 4 of 32 layers (the
            kernels' fp32 instantiations): every
            bar and every planted fault of phase 5 (the loss bar an fp32
            one, HYMBA_LOSS_REL), with two more forward faults that must
            break the loss bar: the plain scan's decay applied before the
            query reads the state (RWKV's order), and every query seeing
            one key beyond the window. Unlike rwkv6-3b's, hymba's backward
            at random init does not amplify rounding (the kernels read
            8e-06 on dA / dB at 32 layers). The kernel runs launch flash
            and the scan twice per layer each.
23. hymba rank sweep — the slice's main path: phase 6 on hymba-1.5b at full
            width and HYMBA_SWEEP_LAYERS = 4 of its 32 layers (depth cut
            for time; 8 jobs, ranks 4/8/16/32 x lr 1e-4/1e-3, Z = 4, b = 2,
            S = 2,048, eval b = 4): every fused train step must launch the
            rank-local xa/sb_add 64 times, ds/da/db 32, dx 28 (the first
            layer's q/k/v and in_proj read the normed embedding), flash 8
            and the scan 8; every eval step xa/sb_add 32, flash 4 and
            the scan 4; the dense and ragged kernels never. The same measurements as phase 6, with flash's and the
            scan's shares of the device time.

The hymba-1.5b backbone is freed; the MoE phases follow
(``moe_phases``), on granite-moe-1b-a400m (24 layers, d_model 1024, 16
heads of 64 with 8 KV heads, 32 routed experts of d_ff 512, top-8,
capacity factor 1.25, vocab 49155, tied embeddings, bf16, random weights
from a seed; LoRA on q/k/v/o, 96 projections per forward; the experts,
router and embeddings frozen), then llama4-scout-17b-a16e:

24. moe kernels — the six rank-local kernels against their plain versions
            at granite's q/o (1024 x 1024) and k/v (1024 x 512) shapes at
            the train step's T = 1,024 rows a slot (ranks 4/8/16/32), the
            forward pair at the serve's decode rows (T = 4) and the eval
            step's (T = 4,096), timed beside the bound and ``torch.bmm``;
            flash attention against its plain version at granite's B =
            Z*b*H = 256 (train) and 1,024 (eval), S 256, hd 64 (GQA 16 / 8,
            the KV heads repeated before the kernel), and at llama4-scout's
            hd 128 (B = 640, 40 heads) in fp32 (its train check's path) and
            bf16, with phase 3b's bars, faults and batch independence.
25. moe layer — layer 0's MoE block at the train step's 4,096 tokens (one
            group, capacity 1,280), bf16: the device time of the router,
            the dispatch, the expert GEMMs, the combine and the whole
            block's forward (graph replay), the block's and the expert
            GEMMs' forward + backward (events); the router, dispatch and
            combine's time in one train step of 24 layers is printed
            beside the rank sweep's profiled busy time. The same for
            llama4-scout's layer (top-1 of 16, capacity 384, the shared
            expert).
26. moe serve — phase 4 on granite-moe: 16 greedy requests on 4 adapters
            (ranks 8-64), 4 lanes; the same launch counts (96 per forward),
            bars and planted faults; decode at T = 16 is lossless, the
            joins' block prefill (T up to 2,048) capacity-bound; flash 0.
27. moe train — phase 5 on granite-moe in fp32 at full width and depth
            (~5.3 GB of weights), the same bars and planted faults, plus a
            routing fault (the plain run's selected gates left
            unnormalized) that must break the loss bar; the kernel step
            run twice must give the same per-slot losses and every dA / dB
            bit for bit; the (token, choice) routing disagreements between
            one kernel and one plain forward, and each layer's dropped
            share, printed. Flash launches twice per layer.
28. moe rank sweep — the slice's main path: phase 6 on granite-moe at full
            width and depth (8 jobs, ranks 4/8/16/32 x lr 1e-4/1e-3, Z =
            4, b = 4, S = 256, eval b = 16): every fused train step must
            launch the rank-local xa/sb_add 192 times, ds/da/db 96, dx 93
            (the first layer's q/k/v read the normed embedding), flash 48;
            every eval step xa/sb_add 96 and flash 24; the dense and
            ragged kernels never. The same measurements as phase 6.
29. llama4 train — llama4-scout-17b-a16e at full width (d_model 5120, 40
            heads of 128 with 8 KV heads, 16 routed experts of d_ff 8192,
            top-1, one shared expert of 8192, capacity factor 1.5, vocab
            202048, untied head) cut to LLAMA4_LAYERS of its 48 layers, in
            fp32 (~26 GB of weights): phase 27's checks; flash at hd 128
            on a model path.

The llama4-scout backbone is freed; the last families' phases follow
(``family_phases``): qwen2-vl-72b (vlm: 80 layers, d_model 8192, 64 heads
of 128 with 8 KV heads, d_ff 29568, vocab 152064, untied, M-RoPE sections
(16, 24, 24) over (t, h, w) positions, a stub vision tower feeding 256
patch embeddings at the start of a sequence) cut to QWEN_LAYERS; then
musicgen-medium (audio: 48 layers, d_model 1536, 24 heads of 64, d_ff
6144, vocab 2048) at full size; then glm4-9b (2 KV heads, d_ff 13696),
granite-8b and mistral-nemo-12b (q_dim 4096 != d_model 5120) at full width
and DENSE_LAYERS layers; random weights from a seed:

30. family kernels — the six rank-local kernels against their plain
            versions at the train step's T = 1,024 rows a slot (ranks
            4-32) and the forward pair at decode rows (T = 4, ranks 8-64),
            timed beside the bound and ``torch.bmm``, at qwen2-vl's 8192 x
            8192, 8192 x 1024, 8192 x 29568 and 29568 x 8192, mistral's
            5120 x 4096 and 4096 x 5120, glm4's 4096 x 256 and 13696 x
            4096 and musicgen's 1536 x 6144; the dense, ragged and
            rank-local twins bitwise at full rank at 4096 x 5120 and 4096
            x 256; phase 3a's invariance at mistral's two shapes; flash in
            bf16 at hd 128 (qwen2-vl's B = 512 at S 512 and its eval B =
            4,096; glm4's B = 512, whose 2 KV heads are repeated 16 times)
            and at hd 64 (musicgen's B = 384 and 1,536), with phase 3b's
            bars, faults, SDPA yardstick and batch independence.
31. qwen2-vl — at full width and QWEN_LAYERS = 4 of 80 layers in bf16
            (~12 GB): an fp32 train check at QWEN_TRAIN_LAYERS = 2 (~17
            GB; Z 4, b 2, S 512) on an image-prefixed batch (256 patch
            embeddings of a 16 x 16 grid, N(0, 0.02) from a seed; patch
            (row, col) at (0, row, col), the text after it at (16 + i,
            16 + i, 16 + i); labels -1 on the prefix): phase 5's bars and
            faults at an fp32 loss bar (FAMILY_LOSS_REL), and three more
            planted faults in the plain run that must break it: the text
            positions (t, t, t), the token embeddings in place of the
            patch embeddings, the h and w sections swapped. Then the rank
            sweep (the vlm family's main path; text batches, as the
            reference's executor feeds): phase 6's settings and
            measurements, LoRA 56/56/28/25/28/28 and flash 8 a train step,
            28 and 4 an eval step; a serve (phase 4 over per-lane caches,
            whose decode positions are M-RoPE's (3, Z, b, 1)); and an
            image-prefixed prompt (``image_prompt_check``): 4 slots of 256
            patches and 64 text tokens prefilled into a global cache by
            ``make_prefill_step``, 8 greedy ``make_serve_step`` steps, the
            logits held against the plain versions within phase 4's bars,
            the run without the patch embeddings outside them.
32. musicgen — at full width and AUDIO_LAYERS = 8 of its 48 layers
            (depth cut for time): the rank sweep (the audio family's main
            path; LoRA 112/112/56/53/56/56 and flash 16 a train step, 56
            and 8 an eval step), a serve, and an fp32 train check
            (phase 5's bars and faults, loss bar FAMILY_LOSS_REL).
33. dense configs — fp32 train checks of glm4-9b, granite-8b and
            mistral-nemo-12b at full width and DENSE_LAYERS = 2 layers on
            the rank-local path (phase 5's bars and faults, loss bar
            FAMILY_LOSS_REL); mistral's also on the dense path at ranks 64,
            where the rank-local kernels at r_max must give its numbers
            bit for bit.
34. launch — the training launcher (``launch/train.py``) over a
            world-size-1 NCCL process group and ``make_local_mesh((1,
            1))``, destroyed at the end: ``run`` on full-width stablelm-3b
            at train_4k's b = 4 and S = 4,096 with LAUNCH_Z slots and all 32
            layers, 3 steps through ``steps_dist.make_train_step`` (finite
            per-slot losses, the peak GiB, LoRA 448/448/224/221/224/224 on
            the dense set and flash 64 in every step) and the step's MFU
            (the roofline's ``model_flops`` at rank 8 over the median step
            at the bf16 peak); at
            LAUNCH_CHECK_LAYERS = 4 layers ``remat=False`` == ``remat=True``
            and opt levels 0 / 1 / 2 bit for bit, and the scan kernel at the
            opt-level-2 policy's ``scan_chunk`` 32 against its plain
            version; then the CLI, ``main(["--reduced", "--steps",
            "2"])``.
35. ap train — Adapter Parallelism on a real multi-rank mesh: the six
            rank-local kernels at the 2 x 2 split's shapes (column-parallel
            2560 -> 1280 and 2560 -> 3456, row-parallel 1280 -> 2560, timed,
            and 3456 -> 2560, T = AP_B * AP_S rows a slot) and flash on each
            rank's 16 heads (hd 80) against their plain versions; then
            AP_PROCS processes of ``python -m repro_torch.launch.train
            --mesh 2x2 --backend gloo`` on this one card (the main path,
            alone on the card; the kernel libraries built above, loaded,
            not rebuilt) on full-width stablelm-3b at AP_LAYERS = 8 of its
            32 layers (cut to make room for phases 36 and 39) at AP_Z
            slots, b = AP_B, S = AP_S, ranks 8/16/32/64 bound, AP_STEPS
            steps, each rank asserting its device and printing its step s,
            peak GiB, kernel launches (summed into the table: per rank and
            step 448/448/224/221/224/224 rank-local and 64 flash) and logged
            collective bytes by axis and role (no data-axis collective of
            role adapter_grad or with a last dim of r_max; model-axis
            adapter-gradient all-reduces); then the launcher's one-rank run
            (``launch.train.run``, NCCL) with the same settings, beside
            a job of the planted-fault pool (``ApRuns``: AP_PROCS processes
            of this script's ``--ap-faults`` loop, started once with phase
            35's ranks, serving phases 35-38; each run's launcher ranks
            start while the previous run's controls run) (AP_STEPS steps;
            on data rank 0 layer AP_FAULT_LAYER's
            row-parallel reduce-scatter skipped, data rank 1 fed rank 0's
            slots). The main path's per-slot losses of both steps and every
            updated adapter leaf must lie within AP_LOSS_REL and
            AP_ADAPTER_REL of the one-rank run's, and each fault, on its
            own slots, must break both bars.
36. ap moe — the MoE family on the same mesh and load: the six
            rank-local kernels at granite-moe's 2 x 2 split (q 1,024 -> 512
            and k/v 1,024 -> 256 column-parallel, o 512 -> 1,024
            row-parallel, timed) and flash on a rank's 8 heads of hd 64
            against their plain versions; then phase 35's runs on
            full-size granite-moe-1b-a400m (experts over "model", capacity
            routing across data ranks: the one-rank run prints each layer's
            dropped share of each data rank's choices, and data rank 1 must
            drop some in layer AP_MOE_ROUTE_LAYER), within AP_MOE_LOSS_REL
            and AP_MOE_ADAPTER_REL, the data axis carrying only base
            weights, metrics and the router's counts; planted faults, each
            in a run of its own: data rank 1 routes layer
            AP_MOE_ROUTE_LAYER without rank 0's counts (read on slots 2-3),
            data rank 0's MoE partial sum in layer AP_MOE_SLICE_LAYER
            sliced, not reduce-scattered (slots 0-1); then
            llama4-scout-17b-a16e at full width and AP_LLAMA4_LAYERS
            layers (top-1 routing, the shared expert, a vocabulary split
            over "model"), AP_LLAMA4_STEPS step, 2 x 2 against 1 x 1 within
            AP_LLAMA4_LOSS_REL and AP_LLAMA4_ADAPTER_REL.
37. ap ssm / hybrid — the ssm and hybrid families on the same mesh
            (``ap_ssm_phase``): rows 13-18 at each rank's shapes of the
            2 x 2 split (rwkv6-3b's column- and row-parallel r/k/v/g/o and
            ffn_k/ffn_v; hymba-1.5b's in_proj in blocks, its whole q/k/v/o
            and its MLP), the scan on a rank's heads (20 RWKV heads at S
            512; 25 Mamba heads in SSD mode at S 2,048) and flash on
            hymba's whole 25 heads with the window of 1,024, against their
            plain versions; then phase 35's runs on rwkv6-3b at full width
            and AP_RWKV_LAYERS layers in bf16 (Z 4, b 2, S 512; scan heads
            over "model", one gather before each token shift; held on the
            loss, its adapters noise-bound: RWKV amplifies the rounding of
            bf16 partial sums), again in fp32 at AP_RWKV_CHECK_LAYERS
            layers with fault (a), data rank 0 shifting each model rank's
            block alone (slots 0-1), and on hymba-1.5b at full width and
            AP_HYMBA_LAYERS layers (Z 4, b 1, S 2,048; attention whole on
            every model rank, Mamba heads split, bc/dt partial products
            all-reduced) with fault (b), data rank 1 taking in_proj's
            contiguous column block (slots 2-3), each 2 x 2 against 1 x 1
            within its bars.
38. ap vlm / audio — the vlm and audio families on the same mesh
            (``ap_modal_phase``): rows 13-18 at each rank's shapes of the
            2 x 2 split (qwen2-vl-72b: q 8,192 -> 4,096, k/v 8,192 -> 512,
            gate/up 8,192 -> 14,784 column-parallel, o 4,096 -> 8,192,
            timed, and down 14,784 -> 8,192 row-parallel; musicgen-medium:
            q/k/v 1,536 -> 768, gate/up 1,536 -> 3,072, o 768 -> 1,536,
            timed, down 3,072 -> 1,536) and flash on a rank's heads
            (qwen2-vl's 32 heads of 128 at S 384, musicgen's 12 of 64 at S
            512) against their plain versions; then phase 35's runs on
            musicgen-medium at full width and AP_AUDIO_LAYERS layers (Z 4,
            b 2, S 512), and on qwen2-vl-72b at full width and AP_QWEN_LAYERS
            layers (Z 4, b 2, S 384: the 256-patch prefix, N(0, 0.02),
            crosses the model ranks' boundary at 192; M-RoPE positions of a
            16 x 16 patch grid for slots 0-1 and 8 x 32 for slots 2-3,
            ``launch.train.modal_inputs``) with faults (c), data rank 0's
            model ranks writing the prefix at the head of their own blocks
            (slots 0-1), and (d), data rank 1 taking data rank 0's
            positions (slots 2-3), planted together (their fault ranks run
            before the one-rank run: four ranks drawing qwen2-vl's weights
            and the one-rank run do not share the card), each 2 x 2
            against 1 x 1 within phase 35's bars; a fault must pass both.
            Every sharded run of phases 35-38 (and each fault run) ends
            with one sharded eval step on the next batch with its trained
            adapters; its per-slot losses are read against the one-rank
            run's eval step on the same adapters, weights and batch within
            the run's loss bar, and a fault whose train loss reads past
            its bar must read AP_EVAL_FAULT_X times the sound eval reading
            of its config (but AP_EVAL_UNSEEN). Each rank's eval launches
            are counted apart from its steps'.
39. ap dpo / serve — the sharded DPO loss and the sharded prefill and
            serve steps (``steps_dist``) as two jobs of the fault pool's
            four ranks on the same mesh: rows 13-18 at a rank's fp32 DPO
            shapes, rows 13-14 at its decode shapes (T 2 a slot) and flash
            in fp32 on its 16 heads at S AP_DPO_S against their plain
            versions; then (i) full-width stablelm-3b in fp32 at
            AP_DPO_LAYERS layers, Z 4, DPO_B pairs of S 256 a slot,
            AP_DPO_STEPS DPO steps and a DPO eval against a one-rank run
            (loss, eval and adapter readings within AP_DPO_LOSS_REL /
            AP_DPO_ADAPTER_REL; fault "dpo_swap", data rank 1's policy
            forwards swapping each pair, past all three on slots 2-3), and
            (ii) full-width stablelm-3b in bf16 at AP_SERVE_LAYERS layers,
            Z 4, b 2, a per-lane cache: a prompt of AP_SERVE_S tokens
            prefilled into a cache as long as the prompt (flash), the cache
            grown, AP_SERVE_DECODES serve steps fed the one-rank run's
            greedy tokens and one with AP_IDLE_LANES idle, every step's
            logits per slot within LOGITS_ATOL_REL / LOGITS_REL_RMS of the
            one-rank run's (the greedy agreement printed), the idle lanes'
            K/V rows and positions bitwise untouched on every rank, fault
            "kv_roll" (data rank 0's last model rank writing its KV heads
            rolled) past both bars on slots 0-1 and the other slots within
            them; (iii-v) the same serving, each job at its own width and
            depth (``AP_SERVE_JOBS``), for full-size granite-moe-1b-a400m
            at S 512 (fault "route_blind" in the prefill's layer 0, held
            at AP_SERVE_MOE_BARS on the data-rank-1 slots whose choices
            the capacity drops), rwkv6-3b at AP_RWKV_LAYERS layers, S 512
            (fault "state_roll", a model rank's wkv heads rolled after the
            prefill, slots 2-3) and hymba-1.5b at AP_HYMBA_LAYERS layers,
            S 2,048 (whole attention heads, the window binding; fault
            "conv_roll", a model rank's conv block rolled, slots 0-1), the
            cache laid out by ``serve_cache_specs``, every leaf of an idle
            lane bitwise untouched on every rank and the prefilled cache's
            relative RMS against the one-rank run printed leaf by leaf;
            rows 13-14 at each job's per-rank decode widths and hymba's
            prefill, flash and the SSD scan at hymba's prefill shapes
            checked first; (vi-viii) the pod jobs, AP_POD_JOBS, on
            ("pod", "data", "model") meshes of the pool's four ranks;
            (ix-xii) the uneven jobs, AP_UNEVEN_JOBS, on ("data",
            "model") meshes of them: hymba-1.5b's train and serve steps
            with its 50 Mamba and 25 attention heads whole on 1 x 4,
            hymba's train step with ragged slot rows over a split model
            axis on 2 x 2 (the ragged kernels), full granite-moe's at S
            768, whose token groups of 2,048 neither divide nor are
            divided by a data rank's run of 3,072 rows, on 2 x 2; each
            with one planted fault, rows 7-12, 13-18, 19 and 20 checked
            first at their rank shapes. Every rank's launches of rows
            7-20 are checked.

The last line is ``{"ok": true, "device": {...}}``; the line before it the
kernel table as JSON (twenty kernels), with each kernel's launches by
path (``engine_static`` and ``engine_elastic`` for the engine phase's two
runs, ``service`` and ``service_recovery`` for the service's trainings,
``service_serve`` for its served requests, ``moe_train`` and
``moe_serve`` for granite-moe's sweep and serve, ``llama4_train`` for
llama4-scout's kernel step, ``vlm_train``, ``vlm_sweep``, ``vlm_serve``
and ``vlm_prompt`` for qwen2-vl's train check, sweep, serve and image
prompt, ``audio_sweep``, ``audio_serve`` and ``audio_train`` for
musicgen's, ``dense_cfg_train`` for the dense configs' train checks,
``launch_train`` for the launcher's full-width steps, ``ap_train``,
``ap_moe_train``, ``ap_llama4_train``, ``ap_rwkv_train``,
``ap_hymba_train``, ``ap_vlm_train`` and ``ap_audio_train`` for the sharded
steps' four ranks, summed, and ``ap_dpo`` and ``ap_serve_<job>``
(stablelm, granite, rwkv, hymba) for phase 39's sound sharded DPO steps
and serving jobs, its four ranks summed).
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
# and ds of three sets at two default tiles and the three more of the tile
# plans (autotune.PLAN_SET: 64 x 32 / 32 x 32, 32 x 64, 16 x 32), fp32 one
# in each of the four sources; tn: da and db of three sets at the default
# 64 x 64 and two plan tiles each (da 128 x 32, 64 x 32; db 32 x 128,
# 32 x 64), fp32 one each; rank_sum: sb_add and dx of three sets at two
# default tiles and five plan tiles (bf16) or one (fp32); flash: one per
# head dim
TC_INSTANTIATIONS = {"narrow_out_kernel": (30, 4), "tn_kernel": (18, 6),
                     "rank_sum_kernel": (42, 6), "flash_fwd_kernel": (5, 5)}

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
# layers of the recovery and service recovery phases (full width; cut from
# 4 so that the script with phase 37 fits its limit on a slow host: their
# checkpoints, written every chunk, shrink with the depth; PERF.md §4)
RECOVERY_LAYERS = 2
# layers of stablelm-3b's lr sweep, heterogeneous co-location, DPO sweep,
# engine and service phases (full width; the lr sweep cut from 32 so that
# the rwkv6-3b phases fit in half the script's time limit, the others so
# that the script with phase 37 fits its limit on a slow host, and all of
# them from 8 to 4 for phase 39's uneven jobs; PERF.md §4)
SWEEP_LAYERS = 4
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
# the depth of that first check, the loss bar's (cut from full depth, 32,
# to make room for phase 39, and from 16 for its uneven jobs)
RWKV_CHECK_LAYERS = 8
# layers of the rwkv rank sweep (full width; cut from 32 so that the last
# families' phases fit the script's time, from 16 to make room for phase
# 37, and from 8 for phase 39's pod jobs)
RWKV_SWEEP_LAYERS = 4
# hymba-1.5b's paths: S = 2048 (its sliding window of 1024 binds in every
# forward), b = 2 sequences a slot in a train step, HYMBA_EVAL_B in an eval
# step; its LoRA projections (din, dout): q/o, k/v, in_proj, gate/up, down
HYMBA_S, HYMBA_B, HYMBA_EVAL_B = 2048, 2, 4
# layers of the hymba rank sweep (full width; cut from 32 so that the
# autotune and launch phases fit the script's time, from 16 to make room
# for phase 37, and from 8 for phase 39's pod jobs)
HYMBA_SWEEP_LAYERS = 4
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
# layers of hymba's fp32 train and ring-wrap checks: cut from 32 to 16 so
# that phase 35 fits the script's time, to 8 for phase 37 and to 4 for
# phase 39 (its runs at 32 layers read the figures above)
HYMBA_CHECK_LAYERS = 4
# hymba-1.5b's ring past its wrap: two lanes prefilled with RING_PREFILL
# tokens, then one lane decodes RING_STEPS more (positions 1,000-1,063: the
# ring of 1,024 slots wraps after 24 steps), in fp32; its logits against
# the full forward's, as max |diff| / max |forward|
RING_PREFILL, RING_STEPS = 1000, 64
RING_LOGITS_REL = 1e-4
# granite-moe-1b-a400m's LoRA projections (din, dout): q/o, k/v
GRANITE_SHAPES = ((1024, 1024), (1024, 512))
# llama4-scout-17b-a16e at full width is cut to LLAMA4_LAYERS of its 48
# layers: its fp32 train check then holds ~26 GB of weights
LLAMA4_LAYERS = 2
# the MoE train checks' loss bar, an fp32 one as HYMBA_LOSS_REL: on an
# NVIDIA H100 80GB HBM3 at 700 W the kernels read at most 8.7e-08
# (granite-moe, 24 layers; 4 of its 786,432 (token, choice) pairs routed
# otherwise) and 7.5e-08 (llama4-scout, 2 layers), while the mildest
# planted forward fault, slot 0's rank-4 delta halved, reads 6.4e-05 and
# 3.1e-04 (PERF.md)
MOE_LOSS_REL = 2e-6
# qwen2-vl-72b at full width is cut to QWEN_LAYERS of its 80 layers in bf16
# (~12 GB: 1.76 GB a layer, 4.98 GB for the untied embedding and head) and
# to QWEN_TRAIN_LAYERS in its fp32 train check (~17 GB); that check's
# batch: b = QWEN_B sequences of QWEN_S tokens a slot, each led by the
# stub vision tower's 256 patch embeddings of a QWEN_GRID patch grid
QWEN_LAYERS, QWEN_TRAIN_LAYERS = 4, 2
QWEN_S, QWEN_B = 512, 2
QWEN_GRID = (16, 16)
# decode steps after the image-prefixed prompt; its text tokens
IMAGE_DECODES, IMAGE_TEXT = 8, 64
# glm4-9b, granite-8b and mistral-nemo-12b at full width, DENSE_LAYERS of
# their 36-40 layers, in their fp32 train checks
DENSE_LAYERS = 2
# musicgen-medium at full width is cut to AUDIO_LAYERS of its 48 layers for
# its rank sweep, serve and fp32 train check (the check cut from 48 to 24
# once phase 36 came, all three to 16 so that the script with phase 37 fits
# its limit on a slow host, and to 8 for phase 39's pod jobs; PERF.md §4)
AUDIO_LAYERS = 8
# the LoRA projections (din, dout) of the last families: qwen2-vl's q/o,
# k/v, gate/up and down; mistral-nemo's q and o (q_dim 4,096 != d_model
# 5,120); glm4's k/v (2 KV heads of 128) and down (13,696 = 107 x 128);
# musicgen's gate/up
FAMILY_SHAPES = {"qwen2-vl": ((8192, 8192), (8192, 1024), (8192, 29568),
                              (29568, 8192)),
                 "mistral": ((5120, 4096), (4096, 5120)),
                 "glm4": ((4096, 256), (13696, 4096)),
                 "musicgen": ((1536, 6144),)}
# the fp32 train checks of the last families: an fp32 loss bar, as
# MOE_LOSS_REL
FAMILY_LOSS_REL = 2e-6
# the launcher at full width and train_4k's b = 4, S = 4,096: LAUNCH_Z
# slots of train_4k's 64 (what the card holds, see PERF.md), all 32
# layers; its bitwise checks at LAUNCH_CHECK_LAYERS layers
LAUNCH_Z = 1
LAUNCH_RANK = 8             # the launcher's default adapter rank
LAUNCH_CHECK_LAYERS = 4
# phase 35: the launcher's sharded step over a 2 x 2 (data, model) mesh of
# AP_RANKS processes sharing the card (gloo), on full-width stablelm-3b at
# AP_LAYERS of its 32 layers (cut from full depth to make room for phase 36,
# and from 16 to 8 for phase 39)
# at AP_Z slots of AP_B sequences of AP_S tokens, slot ranks RANKS, AP_STEPS
# steps; held against the one-rank run of the same seed.
# Bars (bf16, relative): per slot and step |loss diff| / |loss|; per adapter
# leaf and slot the RMS of (sharded - one-rank) over the RMS of the
# one-rank run's update (one-rank - init). The planted faults (one layer's
# row-parallel reduce-scatter skipped; data rank 1 fed rank 0's slots)
# must break both. The adapter reading is large even when sound: B starts
# at 0, so A's first nonzero gradient comes at step 1, and AdamW's first
# step there moves each entry by about lr times the sign of its gradient;
# the sharded run's bf16 partial sums flip the signs of the gradient
# entries nearest 0. On an H100 the sound run reads 6.84e-4 and 0.429, the
# faults, each on its own slots, at least 6.96e-3 and 1.23 (PERF.md).
AP_MESH = "2x2"
AP_PROCS = 4
# a run's ranks start while the previous run's controls hold the card only
# if, all building their full weights at once (launch.train.init_bytes a
# rank), they need at most this much of it: llama4-scout's 155 GB (its
# ranks take turns sized to the card's free memory when they start) waits
# for the controls to end
AP_EARLY_BYTES = 36e9
AP_LAYERS = 8
AP_Z, AP_B, AP_S, AP_STEPS = 4, 2, 512, 2
AP_LOAD = (AP_Z, AP_B, AP_S)
AP_FAULT_LAYER = 5
# the slots each planted fault reaches (one run plants both: one on each
# data rank)
AP_FAULT_SLOTS = {"skip_scatter": (0, 1), "swap_slots": (2, 3)}
AP_LOSS_REL = 3e-3
AP_ADAPTER_REL = 0.75
# every sharded run of phases 35-38 ends with one sharded eval step, read
# against the one-rank run's eval step on the same adapters and batch: per
# slot |eval diff| / |eval|, held within the run's loss bar. A planted
# fault whose train loss reads past its bar must read at least
# AP_EVAL_FAULT_X times the sound eval reading of its config in the same
# call (the main path's, or the fault ranks' own sound run where they run
# a config of their own). At random init a forward fault moves an eval
# 9x to 4,400x a sound run's on an H100 (PERF.md), except granite's route
# fault, 1.9x: data rank 1 drops other choices, whose random experts move
# a loss as little as rounding does. Its train loss and adapters hold it
# (AP_EVAL_UNSEEN)
AP_EVAL_FAULT_X = 4
AP_EVAL_UNSEEN = ("route_blind",)
AP_TIMEOUT_S = 420
# phase 36: the MoE family's sharded step, on the same mesh, load and
# ranks as phase 35: full-size granite-moe-1b-a400m (bf16) against its
# one-rank run; then llama4-scout-17b-a16e at full width and
# AP_LLAMA4_LAYERS layers, AP_LLAMA4_STEPS step, against its one-rank run.
# Planted faults, each in a run of its own, one after the other in the same
# fault ranks (rank 0's tokens reach rank 1's queue places through the
# counts, so one run could not tell them apart):
# data rank 1 routes layer AP_MOE_ROUTE_LAYER without rank 0's counts (its
# queue places start at 0; it drops 42% of its choices there on an H100,
# PERF.md), read on slots 2-3; data rank 0's MoE partial sum in layer
# AP_MOE_SLICE_LAYER is sliced, not reduce-scattered, read on slots 0-1.
# The bars are bf16 readings, set from the card's sound runs (PERF.md).
AP_MOE_ARCH = "granite-moe-1b-a400m"
AP_MOE_FAULT_RUNS = ({"route_blind": (2, 3)}, {"moe_slice": (0, 1)})
AP_MOE_ROUTE_LAYER = AP_MOE_SLICE_LAYER = 0
AP_MOE_LOSS_REL = 1.5e-3
AP_MOE_ADAPTER_REL = 0.75
AP_LLAMA4_ARCH = "llama4-scout-17b-a16e"
# (AP_LLAMA4_LAYERS cut from 2 to 1, every layer an MoE one, for phase 39)
AP_LLAMA4_LAYERS, AP_LLAMA4_STEPS = 1, 1
AP_LLAMA4_LOSS_REL = 3e-3
AP_LLAMA4_ADAPTER_REL = 0.75
# phase 37: the ssm and hybrid families' sharded step, on the same mesh
# and ranks as phase 35: rwkv6-3b at full width (40 heads: 20 a model
# rank) and AP_RWKV_LAYERS of its 32 layers (cut from 8 for time) at Z 4,
# b 2, S 512; hymba-1.5b
# at full width (25 heads and 5 KV heads, whole on every model rank; 50
# Mamba heads, 25 a rank) and AP_HYMBA_LAYERS of its 32 layers at Z 4, b 1,
# S 2,048 (its window of 1,024 binds); AP_STEPS steps each, against its
# one-rank run. Planted faults, in layer AP_SSM_FAULT_LAYER, each on its
# own data rank's slots: (a) rwkv, data rank 0 shifts each model rank's
# sequence block alone (slots 0-1); (b) hymba, data rank 1 takes in_proj's
# contiguous column block for its x/z split (slots 2-3). The bars are set
# from the card's sound runs (PERF.md). RWKV's step amplifies rounding: in
# bf16 the sharded partial sums move its loss by 1.5e-4 at step 0 and, by
# step 1, 9.6e-4 at 4 layers (1.6e-3 at 8), as much as fault (a) moves it
# (9.2e-4 at 8 layers), so the bf16 run (the main path) is held on the loss
# and its fault ranks run the same width in fp32 at AP_RWKV_CHECK_LAYERS
# layers, sound and with fault (a): the sound fp32 loss agrees within 1e-7
# at step 0 and 1.2e-4 at step 1, the fault's reads 8.9e-4. The adapters,
# in both dtypes, differ by about their whole update (AdamW's first steps
# move an entry by lr times the sign of its gradient, and the sums flip
# the signs of RWKV's many near-zero gradient entries: 0.96 in fp32, the
# fault 1.11): their bars only bound that noise, and the fault must pass
# the loss bar.
AP_RWKV_ARCH, AP_RWKV_LAYERS, AP_RWKV_LOAD = "rwkv6-3b", 4, (4, 2, 512)
AP_RWKV_CHECK_LAYERS = 4
AP_HYMBA_ARCH, AP_HYMBA_LAYERS, AP_HYMBA_LOAD = "hymba-1.5b", 4, (4, 1, 2048)
AP_SSM_FAULT_LAYER = 0
AP_RWKV_FAULT_RUNS = ({"shift_local": (0, 1)},)
AP_HYMBA_FAULT_RUNS = ({"in_proj_cols": (2, 3)},)
AP_RWKV_LOSS_REL, AP_RWKV_ADAPTER_REL = 3e-3, 2.5
AP_RWKV_FP32_LOSS_REL, AP_RWKV_FP32_ADAPTER_REL = 3e-4, 1.5
AP_HYMBA_LOSS_REL, AP_HYMBA_ADAPTER_REL = 1e-3, 0.75
# phase 38: the vlm and audio families' sharded step, on the same mesh,
# ranks and bars as phase 35: musicgen-medium at full width and
# AP_AUDIO_LAYERS of its 48 layers at Z 4, b 2, S 512, no fault of its own
# (its path is phase 35's dense one); then qwen2-vl-72b at full width (64
# heads and 8 KV heads: 32 and 4 a model rank) and AP_QWEN_LAYERS of its 80
# layers at Z 4, b 2, S 384 (its 256-patch prefix spans both model ranks'
# blocks of 192), with faults (c) and (d) planted together, each on its own
# data rank's slots. Both cut for time (4 and 16 layers put the script past
# 1,100 s on an H100's host; PERF.md), musicgen again from 8 to 4 for phase
# 39's uneven jobs
AP_QWEN_ARCH, AP_QWEN_LAYERS, AP_QWEN_LOAD = "qwen2-vl-72b", 2, (4, 2, 384)
AP_QWEN_FAULT_RUNS = ({"prefix_head": (0, 1), "positions_rank0": (2, 3)},)
AP_AUDIO_ARCH, AP_AUDIO_LAYERS, AP_AUDIO_LOAD = ("musicgen-medium", 4,
                                                 (4, 2, 512))
# phase 39: the fault pool's two jobs of the sharded DPO loss and the
# sharded prefill and serve steps, on the same mesh and ranks as phase 35,
# each against a one-rank run in this process. (i) DPO: full-width
# stablelm-3b in fp32 (DPO's margin, beta times a difference of per-slot
# sums of log-probabilities, amplifies bf16 rounding about 660x, PERF.md)
# at AP_DPO_LAYERS layers, Z 4, DPO_B pairs a slot of S 256, AP_DPO_STEPS
# steps at lr AP_DPO_LR (1e-3 carries margins far enough for -log sigmoid
# to round to 0 in a step or two), then the DPO eval step on the next
# pairs; planted fault "dpo_swap": data rank 1's policy forwards swap each
# pair (slots 2-3). (ii) Serving: full-width stablelm-3b in bf16 at
# AP_SERVE_LAYERS layers, Z 4, b 2, a per-lane cache, a prompt of
# AP_SERVE_S random tokens prefilled into a cache as long as the prompt
# (the flash kernel), grown by AP_SERVE_DECODES + 1 rows, then
# AP_SERVE_DECODES serve steps fed the one-rank run's greedy tokens and one
# more with AP_IDLE_LANES idle (one lane on each data rank); planted fault
# "kv_roll": on data rank 0 the last model rank writes its KV heads rolled
# by one head (slots 0-1). The DPO bars are relative (loss and eval per
# slot, and the adapters' RMS reading of phase 35), set from the card's
# sound runs: on an H100 the sound run reads 6.545e-05 (loss), 1.184e-04
# (eval) and 4.455e-03 (adapters: in fp32 few gradient signs flip), the
# fault 7.403, 1.613 and 1.997 (PERF.md). The serving bars are
# LOGITS_ATOL_REL / LOGITS_REL_RMS per slot over every step's logits: the
# sound run reads at most 0.02033 / 0.02084 there, the fault at least
# 1.40123 / 1.37081 on its slots.
AP_DPO_LAYERS, AP_DPO_STEPS, AP_DPO_S, AP_DPO_LR = 4, 2, 256, 1e-4
AP_DPO_LOSS_REL, AP_DPO_ADAPTER_REL = 5e-4, 0.05
AP_DPO_FAULT = {"dpo_swap": (2, 3)}
# (AP_SERVE_LAYERS cut from 8 to 4 for the uneven jobs: the readings
# below are 8 layers')
AP_SERVE_LAYERS, AP_SERVE_S, AP_SERVE_DECODES = 4, 512, 16
AP_IDLE_LANES = ((0, 1), (3, 0))
AP_SERVE_FAULT = {"kv_roll": (0, 1)}
# (iii-v) the serving job of the other families, each as (ii): Z 4, b 2,
# bf16, a per-lane cache as long as the prompt, grown after the prefill,
# AP_SERVE_DECODES steps fed the one-rank run's tokens and one with
# AP_IDLE_LANES idle, then the same with its planted fault: full-size
# granite-moe-1b-a400m at S 512 (the prefill's token group spans the data
# ranks; "route_blind", phase 36's fault (a) in the prefill's layer
# AP_MOE_ROUTE_LAYER, slots 2-3); rwkv6-3b at full width and
# AP_RWKV_LAYERS layers at S 512 (the scan on a rank's 20 of 40 heads;
# "state_roll", on data rank 1 the last model rank's wkv heads of layer 0
# rolled by one head after the prefill, slots 2-3); hymba-1.5b at full
# width and AP_HYMBA_LAYERS layers at S 2,048 (its window of 1,024 binds;
# attention whole on every model rank, the scan on a rank's 25 of 50
# Mamba heads; "conv_roll", on data rank 0 the last model rank's conv block
# of layer 0 rolled by one row along W-1 after the prefill, slots 0-1).
# Each job's logits are held per slot at LOGITS_ATOL_REL / LOGITS_REL_RMS
# but granite's, at AP_SERVE_MOE_BARS: on an H100 its sound idle step (one
# token a lane) read 0.04299 / 0.04254 on slot 3, past the shared RMS bar
# where every other job stayed within it, and its route fault 0.21712 /
# 0.19163 at least (PERF.md; a top-8 expert choice flipped by bf16
# rounding is the likely cause, not measured).
# Each job: name -> (arch, layers (None: every layer), prompt S, fault,
# bars)
AP_SERVE_MOE_BARS = (0.1, 0.08)
AP_SERVE_JOBS = {
    "stablelm": ("stablelm-3b", AP_SERVE_LAYERS, AP_SERVE_S, AP_SERVE_FAULT,
                 (LOGITS_ATOL_REL, LOGITS_REL_RMS)),
    "granite": (AP_MOE_ARCH, None, 512, {"route_blind": (2, 3)},
                AP_SERVE_MOE_BARS),
    "rwkv": (AP_RWKV_ARCH, AP_RWKV_LAYERS, 512, {"state_roll": (2, 3)},
             (LOGITS_ATOL_REL, LOGITS_REL_RMS)),
    "hymba": (AP_HYMBA_ARCH, AP_HYMBA_LAYERS, 2048, {"conv_roll": (0, 1)},
              (LOGITS_ATOL_REL, LOGITS_REL_RMS)),
}
# (vi-viii) the pod jobs: the sharded steps on a real ("pod", "data",
# "model") mesh over the pool's AP_PROCS ranks, "pod" splitting each slot's
# b = 2 rows, one a pod rank; the adapters, their AdamW state and the base
# weights replicated over it. "pod_train": phase 35's run (stablelm-3b,
# AP_LAYERS layers, AP_LOAD, RANKS, AP_STEPS steps and an eval step) on pod
# 2 x data 1 x model 2, read against phase 35's one-rank run at its bars;
# fault "pod_grad_skip", slots 2-3's adapter gradients not all-reduced over
# "pod" (each pod rank steps on its own row's share). "pod_moe": phase 36's
# run (full-size granite-moe-1b-a400m) on pod 2 x data 2 x model 1, its one
# group of 4,096 tokens in 8 interleaved pieces of 512, 2 a rank, read
# against phase 36's one-rank run at its bars; fault "route_pod_blind",
# pod rank 1 of data rank 1 routes layer AP_MOE_ROUTE_LAYER without its pod
# peer's counts (slots 2-3, the pieces of their lane 1). "pod_serve": job
# (ii) on pod 2 x data 1 x model 2, fed the one-rank stablelm run's tokens
# and held against its logits per (slot, lane) at (ii)'s bars, then the idle
# step; fault "pod_kv_roll", on pod rank 1 the last model rank writes its KV
# heads rolled by one head (lane 1 of every slot). Each: name -> (arch,
# layers (None: every layer), mesh (p, d, m), faults {fault: the slots, or
# for "pod_serve" the lanes,
# it reaches}). A reduced rehearsal's train jobs take AP_POD_REDUCED_LOAD
AP_POD_AXES = ("pod", "data", "model")
AP_POD_JOBS = {
    "pod_train": ("stablelm-3b", AP_LAYERS, (2, 1, 2),
                  {"pod_grad_skip": (2, 3)}),
    "pod_moe": (AP_MOE_ARCH, None, (2, 2, 1), {"route_pod_blind": (2, 3)}),
    "pod_serve": ("stablelm-3b", AP_SERVE_LAYERS, (2, 1, 2),
                  {"pod_kv_roll": (1,)}),
}
AP_POD_REDUCED_LOAD = (4, 2, 32)
# (ix-xii) the last sharded refusals: each a job of the pool on a ("data",
# "model") mesh of its own over the pool's AP_PROCS ranks
# (``launch.mesh.make_local_mesh``, kept by shape), sound and with one
# planted fault, read against a one-rank run. "scan_whole": phase 37's hymba
# run (full width, AP_HYMBA_LAYERS layers, AP_HYMBA_LOAD, RANKS, AP_STEPS
# steps and an eval step) on data 1 x model 4, where neither its 50 Mamba
# heads nor its 25 attention heads split: both run whole on every model
# rank; read against phase 37's one-rank run at its bars; fault
# "scan_block_wrong", in layer AP_SSM_FAULT_LAYER model rank 3 keeps model
# rank 2's sequence block of the whole Mamba output for slots 2-3.
# "scan_whole_serve": job (v), hymba's serving, on data 1 x model 4, fed
# the one-rank hymba serving's tokens and held against its logits at (v)'s
# bars, the idle step's lanes untouched and the model ranks' conv and ssm
# leaves bitwise equal; fault "whole_state_roll", model rank 0's ssm heads
# of every layer rolled by one head for slots 0-1 after the prefill (layer
# 0's alone read 0.05208 / 0.02726 on slot 0 on an H100, PERF.md; a decode
# step counts model rank 0's whole output once, so the other model ranks'
# states reach no logit: the bitwise check holds them). "ragged_model":
# hymba at full width and AP_HYMBA_LAYERS layers, Z 4, b 2, S 1,024, every
# slot at r_max with only its rows bound (the ragged kernels), widths
# AP_RAGGED_WIDTHS (slot_rows 2,048, 1,024, 1,024, 2,048; a lane's tail
# padded as the executor pads it) on data 2 x model 2 (attention whole: its
# o_proj's LoRA on a rank's sequence block of 512), AP_STEPS steps and no
# eval step (neither package's eval step takes slot rows), against a
# one-rank run of the same load and rows at phase 37's hymba bars; fault
# "rows_swapped", data rank 1 binds data rank 0's rows: slot 3's second
# row loses its LoRA term, and slot 2's extra row is padding. "moe_odd":
# full-size granite-moe-1b-a400m at Z 4, b 2, S 768 on data 2 x model 2: T
# 6,144, groups of 2,048, a data rank's run of 3,072, so three pieces of
# 1,024 a rank, one group across the data ranks' boundary; AP_STEPS steps
# and an eval step against a one-rank run of the same load at phase 36's
# bars; fault "route_blind" (phase 36's: data rank 1 routes layer
# AP_MOE_ROUTE_LAYER without the other data rank's counts), which reaches
# slot 2: only its first 1,024 tokens share a group (flat 2,048-4,095)
# with data rank 0; it must read past the adapter bar there (an H100
# reads 0.9993, its loss 4.728e-04 under the bar, as phase 36's loss
# reading sat near its bar), and slot 3, whose tokens share group 2
# with slot 2's tail, moves at step 1 within the bars (1.167e-03, 0.6721;
# PERF.md). Each: name -> (arch, layers (None: every layer), mesh
# (d, m), load (Z, b, S; None: the serving job's), faults {fault: the slots
# it reaches}, what each fault must read past its bars). A reduced
# rehearsal's train jobs take AP_UNEVEN_REDUCED_LOADS
AP_RAGGED_WIDTHS = (2, 1, 1, 2)
AP_UNEVEN_JOBS = {
    "scan_whole": (AP_HYMBA_ARCH, AP_HYMBA_LAYERS, (1, 4), AP_HYMBA_LOAD,
                   {"scan_block_wrong": (2, 3)}, ("loss", "adapters")),
    "scan_whole_serve": (AP_HYMBA_ARCH, AP_HYMBA_LAYERS, (1, 4), None,
                         {"whole_state_roll": (0, 1)}, ()),
    "ragged_model": (AP_HYMBA_ARCH, AP_HYMBA_LAYERS, (2, 2), (4, 2, 1024),
                     {"rows_swapped": (3,)}, ("loss", "adapters")),
    "moe_odd": (AP_MOE_ARCH, None, (2, 2), (4, 2, 768),
                {"route_blind": (2,)}, ("adapters",)),
}
AP_UNEVEN_REDUCED_LOADS = {"scan_whole": (4, 1, 64),
                           "ragged_model": (4, 2, 32),
                           "moe_odd": (4, 4, 24)}
# a reduced rehearsal's prompts are cut to this many tokens
AP_SERVE_REDUCED_S = 128
# the token the granite job's slots 1 and 2 repeat in their prompts
AP_MOE_REPEAT = 7
# device busy ms per profiled train step of each executor phase, by task
STEP_BUSY_MS = {}
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


def kernel_phase(torch, RL, ref, cases=None, timed=None, untimed=()):
    """The forward pair against its plain versions at the serving shapes
    and the executor's eval-step shape (T = 4,096 rows per slot); returns
    per-kernel results at the decode shape the serving path launches most
    (T = lanes, din = dout = d_model = 2560; the eval step's 2560 -> 6912
    under ``shapes["eval"]``) and prints every case. ``cases`` replaces
    the shapes, ``timed`` maps the (label, din, dout) whose times are
    kept to their key under ``shapes``, and the cases labelled in
    ``untimed`` are checked, not timed."""
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
        if label in untimed:
            print(f"xa, sb_add {label:8s} {T:4d} {din:5d} {dout:5d}  "
                  f"max_abs_err {errs['xa']:.3g}, {errs['sb_add']:.3g} "
                  f"(within the bars; not timed)")
            for name, err in errs.items():
                res = results.setdefault(name, {"max_abs_err": 0.0})
                res["max_abs_err"] = max(res["max_abs_err"], err)
            del xs, As, Bs, As_lib, Bs_lib
            continue
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
    (stablelm-3b at full size in ``main``, granite-moe-1b-a400m in
    ``moe_phases``) on the card."""
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
                          timed=("train", 2560, 2560), untimed=("dpo",),
                          dtype=None):
    """The four backward kernels, and the forward pair, against their
    plain versions at the training shapes (Z = 4 slots, T = TRAIN_B *
    TRAIN_S = 1024 token rows per slot, d in {2560, 6912}, true ranks
    4/8/16/32 of r_max 64, bf16 activations, fp32 masters with garbage
    past each rank) and at the DPO step's shapes (T = DPO_B * TRAIN_S =
    512 rows per slot in each policy forward; checked, not timed); returns
    per-kernel results (times of the backward four at the q/k/v/o shape,
    din = dout = 2560; the forward pair's there under ``shapes["train"]``)
    and prints every case. ``cases`` replaces the shapes: then the times of
    all six at ``timed`` (label, din, dout) go under ``shapes[label]``;
    cases labelled in ``untimed`` are checked, not timed. ``dtype`` (bf16
    by default) is the activations' and the gradients'."""
    dev = "cuda"
    dtype = dtype or torch.bfloat16
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
              .to(dtype) for _ in range(2)]
        dys = [torch.randn(Z, T, dout, generator=gen, device=dev)
               .to(dtype) for _ in range(2)]
        A = torch.randn(Z, din, r, generator=gen, device=dev) / din ** 0.5
        B = torch.randn(Z, r, dout, generator=gen, device=dev) / r ** 0.5
        scale = torch.full((Z,), 2.0, device=dev)
        keep = (torch.arange(r, device=dev)[None, :] < ranks[:, None])
        A_lib = (A * keep[:, None, :]).to(dtype).transpose(1, 2)
        B_lib = (B * keep[:, :, None]).to(dtype).transpose(1, 2)
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
        if label in untimed:
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
        # (activations e bytes an element, the masters fp32; fp32
        # activations take the FMA units' peak)
        sum_rr = sum(rk * nr for rk, nr in zip(live, nrows))
        rows_x = sum(nr for nr, rk in zip(nrows, live) if rk)
        e = x.element_size()
        peak = None if dtype == torch.bfloat16 else H100_FP32_FLOPS
        work = {
            "xa": (rows_x * din * e + sum(live) * din * 4 + Z * T * r * e,
                   2 * sum_rr * din),
            "sb_add": (sum_rr * e + sum(live) * dout * 4 + Z * T * dout * e,
                       2 * sum_rr * dout),
            "ds": (rows_x * dout * e + sum(live) * dout * 4 + Z * T * r * e,
                   2 * sum_rr * dout),
            "dx": (sum_rr * e + sum(live) * din * 4 + Z * T * din * e,
                   2 * sum_rr * din),
            "da": (rows_x * din * e + sum_rr * e + Z * din * r * 4,
                   2 * sum_rr * din),
            "db": (sum_rr * e + rows_x * dout * e + Z * r * dout * 4,
                   2 * sum_rr * dout),
        }
        for name, (kern, plain, lib) in timing.items():
            ms, _ = time_ms(torch, kern, 10)
            plain_ms, _ = time_ms(torch, plain, 10)
            lib_ms, _ = time_ms(torch, lib, 10)
            bound_ms, bound_by = bound(*work[name], peak)
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


def _one_ulp_fault(torch, AT, bad):
    """``autotune.six_kernel_step`` with one planted fault: under plan
    ``bad`` the first output (the rank-local S) has its first entry moved
    to the next representable value above it; every other plan's outputs
    are the real ones."""
    real = AT.six_kernel_step

    def step_of(plan):
        step = real(plan)
        if plan != bad:
            return step

        def faulted(*args):
            outs = list(step(*args))
            s = outs[0].clone()
            flat = s.view(-1)
            flat[:1] = torch.nextafter(flat[:1],
                                       torch.full_like(flat[:1], float("inf")))
            outs[0] = s
            return tuple(outs)

        return faulted

    return step_of


def autotune_phase(torch, fams):
    """The tile autotuner (``kernels/grouped_lora/autotune.py``) at
    stablelm-3b's projection shapes (2560 x 2560, 2560 x 6912, 6912 x
    2560), r_max 64, Z 4, at the train step's 1,024 rows a slot and at
    decode (T 4): the C plan set equals ``autotune.PLAN_SET``; a planted
    candidate one ulp off the default is discarded by the sweep's gate;
    each key's sweep through ``autotune_tile_plan`` (candidates tried and
    discarded, default and tuned ms of the 18 kernels, graph-replayed) with
    the winners persisted to a ``ProfileStore`` in a temporary directory,
    which a fresh store on the same path then serves with zero sweeps; and
    at each key the dense, ragged and rank-local Functions' forward and
    backward under the tuned plan equal the default plan's and each
    other's (full rank, every row live) bit for bit. Returns {key label:
    {default/tuned plan and ms, tried, discarded}}."""
    from repro_torch.kernels.grouped_lora import autotune as AT
    from repro_torch.kernels.grouped_lora import ops
    from repro_torch.kernels.grouped_lora import ranklocal as RL
    from repro_torch.sched.profiler import ProfileStore

    import ctypes

    lib = RL._load()
    out3 = (ctypes.c_int * 3)()
    c_set = []
    for i in range(lib.gl_plan_count()):
        require(lib.gl_plan_tiles(i, out3) == 0, f"gl_plan_tiles({i})")
        c_set.append(tuple(out3))
    py_set = [(p.bm, p.bn, p.br) for p in AT.PLAN_SET]
    require(c_set == py_set, f"compiled plan set {c_set} != PLAN_SET "
                             f"{py_set}")
    require(lib.gl_plan_tiles(len(c_set), out3) != 0,
            "an index past the plan set was accepted")
    print(f"autotune: compiled plan set (bm, bn, br) {c_set} == "
          f"autotune.PLAN_SET")

    Z, r_max = 4, 64
    shapes = ((2560, 2560), (2560, 6912), (6912, 2560))
    keys = [(din, dout, T) for T in (TRAIN_B * TRAIN_S, 4)
            for din, dout in shapes]

    # the gate: a candidate one ulp off the default is discarded
    bad = AT.PLAN_SET[0]
    real = AT.six_kernel_step
    AT.six_kernel_step = _one_ulp_fault(torch, AT, bad)
    try:
        res = AT.sweep(2560, 2560, r_max, Z, 4, iters=5, repeats=3)
    finally:
        AT.six_kernel_step = real
    require(bad in res.discarded and res.plan != bad,
            f"the planted one-ulp candidate {bad} was not discarded "
            f"({res.discarded}, winner {res.plan})")
    print(f"autotune: planted one-ulp candidate {bad} discarded by the "
          f"gate (winner {res.plan}, {len(res.candidates)} tried)")

    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "profile.json")
        store = ProfileStore()
        AT.clear_plan_cache()
        n0 = len(AT.SWEEPS)
        for din, dout, T in keys:
            plan = AT.autotune_tile_plan(din, dout, r_max, Z, T, store=store,
                                         iters=20, repeats=5)
            res = AT.SWEEPS[-1]
            require(res.plan == plan, f"sweep winner {res.plan} != {plan}")
            label = f"{din}x{dout} T{T}"
            tried = len(res.candidates)
            disc = res.discarded
            results[label] = {
                "key": list(res.key), "default": AT.DEFAULT_PLAN.to_json(),
                "tuned": plan.to_json(), "default_ms": res.default_s * 1e3,
                "tuned_ms": res.best_s * 1e3, "speedup": res.speedup,
                "tried": tried, "discarded": len(disc),
                "candidate_ms": {str((c.plan.bm, c.plan.bn, c.plan.br)):
                                 c.seconds * 1e3 for c in res.candidates}}
            print(f"autotune: key {res.key}: {tried} candidates tried, "
                  f"{len(disc)} discarded; default {res.default_s * 1e3:.5f}"
                  f" ms, tuned {(plan.bm, plan.bn, plan.br)} "
                  f"{res.best_s * 1e3:.5f} ms, speedup {res.speedup:.4f} "
                  f"(18 kernels, graph-replayed); candidates "
                  f"{results[label]['candidate_ms']}")
        require(len(AT.SWEEPS) - n0 == len(keys),
                f"{len(AT.SWEEPS) - n0} sweeps for {len(keys)} keys")
        store.save(path)
        fresh = ProfileStore.load(path)
        AT.clear_plan_cache()
        n1 = len(AT.SWEEPS)
        for (din, dout, T), got in zip(keys, results.values()):
            plan = AT.autotune_tile_plan(din, dout, r_max, Z, T, store=fresh)
            require(plan.to_json() == got["tuned"],
                    f"reloaded plan {plan} != the sweep's {got['tuned']}")
        require(len(AT.SWEEPS) == n1, f"{len(AT.SWEEPS) - n1} sweeps after "
                                      f"the reload")
        print(f"autotune: a fresh ProfileStore on {Path(path).name} served "
              f"{len(keys)} keys with {len(AT.SWEEPS) - n1} sweeps")

    # the tuned plans: forward and backward of the three Functions equal
    # the default plan's, and each other's at full rank and rows = T
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(25)
    for (din, dout, T), got in zip(keys, results.values()):
        plan = AT.TilePlan.from_json(got["tuned"])
        x = torch.randn(Z, T, din, generator=gen, device=dev).bfloat16()
        A = torch.randn(Z, din, r_max, generator=gen, device=dev) / din ** .5
        B = torch.randn(Z, r_max, dout, generator=gen, device=dev) / 8
        dy = torch.randn(Z, T, dout, generator=gen, device=dev).bfloat16()
        scale = torch.tensor([0.5, 1.0, 1.5, 2.0], device=dev)
        full = torch.full((Z,), r_max, dtype=torch.int32, device=dev)
        rows = torch.full((Z,), T, dtype=torch.int32, device=dev)

        def run(fn, p):
            xs, As, Bs = (t.clone().requires_grad_(True) for t in (x, A, B))
            y = fn(xs, As, Bs, p)
            y.backward(dy)
            return [y.detach(), xs.grad, As.grad, Bs.grad]

        fns = {"dense": lambda a, b, c, p: ops.grouped_lora(
                   a, b, c, scale, plan=p),
               "ragged": lambda a, b, c, p: ops.ragged_grouped_lora(
                   a, b, c, scale, rows, plan=p),
               "rank-local": lambda a, b, c, p: ops.ranklocal_grouped_lora(
                   a, b, c, scale, full, rows, plan=p)}
        # the tuned plan first, then every other candidate of the key
        plans = [plan] + [p for p in AT.candidate_plans(T, din, dout, r_max,
                                                        Z=Z)
                          if p not in (plan, AT.DEFAULT_PLAN)]
        for p in plans:
            outs = {}
            for fam, fn in fns.items():
                got, default = run(fn, p), run(fn, None)
                require(all(torch.equal(a, b)
                            for a, b in zip(got, default)),
                        f"autotune {din}x{dout} T{T}: {fam} under {p} "
                        f"differs from the default plan")
                outs[fam] = got
            require(all(torch.equal(a, b) and torch.equal(a, c)
                        for a, b, c in zip(outs["dense"], outs["ragged"],
                                           outs["rank-local"])),
                    f"autotune {din}x{dout} T{T}: dense, ragged and "
                    f"rank-local differ under {p}")
        print(f"autotune {din}x{dout} T{T}: y, dx, dA, dB of the dense, "
              f"ragged and rank-local Functions under the tuned plan "
              f"{(plan.bm, plan.bn, plan.br)} and the {len(plans) - 1} "
              f"other candidates == the default plan's, and dense == "
              f"ragged == rank-local, bit for bit")
    torch.cuda.empty_cache()
    return results


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
    the plain version beside it (with a window shorter than the keys, a
    third: the window one key wider); the batch-independence check;
    times of the kernel, the plain version (cases labelled in
    ``plain_labels``) and the SDPA
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
                  if 0 < window < Sk else None)
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
                loss_bar=TRAIN_LOSS_REL, image=False):
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
    any bar (rwkv6-3b at full depth, see RWKV_GRAD_LAYERS).

    MoE (granite-moe, llama4-scout): the kernel step runs again and must
    give the first one's per-slot losses and every dA and dB bit for bit;
    one forward of each run (no gradients) reads every layer's routing
    through ``moe.route``, and the count of (token, choice) pairs routed to
    another expert or kept / dropped otherwise in the plain run, and each
    layer's dropped share, are printed; one more forward fault in the
    plain run, the selected gates left unnormalized, must break the loss
    bar.

    ``image`` (qwen2-vl): every sequence starts with the stub vision
    tower's patch embeddings and (t, h, w) positions (``image_inputs``),
    labels -1 over the prefix; three more planted faults in the plain run,
    each of which must break the loss bar: the text positions (t, t, t) in
    place of the image's, the token embeddings in place of the patch
    embeddings, and the h and w sections swapped (``image_faults``).

    Returns the kernel run's launches (the path's set and both sequence
    kernels)."""
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
    from repro_torch.models import moe as MOE
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
    if image:                  # no loss over the patch prefix
        raw["labels"][:, :, :cfg.num_modality_tokens] = -1
    kbatch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    if image:
        kbatch.update(image_inputs(torch, cfg, Z, b, S))
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
    kernel_launches = {**fams[path].LAUNCHES, **FA.LAUNCHES, **LSK.LAUNCHES}
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
    if cfg.is_moe:
        moe_routing_checks(torch, cfg, params, lora, kbatch, pbatch,
                           k_gloss, gk, grads)
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

    @contextlib.contextmanager
    def gates_unnormalized():
        """The plain routing with the selected gates left as the router's
        probabilities (not renormalized over the top k)."""
        plain = MOE.route

        def raw_gates(xt, router, moe, cap):
            gates, idx, pos, keep, aux = plain(xt, router, moe, cap)
            probs = torch.softmax(xt.float() @ router, dim=-1)
            return torch.gather(probs, -1, idx) * keep, idx, pos, keep, aux
        MOE.route = raw_gates
        try:
            yield
        finally:
            MOE.route = plain

    faults = {
        "moe": [(attention_peeks_ahead, "every query sees one future key "
                 "in the plain attention"),
                (gates_unnormalized, "the plain routing's selected gates "
                 "left unnormalized")],
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
    for what, batch in (image_faults(pbatch) if image else ()):
        a_loss, g_img, a_nll = plain_run(batch=batch)
        c = gap(a_loss, adamw.per_slot_global_norm(g_img), g_img, a_nll)
        print(f"train check ({tag}): control, {what}: {show(c)}")
        require(max(c["loss"]) > loss_bar,
                f"control '{what}' passes the loss bar")
        del g_img
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
    return kernel_launches


def moe_routing_checks(torch, cfg, params, lora, kbatch, pbatch, k_gloss,
                       gk, grads):
    """An MoE train check's own parts: the kernel step's gradients again,
    which must equal the first run's (``k_gloss``, ``gk``) bit for bit;
    then one forward with the kernels and one on the plain versions, no
    gradients, each layer's routing read through ``moe.route``: the
    (token, choice) pairs the two runs route differently (another expert,
    or kept in one and dropped in the other) and each layer's dropped
    share are printed."""
    from repro_torch.core import lora as LORA
    from repro_torch.models import backend as BK
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    r_gloss, gr = grads("kernel")
    torch.cuda.synchronize()
    same = [torch.equal(gr[t][m], gk[t][m]) for t in gk for m in gk[t]]
    print(f"train check ({cfg.name}): the kernel step again: per-slot loss "
          f"bitwise equal {torch.equal(r_gloss, k_gloss)}, dA/dB bitwise "
          f"equal on {sum(same)} of {len(same)} leaves")
    require(torch.equal(r_gloss, k_gloss) and all(same),
            f"{cfg.name}: two identical kernel train steps differ")
    del gr

    plain = MOE.route

    def routing(backend, batch):
        seen = []

        def tapped(*args):
            out = plain(*args)
            seen.append((out[1], out[3]))
            return out
        MOE.route = tapped
        try:
            with (torch.no_grad(), LORA.backend(backend),
                  BK.backend(backend),
                  LORA.slot_ranks(batch.get("slot_ranks"))):
                M.forward(cfg, params, lora, batch["tokens"])
        finally:
            MOE.route = plain
        return seen

    k_route = routing("kernel", kbatch)
    p_route = routing("torch", pbatch)
    require(len(k_route) == len(p_route) == cfg.num_layers,
            f"{len(k_route)} / {len(p_route)} routed layers")
    other = sum(int((ki != pi).sum()) for (ki, _), (pi, _)
                in zip(k_route, p_route))
    kept = sum(int(((kk != pk) & (ki == pi)).sum()) for (ki, kk), (pi, pk)
               in zip(k_route, p_route))
    n = k_route[0][0].numel() * cfg.num_layers
    drop = [1.0 - float(kk.float().mean()) for _, kk in k_route]
    G, s, k = k_route[0][0].shape
    print(f"train check ({cfg.name}): routing, kernels vs plain versions: "
          f"{other} of {n} (token, choice) pairs routed to another expert, "
          f"{kept} more kept in one run and dropped in the other "
          f"({cfg.num_layers} layers, {G} group(s) of {s} tokens, top-"
          f"{k} of {cfg.moe.num_experts}, capacity "
          f"{MOE.capacity(cfg.moe, s)})")
    print(f"train check ({cfg.name}): dropped share of the choices by "
          f"layer (0 first): {[float(f'{x:.4g}') for x in drop]}; mean "
          f"{statistics.mean(drop):.4g}")


# the projections whose inputs are the first layer's normed embedding (for
# RWKV: its token-shift lerps), which hang off no differentiable leaf
FIRST_LAYER_NO_DX = {"dense": {"q_proj", "k_proj", "v_proj"},
                     "vlm": {"q_proj", "k_proj", "v_proj"},
                     "audio": {"q_proj", "k_proj", "v_proj"},
                     "moe": {"q_proj", "k_proj", "v_proj"},
                     "ssm": {"r_proj", "k_proj", "v_proj", "g_proj"},
                     "hybrid": {"q_proj", "k_proj", "v_proj", "in_proj"}}
# the sequence kernels of each family: one launch each per layer of a
# forward
SEQ_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention",),
               "vlm": ("flash_attention",), "audio": ("flash_attention",),
               "ssm": ("linear_scan",),
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
    ``cfg`` at full size (stablelm-3b, rwkv6-3b, hymba-1.5b or
    granite-moe-1b-a400m; b sequences
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
    STEP_BUSY_MS[task] = busy / 2e3 if busy else None
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
    width and RECOVERY_LAYERS layers, RECOVERY_STEPS steps per job (three
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

    cfg = dataclasses.replace(cfg, num_layers=RECOVERY_LAYERS)
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
    cfg = dataclasses.replace(get_arch("stablelm-3b"), num_layers=SWEEP_LAYERS)
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
    cfg = dataclasses.replace(get_arch("stablelm-3b"), num_layers=SWEEP_LAYERS)
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
    """Kill and recover through the service at full width and RECOVERY_LAYERS
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
    cfg = dataclasses.replace(get_arch("stablelm-3b"),
                              num_layers=RECOVERY_LAYERS)
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
                             for lab in ("train", "eval") if lab in results)
    if "eval" in results:
        res["eval_ms"] = results["eval"]["ms"]
    return res, results


def _leaves(tree):
    """The tensors of a nested dict."""
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _gbytes(tree) -> float:
    return sum(x.numel() * x.element_size() for x in _leaves(tree)) / 1e9


def _lanes_first(cache):
    """Every per-lane tensor of a per-lane cache with the (Z, b) lane axes
    first: the layer leaves [L, Z, b, ...] moved to [Z, b, L, ...], and the
    positions (``pos``, a ring's ``k_pos``)."""
    out = [v.movedim(0, 2) for v in _leaves(cache["layers"])]
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


def _cut_layers(params, layers, dtype=None):
    """``params`` with the first ``layers`` of every stacked leaf (nested
    ones too), each leaf cast to ``dtype`` (None: each keeps its own, as
    rwkv6-3b's fp32 leaves beside its bf16 ones need)."""
    def conv(x, stacked):
        x = x[:layers] if stacked else x
        return x if dtype is None else x.to(dtype)

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
    _merged(lora, fwd)
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
    # depth cut (HYMBA_CHECK_LAYERS) to keep the script within its time
    ccfg = dataclasses.replace(hcfg, dtype="float32",
                               num_layers=HYMBA_CHECK_LAYERS)
    cparams = _cut_layers(hparams, HYMBA_CHECK_LAYERS, torch.float32)
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
    # depth cut (HYMBA_SWEEP_LAYERS) to keep the script within its time
    scfg = dataclasses.replace(hcfg, num_layers=HYMBA_SWEEP_LAYERS)
    sparams = _cut_layers(hparams, HYMBA_SWEEP_LAYERS)
    launches = executor_phase(torch, RL, (fams["dense"], fams["ragged"]),
                              scfg, sparams, "hymba-rank-sweep", jobs,
                              b=HYMBA_B, S=S, eval_b=HYMBA_EVAL_B)
    del sparams
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
    for layers, hold in ((RWKV_CHECK_LAYERS, False),
                         (RWKV_GRAD_LAYERS, True)):
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
    # depth cut (RWKV_SWEEP_LAYERS) to keep the script within its time
    scfg = dataclasses.replace(rcfg, num_layers=RWKV_SWEEP_LAYERS)
    sparams = _cut_layers(rparams, RWKV_SWEEP_LAYERS)
    launches = executor_phase(torch, RL, (fams["dense"], fams["ragged"]),
                              scfg, sparams, "rwkv-rank-sweep", jobs)
    print(f"rwkv rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    return scan, serve, launches


def moe_layer_phase(torch, cfg, params, b=TRAIN_B, S=TRAIN_S):
    """Layer 0's MoE block of ``cfg`` at a train step's tokens (Z = 4
    slots of b sequences of S; granite-moe: 4,096 tokens, one group,
    capacity 1,280), in bf16 (the router in fp32) with activations from a
    seed: the device time of each
    part of ``moe_block``'s forward (graph replay): the router (logits,
    softmax, top-k, gates, aux and queue positions), the dispatch into the
    expert buffer, the expert GEMMs, the combine, the shared expert if
    any, and the whole block; then, with CUDA events around eager calls,
    the whole block's forward and backward (dL/dx, as a LoRA step asks)
    and the expert GEMMs' alone. Returns (ms of the router, dispatch and
    combine in one train step of all the layers: each layer's forward runs
    twice, the forward and its remat, and the backward once; the parts'
    times)."""
    from repro_torch.models import moe as MOE

    dev, bf16 = "cuda", torch.bfloat16
    moe, d, E = cfg.moe, cfg.d_model, cfg.moe.num_experts
    def first(w, name):     # layer 0; the router stays fp32
        return w[0] if name == "router" else w[0].to(bf16)

    p = {k: ({n: first(w, n) for n, w in v.items()} if isinstance(v, dict)
             else first(v, k)) for k, v in params["layers"]["moe"].items()}
    gen = torch.Generator(device=dev).manual_seed(13)
    x = torch.randn(4, b, S, d, generator=gen, device=dev).to(bf16)
    T = x.numel() // d
    s = MOE.pick_group_size(T)
    G, cap = T // s, MOE.capacity(moe, s)
    xt = x.reshape(G, s, d)
    gates, idx, pos, keep, aux = MOE.route(xt, p["router"], moe, cap)
    slot = MOE.slots(idx, pos, keep, E, cap)
    e_in = MOE.dispatch(xt, slot, E, cap)
    e_out = MOE.experts(e_in, p)
    parts = {
        "router": lambda i: MOE.route(xt, p["router"], moe, cap),
        "dispatch": lambda i: MOE.dispatch(
            xt, MOE.slots(idx, pos, keep, E, cap), E, cap),
        "experts": lambda i: MOE.experts(e_in, p),
        "combine": lambda i: MOE.combine(e_out, slot, gates, bf16),
        "block": lambda i: MOE.moe_block(x, p, moe),
    }
    if "shared" in p:
        parts["shared"] = lambda i: MOE.shared_expert(xt, p["shared"])
    ms = {}
    with torch.no_grad():
        for name, fn in parts.items():
            ms[name], _ = time_ms(torch, fn, 10)

    def events_ms(fn, n=10):
        for _ in range(2):
            fn()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        return a.elapsed_time(e) / n

    xg = x.detach().requires_grad_(True)
    g_out = torch.randn(x.shape, generator=gen, device=dev).to(bf16)
    one = torch.ones((), device=dev)

    def block_fb():
        out, a_ = MOE.moe_block(xg, p, moe)
        torch.autograd.grad((out, a_), xg, (g_out, one))

    e_in_g = e_in.detach().requires_grad_(True)
    g_e = torch.randn(e_out.shape, generator=gen, device=dev).to(bf16)

    def experts_fb():
        torch.autograd.grad(MOE.experts(e_in_g, p), e_in_g, g_e)

    ms["block_fwd_bwd"] = events_ms(block_fb)
    ms["experts_fwd_bwd"] = events_ms(experts_fb)
    rdc = ms["router"] + ms["dispatch"] + ms["combine"]
    shared = ms.get("shared", 0.0)
    per_step = cfg.num_layers * (rdc + ms["block_fwd_bwd"]
                                 - ms["experts_fwd_bwd"] - 2 * shared)
    kept = float(keep.float().mean())
    print(f"moe layer ({cfg.name}): T {T} tokens, {G} group(s) of {s}, "
          f"top-{moe.top_k} of {E}, capacity {cap}, kept {kept:.4f} of the "
          f"choices; forward ms (graph replay): " + ", ".join(
              f"{k} {v:.4f}" for k, v in ms.items()
              if not k.endswith("fwd_bwd"))
          + f"; router + dispatch + combine {rdc:.4f} = "
          f"{rdc / ms['block']:.3f} of the block's forward")
    print(f"moe layer ({cfg.name}): forward + backward (events, eager): "
          f"block {ms['block_fwd_bwd']:.4f} ms, expert GEMMs alone "
          f"{ms['experts_fwd_bwd']:.4f} ms; router, dispatch and combine in "
          f"one train step of {cfg.num_layers} layers (forward, remat and "
          f"backward) ~{per_step:.3f} ms")
    del xg, e_in_g, e_in, e_out
    torch.cuda.empty_cache()
    return per_step, ms


def moe_phases(torch, fams, t_all):
    """Phases 24-29, the MoE family: the rank-local kernels and flash
    attention at granite-moe-1b-a400m's shapes (and flash at
    llama4-scout's head dim 128), one MoE layer's parts timed, a serve of
    granite-moe, its fp32 train check at full depth, its rank sweep (the
    main path), then llama4-scout at full width and LLAMA4_LAYERS layers:
    its fp32 train check. Returns (the rank-local kernels' results,
    flash's by case, the serve's launches, the sweep's launches, the
    llama4 kernel step's launches)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.models import model as M

    RL = fams["rank-local"]
    gcfg = get_arch("granite-moe-1b-a400m")
    lcfg = get_arch("llama4-scout-17b-a16e")
    T = TRAIN_B * TRAIN_S
    bf16, fp32 = torch.bfloat16, torch.float32
    lora = backward_kernel_phase(
        torch, RL, ref, timed=("granite", 1024, 1024),
        cases=[("granite", T, din, dout, TRAIN_RANKS, None)
               for din, dout in GRANITE_SHAPES])
    fwd = kernel_phase(
        torch, RL, ref,
        cases=[("decode", LANES, din, dout, RANKS, None)
               for din, dout in GRANITE_SHAPES]
        + [("eval", EVAL_B * TRAIN_S, din, dout, TRAIN_RANKS, None)
           for din, dout in GRANITE_SHAPES],
        timed={("decode", 1024, 1024): "granite_decode",
               ("eval", 1024, 1024): "granite_eval"})
    _merged(lora, fwd)
    H, hd = gcfg.num_heads, gcfg.resolved_head_dim
    _, flash = flash_kernel_phase(
        torch, FA, fref, gcfg, plain_labels=("train",),
        cases=[("train", 4 * TRAIN_B * H, TRAIN_S, TRAIN_S, hd, 0, bf16),
               ("eval", 4 * EVAL_B * H, TRAIN_S, TRAIN_S, hd, 0, bf16)])
    lH, lhd = lcfg.num_heads, lcfg.resolved_head_dim
    _, l_flash = flash_kernel_phase(
        torch, FA, fref, lcfg, plain_labels=("train",),
        cases=[("train", 4 * TRAIN_B * lH, TRAIN_S, TRAIN_S, lhd, 0, fp32),
               ("bf16", 4 * TRAIN_B * lH, TRAIN_S, TRAIN_S, lhd, 0, bf16)])
    flash.update({f"llama4_{k}": v for k, v in l_flash.items()})
    print(f"moe kernel phases done at {time.perf_counter() - t_all:.1f} s")

    t = time.perf_counter()
    gparams = M.init_params(gcfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {gcfg.name} backbone in {time.perf_counter() - t:.1f} s "
          f"({_gbytes(gparams):.2f} GB)")
    rdc_step_ms, _ = moe_layer_phase(torch, gcfg, gparams)
    serve = serve_phase(torch, RL, gcfg, gparams)
    torch.cuda.empty_cache()
    print(f"moe serve phase done at {time.perf_counter() - t_all:.1f} s")
    ccfg = dataclasses.replace(gcfg, dtype="float32")
    cparams = _cut_layers(gparams, gcfg.num_layers, fp32)
    train_check(torch, fams, ccfg, cparams, TRAIN_RANKS, "rank-local",
                loss_bar=MOE_LOSS_REL)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"moe train check done at {time.perf_counter() - t_all:.1f} s")
    jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                          per_adapter_batch=TRAIN_B)
            for r in TRAIN_RANKS for lr in (1e-4, 1e-3)}
    launches = executor_phase(torch, RL, (fams["dense"], fams["ragged"]),
                              gcfg, gparams, "moe-rank-sweep", jobs)
    busy = STEP_BUSY_MS.get("moe-rank-sweep")
    print(f"moe: router, dispatch and combine ~{rdc_step_ms:.3f} ms of a "
          f"train step's device busy {busy:.3f} ms = "
          f"{rdc_step_ms / busy:.3f} (moe layer phase over the sweep's "
          f"profile)" if busy else "moe: step busy not measured")
    print(f"moe rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    del gparams
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    l2 = dataclasses.replace(lcfg, num_layers=LLAMA4_LAYERS,
                             dtype="float32")
    lparams = M.init_params(l2, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {lcfg.name} at full width, {LLAMA4_LAYERS} of "
          f"{lcfg.num_layers} layers, fp32, in "
          f"{time.perf_counter() - t:.1f} s ({_gbytes(lparams):.2f} GB)")
    moe_layer_phase(torch, l2, lparams)
    l_launches = train_check(torch, fams, l2, lparams, TRAIN_RANKS,
                             "rank-local", loss_bar=MOE_LOSS_REL)
    del lparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"llama4 train check done at {time.perf_counter() - t_all:.1f} s")
    return lora, flash, serve, launches, l_launches



def image_inputs(torch, cfg, Z, b, S, seed=4):
    """The stub vision tower's output for a [Z, b, S] batch: the
    ``num_modality_tokens`` patch embeddings of a QWEN_GRID image a sequence
    ([Z, b, P, d] in the config's dtype, N(0, 0.02) from a seeded
    generator, as tests/test_arch_smoke.py makes them) and the (t, h, w)
    positions of the patches and the text after them ([3, Z, b, S])."""
    from repro_torch.launch.train import image_positions
    from repro_torch.models.common import dtype_of

    P = cfg.num_modality_tokens
    require(P == QWEN_GRID[0] * QWEN_GRID[1],
            f"{cfg.name}: {P} modality tokens, a {QWEN_GRID} grid")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    emb = 0.02 * torch.randn(Z, b, P, cfg.d_model, generator=gen,
                             device="cuda")
    pos = image_positions(QWEN_GRID, S, "cuda")
    return {"modal_embeds": emb.to(dtype_of(cfg.dtype)),
            "positions": pos[:, None, None].expand(3, Z, b, S).contiguous()}


def image_faults(batch):
    """Copies of an image-prefixed ``batch`` with a fault planted: the text
    positions (t, t, t) (the forward's default) in place of the image's;
    the token embeddings in place of the patch embeddings; the h and w
    sections' positions swapped."""
    text = {k: v for k, v in batch.items() if k != "positions"}
    tokens = {k: v for k, v in batch.items() if k != "modal_embeds"}
    return [("the text positions (t, t, t) in place of the image's", text),
            ("the token embeddings in place of the patch embeddings",
             tokens),
            ("the h and w sections' positions swapped",
             dict(batch, positions=batch["positions"][[0, 2, 1]]))]


def image_prompt_check(torch, RL, cfg, params):
    """An image-prefixed prompt through the serving steps on qwen2-vl: 4
    slots (adapters at ranks RANKS, non-zero B), one sequence each of the
    stub's 256 patch embeddings and IMAGE_TEXT text tokens with their
    (t, h, w) positions, prefilled with ``make_prefill_step`` into a global
    cache, then IMAGE_DECODES greedy ``make_serve_step`` steps (decode
    continues at (p, p, p), p the sequence index, as the JAX package
    does). The kernel run's logits at every step are held against a run on
    the plain versions (model and LoRA backend "torch") fed the kernel
    run's tokens, per slot within LOGITS_ATOL_REL / LOGITS_REL_RMS; the
    same plain run without the patch embeddings must fail those bars in
    every slot. Returns the kernel run's launches."""
    from repro_torch.core import lora as LORA
    from repro_torch.core import steps as STEPS
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import backend as BK
    from repro_torch.models import model as M

    dev, Z = "cuda", len(RANKS)
    P = cfg.num_modality_tokens
    S = P + IMAGE_TEXT
    gen = torch.Generator(device=dev).manual_seed(9)
    ranks = torch.tensor(RANKS, dtype=torch.int32, device=dev)
    lora = LORA.init_lora_tree(gen, cfg, Z, ranks, M.target_shapes(cfg))
    for ab in lora.values():
        ab["B"].normal_(0.0, 0.003, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (Z, 1, S), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, **image_inputs(torch, cfg, Z, 1, S)}

    def run(backend, batch, feed=None):
        """(logits of the prefill and every decode step [n+1, Z, 1, V]
        fp32, the tokens fed)."""
        cache = M.init_cache(cfg, Z, 1, S + IMAGE_DECODES, device=dev)
        serve = STEPS.make_serve_step(cfg)
        out, fed = [], []
        with (torch.inference_mode(), LORA.backend(backend),
              BK.backend(backend), LORA.slot_ranks(ranks)):
            logits, cache = STEPS.make_prefill_step(cfg)(params, lora, cache,
                                                         batch)
            for i in range(IMAGE_DECODES):
                out.append(logits.float())
                cur = (logits.argmax(-1).to(torch.int32) if feed is None
                       else feed[i])
                fed.append(cur)
                logits, cache = serve(params, lora, cache, cur)
            out.append(logits.float())
        require(int(cache["pos"]) == S + IMAGE_DECODES,
                f"image prompt: cache position {int(cache['pos'])}")
        return torch.stack(out), fed

    RL.reset_launches()
    FA.reset_launches()
    t = time.perf_counter()
    k_logits, fed = run("kernel", batch)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t
    launches = {**RL.LAUNCHES, **FA.LAUNCHES}
    want = len(cfg.lora.targets) * cfg.num_layers * (1 + IMAGE_DECODES)
    require(launches["xa"] == launches["sb_add"] == want
            and launches["flash_attention"] == 0,
            f"image prompt: launches {launches}, expected {want} of xa and "
            f"sb_add and no flash (a prefill into a longer cache)")
    p_logits, _ = run("torch", batch, fed)
    no_img, _ = run("torch", {k: v for k, v in batch.items()
                              if k != "modal_embeds"}, fed)

    def gap(a, b):
        """Per slot over every step: max|a-b| / max|b| and the relative
        RMS."""
        d, b = (a - b).transpose(0, 1).flatten(1), b.transpose(0, 1).flatten(1)
        return ((d.abs().amax(1) / b.abs().amax(1)).tolist(),
                (d.norm(dim=1) / b.norm(dim=1)).tolist())

    sound, control = gap(k_logits, p_logits), gap(no_img, p_logits)
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
    show = lambda g: (f"max|diff|/max|logit| {[round(v, 5) for v in g[0]]}, "
                      f"relative RMS {[round(v, 5) for v in g[1]]}")
    print(f"image prompt ({cfg.name}, {cfg.num_layers} layers, {cfg.dtype}): "
          f"{Z} slots x ({P} patches of a {QWEN_GRID} grid + {IMAGE_TEXT} "
          f"text tokens) prefilled, {IMAGE_DECODES} greedy decode steps at "
          f"positions ({S}, {S}, {S}) on, in {t_k:.2f} s with the kernels; "
          f"launches {launches} = {want // (1 + IMAGE_DECODES)} a forward")
    print(f"image prompt: kernels vs plain versions per slot over the "
          f"prefill and decode logits: {show(sound)} (bars "
          f"{LOGITS_ATOL_REL}, {LOGITS_REL_RMS}); greedy agreement "
          f"{agree:.3f}; the plain run without the patch embeddings: "
          f"{show(control)}")
    require(bool(torch.isfinite(k_logits).all())
            and tuple(k_logits.shape) == (IMAGE_DECODES + 1, Z, 1,
                                          cfg.vocab_size),
            f"image prompt: logits {tuple(k_logits.shape)} not finite or "
            f"misshapen")
    require(max(sound[0]) <= LOGITS_ATOL_REL
            and max(sound[1]) <= LOGITS_REL_RMS,
            "image prompt: kernel logits too far from the plain versions'")
    require(min(control[0]) > LOGITS_ATOL_REL
            and min(control[1]) > LOGITS_REL_RMS,
            "image prompt: the run without the patch embeddings passes the "
            "logits bars")
    del lora, k_logits, p_logits, no_img
    torch.cuda.empty_cache()
    return launches


def _merged(into, more):
    """Kernel results by name with ``more``'s shapes beside ``into``'s and
    the larger error."""
    for name, res in more.items():
        had = into.setdefault(name, {"max_abs_err": 0.0})
        had.setdefault("shapes", {}).update(res.get("shapes", {}))
        had["max_abs_err"] = max(had["max_abs_err"], res["max_abs_err"])
    return into


def family_phases(torch, fams, t_all):
    """Phases 30-33, the last model families at full width: the rank-local
    kernels at their new edges and flash at head dim 128 in bf16;
    qwen2-vl-72b (the vlm family: M-RoPE and the stub vision tower's patch
    prefix) at QWEN_LAYERS layers, with an image-prefixed fp32 train check
    at QWEN_TRAIN_LAYERS, a rank sweep (its main path), a serve and an
    image-prefixed prompt; musicgen-medium (the audio family) at full width
    and AUDIO_LAYERS: its rank sweep (its main path), a serve and an fp32
    train check; then
    fp32 train checks of glm4-9b, granite-8b and mistral-nemo-12b at
    DENSE_LAYERS layers (mistral's also on the dense path). Returns (the
    rank-local kernels' results, flash's by case, launches by path: of the
    rank-local set, of the dense set, of flash)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.models import model as M

    RL = fams["rank-local"]
    qcfg = get_arch("qwen2-vl-72b")
    mcfg = get_arch("musicgen-medium")
    gcfg = get_arch("glm4-9b")
    T = TRAIN_B * TRAIN_S
    bf16 = torch.bfloat16
    t = time.perf_counter()
    lora = {}
    for model, shapes in FAMILY_SHAPES.items():
        _merged(lora, backward_kernel_phase(
            torch, RL, ref, timed=(model, *shapes[0]),
            cases=[(model, T, din, dout, TRAIN_RANKS, None)
                   for din, dout in shapes]))
        _merged(lora, kernel_phase(
            torch, RL, ref,
            cases=[("decode", LANES, din, dout, RANKS, None)
                   for din, dout in shapes],
            timed={("decode", *shapes[0]): f"{model}_decode"}))
    for din, dout in ((4096, 5120), (4096, 256)):
        full_rank_twins(torch, fams, T, din, dout)
    invariance_phase(torch, fams["dense"], fams["ragged"], RL,
                     shapes=FAMILY_SHAPES["mistral"])
    H, hd = qcfg.num_heads, qcfg.resolved_head_dim
    _, flash = flash_kernel_phase(
        torch, FA, fref, qcfg, plain_labels=("train",),
        cases=[("train", 4 * QWEN_B * H, QWEN_S, QWEN_S, hd, 0, bf16),
               ("eval", 4 * EVAL_B * H, TRAIN_S, TRAIN_S, hd, 0, bf16)])
    flash = {f"qwen2-vl_{k}": v for k, v in flash.items()}
    _, g_flash = flash_kernel_phase(
        torch, FA, fref, gcfg, plain_labels=("train",),
        cases=[("train", 4 * TRAIN_B * gcfg.num_heads, TRAIN_S, TRAIN_S,
                gcfg.resolved_head_dim, 0, bf16)])
    _, m_flash = flash_kernel_phase(
        torch, FA, fref, mcfg, plain_labels=("train",),
        cases=[("train", 4 * TRAIN_B * mcfg.num_heads, TRAIN_S, TRAIN_S,
                mcfg.resolved_head_dim, 0, bf16),
               ("eval", 4 * EVAL_B * mcfg.num_heads, TRAIN_S, TRAIN_S,
                mcfg.resolved_head_dim, 0, bf16)])
    flash.update({f"glm4_{k}": v for k, v in g_flash.items()})
    flash.update({f"musicgen_{k}": v for k, v in m_flash.items()})
    print(f"family kernel phases done at {time.perf_counter() - t_all:.1f} s "
          f"({time.perf_counter() - t:.1f} s)")

    rank_jobs = {f"r{r}-lr{lr:g}": TrainConfig(learning_rate=lr, lora_rank=r,
                                               per_adapter_batch=TRAIN_B)
                 for r in TRAIN_RANKS for lr in (1e-4, 1e-3)}
    paths = {}
    t = time.perf_counter()
    q4 = dataclasses.replace(qcfg, num_layers=QWEN_LAYERS)
    qparams = M.init_params(q4, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {qcfg.name} at full width, {QWEN_LAYERS} of "
          f"{qcfg.num_layers} layers, bf16, in {time.perf_counter() - t:.1f} "
          f"s ({_gbytes(qparams):.2f} GB)")
    q2 = dataclasses.replace(qcfg, num_layers=QWEN_TRAIN_LAYERS,
                             dtype="float32")
    cparams = _cut_layers(qparams, QWEN_TRAIN_LAYERS, torch.float32)
    paths["vlm_train"] = train_check(
        torch, fams, q2, cparams, TRAIN_RANKS, "rank-local", S=QWEN_S,
        b=QWEN_B, loss_bar=FAMILY_LOSS_REL, image=True)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"vlm train check done at {time.perf_counter() - t_all:.1f} s")
    paths["vlm_sweep"] = executor_phase(
        torch, RL, (fams["dense"], fams["ragged"]), q4, qparams,
        "vlm-rank-sweep", rank_jobs)
    print(f"vlm rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    paths["vlm_serve"] = serve_phase(torch, RL, q4, qparams)
    paths["vlm_prompt"] = image_prompt_check(torch, RL, q4, qparams)
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"vlm serve phases done at {time.perf_counter() - t_all:.1f} s")

    t = time.perf_counter()
    mcut = dataclasses.replace(mcfg, num_layers=AUDIO_LAYERS)
    mparams = M.init_params(mcut, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"init: {mcfg.name} at full width, {AUDIO_LAYERS} of "
          f"{mcfg.num_layers} layers, in {time.perf_counter() - t:.1f} s "
          f"({_gbytes(mparams):.2f} GB)")
    paths["audio_sweep"] = executor_phase(
        torch, RL, (fams["dense"], fams["ragged"]), mcut, mparams,
        "audio-rank-sweep", rank_jobs)
    print(f"audio rank-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    paths["audio_serve"] = serve_phase(torch, RL, mcut, mparams)
    m32 = dataclasses.replace(mcut, dtype="float32")
    cparams = _cut_layers(mparams, AUDIO_LAYERS, torch.float32)
    del mparams
    paths["audio_train"] = train_check(torch, fams, m32, cparams,
                                       TRAIN_RANKS, "rank-local",
                                       loss_bar=FAMILY_LOSS_REL)
    del cparams
    gc.collect()
    torch.cuda.empty_cache()
    print(f"audio phases done at {time.perf_counter() - t_all:.1f} s")

    dense_cfg = {}
    for arch in ("glm4-9b", "granite-8b", "mistral-nemo-12b"):
        t = time.perf_counter()
        c = dataclasses.replace(get_arch(arch), num_layers=DENSE_LAYERS,
                                dtype="float32")
        params = M.init_params(c, seed=0, device="cuda")
        torch.cuda.synchronize()
        print(f"init: {arch} at full width, {DENSE_LAYERS} layers, fp32, in "
              f"{time.perf_counter() - t:.1f} s ({_gbytes(params):.2f} GB)")
        checks = [(TRAIN_RANKS, "rank-local")]
        if arch == "mistral-nemo-12b":
            checks.append((FULL_RANKS, "dense"))
        for ranks_t, path in checks:
            got = train_check(torch, fams, c, params, ranks_t, path,
                              loss_bar=FAMILY_LOSS_REL)
            mine = dense_cfg.setdefault(path, {})
            for k, v in got.items():
                mine[k] = mine.get(k, 0) + v
        del params
        gc.collect()
        torch.cuda.empty_cache()
    paths["dense_cfg_train"] = dense_cfg
    print(f"dense config train checks done at "
          f"{time.perf_counter() - t_all:.1f} s")
    return lora, flash, paths


def _counts(fams, FA):
    """The LoRA launches of each set and the flash launches since the last
    reset, then reset."""
    got = {fam: dict(mod.LAUNCHES) for fam, mod in fams.items()}
    got["flash"] = FA.LAUNCHES["flash_attention"]
    for mod in (*fams.values(), FA):
        mod.reset_launches()
    return got


def launch_mfu(cfg, Z: int, b: int, S: int, rank: int, step_s):
    """(MFU, model FLOPs, median step s) of the launcher's step: the
    roofline's ``model_flops`` (frozen base 4ND plus the adapters' 6ND at
    ``rank``) of Z slots of b sequences of S tokens, over the median of
    ``step_s`` at the card's dense bf16 peak."""
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.roofline.analysis import model_flops
    shape = dataclasses.replace(TRAIN_4K, seq_len=S, global_batch=Z * b,
                                num_slots=Z, per_adapter_batch=b)
    flops = model_flops(cfg, shape, lora_rank=rank)
    med = statistics.median(step_s)
    return flops / (med * H100_BF16_FLOPS), flops, med


def launch_phase(torch, fams):
    """The training launcher (``launch/train.py``) over a world-size-1 NCCL
    process group (127.0.0.1, a free port; destroyed at the end, even on
    failure) and ``make_local_mesh((1, 1))``: ``run`` on full-width
    stablelm-3b at train_4k's b = 4 and S = 4,096, LAUNCH_Z slots, all 32
    layers, 3 steps through ``steps_dist.make_train_step`` (finite per-slot
    losses; every step's LoRA and flash launches; the peak GiB); then at
    LAUNCH_CHECK_LAYERS layers (Z 4, ranks 4-32 bound, S 1,024):
    ``remat=False`` equal to ``remat=True`` bit for bit on losses and LoRA
    grads, opt levels 0, 1 and 2 bit for bit on losses and grad norms (the
    1x1 mesh's model_size is 1), and the scan kernel at the policy's
    ``scan_chunk`` 32 against its plain version; then ``main`` through
    the CLI with ``--reduced --steps 2``. Returns {path: launches}."""
    from repro_torch.core import lora as LORA
    from repro_torch.core import steps as STEPS
    from repro_torch.configs.registry import get_arch
    from repro_torch.configs.shapes import TRAIN_4K
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.kernels.linear_scan import ref as lsref
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import partitioning as PT
    from repro_torch.launch import steps_dist as SD
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import model as M
    from repro_torch.optim import adamw

    cfg = get_arch("stablelm-3b")
    _, b = TRAIN_4K.decompose()
    S = TRAIN_4K.seq_len
    want, _, (want_flash, _) = _step_launches(cfg)
    launches = {"launch_train": {fam: {k: 0 for k in want} for fam in fams},
                "launch_flash": 0}
    with MESH.process_group("cuda"):
        mesh = MESH.make_local_mesh((1, 1))
        print(f"launch: world-size-1 NCCL group, mesh "
              f"{MESH.axis_sizes(mesh)}")
        per_step = []

        def hook(t, metrics, seconds):
            per_step.append(_counts(fams, FA))

        _counts(fams, FA)
        t0 = time.perf_counter()
        res = TRAIN.run(cfg, LAUNCH_Z, b, S, mesh, 3, rank=LAUNCH_RANK,
                        device="cuda", step_hook=hook,
                        log=lambda m: print(f"launch: {m}"))
        losses = torch.tensor(res["losses"])
        require(bool(torch.isfinite(losses).all()),
                f"launch: non-finite per-slot losses {res['losses']}")
        for t, got in enumerate(per_step):
            require(got["dense"] == want and got["flash"] == want_flash
                    and not any(got["ragged"].values())
                    and not any(got["rank-local"].values()),
                    f"launch step {t}: launches {got}, expected dense "
                    f"{want} and flash {want_flash}")
            for k in want:
                launches["launch_train"]["dense"][k] += got["dense"][k]
            launches["launch_flash"] += got["flash"]
        print(f"launch: stablelm-3b Z {LAUNCH_Z}, b {b}, S {S}, "
              f"{cfg.num_layers} layers: 3 steps of "
              f"{[round(v, 3) for v in res['step_s']]} s, per-slot losses "
              f"{res['losses']}, peak {res['peak_gib']:.2f} GiB; each step "
              f"LoRA (dense) {list(want.values())}, flash {want_flash}; "
              f"{res['policy_decisions']} constraint decisions resolved, "
              f"{time.perf_counter() - t0:.1f} s")
        mfu, flops, med = launch_mfu(cfg, LAUNCH_Z, b, S, LAUNCH_RANK,
                                     res["step_s"])
        print(f"launch: step MFU {mfu:.4f} = model_flops {flops:.4e} "
              f"(Z {LAUNCH_Z}, b {b}, S {S}, rank {LAUNCH_RANK}) / (median "
              f"step {med:.3f} s x {H100_BF16_FLOPS:.4g} FLOP/s)")
        gc.collect()
        torch.cuda.empty_cache()

        # 4 layers: remat=False == remat=True, opt levels 0/1/2
        cfg4 = dataclasses.replace(cfg, num_layers=LAUNCH_CHECK_LAYERS)
        Z4, S4, dev = 4, 1024, "cuda"
        params = M.init_params(cfg4, seed=0, device=dev)
        ranks = torch.tensor(TRAIN_RANKS, dtype=torch.int32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(5)
        lora0 = LORA.init_lora_tree(gen, cfg4, Z4, ranks,
                                    M.target_shapes(cfg4))
        for ab in lora0.values():        # non-zero B inside each rank
            ab["B"].normal_(generator=gen).mul_(0.01)
            LORA.mask_lora_tree({"t": ab}, ranks, cfg4.lora.r_max)
        tok = torch.randint(0, cfg4.vocab_size, (Z4, b, S4), generator=gen,
                            device=dev, dtype=torch.int32)
        batch = {"tokens": tok, "labels": tok, "slot_ranks": ranks}
        active = torch.ones((Z4,), dtype=torch.int32, device=dev)

        def clone(tree):
            return {t: {k: v.clone() for k, v in ab.items()}
                    for t, ab in tree.items()}

        got = {r: STEPS.lora_grads(cfg4, params, clone(lora0), batch,
                                   active, remat=r) for r in (True, False)}
        require(torch.equal(got[True][0], got[False][0])
                and all(torch.equal(got[True][1][t][k], got[False][1][t][k])
                        for t in got[True][1] for k in got[True][1][t]),
                "launch: remat=False differs from remat=True")
        print(f"launch: {LAUNCH_CHECK_LAYERS} layers, Z {Z4}, b {b}, S {S4}:"
              f" remat=False == remat=True bit for bit (losses "
              f"{got[True][0].tolist()} and all "
              f"{sum(len(ab) for ab in got[True][1].values())} LoRA grads)")
        per_level = {}
        for level in (0, 1, 2):
            step = SD.make_train_step(cfg4, mesh, opt_level=level)
            lora = clone(lora0)
            opt = adamw.init_state(lora, Z4)
            hp = adamw.SlotHParams.broadcast(Z4, lr=1e-3, device=dev)
            _, _, m = step(params, lora, opt, hp, active, ranks, batch)
            per_level[level] = m
            require(step.policy.hints["model_size"] == 1,
                    f"launch: model_size {step.policy.hints}")
        for level in (1, 2):
            require(torch.equal(per_level[level]["per_slot_loss"],
                                per_level[0]["per_slot_loss"])
                    and torch.equal(per_level[level]["grad_norm"],
                                    per_level[0]["grad_norm"]),
                    f"launch: opt level {level} differs from level 0")
        print(f"launch: opt levels 0, 1, 2 bit for bit on the 1x1 mesh "
              f"(losses {per_level[0]['per_slot_loss'].tolist()})")
        del params, lora0, got, per_level
        gc.collect()
        torch.cuda.empty_cache()

        # the scan kernel at the opt-level-2 policy's scan_chunk
        chunk = PT.activation_policy(mesh, opt_level=2).hints["scan_chunk"]
        g = torch.Generator(device=dev).manual_seed(9)
        B, Sx, K = 160, 256, 64
        q, k, v = (torch.randn(B, Sx, K, generator=g, device=dev)
                   for _ in range(3))
        logw = -torch.exp(torch.rand(B, Sx, K, generator=g, device=dev) * 4
                          - 3)
        bonus = torch.randn(B, K, generator=g, device=dev) * 0.1
        y, st = LSK.linear_scan(q, k, v, logw, bonus=bonus, chunk=chunk)
        py, pst = lsref.linear_scan_ref(q, k, v, logw, bonus=bonus,
                                        chunk=chunk)
        for name, a, p in (("y", y, py), ("state", st, pst)):
            bar = SCAN_RTOL["fp32"] * p.abs() + SCAN_ATOL_REL * \
                p.abs().max()
            require(bool(((a - p).abs() <= bar).all()),
                    f"launch: scan at chunk {chunk}: {name} off its bar")
        print(f"launch: the scan kernel at scan_chunk {chunk} (fp32, B {B}, "
              f"S {Sx}, K = V = {K}) within 1e-5 of its plain version")
    _counts(fams, FA)

    t0 = time.perf_counter()
    out = TRAIN.main(["--reduced", "--steps", "2"])
    require(all(math.isfinite(v) for row in out["losses"] for v in row),
            f"launch CLI: losses {out['losses']}")
    print(f"launch: the CLI (--reduced --steps 2) finished in "
          f"{time.perf_counter() - t0:.1f} s")
    _counts(fams, FA)
    torch.cuda.empty_cache()
    return launches


def _ap_env(rank: int, port: int) -> dict:
    import os
    src = str(ROOT / "src")
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(AP_PROCS),
               LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="2",
               PYTHONPATH=src + (":" + os.environ["PYTHONPATH"]
                                 if os.environ.get("PYTHONPATH") else ""))
    return env


def _ap_start(cmd, out_dir: Path, tag: str):
    """AP_PROCS processes of ``cmd`` (torchrun-style environment, one free
    port), their output to ``out_dir/<tag><rank>.log``."""
    from repro_torch.launch.mesh import free_port
    port = free_port()
    logs = [open(out_dir / f"{tag}{r}.log", "w") for r in range(AP_PROCS)]
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=_ap_env(r, port),
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(AP_PROCS)]
    return procs, logs, out_dir, tag


def _ap_kill(started) -> None:
    """Kill whichever of ``_ap_start``'s processes still run."""
    procs, logs, _, _ = started
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()


def _ap_wait(started) -> list:
    """Wait for ``_ap_start``'s processes; every one is killed if any fails
    or the time runs out (or the caller fails meanwhile). Returns each
    rank's output; a failure names the ranks that failed before the kill."""
    procs, logs, out_dir, tag = started
    failed = []
    try:
        deadline = time.perf_counter() + AP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.poll() not in (None, 0)]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
    finally:
        _ap_kill(started)
    texts = [(out_dir / f"{tag}{r}.log").read_text()
             for r in range(AP_PROCS)]
    for r in failed + list(range(AP_PROCS)):
        require(procs[r].returncode == 0, f"ap {tag} rank {r} exited "
                f"{procs[r].returncode} (first to fail: ranks {failed}):\n"
                f"{texts[r][-3000:]}")
    return texts


def _ap_args(cfg, reduced: bool, device: str, steps: int,
             load=AP_LOAD) -> list:
    """The launcher's flags for ``cfg`` (its arch, reduced or cut to its
    depth) on phase 35's mesh and ``load`` (Z, b, S)."""
    Z, b, S = load
    return (["--arch", cfg.name]
            + (["--reduced"] if reduced else
               ["--layers", str(cfg.num_layers)])
            + ["--slots", str(Z), "--batch", str(b), "--seq",
               str(S), "--ranks", ",".join(map(str, RANKS)),
               "--mesh", AP_MESH, "--backend", "gloo", "--device", device,
               "--steps", str(steps)])


@contextlib.contextmanager
def _planted(layer: int):
    """Two faults planted in this process's sharded step, each on its own
    data rank's slots: on data rank 0 (slots AP_FAULT_SLOTS["skip_scatter"])
    layer ``layer``'s row-parallel partial sums are sliced, not
    reduce-scattered; data rank 1 (slots AP_FAULT_SLOTS["swap_slots"]) is
    fed rank 0's slots."""
    from repro_torch.launch import partitioning as PT
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import blocks as B
    here = {"layer": None}
    apply_block, residual = B.apply_block, PT.SpmdPlan.residual
    next_batch = TRAIN.SlotBatcher.next_batch

    def block(cfg, x, p, lora, layer_, ctx):
        prev, here["layer"] = here["layer"], layer_
        try:
            return apply_block(cfg, x, p, lora, layer_, ctx)
        finally:
            here["layer"] = prev

    def skip(self, x):
        if (here["layer"] == layer and self.mesh.get_local_rank("data") == 0
                and getattr(x, "_spmd_partial", False)):
            return self.local(x, 2)
        return residual(self, x)

    def swapped(self):
        tok, lab = next_batch(self)
        half = self.Z // 2
        tok[half:], lab[half:] = tok[:half].copy(), lab[:half].copy()
        return tok, lab

    B.apply_block, PT.SpmdPlan.residual = block, skip
    TRAIN.SlotBatcher.next_batch = swapped
    try:
        yield
    finally:
        B.apply_block, PT.SpmdPlan.residual = apply_block, residual
        TRAIN.SlotBatcher.next_batch = next_batch


@contextlib.contextmanager
def _planted_moe(faults, route_layer: int, slice_layer: int):
    """Phase 36's faults named in ``faults``: "route_blind", data rank 1
    routes layer ``route_layer`` without the lower data ranks' counts (the
    counts still cross "data"; the places its own earlier pieces of a
    group took still count); "moe_slice", data rank 0's MoE partial sum
    in layer ``slice_layer`` is sliced along S, not reduce-scattered."""
    from repro_torch.launch import partitioning as PT
    from repro_torch.models import blocks as B
    from repro_torch.models import moe as MOE
    here = {"layer": None}
    apply_block, moe_block = B.apply_block, MOE.moe_block
    exchange, residual = PT.SpmdPlan.route_exchange, PT.SpmdPlan.residual

    def block(cfg, x, p, lora, layer_, ctx):
        prev, here["layer"] = here["layer"], layer_
        try:
            return apply_block(cfg, x, p, lora, layer_, ctx)
        finally:
            here["layer"] = prev

    def blind(self, counts, top1, piece, group):
        offset, top1 = exchange(self, counts, top1, piece, group)
        if ("route_blind" in faults and here["layer"] == route_layer
                and self.data_rank == 1):
            # the places its own earlier pieces of a group took, alone
            at = self._offsets(counts.shape[0] * piece, piece,
                               self.data_rank, self.pod_rank).to(
                                   counts.device)
            before = ((at // group)[:, None] == (at // group)[None]) & (
                at[None] < at[:, None])
            offset = (before[..., None] * counts[None]).sum(1).to(
                offset.dtype)
        return offset, top1

    def moe(x, params, cfg_moe):
        out, aux = moe_block(x, params, cfg_moe)
        out._planted_slice = ("moe_slice" in faults
                              and here["layer"] == slice_layer)
        return out, aux

    def skip(self, x):
        if getattr(x, "_planted_slice", False) and self.data_rank == 0:
            return self.local(x, 2)
        return residual(self, x)

    saved = (B.apply_block, MOE.moe_block, PT.SpmdPlan.route_exchange,
             PT.SpmdPlan.residual)
    B.apply_block, MOE.moe_block = block, moe
    PT.SpmdPlan.route_exchange, PT.SpmdPlan.residual = blind, skip
    try:
        yield
    finally:
        (B.apply_block, MOE.moe_block, PT.SpmdPlan.route_exchange,
         PT.SpmdPlan.residual) = saved


@contextlib.contextmanager
def _planted_ssm(faults, layer: int):
    """Phase 37's faults named in ``faults``, in layer ``layer``:
    "shift_local", data rank 0 shifts each model rank's sequence block
    alone (the first token of every block but the first takes zeros, not
    its true predecessor; RWKV's time and channel mixes); "in_proj_cols",
    data rank 1 takes in_proj's contiguous column block (the rule's plain
    Shard(-1)) for its x/z split, and the same block of its LoRA B
    (Mamba)."""
    from repro_torch.core import lora as LORA
    from repro_torch.models import blocks as B
    from repro_torch.models import mamba as MAMBA
    from repro_torch.models import rwkv as RW
    from repro_torch.models import shardctx
    here = {"layer": None}
    apply_block, shift, proj = B.apply_block, RW._token_shift, MAMBA.proj

    def block(cfg, x, p, lora, layer_, ctx):
        prev, here["layer"] = here["layer"], layer_
        try:
            return apply_block(cfg, x, p, lora, layer_, ctx)
        finally:
            here["layer"] = prev

    def local_shift(x, prev):
        out = shift(x, prev)
        sp = shardctx.spmd()
        if ("shift_local" in faults and here["layer"] == layer
                and sp is not None and sp.data_rank == 0 and sp.m > 1):
            k = x.shape[2] // sp.m
            out = out.clone()
            out[:, :, k::k] = 0
        return out

    def cols_proj(x, W, lora_pair=None, scale=2.0, name=None, **kw):
        sp = shardctx.spmd()
        if not ("in_proj_cols" in faults and name == "in_proj"
                and here["layer"] == layer and sp is not None
                and sp.data_rank == 1 and sp.m > 1):
            return proj(x, W, lora_pair, scale, name, **kw)
        W = sp.local(sp.gather_model(sp.weight(W, name), name), -1)
        x = sp.columns(x)
        A, Bm = lora_pair
        return x @ W + LORA.lora_delta(x, A, sp.local(Bm, -1).contiguous(),
                                       scale)

    saved = B.apply_block, RW._token_shift, MAMBA.proj
    B.apply_block, RW._token_shift, MAMBA.proj = block, local_shift, cols_proj
    try:
        yield
    finally:
        B.apply_block, RW._token_shift, MAMBA.proj = saved


@contextlib.contextmanager
def _planted_modal(faults):
    """Phase 38's faults named in ``faults``: (c) "prefix_head", data rank
    0's model ranks each write the prefix's first rows at the head of their
    own sequence block (model rank 0's are right; the others' are not);
    (d) "positions_rank0", data rank 1 takes data rank 0's slots of the
    per-slot positions."""
    import torch

    from repro_torch.launch import partitioning as PT
    prefix, positions = PT.SpmdPlan.prefix, PT.SpmdPlan.slot_positions

    def head(self, x, modal):
        if "prefix_head" not in faults or self.data_rank != 0:
            return prefix(self, x, modal)
        n = min(modal.shape[2], x.shape[2])
        return torch.cat([modal[:, :, :n].to(x.dtype), x[:, :, n:]], dim=2)

    def first(self, pos, mrope):
        if "positions_rank0" not in faults or self.data_rank != 1:
            return positions(self, pos, mrope)
        dim = 1 if mrope else 0
        return (pos.narrow(dim, 0, self.z_local)
                if pos.dim() == dim + 3 else pos)

    PT.SpmdPlan.prefix, PT.SpmdPlan.slot_positions = head, first
    try:
        yield
    finally:
        PT.SpmdPlan.prefix, PT.SpmdPlan.slot_positions = prefix, positions


@contextlib.contextmanager
def _planted_serve(faults):
    """The faults of the sharded DPO and serving jobs named in ``faults``:
    "dpo_swap", data rank 1's policy forwards score the rejected sequences
    as chosen and the chosen as rejected (the frozen reference's forwards
    do not); "kv_roll", on data rank 0 the last model rank writes its KV
    heads into the cache rolled by one head (prefill and decode);
    "pod_kv_roll", the same on pod rank 1 (its lanes of every slot);
    "state_roll", on data rank 1 the last model rank's wkv heads of layer 0
    are rolled by one head after the prefill (RWKV); "conv_roll", on data
    rank 0 the last model rank's conv block of layer 0 is rolled by one
    row along W-1 after the prefill (Mamba)."""
    import torch

    from repro_torch.core import losses as LS
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.models import shardctx
    seq, span, lanes = LS._seq_logp, B._write_span, B._write_lanes
    forward = M.forward

    def other(cfg, params, lora, tokens, labels, remat):
        sp = shardctx.spmd()
        batch = swap.get("batch")
        if ("dpo_swap" in faults and lora and batch is not None
                and sp is not None and sp.data_rank == 1):
            which = ("rejected" if tokens is batch["tokens_chosen"]
                     else "chosen")
            tokens, labels = (batch[f"tokens_{which}"],
                              batch[f"labels_{which}"])
        return seq(cfg, params, lora, tokens, labels, remat)

    loss = LS.LOSSES["dpo"]
    swap = {}

    def dpo(cfg, params, lora, batch, active, **kw):
        swap["batch"] = batch
        try:
            return loss(cfg, params, lora, batch, active, **kw)
        finally:
            swap.clear()

    def rolled(new):
        sp = shardctx.spmd()
        if sp is None or sp.model_rank != sp.m - 1:
            return new
        if ("kv_roll" in faults and sp.data_rank == 0
                or "pod_kv_roll" in faults and sp.pod_rank == 1):
            return torch.roll(new, 1, dims=-2)   # [..., KV/m, hd]
        return new

    def write_span(c, new, start, mask):
        return span(c, rolled(new), start, mask)

    def write_lanes(c, new, index, mask):
        return lanes(c, rolled(new), index, mask)

    def rolled_state(*args, **kw):
        h, aux, cache = forward(*args, **kw)
        sp = shardctx.spmd()
        if cache is None or sp is None or sp.model_rank != sp.m - 1:
            return h, aux, cache
        layers = cache["layers"]
        if "state_roll" in faults and sp.data_rank == 1 and "wkv" in layers:
            layers["wkv"][0] = torch.roll(layers["wkv"][0], 1, dims=2)
        if ("conv_roll" in faults and sp.data_rank == 0
                and "mamba" in layers):
            conv = layers["mamba"]["conv"]             # [L, Z, b, W-1, .]
            conv[0] = torch.roll(conv[0], 1, dims=2)
        return h, aux, cache

    LS._seq_logp, LS.LOSSES["dpo"] = other, dpo
    B._write_span, B._write_lanes = write_span, write_lanes
    M.forward = rolled_state
    try:
        yield
    finally:
        LS._seq_logp, LS.LOSSES["dpo"] = seq, loss
        B._write_span, B._write_lanes = span, lanes
        M.forward = forward


@contextlib.contextmanager
def _planted_pod(faults, route_layer: int = AP_MOE_ROUTE_LAYER):
    """Phase 39's pod faults named in ``faults``: "pod_grad_skip", the
    adapter gradients of the slots ``AP_POD_JOBS["pod_train"]`` names are
    not all-reduced over "pod" (each pod rank steps on its own rows'
    share); "route_pod_blind", pod rank 1 of data rank 1 routes layer
    ``route_layer`` without its pod peer's counts (they still cross
    "pod"); "pod_kv_roll", ``_planted_serve``'s."""
    import torch

    from repro_torch.launch import collectives as C
    from repro_torch.launch import partitioning as PT
    from repro_torch.models import blocks as B
    here = {"layer": None}
    apply_block = B.apply_block
    reduce_grads = PT.SpmdPlan.reduce_grads
    exchange = PT.SpmdPlan.route_exchange
    skipped = AP_POD_JOBS["pod_train"][3]["pod_grad_skip"]

    def block(cfg, x, p, lora, layer_, ctx):
        prev, here["layer"] = here["layer"], layer_
        try:
            return apply_block(cfg, x, p, lora, layer_, ctx)
        finally:
            here["layer"] = prev

    def grads(self, g):
        out = reduce_grads(self, g)
        if "pod_grad_skip" not in faults or self.p == 1:
            return out
        p, self.p = self.p, 1            # the all-reduce over "model" only
        try:
            mine = reduce_grads(self, g)
        finally:
            self.p = p
        first = self.data_rank * self.z_local
        keep = [z - first for z in skipped
                if first <= z < first + self.z_local]
        for t, ab in out.items():
            for k, v in ab.items():
                v[:, keep] = mine[t][k][:, keep]
        return out

    def blind(self, counts, top1, piece, group):
        if not ("route_pod_blind" in faults and here["layer"] == route_layer
                and self.pod_rank == 1 and self.data_rank == 1):
            return exchange(self, counts, top1, piece, group)
        gather = C.all_gather

        def own(x, mesh, axis, dim, role, log):
            out = gather(x, mesh, axis, dim, role, log)
            if axis == "pod":              # [p, 2, n, E]: peers' zeroed
                out = torch.stack([t if i == self.pod_rank
                                   else torch.zeros_like(t)
                                   for i, t in enumerate(out)])
            return out

        C.all_gather = own
        try:
            return exchange(self, counts, top1, piece, group)
        finally:
            C.all_gather = gather

    saved = (B.apply_block, PT.SpmdPlan.reduce_grads,
             PT.SpmdPlan.route_exchange)
    B.apply_block, PT.SpmdPlan.reduce_grads = block, grads
    PT.SpmdPlan.route_exchange = blind
    try:
        with (_planted_serve(faults) if "pod_kv_roll" in faults
              else contextlib.nullcontext()):
            yield
    finally:
        (B.apply_block, PT.SpmdPlan.reduce_grads,
         PT.SpmdPlan.route_exchange) = saved


@contextlib.contextmanager
def _planted_uneven(faults):
    """The uneven jobs' faults (``AP_UNEVEN_JOBS``) named in ``faults``:
    "scan_block_wrong", in layer AP_SSM_FAULT_LAYER model rank 3 keeps
    model rank 2's sequence block of the whole Mamba output for the slots
    the job names; "whole_state_roll", after the prefill model rank 0's
    ssm heads of every layer rolled by one head for the slots the job
    names;
    "rows_swapped", data rank 1 binds data rank 0's slot rows."""
    import torch

    from repro_torch.launch import partitioning as PT
    from repro_torch.models import blocks as B
    from repro_torch.models import model as M
    from repro_torch.models import shardctx
    here = {"layer": None, "mamba": False}
    saved = (B.apply_block, B.mamba_block, PT.SpmdPlan.seq_block,
             PT.SpmdPlan.slot_vectors, M.forward)
    apply_block, mamba_block, seq_block, slot_vectors, forward = saved

    def block(cfg, x, p, lora, layer_, ctx):
        prev, here["layer"] = here["layer"], layer_
        try:
            return apply_block(cfg, x, p, lora, layer_, ctx)
        finally:
            here["layer"] = prev

    def mamba(*args, **kw):
        here["mamba"] = True
        try:
            return mamba_block(*args, **kw)
        finally:
            here["mamba"] = False

    def local_slots(self, slots):
        first = self.data_rank * self.z_local
        return [z - first for z in slots if first <= z < first + self.z_local]

    def wrong(self, t):
        out = seq_block(self, t)
        if not ("scan_block_wrong" in faults and here["mamba"]
                and here["layer"] == AP_SSM_FAULT_LAYER
                and self.model_rank == 3):
            return out
        slots = local_slots(
            self, AP_UNEVEN_JOBS["scan_whole"][4]["scan_block_wrong"])
        pick = torch.zeros(t.shape[0], dtype=torch.bool, device=t.device)
        pick[slots] = True
        k = t.shape[2] // self.m
        out = torch.where(pick.view(-1, *(1,) * (t.dim() - 1)),
                          t.narrow(2, 2 * k, k), out).contiguous()
        out._spmd_block = True
        return out

    def swapped(self, batch):
        out = slot_vectors(self, batch)
        if ("rows_swapped" in faults and self.data_rank == 1
                and out.get("slot_rows") is not None):
            rows = out["slot_rows"]
            out["slot_rows"] = torch.tensor(
                [w * self.seq_len for w in AP_RAGGED_WIDTHS[:self.z_local]],
                dtype=rows.dtype, device=rows.device)
        return out

    def rolled(*args, **kw):
        h, aux, cache = forward(*args, **kw)
        sp = shardctx.spmd()
        if ("whole_state_roll" in faults and cache is not None
                and sp is not None and sp.model_rank == 0):
            ssm = cache["layers"]["mamba"]["ssm"]      # [L, Z, b, H, N, hs]
            for z in local_slots(sp, AP_UNEVEN_JOBS["scan_whole_serve"][4][
                    "whole_state_roll"]):
                ssm[:, z] = torch.roll(ssm[:, z], 1, dims=2)
        return h, aux, cache

    B.apply_block, B.mamba_block = block, mamba
    PT.SpmdPlan.seq_block, PT.SpmdPlan.slot_vectors = wrong, swapped
    M.forward = rolled
    try:
        yield
    finally:
        (B.apply_block, B.mamba_block, PT.SpmdPlan.seq_block,
         PT.SpmdPlan.slot_vectors, M.forward) = saved


def _placed(mesh, tree, specs):
    from repro_torch.launch import partitioning as PT
    return PT.distribute(mesh, tree, PT.to_named(mesh, specs))


class _Ragged:
    """The ragged kernels (rows 7-12) behind the rank-local wrappers'
    signatures (``RG``) and their plain versions behind the rank-local
    plain versions' names (``ref``), for ``backward_kernel_phase``: every
    slot at r_max, so the ranks are not passed on."""

    def __init__(self, RG=None, ref=None):
        self.RG, self.ref = RG, ref

    def xa(self, x, A, rows, ranks):
        return self.RG.xa(x, A, rows)

    def sb_add(self, s, B, scale, rows, ranks, base=None):
        return self.RG.sb_add(s, B, scale, rows, base)

    def ds(self, dy, B, scale, rows, ranks):
        return self.RG.ds(dy, B, scale, rows)

    def dx(self, dS, A, rows, ranks):
        return self.RG.dx(dS, A, rows)

    def da(self, x, dS, rows, ranks):
        return self.RG.da(x, dS, rows)

    def db(self, s, dy, scale, rows, ranks):
        return self.RG.db(s, dy, scale, rows)

    def ranklocal_xa_ref(self, x, A, rows, ranks):
        return self.ref.ragged_xa_ref(x, A, rows)

    def ranklocal_sb_add_ref(self, s, B, scale, rows, ranks, base=None):
        return self.ref.ragged_sb_add_ref(s, B, scale, rows, base)

    def ranklocal_ds_ref(self, dy, B, scale, rows, ranks):
        return self.ref.ragged_ds_ref(dy, B, scale, rows)

    def ranklocal_dx_ref(self, dS, A, rows, ranks):
        return self.ref.ragged_dx_ref(dS, A, rows)

    def ranklocal_da_ref(self, x, dS, rows, ranks):
        return self.ref.ragged_da_ref(x, dS, rows)

    def ranklocal_db_ref(self, s, dy, scale, rows, ranks):
        return self.ref.ragged_db_ref(s, dy, scale, rows)


def _rank_lanes(mesh, Z: int, b: int) -> tuple:
    """(slots, lanes): the slots of this rank's data rank on ``mesh`` and
    its pod rank's ``b``/p lanes of each (all Z and all b on a mesh
    without a split data or pod axis)."""
    from repro_torch.launch.mesh import axis_sizes
    sizes = axis_sizes(mesh)

    def block(axis, n):
        k = sizes.get(axis, 1)
        r = mesh.get_local_rank(axis) if k > 1 else 0
        return slice(r * n // k, (r + 1) * n // k)

    return block("data", Z), block("pod", b)


def ap_dpo(torch, cfg, mesh, params, lora, batches, ranks, *, lr: float,
           bind_ranks: bool = True) -> dict:
    """``len(batches) - 1`` DPO train steps (``steps_dist``, sharded on a
    real multi-rank ``mesh``; on a one-rank mesh, the one-rank run), one a
    batch, then the DPO eval step on the last batch with the trained
    adapters. ``params``, ``lora`` and each batch (the pairs' tokens and
    labels, [Z, b, S]) are whole: distributed here; slot z trains at
    ``ranks[z]``, bound (the rank-local kernels) with ``bind_ranks``.
    Returns {"losses": [steps, Z], "eval": [Z] (all slots, gathered over
    "data"), "lora": this rank's adapters, "launches" and
    "eval_launches": the kernel launches of the steps and of the eval
    step, by set}."""
    from repro_torch.launch import partitioning as PT
    from repro_torch.launch import steps_dist as SD
    from repro_torch.launch import train as TRAIN
    from repro_torch.optim import adamw
    Z = ranks.shape[0]
    dev = ranks.device
    opt = adamw.init_state(lora, Z)
    hp = adamw.SlotHParams.broadcast(Z, lr=lr, device=dev)
    active = torch.ones((Z,), dtype=torch.int32, device=dev)
    l_named = PT.to_named(mesh, PT.lora_param_specs(mesh, lora))
    o_named = PT.to_named(mesh, PT.opt_state_specs(mesh, opt))
    params = _placed(mesh, params, PT.base_param_specs(mesh, params))
    lora = PT.distribute(mesh, lora, l_named)
    opt = PT.distribute(mesh, opt, o_named)
    hp = _placed(mesh, hp, PT.hp_specs(mesh, hp))
    v_spec = PT.pick_spec(mesh, (Z,), [{0: "data"}, {}])
    active, ranks = (_placed(mesh, t, v_spec) for t in (active, ranks))

    def placed(batch):
        batch = _placed(mesh, batch, PT.batch_specs(mesh, batch))
        if bind_ranks:
            batch["slot_ranks"] = ranks
        return batch

    step = SD.make_train_step(cfg, mesh, loss_kind="dpo")
    out = {"losses": []}
    before = TRAIN._launch_counts()
    for batch in batches[:-1]:
        lora, opt, metrics = step(params, lora, opt, hp, active, ranks,
                                  placed(batch))
        lora = PT.from_local(mesh, lora, l_named)
        opt = PT.from_local(mesh, opt, o_named)
        out["losses"].append(metrics["per_slot_loss"].float().cpu().tolist())
    mid = TRAIN._launch_counts()
    evaluate = SD.make_eval_step(cfg, mesh, loss_kind="dpo")
    out["eval"] = evaluate(params, lora, active,
                           placed(batches[-1])).float().cpu().tolist()
    after = TRAIN._launch_counts()
    out["launches"], out["eval_launches"] = (
        {fam: {k: b[fam][k] - a[fam][k] for k in ks}
         for fam, ks in b.items()} for a, b in ((before, mid), (mid, after)))
    out["lora"] = PT.local(lora)
    return out


def _flat_leaves(tree, prefix: str = "") -> dict:
    """A nested dict of tensors as {"<prefix>a/b": tensor}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def ap_serve(torch, cfg, mesh, params, lora, batch, ranks, n: int, *,
             per_lane: bool = False, grow: bool = False, feed=None,
             idle=None, ring: bool = False) -> dict:
    """The prefill step then ``n`` serve steps (``steps_dist``, sharded on
    a real multi-rank ``mesh``; on a one-rank mesh, the one-rank run).
    ``params``, ``lora`` and ``batch`` (tokens [Z, b, S] and a vlm's
    prefix and positions) are whole: distributed here, the cache laid out
    by ``serve_cache_specs``: S + n rows (and one more for an ``idle``
    step) or, with ``grow``, S rows, the K/V grown by the rest after the
    prefill (a cache as long as the prompt takes the flash kernel); a
    global position, or with ``per_lane`` a [Z, b] one. With ``ring`` there
    is no prefill: a per-lane ring cache of the sliding window takes ``n``
    serve steps fed ``feed``. Each serve step takes the previous logits'
    greedy tokens or ``feed[i]`` ([Z, b], whole); with ``idle`` ((slot,
    lane) pairs, a per-lane cache) one more step runs with those lanes
    idle (``active``). The LoRA terms take the rank-local kernels at
    ``ranks`` ([Z]; None: nothing bound). Returns, for this rank:
    "logits" [n + 1 (n with ``ring``), Z/d, b/p, V] fp32 (this data rank's
    slots, on a pod mesh its pod rank's lanes of them, the whole
    vocabulary), "tokens" [n (+ 1 with ``idle``), Z/d, b/p] (those fed),
    "cache" ({"cache/attn/k": ..., "cache/wkv": ...}: every
    local leaf of the cache after the prefill, and "split/<path>": the dim
    it splits over "model", -1 where it is whole there; ``cache_whole``
    joins the ranks' shards), "launches" (by set, every step), "log" (on a
    real multi-rank mesh, {"prefill" | "serve": the steps' collective
    records}), and
    with ``idle``: "idle_logits" [Z/d, b, V], "idle_changed" (the entries
    of idle lanes' local cache rows, in every leaf, and positions the step
    changed: must be 0) and "live_changed" (the live lanes' entries it
    changed)."""
    from repro_torch.core import lora as LORA
    from repro_torch.launch import partitioning as PT
    from repro_torch.launch import steps_dist as SD
    from repro_torch.launch import train as TRAIN
    from repro_torch.models import model as M
    tokens = batch["tokens"]
    dev, (Z, b, S) = tokens.device, tuple(tokens.shape)
    extra = n + (idle is not None)
    params = _placed(mesh, params, PT.base_param_specs(mesh, params))
    lora = _placed(mesh, lora, PT.lora_param_specs(mesh, lora))
    batch = _placed(mesh, batch, PT.batch_specs(mesh, batch))
    cache = M.init_cache(cfg, Z, b, S if grow else S + extra,
                         ring=ring, per_lane=per_lane or ring, device=dev)
    specs = PT.serve_cache_specs(cfg, mesh, cache)
    named = PT.to_named(mesh, specs)
    cache = PT.distribute(mesh, cache, named)
    mine = _rank_lanes(mesh, Z, b)
    prefill = SD.make_prefill_step(cfg, mesh)
    serve = SD.make_serve_step(cfg, mesh)
    out = {"logits": [], "tokens": []}
    before = TRAIN._launch_counts()
    with (torch.inference_mode(),
          LORA.slot_ranks(None if ranks is None else ranks[mine[0]])):
        if ring:
            logits, local = None, PT.local(cache)
        else:
            logits, local = prefill(params, lora, cache, batch)
            out["logits"].append(logits.float())
        out["cache"] = {f"cache/{k}": v.clone()
                        for k, v in _flat_leaves(local["layers"]).items()}
        out["cache"].update({
            f"split/{k}": spec.index("model") if "model" in spec else -1
            for k, spec in _flat_leaves(specs["layers"]).items()})
        if grow:                      # the K/V (RWKV keeps none)
            attn = local["layers"].get("attn", {})
            for key, t in list(attn.items()):
                attn[key] = torch.cat([t, t.new_zeros(
                    t.shape[:3] + (extra,) + t.shape[4:])], dim=3)
        cache = PT.from_local(mesh, local, named)
        for i in range(n):
            cur = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[i][mine].to(dev, torch.int32))
            out["tokens"].append(cur)
            logits, local = serve(params, lora, cache, cur)
            cache = PT.from_local(mesh, local, named)
            out["logits"].append(logits.float())
        if idle is not None:
            active = torch.ones((Z, b), dtype=torch.bool, device=dev)
            for z, lane in idle:
                active[z, lane] = False

            def lanes(c):
                """Every local leaf with its lanes [Z/d, b] first, and this
                data rank's lanes of the positions."""
                return [*(v.movedim(0, 2) for v in _leaves(c["layers"])),
                        *(c[k][mine] for k in ("pos", "k_pos") if k in c)]

            was = [t.clone() for t in lanes(local)]
            cur = (logits.argmax(-1).to(torch.int32) if feed is None
                   else feed[n][mine].to(dev, torch.int32))
            out["tokens"].append(cur)
            out["idle_logits"], local = serve(params, lora, cache, cur,
                                              active)
            # changed entries per lane of this data rank's slots [Z/d, b]
            diff = sum((a != w).reshape(*a.shape[:2], -1).sum(-1)
                       for a, w in zip(lanes(local), was))
            live = active[mine]
            out["idle_changed"] = int(diff[~live].sum())
            out["live_changed"] = int(diff[live].sum())
    after = TRAIN._launch_counts()
    out["launches"] = {fam: {k: after[fam][k] - before[fam][k] for k in ks}
                       for fam, ks in after.items()}
    out["log"] = {name: [dataclasses.asdict(r) for r in step.policy.spmd.log]
                  for name, step in (("prefill", prefill), ("serve", serve))
                  if step.policy.spmd is not None}
    out["logits"] = torch.stack(out["logits"])
    out["tokens"] = torch.stack(out["tokens"]) if n else None
    return out


def cache_whole(parts, d: int, m: int, cat, p: int = 1) -> dict:
    """The whole prefilled cache {"cache/<path>": leaf} from the shards of
    every rank of a (d, m) or (p, d, m) mesh (``parts`` by global rank,
    rank r at pod rank r // (d·m), data rank r // m mod d and model rank
    r % m, each ``ap_serve``'s "cache"): the model ranks' shards joined
    along their "split/<path>" dim, the pod ranks' lanes along dim 2 and
    the data ranks' slots along dim 1; a leaf whole over "model" must be
    the same on every model rank of a (pod, data) rank, bitwise. ``cat``:
    ``np.concatenate`` or ``torch.cat``."""
    out = {}
    for key in (k for k in parts[0] if k.startswith("cache/")):
        dim = int(parts[0]["split/" + key[len("cache/"):]])
        rows = []
        for i in range(d):
            lanes = []
            for k in range(p):
                ps = [parts[(k * d + i) * m + j][key] for j in range(m)]
                if dim < 0:
                    require(all(bool((q == ps[0]).all()) for q in ps[1:]),
                            f"{key}: the model ranks of pod rank {k}, data "
                            f"rank {i} hold different copies of a leaf "
                            f"whole over model")
                    lanes.append(ps[0])
                else:
                    lanes.append(cat(ps, dim))
            rows.append(cat(lanes, 2) if p > 1 else lanes[0])
        out[key] = cat(rows, 1)
    return out


def _dpo_inputs(torch, dev, reduced: bool = False):
    """Phase 39's DPO job, as every process builds it from the seeds:
    (config (``reduced``: the tiny fp32 variant), full weights, adapters,
    [AP_DPO_STEPS + 1] batches of pairs, ranks) on ``dev``."""
    from repro_torch.core import lora as LORA
    from repro_torch.data.synthetic import PairSlotBatcher
    from repro_torch.models import model as M
    cfg = _ap_config(reduced, layers=AP_DPO_LAYERS, dtype="float32")
    Z = len(RANKS)
    ranks = torch.tensor(RANKS, dtype=torch.int32, device=dev)
    params = M.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    lora = LORA.init_lora_tree(gen, cfg, Z, ranks, M.target_shapes(cfg))
    pairs = PairSlotBatcher(*_pair_data(cfg), Z, DPO_B, seed=0)
    require(pairs.seq_len == AP_DPO_S, f"DPO pairs of {pairs.seq_len}")
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                pairs.next_batch_dict().items()}
               for _ in range(AP_DPO_STEPS + 1)]
    return cfg, params, lora, batches, ranks


def _serve_inputs(torch, dev, reduced: bool = False, job: str = "stablelm"):
    """Phase 39's serving job ``job`` (``AP_SERVE_JOBS``), as every process
    builds it from the seeds: (config (``reduced``: the tiny fp32 variant,
    its prompt cut to AP_SERVE_REDUCED_S), full weights, adapters (B drawn
    N(0, 0.003)), the prompt batch [Z, 2, S], ranks) on ``dev``."""
    from repro_torch.core import lora as LORA
    from repro_torch.models import model as M
    arch, layers, S = AP_SERVE_JOBS[job][:3]
    cfg = _ap_config(reduced, arch, layers)
    if reduced:
        S = min(S, AP_SERVE_REDUCED_S)
    Z = len(RANKS)
    ranks = torch.tensor(RANKS, dtype=torch.int32, device=dev)
    params = M.init_params(cfg, seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    lora = LORA.init_lora_tree(gen, cfg, Z, ranks, M.target_shapes(cfg))
    for ab in lora.values():
        ab["B"].normal_(0.0, 0.003, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (Z, 2, S), generator=gen,
                           device=dev, dtype=torch.int32)
    if cfg.is_moe:
        # slots 1 and 2 repeat one token at three of every four positions:
        # their rows pick the same experts, so the prefill's token group,
        # which spans the data ranks, overflows those experts' capacity
        # on data rank 1 (the route fault's reach)
        for z in (1, 2):
            tokens[z, :, torch.arange(S, device=dev) % 4 != 0] = AP_MOE_REPEAT
    return cfg, params, lora, {"tokens": tokens}, ranks


def _serve_fault(cfg, fault: str):
    """The context that plants serving fault ``fault`` (``AP_SERVE_JOBS``):
    phase 36's route fault on the MoE family, else ``_planted_serve``'s."""
    if fault == "route_blind":
        last = cfg.num_layers - 1
        return _planted_moe((fault,), min(AP_MOE_ROUTE_LAYER, last),
                            min(AP_MOE_SLICE_LAYER, last))
    return _planted_serve((fault,))


def _pool_job(spec: dict, dev, meshes: dict) -> None:
    """Phase 39's jobs of the fault pool: ``spec["kind"]`` "dpo" (the
    sharded DPO steps and eval of ``_dpo_inputs``, sound and with
    AP_DPO_FAULT) or "serve" (the sharded serving of ``_serve_inputs``'s
    job ``spec["job"]``, fed ``spec["feed"]``'s tokens, sound with the idle
    step and with the job's planted fault), one weight draw for both runs
    (with ``spec["reduced"]``, of the tiny fp32 configs). Each run's
    results go to ``spec["out"]``: the DPO runs' losses, evals and adapters
    as ``launch.train.write_out`` writes them (``dpo_<fault>.npz``), and
    per rank ``<kind>_<fault>_rank<r>.json`` (launches; the serving's idle
    readings; a serving job's names begin ``serve_<job>``), the sound
    serving run's prefilled cache shards (``cache_<job>_rank<r>.pt``) and,
    from each data rank's first model rank, the serving logits
    (``serve_<job>_<fault>_data<i>.npz``)."""
    import numpy as np
    import torch

    from repro_torch.launch import train as TRAIN
    out, kind = Path(spec["out"]), spec["kind"]
    if kind in AP_POD_JOBS:
        return _pod_job(spec, dev, meshes)
    if kind in AP_UNEVEN_JOBS:
        return _uneven_job(spec, dev, meshes)
    if AP_MESH not in meshes:
        meshes[AP_MESH] = TRAIN.build_mesh(AP_MESH, dev)
    mesh = meshes[AP_MESH]
    rank = torch.distributed.get_rank()
    first = mesh.get_local_rank("model") == 0
    data = mesh.get_local_rank("data")
    if kind == "dpo":
        cfg, params, lora, batches, ranks = _dpo_inputs(torch, dev,
                                                        spec["reduced"])
        faults = AP_DPO_FAULT
    else:
        job = spec["job"]
        kind = f"serve_{job}"
        cfg, params, lora, batch, ranks = _serve_inputs(
            torch, dev, spec["reduced"], job)
        feed = torch.load(spec["feed"], map_location=dev)
        faults = AP_SERVE_JOBS[job][3]
    for fault in ("none", *faults):
        if fault == "none":
            planted = contextlib.nullcontext()
        elif kind == "dpo":
            planted = _planted_serve((fault,))
        else:
            planted = _serve_fault(cfg, fault)
        with planted:
            if kind == "dpo":
                res = ap_dpo(torch, cfg, mesh, params, lora, batches,
                             ranks, lr=AP_DPO_LR)
                TRAIN.write_out(str(out / f"dpo_{fault}.npz"), mesh, res)
                info = {k: res[k] for k in ("launches", "eval_launches")}
            else:
                res = ap_serve(torch, cfg, mesh, params, lora, batch,
                               ranks, AP_SERVE_DECODES, per_lane=True,
                               grow=True, feed=feed,
                               idle=AP_IDLE_LANES if fault == "none"
                               else None)
                info = {k: res[k] for k in ("launches", "idle_changed",
                                            "live_changed") if k in res}
                if fault == "none":
                    torch.save(res["cache"], out / f"cache_{job}_rank{rank}"
                               ".pt")
                if first:
                    logits = {"logits": res["logits"].cpu().numpy()}
                    if "idle_logits" in res:
                        logits["idle_logits"] = res["idle_logits"].float(
                            ).cpu().numpy()
                    np.savez(out / f"{kind}_{fault}_data{data}.npz", **logits)
        (out / f"{kind}_{fault}_rank{rank}.json").write_text(
            json.dumps(info))
        del res


def _digests(lora) -> list:
    """Per local slot, the sha256 of its entries of every adapter leaf
    ({target: {"A", "B"}: [L, Z/d, ...]}), leaf by leaf in order."""
    import hashlib
    leaves = [lora[t][k] for t in sorted(lora) for k in sorted(lora[t])]
    out = []
    for z in range(leaves[0].shape[1]):
        h = hashlib.sha256()
        for v in leaves:
            h.update(v[:, z].float().contiguous().cpu().numpy().tobytes())
        out.append(h.hexdigest())
    return out


def _pod_job(spec: dict, dev, meshes: dict) -> None:
    """Phase 39's pod job ``spec["kind"]`` (``AP_POD_JOBS``) on its
    ("pod", "data", "model") mesh (kept in ``meshes`` by shape), sound and
    with each of its faults (``_planted_pod``). "pod_train" / "pod_moe":
    ``launch.train.run`` at ``spec["load"]``, AP_STEPS steps and the eval
    step, written by ``launch.train.write_out`` (``<job>_<fault>.npz``);
    "pod_serve": ``ap_serve`` of job (ii)'s inputs fed ``spec["feed"]``,
    with the idle step in the sound run, each (pod, data) rank's first
    model rank writing its logits (``<job>_<fault>_rank<r>.npz``). Every
    rank writes ``<job>_<fault>_rank<r>.json``: its launches, its
    collective records (axis, role, kind, bytes), and for the train jobs
    its adapters' bytes and per-slot digests (``_digests``), for the
    serving job its idle readings."""
    import numpy as np
    import torch

    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as TRAIN
    out, job = Path(spec["out"]), spec["kind"]
    _, _, shape, faults = AP_POD_JOBS[job]
    if shape not in meshes:
        meshes[shape] = MESH.make_local_mesh(shape, AP_POD_AXES, device=dev)
    mesh = meshes[shape]
    rank = torch.distributed.get_rank()
    first = mesh.get_local_rank("model") == 0
    if job == "pod_serve":
        cfg, params, lora, batch, ranks = _serve_inputs(
            torch, dev, spec["reduced"], "stablelm")
        feed = torch.load(spec["feed"], map_location=dev)
    else:
        cfg = _job_config(job, spec["reduced"])
    for fault in ("none", *faults):
        planted = (contextlib.nullcontext() if fault == "none"
                   else _planted_pod((fault,)))
        with planted:
            if job == "pod_serve":
                res = ap_serve(torch, cfg, mesh, params, lora, batch, ranks,
                               AP_SERVE_DECODES, per_lane=True, grow=True,
                               feed=feed, idle=AP_IDLE_LANES
                               if fault == "none" else None)
                info = {k: res[k] for k in ("launches", "idle_changed",
                                            "live_changed") if k in res}
                info["log"] = [(c["axis"], c["role"], c["kind"], c["bytes"])
                               for log in res["log"].values() for c in log]
                if first:
                    got = {"logits": res["logits"].cpu().numpy()}
                    if "idle_logits" in res:
                        got["idle_logits"] = res["idle_logits"].float(
                            ).cpu().numpy()
                    np.savez(out / f"{job}_{fault}_rank{rank}.npz", **got)
            else:
                Z, b, S = spec["load"]
                res = TRAIN.run(cfg, Z, b, S, mesh, AP_STEPS, ranks=RANKS,
                                device=dev,
                                log=lambda m: print(f"{job} {fault}: {m}"))
                TRAIN.write_out(str(out / f"{job}_{fault}.npz"), mesh, res)
                info = {k: res[k] for k in ("launches", "eval_launches")}
                info["log"] = [(c.axis, c.role, c.kind, c.bytes)
                               for c in res["collectives"]]
                info["slots"] = _digests(res["lora"])
                info["lora_bytes"] = sum(
                    v.numel() * v.element_size()
                    for ab in res["lora"].values() for v in ab.values())
        (out / f"{job}_{fault}_rank{rank}.json").write_text(
            json.dumps(info))
        del res


def _uneven_job(spec: dict, dev, meshes: dict) -> None:
    """Phase 39's uneven job ``spec["kind"]`` (``AP_UNEVEN_JOBS``) on its
    ("data", "model") mesh (kept in ``meshes`` by shape), sound and with its
    fault (``_planted_uneven``; phase 36's ``_planted_moe`` for
    "route_blind"). The train jobs: ``launch.train.run`` at
    ``spec["load"]``, AP_STEPS steps and (but "ragged_model") the eval
    step, written by ``launch.train.write_out`` (``<job>_<fault>.npz``);
    "ragged_model" with every slot at r_max, nothing but its rows bound
    (``widths`` AP_RAGGED_WIDTHS), the others at RANKS. "scan_whole_serve":
    ``ap_serve`` of job (v)'s inputs fed ``spec["feed"]``, with the idle
    step in the sound run, which keeps its cache shards
    (``cache_<job>_rank<r>.pt``), each data rank's first model rank
    writing its logits (``<job>_<fault>_data<i>.npz``). Every rank writes
    ``<job>_<fault>_rank<r>.json``: its launches and its collective
    records (axis, role, kind, bytes), and for the serving job its idle
    readings."""
    import numpy as np
    import torch

    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as TRAIN
    out, job = Path(spec["out"]), spec["kind"]
    _, _, shape, _, faults, _ = AP_UNEVEN_JOBS[job]
    if shape not in meshes:
        meshes[shape] = MESH.make_local_mesh(shape, ("data", "model"),
                                             device=dev)
    mesh = meshes[shape]
    rank = torch.distributed.get_rank()
    first = mesh.get_local_rank("model") == 0
    data = mesh.get_local_rank("data")
    cfg = _job_config(job, spec["reduced"])
    if job == "scan_whole_serve":
        cfg, params, lora, batch, ranks = _serve_inputs(
            torch, dev, spec["reduced"], "hymba")
        feed = torch.load(spec["feed"], map_location=dev)
    for fault in ("none", *faults):
        if fault == "none":
            planted = contextlib.nullcontext()
        elif fault == "route_blind":
            last = cfg.num_layers - 1
            planted = _planted_moe((fault,), min(AP_MOE_ROUTE_LAYER, last),
                                   min(AP_MOE_SLICE_LAYER, last))
        else:
            planted = _planted_uneven((fault,))
        with planted:
            if job == "scan_whole_serve":
                res = ap_serve(torch, cfg, mesh, params, lora, batch, ranks,
                               AP_SERVE_DECODES, per_lane=True, grow=True,
                               feed=feed, idle=AP_IDLE_LANES
                               if fault == "none" else None)
                info = {k: res[k] for k in ("launches", "idle_changed",
                                            "live_changed") if k in res}
                info["log"] = [(c["axis"], c["role"], c["kind"], c["bytes"])
                               for log in res["log"].values() for c in log]
                if fault == "none":
                    torch.save(res["cache"], out / f"cache_{job}_rank{rank}"
                               ".pt")
                if first:
                    got = {"logits": res["logits"].cpu().numpy()}
                    if "idle_logits" in res:
                        got["idle_logits"] = res["idle_logits"].float(
                            ).cpu().numpy()
                    np.savez(out / f"{job}_{fault}_data{data}.npz", **got)
            else:
                ragged = job == "ragged_model"
                Z, b, S = spec["load"]
                res = TRAIN.run(cfg, Z, b, S, mesh, AP_STEPS,
                                ranks=None if ragged else RANKS,
                                rank=cfg.lora.r_max, device=dev,
                                widths=AP_RAGGED_WIDTHS if ragged else None,
                                log=lambda m: print(f"{job} {fault}: {m}"))
                TRAIN.write_out(str(out / f"{job}_{fault}.npz"), mesh, res)
                info = {k: res[k] for k in ("launches", "eval_launches")
                        if k in res}
                info["log"] = [(c.axis, c.role, c.kind, c.bytes)
                               for c in res["collectives"]]
        (out / f"{job}_{fault}_rank{rank}.json").write_text(
            json.dumps(info))
        del res


def ap_fault_child(argv) -> int:
    """One rank of phases 35-38's planted-fault pool (``chip_smoke.py
    --ap-faults <dir> --device <d> --backend <b>``, AP_PROCS ranks in
    ``_ap_env``'s torchrun-style environment, started once by ``ApRuns``):
    for k = 0, 1, ... it waits for ``<dir>/job<k>.json`` (``ApRuns.faults``:
    a sharded run's launcher flags, its fault runs, its output directory)
    and runs the job (``_fault_job``), frees what it can of the card, then
    writes what it still holds there to ``<dir>/done<k>_<rank>``; it ends
    when ``<dir>/end`` exists and no job is waiting."""
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--ap-faults", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import mesh as MESH
    jobs, meshes = Path(args.ap_faults), {}
    with MESH.process_group(args.device, backend=args.backend) as dev:
        require(dev.type == args.device.split(":")[0], f"device {dev}")
        rank, k = torch.distributed.get_rank(), 0
        while True:
            job = jobs / f"job{k}.json"
            while not job.exists():
                if (jobs / "end").exists():
                    return 0
                time.sleep(0.05)
            spec = json.loads(job.read_text())
            (_pool_job if "kind" in spec else _fault_job)(spec, dev, meshes)
            gc.collect()            # the steps' graphs: the next run's
            if dev.type == "cuda":  # weights need the card
                torch.cuda.empty_cache()
                held = (f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} "
                        f"GiB allocated, "
                        f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} "
                        f"reserved")
            else:
                held = "on the CPU"
            (jobs / f"held{k}_{rank}").write_text(held)
            (jobs / f"held{k}_{rank}").rename(jobs / f"done{k}_{rank}")
            k += 1


def _fault_job(spec: dict, dev, meshes: dict) -> None:
    """One job of the fault pool: for each of ``spec["faults"]`` in turn
    (a comma-separated list of faults, or "none": a sound control), the
    steps of ``spec["args"]`` (the launcher's flags and ``--dtype``) under
    the faults it names (``_planted``: the dense family's two;
    ``_planted_moe``: MoE's; ``_planted_ssm``: the ssm and hybrid
    families'; ``_planted_modal``: the vlm family's), the losses, eval
    losses and adapters written by rank 0 to
    ``<spec["out"]>/faults_<a+b>.npz``. ``meshes`` keeps each mesh built."""
    import argparse

    from repro_torch.launch import train as TRAIN
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    for flag in ("--slots", "--batch", "--seq", "--steps"):
        ap.add_argument(flag, type=int, required=True)
    for flag in ("--ranks", "--mesh", "--backend", "--device"):
        ap.add_argument(flag, required=True)
    args = ap.parse_args(spec["args"])
    cfg = _ap_config(args.reduced, args.arch, args.layers, args.dtype)
    ranks = [int(r) for r in args.ranks.split(",")]
    if args.mesh not in meshes:
        meshes[args.mesh] = TRAIN.build_mesh(args.mesh, dev)
    mesh, last = meshes[args.mesh], cfg.num_layers - 1
    for run in spec["faults"]:
        faults = run.split(",")
        if faults == ["none"]:
            planted = contextlib.nullcontext()
        elif cfg.is_moe:
            planted = _planted_moe(faults, min(AP_MOE_ROUTE_LAYER, last),
                                   min(AP_MOE_SLICE_LAYER, last))
        elif cfg.family in ("ssm", "hybrid"):
            planted = _planted_ssm(faults, min(AP_SSM_FAULT_LAYER, last))
        elif cfg.family == "vlm":
            planted = _planted_modal(faults)
        else:
            planted = _planted(min(AP_FAULT_LAYER, last))
        with planted:
            res = TRAIN.run(cfg, args.slots, args.batch, args.seq, mesh,
                            args.steps, ranks=ranks, device=dev,
                            log=lambda m: print(f"faults: {m}"))
        TRAIN.write_out(str(Path(spec["out"]) / f"faults_{'+'.join(faults)}"
                            ".npz"), mesh, res)
        del res


def _ap_order() -> list:
    """Phases 35-38's sharded runs, (config, steps, load), in the order the
    phases take them."""
    return [(_ap_config(False, layers=AP_LAYERS), AP_STEPS, AP_LOAD),
            (_ap_config(False, AP_MOE_ARCH), AP_STEPS, AP_LOAD),
            (_ap_config(False, AP_LLAMA4_ARCH, AP_LLAMA4_LAYERS),
             AP_LLAMA4_STEPS, AP_LOAD),
            (_ap_config(False, AP_RWKV_ARCH, AP_RWKV_LAYERS), AP_STEPS,
             AP_RWKV_LOAD),
            (_ap_config(False, AP_HYMBA_ARCH, AP_HYMBA_LAYERS), AP_STEPS,
             AP_HYMBA_LOAD),
            (_ap_config(False, AP_AUDIO_ARCH, AP_AUDIO_LAYERS), AP_STEPS,
             AP_AUDIO_LOAD),
            (_ap_config(False, AP_QWEN_ARCH, AP_QWEN_LAYERS), AP_STEPS,
             AP_QWEN_LOAD)]


class ApRuns:
    """Phases 35-38's sharded runs, in ``order`` (each (config, steps,
    load)), and one pool of AP_PROCS planted-fault ranks for all of them.

    A run's AP_PROCS launcher ranks start when the previous run's ranks
    have ended (``start_next``), so that their start-up (~14 s of imports
    a process on the card's host) overlaps that run's controls, unless
    their weights are too large for that (AP_EARLY_BYTES); the others',
    and the pool's, start at the run's ``take``. A fault job
    (``faults``) is given to the pool only once its run's launcher ranks
    have ended: the main path has the card to itself unless the previous
    run's controls outlast its start-up (``ap_train_phase`` prints which).
    With ``reduced`` every run is its config's tiny fp32 variant (the
    launcher's ``--reduced``; on the CPU, a check of this machinery)."""

    def __init__(self, order, device: str = "cuda", reduced: bool = False):
        self.order, self.device, self.reduced = list(order), device, reduced
        self.dir = Path(tempfile.mkdtemp(prefix="ap_runs_"))
        self.taken, self.jobs = 0, 0
        self.next = self.pool = None
        self.t_next = self.lead = 0.0

    @staticmethod
    def _key(cfg, steps, load):
        return cfg.name, cfg.num_layers, cfg.dtype, steps, tuple(load)

    def _start(self, i: int):
        cfg, steps, load = self.order[i]
        out = Path(tempfile.mkdtemp(prefix="ap_run_", dir=self.dir))
        return _ap_start([sys.executable, "-m", "repro_torch.launch.train",
                          *_ap_args(cfg, self.reduced, self.device, steps,
                                    load),
                          "--out", str(out / "ap.npz")], out, "rank")

    def take(self, cfg, steps: int, load):
        """The launcher ranks of the next run, which must be ``cfg`` at
        ``steps`` and ``load``: started by ``start_next``, or now."""
        i = self.taken
        require(i < len(self.order)
                and self._key(*self.order[i]) == self._key(cfg, steps, load),
                f"ap: {cfg.name} is not run {i} of {len(self.order)}")
        self.taken += 1
        if self.device == "cuda":
            import torch
            free, total = torch.cuda.mem_get_info()
            print(f"ap: the card has {free / 2**30:.2f} of "
                  f"{total / 2**30:.2f} GiB free as {cfg.name}'s run is "
                  f"taken")
        now = time.perf_counter()
        self.lead = now - self.t_next if self.next is not None else 0.0
        started, self.next = self.next or self._start(i), None
        self._start_pool()
        return started

    def _start_pool(self) -> None:
        if self.pool is None:
            self.pool = _ap_start(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--ap-faults",
                 str(self.dir), "--device", self.device, "--backend",
                 "gloo"], self.dir, "fault")

    def start_next(self) -> None:
        """Start the following run's launcher ranks, if one is left and
        its ranks' weights are small enough (AP_EARLY_BYTES)."""
        from repro_torch.launch.train import init_bytes
        if self.taken < len(self.order):
            cfg = self.order[self.taken][0]
            if AP_PROCS * init_bytes(cfg) <= AP_EARLY_BYTES:
                self.next = self._start(self.taken)
                self.t_next = time.perf_counter()

    def next_stage(self) -> str:
        """How far the following run's ranks have come: "none" (no run
        left), "starting", "set up" or "stepping"."""
        if self.next is None:
            return "none"
        text = (self.next[2] / "rank0.log").read_text()
        lines = [ln.split()[0] for ln in text.splitlines() if ln.strip()]
        return ("stepping" if "step" in lines else
                "set up" if "set-up" in lines else "starting")

    def faults(self, runs, cfg, steps: int, load, out: Path) -> int:
        """Give the pool ``runs`` (each a list of faults; empty: a sound
        run) of ``cfg`` at ``steps`` and ``load``, their files to ``out``.
        Returns the job's number for ``wait``."""
        return self.job({"faults": [",".join(r) or "none" for r in runs],
                         "args": _ap_args(cfg, self.reduced, self.device,
                                          steps, load)
                         + ["--dtype", cfg.dtype],
                         "out": str(out)})

    def job(self, spec: dict) -> int:
        """Give the pool the job ``spec`` (``_fault_job``'s, or with a
        "kind" ``_pool_job``'s); returns its number for ``wait``."""
        self._start_pool()
        k, self.jobs = self.jobs, self.jobs + 1
        tmp = self.dir / f"job{k}.tmp"
        tmp.write_text(json.dumps(spec))
        tmp.rename(self.dir / f"job{k}.json")
        return k

    def wait(self, k: int) -> None:
        """Wait for job ``k`` on every rank of the pool; the pool is killed
        if a rank fails or the time runs out."""
        procs = self.pool[0]
        done = [self.dir / f"done{k}_{r}" for r in range(AP_PROCS)]
        deadline = time.perf_counter() + AP_TIMEOUT_S
        while not all(f.exists() for f in done):
            if (time.perf_counter() > deadline
                    or any(p.poll() is not None for p in procs)):
                _ap_kill(self.pool)
                texts = [(self.dir / f"fault{r}.log").read_text()[-3000:]
                         for r in range(AP_PROCS)]
                require(False, f"ap fault job {k}: ranks exited "
                        f"{[p.returncode for p in procs]}:\n{texts}")
            time.sleep(0.2)
        print(f"ap fault job {k}: the pool's ranks hold "
              f"{[f.read_text() for f in done]} of the card")

    def close(self, ok: bool = True) -> None:
        """End the pool (with ``ok``, let it exit and check that it did;
        else kill it) and kill the following run's ranks if they were
        started but never taken."""
        try:
            if self.next is not None:
                _ap_kill(self.next)
            if self.pool is not None:
                if ok:
                    (self.dir / "end").touch()
                    _ap_wait(self.pool)
                else:
                    _ap_kill(self.pool)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)


def _ap_config(reduced: bool, arch: str = "stablelm-3b", layers=None,
               dtype=None):
    """``arch``'s config as the launcher builds it: ``--reduced`` (the tiny
    fp32 variant) or full width, cut to ``layers`` (``--layers``), in
    ``dtype`` (``--dtype``; the config's by default)."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch)
    if reduced:
        return dataclasses.replace(cfg.reduced(), dtype="float32")
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def _ap_readings(np, got: dict, want: dict, init: dict, slots):
    """(largest relative loss difference of ``slots`` over the steps,
    largest per-leaf, per-slot relative RMS adapter difference of
    ``slots``: the RMS of got - want over the RMS of want - init)."""
    gl = np.asarray(got["losses"])[:, list(slots)]
    wl = np.asarray(want["losses"])[:, list(slots)]
    loss = float((np.abs(gl - wl) / np.abs(wl)).max())
    worst, where = 0.0, None
    for key, w in want.items():
        if not key.startswith("lora/"):
            continue
        g, w0 = got[key], init[key]
        for z in slots:
            step = np.sqrt(np.mean((w[:, z] - w0[:, z]) ** 2))
            if step == 0:
                continue
            r = float(np.sqrt(np.mean((g[:, z] - w[:, z]) ** 2)) / step)
            if r > worst:
                worst, where = r, f"{key}[slot {z}]"
    print(f"ap: largest adapter reading {worst:.3e} at {where}")
    return loss, worst


def _ap_eval(np, got, want, slots) -> float:
    """The largest relative difference of ``slots``' per-slot eval losses
    ``got`` (a sharded eval step's) from ``want`` (the one-rank eval step's
    on the same adapters)."""
    g, w = np.asarray(got)[list(slots)], np.asarray(want)[list(slots)]
    return float((np.abs(g - w) / np.abs(w)).max())


def _lora_tree(torch, tree: dict) -> dict:
    """The adapters of ``tree`` (every slot's "lora/<target>/<A|B>", as
    ``launch.train.write_out`` writes them) as {target: {"A", "B"}}."""
    lora = {}
    for key, v in tree.items():
        if key.startswith("lora/"):
            _, t, k = key.split("/")
            lora.setdefault(t, {})[k] = torch.from_numpy(v)
    return lora


def _ap_parse(text: str, what: str):
    lines = [ln for ln in text.splitlines() if ln.startswith(what + " ")]
    require(len(lines) == 1, f"ap: {len(lines)} '{what}' lines")
    return json.loads(lines[0][len(what) + 1:])


def _moe_drops(cfg, d: int):
    """A context that reads, from the first forward of the one-rank run,
    each MoE layer's dropped share of the choices of each of ``d`` data
    ranks' token rows (Z-major, as the sharded step splits them); the
    shares land in the list it yields, one [d] row a layer."""
    from repro_torch.models import moe as MOE

    @contextlib.contextmanager
    def ctx():
        shares, real = [], MOE.route

        def tapped(*args, **kw):
            out = real(*args, **kw)
            if len(shares) < cfg.num_layers:
                keep = out[3].reshape(-1).float()
                shares.append([round(1.0 - float(part.mean()), 6)
                               for part in keep.chunk(d)])
            return out

        MOE.route = tapped
        try:
            yield shares
        finally:
            MOE.route = real

    return ctx()


def _run_init(torch, cfg, dev, ranks=RANKS) -> dict:
    """The initial adapters of ``launch.train.run``'s seed-0 run of ``cfg``
    at ``ranks``, every slot's, as numpy ("lora/<target>/<A|B>")."""
    from repro_torch.core import lora as LORA
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(1)  # seed + 1
    ranks_t = torch.tensor(ranks, dtype=torch.int32, device=dev)
    return {f"lora/{t}/{k}": v.cpu().numpy() for t, ab in
            LORA.init_lora_tree(gen, cfg, len(RANKS), ranks_t,
                                M.target_shapes(cfg)).items()
            for k, v in ab.items()}


def ap_train_phase(torch, runs: ApRuns, cfg, kernel_checks=None, *,
                   steps: int = AP_STEPS, fault_runs=(AP_FAULT_SLOTS,),
                   bars=(AP_LOSS_REL, AP_ADAPTER_REL),
                   tag: str = "ap", load=AP_LOAD,
                   fault_reads=("loss", "adapters"), fault_cfg=None,
                   fault_bars=None) -> dict:
    """Phase 35's, 36's and 37's runs at ``load`` (Z, b, S): AP_PROCS
    processes of ``python -m
    repro_torch.launch.train --mesh 2x2 --backend gloo`` (the main path;
    ``runs.take``: started when the previous run's ended, or now); while
    they start up, ``kernel_checks()`` runs here; the main path then has
    the card to itself; after it, the next run's ranks start
    (``runs.start_next``) and the fault pool runs each of ``fault_runs``
    in turn (each {fault: the slots it reaches}, planted together) beside
    the one-rank reference (``launch.train.run`` on a one-rank group;
    before it where the fault ranks' weights are too large to share the
    card with it, AP_EARLY_BYTES), and
    every sharded run is held against the reference: the main path within
    ``bars`` (loss, adapters), each fault past the bars of ``fault_reads``
    on its own slots (both, unless the adapter reading is only a bound on
    the noise: RWKV's). Each run ends with one sharded eval step
    (``launch.train.run``), whose per-slot losses are held within the
    run's loss bar of the one-rank run's eval step on the same adapters
    (its ``eval_trees``: the one-rank run evaluates the sharded runs'
    adapters on its own weights and eval batch); a fault whose loss reads
    past its loss bar must read AP_EVAL_FAULT_X times the sound eval
    reading (but AP_EVAL_UNSEEN). With ``fault_cfg`` (RWKV's fp32 check
    beside its bf16 main path) the fault ranks run that config instead,
    first sound, held against its own one-rank run within ``fault_bars``,
    then each fault, read against that run and those bars. An MoE config's one-rank
    run prints each layer's dropped share of each data rank's choices.
    Returns {"launches": the kernel launches summed over the ranks,
    "seconds": the phase's parts (``started_before``: how long before the
    run was taken its ranks started), "drops": the dropped shares by
    layer, "one_rank": {"want": the one-rank run's losses, adapters,
    evals and own eval ("eval_own"), "init": its initial adapters}, which
    phase 39's pod jobs are read against}."""
    import numpy as np
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import train as TRAIN

    loss_bar, adapter_bar = bars
    device = runs.device
    d = int(AP_MESH.split("x")[0])
    Z, b, S = load
    seconds, drops = {}, []
    fcfg = fault_cfg or cfg
    # the fault ranks' runs: with a config of their own, a sound one first
    frs = ([{}] if fcfg is not cfg else []) + list(fault_runs)
    fault_bars = fault_bars or bars
    t = time.perf_counter()
    sharded = runs.take(cfg, steps, load)
    out = sharded[2]
    seconds["started_before"] = runs.lead
    try:
        if kernel_checks is not None:
            kernel_checks()
            print(f"{tag}: kernel checks done {time.perf_counter() - t:.1f} "
                  f"s after the run was taken")
        texts = _ap_wait(sharded)
        seconds["sharded"] = time.perf_counter() - t
        got = dict(np.load(out / "ap.npz"))
        # the fault ranks run beside the one-rank run unless, drawing their
        # full weights, they would crowd it off the card (AP_EARLY_BYTES):
        # then before it, and the next run's ranks start only after it
        beside = AP_PROCS * TRAIN.init_bytes(fcfg) <= AP_EARLY_BYTES
        if beside or not frs:
            runs.start_next()
        # the controls' timing is not read: the fault ranks and the
        # one-rank reference share the card
        t = time.perf_counter()
        if frs and not beside:
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()
        job = runs.faults(frs, fcfg, steps, load, out) if frs else None
        if job is not None and not beside:
            runs.wait(job)

        def fault_trees():
            """The fault runs' adapters, once the pool has written them."""
            if beside:
                runs.wait(job)
            return [_lora_tree(torch, dict(np.load(
                out / f"faults_{'+'.join(run) or 'none'}.npz")))
                for run in frs]

        def one_rank(c, tap, label, trees):
            """(the one-rank run's losses, adapters and its evals of the
            adapter trees ``trees()`` on its weights and eval batch, its
            initial adapters) of config ``c``."""
            with MESH.process_group(device) as dev, tap as seen:
                mesh = MESH.make_local_mesh((1, 1), device=dev)
                one = TRAIN.run(c, Z, b, S, mesh, steps,
                                ranks=RANKS, device=dev, eval_trees=trees,
                                log=lambda m: print(f"{label}: {m}"))
            drops.extend(seen)
            want = {"losses": np.asarray(one["losses"]),
                    "evals": [np.asarray(e) for e in one["evals"]],
                    "eval_own": np.asarray(one["eval"])}
            want.update({f"lora/{t}/{k}": v.float().cpu().numpy()
                         for t, ab in one["lora"].items()
                         for k, v in ab.items()})
            del one
            return want, _run_init(torch, c, dev), dev

        # the one-rank eval step on the adapters each sharded eval took:
        # the main path's, then (on the config they ran) the fault runs'
        mine = [_lora_tree(torch, got)]
        want, init, dev = one_rank(
            cfg, _moe_drops(cfg, d) if cfg.is_moe
            else contextlib.nullcontext([]), f"{tag} 1x1",
            lambda: mine + (fault_trees() if fcfg is cfg and frs else []))
        fwant, finit, fevals = want, init, want["evals"][1:]
        if fcfg is not cfg:
            fwant, finit, _ = one_rank(fcfg, contextlib.nullcontext([]),
                                       f"{tag} {fcfg.dtype} 1x1",
                                       fault_trees)
            fevals = fwant["evals"]
        if frs and not beside:
            runs.start_next()
        seconds["one_rank_and_faults"] = time.perf_counter() - t
        print(f"{tag}: the controls ended with the next run's ranks "
              f"{runs.next_stage()}")
        want["eval"] = want["evals"][0]
        bad = [(run, dict(np.load(
            out / f"faults_{'+'.join(run) or 'none'}.npz"))) for run in frs]
        for (_, faults), ev in zip(bad, fevals):
            faults["one_rank_eval"] = ev
    finally:
        _ap_kill(sharded)
        shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    r_max = cfg.lora.r_max
    weight_dims = _weight_last_dims(cfg)
    launches, eval_launches = {}, {}
    for r, text in enumerate(texts):
        require(f"device={device}" in text, f"{tag} rank {r}: device")
        for what, into in (("launches", launches),
                           ("eval launches", eval_launches)):
            for fam, ks in _ap_parse(text, what).items():
                for k, v in ks.items():
                    into.setdefault(fam, {}).setdefault(k, 0)
                    into[fam][k] += v
        shapes = _ap_parse(text, "collective shapes")
        # a base weight's gather is as wide as a base weight; nothing else
        # over "data" is r_max wide
        bad_shapes = [s for s in shapes if s[0] == "data" and (
            s[1] == "adapter_grad"
            or s[1] == "base_weight" and s[3] not in weight_dims
            or s[1] != "base_weight" and s[3] == r_max)]
        require(not bad_shapes, f"{tag} rank {r}: adapter collectives over "
                f"data {bad_shapes}")
        require(any(s[0] == "model" and s[1] == "adapter_grad"
                    for s in shapes), f"{tag} rank {r}: no model-axis "
                "adapter-gradient all-reduce")
        moved = _ap_parse(text, "collective bytes")
        roles = set(moved.get("data", {}))
        require(roles <= {"base_weight", "metric", "route"},
                f"{tag} rank {r}: data-axis roles {roles}")
        step_s = [float(ln.split()[2].rstrip("s"))
                  for ln in text.splitlines() if ln.startswith("step ")]
        setup = [ln for ln in text.splitlines() if ln.startswith("set-up ")]
        peak = [ln for ln in text.splitlines()
                if ln.startswith(("peak ", "eval peak "))]
        print(f"{tag} rank {r}: {setup[0] if setup else ''}; steps {step_s} "
              f"s, {'; '.join(peak)}; logged bytes {moved}")
    for layer, share in enumerate(drops):
        print(f"{tag}: layer {layer} dropped share by data rank {share}")
    loss, adapters = _ap_readings(np, got, want, init, range(Z))
    ev = _ap_eval(np, got["eval"], want["eval"], range(Z))
    print(f"{tag}: eval step after the steps, {AP_MESH} vs 1x1 on the same "
          f"adapters: reading {ev:.3e} (bar {loss_bar}); per-slot eval "
          f"losses {got['eval'].tolist()} vs {want['eval'].tolist()}")
    require(ev <= loss_bar, f"{tag}: eval reading {ev} past the bar")
    sound = ev        # the sound eval reading of the fault ranks' config
    print(f"{tag}: {AP_MESH} vs 1x1, {cfg.name} {cfg.num_layers} layers, "
          f"Z {Z}, b {b}, S {S}, ranks {RANKS}, {steps} steps: "
          f"loss reading {loss:.3e} (bar {loss_bar}), adapter reading "
          f"{adapters:.3e} (bar {adapter_bar}); losses "
          f"{got['losses'].tolist()} vs {want['losses'].tolist()}")
    require(loss <= loss_bar and adapters <= adapter_bar,
            f"{tag}: readings {loss}, {adapters} past the bars")
    for run, faults in bad:
        if not run:                 # the fault ranks' own sound run
            fl, fa = _ap_readings(np, faults, fwant, finit, range(Z))
            fe = _ap_eval(np, faults["eval"], faults["one_rank_eval"],
                          range(Z))
            print(f"{tag}: {fcfg.dtype} at {fcfg.num_layers} layers, "
                  f"{AP_MESH} vs 1x1: loss reading {fl:.3e} (bar "
                  f"{fault_bars[0]}), adapter reading {fa:.3e} (bar "
                  f"{fault_bars[1]}), eval reading {fe:.3e} (bar "
                  f"{fault_bars[0]})")
            require(fl <= fault_bars[0] and fa <= fault_bars[1]
                    and fe <= fault_bars[0],
                    f"{tag}: {fcfg.dtype} readings {fl}, {fa}, {fe} past "
                    f"the bars")
            sound = fe
        for fault, slots in run.items():
            fl, fa = _ap_readings(np, faults, fwant, finit, slots)
            fe = _ap_eval(np, faults["eval"], faults["one_rank_eval"],
                          slots)
            seen = fault not in AP_EVAL_UNSEEN
            print(f"{tag}: planted fault {fault}: loss reading {fl:.3e}, "
                  f"adapter reading {fa:.3e}, eval reading {fe:.3e}, "
                  f"{fe / sound if sound else float('inf'):.1f}x the "
                  f"sound eval reading {sound:.3e} "
                  f"(must pass the {' and '.join(fault_reads)} bar"
                  + (f"; the eval {AP_EVAL_FAULT_X}x the sound one where "
                     f"the loss does)" if seen else "; not read on the "
                     "eval, AP_EVAL_UNSEEN)"))
            past = {"loss": fl > fault_bars[0],
                    "adapters": fa > fault_bars[1]}
            require(all(past[r] for r in fault_reads),
                    f"{tag}: planted fault {fault} within the bars ({fl}, "
                    f"{fa})")
            require(not (seen and past["loss"])
                    or fe >= AP_EVAL_FAULT_X * sound,
                    f"{tag}: planted fault {fault}: the train loss reads "
                    f"past its bar ({fl}), the eval ({fe}) not "
                    f"{AP_EVAL_FAULT_X}x the sound one ({sound})")
    print(f"{tag}: seconds {seconds}")
    return {"launches": launches, "eval_launches": eval_launches,
            "seconds": seconds, "drops": drops,
            "one_rank": {"want": want, "init": init}}


def _weight_last_dims(cfg) -> set:
    """The last dims of ``cfg``'s base weights as their gathers over "data"
    on AP_MESH give them (whole over "data", this rank's block over
    "model" where the rule splits them there; a tied unembedding is the
    embedding transposed)."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch import partitioning as PT
    shape = tuple(int(x) for x in AP_MESH.split("x"))
    amesh = MESH.abstract_mesh(shape, ("data", "model"))
    params, _, _ = DR.abstract_state(cfg, 1)
    dims = set()
    for path, leaf, spec in DR._leaves(params,
                                       PT.base_param_specs(amesh, params)):
        if not DR._names(spec, "data"):
            continue
        local = [n // shape[1] if i < len(spec) and spec[i] == "model"
                 else n for i, n in enumerate(leaf.shape)]
        dims.add(local[-1])
        if path == "embed" and cfg.tie_embeddings:
            dims.add(local[0])
    return dims


def _ap_launches(cfg, res: dict, steps: int, tag: str) -> None:
    """Every rank ran the rank-local set and the family's sequence kernels
    (flash, the scan) as the one-rank steps would, each step, and the
    forward ones as the one-rank eval step would in its eval (``res``:
    ``ap_train_phase``'s "launches" and "eval_launches"); nothing on the
    dense or ragged sets."""
    train, evals, (train_seq, eval_seq) = _step_launches(cfg)
    for what, want, want_seq, per in (
            ("launches", train, train_seq, AP_PROCS * steps),
            ("eval_launches", evals, eval_seq, AP_PROCS)):
        got, seq = res[what], _seq_counts(cfg, want_seq * per)
        require(got["rank-local"] == {k: v * per for k, v in want.items()}
                and got["flash"]["flash_attention"] == seq["flash_attention"]
                and got["scan"]["linear_scan"] == seq["linear_scan"]
                and not any(got["dense"].values())
                and not any(got["ragged"].values()),
                f"{tag}: {what} {got}, expected rank-local {want} and "
                f"{SEQ_KERNELS[cfg.family]} {want_seq} a step on each of "
                f"{AP_PROCS} ranks")
    print(f"{tag}: eval launches, summed over the ranks, "
          f"{res['eval_launches']}")


def ap_phase(torch, fams, runs: ApRuns) -> tuple:
    """Phase 35: rows 13-18 and flash at the sharded step's shapes, then
    ``ap_train_phase`` on full-width stablelm-3b at AP_LAYERS layers.
    Returns (the rank-local kernels' results, flash's, the launches of the
    sharded runs' ranks, summed, the one-rank run's results for phase 39's
    "pod_train")."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref

    cfg = _ap_config(False, layers=AP_LAYERS)
    d, ff = cfg.d_model, cfg.d_ff
    m = int(AP_MESH.split("x")[1])
    T = AP_B * AP_S
    lora, flash = {}, {}

    def kernel_checks():
        _merged(lora, backward_kernel_phase(
            torch, fams["rank-local"], ref, timed=("ap_row", d // m, d),
            untimed=("ap_col", "ap_ff"),
            cases=[("ap_col", T, d, d // m, RANKS, None),
                   ("ap_ff", T, d, ff // m, RANKS, None),
                   ("ap_row", T, d // m, d, RANKS, None),
                   ("ap_ff", T, ff // m, d, RANKS, None)]))
        H = cfg.num_heads // m
        _, cases = flash_kernel_phase(
            torch, FA, fref, cfg, plain_labels=("train",),
            cases=[("train", AP_Z // int(AP_MESH.split("x")[0]) * AP_B * H,
                    AP_S, AP_S, cfg.resolved_head_dim, 0, torch.bfloat16)])
        flash.update({f"ap_{k}": v for k, v in cases.items()})

    res = ap_train_phase(torch, runs, cfg, kernel_checks=kernel_checks)
    _ap_launches(cfg, res, AP_STEPS, "ap")
    return lora, flash, res["launches"], res["one_rank"]


def ap_moe_phase(torch, fams, runs: ApRuns) -> tuple:
    """Phase 36: rows 13-18 at granite-moe's 2 x 2 split (q 1,024 -> 512 and
    k/v 1,024 -> 256 column-parallel, o 512 -> 1,024 row-parallel, timed)
    and flash on a rank's 8 heads of hd 64 against their plain versions;
    then ``ap_train_phase`` on full-size granite-moe-1b-a400m with both
    planted faults, and on llama4-scout at full width and AP_LLAMA4_LAYERS
    layers, AP_LLAMA4_STEPS step, without. Returns (the rank-local
    kernels' results, flash's, the launches of granite's sharded ranks and
    of llama4's, summed over the ranks, granite's one-rank run's results
    for phase 39's "pod_moe")."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref

    cfg = _ap_config(False, AP_MOE_ARCH)
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    dd, m = (int(x) for x in AP_MESH.split("x"))
    T = AP_B * AP_S
    lora, flash = {}, {}

    def kernel_checks():
        _merged(lora, backward_kernel_phase(
            torch, fams["rank-local"], ref,
            timed=("apmoe_row", q // m, d), untimed=("apmoe_col",),
            cases=[("apmoe_col", T, d, q // m, RANKS, None),
                   ("apmoe_col", T, d, kv // m, RANKS, None),
                   ("apmoe_row", T, q // m, d, RANKS, None)]))
        H = cfg.num_heads // m
        _, cases = flash_kernel_phase(
            torch, FA, fref, cfg, plain_labels=("train",),
            cases=[("train", AP_Z // dd * AP_B * H, AP_S, AP_S,
                    cfg.resolved_head_dim, 0, torch.bfloat16)])
        flash.update({f"apmoe_{k}": v for k, v in cases.items()})

    res = ap_train_phase(torch, runs, cfg, kernel_checks=kernel_checks,
                         fault_runs=AP_MOE_FAULT_RUNS,
                         bars=(AP_MOE_LOSS_REL, AP_MOE_ADAPTER_REL),
                         tag="ap moe")
    route = res["drops"][min(AP_MOE_ROUTE_LAYER, cfg.num_layers - 1)]
    require(route[1] > 0, f"ap moe: data rank 1 drops no choice in layer "
            f"{AP_MOE_ROUTE_LAYER}: fault (a) would test nothing")
    _ap_launches(cfg, res, AP_STEPS, "ap moe")
    lcfg = _ap_config(False, AP_LLAMA4_ARCH, AP_LLAMA4_LAYERS)
    l4 = ap_train_phase(torch, runs, lcfg, steps=AP_LLAMA4_STEPS,
                        fault_runs=(),
                        bars=(AP_LLAMA4_LOSS_REL, AP_LLAMA4_ADAPTER_REL),
                        tag="ap llama4")
    _ap_launches(lcfg, l4, AP_LLAMA4_STEPS, "ap llama4")
    return lora, flash, res["launches"], l4["launches"], res["one_rank"]


def ap_ssm_phase(torch, fams, runs: ApRuns) -> tuple:
    """Phase 37: the ssm and hybrid families' sharded step. Rows 13-18 at
    each rank's shapes of a 2 x 2 split (rwkv6-3b: r/k/v/g 2,560 -> 1,280
    and ffn_k 2,560 -> 4,480 column-parallel, o 1,280 -> 2,560 and ffn_v
    4,480 -> 2,560 row-parallel; hymba-1.5b: in_proj 1,600 -> 2 x 1,600 in
    blocks, q/k/v whole 1,600 -> 1,600 / 320, o whole on a rank's 1,024
    rows, gate/up 1,600 -> 2,752, down 2,752 -> 1,600), row 20 (the scan on
    a rank's 20 RWKV heads of 64 at S 512, and on its 25 Mamba heads in SSD
    mode, K 16, at S 2,048) and row 19 (flash on hymba's whole 25 heads, 5
    KV heads of 64, window 1,024, S 2,048) against their plain versions,
    while the ranks start; then ``ap_train_phase`` on rwkv6-3b at full
    width and AP_RWKV_LAYERS layers in bf16 (its fault ranks run it in
    fp32 at AP_RWKV_CHECK_LAYERS layers, sound and with fault (a)), and on
    hymba-1.5b at full width and AP_HYMBA_LAYERS layers with fault (b).
    Returns (the rank-local kernels' results, flash's, the scan's, the
    launches of rwkv's and of hymba's sharded ranks, summed over the
    ranks, hymba's one-rank run for phase 39's "scan_whole")."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.kernels.linear_scan import ref as lsref
    from repro_torch.models.mamba import mamba_dims

    dd, m = (int(x) for x in AP_MESH.split("x"))
    bf16, RL = torch.bfloat16, fams["rank-local"]
    lora, flash, scan = {}, {}, {}

    rcfg = _ap_config(False, AP_RWKV_ARCH, AP_RWKV_LAYERS)
    Z, b, S = AP_RWKV_LOAD
    d, ff, hs = rcfg.d_model, rcfg.d_ff, rcfg.ssm.head_size
    T = b * S

    def rwkv_checks():
        _merged(lora, backward_kernel_phase(
            torch, RL, ref, timed=("aprwkv_row", d // m, d),
            untimed=("aprwkv_col", "aprwkv_ff"),
            cases=[("aprwkv_col", T, d, d // m, RANKS, None),
                   ("aprwkv_ff", T, d, ff // m, RANKS, None),
                   ("aprwkv_row", T, d // m, d, RANKS, None),
                   ("aprwkv_ff", T, ff // m, d, RANKS, None)]))
        _, cases = scan_kernel_phase(
            torch, LSK, lsref, rcfg, S=S,
            cases=[("train", Z // dd * b * rcfg.num_heads // m, hs, hs,
                    False, False, 1.0, bf16)])
        scan.update({f"aprwkv_{k}": v for k, v in cases.items()})

    rwkv = ap_train_phase(
        torch, runs, rcfg, kernel_checks=rwkv_checks,
        fault_runs=AP_RWKV_FAULT_RUNS,
        bars=(AP_RWKV_LOSS_REL, AP_RWKV_ADAPTER_REL), tag="ap rwkv",
        load=AP_RWKV_LOAD, fault_reads=("loss",),
        fault_cfg=_ap_config(False, AP_RWKV_ARCH, AP_RWKV_CHECK_LAYERS,
                             "float32"),
        fault_bars=(AP_RWKV_FP32_LOSS_REL, AP_RWKV_FP32_ADAPTER_REL))
    _ap_launches(rcfg, rwkv, AP_STEPS, "ap rwkv")
    gc.collect()
    torch.cuda.empty_cache()

    hcfg = _ap_config(False, AP_HYMBA_ARCH, AP_HYMBA_LAYERS)
    Z, b, S = AP_HYMBA_LOAD
    d, ff, q, kv = hcfg.d_model, hcfg.d_ff, hcfg.q_dim, hcfg.kv_dim
    inner, Hs, hs = mamba_dims(hcfg)
    T = b * S

    def hymba_checks():
        _merged(lora, backward_kernel_phase(
            torch, RL, ref, timed=("aphymba_in", d, 2 * inner // m),
            untimed=("aphymba_whole", "aphymba_ff"),
            cases=[("aphymba_in", T, d, 2 * inner // m, RANKS, None),
                   ("aphymba_whole", T, d, q, RANKS, None),
                   ("aphymba_whole", T, d, kv, RANKS, None),
                   ("aphymba_whole", T // m, q, d, RANKS, None),
                   ("aphymba_ff", T, d, ff // m, RANKS, None),
                   ("aphymba_ff", T, ff // m, d, RANKS, None)]))
        _, cases = flash_kernel_phase(
            torch, FA, fref, hcfg, plain_labels=("train",),
            cases=[("train", Z // dd * b * hcfg.num_heads, S, S,
                    hcfg.resolved_head_dim, hcfg.sliding_window, bf16)])
        flash.update({f"aphymba_{k}": v for k, v in cases.items()})
        _, cases = scan_kernel_phase(
            torch, LSK, lsref, hcfg, S=S,
            cases=[("train", Z // dd * b * Hs // m, hcfg.ssm.state_size, hs,
                    True, False, 1.0, bf16)])
        scan.update({f"aphymba_{k}": v for k, v in cases.items()})

    hymba = ap_train_phase(torch, runs, hcfg, kernel_checks=hymba_checks,
                           fault_runs=AP_HYMBA_FAULT_RUNS,
                           bars=(AP_HYMBA_LOSS_REL, AP_HYMBA_ADAPTER_REL),
                           tag="ap hymba", load=AP_HYMBA_LOAD)
    _ap_launches(hcfg, hymba, AP_STEPS, "ap hymba")
    return (lora, flash, scan, rwkv["launches"], hymba["launches"],
            hymba["one_rank"])


def ap_modal_phase(torch, fams, runs: ApRuns) -> tuple:
    """Phase 38: the vlm and audio families' sharded step. Rows 13-18 at
    each rank's shapes of a 2 x 2 split and row 19 on a rank's heads
    (qwen2-vl-72b: 32 heads and 4 KV heads of 128 at S 384; musicgen: 12
    heads of 64 at S 512) against their plain versions while each run's
    ranks start; then ``ap_train_phase`` on musicgen-medium at full width
    and AP_AUDIO_LAYERS layers (its ranks start during phase 37's last
    controls), and on qwen2-vl-72b at full width and AP_QWEN_LAYERS
    layers, its batches holding the launcher's 256-patch prefix and
    per-slot M-RoPE positions, with faults (c) and (d). Returns (the
    rank-local kernels' results, flash's, the launches of qwen2-vl's and
    of musicgen's sharded ranks, summed over the ranks)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref

    dd, m = (int(x) for x in AP_MESH.split("x"))
    bf16, RL = torch.bfloat16, fams["rank-local"]
    lora, flash = {}, {}

    def checks(cfg, load, tag):
        """Rows 13-18 at ``cfg``'s column- and row-parallel shapes on one
        rank (o timed) and flash on its heads, at ``load`` (Z, b, S)."""
        Z, b, S = load
        d, q, kv, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff
        T = b * S

        def run():
            _merged(lora, backward_kernel_phase(
                torch, RL, ref, timed=(f"{tag}_row", q // m, d),
                untimed=(f"{tag}_col", f"{tag}_ff"),
                cases=[(f"{tag}_col", T, d, q // m, RANKS, None),
                       (f"{tag}_col", T, d, kv // m, RANKS, None),
                       (f"{tag}_ff", T, d, ff // m, RANKS, None),
                       (f"{tag}_row", T, q // m, d, RANKS, None),
                       (f"{tag}_ff", T, ff // m, d, RANKS, None)]))
            _, cases = flash_kernel_phase(
                torch, FA, fref, cfg, plain_labels=("train",),
                cases=[("train", Z // dd * b * cfg.num_heads // m, S, S,
                        cfg.resolved_head_dim, 0, bf16)])
            flash.update({f"{tag}_{k}": v for k, v in cases.items()})

        return run

    acfg = _ap_config(False, AP_AUDIO_ARCH, AP_AUDIO_LAYERS)
    audio = ap_train_phase(
        torch, runs, acfg,
        kernel_checks=checks(acfg, AP_AUDIO_LOAD, "apaudio"), fault_runs=(),
        tag="ap audio", load=AP_AUDIO_LOAD)
    _ap_launches(acfg, audio, AP_STEPS, "ap audio")
    gc.collect()
    torch.cuda.empty_cache()

    qcfg = _ap_config(False, AP_QWEN_ARCH, AP_QWEN_LAYERS)
    require(qcfg.input_mode == "mixed"
            and AP_QWEN_LOAD[2] // m < qcfg.num_modality_tokens,
            f"ap vlm: the {qcfg.num_modality_tokens}-patch prefix must span "
            f"the model ranks' blocks of {AP_QWEN_LOAD[2] // m}")
    qwen = ap_train_phase(
        torch, runs, qcfg, kernel_checks=checks(qcfg, AP_QWEN_LOAD, "apvlm"),
        fault_runs=AP_QWEN_FAULT_RUNS, tag="ap vlm", load=AP_QWEN_LOAD)
    _ap_launches(qcfg, qwen, AP_STEPS, "ap vlm")
    return lora, flash, qwen["launches"], audio["launches"]


def ap_dpo_serve_phase(torch, fams, runs: ApRuns, pod_refs=None) -> tuple:
    """Phase 39: the fault pool's jobs of the sharded DPO loss and the
    sharded prefill and serve steps of every family (see AP_DPO_LAYERS and
    AP_SERVE_JOBS). While the card is free, rows 13-18 at a rank's shapes
    of the fp32 DPO job (T = DPO_B · AP_DPO_S rows a slot: q/k/v and
    gate/up column-parallel, o and down row-parallel), rows 13-14 at each
    serving job's per-rank decode shapes (T = b = 2 rows a slot) and at
    hymba's prefill (T = 2 · 2,048; the other prefills' rank shapes, T =
    1,024, are phases 36 and 37's train checks), row 19 on a rank's heads
    in fp32 at S AP_DPO_S and on hymba's whole 25 heads at the prefill's B
    = 100, S 2,048, window 1,024 (stablelm's and granite's prefill shapes
    are phases 35 and 36's), and row 20 on hymba's prefill, 25 Mamba heads
    a rank, B = 100, SSD mode (rwkv's, 20 heads a rank at S 512, is phase
    37's), and rows 13-18 at the pod jobs' rank shapes (b/p = 1 row a
    slot: stablelm's column and row halves at T 512, granite's whole
    widths at T 512, stablelm's decode at T 1; their flash shapes are
    phase 35's and 36's), against their plain versions; then the jobs
    (``ap_dpo_serve_jobs``; the pod jobs read against ``pod_refs``, phase
    35's and 36's one-rank runs). Every rank's launches of rows 13-20 are
    checked: a serving job's rows 13-14 once a LoRA target and layer of
    every forward (the prefill, AP_SERVE_DECODES steps, the idle step),
    row 19 once a layer of an attention family's prefill, row 20 once a
    layer of an ssm or hybrid prefill, none in decode, and nothing of the
    dense, ragged or backward sets; a pod train job's as a one-rank step's
    on its shapes (``ap_pod_readings``). Then the uneven jobs' rank shapes
    (``AP_UNEVEN_JOBS``): rows 7-12 at ragged_model's (every slot at r_max,
    its rows, whole attention's o_proj on a block with the block's rows),
    rows 13-18 at scan_whole's whole hymba projections on 1 x 4 and at
    moe_odd's granite halves at T 1,536, row 20 on all 50 Mamba heads of 4
    slots (B 200, S 2,048) and row 19 at ragged_model's S 1,024 and
    moe_odd's S 768; their launches, every rank's, are checked by
    ``ap_uneven_readings``. Returns (the rank-local kernels' results,
    flash's, the scan's, the ragged kernels', the DPO job's sound launches,
    each serving job's, and each pod and uneven job's, summed over the
    pool's ranks)."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.grouped_lora import ref
    from repro_torch.kernels.linear_scan import linear_scan as LSK
    from repro_torch.kernels.linear_scan import ref as lsref
    from repro_torch.models.mamba import mamba_dims

    RL, fp32, bf16 = fams["rank-local"], torch.float32, torch.bfloat16
    dd, m = (int(x) for x in AP_MESH.split("x"))
    t0 = time.perf_counter()
    lora, flash, scan = {}, {}, {}
    dcfg = _ap_config(False, layers=AP_DPO_LAYERS, dtype="float32")
    d, ff = dcfg.d_model, dcfg.d_ff
    T = DPO_B * AP_DPO_S
    _merged(lora, backward_kernel_phase(
        torch, RL, ref, timed=("apdpo_row", d // m, d),
        untimed=("apdpo_col", "apdpo_ff"), dtype=fp32,
        cases=[("apdpo_col", T, d, d // m, RANKS, None),
               ("apdpo_ff", T, d, ff // m, RANKS, None),
               ("apdpo_row", T, d // m, d, RANKS, None),
               ("apdpo_ff", T, ff // m, d, RANKS, None)]))
    # the serving jobs' per-rank widths: (label, din, dout)
    gcfg = _ap_config(False, AP_MOE_ARCH)
    rcfg = _ap_config(False, AP_RWKV_ARCH, AP_RWKV_LAYERS)
    hcfg = _ap_config(False, AP_HYMBA_ARCH, AP_HYMBA_LAYERS)
    g_d, g_q, g_kv = gcfg.d_model, gcfg.q_dim, gcfg.kv_dim
    r_d, r_ff = rcfg.d_model, rcfg.d_ff
    h_d, h_ff, h_q, h_kv = hcfg.d_model, hcfg.d_ff, hcfg.q_dim, hcfg.kv_dim
    inner, Hs, hs = mamba_dims(hcfg)
    # the serving jobs' per-rank widths, (label, din, dout): the first of
    # each job's is timed, the others checked (label + "_chk")
    widths = [("apdecode", d // m, d), ("apdecode", d, d // m),
              ("apdecode", d, ff // m), ("apdecode", ff // m, d),
              ("apsgranite", g_q // m, g_d), ("apsgranite", g_d, g_q // m),
              ("apsgranite", g_d, g_kv // m),
              ("apsrwkv", r_d // m, r_d), ("apsrwkv", r_d, r_d // m),
              ("apsrwkv", r_d, r_ff // m), ("apsrwkv", r_ff // m, r_d),
              ("apshymba", h_d, 2 * inner // m), ("apshymba", h_d, h_q),
              ("apshymba", h_d, h_kv), ("apshymba", h_q, h_d),
              ("apshymba", h_d, h_ff // m), ("apshymba", h_ff // m, h_d)]
    hT = 2 * AP_SERVE_JOBS["hymba"][2]
    cases, timed = [], {}
    for label, din, dout in widths:
        first = not any(k[0] == label for k in timed)
        if first:
            timed[label, din, dout] = label
        cases.append((label if first else f"{label}_chk", 2, din, dout,
                      RANKS, None))
    timed["apshymba_pre", h_d, 2 * inner // m] = "apshymba_pre"
    cases += [("apshymba_pre", hT, h_d, 2 * inner // m, RANKS, None)] + [
        ("apshymba_pre_chk", T_, din, dout, RANKS, None)
        for T_, din, dout in ((hT, h_d, h_q), (hT, h_d, h_kv),
                              (hT // m, h_q, h_d), (hT, h_d, h_ff // m),
                              (hT, h_ff // m, h_d))]
    _merged(lora, kernel_phase(
        torch, RL, ref, timed=timed, cases=cases,
        untimed={c[0] for c in cases if c[0].endswith("_chk")}))
    H = dcfg.num_heads // m
    hS = AP_SERVE_JOBS["hymba"][2]
    _, cases = flash_kernel_phase(
        torch, FA, fref, dcfg, plain_labels=("train",),
        cases=[("train", AP_Z // dd * DPO_B * H, AP_DPO_S, AP_DPO_S,
                dcfg.resolved_head_dim, 0, fp32)])
    flash.update({f"apdpo_{k}": v for k, v in cases.items()})
    _, cases = flash_kernel_phase(
        torch, FA, fref, hcfg, plain_labels=("train",),
        cases=[("train", AP_Z // dd * 2 * hcfg.num_heads, hS, hS,
                hcfg.resolved_head_dim, hcfg.sliding_window, bf16)])
    flash.update({f"apshymba_{k}": v for k, v in cases.items()})
    _, cases = scan_kernel_phase(
        torch, LSK, lsref, hcfg, S=hS,
        cases=[("train", AP_Z // dd * 2 * Hs // m, hcfg.ssm.state_size, hs,
                True, False, 1.0, bf16)])
    scan.update({f"apshymba_{k}": v for k, v in cases.items()})
    # the pod jobs' rank shapes, b/p = 1 row a slot: pod_train's halves
    # (model 2) and pod_moe's whole widths (model 1) at T = S = 512, 4
    # slots as phases 35's and 36's checks take them; pod_serve's decode
    # at T 1 a slot
    sd, sff = d, ff                       # stablelm's widths (the DPO job's)
    _merged(lora, backward_kernel_phase(
        torch, RL, ref, timed=("appod_row", sd // m, sd),
        untimed=("appod_col", "appod_ff"),
        cases=[("appod_col", AP_S, sd, sd // m, RANKS, None),
               ("appod_ff", AP_S, sd, sff // m, RANKS, None),
               ("appod_row", AP_S, sd // m, sd, RANKS, None),
               ("appod_ff", AP_S, sff // m, sd, RANKS, None)]))
    _merged(lora, backward_kernel_phase(
        torch, RL, ref, timed=("appodmoe", g_q, g_d),
        untimed=("appodmoe_chk",),
        cases=[("appodmoe_chk", AP_S, g_d, g_q, RANKS, None),
               ("appodmoe_chk", AP_S, g_d, g_kv, RANKS, None),
               ("appodmoe", AP_S, g_q, g_d, RANKS, None)]))
    _merged(lora, kernel_phase(
        torch, RL, ref, timed={("appoddecode", sd // m, sd): "appoddecode"},
        untimed={"appoddecode_chk"},
        cases=[("appoddecode", 1, sd // m, sd, RANKS, None),
               ("appoddecode_chk", 1, sd, sd // m, RANKS, None),
               ("appoddecode_chk", 1, sd, sff // m, RANKS, None),
               ("appoddecode_chk", 1, sff // m, sd, RANKS, None)]))
    print("ap serve: the granite and rwkv prefills' rank shapes (T 1,024 a "
          "slot) are phase 36's and 37's row 13-18 checks; flash on the "
          "stablelm and granite prefills (B 64 and 32, S 512) phase 35's "
          "and 36's; the scan on rwkv's (B 80, S 512) phase 37's. ap pod: "
          "flash on pod_train's and pod_serve's rank shapes (B 4 x 1 x 16 = "
          "64, S 512) is phase 35's check, on pod_moe's (B 2 x 1 x 16 = 32, "
          "S 512, hd 64) phase 36's")
    # the uneven jobs' rank shapes (AP_UNEVEN_JOBS). ragged_model, data 2 x
    # model 2: rows 7-12 at every slot's r_max and its rows, T = b·S =
    # 2,048 a slot, in_proj's block, q/k/v whole, gate/up/down halves, and
    # whole attention's o_proj on a model rank's block of S/2 with the
    # rows of that block (SpmdPlan.block_rows); flash on a data rank's 2
    # slots of b 2 and the 25 whole heads at S 1,024
    RG = _Ragged(fams["ragged"], ref)
    rZ, rb, rS = AP_UNEVEN_JOBS["ragged_model"][3]
    rm = AP_UNEVEN_JOBS["ragged_model"][2][1]
    rT, n = rb * rS, rS // rm
    rows = tuple(w * rS for w in AP_RAGGED_WIDTHS)
    block = tuple(rw // rS * n + min(max(rw % rS, 0), n) for rw in rows)
    full = (hcfg.lora.r_max,) * len(RANKS)
    ragged = backward_kernel_phase(
        torch, RG, RG, timed=("apragged", h_d, 2 * inner // rm),
        untimed=("apragged_chk",),
        cases=[("apragged", rT, h_d, 2 * inner // rm, full, rows),
               ("apragged_chk", rT, h_d, h_q, full, rows),
               ("apragged_chk", rT, h_d, h_kv, full, rows),
               ("apragged_chk", n * rb, h_q, h_d, full, block),
               ("apragged_chk", rT, h_d, h_ff // rm, full, rows),
               ("apragged_chk", rT, h_ff // rm, h_d, full, rows)])
    _, cases = flash_kernel_phase(
        torch, FA, fref, hcfg, plain_labels=("train",),
        cases=[("train", rZ // 2 * rb * hcfg.num_heads, rS, rS,
                hcfg.resolved_head_dim, hcfg.sliding_window, bf16)])
    flash.update({f"apragged_{k}": v for k, v in cases.items()})
    # scan_whole, data 1 x model 4: rows 13-18 at hymba's whole in_proj
    # (T 2,048), its o_proj on a rank's block of 512, gate/up/down quarters
    # (q/k/v whole at T 2,048 are phase 37's aphymba_whole checks), and the
    # scan on all 50 Mamba heads of the 4 slots (B 200, S 2,048); its
    # flash on the 25 whole heads of 4 slots (B 100) is the check above
    # (apshymba); the serving job's prefill takes the scan at B 400, the
    # hymba phases' ssd check
    wZ, wb, wS = AP_HYMBA_LOAD
    wm = AP_UNEVEN_JOBS["scan_whole"][2][1]
    wT = wb * wS
    _merged(lora, backward_kernel_phase(
        torch, RL, ref, timed=("apwhole", h_d, 2 * inner),
        untimed=("apwhole_chk",),
        cases=[("apwhole", wT, h_d, 2 * inner, RANKS, None),
               ("apwhole_chk", wT // wm, h_q, h_d, RANKS, None),
               ("apwhole_chk", wT, h_d, h_ff // wm, RANKS, None),
               ("apwhole_chk", wT, h_ff // wm, h_d, RANKS, None)]))
    _, cases = scan_kernel_phase(
        torch, LSK, lsref, hcfg, S=wS,
        cases=[("train", wZ * wb * Hs, hcfg.ssm.state_size, hs, True, False,
                1.0, bf16)])
    scan.update({f"apwhole_{k}": v for k, v in cases.items()})
    # moe_odd, data 2 x model 2: granite's q/k/v halves and o at T = b·S =
    # 1,536 a slot, and flash on a data rank's 2 slots of b 2 and 8 heads
    # at S 768 (granite's attention is global: no window on its path)
    oZ, ob, oS = AP_UNEVEN_JOBS["moe_odd"][3]
    om = AP_UNEVEN_JOBS["moe_odd"][2][1]
    oT = ob * oS
    _merged(lora, backward_kernel_phase(
        torch, RL, ref, timed=("apodd", g_q // om, g_d),
        untimed=("apodd_chk",),
        cases=[("apodd_chk", oT, g_d, g_q // om, RANKS, None),
               ("apodd_chk", oT, g_d, g_kv // om, RANKS, None),
               ("apodd", oT, g_q // om, g_d, RANKS, None)]))
    _, cases = flash_kernel_phase(
        torch, FA, fref, gcfg, plain_labels=("train",),
        cases=[("train", oZ // 2 * ob * gcfg.num_heads // om, oS, oS,
                gcfg.resolved_head_dim, 0, bf16)])
    flash.update({f"apodd_{k}": v for k, v in cases.items()})
    print(f"ap dpo / serve: kernel checks {time.perf_counter() - t0:.1f} s")
    (dcfg, dpo_parts, serve_jobs, pod_jobs,
     uneven_jobs) = ap_dpo_serve_jobs(torch, runs, pod_refs)
    train, evals, (train_seq, eval_seq) = _step_launches(dcfg, "dpo")
    for r, part in enumerate(dpo_parts):
        for what, want, want_seq, n in (
                ("launches", train, train_seq, AP_DPO_STEPS),
                ("eval_launches", evals, eval_seq, 1)):
            got = part[what]
            require(got["rank-local"] == {k: v * n for k, v in want.items()}
                    and got["flash"]["flash_attention"] == want_seq * n
                    and not any(got["dense"].values())
                    and not any(got["ragged"].values())
                    and not any(got["scan"].values()),
                    f"ap dpo rank {r}: {what} {got}, expected rank-local "
                    f"{want} and flash {want_seq} a step")
    forwards = 1 + AP_SERVE_DECODES + 1
    for job, (scfg, parts) in serve_jobs.items():
        per_forward = len(scfg.lora.targets) * scfg.num_layers
        seq = _seq_counts(scfg, scfg.num_layers)
        for r, part in enumerate(parts):
            got = part["launches"]
            want = {k: (per_forward * forwards if k in ("xa", "sb_add")
                        else 0) for k in got["rank-local"]}
            require(got["rank-local"] == want
                    and got["flash"]["flash_attention"]
                    == seq["flash_attention"]
                    and got["scan"]["linear_scan"] == seq["linear_scan"]
                    and not any(got["dense"].values())
                    and not any(got["ragged"].values()),
                    f"ap serve {job} rank {r}: launches {got}, expected "
                    f"rank-local {want} and {seq} (the prefill)")
    print(f"ap dpo / serve phase: {time.perf_counter() - t0:.1f} s")
    return (lora, flash, scan, ragged, _summed(dpo_parts, "launches"),
            {job: _summed(parts, "launches")
             for job, (_, parts) in serve_jobs.items()},
            {job: _summed(parts, "launches")
             for job, (_, parts) in {**pod_jobs, **uneven_jobs}.items()})


def _summed(parts, what: str) -> dict:
    """The launches ``what`` of each rank's results ``parts``, by set,
    summed over the ranks."""
    tot = {}
    for part in parts:
        for fam, ks in part[what].items():
            for k, v in ks.items():
                tot.setdefault(fam, {}).setdefault(k, 0)
                tot[fam][k] += v
    return tot


def ap_dpo_serve_jobs(torch, runs: ApRuns, pod_refs=None) -> tuple:
    """Phase 39's jobs and readings (``ap_dpo_serve_phase``): the DPO job
    and the pod train jobs to the pool, the one-rank serving runs of
    ``AP_SERVE_JOBS`` (each one's greedy tokens feed the pool's serving job
    of the same name, and stablelm's the "pod_serve" job too, given to the
    pool as soon as they are known) and the one-rank DPO run here, then
    every reading against its bars (``ap_pod_readings`` for the pod jobs,
    against ``pod_refs``: phase 35's and 36's one-rank runs; without them,
    phase 39 alone, one-rank runs made here), and the uneven jobs
    (``AP_UNEVEN_JOBS``: the train jobs to the pool with the pod jobs, the
    serving job when the one-rank hymba serving's tokens are known; read
    by ``ap_uneven_readings`` against one-rank runs made here, or, for
    "scan_whole", phase 37's in ``pod_refs``). With ``runs.reduced`` every
    run is its config's tiny fp32 variant (on the CPU, a check of this
    machinery; its bars are not the card's). Returns (the DPO config, the
    pool ranks' results of the sound DPO run, {job: (its config, the pool
    ranks' results of its sound serving run)}, {pod job: the same},
    {uneven job: the same})."""
    import numpy as np
    from repro_torch.launch import mesh as MESH

    Z = len(RANKS)
    dd, m = (int(x) for x in AP_MESH.split("x"))
    t = time.perf_counter()
    seconds = {}
    dcfg = _ap_config(runs.reduced, layers=AP_DPO_LAYERS, dtype="float32")
    out = Path(tempfile.mkdtemp(prefix="ap_dpo_serve_", dir=runs.dir))
    k_dpo = runs.job({"kind": "dpo", "out": str(out),
                      "reduced": runs.reduced})
    load = AP_POD_REDUCED_LOAD if runs.reduced else AP_LOAD
    k_pod = {job: runs.job({"kind": job, "out": str(out), "load": load,
                            "reduced": runs.reduced})
             for job in ("pod_train", "pod_moe")}

    def uneven_load(job):
        return (AP_UNEVEN_REDUCED_LOADS[job] if runs.reduced
                else AP_UNEVEN_JOBS[job][3])

    k_uneven = {job: runs.job({"kind": job, "out": str(out),
                               "load": uneven_load(job),
                               "reduced": runs.reduced})
                for job in ("scan_whole", "ragged_model", "moe_odd")}
    ones, k_serve = {}, {}
    with MESH.process_group(runs.device) as dev:
        mesh = MESH.make_local_mesh((1, 1), device=dev)
        for job in AP_SERVE_JOBS:
            t1 = time.perf_counter()
            scfg, params, slora, batch, ranks = _serve_inputs(
                torch, dev, runs.reduced, job)
            # each slot's dropped share of its choices in each MoE layer
            # of the prefill (the route fault reaches the slots with drops)
            with (_moe_drops(scfg, Z) if scfg.is_moe
                  else contextlib.nullcontext([])) as drops:
                one = ap_serve(torch, scfg, mesh, params, slora, batch,
                               ranks, AP_SERVE_DECODES, per_lane=True,
                               grow=True, idle=AP_IDLE_LANES)
            torch.save(one["tokens"].cpu(), out / f"feed_{job}.pt")
            k_serve[job] = runs.job({"kind": "serve", "job": job,
                                     "out": str(out),
                                     "feed": str(out / f"feed_{job}.pt"),
                                     "reduced": runs.reduced})
            if job == "stablelm":
                k_pod["pod_serve"] = runs.job({
                    "kind": "pod_serve", "out": str(out),
                    "feed": str(out / f"feed_{job}.pt"),
                    "reduced": runs.reduced})
            if job == "hymba":
                k_uneven["scan_whole_serve"] = runs.job({
                    "kind": "scan_whole_serve", "out": str(out),
                    "feed": str(out / f"feed_{job}.pt"),
                    "reduced": runs.reduced})
            ones[job] = (scfg, batch["tokens"].shape[-1], {
                "logits": one["logits"].cpu().numpy(),
                "idle_logits": one["idle_logits"].float().cpu().numpy(),
                "cache": {k: v for k, v in one["cache"].items()
                          if k.startswith("cache/")}, "drops": drops})
            del params, slora, batch, one
            seconds[f"one_rank_{job}"] = time.perf_counter() - t1
        _, params, dlora, batches, ranks = _dpo_inputs(torch, dev,
                                                       runs.reduced)
        # a copy: the one-rank step updates the adapters in place
        init = {f"lora/{tg}/{k}": v.cpu().numpy().copy()
                for tg, ab in dlora.items() for k, v in ab.items()}
        res = ap_dpo(torch, dcfg, mesh, params, dlora, batches, ranks,
                     lr=AP_DPO_LR)
        one_dpo = {"losses": np.asarray(res["losses"]),
                   "eval": np.asarray(res["eval"]),
                   **{f"lora/{tg}/{k}": v.cpu().numpy()
                      for tg, ab in res["lora"].items()
                      for k, v in ab.items()}}
        del params, dlora, batches, res
        # the uneven jobs' own loads; phase 37's one-rank hymba run where
        # it ran (scan_whole's load is its)
        refs = dict(pod_refs or {})
        for job in ("pod_train", "pod_moe", "scan_whole", "ragged_model",
                    "moe_odd"):
            if job not in refs:
                refs[job] = _one_rank_ref(
                    torch, np, job,
                    load if job in AP_POD_JOBS else uneven_load(job), mesh,
                    dev, runs.reduced)
    seconds["one_rank"] = time.perf_counter() - t
    runs.wait(k_dpo)
    seconds["dpo_job"] = time.perf_counter() - t
    for job, k in {**k_pod, **k_uneven, **k_serve}.items():
        runs.wait(k)
        seconds[f"{job}_job"] = time.perf_counter() - t
    gc.collect()
    if runs.device == "cuda":
        torch.cuda.empty_cache()

    def rank_files(kind, fault):
        return [json.loads((out / f"{kind}_{fault}_rank{r}.json").read_text())
                for r in range(AP_PROCS)]

    # -- (i) DPO
    dpo_parts = rank_files("dpo", "none")
    got = dict(np.load(out / "dpo_none.npz"))
    loss, adapters = _ap_readings(np, got, one_dpo, init, range(Z))
    ev = _ap_eval(np, got["eval"], one_dpo["eval"], range(Z))
    print(f"ap dpo: {AP_MESH} vs 1x1, {dcfg.name} {dcfg.num_layers} layers "
          f"fp32, Z {Z}, {DPO_B} pairs of {AP_DPO_S} a slot, ranks {RANKS}, "
          f"{AP_DPO_STEPS} steps at lr {AP_DPO_LR}: loss reading {loss:.3e} "
          f"(bar {AP_DPO_LOSS_REL}), adapter reading {adapters:.3e} (bar "
          f"{AP_DPO_ADAPTER_REL}), eval reading {ev:.3e} (bar "
          f"{AP_DPO_LOSS_REL}); losses {got['losses'].tolist()} vs "
          f"{one_dpo['losses'].tolist()}; evals {got['eval'].tolist()} vs "
          f"{one_dpo['eval'].tolist()}")
    require(bool(np.isfinite(got["losses"]).all()
                 and np.isfinite(got["eval"]).all())
            and bool((np.abs(one_dpo["eval"] - np.log(2.0)) > 1e-4).all()),
            "ap dpo: losses not finite, or the eval still reads log 2")
    require(loss <= AP_DPO_LOSS_REL and adapters <= AP_DPO_ADAPTER_REL
            and ev <= AP_DPO_LOSS_REL,
            f"ap dpo: readings {loss}, {adapters}, {ev} past the bars")
    for fault, slots in AP_DPO_FAULT.items():
        bad = dict(np.load(out / f"dpo_{fault}.npz"))
        fl, fa = _ap_readings(np, bad, one_dpo, init, slots)
        fe = _ap_eval(np, bad["eval"], one_dpo["eval"], slots)
        kept = [z for z in range(Z) if z not in slots]
        kl, ka = _ap_readings(np, bad, one_dpo, init, kept)
        print(f"ap dpo: planted fault {fault}: loss reading {fl:.3e}, "
              f"adapter reading {fa:.3e}, eval reading {fe:.3e} on slots "
              f"{slots} (must pass all three bars); the other slots "
              f"{kl:.3e}, {ka:.3e}")
        require(fl > AP_DPO_LOSS_REL and fa > AP_DPO_ADAPTER_REL
                and fe > AP_DPO_LOSS_REL,
                f"ap dpo: planted fault {fault} within a bar")
        require(kl <= AP_DPO_LOSS_REL and ka <= AP_DPO_ADAPTER_REL,
                f"ap dpo: planted fault {fault} reaches slots {kept}")

    # -- (ii-v) serving
    serve_parts = {job: ap_serve_readings(torch, np, out, job, *ones[job],
                                          dd, m)
                   for job in AP_SERVE_JOBS}
    scfg, _, one = ones["stablelm"]
    pod_parts = ap_pod_readings(np, out, refs, dict(one, cfg=scfg),
                                runs.reduced)
    uneven_parts = ap_uneven_readings(torch, np, out, refs, ones["hymba"],
                                      runs.reduced)
    shutil.rmtree(out, ignore_errors=True)
    seconds["jobs_phase"] = time.perf_counter() - t
    print(f"ap dpo / serve: seconds "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }")
    return dcfg, dpo_parts, serve_parts, pod_parts, uneven_parts


def ap_serve_readings(torch, np, out: Path, job: str, cfg, S: int, one: dict,
                      dd: int, m: int, kind=None, faults=None,
                      bars=None) -> tuple:
    """The readings of phase 39's serving job ``job`` against its one-rank
    run ``one`` (its logits, idle step's logits and prefilled cache):
    every pool rank's idle step left the idle lanes' entries of every leaf
    and their positions untouched and changed live ones; per slot over
    every step's logits and the idle step's live lanes, max|diff| /
    max|logit| and the relative RMS within the job's bars
    (``AP_SERVE_JOBS``); the prefilled cache's relative RMS, leaf by leaf (the
    ranks' shards joined, ``cache_whole``; printed); the planted fault past
    both bars on its slots and within them on the others. ``kind`` (the
    job's files' prefix, ``serve_<job>`` by default), ``faults`` and
    ``bars`` replace ``AP_SERVE_JOBS[job]``'s (phase 39's uneven serving
    job, on a ``dd`` x ``m`` mesh of its own). Returns (the config, the
    pool ranks' results of the sound run)."""
    Z = len(RANKS)
    kind = kind or f"serve_{job}"
    faults = AP_SERVE_JOBS[job][3] if faults is None else faults
    tag = f"ap serve {job}"
    parts = [json.loads((out / f"{kind}_none_rank{r}.json").read_text())
             for r in range(AP_PROCS)]
    for r, part in enumerate(parts):
        require(part["idle_changed"] == 0 and part["live_changed"] > 0,
                f"{tag} rank {r}: the idle step changed "
                f"{part['idle_changed']} entries of idle lanes and "
                f"{part['live_changed']} of live ones")
    print(f"{tag}: every rank's idle-step lanes: "
          f"{[(p['idle_changed'], p['live_changed']) for p in parts]}"
          f" (idle, live) entries changed in every cache leaf and position")

    def sharded(fault):
        got = [dict(np.load(out / f"{kind}_{fault}_data{i}.npz"))
               for i in range(dd)]
        return {k: np.concatenate([p[k] for p in got],
                                  axis=1 if k == "logits" else 0)
                for k in got[0]}

    def gap(a, b):
        """Per slot over every step ([steps, Z, ...]): max|a-b| / max|b|
        and the relative RMS."""
        dlt = (a - b).swapaxes(0, 1).reshape(Z, -1)
        b = b.swapaxes(0, 1).reshape(Z, -1)
        return (np.abs(dlt).max(1) / np.abs(b).max(1),
                np.linalg.norm(dlt, axis=1) / np.linalg.norm(b, axis=1))

    def show(g):
        return (f"max|diff|/max|logit| {[round(float(v), 5) for v in g[0]]}"
                f", relative RMS {[round(float(v), 5) for v in g[1]]}")

    want = one["logits"]
    atol_rel, rel_rms = bars or AP_SERVE_JOBS[job][4]
    live = np.ones((Z, 2), bool)
    for z, lane in AP_IDLE_LANES:
        live[z, lane] = False
    got = sharded("none")
    sound = gap(got["logits"], want)
    idle = gap(np.where(live[..., None], got["idle_logits"], 0)[None],
               np.where(live[..., None], one["idle_logits"], 0)[None])
    agree = float((got["logits"].argmax(-1) == want.argmax(-1)).mean())
    print(f"{tag}: {dd}x{m} vs 1x1, {cfg.name} {cfg.num_layers} layers "
          f"{cfg.dtype}, Z {Z}, b 2, a {S}-token prompt into a per-lane "
          f"cache then {AP_SERVE_DECODES} steps fed the one-rank run's "
          f"tokens: per slot over the {AP_SERVE_DECODES + 1} logits "
          f"{show(sound)}; the idle step's live lanes {show(idle)} (bars "
          f"{atol_rel}, {rel_rms}); greedy agreement {agree:.3f}")
    require(bool(np.isfinite(got["logits"]).all())
            and got["logits"].shape == (AP_SERVE_DECODES + 1, Z, 2,
                                        cfg.vocab_size),
            f"{tag}: logits {got['logits'].shape} not finite or misshapen")
    require(max(sound[0].max(), idle[0].max()) <= atol_rel
            and max(sound[1].max(), idle[1].max()) <= rel_rms,
            f"{tag}: sharded logits too far from the one-rank run's")
    dev = next(iter(one["cache"].values())).device
    shards = [torch.load(out / f"cache_{job}_rank{r}.pt", map_location=dev)
              for r in range(AP_PROCS)]
    whole = cache_whole(shards, dd, m, torch.cat)
    rms = {}
    for key, ref in one["cache"].items():
        a, b = whole[key].float(), ref.float()
        require(a.shape == b.shape and bool(torch.isfinite(a).all()),
                f"{tag}: {key} {tuple(a.shape)} vs {tuple(b.shape)}")
        rms[key[len("cache/"):]] = float((a - b).norm() / b.norm())
    whole_leaves = [k for k in rms
                    if int(shards[0]["split/" + k]) < 0]
    print(f"{tag}: the prefilled cache's relative RMS against the one-rank "
          f"run, leaf by leaf: "
          f"{ {k: f'{v:.3e}' for k, v in rms.items()} }; the leaves whole "
          f"over model ({whole_leaves}) bitwise equal on the {m} model "
          f"ranks of each data rank (cache_whole)")
    del shards, whole
    for fault, slots in faults.items():
        if fault == "route_blind":
            layer = one["drops"][min(AP_MOE_ROUTE_LAYER, cfg.num_layers - 1)]
            print(f"{tag}: each slot's dropped share of its choices in the "
                  f"prefill's layer {AP_MOE_ROUTE_LAYER}: {layer}")
            slots = [z for z in slots if layer[z] > 0]
            require(bool(slots), f"{tag}: data rank 1 drops no choice in "
                    f"layer {AP_MOE_ROUTE_LAYER}: the fault would test "
                    f"nothing")
        bad = gap(sharded(fault)["logits"], want)
        kept = [z for z in range(Z) if z not in slots]
        print(f"{tag}: planted fault {fault}: {show(bad)} (slots {slots} "
              f"must pass both bars, {kept} stay within them)")
        require(min(bad[0][list(slots)]) > atol_rel
                and min(bad[1][list(slots)]) > rel_rms,
                f"{tag}: planted fault {fault} within the bars")
        require(max(bad[0][kept]) <= atol_rel
                and max(bad[1][kept]) <= rel_rms,
                f"{tag}: planted fault {fault} reaches slots {kept}")
    return cfg, parts


def _job_config(job: str, reduced: bool):
    """The config of pod or uneven job ``job`` (``AP_POD_JOBS``,
    ``AP_UNEVEN_JOBS``)."""
    arch, layers = {**AP_POD_JOBS, **AP_UNEVEN_JOBS}[job][:2]
    return _ap_config(reduced, arch, layers)


def _one_rank_ref(torch, np, job: str, load, mesh, dev,
                  reduced: bool) -> dict:
    """The one-rank run pod or uneven job ``job`` is read against:
    ``launch.train.run`` of its config on the one-rank ``mesh``, as
    ``ap_train_phase``'s "one_rank" gives it ("ragged_model": every slot at
    r_max, its widths, no eval step), where phase 35, 36 or 37 did not make
    it (phase 39 run alone: a dev script or the CPU rehearsal) or for a
    load of its own."""
    from repro_torch.launch import train as TRAIN
    cfg = _job_config(job, reduced)
    ragged = job == "ragged_model"
    one = TRAIN.run(cfg, *load, mesh, AP_STEPS,
                    ranks=None if ragged else RANKS, rank=cfg.lora.r_max,
                    device=dev, widths=AP_RAGGED_WIDTHS if ragged else None,
                    log=lambda m: print(f"{job} 1x1: {m}"))
    want = {"losses": np.asarray(one["losses"])}
    if "eval" in one:
        want["eval_own"] = np.asarray(one["eval"])
    want.update({f"lora/{t}/{k}": v.float().cpu().numpy()
                 for t, ab in one["lora"].items() for k, v in ab.items()})
    return {"want": want, "init": _run_init(
        torch, cfg, dev, (cfg.lora.r_max,) * len(RANKS) if ragged else RANKS)}


def _pod_parts(out: Path, job: str, fault: str) -> list:
    return [json.loads((out / f"{job}_{fault}_rank{r}.json").read_text())
            for r in range(AP_PROCS)]


def _pod_peer(r: int, shape) -> int:
    """The global rank of rank ``r``'s pod peer on a (2, d, m) mesh."""
    _, d, m = shape
    return (r + d * m) % (2 * d * m)


def _pod_invariant(parts, tag: str, moe: bool, steps: int = 0) -> None:
    """The pod invariant from every rank's collective records ``parts``
    ("log": (axis, role, kind, bytes)): "pod" carries only ``steps``
    all-reduces of the adapter gradients (role "adapter_grad"), each of the
    rank's adapter bytes, the per-slot loss sums (role "loss") and, for
    the MoE family, the route counts; "data" only base weights, the metric
    gather and route counts. A serving job (``steps`` 0, no adapter bytes)
    sends nothing over "pod" but, for the MoE family, route counts."""
    route = {"route"} if moe else set()
    for r, part in enumerate(parts):
        pod = [c for c in part["log"] if c[0] == "pod"]
        roles = {c[1] for c in pod}
        data = {c[1] for c in part["log"] if c[0] == "data"}
        grads = [c for c in pod if c[1] == "adapter_grad"]
        want = ({"adapter_grad", "loss"} | route) if steps else route
        require(roles <= want and data <= {"base_weight", "metric", "route"}
                and len(grads) == steps
                and all(c[2] == "all-reduce" and c[3] == part["lora_bytes"]
                        for c in grads),
                f"{tag} rank {r}: pod roles {roles}, data roles {data}, "
                f"{len(grads)} adapter-gradient all-reduces over pod "
                f"{[c[3] for c in grads]} (want {steps} of "
                f"{part.get('lora_bytes')} bytes)")
    pods = [sum(c[3] for c in part["log"] if c[0] == "pod")
            for part in parts]
    print(f"{tag}: pod invariant holds on every rank; bytes over pod a "
          f"rank {pods}")


def ap_pod_readings(np, out: Path, refs: dict, one_serve: dict,
                    reduced: bool) -> dict:
    """Phase 39's pod jobs' readings: "pod_train" and "pod_moe" against
    their one-rank runs ``refs[job]`` (phase 35's and 36's: "want" its
    losses, adapters and own eval, "init" the initial adapters) at their
    phases' bars, the pod ranks' adapters bitwise equal slot by slot, each
    fault past the bars on its slots (the adapters; for the route fault
    the loss too) and within them on the others, with pod_grad_skip's
    slots no longer equal over "pod"; "pod_serve" against the one-rank
    stablelm serving run ``one_serve`` per (slot, lane) at job (ii)'s bars,
    the idle lanes untouched, its fault past both bars on the lane it
    reaches and within them on the other; every job's pod invariant and
    launches a rank. Returns {job: (config, the ranks' sound results)}."""
    Z = len(RANKS)
    res = {}
    for job in ("pod_train", "pod_moe"):
        _, _, shape, faults = AP_POD_JOBS[job]
        cfg = _job_config(job, reduced)
        tag = f"ap {job}"
        loss_bar, adapter_bar = ((AP_LOSS_REL, AP_ADAPTER_REL)
                                 if job == "pod_train" else
                                 (AP_MOE_LOSS_REL, AP_MOE_ADAPTER_REL))
        want, init = refs[job]["want"], refs[job]["init"]
        parts = _pod_parts(out, job, "none")
        got = dict(np.load(out / f"{job}_none.npz"))
        loss, adapters = _ap_readings(np, got, want, init, range(Z))
        ev = _ap_eval(np, got["eval"], want["eval_own"], range(Z))
        print(f"{tag}: pod x data x model {shape} vs 1x1, {cfg.name} "
              f"{cfg.num_layers} layers, {AP_STEPS} steps: loss reading "
              f"{loss:.3e} (bar {loss_bar}), adapter reading {adapters:.3e} "
              f"(bar {adapter_bar}), eval reading {ev:.3e} against the "
              f"one-rank run's own eval (bar {loss_bar}); losses "
              f"{got['losses'].tolist()} vs {want['losses'].tolist()}")
        require(bool(np.isfinite(got["losses"]).all()) and loss <= loss_bar
                and adapters <= adapter_bar and ev <= loss_bar,
                f"{tag}: readings {loss}, {adapters}, {ev} past the bars")
        require(all(p["slots"] == parts[_pod_peer(r, shape)]["slots"]
                    for r, p in enumerate(parts)),
                f"{tag}: the pod ranks' adapters differ")
        print(f"{tag}: the pod ranks' adapters bitwise equal, slot by slot")
        _pod_invariant(parts, tag, cfg.is_moe, AP_STEPS)
        train, evals, (train_seq, eval_seq) = _step_launches(cfg)
        for r, part in enumerate(parts):
            for what, w, w_seq, n in (("launches", train, train_seq,
                                       AP_STEPS),
                                      ("eval_launches", evals, eval_seq, 1)):
                g = part[what]
                require(g["rank-local"] == {k: v * n for k, v in w.items()}
                        and g["flash"]["flash_attention"] == w_seq * n
                        and not any(g["scan"].values())
                        and not any(g["dense"].values())
                        and not any(g["ragged"].values()),
                        f"{tag} rank {r}: {what} {g}, expected rank-local "
                        f"{w} and flash {w_seq} a step")
        for fault, slots in faults.items():
            bad = dict(np.load(out / f"{job}_{fault}.npz"))
            fparts = _pod_parts(out, job, fault)
            kept = [z for z in range(Z) if z not in slots]
            fl, fa = _ap_readings(np, bad, want, init, slots)
            kl, ka = _ap_readings(np, bad, want, init, kept)
            print(f"{tag}: planted fault {fault}: loss reading {fl:.3e}, "
                  f"adapter reading {fa:.3e} on slots {slots}; the other "
                  f"slots {kl:.3e}, {ka:.3e}")
            reads = ((fa > adapter_bar) if fault == "pod_grad_skip"
                     else (fl > loss_bar and fa > adapter_bar))
            require(reads, f"{tag}: planted fault {fault} within the bars")
            require(kl <= loss_bar and ka <= adapter_bar,
                    f"{tag}: planted fault {fault} reaches slots {kept}")
            if fault == "pod_grad_skip":
                first = [r for r in range(AP_PROCS)
                         if r < _pod_peer(r, shape)]
                same = [[fparts[r]["slots"][z]
                         == fparts[_pod_peer(r, shape)]["slots"][z]
                         for z in range(Z)] for r in first]
                require(all(s == [z not in slots for z in range(Z)]
                            for s in same),
                        f"{tag}: {fault}: the pod ranks' slots equal "
                        f"{same}, expected only slots {kept}")
        res[job] = (cfg, parts)
    # -- pod_serve
    job, tag = "pod_serve", "ap pod_serve"
    _, _, shape, faults = AP_POD_JOBS[job]
    scfg = one_serve["cfg"]
    p, dd, m = shape
    atol_rel, rel_rms = AP_SERVE_JOBS["stablelm"][4]
    parts = _pod_parts(out, job, "none")
    for r, part in enumerate(parts):
        require(part["idle_changed"] == 0 and part["live_changed"] > 0,
                f"{tag} rank {r}: the idle step changed "
                f"{part['idle_changed']} entries of idle lanes and "
                f"{part['live_changed']} of live ones")
    _pod_invariant([dict(q, lora_bytes=0) for q in parts], tag, False)
    per_forward = len(scfg.lora.targets) * scfg.num_layers
    seq = _seq_counts(scfg, scfg.num_layers)
    for r, part in enumerate(parts):
        g = part["launches"]
        w = {k: (per_forward * (AP_SERVE_DECODES + 2)
                 if k in ("xa", "sb_add") else 0) for k in g["rank-local"]}
        require(g["rank-local"] == w
                and g["flash"]["flash_attention"] == seq["flash_attention"]
                and not any(g["scan"].values())
                and not any(g["dense"].values())
                and not any(g["ragged"].values()),
                f"{tag} rank {r}: launches {g}, expected rank-local {w} "
                f"and flash {seq['flash_attention']} (the prefill)")

    def sharded(fault):
        """[steps, Z, b, V] (and the idle step's [Z, b, V]): each pod
        rank's lanes of the slots, from its first model rank."""
        got = [dict(np.load(out / f"{job}_{fault}_rank{k * dd * m}.npz"))
               for k in range(p)]
        return {key: np.concatenate([g[key] for g in got],
                                    axis=2 if key == "logits" else 1)
                for key in got[0]}

    def gap(a, b):
        """Per (slot, lane) over every step: max|a-b| / max|b| and the
        relative RMS, [Z, b] each."""
        dlt = np.moveaxis(a - b, 0, 2).reshape(Z, a.shape[2], -1)
        ref = np.moveaxis(b, 0, 2).reshape(Z, a.shape[2], -1)
        return (np.abs(dlt).max(-1) / np.abs(ref).max(-1),
                np.linalg.norm(dlt, axis=-1) / np.linalg.norm(ref, axis=-1))

    want = one_serve["logits"]
    got = sharded("none")
    sound = gap(got["logits"], want)
    live = np.ones((Z, 2), bool)
    for z, lane in AP_IDLE_LANES:
        live[z, lane] = False
    idle = gap(got["idle_logits"][None], one_serve["idle_logits"][None])
    print(f"{tag}: pod x data x model {shape} vs 1x1, {scfg.name} "
          f"{scfg.num_layers} layers, b 2 (one lane a pod rank): per "
          f"(slot, lane) over the {AP_SERVE_DECODES + 1} logits "
          f"max|diff|/max|logit| {np.round(sound[0], 5).tolist()}, relative "
          f"RMS {np.round(sound[1], 5).tolist()}; the idle step's live "
          f"lanes {np.round(np.where(live, idle[0], 0), 5).tolist()}, "
          f"{np.round(np.where(live, idle[1], 0), 5).tolist()} (bars "
          f"{atol_rel}, {rel_rms})")
    require(bool(np.isfinite(got["logits"]).all())
            and got["logits"].shape == want.shape,
            f"{tag}: logits {got['logits'].shape} not finite or misshapen")
    require(max(sound[0].max(), idle[0][live].max()) <= atol_rel
            and max(sound[1].max(), idle[1][live].max()) <= rel_rms,
            f"{tag}: sharded logits too far from the one-rank run's")
    for fault, lanes in faults.items():
        bad = gap(sharded(fault)["logits"], want)
        kept = [lane for lane in range(2) if lane not in lanes]
        print(f"{tag}: planted fault {fault}: max|diff|/max|logit| "
              f"{np.round(bad[0], 5).tolist()}, relative RMS "
              f"{np.round(bad[1], 5).tolist()} (lanes {list(lanes)} of every "
              f"slot must pass both bars, lanes {kept} stay within them)")
        require(bad[0][:, list(lanes)].min() > atol_rel
                and bad[1][:, list(lanes)].min() > rel_rms,
                f"{tag}: planted fault {fault} within the bars")
        require(bad[0][:, kept].max() <= atol_rel
                and bad[1][:, kept].max() <= rel_rms,
                f"{tag}: planted fault {fault} reaches lanes {kept}")
    res[job] = (scfg, parts)
    return res


def ap_uneven_readings(torch, np, out: Path, refs: dict, one_serve: tuple,
                       reduced: bool) -> dict:
    """Phase 39's uneven jobs' readings (``AP_UNEVEN_JOBS``): each train
    job against its one-rank run ``refs[job]`` ("want": losses, adapters and
    own eval; "init": the initial adapters) at its phase's bars (hymba's of
    phase 37, granite's of phase 36), its fault past the bars its job names
    on the slots it reaches and within them on the others; every rank's
    launches a step as one rank's on its shapes ("ragged_model": the
    ragged set, nothing of the rank-local one; the others the rank-local
    set), the sequence kernels once a layer of every forward and
    recompute; every rank's collective records: "data" only base weights,
    the metric gather and route counts, "model"'s base weights only
    all-gathered. "scan_whole_serve" against the one-rank hymba serving
    ``one_serve`` ((config, S, results)) through ``ap_serve_readings`` at
    job (v)'s bars (its cache's whole leaves bitwise equal on every model
    rank), its launches a rank those of a serving job. Returns {job:
    (config, the ranks' sound results)}."""
    Z = len(RANKS)
    res = {}
    for job in ("scan_whole", "ragged_model", "moe_odd"):
        _, _, shape, _, faults, reads = AP_UNEVEN_JOBS[job]
        cfg = _job_config(job, reduced)
        tag = f"ap {job}"
        loss_bar, adapter_bar = ((AP_MOE_LOSS_REL, AP_MOE_ADAPTER_REL)
                                 if cfg.is_moe else
                                 (AP_HYMBA_LOSS_REL, AP_HYMBA_ADAPTER_REL))
        want, init = refs[job]["want"], refs[job]["init"]
        parts = _pod_parts(out, job, "none")
        got = dict(np.load(out / f"{job}_none.npz"))
        loss, adapters = _ap_readings(np, got, want, init, range(Z))
        ev = (_ap_eval(np, got["eval"], want["eval_own"], range(Z))
              if "eval_own" in want else 0.0)
        print(f"{tag}: data x model {shape} vs 1x1, {cfg.name} "
              f"{cfg.num_layers} layers, {AP_STEPS} steps: loss reading "
              f"{loss:.3e} (bar {loss_bar}), adapter reading {adapters:.3e} "
              f"(bar {adapter_bar}), eval reading {ev:.3e} against the "
              f"one-rank run's own eval (bar {loss_bar}; 0: no eval step); "
              f"losses {got['losses'].tolist()} vs "
              f"{want['losses'].tolist()}")
        require(bool(np.isfinite(got["losses"]).all()) and loss <= loss_bar
                and adapters <= adapter_bar and ev <= loss_bar,
                f"{tag}: readings {loss}, {adapters}, {ev} past the bars")
        ragged = job == "ragged_model"
        fam, other = (("ragged", "rank-local") if ragged
                      else ("rank-local", "ragged"))
        train, evals, (train_seq, eval_seq) = _step_launches(cfg)
        for r, part in enumerate(parts):
            for what, w, w_seq, n in (("launches", train, train_seq,
                                       AP_STEPS),
                                      ("eval_launches", evals, eval_seq, 1)):
                if what not in part:
                    continue
                g, seq = part[what], _seq_counts(cfg, w_seq * n)
                require(g[fam] == {k: v * n for k, v in w.items()}
                        and g["flash"]["flash_attention"]
                        == seq["flash_attention"]
                        and g["scan"]["linear_scan"] == seq["linear_scan"]
                        and not any(g[other].values())
                        and not any(g["dense"].values()),
                        f"{tag} rank {r}: {what} {g}, expected {fam} {w} "
                        f"and {seq} a step")
            data = {c[1] for c in part["log"] if c[0] == "data"}
            model = [c for c in part["log"]
                     if c[0] == "model" and c[1] == "base_weight"]
            require(data <= {"base_weight", "metric", "route"}
                    and all(c[2] == "all-gather" for c in model)
                    and not any(c[0] == "pod" for c in part["log"]),
                    f"{tag} rank {r}: data roles {data}, model-axis base "
                    f"weights {sorted({c[2] for c in model})}")
        print(f"{tag}: every rank's launches as one rank's on its shapes; "
              f"rank 0's collective bytes by (axis, role): "
              f"{_summed_bytes(parts[0]['log'])}")
        for fault, slots in faults.items():
            bad = dict(np.load(out / f"{job}_{fault}.npz"))
            kept = [z for z in range(Z) if z not in slots]
            fl, fa = _ap_readings(np, bad, want, init, slots)
            kl, ka = _ap_readings(np, bad, want, init, kept)
            print(f"{tag}: planted fault {fault}: loss reading {fl:.3e}, "
                  f"adapter reading {fa:.3e} on slots {list(slots)} (must "
                  f"pass the bars of {list(reads)}); the other slots "
                  f"{kl:.3e}, {ka:.3e}")
            require(("loss" not in reads or fl > loss_bar)
                    and ("adapters" not in reads or fa > adapter_bar),
                    f"{tag}: planted fault {fault} within the bars")
            require(kl <= loss_bar and ka <= adapter_bar,
                    f"{tag}: planted fault {fault} reaches slots {kept}")
        res[job] = (cfg, parts)
    job = "scan_whole_serve"
    _, _, (dd, m), _, faults, _ = AP_UNEVEN_JOBS[job]
    scfg, S, one = one_serve
    _, parts = ap_serve_readings(torch, np, out, job, scfg, S, one, dd, m,
                                 kind=job, faults=faults,
                                 bars=AP_SERVE_JOBS["hymba"][4])
    per_forward = len(scfg.lora.targets) * scfg.num_layers
    seq = _seq_counts(scfg, scfg.num_layers)
    for r, part in enumerate(parts):
        g = part["launches"]
        w = {k: (per_forward * (AP_SERVE_DECODES + 2)
                 if k in ("xa", "sb_add") else 0) for k in g["rank-local"]}
        require(g["rank-local"] == w
                and g["flash"]["flash_attention"] == seq["flash_attention"]
                and g["scan"]["linear_scan"] == seq["linear_scan"]
                and not any(g["dense"].values())
                and not any(g["ragged"].values()),
                f"ap {job} rank {r}: launches {g}, expected rank-local {w} "
                f"and {seq} (the prefill)")
    res[job] = (scfg, parts)
    return res


def _summed_bytes(log) -> dict:
    """{"axis/role": bytes} of collective records (axis, role, kind,
    bytes)."""
    out = {}
    for axis, role, _, n in log:
        out[f"{axis}/{role}"] = out.get(f"{axis}/{role}", 0) + n
    return out


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
    t = time.perf_counter()
    autotune_phase(torch, fams)
    print(f"autotune phase {time.perf_counter() - t:.1f} s")
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
    # depth cut (SWEEP_LAYERS) to keep the script within its limit
    sw_cfg = dataclasses.replace(cfg, num_layers=SWEEP_LAYERS)
    sw_params = _cut_layers(params, SWEEP_LAYERS, torch.bfloat16)
    lr_launches = executor_phase(torch, GL, (RL, RG), sw_cfg, sw_params,
                                 "lr-sweep", lr_jobs)
    print(f"lr-sweep executor phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    colo_launches = colocation_phase(torch, fams, sw_cfg, sw_params)
    print(f"heterogeneous co-location phase done at "
          f"{time.perf_counter() - t_all:.1f} s")
    train_check(torch, fams, cfg, params, TRAIN_RANKS, "rank-local",
                loss_kind="dpo")
    print(f"DPO train check done at {time.perf_counter() - t_all:.1f} s")
    chosen, rejected = _pair_data(cfg)
    dpo_launches = executor_phase(
        torch, RL, (GL, RG), sw_cfg, sw_params, "dpo", _dpo_jobs(),
        loss_kind="dpo", b=DPO_B,
        batcher=PairSlotBatcher(chosen, rejected, 4, DPO_B, seed=0))
    print(f"DPO executor phase done at {time.perf_counter() - t_all:.1f} s")
    del params, sw_params
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
    gc.collect()                 # the hymba-1.5b backbone
    torch.cuda.empty_cache()
    m_lora, m_flash, m_serve, m_launches, l4_launches = moe_phases(
        torch, fams, t_all)
    gc.collect()                 # the llama4-scout backbone
    torch.cuda.empty_cache()
    f_lora, f_flash, f_paths = family_phases(torch, fams, t_all)
    f_dense = f_paths.pop("dense_cfg_train")
    f_paths["dense_cfg_train"] = f_dense["rank-local"]
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    launch = launch_phase(torch, fams)
    print(f"launch phase {time.perf_counter() - t:.1f} s, done at "
          f"{time.perf_counter() - t_all:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    runs = ApRuns(_ap_order())
    ok = False
    try:
        t = time.perf_counter()
        ap_lora, ap_flash, ap_launches, pod_refs = ap_phase(torch, fams,
                                                            runs)
        pod_refs = {"pod_train": pod_refs}
        print(f"ap phase {time.perf_counter() - t:.1f} s, done at "
              f"{time.perf_counter() - t_all:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        (apm_lora, apm_flash, apm_launches, apl_launches,
         pod_refs["pod_moe"]) = ap_moe_phase(torch, fams, runs)
        print(f"ap moe phase {time.perf_counter() - t:.1f} s, done at "
              f"{time.perf_counter() - t_all:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        (aps_lora, aps_flash, aps_scan, apr_launches, aph_launches,
         pod_refs["scan_whole"]) = ap_ssm_phase(torch, fams, runs)
        print(f"ap ssm / hybrid phase {time.perf_counter() - t:.1f} s, done "
              f"at {time.perf_counter() - t_all:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        apv_lora, apv_flash, apv_launches, apa_launches = ap_modal_phase(
            torch, fams, runs)
        print(f"ap vlm / audio phase {time.perf_counter() - t:.1f} s, done "
              f"at {time.perf_counter() - t_all:.1f} s")
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        (apx_lora, apx_flash, apx_scan, apx_ragged, apdpo_launches,
         apserve_launches, appod_launches) = ap_dpo_serve_phase(
            torch, fams, runs, pod_refs)
        print(f"ap dpo / serve phase {time.perf_counter() - t:.1f} s, done "
              f"at {time.perf_counter() - t_all:.1f} s")
        ok = True
    finally:
        runs.close(ok)

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
                "colocation": colo_launches["dense"][name],
                "dense_cfg_train": f_dense["dense"][name],
                "launch_train": launch["launch_train"]["dense"][name]}, \
                dense[name]
        elif src == "ragged.cu":
            prefix, by_path, res = "ragged", {
                "colocation": colo_launches["ragged"][name],
                "ap_ragged_model":
                    appod_launches["ragged_model"]["ragged"][name]}, \
                dict(ragged[name])
            res["shapes"] = {**res.get("shapes", {}),
                             **apx_ragged[name]["shapes"]}
            res["max_abs_err"] = max(res["max_abs_err"],
                                     apx_ragged[name]["max_abs_err"])
        else:
            prefix, by_path, res = "ranklocal", {
                "train": train_launches[name],
                "dpo": dpo_launches[name],
                "rwkv_train": rwkv_launches[name],
                "hymba_train": h_launches[name],
                "moe_train": m_launches[name],
                "llama4_train": l4_launches[name],
                **{path: got[name] for path, got in f_paths.items()},
                "ap_train": ap_launches["rank-local"][name],
                "ap_moe_train": apm_launches["rank-local"][name],
                "ap_llama4_train": apl_launches["rank-local"][name],
                "ap_rwkv_train": apr_launches["rank-local"][name],
                "ap_hymba_train": aph_launches["rank-local"][name],
                "ap_vlm_train": apv_launches["rank-local"][name],
                "ap_audio_train": apa_launches["rank-local"][name],
                "ap_dpo": apdpo_launches["rank-local"][name],
                **{f"ap_serve_{job}": got["rank-local"][name]
                   for job, got in apserve_launches.items()},
                **{f"ap_{job}": got["rank-local"][name]
                   for job, got in appod_launches.items()}}, \
                dict(kern[name])
            by_path["serve"] = serve_launches[name]
            by_path["rwkv_serve"] = rwkv_serve[name]
            by_path["hymba_serve"] = h_serve[name]
            by_path["moe_serve"] = m_serve[name]
            res["shapes"] = {**res.get("shapes", {}),
                             **h_lora[name]["shapes"],
                             **m_lora[name]["shapes"],
                             **f_lora[name]["shapes"],
                             **ap_lora[name]["shapes"],
                             **apm_lora[name]["shapes"],
                             **aps_lora[name]["shapes"],
                             **apv_lora[name]["shapes"],
                             **apx_lora[name]["shapes"]}
            res["max_abs_err"] = max(res["max_abs_err"],
                                     apx_lora[name]["max_abs_err"],
                                     h_lora[name]["max_abs_err"],
                                     m_lora[name]["max_abs_err"],
                                     f_lora[name]["max_abs_err"],
                                     ap_lora[name]["max_abs_err"],
                                     apm_lora[name]["max_abs_err"],
                                     aps_lora[name]["max_abs_err"],
                                     apv_lora[name]["max_abs_err"])
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

    def with_paths(res, **paths):
        """The kernel's row with other paths' shapes (hymba's, the MoE
        family's) beside its own."""
        res = dict(res)
        res["shapes"] = {f"{path}_{lab}": {k: v for k, v in r.items()
                                           if k != "pair_exp_bound_ms"}
                         for path, cases in paths.items()
                         for lab, r in cases.items()}
        res["max_abs_err"] = max([res["max_abs_err"]]
                                 + [r["max_abs_err"]
                                    for cases in paths.values()
                                    for r in cases.values()])
        return res

    by_path = {"serve": serve_launches["flash_attention"],
               "train": train_launches["flash_attention"],
               "lr_sweep": lr_launches["flash_attention"],
               "colocation": colo_launches["flash"]["flash_attention"],
               "dpo": dpo_launches["flash_attention"],
               "hymba_train": h_launches["flash_attention"],
               "hymba_serve": h_serve["flash_attention"],
               "moe_train": m_launches["flash_attention"],
               "moe_serve": m_serve["flash_attention"],
               "llama4_train": l4_launches["flash_attention"],
               "engine_static": eng_static["flash"]["flash_attention"],
               "engine_elastic": eng_elastic["flash"]["flash_attention"],
               "service": svc_launches["flash"]["flash_attention"],
               "service_recovery":
                   svc_rec_launches["flash"]["flash_attention"],
               "service_serve": svc_serve["flash"]["flash_attention"],
               **{path: got["flash_attention"]
                  for path, got in f_paths.items()}}
    by_path["dense_cfg_train"] = sum(got["flash_attention"]
                                     for got in f_dense.values())
    by_path["launch_train"] = launch["launch_flash"]
    by_path["ap_train"] = ap_launches["flash"]["flash_attention"]
    by_path["ap_moe_train"] = apm_launches["flash"]["flash_attention"]
    by_path["ap_llama4_train"] = apl_launches["flash"]["flash_attention"]
    by_path["ap_hymba_train"] = aph_launches["flash"]["flash_attention"]
    by_path["ap_vlm_train"] = apv_launches["flash"]["flash_attention"]
    by_path["ap_audio_train"] = apa_launches["flash"]["flash_attention"]
    by_path["ap_dpo"] = apdpo_launches["flash"]["flash_attention"]
    by_path.update({f"ap_serve_{job}": got["flash"]["flash_attention"]
                    for job, got in apserve_launches.items()})
    by_path.update({f"ap_{job}": got["flash"]["flash_attention"]
                    for job, got in appod_launches.items()})
    table["kernels"].append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:89",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **with_paths(flash, hymba=h_flash, moe=m_flash, families=f_flash,
                     ap=ap_flash, apmoe=apm_flash, apssm=aps_flash,
                     apmodal=apv_flash, ap39=apx_flash)})
    by_path = {"rwkv_train": rwkv_launches["linear_scan"],
               "rwkv_serve": rwkv_serve["linear_scan"],
               "hymba_train": h_launches["linear_scan"],
               "hymba_serve": h_serve["linear_scan"],
               "service": svc_launches["scan"]["linear_scan"],
               "service_recovery": svc_rec_launches["scan"]["linear_scan"],
               "ap_rwkv_train": apr_launches["scan"]["linear_scan"],
               "ap_hymba_train": aph_launches["scan"]["linear_scan"],
               **{f"ap_serve_{job}": got["scan"]["linear_scan"]
                  for job, got in apserve_launches.items()},
               **{f"ap_{job}": got["scan"]["linear_scan"]
                  for job, got in appod_launches.items()}}
    table["kernels"].append({
        "name": "linear_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu",
        "replaces": "src/repro/kernels/linear_scan/linear_scan.py:111",
        "launches": sum(by_path.values()), "launches_by_path": by_path,
        **with_paths(scan, hymba=h_scan, apssm=aps_scan, ap39=apx_scan)})
    print(f"total: {time.perf_counter() - t_all:.1f} s")
    print(card_line())
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ap-faults"]:
        sys.exit(ap_fault_child(sys.argv[1:]))
    sys.exit(main())
