"""PyTorch + CUDA port of the ALTO reproduction (the JAX package ``repro``
is the reference; this package imports nothing of it, nor JAX).

The dense family (stablelm-3b) serves many adapters (configs, the model's
prefill/decode with a per-lane cache, the adapter pool, the serving replica
and frontend) and trains them: rank sweeps, full-rank learning-rate sweeps,
heterogeneous co-location and DPO with crash-and-resume, through the
executor, autograd and AdamW. The RWKV-6 family (rwkv6-3b, ``ssm``) adds
the recurrent model (``models/rwkv.py``, ``models/linear_scan.py``), its
recurrent-state cache, serving by streaming prompts through decode, and
rank-sweep training through the same executor. The hybrid family
(hymba-1.5b) adds the Mamba branch (``models/mamba.py``) beside attention
and its cache. Above the executor sit the engine of paper Listing 1
(``core/engine.py``: tasks, slot sizing from the memory model, profiling,
``schedule`` and ``batched_execution``) and the host-side scheduler
(``sched/``: the inter-task planner, the elastic cluster runtime over
``ExecutorTaskDriver``s, the intra-task admission policy, the profiler at
H100 constants, the fitted cost models and the event vocabulary), copies
of the JAX package's. Above the engine sits the tuning service
(``core/service.py``: ``TuningService`` sessions with arrivals, co-location,
cancellation, per-tenant quotas, the profiler feedback loop and
tune-to-serve into a live ``ServingFrontend``; the elastic
``batched_execution`` is a one-shot session), with its write-ahead journal
(``sched/journal.py``) and kill-and-recover, the chaos harness
(``sched/chaos.py``) and serving leases (``serve/driver.py``). The kernels
are written in CUDA C++ for Hopper: the rank-local, dense and ragged
grouped-LoRA forward and backward kernels (``kernels/grouped_lora``),
causal flash attention (``kernels/flash_attention``) and the chunked
linear scan (``kernels/linear_scan``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
