"""PyTorch + CUDA port of the ALTO reproduction (the JAX package ``repro``
is the reference; this package imports nothing of it, nor JAX).

The dense family (stablelm-3b) serves many adapters (configs, the model's
prefill/decode with a per-lane cache, the adapter pool, the serving replica
and frontend) and trains them: rank sweeps, full-rank learning-rate sweeps,
heterogeneous co-location and DPO with crash-and-resume, through the
executor, autograd and AdamW. The RWKV-6 family (rwkv6-3b, ``ssm``) adds
the recurrent model (``models/rwkv.py``, ``models/linear_scan.py``), its
recurrent-state cache, serving by streaming prompts through decode, and
rank-sweep training through the same executor. The kernels are written in
CUDA C++ for Hopper: the rank-local, dense and ragged grouped-LoRA forward
and backward kernels (``kernels/grouped_lora``), causal flash attention
(``kernels/flash_attention``) and the chunked linear scan
(``kernels/linear_scan``).
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
